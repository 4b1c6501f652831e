"""The port's episodic data path against the JAX package's, on the CPU.

- ``data/class_set.py`` and ``data/synthetic.py`` are copies of pure-numpy
  modules: their outputs and errors are held EQUAL to the originals.
- ``gather_rows``: the JAX Pallas kernel in interpret mode and the port's
  plain version (and its wrapper on CPU tensors) agree bitwise.
- ``sample_episode``: fed the noise JAX's ``sample_episode`` draws from a
  key, the port returns every ``Episode`` leaf bitwise equal to JAX's
  (same dtypes too), on fp32, bf16 and uint8 tables, with ragged and
  too-small classes, with and without augmentation and the kernel gather.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fumi_tpu.core.episode import EpisodeSpec as JaxSpec
from fumi_tpu.data import class_set as jax_class_set
from fumi_tpu.data import sampler as jax_sampler
from fumi_tpu.data import synthetic as jax_synthetic
from fumi_tpu.ops import pallas_kernels as pk
from fumi_tpu_torch import bridge
from fumi_tpu_torch.core.episode import Episode, EpisodeSpec
from fumi_tpu_torch.data import class_set, sampler, synthetic
from fumi_tpu_torch.ops import kernels

B, N, K, Q, D, E = 2, 3, 2, 4, 64, 16


def assert_same(a, b):
    """Equal arrays, or equal dataclass / tuple / dict structures."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


# ---------------------------------------------------------------------------
# copies of the pure-numpy modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(num_classes=7, images_per_class=9, im_dim=5, text_dim=3,
                 noise=0.2, seed=3),
    dict(text_tokens=True, vocab_size=50, text_len=6, seed=1)])
def test_synthetic_class_set_equals_original(kw):
    assert_same(synthetic.synthetic_class_set(**kw),
                jax_synthetic.synthetic_class_set(**kw))


def test_synthetic_splits_equal_original():
    kw = dict(num_classes=10, images_per_class=8, im_dim=12, text_dim=6,
              seed=2)
    assert_same(synthetic.synthetic_splits(**kw),
                jax_synthetic.synthetic_splits(**kw))
    with pytest.raises(NotImplementedError, match="item 7"):
        synthetic.synthetic_splits(raw_images=True)


def test_build_class_tables_equals_original():
    cats = np.array([4, 1, 7])
    ids = {4: [10, 11, 12], 1: [3], 7: [20, 21, 22, 23, 24]}
    assert_same(class_set.build_class_tables(cats, ids),
                jax_class_set.build_class_tables(cats, ids))


def _error(fn):
    try:
        fn()
    except Exception as e:  # the type and message are what is compared
        return type(e), str(e)
    return None


def test_validate_episode_raises_the_same():
    rows, counts = jax_class_set.build_class_tables(
        np.arange(3), {0: [0, 1, 2], 1: [3, 4], 2: [5, 6, 7, 8]})
    kw = dict(categories=np.arange(3), class_image_rows=rows,
              class_counts=counts, text_features=np.zeros((3, 2), np.float32))
    ours, theirs = class_set.ClassSet(**kw), jax_class_set.ClassSet(**kw)
    for shots, query in ((1, 1), (1, 2), (2, 2), (3, 3)):
        assert _error(lambda: ours.validate_episode(shots, query)) == \
            _error(lambda: theirs.validate_episode(shots, query))
    assert _error(lambda: ours.validate_episode(3, 3)) is not None
    assert (ours.num_classes, ours.max_count, ours.text_is_tokens) == \
        (theirs.num_classes, theirs.max_count, theirs.text_is_tokens)


# ---------------------------------------------------------------------------
# gather_rows
# ---------------------------------------------------------------------------

def _torch_of(a):
    """numpy (incl. JAX's bfloat16) -> torch, bitwise."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t):
    """torch -> numpy of the same bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_gather_rows_matches_interpret_kernel_bitwise(dtype):
    rng = np.random.RandomState(0)
    table = jnp.asarray(rng.randn(40, D).astype(np.float32)).astype(dtype)
    idx = rng.randint(0, 40, 24).astype(np.int32)
    want = np.asarray(pk.gather_rows(table, jnp.asarray(idx), block_rows=8,
                                     interpret=True))
    t_table, t_idx = _torch_of(table), torch.from_numpy(idx)
    for got in (kernels.gather_rows_reference(t_table, t_idx),
                kernels.gather_rows(t_table, t_idx)):
        assert got.dtype == t_table.dtype and got.shape == (24, D)
        np.testing.assert_array_equal(_bits(got), _bits(_torch_of(want)))


@pytest.mark.parametrize("width", [1, 99, 2048])
def test_gather_rows_uint8_matches_np_take(width):
    rng = np.random.RandomState(width)
    table = rng.randint(0, 256, (17, width)).astype(np.uint8)
    idx = rng.randint(0, 17, 9).astype(np.int32)
    got = kernels.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.take(table, idx, axis=0))
    empty = kernels.gather_rows(torch.from_numpy(table),
                                torch.zeros(0, dtype=torch.int32))
    assert empty.shape == (0, width)


def test_gather_rows_wrapper_errors():
    table = torch.zeros(8, 4)
    idx = torch.zeros(3, dtype=torch.int32)
    before = kernels.gather_rows.launches
    with pytest.raises(ValueError, match="2-D"):
        kernels.gather_rows(torch.zeros(8, 4, 2), idx)
    with pytest.raises(ValueError, match="strided"):
        kernels.gather_rows(torch.zeros(4, 8).t(), idx)
    with pytest.raises(TypeError, match="int32"):
        kernels.gather_rows(table, idx.long())
    with pytest.raises(TypeError, match="int32"):
        kernels.gather_rows(table, idx.reshape(3, 1))
    with pytest.raises(ValueError, match="indices on meta"):
        kernels.gather_rows(table, idx.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.gather_rows(table.to("meta"), idx.to("meta"))
    # the CPU path runs the plain version: no launch is counted
    kernels.gather_rows(table, idx)
    assert kernels.gather_rows.launches == before


# ---------------------------------------------------------------------------
# sample_episode
# ---------------------------------------------------------------------------

def _tables(table_dtype, counts):
    """The same tables for both packages: ragged classes padded as
    build_class_tables pads them. Returns (jax tables, port tables)."""
    rng = np.random.RandomState(1)
    n_img = int(sum(counts))
    per_class = {c: list(rng.permutation(n_img)[:n])
                 for c, n in enumerate(counts)}
    rows, cnt = jax_class_set.build_class_tables(np.arange(len(counts)),
                                                 per_class)
    if table_dtype == "uint8":
        table = rng.randint(0, 256, (n_img, D)).astype(np.uint8)
        j_table = jnp.asarray(table)
    else:
        table = rng.randn(n_img, D).astype(np.float32)
        j_table = jax_sampler.table_storage(jnp.asarray(table), table_dtype)
    ids = (1000 + rng.permutation(n_img)).astype(np.int32)
    text = rng.randn(len(counts), E).astype(np.float32)
    j = jax_sampler.SamplerTables(
        image_table=j_table, image_ids=jnp.asarray(ids),
        class_rows=jnp.asarray(rows), class_counts=jnp.asarray(cnt),
        text_features=jnp.asarray(text))
    t = sampler.SamplerTables(
        image_table=_torch_of(j_table), image_ids=torch.from_numpy(ids),
        class_rows=torch.from_numpy(rows), class_counts=torch.from_numpy(cnt),
        text_features=torch.from_numpy(text))
    return j, t


def _jax_noise(key, num_classes, max_count, augment_scale):
    """The noise JAX's sample_episode draws from ``key`` (sampler.py:119-132
    and the augmentation's jnp reference), as torch tensors."""
    k_cls, k_img, k_aug = jax.random.split(key, 3)
    cls_noise = jax.random.uniform(k_cls, (B, num_classes))
    img_noise = jax.random.uniform(k_img, (B, N, max_count))
    aug = None
    if augment_scale > 0:
        aug = torch.from_numpy(np.array(jax.random.uniform(
            k_aug, (B * N * K, D), jnp.float32, -augment_scale,
            augment_scale)).reshape(B, N * K, D))
    return (torch.from_numpy(np.array(cls_noise)),
            torch.from_numpy(np.array(img_noise)), aug)


COUNTS = {"even": [9] * 7, "ragged": [6, 11, 7, 9, 6, 13],
          "too_small": [6, 2, 9, 1, 8]}


@pytest.mark.parametrize("table_dtype,counts,augment,pallas", [
    ("float32", "even", 0.0, False), ("float32", "ragged", 0.0, True),
    ("float32", "too_small", 0.0, False), ("float32", "ragged", 0.3, True),
    ("bfloat16", "ragged", 0.0, True), ("uint8", "even", 0.2, False),
])
def test_sample_episode_bitwise_equal_given_jax_noise(table_dtype, counts,
                                                      augment, pallas):
    counts = COUNTS[counts]
    j_tables, t_tables = _tables(table_dtype, counts)
    spec = dict(batch_size=B, num_ways=N, num_shots=K, num_query=Q,
                im_dim=D, text_dim=E)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = jax_sampler.sample_episode(j_tables, JaxSpec(**spec), key,
                                          use_pallas_gather=pallas,
                                          augment_scale=augment)
        noise = _jax_noise(key, len(counts), max(counts), augment)
        got = sampler.episode_from_noise(t_tables, EpisodeSpec(**spec),
                                         *noise, use_pallas_gather=pallas)
        want = bridge.episode_from_numpy(
            jax.tree_util.tree_map(np.asarray, want), device="cpu")
        for name in Episode._fields:
            a, b = getattr(got, name), getattr(want, name)
            if b is None:
                assert a is None, name
                continue
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.equal(a, b), name


def test_device_sampler_construction_errors_match():
    spec = dict(batch_size=B, num_ways=N, num_shots=K, num_query=Q,
                im_dim=D, text_dim=E)

    def cs(counts):
        rows, cnt = jax_class_set.build_class_tables(
            np.arange(len(counts)),
            {c: list(range(n)) for c, n in enumerate(counts)})
        return dict(categories=np.arange(len(counts)), class_image_rows=rows,
                    class_counts=cnt,
                    text_features=np.zeros((len(counts), E), np.float32))

    table = np.zeros((20, D), np.float32)
    ids = np.arange(20, dtype=np.int32)
    cases = [(cs([9, 9, 2, 9]), {}), (cs([9, 0, 9, 9]),
                                      dict(allow_replacement=True)),
             (cs([9, 9]), {}), (cs([9, 9]), dict(allow_replacement=True)),
             (cs([9, 3, 9, 9]), dict(allow_replacement=True))]
    for kw_cs, kw in cases:
        theirs = _error(lambda: jax_sampler.DeviceEpisodeSampler(
            table, ids, jax_class_set.ClassSet(**kw_cs), JaxSpec(**spec),
            **kw))
        ours = _error(lambda: sampler.DeviceEpisodeSampler(
            table, ids, class_set.ClassSet(**kw_cs), EpisodeSpec(**spec),
            device="cpu", **kw))
        assert ours == theirs


def _port_sampler(**kw):
    cs, table, ids = synthetic.synthetic_class_set(
        num_classes=8, images_per_class=10, im_dim=D, text_dim=E)
    spec = EpisodeSpec(B, N, K, Q, D, E)
    return sampler.DeviceEpisodeSampler(table, ids, cs, spec, device="cpu",
                                        **kw)


def test_sample_is_deterministic_per_seed_and_shaped():
    smp = _port_sampler(use_pallas_gather=True)
    a, b = smp.sample(smp.generator(5)), smp.sample(smp.generator(5))
    c = smp.sample(smp.generator(6))
    for name in Episode._fields:
        if getattr(a, name) is not None:
            assert torch.equal(getattr(a, name), getattr(b, name))
    assert not torch.equal(a.support_ids, c.support_ids)
    assert a.support_im.shape == (B, N * K, D)
    assert a.query_im.shape == (B, N * Q, D)
    assert a.support_text.shape == (B, N * K, E)
    assert a.support_y.dtype == a.support_ids.dtype == torch.int32
    assert a.query_y.dtype == a.query_ids.dtype == torch.int32
    # distinct images within each task (every class has >= K+Q images)
    for task in range(B):
        seen = torch.cat([a.support_ids[task], a.query_ids[task]])
        assert len(torch.unique(seen)) == N * (K + Q)
    # the all-zeros episode has the same geometry and dtypes
    z = smp.spec.zeros("cpu")
    for name in Episode._fields:
        x, y = getattr(a, name), getattr(z, name)
        assert (x is None) == (y is None)
        if x is not None:
            assert (x.shape, x.dtype) == (y.shape, y.dtype), name
    assert torch.equal(z.support_y, a.support_y)


def test_augmentation_bounds_and_clean_queries():
    s = 0.1
    plain = _port_sampler().sample(_port_sampler().generator(3))
    aug_smp = _port_sampler(augment_scale=s)
    aug = aug_smp.sample(aug_smp.generator(3))
    # same noise order: classes and images are picked identically
    for name in ("support_ids", "query_ids", "support_y", "query_y",
                 "support_text", "query_im"):
        assert torch.equal(getattr(aug, name), getattr(plain, name)), name
    assert not torch.equal(aug.support_im, plain.support_im)
    ratio = aug.support_im / plain.support_im
    assert float(ratio.min()) >= 1 - s - 1e-6
    assert float(ratio.max()) <= 1 + s + 1e-6


def test_episode_from_noise_jitters_by_noise_or_by_seed():
    """The support jitter comes from ``aug_noise`` or from ``aug_seed``
    through ``augment_embeddings`` (never both); queries stay clean, and
    a seed at scale 0 leaves the episode as it is."""
    j_tables, t_tables = _tables("float32", COUNTS["even"])
    spec = EpisodeSpec(B, N, K, Q, D, E)
    cls_noise, img_noise, aug = _jax_noise(jax.random.PRNGKey(0), 7, 9, 0.1)
    plain = sampler.episode_from_noise(t_tables, spec, cls_noise, img_noise)
    seed = torch.tensor([99], dtype=torch.int64)
    by_seed = sampler.episode_from_noise(t_tables, spec, cls_noise,
                                         img_noise, aug_seed=seed,
                                         augment_scale=0.1)
    want = kernels.augment_embeddings(plain.support_im.reshape(B * N * K, D),
                                      seed, 0.1).reshape(B, N * K, D)
    assert torch.equal(by_seed.support_im, want)
    assert torch.equal(by_seed.query_im, plain.query_im)
    unjittered = sampler.episode_from_noise(t_tables, spec, cls_noise,
                                            img_noise, aug_seed=seed,
                                            augment_scale=0.0)
    assert torch.equal(unjittered.support_im, plain.support_im)
    with pytest.raises(ValueError, match="not both"):
        sampler.episode_from_noise(t_tables, spec, cls_noise, img_noise,
                                   aug_noise=aug, aug_seed=seed,
                                   augment_scale=0.1)
