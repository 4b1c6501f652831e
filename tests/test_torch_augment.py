"""The port's embedding jitter (``--augment``) on the CPU, and the widening
row gathers that carry it as their epilogue (``gather_augment_rows``,
``gather_episode_rows``).

``augment_embeddings_reference`` is the plain version of the CUDA kernel
(``tests/test_torch_cuda.py`` holds the two bitwise equal on the card).
Its generator is its own (Philox4x32-10 keyed by the seed), so against
the JAX package it is held to the same properties, not the same bits:
the bounds of the jitter, clean queries, determinism per seed,
``scale=0`` as the identity, independence from how the rows are split,
and the first two moments of U[-s, s) within 4 sigma over 2e5 draws.
JAX's own kernel and reference are run on the same checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fumi_tpu.ops import pallas_kernels as pk
from fumi_tpu_torch.core.episode import EpisodeSpec
from fumi_tpu_torch.data import sampler, synthetic
from fumi_tpu_torch.ops import kernels

SCALE = 0.1


def seed_of(value: int) -> torch.Tensor:
    return torch.tensor([value], dtype=torch.int64)


def x_of(rows, width, seed=0):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(rows, width).astype(np.float32))


# Philox4x32-10 known-answer vectors of Random123 (kat_vectors)
KAT = [((0, 0, 0, 0), (0, 0),
        (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
       ((0xffffffff,) * 4, (0xffffffff,) * 2,
        (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
       ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
        (0xa4093822, 0x299f31d0),
        (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]


@pytest.mark.parametrize("counter,key,want", KAT)
def test_philox_known_answers(counter, key, want):
    got = kernels.philox4x32_10(torch.tensor([counter], dtype=torch.int64),
                                torch.tensor(key, dtype=torch.int64))
    assert tuple(int(v) for v in got[0]) == want


@pytest.mark.parametrize("shape", [(64, 32), (37, 99), (1, 1), (100, 2048)])
def test_ratio_within_bounds_and_moved(shape):
    x = x_of(*shape)
    out = kernels.augment_embeddings(x, seed_of(7), SCALE)
    # 1 + jitter rounds to fp32 (1.1f is 1.10000002), and so does x times
    # it: 1e-6 of slack, as tests/test_pallas.py allows
    ratio = (out / x).double()
    assert float(ratio.min()) >= 1 - SCALE - 1e-6
    assert float(ratio.max()) <= 1 + SCALE + 1e-6
    assert out.shape == x.shape and out.dtype == torch.float32
    if x.numel() > 1:
        assert not torch.equal(out, x)


def test_deterministic_per_seed_and_seeds_differ():
    x = x_of(40, 24)
    a = kernels.augment_embeddings(x, seed_of(3))
    assert torch.equal(a, kernels.augment_embeddings(x, seed_of(3)))
    for other in (4, 3 + 2 ** 32, 2 ** 62 - 1):
        assert not torch.equal(a, kernels.augment_embeddings(x,
                                                             seed_of(other)))


def test_scale_zero_is_the_identity():
    x = x_of(33, 17)
    assert torch.equal(kernels.augment_embeddings(x, seed_of(1), 0.0), x)
    # as JAX's kernel mapping and reference give x back at scale 0
    j = np.asarray(pk.augment_embeddings_reference(
        jnp.asarray(x.numpy()), jax.random.PRNGKey(0), 0.0))
    np.testing.assert_array_equal(j, x.numpy())


@pytest.mark.parametrize("cuts", [(1,), (10, 11), (5, 20, 36)])
def test_rows_split_jitter_as_the_whole(cuts):
    x, s = x_of(37, 99), seed_of(11)
    whole = kernels.augment_embeddings(x, s, SCALE)
    bounds = (0,) + cuts + (37,)
    pieces = [kernels.augment_embeddings(x[a:b], s, SCALE, row_offset=a)
              for a, b in zip(bounds[:-1], bounds[1:])]
    assert torch.equal(torch.cat(pieces), whole)


def test_jitter_moments_match_uniform():
    """Mean 0 and variance s^2/3 of U[-s, s) within 4 sigma of their
    sampling spread over 2e5 draws."""
    x = torch.ones(200, 1000)
    j = (kernels.augment_embeddings(x, seed_of(5), SCALE) - 1.0).double()
    n = j.numel()
    var = SCALE ** 2 / 3
    assert abs(float(j.mean())) <= 4 * (var / n) ** 0.5
    # Var of (u^2) for u ~ U[-s, s): s^4/5 - s^4/9
    var_of_sq = SCALE ** 4 / 5 - SCALE ** 4 / 9
    assert abs(float((j ** 2).mean()) - var) <= 4 * (var_of_sq / n) ** 0.5


def test_wrapper_errors_and_no_launch_on_the_cpu():
    x, s = x_of(4, 8), seed_of(1)
    before = kernels.augment_embeddings.launches
    with pytest.raises(ValueError, match="contiguous"):
        kernels.augment_embeddings(x_of(8, 4).t(), s)
    with pytest.raises(TypeError, match="float32"):
        kernels.augment_embeddings(x.double(), s)
    with pytest.raises(TypeError, match="float32"):
        kernels.augment_embeddings(x.reshape(2, 2, 8), s)
    with pytest.raises(TypeError, match="int64"):
        kernels.augment_embeddings(x, s.int())
    with pytest.raises(TypeError, match="one-element"):
        kernels.augment_embeddings(x, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="seed on meta"):
        kernels.augment_embeddings(x, s.to("meta"))
    with pytest.raises(ValueError, match="row_offset"):
        kernels.augment_embeddings(x, s, row_offset=-1)
    kernels.augment_embeddings(x, s)
    assert kernels.augment_embeddings.launches == before


# ---------------------------------------------------------------------------
# the jitter as the epilogue of the support gather
# ---------------------------------------------------------------------------

def table_of(dtype, rows, width, seed=0):
    rng = np.random.RandomState(seed)
    if dtype == torch.uint8:
        return torch.from_numpy(rng.randint(0, 256, (rows, width))
                                .astype(np.uint8))
    return torch.from_numpy(rng.randn(rows, width).astype(np.float32)
                            ).to(dtype)


def widened(table: torch.Tensor) -> np.ndarray:
    """pixels_to_float in numpy: bf16 bits shifted into fp32, uint8 times
    1/255 rounded to fp32, in one fp32 product."""
    if table.dtype == torch.bfloat16:
        bits = table.view(torch.int16).numpy().astype(np.uint16)
        return (bits.astype(np.uint32) << 16).view(np.float32)
    if table.dtype == torch.uint8:
        return table.numpy().astype(np.float32) * np.float32(1.0 / 255.0)
    return table.numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.uint8], ids=str)
@pytest.mark.parametrize("width", [5, 8, 2048])
def test_gather_augment_rows_is_the_composition(dtype, width):
    """Bitwise ``augment_embeddings_reference(pixels_to_float(
    gather_rows_reference(...)))``, for several seeds and row offsets and
    M = 0; and, computed apart in numpy, the widened rows times the
    jitter factor (the jitter of a row of ones), one fp32 product each."""
    table = table_of(dtype, 30, width)
    idx = torch.from_numpy(
        np.random.RandomState(width).randint(0, 30, 12).astype(np.int32))
    for seed, offset in ((1, 0), (2 ** 62 - 3, 0), (7, 5), (7, 2 ** 33)):
        s = seed_of(seed)
        got = kernels.gather_augment_rows(table, idx, s, SCALE, offset)
        want = kernels.augment_embeddings_reference(
            sampler.pixels_to_float(kernels.gather_rows_reference(table,
                                                                  idx)),
            s, SCALE, offset)
        assert got.dtype == torch.float32 and got.shape == (12, width)
        assert torch.equal(got, want)
        assert torch.equal(got, kernels.gather_augment_rows_reference(
            table, idx, s, SCALE, offset))
        factor = kernels.augment_embeddings_reference(
            torch.ones(12, width), s, SCALE, offset).numpy()
        np.testing.assert_array_equal(
            got.numpy(), widened(table)[idx.numpy()] * factor)
    empty = kernels.gather_augment_rows(
        table, torch.zeros(0, dtype=torch.int32), seed_of(1), SCALE)
    assert empty.shape == (0, width) and empty.dtype == torch.float32


@pytest.mark.parametrize("cuts", [(1,), (4, 9)])
def test_gather_augment_rows_split_jitter_as_the_whole(cuts):
    table, s = table_of(torch.uint8, 20, 13), seed_of(4)
    idx = torch.arange(19, -1, -1, dtype=torch.int32)
    whole = kernels.gather_augment_rows(table, idx, s, SCALE)
    bounds = (0,) + cuts + (20,)
    pieces = [kernels.gather_augment_rows(table, idx[a:b], s, SCALE,
                                          row_offset=a)
              for a, b in zip(bounds[:-1], bounds[1:])]
    assert torch.equal(torch.cat(pieces), whole)


def test_gather_augment_rows_errors_and_no_launch_on_the_cpu():
    table, s = table_of(torch.float32, 8, 4), seed_of(1)
    idx = torch.zeros(3, dtype=torch.int32)
    before = kernels.gather_augment_rows.launches
    with pytest.raises(TypeError, match="int32"):
        kernels.gather_augment_rows(table, idx.long(), s)
    with pytest.raises(TypeError, match="int32"):
        kernels.gather_augment_rows(table, idx.reshape(3, 1), s)
    with pytest.raises(ValueError, match="strided"):
        kernels.gather_augment_rows(table_of(torch.float32, 4, 8).t(), idx, s)
    with pytest.raises(ValueError, match="2-D"):
        kernels.gather_augment_rows(table.reshape(2, 4, 4), idx, s)
    with pytest.raises(ValueError, match="indices on meta"):
        kernels.gather_augment_rows(table, idx.to("meta"), s)
    with pytest.raises(ValueError, match="seed on meta"):
        kernels.gather_augment_rows(table, idx, s.to("meta"))
    with pytest.raises(TypeError, match="int64"):
        kernels.gather_augment_rows(table, idx, s.int())
    with pytest.raises(TypeError, match="one-element"):
        kernels.gather_augment_rows(table, idx,
                                    torch.zeros(2, dtype=torch.int64))
    with pytest.raises(TypeError, match="uint8 tables"):
        kernels.gather_augment_rows(table.double(), idx, s)
    with pytest.raises(ValueError, match="row_offset"):
        kernels.gather_augment_rows(table, idx, s, row_offset=-1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.gather_augment_rows(table.to("meta"), idx.to("meta"),
                                    s.to("meta"))
    kernels.gather_augment_rows(table, idx, s)
    assert kernels.gather_augment_rows.launches == before


# (B, N, K, Q): the flagship train episode, a small one, K+Q of 1 either way
EPISODES = [(4, 5, 5, 32), (2, 3, 2, 4), (3, 2, 1, 0), (2, 2, 0, 1)]


@pytest.mark.parametrize("seeded", [False, True], ids=["plain", "seeded"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.uint8], ids=str)
@pytest.mark.parametrize("width", [99, 2048])
def test_gather_episode_rows_is_the_composition(dtype, width, seeded):
    """Bitwise the composition it replaces: each segment gathered and
    widened, the support rows jittered as ``gather_augment_rows`` jitters
    the support indices (and, computed apart in numpy, widened rows times
    the jitter of a row of ones); rows repeat, as too-small classes draw
    them with replacement."""
    table = table_of(dtype, 30, width, seed=width)
    rng = np.random.RandomState(width + seeded)
    for b, n, k, q in EPISODES:
        rows = torch.from_numpy(rng.randint(0, 30, (b, n, k + q))
                                .astype(np.int32))
        seed = seed_of(2 ** 62 - 7) if seeded else None
        scale = SCALE if seeded else 0.0
        got = kernels.gather_episode_rows(table, rows, k, seed, scale)
        want = kernels.gather_episode_rows_reference(table, rows, k, seed,
                                                     scale)
        s_idx = rows[..., :k].reshape(-1)
        q_idx = rows[..., k:].reshape(-1)
        support = sampler.pixels_to_float(
            kernels.gather_rows_reference(table, s_idx))
        if seeded:
            support = kernels.augment_embeddings_reference(support, seed,
                                                           SCALE)
            assert torch.equal(support, kernels.gather_augment_rows(
                table, s_idx, seed, SCALE))
        query = sampler.pixels_to_float(
            kernels.gather_rows_reference(table, q_idx))
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and torch.equal(g, w)
        assert got[0].shape == (b, n * k, width)
        assert got[1].shape == (b, n * q, width)
        assert torch.equal(got[0].reshape(-1, width), support)
        assert torch.equal(got[1].reshape(-1, width), query)
        factor = (kernels.augment_embeddings_reference(
            torch.ones(b * n * k, width), seed, SCALE).numpy()
            if seeded else np.float32(1.0))
        np.testing.assert_array_equal(
            got[0].reshape(-1, width).numpy(),
            widened(table)[s_idx.numpy()] * factor)
        np.testing.assert_array_equal(got[1].reshape(-1, width).numpy(),
                                      widened(table)[q_idx.numpy()])


def test_gather_episode_rows_errors_and_no_launch_on_the_cpu():
    table, s = table_of(torch.float32, 8, 4), seed_of(1)
    rows = torch.zeros(2, 3, 5, dtype=torch.int32)
    before = kernels.gather_episode_rows.launches
    with pytest.raises(TypeError, match="int32 rows"):
        kernels.gather_episode_rows(table, rows.long(), 2)
    with pytest.raises(TypeError, match="int32 rows"):
        kernels.gather_episode_rows(table, rows.reshape(6, 5), 2)
    with pytest.raises(TypeError, match="uint8 tables"):
        kernels.gather_episode_rows(table.double(), rows, 2)
    with pytest.raises(ValueError, match="strided"):
        kernels.gather_episode_rows(table_of(torch.float32, 4, 8).t(), rows,
                                    2)
    with pytest.raises(ValueError, match="2-D"):
        kernels.gather_episode_rows(table.reshape(2, 4, 4), rows, 2)
    with pytest.raises(ValueError, match="indices on meta"):
        kernels.gather_episode_rows(table, rows.to("meta"), 2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.gather_episode_rows(table.to("meta"), rows.to("meta"), 2)
    for k in (-1, 6):
        with pytest.raises(ValueError, match="num_shots"):
            kernels.gather_episode_rows(table, rows, k)
    with pytest.raises(TypeError, match="int64"):
        kernels.gather_episode_rows(table, rows, 2, s.int(), SCALE)
    with pytest.raises(TypeError, match="one-element"):
        kernels.gather_episode_rows(table, rows, 2,
                                    torch.zeros(2, dtype=torch.int64), SCALE)
    with pytest.raises(ValueError, match="seed on meta"):
        kernels.gather_episode_rows(table, rows, 2, s.to("meta"), SCALE)
    with pytest.raises(ValueError, match="without a seed"):
        kernels.gather_episode_rows(table, rows, 2, None, SCALE)
    support, query = kernels.gather_episode_rows(table, rows, 2, s, SCALE)
    assert support.shape == (2, 6, 4) and query.shape == (2, 9, 4)
    assert kernels.gather_episode_rows.launches == before


# ---------------------------------------------------------------------------
# the same checks as the JAX package's (tests/test_pallas.py:61-100)
# ---------------------------------------------------------------------------

def _jax_kernel_or_none(x, seed):
    try:
        return np.asarray(pk.augment_embeddings(
            jnp.asarray(x), jnp.asarray(seed), scale=SCALE, block_rows=16,
            interpret=True))
    except NotImplementedError:
        return None  # pltpu's PRNG has no interpret rule in this jax


@pytest.mark.parametrize("impl", ["port", "jax_reference", "jax_kernel"])
def test_augment_checks_of_the_jax_package(impl):
    """Bounds, moved, deterministic per seed: test_pallas.py:61-77, run on
    the port and on JAX's reference (and kernel, where its interpret mode
    has a PRNG rule)."""
    x = np.random.RandomState(0).randn(64, 32).astype(np.float32)
    if impl == "port":
        run = lambda: kernels.augment_embeddings(  # noqa: E731
            torch.from_numpy(x), seed_of(7), SCALE).numpy()
    elif impl == "jax_reference":
        run = lambda: np.asarray(pk.augment_embeddings_reference(  # noqa
            jnp.asarray(x), jax.random.PRNGKey(7), SCALE))
    else:
        if _jax_kernel_or_none(x, 7) is None:
            pytest.skip("pltpu PRNG has no CPU interpret rule in this jax "
                        "(as tests/test_pallas.py skips)")
        run = lambda: _jax_kernel_or_none(x, 7)  # noqa: E731
    out = run()
    ratio = out / x
    assert np.all(ratio >= 0.9 - 1e-6) and np.all(ratio < 1.1 + 1e-6)
    assert not np.allclose(out, x)
    np.testing.assert_array_equal(out, run())


def _port_sampler(**kw):
    cs, table, ids = synthetic.synthetic_class_set(
        num_classes=8, images_per_class=16, im_dim=32, text_dim=16)
    return sampler.DeviceEpisodeSampler(table, ids, cs,
                                        EpisodeSpec(2, 3, 2, 4, 32, 16),
                                        device="cpu", **kw)


def test_sampler_augmentation_as_the_jax_package_checks_it():
    """test_pallas.py:80-100 on the port's sampler: same episode identity,
    support jittered within the scale, queries untouched; the sampler's
    jitter is the wrapper's, keyed by the seed its generator draws."""
    plain_smp, aug_smp = _port_sampler(), _port_sampler(augment_scale=SCALE)
    plain = plain_smp.sample(plain_smp.generator(0))
    aug = aug_smp.sample(aug_smp.generator(0))
    assert torch.equal(plain.support_ids, aug.support_ids)
    assert torch.equal(plain.query_im, aug.query_im)
    assert not torch.equal(plain.support_im, aug.support_im)
    ratio = (aug.support_im / plain.support_im).numpy()
    assert np.nanmax(np.abs(ratio - 1.0)) <= SCALE + 1e-5

    gen = aug_smp.generator(0)
    torch.rand((2, 8), generator=gen)  # the class noise
    torch.rand((2, 3, 16), generator=gen)  # the image noise
    seed = torch.randint(0, 2 ** 62, (1,), generator=gen, dtype=torch.int64)
    want = kernels.augment_embeddings_reference(
        plain.support_im.reshape(6 * 2, 32), seed, SCALE).reshape(2, 6, 32)
    assert torch.equal(aug.support_im, want)
