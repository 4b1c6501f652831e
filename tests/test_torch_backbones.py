"""The raw-image backbones (conv4, resnet12) in the port against the JAX
package's, on the CPU: the norm, the pool, the blocks, whole backbones on
shared and per-task weights, the bridge and rematerialization. Sizes and
tolerances:
``tests/torch_raw_helpers.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_raw_helpers import *  # noqa: F401,F403
from fumi_tpu_torch.metalearn import inner_loop


@pytest.fixture(scope="module")
def raw_episodes():
    return make_raw_episodes()


# ---------------------------------------------------------------------------
# units: the norm, the pool, the blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("low", [False, True], ids=["two-pass", "one-pass"])
def test_batch_stat_norm_both_forms(low):
    """Per-channel statistics over (M, H, W): the fp32 two-pass form and
    the bf16 one-pass E[x²]−E[x]² form with its clamp."""
    y = images(6, 1, (5, 5, 4)) * 3 + 1
    p = {"b": np.linspace(-1, 1, 4).astype(np.float32),
         "gamma": np.linspace(0.5, 2, 4).astype(np.float32),
         "beta": np.linspace(-0.3, 0.3, 4).astype(np.float32)}
    jy = jnp.asarray(y).astype(jnp.bfloat16) if low else jnp.asarray(y)
    want = jax_conv4.batch_stat_norm(jy, {k: jnp.asarray(v) for k, v in
                                          p.items()}, low)
    ty = nchw(y).to(torch.bfloat16) if low else nchw(y)
    got = conv4.batch_stat_norm(ty, {"bias": torch.from_numpy(p["b"]),
                                     "gamma": torch.from_numpy(p["gamma"]),
                                     "beta": torch.from_numpy(p["beta"])},
                                low)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


def test_maxpool_splits_a_tied_windows_gradient():
    """The reshape-and-max pool floors odd sizes and splits a tied
    window's cotangent evenly, as the JAX package's pool does (second-order
    MAML differentiates through it)."""
    x = np.round(images(2, 2, (5, 7, 3)))  # many exact ties
    x[0, :2, :2, 0] = 1.0  # a fully tied window
    w = images(2, 3, (2, 3, 3))
    want_y, vjp = jax.vjp(jax_conv4.maxpool2x2, jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(w))
    tx = nchw(x).requires_grad_()
    got_y = conv4.maxpool2x2(tx)
    (got_g,) = torch.autograd.grad(got_y, tx, nchw(w))
    np.testing.assert_array_equal(nhwc(got_y), np.asarray(want_y))
    np.testing.assert_allclose(nhwc(got_g), np.asarray(want_g), **TOL)
    assert nhwc(got_g)[0, 0, 0, 0] == pytest.approx(0.25 * w[0, 0, 0, 0])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_conv_block(dtype):
    """Conv3×3 (SAME) → norm → ReLU → pool on bridged HWIO→OIHW weights."""
    jcd, tcd = cd_pair(dtype)
    jp = jax_unit("conv4")
    x = images(4, 4, (9, 9, 3))
    want = jax_conv4.conv_block(jp, jnp.asarray(x), jcd)
    tp = {"weight": torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(jp["w"]), (3, 2, 0, 1)))),
        "bias": torch.from_numpy(np.asarray(jp["b"])),
        "gamma": torch.from_numpy(np.asarray(jp["gamma"])),
        "beta": torch.from_numpy(np.asarray(jp["beta"]))}
    got = conv4.conv_block(tp, nchw(x), tcd)
    assert got.shape == (4, 8, 4, 4)
    if dtype == "fp32":
        np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)
    else:
        assert got.dtype == torch.bfloat16
        assert_bf16_close(nhwc(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_res_block(dtype):
    """Three conv-norm(-leaky) units, the 1×1 projected shortcut (padding
    0), leaky, pool."""
    jcd, tcd = cd_pair(dtype)
    jp = jax_unit("resnet12")
    x = images(4, 5, (8, 8, 3))
    want = jax.jit(jax_resnet12.res_block, static_argnums=2)(
        jp, jnp.asarray(x), jcd)
    tp = bridge.params_from_jax(np_tree({"blocks": (jp,), "head": {
        "w": np.zeros((1, 8), np.float32), "b": np.zeros(1, np.float32)}}),
        "maml", device="cpu")
    got = resnet12.res_block(tp, "blocks.0", nchw(x), 1, tcd)
    if dtype == "fp32":
        np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)
    else:
        assert_bf16_close(nhwc(got), np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# whole backbones: shared weights, per-task weights, the flatten order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_backbone_and_apply(kind, dtype):
    """Features (conv4's in NHWC flatten order: the head's columns match
    the bridged weights) and logits of M shared-weight images."""
    jcd, tcd = cd_pair(dtype)
    jp = jax_init(kind)
    x = images(6, 6)
    tp = port_params(jp)
    backbone = jax.jit(JNETS[kind].backbone, static_argnums=2)
    apply = jax.jit(JNETS[kind].apply, static_argnums=2)
    want_f = backbone(jp, jnp.asarray(x), jcd)
    want = apply(jp, jnp.asarray(x), jcd)
    got_f = NETS[kind].backbone(tp, torch.from_numpy(x), tcd)
    got = NETS[kind].apply(tp, torch.from_numpy(x), tcd)
    assert got_f.dtype == torch.float32 and got.shape == (6, N)
    if dtype == "fp32":
        np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), **TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    else:
        assert_bf16_close(got_f.numpy(), want_f,
                          backbone(jp, jnp.asarray(x), None))
        assert_bf16_close(got.numpy(), want, apply(jp, jnp.asarray(x), None))


def test_conv4_flatten_keeps_nhwc_order():
    """At 32×32 conv4 leaves 2×2×64 features: the port's flatten is the
    JAX package's ``reshape`` of NHWC, not torch's NCHW flatten."""
    jp = jax_conv4.init(jax.random.PRNGKey(3), 32, 3, n_way=N)
    x = images(3, 7, (32, 32, 3))
    want = np.asarray(jax_conv4.backbone(jp, jnp.asarray(x)))
    got = conv4.backbone(port_params(jp), torch.from_numpy(x)).numpy()
    assert got.shape == (3, 2 * 2 * 64)
    np.testing.assert_allclose(got, want, **TOL)
    nchw_order = want.reshape(3, 2, 2, 64).transpose(0, 3, 1, 2).reshape(3,
                                                                         -1)
    assert not np.allclose(got, nchw_order)


@pytest.mark.parametrize("kind", KINDS)
def test_per_task_weights_take_per_task_statistics(kind):
    """B tasks with their own weights (a leading B on every leaf) through
    one grouped convolution equal the JAX package's ``vmap`` of one task:
    each task normalizes with its own (M, H, W) statistics."""
    trees = [jax_init(kind, key=k) for k in range(B)]
    x = images(B * 4, 8).reshape(B, 4, S, S, 3)
    want = jax.jit(jax.vmap(JNETS[kind].apply))(
        jax.tree_util.tree_map(lambda *a: jnp.stack(a), *trees),
        jnp.asarray(x))
    ports = [port_params(t) for t in trees]
    tp = {k: torch.stack([p[k] for p in ports]) for k in ports[0]}
    got = NETS[kind].apply(tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    pooled = jax.jit(JNETS[kind].apply)(trees[0],
                                        jnp.asarray(x.reshape(-1, S, S, 3)))
    assert not np.allclose(np.asarray(pooled)[:4], np.asarray(want)[0],
                           atol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("model", FAMILIES)
def test_bridge_round_trip(model, kind):
    """JAX tree → the port's names (kernels HWIO→OIHW) → the same tree."""
    jcfg, jfam = jax_family(model, kind)
    tree = np_tree(jfam.params)
    params = bridge.params_from_jax(tree, model, device="cpu")
    back = bridge.params_to_numpy(params, model)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    cfg = Config(**cfg_kw(model, kind))
    fam = steps.build_family(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in fam.params.items()}
    conv = [k for k, v in params.items() if v.dim() == 4]
    assert conv and all(params[k].shape[-1] in (1, 3) for k in conv)




# ---------------------------------------------------------------------------
# remat: memory, never the numbers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", ["on", "auto"])
@pytest.mark.parametrize("kind", KINDS)
def test_remat_equals_no_remat(raw_episodes, kind, remat):
    """``--tpu_remat on`` (whole-step checkpointing) and ``auto`` (for
    resnet12 the ``save_convs`` policy, whole-step in the port) give the
    loss and meta-gradient of ``off``."""
    cfg = Config(**cfg_kw("maml", kind, remat=remat))
    off = Config(**cfg_kw("maml", kind, remat="off"))
    assert inner_loop.remat_active(steps.remat_of(cfg), 2) == \
        (remat == "on" or kind == "resnet12")
    assert steps.remat_of(off) is False
    fam = steps.build_family(cfg, torch.Generator().manual_seed(0))
    ref = steps.build_family(off, torch.Generator().manual_seed(0))
    ep = to_port(raw_episodes[0])
    (l1, _), g1 = steps.value_and_grad(fam, fam.params, ep, None)
    (l0, _), g0 = steps.value_and_grad(ref, ref.params, ep, None)
    assert float(l1) == pytest.approx(float(l0), rel=1e-6, abs=1e-7)
    assert_grads_close(g1, g0, 1e-6)


@pytest.mark.parametrize("tasks", ["shared", "per-task"])
def test_block_remat_matches_the_jax_package(tasks, monkeypatch):
    """``conv4.BLOCK_REMAT`` on in both packages (``jax.checkpoint`` of
    each block there, ``torch.utils.checkpoint`` here): the backbone's
    features and the first-order gradient of their sum w.r.t. every conv
    param on bridged weights, shared by 6 images or per task (B tasks of
    4); the features to ``TOL``, the gradient to 1e-5 of its largest
    entry (the module docstring's tolerances)."""
    monkeypatch.setattr(jax_conv4, "BLOCK_REMAT", True)
    monkeypatch.setattr(conv4, "BLOCK_REMAT", True)
    trees = [jax_init("conv4", key=k) for k in range(B)]
    if tasks == "shared":
        trees, x, feats = trees[:1], images(6, 9), jax_conv4.backbone
    else:
        x = images(B * 4, 9).reshape(B, 4, S, S, 3)
        feats = jax.vmap(jax_conv4.backbone)
    jp = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *trees) \
        if tasks == "per-task" else trees[0]
    # traced here, so under the flag (the JAX package reads it at trace
    # time)
    want_f = jax.jit(lambda p, im: feats(p, im))(jp, jnp.asarray(x))
    want_g = jax.jit(jax.grad(lambda p, im: jnp.sum(feats(p, im))))(
        jp, jnp.asarray(x))
    ports = [port_params(t) for t in trees]
    leaves = {k: (torch.stack([p[k] for p in ports]) if tasks == "per-task"
                  else ports[0][k]).requires_grad_() for k in ports[0]}
    got_f = conv4.backbone(leaves, torch.from_numpy(x))
    np.testing.assert_allclose(got_f.detach().numpy(), np.asarray(want_f),
                               **TOL)
    body = [k for k in leaves if not k.startswith("head.")]
    got_g = dict(zip(body, torch.autograd.grad(
        got_f.sum(), [leaves[k] for k in body])))
    for b in range(len(trees)):
        want_b = np_tree(want_g) if tasks == "shared" else \
            jax.tree_util.tree_map(lambda a: np.asarray(a)[b], want_g)
        got_b = {k: v if tasks == "shared" else v[b]
                 for k, v in got_g.items()}
        got_b.update({k: torch.zeros_like(ports[0][k]) for k in leaves
                      if k not in got_g})
        assert not np.any(want_b["head"]["w"])
        assert_grads_close(bridge.params_to_numpy(got_b, "maml")["convs"],
                           want_b["convs"], 1e-5)


def test_remat_replays_the_dropout_generator():
    """A checkpointed FuMI step draws its dropout masks from the step's
    generator: the recompute replays them, and the generator ends where
    the run without remat leaves it."""
    kw = dict(model="fumi", dataset="synthetic", im_emb_dim=12,
              text_emb_dim=E, im_hid_dim=(8, 6), text_hid_dim=8, num_ways=3,
              num_shots=2, num_shots_test=2, batch_size=2,
              num_train_adapt_steps=3, step_size=0.1, dropout=0.3,
              text_encoder="BERT")
    rs = np.random.RandomState(0)
    ep = steps_episode(rs, 2, 3, 2, 12, E)
    out = {}
    for remat in ("on", "off"):
        cfg = Config(**kw, remat=remat)
        fam = steps.build_family(cfg, torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(5)
        (loss, _), g = steps.value_and_grad(fam, fam.params, ep, gen)
        out[remat] = (float(loss), g, torch.rand(1, generator=gen))
    assert out["on"][0] == pytest.approx(out["off"][0], rel=1e-6)
    assert_grads_close(out["on"][1], out["off"][1], 1e-6)
    assert torch.equal(out["on"][2], out["off"][2])


