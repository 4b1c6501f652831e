"""The port's fused test-time adaptation against the JAX package's.

``fused_adapt_reference`` (the plain PyTorch version of the CUDA kernel)
is held against the Pallas kernel run in interpret mode on the CPU, and
against a plain autograd SGD loop. The CUDA kernel itself is held against
the reference on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fumi_tpu.models import mlp as jax_mlp
from fumi_tpu.models import text_encoders as jax_te
from fumi_tpu.models.fumi import FUMI as JaxFUMI
from fumi_tpu.ops import pallas_kernels as pk
from fumi_tpu_torch import bridge
from fumi_tpu_torch.models import mlp
from fumi_tpu_torch.ops import fewshot, kernels

B, N, K, QN, D, H, E = 2, 3, 2, 4, 16, (8, 8), 8
STEPS, STEP = 10, 0.1
TOL = dict(rtol=2e-5, atol=2e-5)  # the tolerance tests/test_pallas.py holds


def episodes(seed):
    rng = np.random.RandomState(seed)
    sx = rng.randn(B, N * K, D).astype(np.float32)
    qx = rng.randn(B, N * QN, D).astype(np.float32)
    sy = np.tile(np.repeat(np.arange(N), K), (B, 1)).astype(np.int32)
    return sx, sy, qx


def t(x):
    return torch.from_numpy(np.array(x))


def jax_fumi():
    enc = jax_te.make_text_encoder("precomputed", jax.random.PRNGKey(1), E)
    model = JaxFUMI(n_way=N, im_emb_dim=D, im_hid_dim=H, text_encoder=enc,
                    text_emb_dim=E, text_hid_dim=8, dropout_rate=0.0,
                    norm_hypernet=True, fine_tune=False, init_bias=False)
    return model, model.init_params(jax.random.PRNGKey(0))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_reference_matches_jax_fused_maml():
    params = jax_mlp.init(jax.random.PRNGKey(0), D, N, H)
    sx, sy, qx = episodes(0)
    want = pk.fused_maml_adapt(params, jnp.asarray(sx), jnp.asarray(sy),
                               jnp.asarray(qx), STEPS, STEP, interpret=True)
    p = bridge.params_from_jax(np_tree(params), "maml", device="cpu")
    got = kernels.fused_maml_adapt(p, t(sx), t(sy), t(qx), STEPS, STEP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_reference_matches_jax_fused_fumi():
    model, params = jax_fumi()
    sx, sy, qx = episodes(1)
    st = np.random.RandomState(2).randn(B, N * K, E).astype(np.float32)
    hyper0 = jax.vmap(lambda a, b: model.get_hyper_params(
        params, a, b, rng=jax.random.PRNGKey(0)))(jnp.asarray(st),
                                                   jnp.asarray(sy))
    want = pk.fused_fumi_adapt(params["im_net"], hyper0, jnp.asarray(sx),
                               jnp.asarray(sy), jnp.asarray(qx), STEPS, STEP,
                               interpret=True)
    p = bridge.params_from_jax(np_tree(params), "fumi", device="cpu")
    got = kernels.fused_fumi_adapt(p, t(np.asarray(hyper0)), t(sx), t(sy),
                                   t(qx), STEPS, STEP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("per_task_head", [False, True])
def test_reference_matches_autograd_sgd(per_task_head):
    """The hand-derived backward equals autograd's on the same loop."""
    gen = torch.Generator().manual_seed(3)
    p = mlp.init(gen, D, N, H)
    sx, sy, qx = (t(a) for a in episodes(3))
    head_w = p["net.lin_final.weight"].expand(B, N, H[1]).clone()
    head_b = p["net.lin_final.bias"].expand(B, 1, N).clone()
    if per_task_head:
        head_w = head_w + 0.1 * torch.randn(head_w.shape, generator=gen)
        head_b = head_b + 0.1 * torch.randn(head_b.shape, generator=gen)
    got = kernels.fused_adapt_reference(
        p["net.lin_0.weight"], p["net.lin_0.bias"], p["net.lin_1.weight"],
        p["net.lin_1.bias"], head_w, head_b, sx, sy, qx, STEPS, STEP)

    want = []
    for b in range(B):
        q = {k: v.clone() for k, v in p.items()}
        q["net.lin_final.weight"] = head_w[b].clone()
        q["net.lin_final.bias"] = head_b[b, 0].clone()
        for _ in range(STEPS):
            leaves = {k: v.requires_grad_() for k, v in q.items()}
            loss = fewshot.cross_entropy(mlp.apply(leaves, sx[b]), sy[b])
            grads = torch.autograd.grad(loss, list(leaves.values()))
            q = {k: (v - STEP * g).detach()
                 for (k, v), g in zip(leaves.items(), grads)}
        want.append(mlp.apply(q, qx[b]))
    np.testing.assert_allclose(got.numpy(), torch.stack(want).numpy(), **TOL)


def test_wrapper_on_cpu_is_the_reference():
    gen = torch.Generator().manual_seed(4)
    p = mlp.init(gen, D, N, H)
    sx, sy, qx = (t(a) for a in episodes(4))
    before = kernels.fused_adapt.launches
    a = kernels.fused_maml_adapt(p, sx, sy, qx, STEPS, STEP)
    head_w = p["net.lin_final.weight"].expand(B, N, H[1]).contiguous()
    head_b = p["net.lin_final.bias"].expand(B, 1, N).contiguous()
    b = kernels.fused_adapt_reference(
        p["net.lin_0.weight"], p["net.lin_0.bias"], p["net.lin_1.weight"],
        p["net.lin_1.bias"], head_w, head_b, sx, sy, qx, STEPS, STEP)
    assert torch.equal(a, b)
    assert kernels.fused_adapt.launches == before  # no kernel on the CPU


def test_reference_in_fp64_is_the_same_loop():
    """The fp64 evaluation (the accuracy yardstick on the card) runs the
    same loop; the wrapper itself takes fp32 only."""
    gen = torch.Generator().manual_seed(9)
    p = mlp.init(gen, D, N, H)
    sx, sy, qx = (t(a) for a in episodes(9))
    args = (p["net.lin_0.weight"], p["net.lin_0.bias"],
            p["net.lin_1.weight"], p["net.lin_1.bias"],
            p["net.lin_final.weight"].expand(B, N, H[1]).contiguous(),
            p["net.lin_final.bias"].expand(B, 1, N).contiguous(), sx, sy, qx)
    f32 = kernels.fused_adapt_reference(*args, STEPS, STEP)
    wide = tuple(a if a.dtype == torch.int32 else a.double() for a in args)
    f64 = kernels.fused_adapt_reference(*wide, STEPS, STEP)
    assert f64.dtype == torch.float64
    np.testing.assert_allclose(f32.numpy(), f64.numpy(), **TOL)
    with pytest.raises(TypeError):
        kernels.fused_adapt(*wide, STEPS, STEP)


@pytest.mark.parametrize("family", ["maml", "fumi"])
def test_rejects_wrong_depth(family):
    sx, sy, qx = (t(a) for a in episodes(5))
    gen = torch.Generator().manual_seed(0)
    if family == "maml":
        with pytest.raises(ValueError):
            kernels.fused_maml_adapt(mlp.init(gen, D, N, (8,)), sx, sy, qx,
                                     1, STEP)
    else:
        im = {"im_net.linear0.weight": torch.zeros(8, D),
              "im_net.linear0.bias": torch.zeros(8)}
        with pytest.raises(ValueError):
            kernels.fused_fumi_adapt(im, torch.zeros(B, N, 9), sx, sy, qx,
                                     1, STEP)


@pytest.mark.parametrize("bad", ["support_x", "w1", "head_w", "labels"])
def test_rejects_wrong_dtype(bad):
    gen = torch.Generator().manual_seed(0)
    p = mlp.init(gen, D, N, H)
    sx, sy, qx = (t(a) for a in episodes(6))
    args = dict(w1=p["net.lin_0.weight"], b1=p["net.lin_0.bias"],
                w2=p["net.lin_1.weight"], b2=p["net.lin_1.bias"],
                head_w=torch.zeros(B, N, H[1]), head_b=torch.zeros(B, 1, N),
                support_x=sx, support_y=sy, query_x=qx)
    if bad == "labels":
        args["support_y"] = sy.long()
    else:
        args[bad] = args[bad].double()
    with pytest.raises(TypeError):
        kernels.fused_adapt(n_steps=1, step_size=STEP, **args)


def test_rejects_wrong_shape():
    gen = torch.Generator().manual_seed(0)
    p = mlp.init(gen, D, N, H)
    sx, sy, qx = (t(a) for a in episodes(7))
    with pytest.raises(ValueError):
        kernels.fused_adapt(p["net.lin_0.weight"], p["net.lin_0.bias"],
                            p["net.lin_1.weight"], p["net.lin_1.bias"],
                            torch.zeros(B, N, H[1] + 1),
                            torch.zeros(B, 1, N), sx, sy, qx, 1, STEP)


def test_gate():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert kernels.fused_adapt_supported((256, 64), 100, cuda)
    assert not kernels.fused_adapt_supported((256, 64), 100, cpu)
    assert not kernels.fused_adapt_supported((256,), 100, cuda)
    assert not kernels.fused_adapt_supported((256, 64), 7, cuda)
    assert kernels.fused_adapt_applicable("fumi", "precomputed", (256, 64),
                                          8, cuda)
    assert not kernels.fused_adapt_applicable("am3", "precomputed",
                                              (256, 64), 100, cuda)
    assert not kernels.fused_adapt_applicable("maml", "conv4", (256, 64),
                                              100, cuda)
