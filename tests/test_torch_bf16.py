"""The bf16 compute policy (``--tpu_compute_dtype bfloat16``) in the port
against the JAX package's, on the CPU, on bridged weights and the same
inputs: the primitives of ``models/layers.py`` and every family's loss
and gradient.

Tolerances. The primitives: a product's result is fp32 from bf16 operands
(never rounded to bf16), equal to JAX's up to the order of fp32 sums:
1e-5 relative; its gradients are rounded to bf16 on both sides, so they
agree within one bf16 ulp (2⁻⁸) of their scale. A convolution's bf16
output within one bf16 ulp. A family's loss and gradient: the two
packages round at other places (XLA on the CPU keeps excess precision
across fused bf16 operations), so they are held within 4 bf16 ulps of the
scale, or 1.5× the distance between JAX's own bf16 and fp32 results (the
policy's own rounding noise), whichever is larger.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fumi_tpu.core.config import Config as JaxConfig
from fumi_tpu.core.episode import EpisodeSpec as JaxSpec
from fumi_tpu.data import sampler as jax_sampler
from fumi_tpu.data.synthetic import synthetic_class_set
from fumi_tpu.models import layers as jax_layers
from fumi_tpu.train import clip_loop as jax_clip_loop
from fumi_tpu.train import steps as jax_steps
from torch_raw_helpers import few_threads  # noqa: F401
from fumi_tpu_torch import bridge
from fumi_tpu_torch.core.config import Config
from fumi_tpu_torch.models import layers
from fumi_tpu_torch.train import clip_loop, steps

B, N, K, Q, D, E, P, TH = 2, 3, 2, 3, 48, 24, 16, 16
BF16 = 2.0 ** -8
FAMILIES = ["maml", "fumi", "am3", "protonet", "matchingnet"]


def rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


def assert_policy_close(got, want, fp32):
    """Within 4 bf16 ulps of the scale, or 1.5× JAX's bf16-to-fp32
    distance."""
    for g, w, f in zip(leaves(got), leaves(want), leaves(fp32)):
        scale = max(float(np.abs(w).max()), 1e-6)
        bound = max(4 * BF16 * scale, 1.5 * float(np.abs(w - f).max()))
        assert float(np.abs(g - w).max()) <= bound


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batched", [False, True])
def test_linear_and_matmul_f32acc(batched):
    """bf16 operands, an fp32 result that is not rounded to bf16, and
    gradients rounded to bf16 then widened (the casts' VJPs)."""
    x = rand(B, 5, 7) if batched else rand(5, 7)
    w, b = rand(4, 7, seed=1), rand(4, seed=2)
    cot = rand(*(x.shape[:-1] + (4,)), seed=3)

    def jf(x_, w_, b_):
        return jax_layers.linear({"w": w_, "b": b_}, x_, jnp.bfloat16)
    want, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    want_g = vjp(jnp.asarray(cot))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    got = layers.linear(tw, tb, tx, torch.bfloat16)
    got_g = torch.autograd.grad(got, (tx, tw, tb), torch.from_numpy(cot))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    rounded = got.detach().to(torch.bfloat16).float()
    assert not torch.equal(rounded, got.detach())  # not rounded to bf16
    for g, wg in zip(got_g, want_g):
        scale = float(np.abs(np.asarray(wg)).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=0,
                                   atol=BF16 * scale)
    m = layers.matmul_f32acc(tx.detach(), tw.detach().T, torch.bfloat16)
    jm = jax_layers.matmul_f32acc(jnp.asarray(x), jnp.asarray(w).T,
                                  jnp.bfloat16)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("keep_dtype", [False, True])
def test_conv2d_f32acc(keep_dtype):
    """bf16 operands and a bf16 output, cast back to fp32 unless
    ``keep_dtype``; NHWC/HWIO in JAX, NCHW/OIHW here."""
    x, w = rand(3, 6, 6, 4), rand(3, 3, 4, 5, seed=1)
    want = jax_layers.conv2d_f32acc(jnp.asarray(x), jnp.asarray(w),
                                    jnp.bfloat16, keep_dtype=keep_dtype)
    got = layers.conv2d_f32acc(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
        torch.bfloat16, padding=1, keep_dtype=keep_dtype)
    assert got.dtype == (torch.bfloat16 if keep_dtype else torch.float32)
    assert np.asarray(want).dtype == (jnp.bfloat16 if keep_dtype
                                      else np.float32)
    g = got.float().permute(0, 2, 3, 1).numpy()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(g, want, rtol=0,
                               atol=BF16 * float(np.abs(want).max()))
    fp32 = layers.conv2d_f32acc(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
        None, padding=1)
    assert fp32.dtype == torch.float32


# ---------------------------------------------------------------------------
# the families in bf16
# ---------------------------------------------------------------------------

def cfg_kw(model, **kw):
    d = dict(model=model, dataset="synthetic", im_emb_dim=D, text_emb_dim=E,
             im_hid_dim=(16, 8), prototype_dim=P, text_hid_dim=TH,
             num_ways=N, num_shots=K, num_shots_test=Q, batch_size=B,
             num_train_adapt_steps=2, step_size=0.1, dropout=0.0,
             text_encoder="BERT", compute_dtype="bfloat16", lr=1e-3, seed=0)
    d.update(kw)
    return d


@pytest.fixture(scope="module")
def jax_episode():
    cs, table, ids = synthetic_class_set(num_classes=8, images_per_class=8,
                                         im_dim=D, text_dim=E)
    smp = jax_sampler.DeviceEpisodeSampler(jnp.asarray(table),
                                           jnp.asarray(ids), cs,
                                           JaxSpec(B, N, K, Q, D, E))
    return smp.sample(jax.random.PRNGKey(0))


def jax_value_and_grad(jfam, params, ep):
    (loss, _), grads = jax.jit(jax.value_and_grad(
        jfam.train_loss, has_aux=True))(params, ep, jax.random.PRNGKey(0))
    return loss, grads


@pytest.mark.parametrize("model", FAMILIES)
def test_family_loss_and_gradient_in_bf16(jax_episode, model):
    """Each family's bf16 loss and gradient against JAX's bf16 ones, on
    the bf16 policy's own scale (JAX's fp32 results beside)."""
    jcfg = JaxConfig(**cfg_kw(model))
    jfam = jax_steps.build_family(jcfg, jax.random.PRNGKey(0))
    j32 = jax_steps.build_family(JaxConfig(**cfg_kw(
        model, compute_dtype="float32")), jax.random.PRNGKey(0))
    cfg = Config(**cfg_kw(model))
    assert steps.compute_dtype_of(cfg) == torch.bfloat16
    fam = steps.build_family(cfg, torch.Generator().manual_seed(0))
    fam = fam._replace(params=bridge.params_from_jax(
        np_tree(jfam.params), model, device="cpu"))
    jl, jg = jax_value_and_grad(jfam, jfam.params, jax_episode)
    fl, fg = jax_value_and_grad(j32, jfam.params, jax_episode)
    (tl, _), tg = steps.value_and_grad(
        fam, fam.params, bridge.episode_from_numpy(np_tree(jax_episode),
                                                   device="cpu"), None)
    assert float(jl) != float(fl)  # the policy changes the numbers
    assert_policy_close(float(tl), float(jl), float(fl))
    assert_policy_close(bridge.params_to_numpy(tg, model), jg, fg)


def test_clip_loss_and_gradient_in_bf16():
    kw = dict(model="clip", dataset="synthetic", text_emb_dim=E,
              im_emb_dim=D, clip_latent_dim=16, compute_dtype="bfloat16")
    jmodel, jparams = jax_clip_loop.make_clip(JaxConfig(**kw),
                                              jax.random.PRNGKey(0))
    j32, _ = jax_clip_loop.make_clip(JaxConfig(**dict(
        kw, compute_dtype="float32")), jax.random.PRNGKey(0))
    model, _ = clip_loop.make_clip(Config(**kw), torch.Generator())
    text, image = rand(6, E, seed=4), rand(6, D, seed=5)

    def jloss(m):
        return jax.value_and_grad(lambda p: m.symmetric_ce_loss(
            p, jnp.asarray(text), jnp.asarray(image)))(jparams)
    (jl, jg), (fl, fg) = jloss(jmodel), jloss(j32)
    params = {k: v.requires_grad_() for k, v in bridge.params_from_jax(
        np_tree(jparams), "clip", device="cpu").items()}
    tl = model.symmetric_ce_loss(params, torch.from_numpy(text),
                                 torch.from_numpy(image))
    tg = dict(zip(params, torch.autograd.grad(tl, list(params.values()))))
    assert_policy_close(float(tl.detach()), float(jl), float(fl))
    assert_policy_close(bridge.params_to_numpy(tg, "clip"), jg, fg)
