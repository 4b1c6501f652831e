"""Shared pieces of the raw-image backbone tests (``tests/test_torch_
backbone*.py``): the port's conv4 and resnet12 against the JAX package's,
on the CPU, on bridged weights and the same inputs.

Sizes: 16×16×3 images, resnet12 channels (8, 12, 16, 24), conv4 at its
64 hidden channels (features 1·1·64); units and backbones on 4-6 images,
B=2 tasks; the families on B=2 tasks of 3 ways, 1 shot, 1 query and 2
second-order inner steps (1 where the fp64 reference runs).

Tolerances. fp32 (IEEE, both packages on the CPU): a unit or a whole
backbone to 1e-5 relative and absolute; an episode's loss to 1e-5 and its
meta-gradient to 1e-5 of the gradient's largest entry (2e-4 for MAML and
FuMI, second order through batch-stat norms over a few images; the conv
biases' gradients are zero analytically, since the norm removes a
constant, and hold only rounding noise); three Adam steps to 1e-3 (the
steps' file says why). bf16 storage: the two packages round at other
places (XLA on the CPU keeps excess precision across fused bf16
operations; the port rounds each stored activation), so a bf16 output is
held to JAX's bf16 output within 4 bf16 ulps (2⁻⁸ ≈ 3.9e-3) of its scale,
or, through a whole backbone, within 1.5× the distance between JAX's own
bf16 and fp32 outputs (the policy's own rounding noise).
Rematerialization changes memory and never the numbers: equal to 1e-6 of
the gradient's scale.

MAML and FuMI are held against the JAX package's own functions (the
backbone's ``apply``, ``cross_entropy``, ``sgd_inner_update``, FuMI's
``get_hyper_params`` and ``im_forward``) composed as its engine's
docstring defines the program: per task, a loop of inner SGD steps, then
the query loss, averaged over the tasks (:func:`jax_inner_loop_loss`).
The installed XLA (jax 0.9.0, CPU) miscompiles their second-order inner
loop through ``batch_stat_norm`` → ``maxpool2x2`` in its algebraic
simplifier (with ``--xla_disable_hlo_passes=algsimp`` the engine agrees
with the port): its jitted meta-gradient misses a central finite
difference (``test_the_jax_scan_engine_fault`` pins it), and op by op
even its loss under ``jax.grad`` changes. The loop's loss is right under
``jit``; its meta-gradient is taken in fp64 op by op, where it meets the
finite difference, and the port's fp32 meta-gradient is held to it
within 2e-4 of its scale, at one inner step to keep it fast. Their Adam
steps run JAX's optimizer (``optax`` through ``make_opt``) on the port's
gradients, each step's loss held to the loop's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fumi_tpu.core.config import Config as JaxConfig
from fumi_tpu.core.episode import EpisodeSpec as JaxSpec
from fumi_tpu.data import sampler as jax_sampler
from fumi_tpu.data.synthetic import synthetic_raw_image_set
from fumi_tpu.models import conv4 as jax_conv4
from fumi_tpu.models import resnet12 as jax_resnet12
from fumi_tpu.train import steps as jax_steps
from fumi_tpu_torch import bridge
from fumi_tpu_torch.core.config import Config
from fumi_tpu_torch.models import conv4, resnet12
from fumi_tpu_torch.train import steps

B, N, K, Q, S, E = 2, 3, 1, 1, 16, 8
CH = (8, 12, 16, 24)
TOL = dict(rtol=1e-5, atol=1e-5)
BF16 = 2.0 ** -8
KINDS = ["conv4", "resnet12"]
FAMILIES = ["maml", "fumi", "am3", "protonet", "matchingnet"]
JNETS = {"conv4": jax_conv4, "resnet12": jax_resnet12}
NETS = {"conv4": conv4, "resnet12": resnet12}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for a module's tests: the tests run in
    several worker processes at once, and the convolutions' default of
    one thread a core oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def images(n, seed=0, shape=(S, S, 3)):
    return np.random.RandomState(seed).randn(n, *shape).astype(np.float32)


def jax_init(kind, key=0, n_way=N):
    kw = {"channels": CH} if kind == "resnet12" else {}
    return JNETS[kind].init(jax.random.PRNGKey(key), S, 3, n_way=n_way, **kw)


def port_params(tree):
    return bridge.params_from_jax(np_tree(tree), "maml", device="cpu")


def jax_unit(kind, key=0):
    if kind == "conv4":
        return jax_conv4.conv_init(jax.random.PRNGKey(key), 3, 8)
    return jax_resnet12.block_init(jax.random.PRNGKey(key), 3, 8)


def cd_pair(dtype):
    return (None, None) if dtype == "fp32" else (jnp.bfloat16,
                                                 torch.bfloat16)


def nchw(x):
    """(M, H, W, C) numpy -> (M, C, H, W) tensor (B=1 groups)."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(y):
    return y.permute(0, 2, 3, 1).detach().float().numpy()


def assert_bf16_close(got, want, fp32=None):
    """Within 4 bf16 ulps of the scale or, given JAX's fp32 output, 1.5×
    the distance of JAX's bf16 output from it."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    bound = 4 * BF16 * scale
    if fp32 is not None:
        bound = max(bound, 1.5 * float(np.abs(want - np.asarray(fp32)).max()))
    assert float(np.abs(got - want).max()) <= bound


def cfg_kw(model, kind, **kw):
    d = dict(model=model, dataset="synthetic", im_encoder=kind, im_size=S,
             im_channels=3, resnet12_channels=CH, text_emb_dim=E,
             prototype_dim=8, text_hid_dim=8, num_ways=N, num_shots=K,
             num_shots_test=Q, batch_size=B, num_train_adapt_steps=2,
             num_test_adapt_steps=3, step_size=0.1, dropout=0.0,
             optim="adam", lr=1e-2, text_encoder="BERT", seed=0)
    d.update(kw)
    return d


def jax_family(model, kind, **kw):
    cfg = JaxConfig(**cfg_kw(model, kind, **kw))
    return cfg, jax_steps.build_family(cfg, jax.random.PRNGKey(0))


def port_family(model, kind, jfam, **kw):
    cfg = Config(**cfg_kw(model, kind, **kw))
    fam = steps.build_family(cfg, torch.Generator().manual_seed(0))
    return cfg, fam._replace(params=bridge.params_from_jax(
        np_tree(jfam.params), model, device="cpu"))


def make_raw_episodes(k=K, q=Q):
    """Three JAX meta-batches of raw 16×16×3 images, ``k`` shots and ``q``
    queries a class."""
    cs, table, ids = synthetic_raw_image_set(num_classes=8,
                                             images_per_class=6, im_size=S,
                                             text_dim=E)
    smp = jax_sampler.DeviceEpisodeSampler(jnp.asarray(table),
                                           jnp.asarray(ids), cs,
                                           JaxSpec(B, N, k, q, S, E))
    return [smp.sample(jax.random.PRNGKey(i)) for i in range(3)]


def to_port(ep):
    return bridge.episode_from_numpy(np_tree(ep), device="cpu")


def assert_grads_close(got, want, rel):
    g, w = (jax.tree_util.tree_leaves(t) for t in (got, want))
    assert len(g) == len(w)
    scale = max(float(np.abs(np.asarray(x)).max()) for x in w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=rel * scale)


INNER = ("maml", "fumi")


def jax_inner_loop_loss(model, jfam, jcfg, params, ep, n_steps=None,
                        mask=None):
    """``(loss, preds)`` of MAML or FuMI from the JAX package's functions:
    per task a Python loop of ``n_steps`` inner SGD steps (default the
    train horizon), then the query cross-entropy, averaged over tasks."""
    from fumi_tpu.metalearn.inner_loop import sgd_inner_update
    from fumi_tpu.ops.fewshot import cross_entropy as jce
    n_steps = jcfg.num_train_adapt_steps if n_steps is None else n_steps
    step, key = jcfg.step_size, jax.random.PRNGKey(0)
    losses, preds = [], []
    for b in range(ep.support_y.shape[0]):
        sx, sy = ep.support_im[b], ep.support_y[b]
        if model == "maml":
            net = JNETS[jcfg.im_encoder]

            def logits(p, x):
                return net.apply(p, x)
            p = params
            for _ in range(n_steps):
                g = jax.grad(lambda q: jce(logits(q, sx), sy))(p)
                p = sgd_inner_update(p, g, step, mask)
        else:
            fm = jfam.model

            def logits(p, x):
                return fm.im_forward(p[0], p[1], x, rng=key, train=False)
            p = (params["im_net"], fm.get_hyper_params(
                params, ep.support_text[b], sy, rng=key))
            for _ in range(n_steps):
                g = jax.grad(lambda q: jce(logits(q, sx), sy))(p)
                p = jax.tree_util.tree_map(lambda a, d: a - step * d, p, g)
        q = logits(p, ep.query_im[b])
        losses.append(jce(q, ep.query_y[b]))
        preds.append(jnp.argmax(q, axis=-1))
    return jnp.mean(jnp.stack(losses)), jnp.concatenate(preds)


def jax_loss_and_grads(model, jfam, jcfg, params, ep, mask=None):
    """The JAX package's loss and gradient: AM3's, ProtoNet's and
    MatchingNet's from the family under ``jit``; MAML's and FuMI's through
    :func:`jax_inner_loop_loss` in fp64, op by op (the module docstring
    says why)."""
    if model not in INNER:
        (loss, _), grads = jax.jit(jax.value_and_grad(
            jfam.train_loss, has_aux=True))(params, ep,
                                            jax.random.PRNGKey(0))
        return loss, grads

    def f64(t):
        return (jnp.asarray(t, jnp.float64)
                if t is not None and jnp.issubdtype(t.dtype, jnp.floating)
                else t)
    with jax.enable_x64(True):
        loss, grads = jax.value_and_grad(
            lambda p: jax_inner_loop_loss(model, jfam, jcfg, p,
                                          type(ep)(*map(f64, ep)),
                                          mask=mask)[0])(
            jax.tree_util.tree_map(f64, params))
        return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def jax_loop_loss(model, jfam, jcfg, n_steps=None):
    """``(params, episode) -> (loss, preds)``: the loop under ``jit``
    (right; only its gradient is not)."""
    fn = jax.jit(lambda p, e: jax_inner_loop_loss(model, jfam, jcfg, p, e,
                                                  n_steps))

    def run(p, e):
        loss, preds = fn(p, e)
        return float(loss), np.asarray(preds)
    return run


def steps_episode(rs, b, n, k, d, e):
    from fumi_tpu_torch.core.episode import Episode
    t = functools.partial(torch.tensor, dtype=torch.float32)
    y = torch.arange(n).repeat_interleave(k).repeat(b, 1).to(torch.int32)
    return Episode(support_im=t(rs.randn(b, n * k, d)),
                   support_text=t(rs.randn(b, n * k, e)),
                   support_text_mask=None, support_ids=None, support_y=y,
                   query_im=t(rs.randn(b, n * k, d)), query_ids=None,
                   query_y=y.clone())

