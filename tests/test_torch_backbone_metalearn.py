"""MAML, FuMI and ANIL on conv4 and resnet12 in the port against the JAX
package's, on the CPU: the JAX engine's fault, one episode's loss and
meta-gradient, the eval engine, and three Adam steps. Sizes, tolerances,
and why these are held against a loop of the JAX package's functions:
``tests/torch_raw_helpers.py``.
"""

import jax
import numpy as np
import pytest
import torch

from torch_raw_helpers import *  # noqa: F401,F403
from fumi_tpu_torch import bridge
from fumi_tpu_torch.metalearn import inner_loop
from fumi_tpu_torch.train import steps


@pytest.fixture(scope="module", autouse=True)
def threefry():
    """JAX's default key implementation pinned to threefry2x32 for the
    module (as ``tests/test_torch_sweep.py`` pins it), the old value
    restored after: the JAX driver sets the process-wide default to its
    ``--tpu_prng_impl`` (``rbg`` unless told), so without the pin the
    inputs drawn from ``jax.random`` here would depend on which test files
    an xdist worker ran before this one. Module-scoped and autouse, so it
    is in place before :func:`raw_episodes` draws."""
    old = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    yield
    jax.config.update("jax_default_prng_impl", old)


@pytest.fixture(scope="module")
def raw_episodes():
    return make_raw_episodes()


def test_the_jax_scan_engine_fault(raw_episodes):
    """MAML on conv4: the JAX engine's jitted meta-gradient is far from the
    fp64 gradient of the JAX package's own functions in a loop, and the
    port's is within 2e-4 of its scale; the losses agree."""
    inner = dict(num_train_adapt_steps=1)
    jcfg, jfam = jax_family("maml", "conv4", **inner)
    cfg, fam = port_family("maml", "conv4", jfam, **inner)
    ep = raw_episodes[0]
    (engine, _), eg = jax.jit(jax.value_and_grad(
        jfam.train_loss, has_aux=True))(jfam.params, ep,
                                        jax.random.PRNGKey(0))
    jl, jg = jax_loss_and_grads("maml", jfam, jcfg, jfam.params, ep)
    (tl, _), tg = steps.value_and_grad(fam, fam.params, to_port(ep), None)
    scale = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(jg))
    assert max(float(np.abs(np.asarray(a) - b).max()) for a, b in zip(
        jax.tree_util.tree_leaves(eg), jax.tree_util.tree_leaves(jg))) \
        > 0.1 * scale
    np.testing.assert_allclose(float(engine), float(jl), **TOL)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    assert_grads_close(bridge.params_to_numpy(tg, "maml"), jg, 2e-4)


@pytest.mark.parametrize("kind", ["conv4"])
def test_fumi_loss_and_meta_gradient(raw_episodes, kind):
    """FuMI's joint inner loop over the headless backbone and the
    generated head (MAML's: the test above). On conv4 only: the fp64
    reference runs op by op, a minute on resnet12; resnet12's MAML and
    FuMI are held by their losses through three steps and the eval
    engine."""
    inner = dict(num_train_adapt_steps=1)
    jcfg, jfam = jax_family("fumi", kind, **inner)
    cfg, fam = port_family("fumi", kind, jfam, **inner)
    ep = raw_episodes[0]
    jl, jg = jax_loss_and_grads("fumi", jfam, jcfg, jfam.params, ep)
    (tl, _), tg = steps.value_and_grad(fam, fam.params, to_port(ep), None)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    assert_grads_close(bridge.params_to_numpy(tg, "fumi"), jg, 2e-4)


def test_anil_adapts_the_backbones_head_only(raw_episodes):
    """ANIL's mask on the backbone layout: only ``head.*`` adapts."""
    from fumi_tpu.metalearn.inner_loop import head_only_mask
    kw = dict(adapt_params="head", num_train_adapt_steps=1)
    jcfg, jfam = jax_family("maml", "conv4", **kw)
    cfg, fam = port_family("maml", "conv4", jfam, **kw)
    mask = inner_loop.head_only_mask(fam.params)
    assert {k for k, v in mask.items() if v} == {"head.weight", "head.bias"}
    ep = raw_episodes[0]
    jl, jg = jax_loss_and_grads("maml", jfam, jcfg, jfam.params, ep,
                                mask=head_only_mask(jfam.params))
    (tl, _), tg = steps.value_and_grad(fam, fam.params, to_port(ep), None)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    assert_grads_close(bridge.params_to_numpy(tg, "maml"), jg, 2e-4)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("model", INNER)
def test_eval_engine(raw_episodes, model, kind):
    """The eval engine (no outer graph, 3 test-time steps): loss and
    predictions."""
    jcfg, jfam = jax_family(model, kind)
    cfg, fam = port_family(model, kind, jfam)
    ep = raw_episodes[1]
    want_loss, want_preds = jax_loop_loss(
        model, jfam, jcfg, jcfg.num_test_adapt_steps)(jfam.params, ep)
    with torch.no_grad():
        got = fam.eval_finalize(fam.eval_raw(fam.params, to_port(ep), None))
    np.testing.assert_allclose(float(got["loss"]), want_loss, **TOL)
    np.testing.assert_array_equal(got["preds"].numpy().reshape(-1),
                                  want_preds.reshape(-1))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("model", INNER)
def test_three_adam_steps(raw_episodes, model, kind):
    """Each step's loss against the JAX loop's; the params against JAX's
    optimizer driven by the port's gradients, to 1e-4 (the conv biases,
    whose gradient is rounding noise that Adam turns into ±lr steps, left
    out)."""
    tol = dict(rtol=1e-4, atol=1e-4)
    jcfg, jfam = jax_family(model, kind, lr=1e-3)
    cfg, fam = port_family(model, kind, jfam, lr=1e-3)
    opt, t_opt = jax_steps.make_opt(jcfg), steps.make_opt(cfg)
    jp, js = jfam.params, opt.init(jfam.params)
    tp, ts = fam.params, t_opt.init(fam.params)
    loop = jax_loop_loss(model, jfam, jcfg)
    for ep in raw_episodes:
        (loss, _), grads = steps.value_and_grad(fam, tp, to_port(ep), None)
        np.testing.assert_allclose(float(loss), loop(jp, ep)[0], **tol)
        with torch.no_grad():
            upd, ts = t_opt.update(grads, ts, tp)
            tp = {k: tp[k] + upd[k] for k in tp}
        updates, js = opt.update(bridge.params_to_numpy(grads, model), js,
                                 jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
    got = bridge.params_from_jax(np_tree(jp), model, device="cpu")
    for k, v in tp.items():
        if k.endswith(".bias") and ("convs." in k or "blocks." in k):
            continue
        np.testing.assert_allclose(v.numpy(), got[k].numpy(), err_msg=k,
                                   **tol)
