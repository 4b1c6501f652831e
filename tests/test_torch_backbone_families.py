"""AM3, ProtoNet and MatchingNet on conv4 and resnet12 in the port
against the JAX package's, on the CPU: one episode's loss and gradient,
AM3's eval, and three Adam steps. Sizes and tolerances:
``tests/torch_raw_helpers.py``.

Three Adam steps, to 1e-3 (relative and absolute) on the loss and every
train metric (the per-component ``grad_norm``s of the JAX package's tree)
at each step, on 2 shots and 2 queries a class: these families normalize
the whole meta-batch at once, and the few-image batch statistics carry
rounding differences from step to step. The params are held through the
metrics each step computes from them: a conv bias sits before a
batch-stat norm, which removes it, and ProtoNet's distances are shift
invariant, so some leaves' gradients are zero analytically and hold only
rounding noise, which Adam turns into steps of ±lr either way.
"""

import jax
import numpy as np
import pytest
import torch

from torch_raw_helpers import *  # noqa: F401,F403
from fumi_tpu_torch import bridge
from fumi_tpu_torch.train import steps

OTHERS = ["am3", "protonet", "matchingnet"]


@pytest.fixture(scope="module")
def raw_episodes():
    return make_raw_episodes()


@pytest.fixture(scope="module")
def wide_episodes():
    return make_raw_episodes(2, 2)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("model", OTHERS)
def test_family_loss_and_gradient(raw_episodes, model, kind):
    jcfg, jfam = jax_family(model, kind)
    cfg, fam = port_family(model, kind, jfam)
    ep = raw_episodes[0]
    jl, jg = jax_loss_and_grads(model, jfam, jcfg, jfam.params, ep)
    (tl, _), tg = steps.value_and_grad(fam, fam.params, to_port(ep), None)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    assert_grads_close(bridge.params_to_numpy(tg, model), jg, 1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_am3_eval(raw_episodes, kind):
    jcfg, jfam = jax_family("am3", kind)
    cfg, fam = port_family("am3", kind, jfam)
    ep = raw_episodes[1]
    want = jfam.eval_finalize(jax.jit(jfam.eval_raw)(
        jfam.params, ep, jax.random.PRNGKey(0)))
    with torch.no_grad():
        got = fam.eval_finalize(fam.eval_raw(fam.params, to_port(ep), None))
    for k in ("loss", "acc", "f1", "avg_lamda"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_array_equal(got["preds"].numpy().reshape(-1),
                                  np.asarray(want["preds"]).reshape(-1))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("model", OTHERS)
def test_three_adam_steps(wide_episodes, model, kind):
    tol = dict(rtol=1e-3, atol=1e-3)
    kw = dict(lr=1e-3, num_shots=2, num_shots_test=2)
    jcfg, jfam = jax_family(model, kind, **kw)
    cfg, fam = port_family(model, kind, jfam, **kw)
    j_steps = jax_steps.steps_from_family(jfam, jax_steps.make_opt(jcfg))
    t_steps = steps.steps_from_family(fam, steps.make_opt(cfg))
    step = jax.jit(j_steps.train_step)
    jp, js = j_steps.params, j_steps.opt.init(j_steps.params)
    tp, ts = t_steps.params, t_steps.opt.init(t_steps.params)
    for i, ep in enumerate(wide_episodes):
        tp, ts, tm = t_steps.train_step(tp, ts, to_port(ep), None)
        jp, js, jm = step(jp, js, ep, jax.random.PRNGKey(i))
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       err_msg=k, **tol)
