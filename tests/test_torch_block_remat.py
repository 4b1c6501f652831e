"""conv4's block rematerialization (``models/conv4.py:BLOCK_REMAT``) in the
port, on the CPU, at the narrow conv4 of ``tests/torch_raw_helpers.py``
(16×16×3 images, 64 channels, B=2 tasks of 3 ways).

The switch checkpoints each conv block and changes memory, never the
numbers: the loss and the meta-gradient with it on are bitwise those with
it off (MAML, FuMI, ProtoNet; fp32 and bf16). Nested inside
``--tpu_remat on``'s step checkpoint they are held as
``test_remat_equals_no_remat`` holds the step checkpoint alone: the loss
to 1e-6 relative, the gradient to 1e-6 of its scale. Where grad mode is
off the switch is skipped: eval's logits bitwise, no warning.
"""

import warnings

import numpy as np
import pytest
import torch

from torch_raw_helpers import assert_grads_close, cfg_kw
from fumi_tpu_torch.core.config import Config
from fumi_tpu_torch.core.episode import Episode
from fumi_tpu_torch.metalearn import inner_loop
from fumi_tpu_torch.models import conv4
from fumi_tpu_torch.train import steps

B, N, K, Q, S, E = 2, 3, 2, 2, 16, 8
DTYPES = {"fp32": "float32", "bf16": "bfloat16"}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def raw_episode(seed=0):
    rs = np.random.RandomState(seed)

    def t(*shape):
        return torch.from_numpy(rs.rand(*shape).astype(np.float32))
    y = torch.arange(N, dtype=torch.int32)
    return Episode(support_im=t(B, N * K, S, S, 3),
                   support_text=t(B, N * K, E) - 0.5,
                   support_text_mask=None, support_ids=None,
                   support_y=y.repeat_interleave(K).repeat(B, 1),
                   query_im=t(B, N * Q, S, S, 3), query_ids=None,
                   query_y=y.repeat_interleave(Q).repeat(B, 1))


def family(model, **kw):
    cfg = Config(**cfg_kw(model, "conv4", num_shots=K, num_shots_test=Q,
                          **kw))
    return steps.build_family(cfg, torch.Generator().manual_seed(0))


def loss_and_grads(monkeypatch, on, model, **kw):
    monkeypatch.setattr(conv4, "BLOCK_REMAT", on)
    fam = family(model, **kw)
    (loss, _), g = steps.value_and_grad(fam, fam.params, raw_episode(),
                                        None)
    return loss, g


def counting_checkpoint(monkeypatch):
    """Wrap the checkpoint conv4 calls; the list counts its calls."""
    calls, real = [], conv4.checkpoint

    def wrapped(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(conv4, "checkpoint", wrapped)
    return calls


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("model", ["maml", "fumi", "protonet"])
def test_block_remat_is_bitwise(model, dtype, monkeypatch):
    """The loss and every leaf of the meta-gradient (second order for
    MAML and FuMI) bitwise equal with the switch on and off; on, every
    block of every backbone call goes through the checkpoint."""
    off = loss_and_grads(monkeypatch, False, model,
                         compute_dtype=DTYPES[dtype])
    calls = counting_checkpoint(monkeypatch)
    on = loss_and_grads(monkeypatch, True, model,
                        compute_dtype=DTYPES[dtype])
    assert calls and len(calls) % 4 == 0
    assert torch.isfinite(on[0])
    assert torch.equal(on[0], off[0])
    assert on[1].keys() == off[1].keys()
    for k, v in on[1].items():
        assert torch.equal(v, off[1][k]), k


@pytest.mark.parametrize("model", ["maml", "fumi"])
def test_block_remat_nested_in_step_remat(model, monkeypatch):
    """``--tpu_remat on`` checkpoints every inner step; the block
    checkpoints nest inside it, and the loss and meta-gradient stay those
    of neither."""
    assert inner_loop.remat_active(
        steps.remat_of(Config(**cfg_kw(model, "conv4", remat="on"))), 2)
    l0, g0 = loss_and_grads(monkeypatch, False, model, remat="off")
    l1, g1 = loss_and_grads(monkeypatch, True, model, remat="on")
    assert float(l1) == pytest.approx(float(l0), rel=1e-6, abs=1e-7)
    assert_grads_close(g1, g0, 1e-6)


def test_block_remat_keeps_only_the_block_inputs(monkeypatch):
    """What the backward pass keeps of a backbone's forward, counted by
    a saved-tensors hook: with the switch on, each block's conv output,
    norm and pool are recomputed and leave the graph, so it keeps less
    than a quarter of what it keeps off."""
    fam = family("maml")
    leaves = {k: v.detach().requires_grad_() for k, v in fam.params.items()}
    x = raw_episode().support_im[0]
    kept = {}
    for on in (False, True):
        monkeypatch.setattr(conv4, "BLOCK_REMAT", on)
        n = [0]

        def pack(t):
            n[0] += t.numel() * t.element_size()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            feats = conv4.backbone(leaves, x)
        torch.autograd.grad(feats.sum(), list(leaves.values()),
                            allow_unused=True)
        kept[on] = n[0]
    assert 0 < kept[True] < kept[False] / 4


@pytest.mark.parametrize("model", ["maml", "protonet"])
def test_block_remat_skipped_without_grad(model, monkeypatch):
    """The eval step runs under ``torch.no_grad()``: its metrics are
    bitwise with and without the switch and nothing warns. Only MAML's
    inner adaptation, which turns grad mode on, reaches the checkpoint."""
    fam = family(model)
    opt = steps.make_opt(Config(**cfg_kw(model, "conv4")))
    eval_step = steps.steps_from_family(fam, opt).eval_step
    out = {}
    for on in (False, True):
        monkeypatch.setattr(conv4, "BLOCK_REMAT", on)
        calls = counting_checkpoint(monkeypatch)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            out[on] = eval_step(fam.params, raw_episode(1), None)
        assert bool(calls) == (on and model == "maml")
    assert out[True].keys() == out[False].keys()
    for k, v in out[True].items():
        assert torch.equal(torch.as_tensor(v), torch.as_tensor(out[False][k]))
