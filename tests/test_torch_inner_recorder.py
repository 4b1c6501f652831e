"""The inner-step recorder (``metalearn/inner_loop.py:recording``) and the
memory counter (``utils/profiling.py:count_memory``) on the CPU.

The recorder keeps each ``adapt`` call's per-task states θ_0 … θ_n and
the support loss at θ_0 … θ_{n−1}, detached, and changes no number: the
loss and the meta-gradient of FuMI (on embeddings, with dropout) and of
MAML (on conv4) are bitwise those of an unrecorded step, with the inner
steps checkpointed (``--tpu_remat on``) and without. A checkpointed step
is recorded once, in the forward pass, though the outer backward runs it
again. The counter is a zero-length range ``mem.<point>=<bytes>`` at the
end of ``train.loss`` and of ``train.meta_grad`` while a profiler runs,
and reads nothing otherwise.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fumi_tpu_torch.core.config import Config
from fumi_tpu_torch.core.episode import Episode
from fumi_tpu_torch.metalearn import inner_loop
from fumi_tpu_torch.train import steps
from fumi_tpu_torch.utils import profiling

B, N, K, Q, D, E, S = 2, 3, 2, 4, 24, 10, 16
STEPS, ALPHA = 2, 0.1


def config(model, remat):
    common = dict(model=model, dataset="synthetic", num_ways=N, num_shots=K,
                  num_shots_test=Q, batch_size=B,
                  num_train_adapt_steps=STEPS, step_size=ALPHA,
                  remat=remat, lr=1e-3)
    if model == "maml":
        return Config(im_encoder="conv4", im_size=S, im_channels=3,
                      **common)
    return Config(im_encoder="precomputed", im_emb_dim=D, im_hid_dim=(12, 6),
                  text_emb_dim=E, text_hid_dim=8, dropout=0.25, **common)


def episode(model, seed=0):
    rs = np.random.RandomState(seed)
    shape = (S, S, 3) if model == "maml" else (D,)

    def t(*s):
        return torch.from_numpy(rs.rand(*s).astype(np.float32))
    y = torch.arange(N, dtype=torch.int32)
    return Episode(support_im=t(B, N * K, *shape),
                   support_text=t(B, N * K, E) - 0.5, support_text_mask=None,
                   support_ids=None, support_y=y.repeat_interleave(K).repeat(
                       B, 1),
                   query_im=t(B, N * Q, *shape), query_ids=None,
                   query_y=y.repeat_interleave(Q).repeat(B, 1))


def step(model, remat, record):
    """One step's loss and meta-gradient, and the records (None where the
    recorder was closed)."""
    fam = steps.build_family(config(model, remat),
                             torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(5)
    if not record:
        (loss, _), grads = steps.value_and_grad(fam, fam.params,
                                                episode(model), gen)
        return loss, grads, None
    with inner_loop.recording() as records:
        (loss, _), grads = steps.value_and_grad(fam, fam.params,
                                                episode(model), gen)
    return loss, grads, records


@pytest.mark.parametrize("remat", ["off", "on"])
@pytest.mark.parametrize("model", ["fumi", "maml"])
def test_recording_changes_no_bit(model, remat):
    loss0, grads0, _ = step(model, remat, False)
    loss1, grads1, records = step(model, remat, True)
    assert len(records) == 1
    assert torch.equal(loss0, loss1)
    assert list(grads0) == list(grads1)
    for k in grads0:
        assert torch.equal(grads0[k], grads1[k]), k
    # the recorder closed: nothing is kept, and the step is the same again
    assert inner_loop._RECORDS is None
    loss2, grads2, _ = step(model, remat, False)
    assert torch.equal(loss0, loss2)


@pytest.mark.parametrize("remat", ["off", "on"])
def test_each_inner_step_is_recorded_once(remat):
    """n steps: n + 1 states and n losses, also where checkpoint runs each
    step again in the outer backward; each state is the last one moved by
    −α times its support loss's gradient there, per task."""
    _, _, records = step("maml", remat, True)
    rec = records[0]
    assert len(rec.theta) == STEPS + 1 and len(rec.loss) == STEPS
    fam = steps.build_family(config("maml", "off"),
                             torch.Generator().manual_seed(0))
    ep = episode("maml")
    assert torch.equal(rec.theta[0]["head.weight"][1],
                       fam.params["head.weight"])
    for k in range(STEPS):
        theta = {key: v.clone().requires_grad_()
                 for key, v in rec.theta[k].items()}
        loss = inner_loop.task_cross_entropy(
            fam.model(theta, ep.support_im), ep.support_y).sum()
        assert torch.equal(loss.detach(), rec.loss[k])
        grads = torch.autograd.grad(loss, list(theta.values()))
        for (key, v), g in zip(rec.theta[k].items(), grads):
            assert not rec.theta[k + 1][key].requires_grad
            torch.testing.assert_close(rec.theta[k + 1][key],
                                       v - ALPHA * g, rtol=0, atol=1e-6)


def test_recorders_nest_and_eval_records_too():
    """An inner recorder takes the calls made inside it; the outer one is
    back after it. The loop without an outer graph (eval) is recorded as
    training's is."""
    fam = steps.build_family(config("maml", "off"),
                             torch.Generator().manual_seed(0))
    with inner_loop.recording() as outer:
        with inner_loop.recording() as inner:
            steps.value_and_grad(fam, fam.params, episode("maml"), None)
        assert inner_loop._RECORDS is outer
        with torch.no_grad():
            fam.eval_raw(fam.params, episode("maml"), None)
    assert len(inner) == 1 and len(outer) == 1
    assert len(outer[0].theta) == 1 + fam_eval_steps()
    assert len(outer[0].loss) == fam_eval_steps()


def fam_eval_steps():
    return config("maml", "off").num_test_adapt_steps


def mem_ranges(prof):
    return [e.name for e in prof.events() if e.name.startswith("mem.")]


def test_memory_counter_marks_the_step_under_a_profiler(monkeypatch):
    """Under a profiler (and a card, faked here): one range at the end of
    the loss and one at the end of the outer backward, each with the
    allocator's live bytes; without a profiler the allocator is not
    asked."""
    reads = []

    def allocated():
        reads.append(1)
        return 1234 * len(reads)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_allocated", allocated)
    fam = steps.build_family(config("fumi", "off"),
                             torch.Generator().manual_seed(0))
    steps.value_and_grad(fam, fam.params, episode("fumi"),
                         torch.Generator().manual_seed(5))
    assert reads == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        steps.value_and_grad(fam, fam.params, episode("fumi"),
                             torch.Generator().manual_seed(5))
    assert mem_ranges(prof) == ["mem.train.loss=1234",
                                "mem.train.meta_grad=2468"]
    by_name = {e.name: e for e in prof.events()}
    loss, grad = by_name["train.loss"], by_name["train.meta_grad"]
    mark = by_name["mem.train.loss=1234"]
    assert loss.time_range.start <= mark.time_range.start
    assert mark.time_range.end <= loss.time_range.end
    assert mark.time_range.end <= grad.time_range.start


def test_memory_counter_is_silent_on_the_cpu():
    """No CUDA context: the counter adds no range even under a profiler."""
    if torch.cuda.is_available():
        pytest.skip("the process has a card")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        profiling.count_memory("train.loss")
    assert mem_ranges(prof) == []
