"""``correct`` comes out false when the timed path is broken underneath,
once for each fault a cell can have, and true when it is not. The runs go
through everything but the harness's look for a card, on tiny cells on
the CPU. (No cell runs across chips, so none can leave out an exchange
between them.)"""

import numpy as np
import pytest

from conftest import run_cpu

TRAIN_CELLS = ("tiny.train",)
SERVE_CELLS = ("tiny.serve",)


@pytest.mark.parametrize("cell", TRAIN_CELLS + SERVE_CELLS)
def test_a_sound_run_is_correct(tiny_root, cell):
    result = run_cpu(tiny_root, cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_a_step_that_returns_its_state_unchanged(tiny_root, cell,
                                                 monkeypatch):
    from fumi_tpu_torch.train import optim
    monkeypatch.setattr(optim, "apply_updates", lambda params, updates:
                        params)
    result = run_cpu(tiny_root, cell)
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_half_of_the_batch_left_out(tiny_root, cell, monkeypatch):
    from fumi_tpu_torch.metalearn import inner_loop
    outer = inner_loop._outer

    def half(q_logits, query_y):
        b = q_logits.shape[0] // 2
        return outer(q_logits[:b], query_y[:b])
    monkeypatch.setattr(inner_loop, "_outer", half)
    result = run_cpu(tiny_root, cell)
    assert not result["correct"]
    assert result["checks"]["loss_gap_first"]["value"] > \
        result["checks"]["loss_gap_first"]["limit"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_an_episode_row_altered_where_it_is_gathered(tiny_root, cell,
                                                     monkeypatch):
    from fumi_tpu_torch.ops import kernels
    gather = kernels.gather_episode_rows

    def altered(*args, **kwargs):
        support, query = gather(*args, **kwargs)
        query = query.clone()
        query.view(-1)[7] += 0.25
        return support, query
    monkeypatch.setattr(kernels, "gather_episode_rows", altered)
    result = run_cpu(tiny_root, cell)
    assert not result["correct"]
    assert result["checks"]["episode_gap"]["value"] == pytest.approx(0.25)


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_an_answer_altered_where_it_is_produced(tiny_root, cell,
                                                monkeypatch):
    from fumi_tpu_torch.serve import FewShotClassifier
    produce = FewShotClassifier._run_episodes

    def altered(self, *args, **kwargs):
        out = np.array(produce(self, *args, **kwargs))
        out[0, 0, 0] += 0.05 * float(np.abs(out).max())
        return out
    monkeypatch.setattr(FewShotClassifier, "_run_episodes", altered)
    result = run_cpu(tiny_root, cell)
    assert not result["correct"]
    assert result["checks"]["logit_gap_median"]["value"] == pytest.approx(
        0.05, rel=0.05)


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_an_answer_that_never_comes(tiny_root, cell, monkeypatch):
    from fumi_tpu_torch.serve import FewShotClassifier
    produce = FewShotClassifier._run_episodes
    calls = []

    def flaky(self, *args, **kwargs):
        calls.append(1)
        if len(calls) == 12:
            raise RuntimeError("lost")
        return produce(self, *args, **kwargs)
    monkeypatch.setattr(FewShotClassifier, "_run_episodes", flaky)
    result = run_cpu(tiny_root, cell, seconds=2.0)
    assert not result["correct"]
    assert result["failed"] == 1
    assert result["checks"]["failed_answers"]["value"] == 1


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_a_quarter_of_the_answers_altered(tiny_root, cell, monkeypatch):
    """A fault in the answers of one request size only (one request in
    four, as a fault in one of a program's size buckets would be) is not
    hidden by the median answer."""
    from fumi_tpu_torch.serve import FewShotClassifier
    produce = FewShotClassifier.episode_logits

    def altered(self, support_im, *args, **kwargs):
        out = np.array(produce(self, support_im, *args, **kwargs))
        query_im = args[1] if len(args) > 1 else kwargs["query_im"]
        if len(query_im) == 9:
            out[0, 0] += 0.5 * float(np.abs(out).max())
        return out
    monkeypatch.setattr(FewShotClassifier, "episode_logits", altered)
    result = run_cpu(tiny_root, cell, seconds=2.0)
    checks = result["checks"]
    assert not result["correct"]
    assert checks["logit_gap_median"]["value"] <= \
        checks["logit_gap_median"]["limit"]
    assert checks["off_share"]["value"] > checks["off_share"]["limit"]
