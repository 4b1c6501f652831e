"""The port's spans (``utils/profiling.py:span``) on the CPU.

Under ``torch.profiler.profile(activities=[CPU])`` a FuMI request on the
autograd engine and a chunk of FuMI training steps open the named ranges
of the request's and the step's phases, nested as the code nests them;
the outputs are bitwise those of the same calls without a profiler; and
without a profiler a span is one shared null context that builds no
``record_function``.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fumi_tpu_torch.core.config import Config
from fumi_tpu_torch.core.episode import EpisodeSpec
from fumi_tpu_torch.data.sampler import DeviceEpisodeSampler
from fumi_tpu_torch.data.synthetic import synthetic_class_set
from fumi_tpu_torch.serve import FewShotClassifier
from fumi_tpu_torch.train import steps
from fumi_tpu_torch.utils import profiling

IM, TXT, N, K, Q, B = 16, 8, 3, 2, 4, 2
INNER = 2
REQUEST = {"serve.checks", "serve.to_device", "hypernet", "serve.adapt",
           "serve.classify", "serve.to_host"}
STEP = {"train.sample", "train.loss", "train.meta_grad", "train.update",
        "train.step_metrics"}


def _cfg(**kw):
    base = dict(model="fumi", dataset="synthetic", im_emb_dim=IM,
                text_emb_dim=TXT, im_hid_dim=(8, 6), text_hid_dim=8,
                num_ways=N, num_shots=K, num_shots_test=Q, batch_size=B,
                num_train_adapt_steps=INNER, num_test_adapt_steps=3,
                step_size=0.1, lr=1e-2, dropout=0.25,
                text_encoder="precomputed")
    base.update(kw)
    return Config(**base)


def _request():
    rng = np.random.RandomState(3)
    return dict(support_im=rng.randn(N * K, IM).astype(np.float32),
                support_y=np.repeat(np.arange(N), K).astype(np.int32),
                query_im=rng.randn(5, IM).astype(np.float32),
                support_text=rng.randn(N * K, TXT).astype(np.float32))


def _serve(batch=False):
    clf = FewShotClassifier(_cfg(), device="cpu")
    if not batch:
        return clf.episode_logits(**_request())
    # two episodes, R padded to 2 and M from 5 to 8 inside the request
    two = {k: np.stack([v, v[::-1]]) for k, v in _request().items()}
    return clf.episode_logits_batch(**two)


def _train():
    """Two FuMI steps of one chunk from a fixed start; the params, the
    optimizer state and the metrics."""
    cfg = _cfg()
    cs, table, ids = synthetic_class_set(num_classes=10, images_per_class=12,
                                         im_dim=IM, text_dim=TXT, seed=0)
    smp = DeviceEpisodeSampler(table, ids, cs,
                               EpisodeSpec(B, N, K, Q, IM, TXT),
                               device="cpu")
    fam = steps.build_family(cfg, torch.Generator().manual_seed(0))
    opt = steps.make_opt(cfg)
    run = steps.make_chunked_train(fam, opt, smp, 2)
    params, state, _, ms = run(fam.params, opt.init(fam.params),
                               torch.Generator().manual_seed(1))
    return {"params": params, "state": state, "metrics": ms}


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events()]


def _inside(outer, events, names):
    """The events named in ``names`` that lie within ``outer``'s range."""
    a, b = outer.time_range.start, outer.time_range.end
    return [e for e in events if e.name in names
            and a <= e.time_range.start and e.time_range.end <= b]


def _flat(tree):
    if isinstance(tree, np.ndarray):
        return [torch.from_numpy(tree)]
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree, key=str) for t in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _flat(v)]
    return []


@pytest.mark.parametrize("batch", [False, True],
                         ids=["episode_logits", "episode_logits_batch"])
def test_a_request_names_its_phases_under_its_root(batch):
    out, events = _profiled(lambda: _serve(batch))
    assert out.shape == ((2,) if batch else ()) + (5, N)
    roots = [e for e in events if e.name == "serve.request"]
    assert len(roots) == 1
    inside = _inside(roots[0], events, REQUEST)
    assert sorted(e.name for e in inside) == sorted(REQUEST)
    # the adaptation's inner steps run inside serve.adapt
    adapt = next(e for e in inside if e.name == "serve.adapt")
    assert len(_inside(adapt, events, {"inner.step"})) == 3


def test_a_chunk_names_each_steps_phases_under_its_root():
    _, events = _profiled(_train)
    roots = [e for e in events if e.name == "train.step"]
    assert len(roots) == 2
    for root in roots:
        inside = _inside(root, events, STEP)
        assert sorted(e.name for e in inside) == sorted(STEP)
        loss = next(e for e in inside if e.name == "train.loss")
        assert len(_inside(loss, events, {"inner.step"})) == INNER
        assert len(_inside(loss, events, {"inner.query"})) == 1
        assert len(_inside(loss, events, {"hypernet"})) == 1


@pytest.mark.parametrize("fn", [_serve, _train], ids=["serve", "train"])
def test_outputs_are_bitwise_equal_under_a_profiler(fn):
    plain = _flat(fn())
    traced, _ = _profiled(fn)
    traced = _flat(traced)
    assert len(plain) == len(traced) > 0
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fn", [_serve, _train], ids=["serve", "train"])
def test_no_range_is_built_without_a_profiler(fn, monkeypatch):
    built = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        built.append(name)
        return real(name, *args, **kwargs)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert profiling.span("train.step") is profiling.span("serve.request")
    assert isinstance(profiling.span("x"), contextlib.nullcontext)
    fn()
    assert built == []
    # and with a profiler the same calls build them through the helper
    _profiled(fn)
    assert {"serve.request", "train.step"} & set(built)
