"""The benchmark's MAML-on-ResNet-12 pieces against the port, on the CPU:
the plain reference (``benchmark/reference/maml_resnet12.py``), the cost
rule (``benchmark/costs/maml_resnet12.py``), the inner-step check of the
``train_inner`` driver at the checkpointed inner steps that
``--tpu_remat auto`` gives resnet12, the recompute span, the card's
convolution route (the 3×3 Functions and the 1×1 GEMM) against
``F.conv2d``, and the readers of the recompute span and counter. The
port's step and the reference's are computed once for the module
(``base``).

Sizes: a tiny ResNet-12 of channels (4, 8, 8, 12) on 16×16×3 images, B=2
tasks of 3 ways, 2 shots and 4 queries a class, 2 inner steps at α=0.1,
fp64 (the port and the reference compute the same function, so they
agree to rounding: 1e-9); weights from the benchmark's own seeded draw.
"""

import json
import math
import os
import sys
from types import SimpleNamespace

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark import harness  # noqa: E402
from benchmark.costs import maml_resnet12 as costs  # noqa: E402
from benchmark.reference import common, maml_resnet12 as ref  # noqa: E402
from benchmark.trace import STRETCH, Event, Trace  # noqa: E402
from fumi_tpu_torch.core.config import Config  # noqa: E402
from fumi_tpu_torch.core.episode import Episode  # noqa: E402
from fumi_tpu_torch.metalearn import inner_loop  # noqa: E402
from fumi_tpu_torch.models import conv4, resnet12  # noqa: E402
from fumi_tpu_torch.ops import kernels  # noqa: E402
from fumi_tpu_torch.train import steps  # noqa: E402

B, N, K, Q, S, STEPS, ALPHA = 2, 3, 2, 4, 16, 2, 0.1
CHANNELS = [4, 8, 8, 12]
CELL = "resnet12.train"
F64 = torch.float64
FULL = json.load(open(os.path.join(
    REPO, "benchmark", "configs", "maml-resnet12-inat-anim.json")))
TRAIN = {"inner_steps": STEPS, "step_size": ALPHA}


def tiny_config() -> dict:
    """The configuration at the tests' size, every other width as
    stated."""
    cfg = json.loads(json.dumps(FULL))
    cfg["name"] = "tiny-resnet12"
    cfg["widths"].update(channels=CHANNELS, im_size=S, num_ways=N)
    cfg["episode"] = {"num_ways": N, "num_shots": K, "num_query_train": Q}
    cfg["train"].update(batch_size=B, inner_steps=STEPS, step_size=ALPHA,
                        lr=1e-3)
    cfg["data"].update(classes=15, rows=300, row_shape=[S, S, 3],
                       text_dim=4)
    cfg["port"].update(im_size=S, num_ways=N, num_shots=K, num_shots_test=Q,
                       batch_size=B, num_train_adapt_steps=STEPS,
                       step_size=ALPHA, lr=1e-3, resnet12_channels=CHANNELS)
    return cfg


def program(cfg=None, **kw):
    port = dict((cfg or tiny_config())["port"], **kw)
    return steps.build_family(Config(**port),
                              torch.Generator().manual_seed(0))


def weights(cfg=None, seed=3, dtype=F64):
    return {k: v.to(dtype) for k, v in common.init_params(
        ref.specs(cfg or tiny_config()), seed, "cpu").items()}


def pixels(seed, dtype=F64):
    """A uint8 episode widened as the sampler widens it: (B, M, S, S, 3)
    support and query images, class-major labels."""
    g = torch.Generator().manual_seed(seed)

    def images(m):
        x = torch.randint(0, 256, (B, m, S, S, 3), generator=g)
        return (x.to(torch.float32) * (1.0 / 255.0)).to(dtype)
    y = torch.arange(N)
    return {"s_x": images(N * K), "q_x": images(N * Q),
            "s_y": y.repeat_interleave(K).repeat(B, 1),
            "q_y": y.repeat_interleave(Q).repeat(B, 1)}


def as_episode(e):
    return Episode(support_im=e["s_x"], support_text=None,
                   support_text_mask=None, support_ids=None,
                   support_y=e["s_y"].to(torch.int32), query_im=e["q_x"],
                   query_ids=None, query_y=e["q_y"].to(torch.int32))


def program_step(p, e, **kw):
    """The port's loss, meta-gradient and inner-step record, and the names
    of the spans the inner loop opened."""
    fam = program(**kw)
    spans, span = [], inner_loop.span

    def named(name):
        spans.append(name)
        return span(name)
    inner_loop.span = named
    try:
        with inner_loop.recording() as records:
            (loss, _), grads = steps.value_and_grad(fam, p, as_episode(e),
                                                    None)
    finally:
        inner_loop.span = span
    return float(loss), grads, records[0], spans


def reference_step(p, e):
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    loss, grads = ref.loss_and_grads(leaves, e, None, TRAIN)
    return float(loss), grads


def grad_gap(a, b):
    scale = max(float(v.abs().max()) for v in b.values())
    return max(float((a[k] - b[k]).abs().max()) for k in b) / scale


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def base():
    """The port's step (inner steps checkpointed, as ``--tpu_remat auto``
    has it for resnet12) and the reference's, in fp64, once."""
    p, e = weights(), pixels(1)
    loss, grads, record, spans = program_step(p, e)
    r_loss, r_grads = reference_step(p, e)
    return SimpleNamespace(p=p, e=e, loss=loss, grads=grads, record=record,
                           spans=spans, r_loss=r_loss, r_grads=r_grads)


@pytest.fixture(scope="module")
def driver():
    return harness.load_module(
        os.path.join(REPO, "benchmark", "drivers", "train_inner.py"),
        "bench_driver_train_inner_resnet12")


@pytest.mark.parametrize("cfg", [tiny_config(), FULL], ids=["tiny", "full"])
def test_reference_leaves_are_the_programs(cfg):
    fam = program(cfg)
    ours = weights(cfg, dtype=torch.float32)
    assert {k: tuple(v.shape) for k, v in fam.params.items()} == \
        {k: tuple(v.shape) for k, v in ours.items()}
    ch = cfg["widths"]["channels"]
    assert torch.equal(ours["blocks.1.c2.gamma"], torch.ones(ch[1]))
    assert torch.equal(ours["blocks.1.sc.beta"], torch.zeros(ch[1]))
    # nn.Conv2d's bound: fan_in = in·k², in alone for the 1×1 shortcut
    for name, fan_in in (("blocks.0.c1", 27), ("blocks.1.c2", ch[1] * 9),
                         ("blocks.2.sc", ch[1])):
        for leaf in ("weight", "bias"):
            t = ours[f"{name}.{leaf}"]
            assert float(t.abs().max()) <= 1 / math.sqrt(fan_in)
            assert float(t.abs().max()) > 0.5 / math.sqrt(fan_in)
    assert steps.remat_of(Config(**cfg["port"])) == "save_convs"


def test_fp64_the_port_is_the_reference(base, driver):
    """Outer loss, meta-gradient and each recorded inner step (its update,
    the support loss at its state, and the query loss after the last), in
    fp64, the inner steps checkpointed as ``--tpu_remat auto`` does."""
    assert abs(base.loss - base.r_loss) <= 1e-9 * abs(base.r_loss)
    assert grad_gap(base.grads, base.r_grads) <= 1e-9
    gaps = driver.inner_gaps(
        driver.program_steps(base.record, base.loss, STEPS),
        driver.reference_steps(ref, base.record, base.e, ALPHA, F64))
    assert set(gaps) == {"inner_update_gap", "support_loss_gap",
                         "query_loss_gap"}
    assert max(gaps.values()) <= 1e-9, gaps


def test_checkpointed_steps_are_the_plain_steps_bitwise(base):
    """The checkpointed inner steps give the plain steps' (``--tpu_remat
    off``) loss and meta-gradient bit for bit; the outer backward opens
    one ``inner.recompute`` span a step, and none without checkpointing
    (the support forward built again inside a step's own inner gradient
    opens none). Whether a span reaches the profiler is
    ``tests/test_torch_spans.py``'s."""
    loss, grads, _, spans = program_step(base.p, base.e, remat="off")
    assert spans.count("inner.recompute") == 0
    assert base.spans.count("inner.recompute") == STEPS
    assert base.spans.count("inner.step") == spans.count("inner.step")
    assert loss == base.loss
    for k in grads:
        assert torch.equal(grads[k], base.grads[k]), k


def test_a_skipped_inner_step_fails(base, driver):
    """One inner step fewer than the configuration states: the loss and
    the meta-gradient leave the reference's, and the inner check refuses
    the record."""
    loss, grads, record, _ = program_step(base.p, base.e,
                                          num_train_adapt_steps=STEPS - 1)
    assert abs(loss - base.r_loss) > 1e-3 * abs(base.r_loss)
    assert grad_gap(grads, base.r_grads) > 1e-2
    with pytest.raises(ValueError, match="recorded 1 inner steps"):
        driver.program_steps(record, loss, STEPS)


def test_the_cards_convolutions_are_conv2d(base, monkeypatch):
    """The route the card takes in fp32 (here in fp64 on the CPU, the
    kernels' entry points running their plain versions): a second-order
    step with every 3×3 convolution on the ``conv3x3`` Functions and every
    1×1 shortcut a per-group GEMM equals the ``F.conv2d`` chain, and calls
    each 3×3 entry point as often as the card launches it. For n inner
    steps and 12 3×3 units, one of them on the images (which take no
    input gradient), plain steps make 35n + 12 forwards and weight
    gradients and 33n + 11 input gradients (conv4's 11n + 4 and 9n + 3
    at 4 units). Checkpointed steps add the support forward built again
    inside each step for its inner gradient (12n forwards), and each
    step's forward and inner gradient rebuilt in the outer backward (12n
    forwards, 12n weight and 11n input gradients): 59n + 12, 47n + 12 and
    44n + 11; the shortcut's GEMM runs in each of those 3n + 1 forward
    passes of 4 stages. Every unit's norm and activation take
    ``norm_relu_pool``'s leaky forms (here their plain versions), as often
    as the card launches them: per stage, 3n + 1 forwards and backwards
    and n double backwards of the residual form (c3 and the shortcut),
    twice that of the norm and leaky ReLU (c1, c2)."""
    counts = {"fprop": 0, "dgrad": 0, "wgrad": 0}
    conv = kernels._conv

    def counted(kind, a, b, groups):
        counts[kind] += 1
        return conv(kind, a, b, groups)
    gemms = []
    pointwise = resnet12.pointwise_conv

    def gemm(*a):
        gemms.append(a[1].shape)
        return pointwise(*a)
    norms = {}
    for name in ("_nrp_forward", "_nrp_backward", "_nrp_double_backward"):
        def norm_counted(form, *a, _fn=getattr(kernels, name), _name=name):
            norms[form, _name] = norms.get((form, _name), 0) + 1
            return _fn(form, *a)
        monkeypatch.setattr(kernels, name, norm_counted)
    monkeypatch.setattr(kernels, "_conv", counted)
    monkeypatch.setattr(resnet12, "pointwise_conv", gemm)
    monkeypatch.setattr(conv4, "fused_norm_applies", lambda z, low: not low)
    loss, grads, _, _ = program_step(base.p, base.e)
    n = STEPS
    assert counts == {"fprop": 59 * n + 12, "wgrad": 47 * n + 12,
                      "dgrad": 44 * n + 11}, counts
    assert len(gemms) == 4 * (3 * n + 1)
    passes = {"_nrp_forward": 3 * n + 1, "_nrp_backward": 3 * n + 1,
              "_nrp_double_backward": n}
    assert norms == {
        **{(kernels.LEAKY, k): 8 * v for k, v in passes.items()},
        **{(kernels.LEAKY_SUM_POOL, k): 4 * v for k, v in passes.items()}
    }, norms
    assert abs(loss - base.loss) <= 1e-10 * abs(base.loss)
    assert grad_gap(grads, base.grads) <= 1e-10


def test_conv_flops_match_a_count_by_hand():
    """84×84×3 through ResNet-12 64-160-320-640: the 3×3 units run at 84²,
    42², 21² and 10² positions; the rule counts 4·u + 9·v a support image
    an inner step and 2·u + 3·v a query image, u the data's layers (stage
    0's c1 and shortcut), v the rest; 25 support and 160 query images, 5
    steps, 4 tasks: 44.96 TFLOP, 7.02 GFLOP a forward image."""
    sides, chans = (84, 42, 21, 10), (64, 160, 320, 640)
    u3, u1, cin = [], [], 3
    for side, ch in zip(sides, chans):
        u3 += [2 * side ** 2 * ch * cin * 9, 2 * side ** 2 * ch * ch * 9,
               2 * side ** 2 * ch * ch * 9]
        u1.append(2 * side ** 2 * ch * cin)
        cin = ch
    head = 2 * 640 * 5

    def step(data, rest):
        return 4 * (5 * 25 * (4 * data + 9 * rest) + 160 * (2 * data
                                                          + 3 * rest))
    assert costs.conv_flops(FULL) == step(u3[0], sum(u3[1:]))
    full = step(u3[0] + u1[0], sum(u3[1:]) + sum(u1[1:]) + head)
    assert costs.step_flops(FULL) == full
    assert 44.95e12 < full < 44.97e12
    assert 7.01e9 < sum(u3) + sum(u1) + head < 7.02e9


def metric(name):
    return harness.load_module(
        os.path.join(REPO, "benchmark", "metrics", name + ".py"),
        "m_" + name.replace(".", "_"))


class Ctx:
    config = FULL
    costs = costs


def recompute_trace(with_spans=True):
    """Two steps of 100 µs: recomputes 30–40 and 45–60 µs in the first,
    60–70 (twice, overlapping) in the second, with their counters."""
    host = [Event(STRETCH, 0, 200), Event("train.meta_grad", 25, 95),
            Event("train.meta_grad", 125, 195)]
    if with_spans:
        host += [Event("inner.recompute", 30, 40),
                 Event("inner.recompute", 45, 60),
                 Event("inner.recompute", 160, 170),
                 Event("inner.recompute", 162, 170),
                 Event("mem.inner.recompute=31000000000", 40, 40),
                 Event("mem.inner.recompute=52500000000", 60, 60),
                 Event("mem.inner.recompute=40000000000", 170, 170)]
    return Trace([Event("sm90_xmma_gemm_f32f32", 10, 190)], host, 2e-4)


def test_recompute_readers_on_a_synthetic_trace():
    rec = {"trace": recompute_trace(), "trace_steps": 2}
    # the ranges' union is 10 + 15 + 10 µs over 2 steps
    assert metric("recompute_ms.train").read(Ctx, rec) == pytest.approx(
        35e-3 / 2)
    assert metric("recompute_gb.train").read(Ctx, rec) == pytest.approx(52.5)


@pytest.mark.parametrize("name", ["recompute_ms.train",
                                  "recompute_gb.train"])
def test_recompute_readers_read_nothing_where_there_is_nothing(name):
    bare = recompute_trace(with_spans=False)
    for rec in ({"trace": bare, "trace_steps": 2}, {"trace": None}, {}):
        assert metric(name).read(Ctx, rec) is None
