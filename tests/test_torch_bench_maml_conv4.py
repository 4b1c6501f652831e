"""The benchmark's MAML-on-Conv-4-64 pieces against the port, on the CPU:
the plain reference (``benchmark/reference/maml.py``), the cost rule
(``benchmark/costs/maml.py``), the inner-step check of the
``train_inner`` driver, and the readers of the convolutions' share,
their roofline and the memory counter.

Sizes: 16×16×3 images, Conv-4-64, B=2 tasks of 3 ways, 2 shots and 4
queries a class, 2 inner steps at α=0.1; weights from the benchmark's own
seeded draw. Tolerances, and why:

- fp64: the port and the reference compute the same function, so their
  outer loss, meta-gradient and every inner step agree to 1e-9 (relative,
  or of the gradient's scale): rounding alone.
- fp32: any two fp32 evaluations part at a max-pool window whose two
  largest values lie within rounding of each other, where they route the
  window's gradient to different elements (at these sizes such a window
  moves a leaf's gradient by up to ~0.3%). The losses at a given state are
  continuous there: 1e-5 relative. An inner step's update by the check's
  own measure (the leaf's norm gap over max(leaf, median leaf)): 1e-3.
- Tied pixels (four grey levels, a first convolution that reads the
  centre pixel): whole windows tie exactly, and the port and the reference
  both split a tie's gradient evenly, 1e-4 of the gradient's scale apart in
  fp32; a pool that sends the gradient to one element is ~10% away.
"""

import json
import math
import os
import shutil
import sys
import time

import pytest
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark import harness  # noqa: E402
from benchmark.costs import maml as costs  # noqa: E402
from benchmark.reference import common, maml as ref  # noqa: E402
from benchmark.trace import STRETCH, Event, Trace  # noqa: E402
from fumi_tpu_torch.core.config import Config  # noqa: E402
from fumi_tpu_torch.core.episode import Episode  # noqa: E402
from fumi_tpu_torch.metalearn import inner_loop  # noqa: E402
from fumi_tpu_torch.models import conv4  # noqa: E402
from fumi_tpu_torch.train import steps  # noqa: E402

B, N, K, Q, S, STEPS, ALPHA = 2, 3, 2, 4, 16, 2, 0.1
CELL = "conv4.train"
FULL = json.load(open(os.path.join(
    REPO, "benchmark", "configs", "maml-conv4-inat-anim.json")))
TRAIN = {"inner_steps": STEPS, "step_size": ALPHA}


def tiny_config() -> dict:
    """The configuration at the tests' size, every width else as stated."""
    cfg = json.loads(json.dumps(FULL))
    cfg["name"] = "tiny-conv4"
    cfg["widths"].update(im_size=S, num_ways=N)
    cfg["episode"] = {"num_ways": N, "num_shots": K, "num_query_train": Q}
    cfg["train"].update(batch_size=B, inner_steps=STEPS, step_size=ALPHA,
                        lr=1e-3)
    cfg["data"].update(classes=15, rows=300, row_shape=[S, S, 3],
                       text_dim=4)
    cfg["port"].update(im_size=S, num_ways=N, num_shots=K, num_shots_test=Q,
                       batch_size=B, num_train_adapt_steps=STEPS,
                       step_size=ALPHA, lr=1e-3)
    return cfg


def program(cfg=None, **kw):
    port = dict((cfg or tiny_config())["port"], **kw)
    return steps.build_family(Config(**port),
                              torch.Generator().manual_seed(0))


def weights(cfg=None, seed=3, dtype=torch.float32):
    return {k: v.to(dtype) for k, v in common.init_params(
        ref.specs(cfg or tiny_config()), seed, "cpu").items()}


def pixels(seed, levels=256):
    """A uint8 episode widened as the sampler widens it: (B, M, S, S, 3)
    support and query images, class-major labels."""
    g = torch.Generator().manual_seed(seed)

    def images(m):
        x = torch.randint(0, levels, (B, m, S, S, 3), generator=g)
        return (x * (255 // (levels - 1))).to(torch.uint8).to(
            torch.float32) * (1.0 / 255.0)
    y = torch.arange(N)
    return {"s_x": images(N * K), "q_x": images(N * Q),
            "s_y": y.repeat_interleave(K).repeat(B, 1),
            "q_y": y.repeat_interleave(Q).repeat(B, 1)}


def as_episode(e):
    return Episode(support_im=e["s_x"], support_text=None,
                   support_text_mask=None, support_ids=None,
                   support_y=e["s_y"].to(torch.int32), query_im=e["q_x"],
                   query_ids=None, query_y=e["q_y"].to(torch.int32))


def cast(e, dtype):
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in e.items()}


def program_step(p, e, **kw):
    """The port's loss, meta-gradient and inner-step record."""
    fam = program(**kw)
    with inner_loop.recording() as records:
        (loss, _), grads = steps.value_and_grad(fam, p, as_episode(e), None)
    return float(loss), grads, records[0]


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
def driver():
    root = os.path.join(REPO, "benchmark")
    return harness.load_module(os.path.join(root, "drivers",
                                            "train_inner.py"),
                               "bench_driver_train_inner")


@pytest.mark.parametrize("cfg", [tiny_config(), FULL], ids=["tiny", "full"])
def test_reference_leaves_are_the_programs(cfg):
    fam = program(cfg)
    ours = weights(cfg)
    assert {k: tuple(v.shape) for k, v in fam.params.items()} == \
        {k: tuple(v.shape) for k, v in ours.items()}
    assert torch.equal(ours["convs.1.gamma"], torch.ones(64))
    assert torch.equal(ours["convs.1.beta"], torch.zeros(64))
    assert float(ours["convs.1.weight"].abs().max()) <= 1 / math.sqrt(576)
    assert float(ours["convs.0.bias"].abs().max()) <= 1 / math.sqrt(27)


def test_fp64_the_port_is_the_reference(driver):
    """Outer loss, meta-gradient and each recorded inner step, in fp64."""
    p, e = weights(dtype=torch.float64), cast(pixels(1), torch.float64)
    loss, grads, record = program_step(p, e)
    r_loss, r_grads = reference_step(p, e)
    assert abs(loss - r_loss) <= 1e-9 * abs(r_loss)
    assert grad_gap(grads, r_grads) <= 1e-9
    ref_steps = driver.reference_steps(ref, record, e, ALPHA, torch.float64)
    gaps = driver.inner_gaps(driver.program_steps(record, loss, STEPS),
                             ref_steps)
    assert max(gaps.values()) <= 1e-9, gaps


@pytest.mark.parametrize("seed", [1, 2])
def test_fp32_inner_steps_within_rounding(driver, seed):
    p, e = weights(), pixels(seed)
    loss, _, record = program_step(p, e)
    gaps = driver.inner_gaps(
        driver.program_steps(record, loss, STEPS),
        driver.reference_steps(ref, record, e, ALPHA, torch.float32))
    assert gaps["support_loss_gap"] <= 1e-5
    assert gaps["query_loss_gap"] <= 1e-5
    assert gaps["inner_update_gap"] <= 1e-3


def tied_weights():
    """The first convolution reads the centre pixel alone, so equal pixels
    give equal values and whole pool windows tie."""
    p = weights()
    mask = torch.zeros(3, 3)
    mask[1, 1] = 1.0
    p["convs.0.weight"] = p["convs.0.weight"] * mask
    return p


def first_block_ties(p, x):
    h = F.conv2d(x.permute(0, 3, 1, 2), p["convs.0.weight"],
                 p["convs.0.bias"], padding=1)
    mean = h.mean(dim=(0, 2, 3), keepdim=True)
    h = torch.relu((h - mean) / torch.sqrt(
        ((h - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True) + ref.EPS))
    M, C, H, W = h.shape
    w = h.reshape(M, C, H // 2, 2, W // 2, 2).permute(0, 1, 2, 4, 3, 5)
    w = w.reshape(M, C, H // 2, W // 2, 4)
    top = w.amax(dim=-1, keepdim=True)
    return int((((w == top) & (top > 0)).sum(-1) > 1).sum())


def one_element_pool(y):
    """The fault: a tied window's gradient all to one element."""
    M, G, H, W = y.shape
    return F.max_pool2d(y[:, :, :H // 2 * 2, :W // 2 * 2], 2)


def test_pool_splits_a_tie_evenly():
    x = torch.tensor([[[[1.0, 1.0, 0.0, 2.0],
                        [1.0, 0.5, 2.0, 2.0]]]], requires_grad=True)
    for pool in (ref.pool, conv4.maxpool2x2):
        g, = torch.autograd.grad(pool(x).sum(), x)
        assert torch.equal(g, torch.tensor([[[[1 / 3, 1 / 3, 0, 1 / 3],
                                              [1 / 3, 0, 1 / 3, 1 / 3]]]]))


def test_tied_pixels_split_the_gradient_as_the_reference(monkeypatch):
    p, e = tied_weights(), pixels(4, levels=4)
    assert first_block_ties(p, e["s_x"][0]) > 100
    loss, grads, _ = program_step(p, e)
    r_loss, r_grads = reference_step(p, e)
    assert abs(loss - r_loss) <= 1e-5 * abs(r_loss)
    assert grad_gap(grads, r_grads) <= 1e-4
    # the fault, planted in the port: the meta-gradient leaves the
    # reference's by far more than the tolerance
    monkeypatch.setattr(conv4, "maxpool2x2", one_element_pool)
    _, bad, _ = program_step(p, e)
    assert grad_gap(bad, r_grads) > 1e-2


def test_a_skipped_inner_step_fails(driver):
    """One inner step fewer than the configuration states: the loss and
    the meta-gradient leave the reference's, and the inner check refuses
    the record."""
    p, e = weights(), pixels(1)
    loss, grads, record = program_step(p, e, num_train_adapt_steps=STEPS - 1)
    r_loss, r_grads = reference_step(p, e)
    assert abs(loss - r_loss) > 1e-2 * abs(r_loss)
    assert grad_gap(grads, r_grads) > 1e-2
    with pytest.raises(ValueError, match="recorded 1 inner steps"):
        driver.program_steps(record, loss, STEPS)


def test_an_unchanged_state_reads_one(driver):
    p, e = weights(), pixels(1)
    loss, _, record = program_step(p, e)
    frozen = record._replace(theta=[record.theta[0]] * len(record.theta))
    gaps = driver.inner_gaps(
        driver.program_steps(frozen, loss, STEPS),
        driver.reference_steps(ref, record, e, ALPHA, torch.float32))
    assert gaps["inner_update_gap"] == 1.0


def test_conv_flops_match_a_count_by_hand():
    """84×84×3 through four 3×3 convolutions to 64 channels: the outputs
    are 84², 42², 21² and 10² positions (SAME, then a VALID 2×2 pool);
    the rule counts 4·u0 + 9·u a support image an inner step and 2·u0 +
    3·u a query image; 25 support and 160 query images, 5 steps, 4 tasks."""
    u = [2 * 84 * 84 * 64 * 27, 2 * 42 * 42 * 64 * 576,
         2 * 21 * 21 * 64 * 576, 2 * 10 * 10 * 64 * 576]
    u0, rest = u[0], sum(u[1:])
    want = 4 * (5 * 25 * (4 * u0 + 9 * rest) + 160 * (2 * u0 + 3 * rest))
    assert costs.conv_flops(FULL) == want
    assert 1.17e12 < want < 1.172e12
    by_layer = costs.conv_flops_by_layer(FULL)
    assert by_layer[0] == 4 * (5 * 25 * 4 + 160 * 2) * u0
    assert by_layer[1] == 4 * (5 * 25 * 9 + 160 * 3) * u[1]
    head = 2 * 5 * 5 * 64 * 5
    assert costs.step_flops(FULL) == want + 4 * (5 * 25 * 9 + 160 * 3) * head


def metric(name):
    return harness.load_module(
        os.path.join(REPO, "benchmark", "metrics", name + ".py"),
        "m_" + name.replace(".", "_"))


class Ctx:
    config = FULL
    costs = costs


CONV = "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nhwckrsc_nhwc"
WGRAD = "sm80_xmma_wgrad_implicit_gemm_indexed_f32f32_f32f32_f32"


def conv_trace(with_convs=True, with_counter=True):
    """One step of 100 µs: convolutions 10–40 and 50–70 µs (30–40 twice,
    overlapping), a GEMM 40–50 µs, the counter's ranges."""
    device = [Event("sm80_xmma_gemm_f32f32_f32f32_f32_tn", 40, 50)]
    if with_convs:
        device += [Event(CONV, 10, 40), Event(WGRAD, 30, 40),
                   Event(WGRAD, 50, 70)]
    host = [Event(STRETCH, 0, 100), Event("train.loss", 5, 45),
            Event("train.meta_grad", 45, 95)]
    if with_counter:
        host += [Event("mem.train.loss=24500000000", 44, 44),
                 Event("mem.train.meta_grad=2100000000", 94, 94)]
    return Trace(device, host, 1e-4)


def test_readers_on_a_synthetic_trace():
    rec = {"trace": conv_trace(), "trace_steps": 1}
    # the convolutions' union is 50 µs of the busy 60 (10–70)
    assert metric("conv_share.train").read(Ctx, rec) == pytest.approx(
        100 * 50 / 60)
    least = costs.conv_flops(FULL) / 67e12
    assert metric("conv_roofline.train").read(Ctx, rec) == pytest.approx(
        100 * least / 50e-6)
    assert metric("graph_gb.train").read(Ctx, rec) == pytest.approx(24.5)
    assert metric("meta_grad_gb.train").read(Ctx, rec) == pytest.approx(2.1)


NORM = "void (anonymous namespace)::norm_relu_pool_grad2_kernel<4>(float const*)"


def test_norm_share_reads_the_ops_kernels():
    """norm_relu_pool's kernels 20–30 and 25–45 µs (union 25) of a step
    whose busy time is 10–70 µs with them (60): 41.7%; the convolutions'
    share still finds cuDNN's kernels alone."""
    tr = conv_trace()
    tr = Trace(tr.device + [Event(NORM, 20, 30),
                            Event(NORM.replace("grad2", "apply"), 25, 45)],
               tr.host, 1e-4)
    rec = {"trace": tr, "trace_steps": 1}
    assert metric("norm_share.train").read(Ctx, rec) == pytest.approx(
        100 * 25 / 60)
    assert metric("conv_share.train").read(Ctx, rec) == pytest.approx(
        100 * 50 / 60)


@pytest.mark.parametrize("name", ["conv_share.train", "conv_roofline.train",
                                  "graph_gb.train", "meta_grad_gb.train",
                                  "norm_share.train"])
def test_readers_read_nothing_where_there_is_nothing(name):
    bare = conv_trace(with_convs=False, with_counter=False)
    for rec in ({"trace": bare, "trace_steps": 1}, {"trace": None}, {}):
        assert metric(name).read(Ctx, rec) is None


# the cell's numbers at the tests' size on the CPU, at the configuration's
# own α and learning rate: fp32 rounding, and the pool windows it flips
# (see the module's docstring), which move a leaf's gradient by up to
# ~0.3% here, and the three steps' gradient and change by ~1%
TINY_LIMITS = {"inner_update_gap": 1e-2, "support_loss_gap": 1e-5,
               "query_loss_gap": 1e-5, "grad_gap": 0.1, "change_gap": 0.3,
               "episode_gap": 0, "episode_bad": 0}


def tiny_root(dest):
    """A copy of the benchmark whose only cell is ``conv4.train`` at the
    tests' size, with limits for that size."""
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = tiny_config()
    # the configuration's own inner step and learning rate
    for block, keys in (("train", ("step_size", "lr")),
                        ("port", ("step_size", "lr"))):
        for k in keys:
            cfg[block][k] = FULL[block][k]
    with open(os.path.join(dest, "benchmark", "configs",
                           "tiny-conv4.json"), "w") as f:
        json.dump(cfg, f)
    cell = json.load(open(os.path.join(REPO, "benchmark", "workloads",
                                       CELL + ".json")))
    cell.update(config=cfg["name"], trace={"steps": 2}, limits=TINY_LIMITS,
                traffic=dict(cell["traffic"], warm_steps=1))
    with open(os.path.join(dest, "benchmark", "workloads",
                           CELL + ".json"), "w") as f:
        json.dump(cell, f)
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    bench["configs"] = [{"name": cfg["name"], "source": "test",
                         "file": "benchmark/configs/tiny-conv4.json",
                         "reduced": [], "why": "tiny"}]
    bench["workloads"] = [w for w in bench["workloads"] if w["name"] == CELL]
    bench["workloads"][0]["config"] = cfg["name"]
    for kind in ("end_to_end", "per_layer"):
        bench[kind] = [e for e in bench[kind]
                       if CELL in e.get("workloads", [CELL])]
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dest


def test_the_cell_runs_and_is_correct_on_the_cpu(tmp_path):
    root = tiny_root(str(tmp_path))
    result = harness.run_cell(root, CELL, 2 ** 31 + 7, 0.3, True,
                              torch.device("cpu"), time.perf_counter())
    assert result["correct"], result["checks"]
    cell = json.load(open(os.path.join(REPO, "benchmark", "workloads",
                                       CELL + ".json")))
    assert set(result["checks"]) == set(TINY_LIMITS) == set(cell["limits"])
    assert result["attempted"] > 0 and result["failed"] == 0
    # no card: no convolution kernel and no counter on the trace
    for name in ("conv_share.train", "conv_roofline.train",
                 "graph_gb.train", "meta_grad_gb.train", "norm_share.train"):
        assert name not in result["metrics"]
    assert "inner_loop_ms.train" in result["metrics"]


def test_a_program_without_the_recorder_fails_before_its_tables(
        tmp_path, monkeypatch):
    root = tiny_root(str(tmp_path))
    monkeypatch.delattr(inner_loop, "recording")
    made = []
    import benchmark.data
    monkeypatch.setattr(benchmark.data, "make_tables",
                        lambda *a, **k: made.append(1))
    with pytest.raises(RuntimeError, match="recording"):
        harness.run_cell(root, CELL, 5, 0.3, False, torch.device("cpu"),
                         time.perf_counter())
    assert made == []
