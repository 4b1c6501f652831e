"""Card-only tests of the port (they skip without a GPU): each CUDA kernel
against its plain version, the paths that launch them, and what only the
card runs (cuBLAS's bf16 product, NCCL). What the CPU tests hold against
the JAX package and a card does not change is not repeated here.

This file imports no JAX, so it also runs on a machine without it:

    python tests/test_torch_cuda.py

which runs pytest on this file without ``tests/conftest.py`` (that file
sets JAX up for the CPU tests). ``scripts/kernel_times.py`` times the same
kernels alone at full width.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

if __name__ == "__main__":  # run as a script: import the port from this checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from fumi_tpu_torch.core.config import Config
from fumi_tpu_torch.core.episode import Episode, EpisodeSpec
from fumi_tpu_torch.data import sampler, synthetic
from fumi_tpu_torch.models import mlp
from fumi_tpu_torch.ops import kernels
from fumi_tpu_torch.serve import FewShotClassifier
from fumi_tpu_torch.train import steps
from scripts.kernel_times import CONV4, CONV_SHAPES, NRP_SHAPES

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided at run time, never
    at import, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (B, S, Qn, D, H1, H2, N, steps): odd sizes cover the ragged tile edges
# (S, H1, H2 not multiples of the tiles), D=300 a cluster of 9 blocks whose
# last owns fewer columns, S > 32 more rows than one query chunk; B = 1, 4,
# 8 and 16 at the flagship widths run in one and in several waves of
# 16-block clusters; D=4096 gives a block 256 columns; 264 and 1024 and
# 2048 hidden units take W1 two, four and eight column groups at a time,
# 2048 over 5 support rows with query chunks of 8 rows; 64 support rows at
# D=4096, 4096 hidden units and 125 support rows keep the blocks' private
# buffers in device memory; 0 steps is the forward alone
SHAPES = [(3, 37, 50, 64, 32, 16, 5, 20),
          (2, 25, 100, 300, 264, 20, 7, 10),
          (1, 6, 3, 16, 8, 8, 3, 0),
          (1, 25, 128, 2048, 256, 64, 5, 10),
          (4, 25, 100, 2048, 256, 64, 5, 10),
          (8, 25, 100, 2048, 256, 64, 5, 5),
          (16, 25, 100, 2048, 256, 64, 5, 3),
          (2, 25, 50, 4096, 256, 64, 5, 5),
          (2, 5, 20, 2048, 1024, 64, 5, 10),
          (1, 5, 100, 2048, 2048, 64, 5, 10),
          (2, 64, 40, 4096, 256, 64, 5, 5),
          (1, 5, 30, 2048, 4096, 64, 5, 5),
          (1, 125, 40, 2048, 64, 32, 5, 5),
          (4, 25, 100, 2048, 256, 64, 5, 0)]


def _inputs(cuda_device, shape, seed):
    B, S, Qn, D, H1, H2, N, steps = shape
    gen = torch.Generator().manual_seed(sum(shape))
    p = {k: v.to(cuda_device)
         for k, v in mlp.init(gen, D, N, (H1, H2)).items()}
    rng = np.random.RandomState(seed)

    def dev(a):
        return torch.from_numpy(a).to(cuda_device)
    sx = dev(rng.randn(B, S, D).astype(np.float32))
    qx = dev(rng.randn(B, Qn, D).astype(np.float32))
    sy = dev(rng.randint(0, N, (B, S)).astype(np.int32))
    head_w = dev(rng.randn(B, N, H2).astype(np.float32) * 0.3)
    head_b = dev(rng.randn(B, 1, N).astype(np.float32) * 0.3)
    return p, sx, sy, qx, head_w, head_b


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_reference(cuda_device, shape):
    """Per-task heads. fp32 on both sides; the kernel sums the D-deep
    products in C partial sums and carries W1's change in the Gram form,
    the plain version sums in cuBLAS's order and updates W1, and the steps
    carry the difference forward, hence 1e-4."""
    steps = shape[-1]
    p, sx, sy, qx, head_w, head_b = _inputs(cuda_device, shape, 0)
    args = (p["net.lin_0.weight"], p["net.lin_0.bias"],
            p["net.lin_1.weight"], p["net.lin_1.bias"], head_w, head_b,
            sx, sy, qx, steps, 0.05)
    before = kernels.fused_adapt.launches
    got = kernels.fused_adapt(*args)
    torch.cuda.synchronize()
    assert kernels.fused_adapt.launches == before + 1
    want = kernels.fused_adapt_reference(*args)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_plan_on_the_card(cuda_device):
    """The card schedules the flagship's 16-block cluster with W1 tiles of
    32 rows; the source's layout gives the plan's bytes; D=4096 takes the
    same cluster with 256 columns a block."""
    optin, max_cluster = kernels.card_limits(torch.cuda.current_device())
    flagship = (4, 25, 100, 2048, 256, 64, 5)
    plan = kernels.fused_adapt_plan(flagship, optin, max_cluster)
    assert (plan.C, plan.cols, plan.tile_k) == (16, 128, 32)
    assert kernels.active_clusters(torch.cuda.current_device(), plan.C,
                                   plan.smem_bytes) >= 4
    lib = kernels._library()
    for dims in (flagship, (3, 37, 50, 64, 32, 16, 5),
                 (2, 25, 100, 300, 264, 20, 7), (2, 25, 50, 4096, 256, 64, 5),
                 (1, 64, 100, 2048, 256, 64, 10),
                 (1, 5, 100, 2048, 2048, 64, 5),
                 (1, 64, 100, 4096, 256, 64, 5)):
        plan = kernels.fused_adapt_plan(dims, optin, max_cluster)
        B, S, Qn, D, H1, H2, N = dims
        assert lib.fused_adapt_smem_bytes(
            S, D, H1, H2, N, plan.C, plan.tile_k, plan.query_rows,
            int(plan.private == "device")) == plan.smem_bytes
    assert kernels.fused_adapt_plan((2, 25, 50, 4096, 256, 64, 5), optin,
                                    max_cluster)[:2] == (16, 256)


def test_kernel_refuses_a_plan_that_does_not_match(cuda_device):
    """The C side recomputes the layout and returns cudaErrorInvalidValue
    (1) for a plan whose bytes, columns, tile depth or query chunk are not
    its own, or whose private buffers go to a device-memory scratch buffer
    too small for them."""
    p, sx, sy, qx, head_w, head_b = _inputs(cuda_device,
                                            (1, 6, 3, 16, 8, 8, 3, 1), 0)
    out = torch.empty(1, 3, 3, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    plan = kernels.fused_adapt_plan((1, 6, 3, 16, 8, 8, 3),
                                    *kernels.card_limits(
                                        torch.cuda.current_device()))
    shared, own = kernels._layout(6, 16, 8, 8, 3, plan.C, plan.tile_k,
                                  plan.query_rows)
    scratch = torch.empty(own // 4 - 1, device=cuda_device)
    ptrs = [t.data_ptr() for t in (sx, sy, qx, p["net.lin_0.weight"],
                                   p["net.lin_0.bias"], p["net.lin_1.weight"],
                                   p["net.lin_1.bias"], head_w, head_b, out,
                                   scratch)]
    lib = kernels._library()
    q = plan.query_rows
    for C, cols, tile_k, rows, private, nbytes in (
            (plan.C, plan.cols, plan.tile_k, q, 0, plan.smem_bytes + 16),
            (plan.C, plan.cols + 1, plan.tile_k, q, 0, plan.smem_bytes),
            (plan.C, plan.cols, 12, q, 0, plan.smem_bytes),
            (plan.C, plan.cols, plan.tile_k, 6, 0, plan.smem_bytes),
            (17, 1, plan.tile_k, q, 0, plan.smem_bytes),
            (plan.C, plan.cols, plan.tile_k, q, 1, shared)):
        assert lib.fused_adapt_launch(*ptrs, 24, 3, 1, 6, 3, 16, 8, 8, 3, C,
                                      cols, tile_k, rows, private, nbytes,
                                      scratch.numel(), 1, 0.05, stream) == 1


KERNEL_NAME = "(anonymous namespace)::fused_adapt_kernel<"


def test_served_request_is_one_kernel(cuda_device):
    """A profiled ``episode_logits`` call launches exactly one kernel of
    ``csrc/fused_adapt.cu``, under the name the benchmark's readers look
    for (``benchmark/metrics/fused_adapt_roofline.serve.py``)."""
    from torch.profiler import ProfilerActivity, profile
    cfg = Config(model="fumi", dataset="synthetic", im_emb_dim=128,
                 text_emb_dim=32, im_hid_dim=(64, 16), text_hid_dim=32,
                 num_ways=5, num_shots=3, num_test_adapt_steps=30,
                 step_size=0.05, dropout=0.0, text_encoder="precomputed",
                 seed=1)
    clf = FewShotClassifier(cfg)
    rng = np.random.RandomState(3)
    s_im = rng.randn(15, 128).astype(np.float32)
    s_tx = rng.randn(15, 32).astype(np.float32)
    s_y = np.repeat(np.arange(5), 3).astype(np.int32)
    q_im = rng.randn(20, 128).astype(np.float32)
    clf.episode_logits(s_im, s_y, q_im, support_text=s_tx)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        clf.episode_logits(s_im, s_y, q_im, support_text=s_tx)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "fused_adapt_kernel" in e.name]
    assert len(names) == 1, names
    assert names[0].removeprefix("void ").startswith(KERNEL_NAME), names


def test_served_shape_within_the_benchmarks_limits(cuda_device):
    """The served request's shape (R=1, M=128, 100 steps at 0.01, the
    flagship widths, rows in [0, 1) as the benchmark draws them) over 16
    seeds against the plain loop in fp64: the benchmark's served limits,
    a median largest gap of 5e-4 of the largest logit and at most 0.35 of
    the answers over 0.05 (``benchmark/workloads/fumi.serve.json``)."""
    S, M, D, H1, H2, N = 25, 128, 2048, 256, 64, 5
    gaps = []
    for seed in range(16):
        gen = torch.Generator().manual_seed(seed)
        p = mlp.init(gen, D, N, (H1, H2))
        sx = torch.rand(1, S, D, generator=gen)
        qx = torch.rand(1, M, D, generator=gen)
        sy = torch.repeat_interleave(torch.arange(N, dtype=torch.int32),
                                     S // N).reshape(1, S)
        head_w = 0.3 * torch.randn(1, N, H2, generator=gen)
        head_b = 0.3 * torch.randn(1, 1, N, generator=gen)
        args = (p["net.lin_0.weight"], p["net.lin_0.bias"],
                p["net.lin_1.weight"], p["net.lin_1.bias"], head_w, head_b,
                sx, sy, qx)
        args = tuple(a.to(cuda_device) for a in args)
        got = kernels.fused_adapt(*args, 100, 0.01).double()
        exact = kernels.fused_adapt_reference(
            *(a if a.dtype == torch.int32 else a.double() for a in args),
            100, 0.01)
        gaps.append(float((got - exact).abs().max() / exact.abs().max()))
    assert np.isfinite(gaps).all(), gaps
    assert float(np.median(gaps)) <= 5e-4, gaps
    assert np.mean(np.array(gaps) > 0.05) <= 0.35, gaps


def test_kernel_result_per_task_independent_of_batch(cuda_device):
    """One cluster per task, and the plan does not depend on B: a task's
    logits are bitwise the same whatever else is in the batch."""
    gen = torch.Generator().manual_seed(2)
    p = {k: v.to(cuda_device)
         for k, v in mlp.init(gen, 96, 4, (48, 16)).items()}
    rng = np.random.RandomState(2)

    def dev(a):
        return torch.from_numpy(a).to(cuda_device)
    sx = dev(rng.randn(3, 12, 96).astype(np.float32))
    qx = dev(rng.randn(3, 20, 96).astype(np.float32))
    sy = dev(rng.randint(0, 4, (3, 12)).astype(np.int32))
    full = kernels.fused_maml_adapt(p, sx, sy, qx, 15, 0.05)
    for b in range(3):
        one = kernels.fused_maml_adapt(p, sx[b:b + 1], sy[b:b + 1],
                                       qx[b:b + 1], 15, 0.05)
        assert torch.equal(one[0], full[b])


@pytest.mark.parametrize("width", ["small", "flagship"])
@pytest.mark.parametrize("model", ["fumi", "maml"])
def test_served_kernel_matches_autograd_engine(cuda_device, model, width):
    """A batched request through ``fused_adapt`` (one launch) against the
    same request through the autograd engine. Small: 3 episodes, 128 wide,
    30 steps at 0.05, within 1e-4, every argmax equal. Flagship
    (:func:`_flagship`): 4 episodes of 25 support rows and 100 queries,
    2048/768 wide, 100 steps at 0.01, within 1e-3 (fp32 summed in other
    orders over 100 steps); an argmax may differ only on a row whose
    engine logits' top two lie within 2e-3, a tie at that tolerance."""
    if width == "flagship":
        cfg, R, S, Q, D, T = _flagship(model), 4, 25, 100, 2048, 768
        rtol, atol, tie = 0.0, 1e-3, 2e-3
    else:
        cfg = Config(model=model, dataset="synthetic", im_emb_dim=128,
                     text_emb_dim=32, im_hid_dim=(64, 16), text_hid_dim=32,
                     num_ways=5, num_shots=3, num_test_adapt_steps=30,
                     step_size=0.05, dropout=0.0, text_encoder="precomputed",
                     seed=1)
        R, S, Q, D, T = 3, 15, 20, 128, 32
        rtol, atol, tie = 1e-4, 1e-4, None
    clf = FewShotClassifier(cfg, device=cuda_device)
    engine = FewShotClassifier(cfg, clf.params, device=cuda_device)
    engine._episode_fn = engine._build_episode_fn(force_engine=True)
    rng = np.random.RandomState(1)
    s_im = rng.randn(R, S, D).astype(np.float32)
    s_tx = rng.randn(R, S, T).astype(np.float32)
    s_y = np.tile(np.repeat(np.arange(5), S // 5), (R, 1)).astype(np.int32)
    q_im = rng.randn(R, Q, D).astype(np.float32)
    before = kernels.fused_adapt.launches
    got = clf.episode_logits_batch(s_im, s_y, q_im, support_text=s_tx)
    assert kernels.fused_adapt.launches == before + 1
    want = engine.episode_logits_batch(s_im, s_y, q_im, support_text=s_tx)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    top2 = np.sort(want, axis=-1)[..., -2:]
    near = (top2[..., 1] - top2[..., 0] <= tie) if tie else np.zeros(
        want.shape[:-1], bool)
    np.testing.assert_array_equal(got.argmax(-1)[~near],
                                  want.argmax(-1)[~near])


# (dtype, rows, width, M): fp32 rows of 16-byte multiples take the vector
# path, bf16 at width 100 (200-byte rows) the 4-byte one, uint8 at odd
# widths the byte one; M=0 and M > the block count's cap are edges too
GATHER_CASES = [(torch.float32, 4096, 2048, 640), (torch.float32, 300, 768, 100),
                (torch.float32, 50, 100, 37), (torch.float32, 9, 3, 5),
                (torch.bfloat16, 4096, 2048, 640), (torch.bfloat16, 70, 100, 33),
                (torch.uint8, 4096, 2048, 640), (torch.uint8, 80, 99, 41),
                (torch.uint8, 20, 1, 7), (torch.float32, 16, 8, 0)]


@pytest.mark.parametrize("case", GATHER_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_gather_rows_bitwise(cuda_device, case):
    dtype, rows, width, M = case
    gen = torch.Generator().manual_seed(rows + width + M)
    if dtype == torch.uint8:
        table = torch.randint(0, 256, (rows, width), generator=gen,
                              dtype=torch.uint8)
    else:
        table = torch.randn((rows, width), generator=gen).to(dtype)
    idx = torch.randint(0, rows, (M,), generator=gen, dtype=torch.int32)
    table, idx = table.to(cuda_device), idx.to(cuda_device)
    before = kernels.gather_rows.launches
    got = kernels.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert kernels.gather_rows.launches == before + (M > 0)
    assert got.dtype == dtype and got.shape == (M, width)
    assert torch.equal(got, kernels.gather_rows_reference(table, idx))
    # a table that starts one row in: the pointer alignment changes
    assert torch.equal(kernels.gather_rows(table[1:], idx.clamp(max=rows - 2)),
                       table[1:][idx.clamp(max=rows - 2).long()])


def test_gather_rows_out_of_range_raises_at_synchronize(cuda_device):
    """A device-side assert spoils the CUDA context of its process, so the
    bad launch runs in a child process."""
    code = (
        "import torch\n"
        "from fumi_tpu_torch.ops import kernels\n"
        "table = torch.zeros(8, 64, device='cuda')\n"
        "idx = torch.tensor([0, 8], dtype=torch.int32, device='cuda')\n"
        "kernels.gather_rows(table, idx)\n"
        "try:\n"
        "    torch.cuda.synchronize()\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n"
        "    raise SystemExit(0)\n"
        "raise SystemExit('no error at synchronize')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "raised:" in out.stdout


# (B, S, Qn, D, H1, H2, N, steps): the shapes of SHAPES with MAML's shared
# head (read at a task stride of 0)
@pytest.mark.parametrize("shape", SHAPES)
def test_batched_kernel_matches_reference(cuda_device, shape):
    """fp32 on both sides in other summation orders, as for fused_adapt:
    1e-4, the same argmax. The per-task form on the broadcast head runs
    the same kernel on the same values: bitwise the same logits."""
    steps = shape[-1]
    p, sx, sy, qx, _, _ = _inputs(cuda_device, shape, 1)
    before = (kernels.fused_maml_adapt_batched.launches,
              kernels.fused_adapt.launches)
    got = kernels.fused_maml_adapt_batched(p, sx, sy, qx, steps, 0.05)
    torch.cuda.synchronize()
    assert (kernels.fused_maml_adapt_batched.launches,
            kernels.fused_adapt.launches) == (before[0] + 1, before[1])
    want = kernels.fused_maml_adapt_batched_reference(p, sx, sy, qx, steps,
                                                      0.05)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    per_task = kernels.fused_maml_adapt(p, sx, sy, qx, steps, 0.05)
    assert torch.equal(got, per_task)


def test_batched_kernel_raises_where_shared_memory_does_not_fit(cuda_device):
    """32 support rows of 2048 hidden units at D=64 (a cluster of 2):
    each block's partial sums of 1024 columns exceed its 227 KB of shared
    memory."""
    gen = torch.Generator().manual_seed(0)
    p = {k: v.to(cuda_device)
         for k, v in mlp.init(gen, 64, 3, (2048, 16)).items()}
    sx = torch.randn(1, 32, 64, device=cuda_device)
    sy = torch.zeros(1, 32, dtype=torch.int32, device=cuda_device)
    for fn in (kernels.fused_maml_adapt_batched, kernels.fused_maml_adapt):
        with pytest.raises(RuntimeError, match="shared memory"):
            fn(p, sx, sy, sx, 1, 0.05)


# (rows, width, seed): the flagship support set, the flagship query count,
# odd widths (scalar path), one element, a row count over the grid cap
AUGMENT_CASES = [(100, 2048, 1), (640, 2048, 2), (37, 99, 3), (1, 1, 4),
                 (3, 5, 2 ** 62 - 1), (70000, 4, 6)]


@pytest.mark.parametrize("case", AUGMENT_CASES)
def test_augment_bitwise(cuda_device, case):
    rows, width, seed = case
    x = torch.randn(rows, width, generator=torch.Generator().manual_seed(
        rows)).to(cuda_device)
    s = torch.tensor([seed], dtype=torch.int64, device=cuda_device)
    before = kernels.augment_embeddings.launches
    got = kernels.augment_embeddings(x, s, 0.1)
    torch.cuda.synchronize()
    assert kernels.augment_embeddings.launches == before + 1
    assert torch.equal(got, kernels.augment_embeddings_reference(x, s, 0.1))
    # a row slice at its offset, and a start 4 bytes past 16-byte
    # alignment (the scalar path), jitter as the whole
    assert torch.equal(kernels.augment_embeddings(x[1:].contiguous(), s, 0.1,
                                                  row_offset=1), got[1:])
    buf = torch.empty(rows * width + 1, device=cuda_device)
    buf[1:] = x.reshape(-1)
    assert torch.equal(kernels.augment_embeddings(
        buf[1:].view(rows, width), s, 0.1), got)
    # 1 + jitter rounds to fp32, and so does x times it: 1e-6 of slack
    ratio = (got / x).double()
    assert float(ratio.min()) >= 0.9 - 1e-6
    assert float(ratio.max()) <= 1.1 + 1e-6


# (dtype, rows, width, M, row_offset): fp32, bf16 and uint8 rows at the
# flagship support gather take the 16-, 8- and 4-byte group loads, odd
# widths the scalar path (2050 over several warps of a row); M = 0 and 1;
# row offsets past 2**32, and rows whose counters cross it; more rows
# than one warp a row covers at once
GATHER_AUGMENT_CASES = [(torch.float32, 4096, 2048, 100, 0),
                        (torch.bfloat16, 4096, 2048, 100, 0),
                        (torch.uint8, 4096, 2048, 100, 0),
                        (torch.float32, 50, 99, 37, 3),
                        (torch.bfloat16, 70, 5, 33, 2 ** 33 + 1),
                        (torch.uint8, 80, 99, 41, 0),
                        (torch.uint8, 20, 6, 1, 9),
                        (torch.bfloat16, 30, 2050, 7, 4),
                        (torch.float32, 16, 8, 0, 0),
                        (torch.float32, 70000, 4, 70000, 0),
                        (torch.float32, 64, 2048, 100, 2 ** 32 - 50)]


@pytest.mark.parametrize("case", GATHER_AUGMENT_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_gather_augment_bitwise(cuda_device, case):
    dtype, rows, width, M, offset = case
    gen = torch.Generator().manual_seed(rows + width + M)
    if dtype == torch.uint8:
        table = torch.randint(0, 256, (rows, width), generator=gen,
                              dtype=torch.uint8)
    else:
        table = torch.randn((rows, width), generator=gen).to(dtype)
    idx = torch.randint(0, rows, (M,), generator=gen, dtype=torch.int32)
    table, idx = table.to(cuda_device), idx.to(cuda_device)
    s = torch.tensor([rows * 7919 + width], dtype=torch.int64,
                     device=cuda_device)
    before = kernels.gather_augment_rows.launches
    got = kernels.gather_augment_rows(table, idx, s, 0.1, offset)
    torch.cuda.synchronize()
    assert kernels.gather_augment_rows.launches == before + (M > 0)
    assert got.dtype == torch.float32 and got.shape == (M, width)
    assert torch.equal(got, kernels.gather_augment_rows_reference(
        table, idx, s, 0.1, offset))
    # the two kernels it replaces give the same bits
    assert torch.equal(got, kernels.augment_embeddings(
        sampler.pixels_to_float(kernels.gather_rows(table, idx)), s, 0.1,
        offset))
    # a table that starts one element in: its groups lose their alignment
    buf = torch.empty(rows * width + 1, dtype=dtype, device=cuda_device)
    buf[1:] = table.reshape(-1)
    assert torch.equal(kernels.gather_augment_rows(
        buf[1:].view(rows, width), idx, s, 0.1, offset), got)


def test_gather_augment_out_of_range_raises_at_synchronize(cuda_device):
    """As for gather_rows: the bad launch runs in a child process."""
    code = (
        "import torch\n"
        "from fumi_tpu_torch.ops import kernels\n"
        "table = torch.zeros(8, 64, device='cuda')\n"
        "idx = torch.tensor([0, 8], dtype=torch.int32, device='cuda')\n"
        "seed = torch.ones(1, dtype=torch.int64, device='cuda')\n"
        "kernels.gather_augment_rows(table, idx, seed)\n"
        "try:\n"
        "    torch.cuda.synchronize()\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n"
        "    raise SystemExit(0)\n"
        "raise SystemExit('no error at synchronize')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "raised:" in out.stdout


# (dtype, table rows, width, (B, N, K, Q)): the flagship train (5+32) and
# eval (5+20) episodes on fp32, bf16 and uint8 tables; K+Q of 1 (support
# only, query only) at an odd width; D = 2050 (scalar path, several warps
# a row); 70,000 rows in one launch; iNat-Anim's 195,605 raw uint8 images
# of 84·84·3 (4.14 GB), whose later half starts past 2**31 bytes
EPISODE_CASES = [(torch.float32, 4096, 2048, (4, 5, 5, 32)),
                 (torch.float32, 4096, 2048, (4, 5, 5, 20)),
                 (torch.bfloat16, 4096, 2048, (4, 5, 5, 32)),
                 (torch.uint8, 4096, 2048, (4, 5, 5, 20)),
                 (torch.float32, 300, 99, (2, 3, 1, 0)),
                 (torch.bfloat16, 300, 99, (2, 3, 0, 1)),
                 (torch.uint8, 300, 2050, (2, 5, 5, 20)),
                 (torch.float32, 300, 2050, (1, 5, 5, 32)),
                 (torch.float32, 70000, 4, (100, 20, 5, 30)),
                 (torch.uint8, 195605, 84 * 84 * 3, (4, 5, 5, 2))]


@pytest.mark.parametrize("case", EPISODE_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "").replace(" ", "") for x in c))
def test_gather_episode_bitwise(cuda_device, case):
    """Bitwise its plain version, with and without the jitter; the support
    rows bitwise ``gather_augment_rows`` of the support indices and the
    query rows the widened ``gather_rows`` of the query indices (the
    PR 5 route), and a table view that starts one element in (its groups
    lose their alignment) gives the same rows. The episode's jitter rows
    start at 0; row counters past 2**32 run the same kernel body through
    ``gather_augment_rows`` (GATHER_AUGMENT_CASES)."""
    dtype, rows, width, (B, N, K, Q) = case
    gen = torch.Generator().manual_seed(rows + width + K + Q)
    if dtype == torch.uint8:
        table = torch.randint(0, 256, (rows, width), generator=gen,
                              dtype=torch.uint8)
    else:
        table = torch.randn((rows, width), generator=gen).to(dtype)
    idx = torch.randint(0, rows, (B, N, K + Q), generator=gen,
                        dtype=torch.int32)
    table, idx = table.to(cuda_device), idx.to(cuda_device)
    buf = torch.empty(rows * width + 1, dtype=dtype, device=cuda_device)
    buf[1:] = table.reshape(-1)
    s_idx, q_idx = idx[..., :K].reshape(-1), idx[..., K:].reshape(-1)
    seed = torch.tensor([rows * 7919 + width], dtype=torch.int64,
                        device=cuda_device)
    for sd, scale in ((None, 0.0), (seed, 0.1)):
        before = kernels.gather_episode_rows.launches
        got = kernels.gather_episode_rows(table, idx, K, sd, scale)
        torch.cuda.synchronize()
        assert kernels.gather_episode_rows.launches == before + 1
        want = kernels.gather_episode_rows_reference(table, idx, K, sd,
                                                     scale)
        for g, w, m in zip(got, want, (N * K, N * Q)):
            assert g.dtype == torch.float32 and g.shape == (B, m, width)
            assert torch.equal(g, w)
        support = (kernels.gather_augment_rows(table, s_idx, sd, scale)
                   if sd is not None else
                   sampler.pixels_to_float(kernels.gather_rows(table, s_idx)))
        query = sampler.pixels_to_float(kernels.gather_rows(table, q_idx))
        assert torch.equal(got[0].reshape(-1, width), support)
        assert torch.equal(got[1].reshape(-1, width), query)
        view = kernels.gather_episode_rows(buf[1:].view(rows, width), idx,
                                           K, sd, scale)
        assert torch.equal(view[0], got[0]) and torch.equal(view[1], got[1])


def test_gather_episode_out_of_range_raises_at_synchronize(cuda_device):
    """As for gather_rows: the bad launch runs in a child process."""
    code = (
        "import torch\n"
        "from fumi_tpu_torch.ops import kernels\n"
        "table = torch.zeros(8, 64, device='cuda')\n"
        "rows = torch.tensor([[[0, 1], [2, 8]]], dtype=torch.int32, "
        "device='cuda')\n"
        "kernels.gather_episode_rows(table, rows, 1)\n"
        "try:\n"
        "    torch.cuda.synchronize()\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n"
        "    raise SystemExit(0)\n"
        "raise SystemExit('no error at synchronize')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "raised:" in out.stdout


def test_sampler_jitter_routes_agree_on_the_card(cuda_device):
    """--augment with the kernel gather (one gather_episode_rows launch)
    and without it (the library gather, then augment_embeddings) draw
    bitwise the same episode from the same generator seed."""
    cs, table, ids = synthetic.synthetic_class_set(
        num_classes=10, images_per_class=12, im_dim=64, text_dim=16)
    spec = EpisodeSpec(2, 3, 2, 4, 64, 16)
    eps = {}
    for pallas in (True, False):
        smp = sampler.DeviceEpisodeSampler(
            table, ids, cs, spec, use_pallas_gather=pallas,
            augment_scale=0.1, device=cuda_device)
        names = ("gather_episode_rows", "gather_rows",
                 "gather_augment_rows", "augment_embeddings")
        before = [getattr(kernels, n).launches for n in names]
        eps[pallas] = smp.sample(smp.generator(3))
        assert [getattr(kernels, n).launches - b
                for n, b in zip(names, before)] == \
            ([1, 0, 0, 0] if pallas else [0, 0, 0, 1])
    for name in Episode._fields:
        a, b = getattr(eps[True], name), getattr(eps[False], name)
        assert (a is None and b is None) or torch.equal(a, b), name


def test_augment_rejects_strided_input_and_other_seeds(cuda_device):
    x = torch.randn(64, 32, device=cuda_device)
    s = torch.tensor([1], dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.augment_embeddings(x.t(), s)
    with pytest.raises(TypeError, match="int64"):
        kernels.augment_embeddings(x, s.int())
    with pytest.raises(ValueError, match="seed on cpu"):
        kernels.augment_embeddings(x, s.cpu())


LAUNCHED = ("gather_episode_rows", "gather_rows", "gather_augment_rows",
            "augment_embeddings", "fused_adapt", "fused_maml_adapt_batched")


def _launches(since=None):
    """The wrappers' launch counts, or (given earlier counts) the nonzero
    launches made since."""
    now = {n: getattr(kernels, n).launches for n in LAUNCHED}
    if since is None:
        return now
    return {n: now[n] - since[n] for n in LAUNCHED if now[n] != since[n]}


@pytest.mark.parametrize("model", ["fumi", "maml", "reptile"])
def test_maml_fused_eval_runs_the_batched_kernel(cuda_device, model):
    """Eval through the fused kernels, one launch a meta-batch (FuMI's
    generated heads through ``fused_adapt``; MAML's and Reptile's shared
    head through ``fused_maml_adapt_batched``), against the same
    meta-batches through the autograd engine: the loss within 1e-4 (fp32
    summed in other orders over 10 steps), the accuracy within one
    query."""
    variant = dict(meta_grad="reptile") if model == "reptile" else {}
    cfg = Config(model="fumi" if model == "fumi" else "maml",
                 dataset="synthetic", im_emb_dim=64, text_emb_dim=16,
                 im_hid_dim=(32, 16), text_hid_dim=16, num_ways=3,
                 num_shots=2, num_test_adapt_steps=10, batch_size=2,
                 step_size=0.1, dropout=0.0, text_encoder="precomputed",
                 pallas_fused_eval=True, seed=0, **variant)
    cs, table, ids = synthetic.synthetic_class_set(
        num_classes=10, images_per_class=40, im_dim=64, text_dim=16)
    smp = sampler.DeviceEpisodeSampler(
        table, ids, cs, EpisodeSpec(2, 3, 2, 33, 64, 16), device=cuda_device)
    kernel = "fused_adapt" if model == "fumi" else "fused_maml_adapt_batched"
    out = {}
    for fused in (True, False):
        st = steps.make_steps(cfg.replace(pallas_fused_eval=fused),
                              torch.Generator().manual_seed(0),
                              device=cuda_device)
        before = _launches()
        _, out[fused] = steps.make_chunked_eval(st.family, smp)(
            st.params, smp.generator(0), 3)
        assert _launches(before) == ({kernel: 3} if fused else {})
    k, e = out[True], out[False]
    assert torch.isfinite(k["loss"]).all()
    np.testing.assert_allclose(k["loss"].cpu().numpy(),
                               e["loss"].cpu().numpy(), rtol=1e-4, atol=1e-4)
    assert float((k["acc"] - e["acc"]).abs().max()) <= 1 / (3 * 33) + 1e-6


# The train step held card against CPU: the flagship families, the
# meta-gradient variants (ANIL, Reptile, iMAML), the bf16 policy (its
# table stored in bf16) and the raw-image backbones at the CPU backbone
# tests' sizes (16x16x3 images, resnet12 channels (8, 12, 16, 24)).
STEP_CASES = {
    "fumi": dict(model="fumi"),
    "maml": dict(model="maml"),
    "anil": dict(model="maml", adapt_params="head"),
    "reptile": dict(model="maml", meta_grad="reptile"),
    "imaml-maml": dict(model="maml", meta_grad="imaml"),
    "imaml-fumi": dict(model="fumi", meta_grad="imaml"),
    "fumi-bf16": dict(model="fumi", compute_dtype="bfloat16"),
    "maml-bf16": dict(model="maml", compute_dtype="bfloat16"),
    "maml-conv4": dict(model="maml", im_encoder="conv4", im_size=16),
    "maml-resnet12": dict(model="maml", im_encoder="resnet12", im_size=16,
                          resnet12_channels=(8, 12, 16, 24)),
}
BF16 = 2.0 ** -8


def _step_sampler(cfg, device):
    """The device sampler with the kernel gather: 64-wide embeddings, or
    16x16x3 images for a raw backbone, stored as the policy stores them."""
    spec = (2, 3, 2, 4)
    if cfg.im_encoder != "precomputed":
        cs, table, ids = synthetic.synthetic_raw_image_set(
            num_classes=10, images_per_class=12, im_size=16, channels=3,
            text_dim=16)
        spec += (16, 16)
    else:
        cs, table, ids = synthetic.synthetic_class_set(
            num_classes=10, images_per_class=12, im_dim=64, text_dim=16)
        spec += (64, 16)
    table = sampler.table_storage(torch.from_numpy(table), cfg.compute_dtype)
    return sampler.DeviceEpisodeSampler(
        table, ids, cs, EpisodeSpec(*spec), use_pallas_gather=True,
        device=device)


def _step(step, episode, device):
    """One SGD step from the seed-0 weights on ``episode``: its metrics,
    and the params before and after it, on the CPU."""
    ep = Episode(*(None if t is None else t.to(device) for t in episode))
    p, _, m = step.train_step(step.params, step.opt.init(step.params), ep,
                              None)
    return ({k: float(v) for k, v in m.items()},
            {k: v.cpu() for k, v in step.params.items()},
            {k: v.cpu() for k, v in p.items()})


def _update(run):
    """Each leaf's change in a :func:`_step`."""
    _, before, after = run
    return {k: after[k] - before[k] for k in after}


def _distance(a, b):
    """The Euclidean distance of two updates over all their leaves."""
    return sum(float((a[k].double() - b[k].double()).pow(2).sum())
               for k in b) ** 0.5


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_on_card_matches_cpu(cuda_device, monkeypatch, case):
    """One train step from the same weights on the same episode, dropout
    0, card against CPU; before it, a chunk of two steps on the device
    sampler launches ``gather_episode_rows`` once a step and no other
    kernel of the episode or the adaptation.

    Tolerances. fp32 MLPs: every metric and updated param within 1e-4 (the
    sums' order; the SGD step keeps the gradient's own differences
    visible). The bf16 policy, as the CPU bf16 tests hold it: the loss and
    each leaf's update within 4 bf16 ulps of its scale, or 1.5x the
    distance of the CPU's bf16 step from its fp32 step; and, so that a card
    step in fp32 cannot pass, the whole update within half that distance,
    which the card's fp32 step is not. The raw backbones,
    as the CPU backbone tests hold them (second order through batch-stat
    norms over a few images; cuDNN deterministic): the loss within 1e-5,
    the update within 2e-4 of its largest entry."""
    kw = STEP_CASES[case]
    cfg = Config(**{**dict(dataset="synthetic", im_emb_dim=64,
                           text_emb_dim=16, im_hid_dim=(32, 16),
                           text_hid_dim=16, num_ways=3, num_shots=2,
                           num_shots_test=4, batch_size=2,
                           num_train_adapt_steps=3, step_size=0.1,
                           dropout=0.0, optim="SGD", lr=0.1,
                           text_encoder="precomputed", seed=0), **kw})
    smp = _step_sampler(cfg, cuda_device)
    card = steps.make_steps(cfg, torch.Generator().manual_seed(0),
                            device=cuda_device)
    before = _launches()
    steps.make_chunked_train(card.family, card.opt, smp, 2)(
        card.params, card.opt.init(card.params), smp.generator(1))
    assert _launches(before) == {"gather_episode_rows": 2}
    raw = cfg.im_encoder != "precomputed"
    if raw:
        monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    episode = smp.sample(smp.generator(0))
    card_run = _step(card, episode, cuda_device)
    host_run = _step(steps.make_steps(cfg, torch.Generator().manual_seed(0),
                                      device="cpu"), episode, "cpu")
    m_card, m_host = card_run[0], host_run[0]
    assert set(m_card) == set(m_host)
    if cfg.compute_dtype == "bfloat16":
        fp32_run = _step(steps.make_steps(
            cfg.replace(compute_dtype="float32"),
            torch.Generator().manual_seed(0), device="cpu"), episode, "cpu")
        u_card, u_host, u32 = map(_update, (card_run, host_run, fp32_run))
        for got, want, fp32 in [(torch.tensor(m_card["loss"]),
                                 torch.tensor(m_host["loss"]),
                                 torch.tensor(fp32_run[0]["loss"]))] + [
                (u_card[k], u_host[k], u32[k]) for k in u_host]:
            bound = max(4 * BF16 * float(want.abs().max()),
                        1.5 * float((want - fp32).abs().max()))
            assert float((got - want).abs().max()) <= bound
        # the card computed in bf16: its update is nearer the CPU's bf16
        # update than half the CPU's fp32 update is; the card's own fp32
        # step, the control, is not
        card32 = _update(_step(steps.make_steps(
            cfg.replace(compute_dtype="float32"),
            torch.Generator().manual_seed(0), device=cuda_device), episode,
            cuda_device))
        assert _distance(u_card, u_host) < 0.5 * _distance(u32, u_host)
        assert _distance(card32, u_host) >= 0.5 * _distance(u32, u_host)
    elif raw:
        np.testing.assert_allclose(m_card["loss"], m_host["loss"], rtol=1e-5,
                                   atol=1e-5)
        u_card, u_host = _update(card_run), _update(host_run)
        scale = max(float(u.abs().max()) for u in u_host.values())
        for k in u_host:
            assert float((u_card[k] - u_host[k]).abs().max()) <= \
                2e-4 * scale, k
    else:
        for k in m_host:
            np.testing.assert_allclose(m_card[k], m_host[k], rtol=1e-4,
                                       atol=1e-4, err_msg=k)
        for k, want in host_run[2].items():
            np.testing.assert_allclose(card_run[2][k].numpy(), want.numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=k)


def test_am3_train_step_on_card_matches_cpu(cuda_device):
    """One AM3 train step (prototypes, no inner loop) from the same weights
    on the same episode, dropout 0: fp32 on both, summed in other orders,
    1e-4; the confusion matrix and the predictions exactly."""
    cfg = Config(model="am3", dataset="synthetic", im_emb_dim=64,
                 text_emb_dim=16, prototype_dim=16, text_hid_dim=16,
                 num_ways=3, num_shots=2, num_shots_test=4, batch_size=2,
                 dropout=0.0, optim="SGD", lr=0.1, text_encoder="BERT",
                 seed=0)
    cs, table, ids = synthetic.synthetic_class_set(
        num_classes=10, images_per_class=12, im_dim=64, text_dim=16)
    smp = sampler.DeviceEpisodeSampler(
        table, ids, cs, EpisodeSpec(2, 3, 2, 4, 64, 16),
        use_pallas_gather=True, device=cuda_device)
    episode = smp.sample(smp.generator(0))
    card = steps.make_steps(cfg, torch.Generator().manual_seed(0),
                            device=cuda_device)
    host = steps.make_steps(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    host_ep = Episode(*(None if t is None else t.cpu() for t in episode))
    (_, a_card), _ = steps.value_and_grad(card.family, card.params, episode,
                                          None)
    (_, a_host), _ = steps.value_and_grad(host.family, host.params, host_ep,
                                          None)
    assert torch.equal(a_card["conf"].cpu(), a_host["conf"])
    assert torch.equal(a_card["preds"].cpu(), a_host["preds"])
    p_card, _, m_card = card.train_step(
        card.params, card.opt.init(card.params), episode, None)
    p_host, _, m_host = host.train_step(
        host.params, host.opt.init(host.params), host_ep, None)
    assert set(m_card) == set(m_host)
    for k in m_host:
        np.testing.assert_allclose(float(m_card[k]), float(m_host[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    for k in p_host:
        np.testing.assert_allclose(p_card[k].cpu().numpy(),
                                   p_host[k].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def _driver_run(log_dir, model):
    """A run dir the port's driver wrote on the card, and its config."""
    import glob
    from fumi_tpu_torch.cli import main as cli_main
    from fumi_tpu_torch.core.config import config_from_args
    argv = ["--model", model, "--dataset", "synthetic", "--im_emb_dim",
            "128", "--text_emb_dim", "16", "--im_hid_dim", "32", "16",
            "--text_hid_dim", "16", "--prototype_dim", "16", "--num_ways",
            "3", "--num_shots", "2", "--num_shots_test", "4", "--batch_size",
            "2", "--num_ep_test", "4", "--epochs", "4", "--eval_freq", "2",
            "--num_train_adapt_steps", "2", "--num_test_adapt_steps", "10",
            "--step_size", "0.1", "--lr", "0.01", "--text_encoder",
            "precomputed", "--seed", "0", "--wandb_offline",
            "--tpu_pallas_gather", "--log_dir", str(log_dir)]
    cli_main.cli(argv)
    (run,) = glob.glob(os.path.join(str(log_dir), "runs", "*"))
    return config_from_args(argv), run


@pytest.mark.parametrize("model", ["fumi", "maml", "am3", "protonet",
                                   "matchingnet"])
def test_serving_from_checkpoint_on_card(cuda_device, tmp_path, model):
    """``from_checkpoint`` on a run dir the driver wrote on the card gives
    bitwise the logits of a classifier on ``load_checkpoint``'s params (the
    same kernel on the same inputs); a FuMI/MAML request launches
    ``fused_adapt`` once; ``reload(best=False)`` swaps the weights and
    drops the adapted state."""
    from fumi_tpu_torch.train import checkpoint
    cfg, run = _driver_run(tmp_path, model)
    clf = FewShotClassifier.from_checkpoint(run, cfg)
    assert clf.device.type == "cuda"
    st = steps.make_steps(cfg, torch.Generator().manual_seed(0),
                          device=cuda_device)
    params, _, _ = checkpoint.load_checkpoint(run, st.params,
                                              st.opt.init(st.params))
    ref = FewShotClassifier(cfg, params)
    rng = np.random.RandomState(0)
    s_im = rng.randn(6, 128).astype(np.float32)
    s_tx = rng.randn(6, 16).astype(np.float32)
    s_y = np.repeat(np.arange(3), 2).astype(np.int32)
    q_im = rng.randn(7, 128).astype(np.float32)
    before = kernels.fused_adapt.launches
    got = clf.episode_logits(s_im, s_y, q_im, support_text=s_tx)
    fused = model in ("fumi", "maml")
    assert kernels.fused_adapt.launches - before == int(fused)
    np.testing.assert_array_equal(
        got, ref.episode_logits(s_im, s_y, q_im, support_text=s_tx))
    assert got.shape == (7, 3) and np.isfinite(got).all()
    clf.adapt(s_im, s_tx, s_y)
    clf.reload(run, best=False)
    with pytest.raises(RuntimeError):
        clf.classify(q_im)
    assert np.isfinite(clf.episode_logits(s_im, s_y, q_im,
                                          support_text=s_tx)).all()


def test_http_on_card(cuda_device):
    """The HTTP front-end on the card: health says cuda, and /v1/episode
    answers the in-process labels and probabilities within 1e-5 from a
    worker thread's launch of ``fused_adapt``."""
    import json
    import threading
    import urllib.request
    from fumi_tpu_torch import serve_http
    from fumi_tpu_torch.serve import _np_softmax
    cfg = Config(model="fumi", dataset="synthetic", im_emb_dim=128,
                 text_emb_dim=16, im_hid_dim=(32, 16), text_hid_dim=16,
                 num_ways=3, num_shots=2, num_test_adapt_steps=20,
                 step_size=0.1, dropout=0.0, text_encoder="precomputed",
                 seed=0)
    clf = FewShotClassifier(cfg)
    server = serve_http.make_server(clf, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    def call(path, body=None):
        data = None if body is None else json.dumps(body).encode()
        with opener.open(urllib.request.Request(url + path, data=data),
                         timeout=120) as resp:
            return json.loads(resp.read())
    try:
        assert call("/healthz")["backend"] == "cuda"
        rng = np.random.RandomState(1)
        s_im = rng.randn(6, 128).astype(np.float32)
        s_tx = rng.randn(6, 16).astype(np.float32)
        s_y = np.repeat(np.arange(3), 2).astype(np.int32)
        q_im = rng.randn(9, 128).astype(np.float32)
        body = {"support_im": s_im.tolist(), "support_y": s_y.tolist(),
                "query_im": q_im.tolist(), "support_text": s_tx.tolist()}
        before = kernels.fused_adapt.launches
        probs = np.asarray(call("/v1/episode",
                                {**body, "return": "probs"})["result"])
        labels = call("/v1/episode", body)["result"]
        assert kernels.fused_adapt.launches - before == 2
        want = clf.episode_logits(s_im, s_y, q_im, support_text=s_tx)
        np.testing.assert_allclose(probs, _np_softmax(want), rtol=1e-5,
                                   atol=1e-5)
        assert labels == want.argmax(-1).tolist()
    finally:
        server.shutdown()
        server.server_close()


# ---------------------------------------------------------------------------
# CLIP and the token text encoders on the card
# ---------------------------------------------------------------------------

def test_clip_encode_and_loss_on_card_match_cpu(cuda_device):
    """CLIP at the parser's widths (text 768, image 2048, latent 512), card
    against CPU from the same weights: the normalised embeddings and the
    similarity matrix within 1e-5, the masked loss of a batch of 64 with 19
    valid rows within 1e-5 of itself and each gradient within 1e-4 of its
    largest entry (fp32 on both sides, IEEE, summed in other orders)."""
    from fumi_tpu_torch.train import clip_loop
    cfg = Config(model="clip", dataset="synthetic", seed=0)
    model, p_host = clip_loop.make_clip(cfg, torch.Generator().manual_seed(0))
    p_card = {k: v.to(cuda_device) for k, v in p_host.items()}
    rng = np.random.RandomState(0)
    text = torch.from_numpy(rng.randn(64, 768).astype(np.float32))
    image = torch.from_numpy(rng.randn(64, 2048).astype(np.float32))
    for enc, x in (("encode_text", text), ("encode_image", image)):
        got = getattr(model, enc)(p_card, x.to(cuda_device)).cpu()
        np.testing.assert_allclose(got.numpy(), getattr(model, enc)(
            p_host, x).numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        model.forward(p_card, text.to(cuda_device),
                      image.to(cuda_device)).cpu().numpy(),
        model.forward(p_host, text, image).numpy(), rtol=1e-5, atol=1e-5)

    def loss_and_grads(p, dev):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        loss = clip_loop.masked_symmetric_ce(model, leaves, text.to(dev),
                                             image.to(dev), 19)
        return float(loss.detach()), torch.autograd.grad(
            loss, list(leaves.values()))
    l_card, g_card = loss_and_grads(p_card, cuda_device)
    l_host, g_host = loss_and_grads(p_host, "cpu")
    assert abs(l_card - l_host) <= 1e-5 * abs(l_host)
    for a, b in zip(g_card, g_host):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(
            b.abs().max()) + 1e-9


@pytest.mark.parametrize("variant", ["output", "hidden"])
def test_masked_bilstm_on_card_matches_cpu(cuda_device, variant):
    """The biLSTM at its full width (300-wide embeddings, 384 a direction)
    over 100 descriptions of T=12 tokens padded to every length 1..12,
    card against CPU: 12 dependent fp32 cell steps summed in other
    orders, within 1e-5 of the output's scale."""
    from fumi_tpu_torch.data.synthetic import synthetic_dictionary
    from fumi_tpu_torch.models import text_encoders
    enc = text_encoders.make_text_encoder(
        "RNN" if variant == "output" else "RNNhid",
        torch.Generator().manual_seed(0), 768, synthetic_dictionary(128))
    rng = np.random.RandomState(1)
    toks = rng.randint(1, 128, size=(100, 12)).astype(np.int32)
    toks[np.arange(12) >= (1 + np.arange(100) % 12)[:, None]] = 0
    host = enc.apply(enc.params, torch.from_numpy(toks))
    card = enc.apply({k: v.to(cuda_device) for k, v in enc.params.items()},
                     torch.from_numpy(toks).to(cuda_device)).cpu()
    assert card.shape == (100, 768) and bool(torch.isfinite(card).all())
    scale = float(host.abs().max())
    assert float((card - host).abs().max()) <= 1e-5 * max(scale, 1.0)


@pytest.mark.parametrize("encoder", ["RNN", "glove"])
def test_token_fumi_served_through_the_kernel(cuda_device, encoder):
    """A token FuMI request with descriptions padded to mixed lengths: one
    ``fused_adapt`` launch, within 1e-4 of the autograd engine with the
    same argmax."""
    from fumi_tpu_torch.data.synthetic import synthetic_dictionary
    vocab = synthetic_dictionary(32)
    cfg = Config(model="fumi", dataset="synthetic", im_emb_dim=128,
                 text_emb_dim=32, im_hid_dim=(64, 16), text_hid_dim=32,
                 num_ways=5, num_shots=3, num_test_adapt_steps=30,
                 step_size=0.05, dropout=0.0, text_encoder=encoder, seed=1)
    clf = FewShotClassifier(cfg, None, vocab)
    engine = FewShotClassifier(cfg, clf.params, vocab)
    engine._episode_fn = engine._build_episode_fn(force_engine=True)
    rng = np.random.RandomState(2)
    s_im = rng.randn(2, 15, 128).astype(np.float32)
    s_tx = rng.randint(1, 32, size=(2, 15, 9)).astype(np.int32)
    s_tx[..., np.arange(9) >= (1 + np.arange(15) % 9)[:, None]] = 0
    s_y = np.tile(np.repeat(np.arange(5), 3), (2, 1)).astype(np.int32)
    q_im = rng.randn(2, 20, 128).astype(np.float32)
    before = kernels.fused_adapt.launches
    got = clf.episode_logits_batch(s_im, s_y, q_im, support_text=s_tx)
    assert kernels.fused_adapt.launches == before + 1
    want = engine.episode_logits_batch(s_im, s_y, q_im, support_text=s_tx)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_token_id_outside_the_table_answers_400_on_card(cuda_device):
    """A token FuMI server on the card: a request with a token id outside
    the 32-row embedding table answers 400 before the lookup (which would
    fail the CUDA context and every later request), and the next valid
    request answers 200 with the logits it gave before."""
    import json
    import threading
    import urllib.error
    import urllib.request
    from fumi_tpu_torch import serve_http
    from fumi_tpu_torch.data.synthetic import synthetic_dictionary
    cfg = Config(model="fumi", dataset="synthetic", im_emb_dim=128,
                 text_emb_dim=32, im_hid_dim=(64, 16), text_hid_dim=32,
                 num_ways=5, num_shots=3, num_test_adapt_steps=30,
                 step_size=0.05, dropout=0.0, text_encoder="RNN", seed=1)
    clf = FewShotClassifier(cfg, None, synthetic_dictionary(32))
    server = serve_http.make_server(clf, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    def call(body):
        req = urllib.request.Request(url + "/v1/episode",
                                     data=json.dumps(body).encode())
        try:
            with opener.open(req, timeout=120) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())
    try:
        rng = np.random.RandomState(3)
        s_tx = rng.randint(1, 32, size=(15, 9))
        s_tx[np.arange(9) >= (1 + np.arange(15) % 9)[:, None]] = 0
        body = {"support_im": rng.randn(15, 128).tolist(),
                "support_y": np.repeat(np.arange(5), 3).tolist(),
                "query_im": rng.randn(20, 128).tolist(),
                "support_text": s_tx.tolist(), "return": "logits"}
        status, first = call(body)
        assert status == 200
        for bad_id in (32, -1):
            bad = s_tx.copy()
            bad[2, 0] = bad_id
            status, err = call({**body, "support_text": bad.tolist()})
            assert status == 400 and "token ids" in err["error"]
        assert call(body) == (200, first)
    finally:
        server.shutdown()
        server.server_close()


# ---------------------------------------------------------------------------
# What only the card runs: cuBLAS's bf16 product and NCCL
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shapes", [((4, 740, 2048), (2048, 256)),
                                    ((4, 740, 64), (4, 64, 5))],
                         ids=["linear", "generated-head"])
def test_bf16_matmul_route_on_card_matches_the_emulation(cuda_device,
                                                         shapes):
    """The bf16 policy's product at the flagship train step's shapes (the
    first linear layer, FuMI's generated head): the card's cuBLAS bf16
    GEMM with an fp32 output against the CPU's route, the emulation
    (operands rounded to bf16, an fp32 product), run on the card. The
    result within 1e-5 of its scale (fp32 sums in another order) and never
    rounded to bf16; the operands' gradients, rounded to bf16 on both
    routes, within one bf16 ulp of their scale (``tests/test_torch_bf16.py``'s
    tolerances)."""
    from fumi_tpu_torch.models import layers
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    a_shape, b_shape = shapes
    a = torch.randn(a_shape, generator=gen, device=cuda_device)
    b = torch.randn(b_shape, generator=gen, device=cuda_device)
    g = torch.randn(a_shape[:-1] + b_shape[-1:], generator=gen,
                    device=cuda_device)
    a, b = a.requires_grad_(), b.requires_grad_()
    got = layers.matmul_f32acc(a, b, torch.bfloat16)
    g_got = torch.autograd.grad(got, (a, b), g)
    emu = torch.matmul(a.to(torch.bfloat16).float(),
                       b.to(torch.bfloat16).float())
    g_emu = torch.autograd.grad(emu, (a, b), g)
    got, emu = got.detach(), emu.detach()
    assert float((got - emu).abs().max()) <= 1e-5 * float(emu.abs().max())
    assert not torch.equal(got, got.to(torch.bfloat16).float())
    for x, y in zip(g_got, g_emu):
        assert float((x - y).abs().max()) <= BF16 * float(y.abs().max())


def _flagship(model):
    """The flagship serving config: 5-way 5-shot, BERT-width text 768,
    image 2048, im_hid (256, 64), 100 steps at 0.01."""
    return Config(model=model, text_encoder="BERT", im_emb_dim=2048,
                  text_emb_dim=768, text_hid_dim=256, im_hid_dim=(256, 64),
                  num_ways=5, num_shots=5, num_test_adapt_steps=100,
                  step_size=0.01, seed=0)


def _serve_batch(clf, model, request):
    s_im, s_y, q_im, s_tx = request
    return clf.episode_logits_batch(
        s_im, s_y, q_im, support_text=s_tx if model == "fumi" else None)


def _nccl_rank(rank, cfg, request, served):
    """The one rank of a world on the card, so NCCL: the dp engine's chunk
    of 3 train steps, its gradient all-reduced over the world, and each
    model's batched request sharded over it, with the launches of that
    one call. ``make_mesh`` leaves a group of one rank out (its
    collectives are skipped), so the world's group stands in for it."""
    import dataclasses
    import torch.distributed as dist
    from fumi_tpu_torch.core import distributed
    from fumi_tpu_torch.core import mesh as mesh_lib
    from fumi_tpu_torch.parallel import engine
    dev = distributed.rank_device()
    mesh = dataclasses.replace(mesh_lib.make_mesh(1, 1),
                               dp_group=dist.group.WORLD,
                               group=dist.group.WORLD)
    smp = _step_sampler(cfg, dev)
    st = steps.make_steps(cfg, torch.Generator().manual_seed(0), device=dev)
    run = engine.make_parallel_chunked_train(cfg, st.family, st.opt, smp,
                                             mesh, 3)
    out = {"backend": dist.get_backend(), "params": run(
        st.params, st.opt.init(st.params), smp.generator(1))[0]}
    for model, params in served.items():
        clf = FewShotClassifier(_flagship(model), params, device=dev,
                                mesh=mesh)
        before = _launches()
        out[model] = (_serve_batch(clf, model, request), _launches(before))
    return out


def test_one_rank_nccl_world_on_card(cuda_device, tmp_path):
    """A world of one rank on the card (``parallel/launch.py:spawn_world``,
    backend NCCL): the dp engine's chunk of 3 train steps bitwise the
    serial chunk (the all-reduce over one rank changes no bit), and the
    flagship FuMI and MAML requests of R=8 episodes (M=100) sharded over
    that world, their logits gathered by NCCL: the single-rank answer
    (the same clusters' arithmetic; within 2e-4 of the logit scale), one
    ``fused_adapt`` launch a request."""
    from fumi_tpu_torch.parallel.launch import spawn_world
    cfg = Config(model="fumi", dataset="synthetic", im_emb_dim=64,
                 text_emb_dim=16, im_hid_dim=(32, 16), text_hid_dim=16,
                 num_ways=3, num_shots=2, num_shots_test=4, batch_size=2,
                 num_train_adapt_steps=3, step_size=0.1, dropout=0.0,
                 text_encoder="precomputed", seed=0)
    smp = _step_sampler(cfg, cuda_device)
    st = steps.make_steps(cfg, torch.Generator().manual_seed(0),
                          device=cuda_device)
    serial = steps.make_chunked_train(st.family, st.opt, smp, 3)(
        st.params, st.opt.init(st.params), smp.generator(1))[0]
    rng = np.random.RandomState(23)
    y = np.repeat(np.arange(5), 5).astype(np.int32)
    request = (rng.randn(8, 25, 2048).astype(np.float32),
               np.stack([rng.permutation(y) for _ in range(8)]),
               rng.randn(8, 100, 2048).astype(np.float32),
               rng.randn(8, 25, 768).astype(np.float32))
    clfs = {m: FewShotClassifier(_flagship(m), device=cuda_device)
            for m in ("fumi", "maml")}
    served = {m: {k: v.cpu() for k, v in c.params.items()}
              for m, c in clfs.items()}
    (rank,) = spawn_world(_nccl_rank, 1, cfg, request, served,
                          store_dir=str(tmp_path))
    got = rank.value
    assert got["backend"] == "nccl"
    for k, v in serial.items():
        assert torch.equal(got["params"][k], v.cpu()), k
    for model, clf in clfs.items():
        want = _serve_batch(clf, model, request)
        logits, launched = got[model]
        assert logits.shape == (8, 100, 5)
        np.testing.assert_allclose(logits, want, rtol=0,
                                   atol=2e-4 * float(np.abs(want).max()))
        assert launched == {"fused_adapt": 1}


# ---------------------------------------------------------------------------
# norm_relu_pool: conv4's norm, ReLU and pool (csrc/norm_relu_pool.cu)
# ---------------------------------------------------------------------------



def _nrp_inputs(dev, M, G, side, seed, beta=True):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    z = r(M, side, side, G).permute(0, 3, 1, 2)  # channels_last
    return (z, r(G), 1.0 + 0.3 * r(G),
            0.2 * r(G) if beta else torch.zeros(G, device=dev))


def _nrp_passes(z, b, g, be, seed):
    """The kernels' forward, backward and double backward of one shape, on
    random cotangents."""
    gen = torch.Generator(device=z.device).manual_seed(seed)
    out, stats = kernels._nrp_forward(z, b, g, be)
    g_out = torch.randn(out.shape, generator=gen, device=z.device)
    bw = kernels._nrp_backward(z, b, g, be, stats, g_out)
    v = (torch.randn(z.shape, generator=gen, device=z.device),
         torch.randn(b.shape, generator=gen, device=z.device),
         torch.randn(b.shape, generator=gen, device=z.device))
    dbw = kernels._nrp_double_backward(z, b, g, be, stats, g_out, bw[4], *v)
    return (out, stats, g_out) + tuple(bw) + tuple(dbw), v


def _nrp_close(got, want, tol=1e-5):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= tol * scale


def _nrp_hold(z, b, g, be):
    """The three passes against the plain versions on the card, fp32 both,
    within 1e-5 of each output's scale: the kernels sum in fp64 partials
    in another order and round a with one fma. The forward's output is
    continuous, so it is held with a nonzero beta on each side's own
    statistics; the backward and double backward on beta = 0 and the
    kernels' statistics, where a = gamma*x rounds alike on both sides, so
    the ReLU masks and the pool's ties agree bitwise and only the sums'
    order parts them."""
    M, G, H, W = z.shape
    out, stats = kernels._nrp_forward(z, b, g, be)
    want, want_stats = kernels.norm_relu_pool_forward_reference(z, b, g, be)
    assert out.shape == (M, G, H // 2, W // 2)
    assert out.is_contiguous(memory_format=torch.channels_last)
    _nrp_close(out, want)
    _nrp_close(stats, want_stats, 1e-6)
    be = torch.zeros_like(be)
    got, v = _nrp_passes(z, b, g, be, 2)
    stats, g_out = got[1], got[2]
    ref = kernels.norm_relu_pool_backward_reference(z, b, g, be, stats, g_out)
    ref += kernels.norm_relu_pool_double_backward_reference(
        z, b, g, be, stats, g_out, ref[4], *v)
    names = ("g_z", "g_b", "g_gamma", "g_beta", "sums", "c_z", "c_b",
             "c_gamma", "c_beta", "c_gout")
    for name, x, y in zip(names, got[3:], ref):
        if name in ("g_b", "c_b", "c_beta"):
            assert not bool(x.any()) and not bool(y.any()), name
        else:
            _nrp_close(x.double() if name == "sums" else x, y)


@pytest.mark.parametrize("shape", NRP_SHAPES,
                         ids=lambda s: f"M{s[0]}-{s[2]}x{s[2]}")
def test_norm_relu_pool_matches_plain_version(cuda_device, shape):
    """conv4.train's eight shapes, 16-byte loads (:func:`_nrp_hold`)."""
    M, G, side = shape
    _nrp_hold(*_nrp_inputs(cuda_device, M, G, side, 1))


def test_norm_relu_pool_repeats_bitwise(cuda_device):
    """No float atomics: two runs of the three passes give the same bits."""
    z, b, g, be = _nrp_inputs(cuda_device, 25, 256, 84, 5)
    first, _ = _nrp_passes(z, b, g, be, 6)
    second, _ = _nrp_passes(z, b, g, be, 6)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("G,offset", [(15, 0), (16, 1), (320, 0)])
def test_norm_relu_pool_other_channel_counts(cuda_device, G, offset):
    """The scalar walk (G = 15: no vectors of 4; G = 16 one float into its
    storage: unaligned) and several channel blocks (G = 320: 80 vectors,
    two blocks across the channels), odd sides, :func:`_nrp_hold`."""
    z, b, g, be = _nrp_inputs(cuda_device, 3, G, 21, 8)
    base = torch.empty(z.numel() + offset, device=cuda_device)
    nhwc = base[offset:].view(3, 21, 21, G)
    nhwc.copy_(z.permute(0, 2, 3, 1))
    z = nhwc.permute(0, 3, 1, 2)
    aligned = z.data_ptr() % 16 == 0
    assert kernels.norm_relu_pool_plan(G, aligned, 132).vec == (
        4 if G % 4 == 0 and not offset else 1)
    _nrp_hold(z, b, g, be)


def test_norm_relu_pool_launches(cuda_device):
    """One launch a forward, backward and double backward; conv4's four
    blocks launch four forwards in fp32 and none in bf16 or fp64."""
    from fumi_tpu_torch.models import conv4
    z, b, g, be = (t.requires_grad_() for t in
                   _nrp_inputs(cuda_device, 25, 256, 21, 9))
    before = kernels.norm_relu_pool.launches
    out = kernels.norm_relu_pool(z, b, g, be)
    assert kernels.norm_relu_pool.launches == before + 1
    grads = torch.autograd.grad((out * out).sum(), (z, g), create_graph=True)
    assert kernels.norm_relu_pool.launches == before + 2
    torch.autograd.grad(sum(t.sum() for t in grads), be)
    # the double backward, and the outer pass through the forward again
    assert kernels.norm_relu_pool.launches == before + 4
    params = {k: v.to(cuda_device) for k, v in conv4.init(
        torch.Generator().manual_seed(0), im_size=84).items()}
    x = torch.rand(2, 10, 84, 84, 3, device=cuda_device)
    for dtype, cd, launched in ((torch.float32, None, 4),
                                (torch.float32, torch.bfloat16, 0),
                                (torch.float64, None, 0)):
        before = kernels.norm_relu_pool.launches
        p = {k: v.to(dtype) for k, v in params.items()}
        conv4.apply(p, x.to(dtype), cd)
        assert kernels.norm_relu_pool.launches == before + launched


# ---------------------------------------------------------------------------
# conv3x3: conv4's convolutions (csrc/conv3x3.cu)
# ---------------------------------------------------------------------------

CONV_ENTRIES = ("fprop", "dgrad", "wgrad")


def _conv_inputs(dev, M, G, cin, side, seed):
    """x (M, G·C_in, side, side), w (G·64, C_in, 3, 3) at torch's default
    init scale, gy (M, G·64, side, side); channels_last activations."""
    hidden = CONV4["widths"]["hidden"]
    gen = torch.Generator(device=dev).manual_seed(seed)

    def nhwc(c):
        return torch.randn((M, side, side, G * c), generator=gen,
                           device=dev).permute(0, 3, 1, 2)
    w = torch.randn((G * hidden, cin, 3, 3), generator=gen, device=dev)
    return nhwc(cin), w / (9 * cin) ** 0.5, nhwc(hidden)


def _conv_passes(x, w, gy, G):
    return (kernels.conv3x3_fprop(x, w, G), kernels.conv3x3_dgrad(gy, w, G),
            kernels.conv3x3_wgrad(x, gy, G))


def _conv_launches():
    return [getattr(kernels, "conv3x3_" + k).launches for k in CONV_ENTRIES]


@pytest.mark.parametrize(
    "shape", CONV_SHAPES + ((25, 1, 3, 84), (25, 1, 64, 21), (7, 2, 8, 9)),
    ids=lambda s: f"M{s[0]}-G{s[1]}-C{s[2]}-{s[3]}x{s[3]}")
def test_conv3x3_matches_fp64_conv2d(cuda_device, shape):
    """conv4.train's eight call shapes (groups 4; block 0's dgrad too, which
    conv4 never launches), shared weights (groups 1) and a small odd one
    (8 channels, 64 of the 128-pixel tiles): each entry point within 1e-5
    of its output's largest value from fp64 F.conv2d and its autograd
    gradients (fp32 sums of 9·C_in products, the weight gradient's
    partials of a few thousand positions summed in fp64), in channels_last
    memory, one launch each, and the same bits on a second run."""
    M, G, cin, side = shape
    x, w, gy = _conv_inputs(cuda_device, M, G, cin, side, 1)
    before = _conv_launches()
    got = _conv_passes(x, w, gy, G)
    assert _conv_launches() == [n + 1 for n in before]
    x64, w64 = x.double().requires_grad_(), w.double().requires_grad_()
    y = torch.nn.functional.conv2d(x64, w64, padding=1, groups=G)
    want = (y,) + torch.autograd.grad(y, (x64, w64), gy.double())
    for name, a, b in zip(CONV_ENTRIES, got, want):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        if name != "wgrad":
            assert a.is_contiguous(memory_format=torch.channels_last), name
        gap = float((a.double() - b).abs().max()) / float(b.abs().max())
        assert gap <= 1e-5, (name, gap)
    for a, b in zip(got, _conv_passes(x, w, gy, G)):
        assert torch.equal(a, b)


def test_conv3x3_refuses_what_the_kernels_do_not_take(cuda_device):
    """bf16 and fp64 raise on the card (conv4 keeps F.conv2d there), as do
    channel counts the kernels do not take; an unaligned input is copied
    to an aligned one."""
    x, w, gy = _conv_inputs(cuda_device, 2, 1, 8, 6, 2)
    for dtype in (torch.bfloat16, torch.float64):
        with pytest.raises(TypeError):
            kernels.conv3x3_fprop(x.to(dtype), w.to(dtype))
    with pytest.raises(ValueError):
        kernels.conv3x3_fprop(x[:, :6], w[:, :6])
    base = torch.empty(x.numel() + 1, device=cuda_device)
    shifted = base[1:].view(2, 6, 6, 8).permute(0, 3, 1, 2)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16
    assert torch.equal(kernels.conv3x3_fprop(shifted, w),
                       kernels.conv3x3_fprop(x, w))


# (side, channels, ways, tasks, support and query images a task, inner
# steps, step size): a 20-pixel side so block 2 is odd, and conv4.train's
# episode (benchmark/configs/maml-conv4-inat-anim.json)
CONV4_STEPS = {
    "small": (20, 16, 3, 2, 6, 12, 3, 0.1),
    "conv4.train": (
        CONV4["widths"]["im_size"], CONV4["widths"]["hidden"],
        CONV4["episode"]["num_ways"], CONV4["train"]["batch_size"],
        CONV4["episode"]["num_ways"] * CONV4["episode"]["num_shots"],
        CONV4["episode"]["num_ways"] * CONV4["episode"]["num_query_train"],
        CONV4["train"]["inner_steps"], CONV4["train"]["step_size"]),
}


def _maml_conv4_step(cuda_device, shape, dtype=torch.float32):
    from fumi_tpu_torch.core.episode import Episode
    from fumi_tpu_torch.metalearn import inner_loop
    from fumi_tpu_torch.models import conv4
    side, hidden, ways, B, S, Q, n_steps, step_size = shape
    gen = torch.Generator().manual_seed(0)
    params = {k: v.to(cuda_device, dtype) for k, v in conv4.init(
        gen, im_size=side, hidden=hidden, n_way=ways).items()}
    x = torch.rand(B, S + Q, side, side, 3, generator=gen).to(cuda_device,
                                                              dtype)
    y = torch.arange(ways).repeat(B, (S + Q) // ways).to(cuda_device)
    episode = Episode(support_im=x[:, :S], support_text=None,
                      support_text_mask=None, support_ids=None,
                      support_y=y[:, :S], query_im=x[:, S:], query_ids=None,
                      query_y=y[:, S:])
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss, _ = inner_loop.maml_episode_loss(
        conv4.apply, leaves, episode, n_steps=n_steps, step_size=step_size,
        first_order=False)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def _leaf_gaps(got, want):
    """Each leaf's distance from ``want``'s over max(its norm, the median
    leaf's)."""
    norms = {k: float(v.norm()) for k, v in want.items()}
    median = float(np.median(list(norms.values())))
    return {k: float((got[k].double() - want[k].double()).norm())
            / max(norms[k], median) for k in want}


def test_conv4_step_runs_no_cudnn_convolution(cuda_device):
    """A conv4.train-shaped second-order MAML step: no aten convolution
    operator runs (so no cuDNN kernel), every device operation whose name
    ``benchmark/convs.py``'s ``PARTS`` finds is one of
    ``csrc/conv3x3.cu``'s, and each entry point launches as often as the
    CPU test counts its calls (tests/test_torch_conv3x3.py): 11n + 4
    fprop and wgrad, 9n + 3 dgrad for n inner steps."""
    from torch.profiler import ProfilerActivity, profile
    from benchmark.convs import PARTS
    shape = CONV4_STEPS["conv4.train"]
    n = shape[6]
    _maml_conv4_step(cuda_device, shape)
    before = _conv_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _maml_conv4_step(cuda_device, shape)
        torch.cuda.synchronize()
    assert [a - b for a, b in zip(_conv_launches(), before)] == [
        11 * n + 4, 9 * n + 3, 11 * n + 4]
    ops = {e.name for e in prof.events()}
    assert not ops & {"aten::convolution", "aten::_convolution",
                      "aten::cudnn_convolution", "aten::convolution_backward"}
    kernels_run = {k.name for e in prof.events() for k in e.kernels}
    convs = {k for k in kernels_run if any(p in k for p in PARTS)}
    assert convs and all("conv3x3_" in k for k in convs), convs
    for entry in CONV_ENTRIES:
        assert any(f"conv3x3_{entry}" in k for k in convs), entry


@pytest.mark.parametrize("shape", list(CONV4_STEPS))
def test_maml_conv4_second_order_step_matches_written_out(cuda_device,
                                                         monkeypatch, shape):
    """A second-order MAML step through Conv-4 through the port's ops (the
    convolutions' kernels and the norm op) against the same step through
    ``F.conv2d`` and the written-out chain on the card, deterministic
    cuDNN; the norm op launches 4 blocks x (n + 1 forwards, n inner and n + 1
    outer backwards, n double backwards) for n inner steps, 88 at
    conv4.train.

    Small (2 tasks, 3 inner steps, a 20-pixel side): the loss within 1e-5,
    each leaf of the meta-gradient within 1e-3 of max(its norm, the median
    leaf's). Both are fp32; the op's statistics are fp64 sums and its a
    one fma, the chain's fp32 reductions, so they part at the rounding
    level, and three second-order steps carry that into the gradient; the
    conv biases' gradients are the chain's rounding residual against the
    op's exact 0 (the output does not depend on them).

    conv4.train (4 tasks of 25 support and 160 query images of 84x84x3, 64
    channels, 5 inner steps): five second-order steps through batch-stat
    norms and max-pools over 1.1M values a channel carry any fp32
    evaluation several percent from the fp64 step (the max-pools' near
    ties; ``benchmark/drivers/train_inner.py``'s note), the written-out
    chain as much as the op. So both are held against the chain in fp64:
    the op's loss and its worst leaf no farther from it than twice the
    fp32 chain's."""
    from fumi_tpu_torch.models import conv4
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    n = CONV4_STEPS[shape][6]
    before = kernels.norm_relu_pool.launches
    loss, grads = _maml_conv4_step(cuda_device, CONV4_STEPS[shape])
    assert kernels.norm_relu_pool.launches == before + 4 * (
        (n + 1) + (2 * n + 1) + n)
    monkeypatch.setattr(conv4, "fused_norm_applies", lambda z, low: False)
    want_loss, want = _maml_conv4_step(cuda_device, CONV4_STEPS[shape])
    if shape == "small":
        assert abs(float(loss) - float(want_loss)) <= \
            1e-5 * abs(float(want_loss))
        for k, gap in _leaf_gaps(grads, want).items():
            assert gap <= 1e-3, (k, gap)
        return
    exact_loss, exact = _maml_conv4_step(cuda_device, CONV4_STEPS[shape],
                                         torch.float64)
    exact_loss = float(exact_loss)
    assert abs(float(loss) - exact_loss) <= \
        2 * abs(float(want_loss) - exact_loss)
    op, chain = _leaf_gaps(grads, exact), _leaf_gaps(want, exact)
    assert max(op.values()) <= 2 * max(chain.values()), (op, chain)


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-m", "cuda", "-q", "--noconftest",
                          "-p", "no:cacheprovider"]))
