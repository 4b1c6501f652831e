"""Card-only tests of the port's CUDA kernels (they skip without a GPU).

This file imports no JAX, so it also runs on a machine without it:

    python tests/test_torch_cuda.py

which runs pytest on this file without ``tests/conftest.py`` (that file
sets JAX up for the CPU tests). ``chip_smoke.py`` checks the same kernels
at full width.
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
# 16-block clusters; D=4096 puts the W1 slices in device memory; 0 steps
# is the forward alone
SHAPES = [(3, 37, 50, 64, 32, 16, 5, 20),
          (2, 25, 100, 300, 264, 20, 7, 10),
          (1, 6, 3, 16, 8, 8, 3, 0),
          (1, 25, 128, 2048, 256, 64, 5, 10),
          (4, 25, 100, 2048, 256, 64, 5, 10),
          (8, 25, 100, 2048, 256, 64, 5, 5),
          (16, 25, 100, 2048, 256, 64, 5, 3),
          (2, 25, 50, 4096, 256, 64, 5, 5),
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
    products in C partial sums and the plain version in cuBLAS's order,
    and the steps carry the difference forward, hence 1e-4."""
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
    """The card schedules the flagship's 16-block cluster with the W1
    slice in shared memory; the source's layout gives the plan's bytes;
    D=4096 moves the W1 slices to device memory."""
    optin, max_cluster = kernels.card_limits(torch.cuda.current_device())
    flagship = (4, 25, 100, 2048, 256, 64, 5)
    plan = kernels.fused_adapt_plan(flagship, optin, max_cluster)
    assert (plan.C, plan.cols, plan.w1) == (16, 128, "shared")
    assert kernels.active_clusters(torch.cuda.current_device(), plan.C,
                                   plan.smem_bytes) >= 4
    lib = kernels._library()
    for dims in (flagship, (3, 37, 50, 64, 32, 16, 5),
                 (2, 25, 100, 300, 264, 20, 7), (2, 25, 50, 4096, 256, 64, 5)):
        plan = kernels.fused_adapt_plan(dims, optin, max_cluster)
        B, S, Qn, D, H1, H2, N = dims
        assert lib.fused_adapt_smem_bytes(S, D, H1, H2, N, plan.C,
                                          int(plan.w1 == "shared")) \
            == plan.smem_bytes
    assert kernels.fused_adapt_plan((2, 25, 50, 4096, 256, 64, 5), optin,
                                    max_cluster).w1 == "device"


def test_kernel_refuses_a_plan_that_does_not_match(cuda_device):
    """The C side recomputes the layout and returns cudaErrorInvalidValue
    (1) for a plan whose bytes or columns are not its own."""
    p, sx, sy, qx, head_w, head_b = _inputs(cuda_device,
                                            (1, 6, 3, 16, 8, 8, 3, 1), 0)
    out = torch.empty(1, 3, 3, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (sx, sy, qx, p["net.lin_0.weight"],
                                   p["net.lin_0.bias"], p["net.lin_1.weight"],
                                   p["net.lin_1.bias"], head_w, head_b, out,
                                   out)]
    plan = kernels.fused_adapt_plan((1, 6, 3, 16, 8, 8, 3),
                                    *kernels.card_limits(
                                        torch.cuda.current_device()))
    lib = kernels._library()
    for C, cols, nbytes in ((plan.C, plan.cols, plan.smem_bytes + 16),
                            (plan.C, plan.cols + 1, plan.smem_bytes),
                            (17, 1, plan.smem_bytes)):
        assert lib.fused_adapt_launch(*ptrs, 24, 3, 1, 6, 3, 16, 8, 8, 3, C,
                                      cols, 1, nbytes, 1, 0.05, stream) == 1


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


@pytest.mark.parametrize("model", ["fumi", "maml"])
def test_served_kernel_matches_autograd_engine(cuda_device, model):
    cfg = Config(model=model, dataset="synthetic", im_emb_dim=128,
                 text_emb_dim=32, im_hid_dim=(64, 16), text_hid_dim=32,
                 num_ways=5, num_shots=3, num_test_adapt_steps=30,
                 step_size=0.05, dropout=0.0, text_encoder="precomputed",
                 seed=1)
    clf = FewShotClassifier(cfg)
    engine = FewShotClassifier(cfg, clf.params)
    engine._episode_fn = engine._build_episode_fn(force_engine=True)
    rng = np.random.RandomState(1)
    s_im = rng.randn(3, 15, 128).astype(np.float32)
    s_tx = rng.randn(3, 15, 32).astype(np.float32)
    s_y = np.tile(np.repeat(np.arange(5), 3), (3, 1)).astype(np.int32)
    q_im = rng.randn(3, 20, 128).astype(np.float32)
    before = kernels.fused_adapt.launches
    got = clf.episode_logits_batch(s_im, s_y, q_im, support_text=s_tx)
    assert kernels.fused_adapt.launches == before + 1
    want = engine.episode_logits_batch(s_im, s_y, q_im, support_text=s_tx)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


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
    """S x H1 activations of 32 x 2048 fp32 (256 KB) exceed a block's
    227 KB of shared memory at any cluster size."""
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
# a row); 70,000 rows in one launch
EPISODE_CASES = [(torch.float32, 4096, 2048, (4, 5, 5, 32)),
                 (torch.float32, 4096, 2048, (4, 5, 5, 20)),
                 (torch.bfloat16, 4096, 2048, (4, 5, 5, 32)),
                 (torch.uint8, 4096, 2048, (4, 5, 5, 20)),
                 (torch.float32, 300, 99, (2, 3, 1, 0)),
                 (torch.bfloat16, 300, 99, (2, 3, 0, 1)),
                 (torch.uint8, 300, 2050, (2, 5, 5, 20)),
                 (torch.float32, 300, 2050, (1, 5, 5, 32)),
                 (torch.float32, 70000, 4, (100, 20, 5, 30))]


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


def test_maml_fused_eval_runs_the_batched_kernel(cuda_device):
    cfg = Config(model="maml", dataset="synthetic", im_emb_dim=64,
                 text_emb_dim=16, im_hid_dim=(32, 16), num_ways=3,
                 num_shots=2, num_test_adapt_steps=10, batch_size=2,
                 step_size=0.1, dropout=0.0, text_encoder="precomputed",
                 pallas_fused_eval=True, seed=0)
    cs, table, ids = synthetic.synthetic_class_set(
        num_classes=10, images_per_class=40, im_dim=64, text_dim=16)
    smp = sampler.DeviceEpisodeSampler(
        table, ids, cs, EpisodeSpec(2, 3, 2, 33, 64, 16), device=cuda_device)
    st = steps.make_steps(cfg, torch.Generator().manual_seed(0),
                          device=cuda_device)
    counts = (kernels.fused_adapt.launches,
              kernels.fused_maml_adapt_batched.launches)
    _, m = steps.make_chunked_eval(st.family, smp)(st.params,
                                                  smp.generator(0), 3)
    assert (kernels.fused_adapt.launches,
            kernels.fused_maml_adapt_batched.launches) == (counts[0],
                                                          counts[1] + 3)
    assert torch.isfinite(m["loss"]).all()


@pytest.mark.parametrize("model", ["fumi", "maml"])
def test_train_step_on_card_matches_cpu(cuda_device, model):
    """One second-order train step from the same weights on the same
    episode, dropout 0: fp32 on both, summed in other orders, 1e-4. The
    SGD step keeps the gradient's own differences visible in the params."""
    cfg = Config(model=model, dataset="synthetic", im_emb_dim=64,
                 text_emb_dim=16, im_hid_dim=(32, 16), text_hid_dim=16,
                 num_ways=3, num_shots=2, num_shots_test=4, batch_size=2,
                 num_train_adapt_steps=3, step_size=0.1, dropout=0.0,
                 optim="SGD", lr=0.1, text_encoder="precomputed", seed=0)
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
    p_card, _, m_card = card.train_step(
        card.params, card.opt.init(card.params), episode, None)
    p_host, _, m_host = host.train_step(
        host.params, host.opt.init(host.params),
        Episode(*(None if t is None else t.cpu() for t in episode)), None)
    assert set(m_card) == set(m_host)
    for k in m_host:
        np.testing.assert_allclose(float(m_card[k]), float(m_host[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    for k in p_host:
        np.testing.assert_allclose(p_card[k].cpu().numpy(),
                                   p_host[k].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


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


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-m", "cuda", "-q", "--noconftest",
                          "-p", "no:cacheprovider"]))
