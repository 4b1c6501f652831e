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


# (B, S, Qn, D, H1, H2, N, steps): odd sizes cover the ragged tile edges,
# S > 32 the chunked W1 update, H1 > 256 two layer-1 column tiles
SHAPES = [(3, 37, 50, 64, 32, 16, 5, 20),
          (2, 25, 100, 300, 264, 20, 7, 10),
          (1, 6, 3, 16, 8, 8, 3, 0)]


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_reference(cuda_device, shape):
    """fp32 on both sides; the summation order differs, hence 1e-4."""
    B, S, Qn, D, H1, H2, N, steps = shape
    gen = torch.Generator().manual_seed(sum(shape))
    p = {k: v.to(cuda_device)
         for k, v in mlp.init(gen, D, N, (H1, H2)).items()}
    rng = np.random.RandomState(0)

    def dev(a):
        return torch.from_numpy(a).to(cuda_device)
    sx = dev(rng.randn(B, S, D).astype(np.float32))
    qx = dev(rng.randn(B, Qn, D).astype(np.float32))
    sy = dev(rng.randint(0, N, (B, S)).astype(np.int32))
    head_w = dev(rng.randn(B, N, H2).astype(np.float32) * 0.3)
    head_b = dev(rng.randn(B, 1, N).astype(np.float32) * 0.3)
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


def test_kernel_result_per_task_independent_of_batch(cuda_device):
    """One block per task: a task's logits are bitwise the same whatever
    else is in the batch."""
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


# (B, S, Qn, D, H1, H2, N, steps): B=1 and B=3 spread one and three tasks
# over the card; odd sizes give ragged row slices; B=16 at the flagship
# widths keeps the private weight copies in device memory (they do not fit
# shared memory at the few blocks per task that are left)
BATCHED_SHAPES = [(1, 6, 3, 16, 8, 8, 3, 0), (3, 37, 50, 64, 32, 16, 5, 20),
                  (2, 25, 100, 300, 264, 20, 7, 10),
                  (4, 25, 100, 2048, 256, 64, 5, 10),
                  (16, 25, 100, 2048, 256, 64, 5, 3)]


@pytest.mark.parametrize("shape", BATCHED_SHAPES)
def test_batched_kernel_matches_reference(cuda_device, shape):
    """fp32 on both sides in other summation orders, as for fused_adapt:
    1e-4, the same argmax; and the per-task kernel agrees too."""
    B, S, Qn, D, H1, H2, N, steps = shape
    gen = torch.Generator().manual_seed(sum(shape))
    p = {k: v.to(cuda_device)
         for k, v in mlp.init(gen, D, N, (H1, H2)).items()}
    rng = np.random.RandomState(1)

    def dev(a):
        return torch.from_numpy(a).to(cuda_device)
    sx = dev(rng.randn(B, S, D).astype(np.float32))
    qx = dev(rng.randn(B, Qn, D).astype(np.float32))
    sy = dev(rng.randint(0, N, (B, S)).astype(np.int32))
    before = kernels.fused_maml_adapt_batched.launches
    got = kernels.fused_maml_adapt_batched(p, sx, sy, qx, steps, 0.05)
    torch.cuda.synchronize()
    assert kernels.fused_maml_adapt_batched.launches == before + 1
    want = kernels.fused_maml_adapt_batched_reference(p, sx, sy, qx, steps,
                                                      0.05)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    per_task = kernels.fused_maml_adapt(p, sx, sy, qx, steps, 0.05)
    np.testing.assert_allclose(got.cpu().numpy(), per_task.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


def test_batched_kernel_raises_where_shared_memory_does_not_fit(cuda_device):
    """S x H1 activations of 32 x 2048 fp32 (256 KB) exceed a block's
    227 KB of shared memory at any number of blocks per task."""
    gen = torch.Generator().manual_seed(0)
    p = {k: v.to(cuda_device)
         for k, v in mlp.init(gen, 64, 3, (2048, 16)).items()}
    sx = torch.randn(1, 32, 64, device=cuda_device)
    sy = torch.zeros(1, 32, dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match="shared memory"):
        kernels.fused_maml_adapt_batched(p, sx, sy, sx, 1, 0.05)


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


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-m", "cuda", "-q", "--noconftest",
                          "-p", "no:cacheprovider"]))
