"""Card-only tests of the port's CUDA kernels (they skip without a GPU).

This file imports no JAX, so it also runs on a machine without it:

    python tests/test_torch_cuda.py

which runs pytest on this file without ``tests/conftest.py`` (that file
sets JAX up for the CPU tests). ``chip_smoke.py`` checks the same kernels
at full width.
"""

import os
import sys

import numpy as np
import pytest
import torch

if __name__ == "__main__":  # run as a script: import the port from this checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from fumi_tpu_torch.core.config import Config
from fumi_tpu_torch.models import mlp
from fumi_tpu_torch.ops import kernels
from fumi_tpu_torch.serve import FewShotClassifier

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


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-m", "cuda", "-q", "--noconftest",
                          "-p", "no:cacheprovider"]))
