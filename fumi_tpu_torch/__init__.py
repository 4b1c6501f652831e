"""fumi_tpu_torch — the PyTorch/CUDA port of fumi_tpu.

The port runs on an NVIDIA H100: plain tensor code is PyTorch, and each
kernel the JAX package wrote in Pallas for the TPU is a kernel written by
hand for Hopper (``csrc/``), built with ``nvcc`` at first use. Module names
follow the JAX package's. It imports neither JAX nor ``fumi_tpu``.

Ported so far: few-shot serving of MAML and FuMI on precomputed embeddings
(:class:`fumi_tpu_torch.serve.FewShotClassifier`) with the fused
test-time adaptation kernel (:mod:`fumi_tpu_torch.ops.kernels`).
"""
