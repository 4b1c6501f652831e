"""fumi_tpu_torch — the PyTorch/CUDA port of fumi_tpu.

The port runs on an NVIDIA H100: plain tensor code is PyTorch, and each
kernel the JAX package wrote in Pallas for the TPU is a kernel written by
hand for Hopper (``csrc/``), built with ``nvcc`` at first use. Module names
follow the JAX package's. It imports neither JAX nor ``fumi_tpu``.

Ported so far, for MAML, FuMI, AM3, ProtoNet and MatchingNet on
precomputed embeddings: few-shot serving
(:class:`fumi_tpu_torch.serve.FewShotClassifier`, from a run dir too, and
over HTTP with ``python -m fumi_tpu_torch.serve_http``), meta-training and
eval on the device sampler (:mod:`fumi_tpu_torch.train.steps`), and the
experiment driver (``python -m fumi_tpu_torch.cli.main``), with every
kernel of the JAX package's ``ops/pallas_kernels.py`` written by hand for
the card (:mod:`fumi_tpu_torch.ops.kernels`).
"""
