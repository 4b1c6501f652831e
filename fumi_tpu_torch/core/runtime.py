"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Where
CUDA is missing and the CPU was not asked for, they raise rather than
carry on quietly on the CPU. The port's fp32 is IEEE fp32, as the JAX
package's reference numbers are: resolving a CUDA device turns TF32 off
for cuBLAS's matrix products and cuDNN's convolutions (process-wide
flags; cuDNN's is on by default).

A rank of a multi-device world (``core/distributed.py``) makes its card
the current CUDA device before it resolves one, so ``resolve_device()``
on that rank is the rank's card.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None``/``"cuda"`` -> the current CUDA device; ``"cpu"`` -> CPU.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
