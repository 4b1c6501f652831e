"""Parameter initializers and primitive layers.

Plain functions on tensors, the PyTorch counterpart of
``fumi_tpu/models/layers.py``. Parameters are flat state dicts keyed by the
reference's ``state_dict`` names (``fumi_tpu_torch/bridge.py``); a linear
layer is the pair ``<name>.weight`` (out, in) and ``<name>.bias`` (out,),
stored (out, in) as on the JAX side.

Every function takes an optional leading batch of per-episode weights: a
weight of shape (R, out, in) applies to an input of shape (R, M, in). That
batch dimension is how the port writes out what the JAX package does with
``vmap``.

Initializers reproduce torch's ``nn.Linear`` default (weight and bias
uniform in +-1/sqrt(fan_in)) from an explicit ``torch.Generator``. They
draw on the CPU, so a seed gives the same weights whatever the device.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch


def linear_init(gen: torch.Generator, in_dim: int, out_dim: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch ``nn.Linear`` default init -> (weight (out, in), bias (out,))."""
    bound = 1.0 / math.sqrt(in_dim)

    def u(*shape):
        return (torch.rand(shape, generator=gen, dtype=torch.float32)
                * (2 * bound) - bound)
    return u(out_dim, in_dim), u(out_dim)


def linear(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = x @ Wᵀ + b with W shaped (out, in), or (R, out, in) per episode."""
    return torch.matmul(x, w.transpose(-1, -2)) + b.unsqueeze(-2)


def matmul_f32acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in fp32 (the port has no bf16 policy yet: ROADMAP.md
    Queue 1, item 8)."""
    return torch.matmul(a, b)


def dropout(x: torch.Tensor, rate: float, train: bool,
            gen: torch.Generator = None) -> torch.Tensor:
    """Inverted dropout, torch semantics (identity in eval mode)."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = rand(x.shape, gen).to(x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def rand(shape, gen: torch.Generator = None) -> torch.Tensor:
    """Uniform [0, 1) fp32 noise drawn on the generator's own device (the
    CPU without one)."""
    return torch.rand(shape, generator=gen,
                      device=None if gen is None else gen.device)


def mlp_init(gen: torch.Generator, dims: Sequence[int]
             ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Linear layers for dims [d0, d1, ..., dn]."""
    return [linear_init(gen, dims[i], dims[i + 1])
            for i in range(len(dims) - 1)]


def normc_init(gen: torch.Generator, shape: Tuple[int, ...],
               gain: float = 1.0) -> torch.Tensor:
    """Column-normalized normal init: ``w ~ N(0,1); w *= gain /
    sqrt(sum(w², axis=1))``."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32)
    return w * gain / torch.sqrt(torch.sum(w * w, dim=1, keepdim=True))
