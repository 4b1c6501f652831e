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

The mixed-precision policy of ``--tpu_compute_dtype bfloat16``
(``compute_dtype=torch.bfloat16``): only the operands of matrix products
and convolutions are rounded to bf16. Weights stay fp32 leaves, and so do
activations between layers, biases, losses and every inner-loop update.
A matrix product gives an fp32 result that is never rounded to bf16 (the
JAX package's ``preferred_element_type=float32``); :func:`matmul_f32acc`
says how each device gets it. A convolution gives a bf16 output, cast
back to fp32 unless ``keep_dtype`` (the conv backbones keep their
activations in bf16 between blocks). Gradients flow back through the
casts as the JAX casts' VJPs do: a cotangent reaching a bf16 operand is
rounded to bf16, then widened to fp32.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def linear_init(gen: torch.Generator, in_dim: int, out_dim: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch ``nn.Linear`` default init -> (weight (out, in), bias (out,))."""
    bound = 1.0 / math.sqrt(in_dim)

    def u(*shape):
        return (torch.rand(shape, generator=gen, dtype=torch.float32)
                * (2 * bound) - bound)
    return u(out_dim, in_dim), u(out_dim)


# set while a step of the 2-D engine runs (parallel/pjit_engine.py:
# mp_context): its row-parallel product, for a weight that holds only its
# input columns; None otherwise
ROW_PARALLEL = None


def linear(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = x @ Wᵀ + b with W shaped (out, in), or (R, out, in) per episode.
    ``compute_dtype`` rounds the product's operands (the policy above)."""
    if ROW_PARALLEL is not None and w.shape[-1] != x.shape[-1]:
        return ROW_PARALLEL(w, b, x, compute_dtype)
    return matmul_f32acc(x, w.transpose(-1, -2), compute_dtype) \
        + b.unsqueeze(-2)


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` and widened back to fp32."""
    return t.to(dtype).to(torch.float32)


class _CublasBf16Matmul(torch.autograd.Function):
    """``a @ b`` of fp32 tensors holding bf16 values, by cuBLAS's bf16 GEMM
    with an fp32 output (``out_dtype``); the backward is the emulation's
    own, written in differentiable operations, so second-order inner
    loops differentiate through it."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        if b16.dim() == 2:
            return torch.mm(a16.reshape(-1, a16.shape[-1]), b16,
                            out_dtype=torch.float32).reshape(
                a.shape[:-1] + b.shape[-1:])
        batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        a16 = a16.expand(batch + a.shape[-2:]).reshape((-1,) + a.shape[-2:])
        b16 = b16.expand(batch + b.shape[-2:]).reshape((-1,) + b.shape[-2:])
        return torch.bmm(a16, b16, out_dtype=torch.float32).reshape(
            batch + (a.shape[-2], b.shape[-1]))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = _sum_to(torch.matmul(g, b.transpose(-1, -2)), a.shape)
        gb = _sum_to(torch.matmul(a.transpose(-1, -2), g), b.shape)
        return _round(ga, torch.bfloat16), _round(gb, torch.bfloat16)


def _sum_to(g: torch.Tensor, shape) -> torch.Tensor:
    """A broadcast operand's gradient summed back to its shape."""
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


def matmul_f32acc(a: torch.Tensor, b: torch.Tensor,
                  compute_dtype: Optional[torch.dtype] = None
                  ) -> torch.Tensor:
    """``a @ b``; with ``compute_dtype`` bf16 operands and an fp32 result.

    Both devices compute the same function. The CPU rounds the operands
    to bf16 and multiplies them in fp32 (exact products of bf16 values,
    fp32 sums: the function itself, up to the order of the sums). A CUDA
    device runs cuBLAS's bf16 GEMM with an fp32 output
    (:class:`_CublasBf16Matmul`). Either way the backward rounds each
    operand's gradient to bf16, as the JAX casts' VJPs do."""
    if compute_dtype is None or compute_dtype == torch.float32:
        return torch.matmul(a, b)
    a, b = _round(a, compute_dtype), _round(b, compute_dtype)
    if a.is_cuda and compute_dtype == torch.bfloat16:
        return _CublasBf16Matmul.apply(a, b)
    return torch.matmul(a, b)


def conv2d_f32acc(x: torch.Tensor, w: torch.Tensor,
                  compute_dtype: Optional[torch.dtype] = None, *,
                  padding: int = 0, groups: int = 1,
                  keep_dtype: bool = False) -> torch.Tensor:
    """NCHW/OIHW stride-1 convolution under the policy above, shared by
    the conv4 and resnet12 backbones. With ``compute_dtype`` the operands
    and the output are bf16 (the convolution accumulates in fp32 inside),
    and the output is cast back to fp32 unless ``keep_dtype``."""
    if compute_dtype is None or compute_dtype == torch.float32:
        return F.conv2d(x, w, padding=padding, groups=groups)
    y = F.conv2d(x.to(compute_dtype), w.to(compute_dtype), padding=padding,
                 groups=groups)
    return y if keep_dtype else y.to(torch.float32)


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
