"""Conv4, the standard few-shot raw-image backbone.

The PyTorch counterpart of ``fumi_tpu/models/conv4.py``: 4 blocks of
[Conv3×3(64) → batch-stat norm → ReLU → MaxPool2×2], flatten, linear head.
Normalization uses the current batch's statistics at train and at eval (no
running stats), written out as the JAX package writes it: ``F.batch_norm``
and cuDNN's norm are not used. On a card in fp32 a block's norm, ReLU and
pool are one op of the port's own (``ops/kernels.py:norm_relu_pool``,
``csrc/norm_relu_pool.cu``), the same function with hand-written kernels
for its forward, backward and double backward, and the convolution is the
port's fp32 implicit GEMM (``ops/kernels.py:conv3x3_fprop``,
``csrc/conv3x3.cu``), whose gradients of every order are its kernels too.

Parameters are flat state dict entries under a ``prefix`` (``""`` for
MAML's whole net, ``im_net.`` in FuMI, ``image_encoder.`` in AM3):
``{prefix}convs.{i}.weight`` (out, in, 3, 3; the JAX package stores HWIO),
``.bias``, ``.gamma`` and ``.beta``, and ``{prefix}head.weight`` /
``.bias``.

Images come in NHWC, as in the JAX package: ``(M, H, W, C)`` with shared
weights (statistics over all M images), or ``(B, M, H, W, C)`` with
per-task weights, a leading B on every leaf, where the JAX package
``vmap``s one task (statistics per task, over its own M images). Inside,
the B tasks are channel groups of one tensor ``(M, B·C, H, W)`` in
channels_last memory: each conv is one grouped convolution
(``groups=B``), and a channel's statistics over (M, H, W) are exactly
that task's. Features leave in NHWC order, so the head's columns match
the JAX package's ``reshape`` of its NHWC activations.

Under ``compute_dtype=torch.bfloat16`` the blocks keep their activations
in bf16 between the convolution, the norm and the pool, the norm takes
its one-pass E[x²]−E[x]² form in fp32, and features leave in fp32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from fumi_tpu_torch.models import layers
from fumi_tpu_torch.ops import kernels

Params = Dict[str, torch.Tensor]
EPS = 1e-5
# the pool is a reshape and a max, as the JAX package's default: a tied
# window splits its gradient evenly among the ties (``amax``), which
# second-order MAML differentiates through (``F.max_pool2d`` would send
# it all to one element)
POOL_IMPL = "reshape"
# Block rematerialization, an experiment switch (the JAX package's): when
# True, backbone() checkpoints each conv block
# (``torch.utils.checkpoint(use_reentrant=False)``), so the backward pass
# keeps only the block's input and recomputes its conv, norm, ReLU and
# pool, also inside a second-order inner step and nested in --tpu_remat
# on's step checkpoint. It trades compute for activation memory and
# computes the same values: the blocks draw no randomness, so there is no
# generator to replay (on CUDA the recompute can still change the order
# in which autograd sums a second-order gradient). Read at every call;
# skipped where grad mode is off.
BLOCK_REMAT = False
UNIT = ("weight", "bias", "gamma", "beta")


def conv_init(gen: torch.Generator, in_ch: int, out_ch: int, kh: int = 3,
              kw: int = 3) -> Params:
    """torch ``nn.Conv2d`` default init, U(−1/√fan_in, 1/√fan_in) for the
    kernel (out, in, kh, kw) and the bias, fan_in = in·kh·kw; the norm's
    gamma ones and beta zeros."""
    bound = 1.0 / math.sqrt(in_ch * kh * kw)

    def u(*shape):
        return (torch.rand(shape, generator=gen, dtype=torch.float32)
                * (2 * bound) - bound)
    return {"weight": u(out_ch, in_ch, kh, kw), "bias": u(out_ch),
            "gamma": torch.ones(out_ch), "beta": torch.zeros(out_ch)}


def is_low_precision(compute_dtype: Optional[torch.dtype]) -> bool:
    return compute_dtype is not None and compute_dtype != torch.float32


def to_groups(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """NHWC images (M, H, W, C) or (B, M, H, W, C) -> ``(y, B)`` with y the
    (M, B·C, H, W) channels_last view the convolutions take."""
    if x.dim() == 4:
        x = x.unsqueeze(0)
    B, M, H, W, C = x.shape
    y = x.permute(1, 2, 3, 0, 4).reshape(M, H, W, B * C)
    return y.permute(0, 3, 1, 2), B


def unit(params: Params, name: str, B: int) -> Params:
    """A conv+norm unit's leaves with the B tasks stacked on their first
    axis (a shared leaf is repeated for every task)."""
    out = {}
    for k in UNIT:
        t = params[f"{name}.{k}"]
        own = 4 if k == "weight" else 1
        if t.dim() == own:
            t = t.expand((B,) + tuple(t.shape))
        out[k] = t.reshape((-1,) + tuple(t.shape[2:]))
    return out


def batch_stat_norm(y: torch.Tensor, p: Params,
                    low_precision: bool) -> torch.Tensor:
    """+bias → per-channel batch-stat normalize over (M, H, W) → affine, on
    (M, G, H, W); fp32 out. fp32: the two-pass (x−mean)² variance. Low
    precision (``y`` bf16): one upcast, then E[x²]−E[x]² with fp32 sums,
    clamped at 0 against the subtraction's rounding. Shared by conv4's
    blocks and resnet12's units."""
    def chan(t):
        return t.reshape(1, -1, 1, 1)
    dims = (0, 2, 3)
    y = (y.to(torch.float32) if low_precision else y) + chan(p["bias"])
    mean = y.mean(dim=dims, keepdim=True)
    if low_precision:
        m2 = y.square().mean(dim=dims, keepdim=True)
        var = torch.clamp(m2 - mean.square(), min=0.0)
    else:
        var = (y - mean).square().mean(dim=dims, keepdim=True)
    y = (y - mean) * torch.rsqrt(var + EPS)
    return y * chan(p["gamma"]) + chan(p["beta"])


def maxpool2x2(y: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 VALID max-pool of (M, G, H, W) (an odd last row or
    column is dropped), as a reshape and ``amax`` over the NHWC view."""
    M, G, H, W = y.shape
    h2, w2 = H // 2, W // 2
    z = y.permute(0, 2, 3, 1)[:, :h2 * 2, :w2 * 2]
    z = z.reshape(M, h2, 2, w2, 2, G).amax(dim=(2, 4))
    return z.permute(0, 3, 1, 2)


def fused_norm_applies(z: torch.Tensor, low_precision: bool) -> bool:
    """Whether a block's norm, ReLU and pool run as the one CUDA op
    (:func:`~fumi_tpu_torch.ops.kernels.norm_relu_pool`): an fp32 conv
    output on a CUDA device. The CPU, fp64 and bf16 keep the written-out
    chain."""
    return (not low_precision and z.is_cuda
            and z.dtype == torch.float32)


def conv_kernel_applies(y: torch.Tensor, w: torch.Tensor, groups: int,
                        low_precision: bool) -> bool:
    """Whether a block's convolution runs as the port's kernels
    (:func:`~fumi_tpu_torch.ops.kernels.conv3x3_fprop`): where
    :func:`fused_norm_applies` holds of its fp32 input on a card, at
    channel counts the kernels take. The CPU, fp64 and bf16 keep
    ``F.conv2d``."""
    return fused_norm_applies(y, low_precision) and \
        kernels.conv3x3_supported(y.shape[1] // groups, w.shape[0] // groups)


def conv_block(p: Params, y: torch.Tensor,
               compute_dtype: Optional[torch.dtype] = None,
               groups: int = 1) -> torch.Tensor:
    """Conv3×3 (SAME) → batch-stat norm → ReLU → MaxPool2×2 on (M, G·C, H,
    W); ``p`` is a :func:`unit` of ``groups`` tasks. In fp32 on a card the
    convolution is the port's own kernels, forward and gradients
    (:func:`conv_kernel_applies`), and the norm, ReLU and pool one op with
    hand-written kernels for its forward, backward and double backward
    (:func:`fused_norm_applies`); elsewhere ``F.conv2d`` and the chain
    written out. Under bf16 the conv output, the normalized output and the
    pooled output are bf16."""
    low = is_low_precision(compute_dtype)
    if conv_kernel_applies(y, p["weight"], groups, low):
        z = kernels.conv3x3_fprop(y, p["weight"], groups)
    else:
        z = layers.conv2d_f32acc(y, p["weight"], compute_dtype, padding=1,
                                 groups=groups, keep_dtype=low)
    if fused_norm_applies(z, low):
        return kernels.norm_relu_pool(z, p["bias"], p["gamma"], p["beta"])
    z = torch.relu(batch_stat_norm(z, p, low))
    if low:
        z = z.to(compute_dtype)
    return maxpool2x2(z)


def feature_dim(im_size: int, hidden: int = 64, blocks: int = 4) -> int:
    """Flattened feature size after ``blocks`` stride-2 pools."""
    s = im_size
    for _ in range(blocks):
        s = s // 2
    return s * s * hidden


def init(gen: torch.Generator, im_size: int = 84, in_channels: int = 3,
         hidden: int = 64, n_way: int = 5, blocks: int = 4) -> Params:
    """``blocks`` conv blocks and a linear head to ``n_way`` logits."""
    if feature_dim(im_size, hidden, blocks) <= 0:
        raise ValueError(
            f"im_size={im_size} collapses to zero spatial extent after "
            f"{blocks} 2x2 pools; need im_size >= {2 ** blocks}")
    params = {}
    ch = in_channels
    for i in range(blocks):
        for k, v in conv_init(gen, ch, hidden).items():
            params[f"convs.{i}.{k}"] = v
        ch = hidden
    params["head.weight"], params["head.bias"] = layers.linear_init(
        gen, feature_dim(im_size, hidden, blocks), n_way)
    return params


def num_blocks(params: Params, prefix: str = "") -> int:
    n = 0
    while f"{prefix}convs.{n}.weight" in params:
        n += 1
    return n


def from_groups(y: torch.Tensor, B: int, batched: bool) -> torch.Tensor:
    """(M, B·C, h, w) -> NHWC-flattened features (B, M, h·w·C), or (M,
    h·w·C) for a 4-D input; fp32 (fp64 stays fp64)."""
    M, G, h, w = y.shape
    f = y.reshape(M, B, G // B, h, w).permute(1, 0, 3, 4, 2)
    f = f.reshape(B, M, -1)
    f = f.to(torch.promote_types(f.dtype, torch.float32))
    return f if batched else f[0]


def backbone(params: Params, x: torch.Tensor,
             compute_dtype: Optional[torch.dtype] = None,
             prefix: str = "") -> torch.Tensor:
    """NHWC images (M, H, W, C) or (B, M, H, W, C) -> flat fp32 features
    (M, F) or (B, M, F)."""
    y, B = to_groups(x)
    remat = BLOCK_REMAT and torch.is_grad_enabled()
    for i in range(num_blocks(params, prefix)):
        p = unit(params, f"{prefix}convs.{i}", B)
        if remat:
            y = checkpoint(conv_block, p, y, compute_dtype, B,
                           use_reentrant=False)
        else:
            y = conv_block(p, y, compute_dtype, groups=B)
    return from_groups(y, B, x.dim() == 5)


def apply(params: Params, x: torch.Tensor,
          compute_dtype: Optional[torch.dtype] = None,
          prefix: str = "") -> torch.Tensor:
    """Images -> (…, M, n_way) logits; MAML adapts it end to end."""
    return layers.linear(params[prefix + "head.weight"],
                         params[prefix + "head.bias"],
                         backbone(params, x, compute_dtype, prefix),
                         compute_dtype)
