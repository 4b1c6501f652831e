"""ResNet-12, the heavy few-shot raw-image backbone.

The PyTorch counterpart of ``fumi_tpu/models/resnet12.py``: 4 residual
stages of 3×[conv3×3 → batch-stat norm → leaky-ReLU] with a 1×1 projected
shortcut and a 2×2 max-pool each, channels (64, 160, 320, 640), then the
global average pool (accumulated in fp32) to 640-wide features. The norm,
the pool, the layouts and the bf16 activation storage are conv4's
(``models/conv4.py``): NHWC images in, per-task weights as channel groups
of one grouped convolution, statistics per task.

In fp32 on a card the convolutions leave cuDNN, under conv4's rule
(``conv4.conv_kernel_applies``): each 3×3 unit runs the port's implicit
GEMM (``ops/kernels.py:conv3x3_fprop``, ``csrc/conv3x3.cu``), whose
gradients of every order are its kernels too, and the 1×1 shortcut is a
per-group GEMM (:func:`pointwise_conv`, cuBLAS with TF32 off), whose
gradients are autograd's GEMMs; under conv4's other rule
(``conv4.fused_norm_applies``) the norm and leaky ReLU of units c1 and c2
are one op (``ops/kernels.py:norm_leaky_relu``), and c3's norm, the
shortcut's, their sum, the leaky ReLU and the pool another
(``norm_residual_pool``): ``csrc/norm_relu_pool.cu``'s leaky forms, with
hand-written kernels for their forward, backward and double backward.
The CPU, fp64 and bf16 keep ``F.conv2d`` and the chain written out.

Parameters under a ``prefix``: ``{prefix}blocks.{i}.{c1,c2,c3,sc}.``
``weight`` (out, in, kh, kw), ``.bias``, ``.gamma``, ``.beta``, and
``{prefix}head.weight`` / ``.bias``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fumi_tpu_torch.models import conv4, layers
from fumi_tpu_torch.models.conv4 import (batch_stat_norm, conv_init,
                                         from_groups, is_low_precision,
                                         maxpool2x2, to_groups, unit)
from fumi_tpu_torch.ops import kernels

Params = Dict[str, torch.Tensor]
CHANNELS: Tuple[int, ...] = (64, 160, 320, 640)
LEAK = kernels.NORM_LEAK  # built into csrc/norm_relu_pool.cu's leaky forms
UNITS = ("c1", "c2", "c3", "sc")
# Stage-selective checkpointing, an experiment switch (the JAX package's):
# stage i of a True entry keeps only its input for the backward pass and
# recomputes the rest. It measured negative there against whole-step remat
# (4.0 against 4.4 episodes/s on its TPU); None in production.
# train/steps.py:resnet12_stage_remat hands it to MAML and FuMI when
# --tpu_remat is auto, in place of the step checkpointing.
STAGE_REMAT_OVERRIDE: Optional[Tuple[bool, ...]] = None


def pointwise_conv(y: torch.Tensor, w: torch.Tensor,
                   groups: int) -> torch.Tensor:
    """The 1×1 grouped convolution ``F.conv2d(y, w, groups=groups)`` as one
    batched GEMM of the groups: y (M, G·C_in, H, W), w (G·C_out, C_in, 1,
    1) -> (M, G·C_out, H, W) in channels_last memory, through the port's
    fp32 product (``layers.matmul_f32acc``)."""
    M, _, H, W = y.shape
    G, cin = groups, w.shape[1]
    cout = w.shape[0] // G
    x = y.permute(0, 2, 3, 1).reshape(M * H * W, G, cin).transpose(0, 1)
    z = layers.matmul_f32acc(x, w.reshape(G, cout, cin).transpose(1, 2))
    return z.transpose(0, 1).reshape(M, H, W, G * cout).permute(0, 3, 1, 2)


def _conv(y: torch.Tensor, w: torch.Tensor, compute_dtype, groups: int,
          low: bool) -> torch.Tensor:
    """A unit's convolution (SAME: padding 1 for 3×3, 0 for the 1×1
    shortcut): in fp32 on a card the port's 3×3 kernels or the 1×1 GEMM,
    elsewhere ``F.conv2d``."""
    if w.shape[-1] == 3 and conv4.conv_kernel_applies(y, w, groups, low):
        return kernels.conv3x3_fprop(y, w, groups)
    if w.shape[-1] == 1 and conv4.fused_norm_applies(y, low):
        return pointwise_conv(y, w, groups)
    return layers.conv2d_f32acc(y, w, compute_dtype,
                                padding=w.shape[-1] // 2, groups=groups,
                                keep_dtype=low)


def _norm(z: torch.Tensor, p: Params, compute_dtype, low: bool
          ) -> torch.Tensor:
    """A unit's batch-stat norm written out; bf16 out under the bf16
    policy."""
    z = batch_stat_norm(z, p, low)
    return z.to(compute_dtype) if low else z


def block_init(gen: torch.Generator, in_ch: int, out_ch: int) -> Params:
    """One stage: three 3×3 conv+norm units and the 1×1 projection."""
    out = {}
    for name, (i, k) in zip(UNITS, ((in_ch, 3), (out_ch, 3), (out_ch, 3),
                                    (in_ch, 1))):
        for leaf, v in conv_init(gen, i, out_ch, k, k).items():
            out[f"{name}.{leaf}"] = v
    return out


def res_block(params: Params, name: str, y: torch.Tensor, B: int,
              compute_dtype=None) -> torch.Tensor:
    """Stage ``name`` on (M, B·C, H, W): 3×[conv-norm(-leaky)] + projected
    shortcut → leaky → maxpool 2×2. Where ``conv4.fused_norm_applies``
    holds of a unit's conv output (fp32 on a card), the norms, the leaky
    ReLUs, the residual add and the pool are the two ops of
    ``csrc/norm_relu_pool.cu``; elsewhere they are written out."""
    low = is_low_precision(compute_dtype)

    def conv(u, t):
        p = unit(params, f"{name}.{u}", B)
        return _conv(t, p["weight"], compute_dtype, B, low), p

    def norm_leaky(z, p):
        if conv4.fused_norm_applies(z, low):
            return kernels.norm_leaky_relu(z, p["bias"], p["gamma"],
                                           p["beta"])
        return F.leaky_relu(_norm(z, p, compute_dtype, low), LEAK)

    z = norm_leaky(*conv("c1", y))
    z = norm_leaky(*conv("c2", z))
    (z, p), (zs, ps) = conv("c3", z), conv("sc", y)
    if conv4.fused_norm_applies(z, low):
        return kernels.norm_residual_pool(z, p["bias"], p["gamma"],
                                          p["beta"], zs, ps["bias"],
                                          ps["gamma"], ps["beta"])
    return maxpool2x2(F.leaky_relu(_norm(z, p, compute_dtype, low)
                                   + _norm(zs, ps, compute_dtype, low), LEAK))


def feature_dim(im_size: int = 84,
                channels: Tuple[int, ...] = CHANNELS) -> int:
    """The global average pool makes the feature width the last stage's."""
    if im_size < 2 ** len(channels):
        raise ValueError(
            f"im_size={im_size} collapses to zero spatial extent after "
            f"{len(channels)} 2x2 pools; need im_size >= "
            f"{2 ** len(channels)}")
    return channels[-1]


def init(gen: torch.Generator, im_size: int = 84, in_channels: int = 3,
         n_way: int = 5, channels: Tuple[int, ...] = CHANNELS) -> Params:
    """One stage per entry of ``channels`` and a linear head."""
    feature_dim(im_size, channels)
    params = {}
    ch = in_channels
    for i, out_ch in enumerate(channels):
        for k, v in block_init(gen, ch, out_ch).items():
            params[f"blocks.{i}.{k}"] = v
        ch = out_ch
    params["head.weight"], params["head.bias"] = layers.linear_init(
        gen, channels[-1], n_way)
    return params


def num_blocks(params: Params, prefix: str = "") -> int:
    n = 0
    while f"{prefix}blocks.{n}.c1.weight" in params:
        n += 1
    return n


def backbone(params: Params, x: torch.Tensor,
             compute_dtype: Optional[torch.dtype] = None,
             prefix: str = "",
             stage_remat: Optional[Tuple[bool, ...]] = None
             ) -> torch.Tensor:
    """NHWC images (M, H, W, C) or (B, M, H, W, C) -> globally pooled fp32
    features (M, channels[-1]) or (B, M, channels[-1]).

    ``stage_remat[i]`` checkpoints stage i
    (``torch.utils.checkpoint(use_reentrant=False)``): only its input is
    kept for the backward pass, which recomputes the stage's convolutions,
    norms and activations, also inside a second-order inner step. The
    values are the same with and without it."""
    y, B = to_groups(x)
    for i in range(num_blocks(params, prefix)):
        name = f"{prefix}blocks.{i}"
        if stage_remat is not None and i < len(stage_remat) and \
                stage_remat[i]:
            y = checkpoint(res_block, params, name, y, B, compute_dtype,
                           use_reentrant=False)
        else:
            y = res_block(params, name, y, B, compute_dtype)
    # (M, B·C), accumulated in fp32 (fp64 stays fp64)
    pooled = torch.mean(y, dim=(2, 3),
                        dtype=torch.promote_types(y.dtype, torch.float32))
    return from_groups(pooled[..., None, None], B, x.dim() == 5)


def apply(params: Params, x: torch.Tensor,
          compute_dtype: Optional[torch.dtype] = None,
          prefix: str = "",
          stage_remat: Optional[Tuple[bool, ...]] = None) -> torch.Tensor:
    """Images -> (…, M, n_way) logits; MAML adapts it end to end."""
    return layers.linear(params[prefix + "head.weight"],
                         params[prefix + "head.bias"],
                         backbone(params, x, compute_dtype, prefix,
                                  stage_remat),
                         compute_dtype)
