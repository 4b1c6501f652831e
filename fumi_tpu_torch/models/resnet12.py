"""ResNet-12, the heavy few-shot raw-image backbone.

The PyTorch counterpart of ``fumi_tpu/models/resnet12.py``: 4 residual
stages of 3×[conv3×3 → batch-stat norm → leaky-ReLU] with a 1×1 projected
shortcut and a 2×2 max-pool each, channels (64, 160, 320, 640), then the
global average pool (accumulated in fp32) to 640-wide features. The norm,
the pool, the layouts and the bf16 activation storage are conv4's
(``models/conv4.py``): NHWC images in, per-task weights as channel groups
of one grouped convolution, statistics per task.

Parameters under a ``prefix``: ``{prefix}blocks.{i}.{c1,c2,c3,sc}.``
``weight`` (out, in, kh, kw), ``.bias``, ``.gamma``, ``.beta``, and
``{prefix}head.weight`` / ``.bias``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fumi_tpu_torch.models import layers
from fumi_tpu_torch.models.conv4 import (batch_stat_norm, conv_init,
                                         from_groups, is_low_precision,
                                         maxpool2x2, to_groups, unit)

Params = Dict[str, torch.Tensor]
CHANNELS: Tuple[int, ...] = (64, 160, 320, 640)
LEAK = 0.1
UNITS = ("c1", "c2", "c3", "sc")
# Stage-selective checkpointing, an experiment switch (the JAX package's):
# stage i of a True entry keeps only its input for the backward pass and
# recomputes the rest. It measured negative there against whole-step remat
# (4.0 against 4.4 episodes/s on its TPU); None in production.
# train/steps.py:resnet12_stage_remat hands it to MAML and FuMI when
# --tpu_remat is auto, in place of the step checkpointing.
STAGE_REMAT_OVERRIDE: Optional[Tuple[bool, ...]] = None


def _conv_bn(p: Params, y: torch.Tensor, compute_dtype, groups: int
             ) -> torch.Tensor:
    """conv (SAME: padding 1 for 3×3, 0 for the 1×1 shortcut) → batch-stat
    norm; bf16 out under the bf16 policy."""
    low = is_low_precision(compute_dtype)
    z = layers.conv2d_f32acc(y, p["weight"], compute_dtype,
                             padding=p["weight"].shape[-1] // 2,
                             groups=groups, keep_dtype=low)
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
    shortcut → leaky → maxpool 2×2."""
    def cb(u, t):
        return _conv_bn(unit(params, f"{name}.{u}", B), t, compute_dtype, B)
    z = F.leaky_relu(cb("c1", y), LEAK)
    z = F.leaky_relu(cb("c2", z), LEAK)
    z = cb("c3", z)
    return maxpool2x2(F.leaky_relu(z + cb("sc", y), LEAK))


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
