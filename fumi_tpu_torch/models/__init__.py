"""Models of the PyTorch port: pure functions over flat state dicts.

The raw-image backbones (``conv4``, ``resnet12``) share one contract:
``init``, ``apply``, ``backbone`` and ``feature_dim``, so every consumer
(the MAML engine, FuMI's and AM3's image encoders, ProtoNet, MatchingNet,
serving) dispatches through :func:`raw_image_net`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

RAW_IMAGE_ENCODERS = ("conv4", "resnet12")


def raw_image_net(kind: str):
    """The backbone module of ``--im_encoder kind``."""
    if kind == "conv4":
        from fumi_tpu_torch.models import conv4 as net
    elif kind == "resnet12":
        from fumi_tpu_torch.models import resnet12 as net
    else:
        raise NameError(f"{kind} is not a raw-image encoder "
                        f"(one of {RAW_IMAGE_ENCODERS})")
    return net


def headless_backbone_init(kind: str, gen: torch.Generator, im_size: int,
                           im_channels: int,
                           resnet12_channels: Optional[Sequence[int]] = None,
                           prefix: str = ""
                           ) -> Tuple[Dict[str, torch.Tensor], int]:
    """A raw backbone WITHOUT its classification head, its names under
    ``prefix``, for the consumers that attach their own head (FuMI's
    generated one, AM3's, ProtoNet's and MatchingNet's projections).
    Returns ``(params, feature_dim)``."""
    net = raw_image_net(kind)
    if kind == "resnet12" and resnet12_channels is not None:
        channels = tuple(resnet12_channels)
        params = net.init(gen, im_size, im_channels, n_way=1,
                          channels=channels)
        fdim = net.feature_dim(im_size, channels)
    else:
        params = net.init(gen, im_size, im_channels, n_way=1)
        fdim = net.feature_dim(im_size)
    return {prefix + k: v for k, v in params.items()
            if not k.startswith("head.")}, fdim
