"""FuMI — Fusion by Meta-Initialisation (text-conditioned hypernetwork).

The PyTorch counterpart of ``fumi_tpu/models/fumi.py``:

- ``hyper_net``: Linear(text_emb → text_hid)-ReLU-Linear(text_hid →
  im_hid[-1]+1), emitting the final-layer weights+bias of the image net
  per class; optional tanh (``norm_hypernet``) and the optional normc bias
  init of the head (``hypernet_bias_init``).
- ``im_net``: Linear-ReLU-(Dropout) hidden stack with NO final head; the
  head is generated per class by the hypernet. With ``im_encoder_kind``
  conv4 or resnet12 it is that raw-image backbone without its head
  (no dropout), and the generated head reads its features.

Parameters are a flat state dict with the reference's names:
``text_encoder.*``, ``im_net.linear{i}.*`` (a backbone's names under
``im_net.``), ``hyper_net.0.*`` and ``hyper_net.2.*``. ``compute_dtype``
is the bf16 policy of ``models/layers.py``. Every forward piece takes an optional leading batch of
episodes (the JAX package vmaps over it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from fumi_tpu_torch.models import (RAW_IMAGE_ENCODERS,
                                   headless_backbone_init, layers,
                                   raw_image_net, text_encoders)
from fumi_tpu_torch.utils.profiling import span

Params = Dict[str, torch.Tensor]


def im_net_names(n_layers: int):
    return [f"im_net.linear{i}" for i in range(n_layers)]


def im_net_depth(params: Params) -> int:
    """Number of ``im_net.linear{i}`` layers in a state dict."""
    n = 0
    while f"im_net.linear{n}.weight" in params:
        n += 1
    return n


@dataclasses.dataclass(frozen=True)
class FUMI:
    """Static model spec."""
    n_way: int
    im_emb_dim: int
    im_hid_dim: Tuple[int, ...]
    text_encoder: text_encoders.TextEncoder
    text_emb_dim: int
    text_hid_dim: int
    dropout_rate: float
    norm_hypernet: bool
    fine_tune: bool
    init_bias: bool
    init_all_layers: bool = False
    # "mlp" or a raw-image backbone ("conv4", "resnet12")
    im_encoder_kind: str = "mlp"
    im_size: int = 84
    im_channels: int = 3
    resnet12_channels: Tuple[int, ...] = (64, 160, 320, 640)
    compute_dtype: Optional[torch.dtype] = None
    # resnet12's per-stage checkpoint pattern (the experiment switch
    # resnet12.STAGE_REMAT_OVERRIDE); None in production
    stage_remat: Optional[Tuple[bool, ...]] = None

    @property
    def raw(self) -> bool:
        return self.im_encoder_kind in RAW_IMAGE_ENCODERS

    @property
    def head_in_dim(self) -> int:
        """Feature dim the generated head consumes."""
        if self.im_encoder_kind == "conv4":
            return raw_image_net("conv4").feature_dim(self.im_size)
        if self.im_encoder_kind == "resnet12":
            return self.resnet12_channels[-1]
        return self.im_hid_dim[-1]

    def init_params(self, gen: torch.Generator) -> Params:
        if self.init_all_layers:
            raise NotImplementedError(
                "Entire model hypernet initialisation removed")
        head_out = self.head_in_dim + 1  # weights + bias
        params = dict(self.text_encoder.params)
        if self.raw:
            params.update(headless_backbone_init(
                self.im_encoder_kind, gen, self.im_size, self.im_channels,
                self.resnet12_channels, prefix="im_net.")[0])
        else:
            in_dim = self.im_emb_dim
            for name, hid in zip(im_net_names(len(self.im_hid_dim)),
                                 self.im_hid_dim):
                params[name + ".weight"], params[name + ".bias"] = \
                    layers.linear_init(gen, in_dim, hid)
                in_dim = hid
        params["hyper_net.0.weight"], params["hyper_net.0.bias"] = \
            layers.linear_init(gen, self.text_emb_dim, self.text_hid_dim)
        w, b = layers.linear_init(gen, self.text_hid_dim, head_out)
        if self.init_bias:
            # zero head weight; normc bias with ReLU gain
            w = torch.zeros_like(w)
            b = layers.normc_init(gen, (1, head_out),
                                  gain=math.sqrt(2.0)).reshape(-1)
        params["hyper_net.2.weight"], params["hyper_net.2.bias"] = w, b
        return params

    # -- forward pieces ---------------------------------------------------

    def hyper_forward(self, params: Params, text_embed: torch.Tensor
                      ) -> torch.Tensor:
        """Hypernetwork: (..., n_way, E) text -> (..., n_way, im_hid[-1]+1)."""
        h = torch.relu(layers.linear(params["hyper_net.0.weight"],
                                     params["hyper_net.0.bias"], text_embed,
                                     self.compute_dtype))
        out = layers.linear(params["hyper_net.2.weight"],
                            params["hyper_net.2.bias"], h,
                            self.compute_dtype)
        if self.norm_hypernet:
            out = torch.tanh(out)
        return out

    def class_text_encoding(self, params: Params, text: torch.Tensor,
                            targets: torch.Tensor,
                            gen: Optional[torch.Generator] = None
                            ) -> torch.Tensor:
        """Per-class text encoding = encoding of the FIRST support sample of
        each class.

        text: (..., NK, E) float embeddings or (..., NK, T) int tokens;
        targets: (..., NK) int class ids. Returns (..., n_way, E). The ``rand`` encoder draws its noise
        from ``gen`` (one generator per episode: callers with a batch of
        episodes call this once per episode)."""
        if self.text_encoder.kind == "rand":
            noise = layers.rand(text.shape[:-1] + (self.text_emb_dim,), gen)
            enc = (2.0 * noise - 1.0).to(text.device)
        else:
            enc_params = params
            if not self.fine_tune:
                enc_params = {k: v.detach() for k, v in params.items()
                              if k.startswith("text_encoder.")}
            enc = self.text_encoder.apply(enc_params, text)
        classes = torch.arange(self.n_way, device=targets.device)
        hits = (targets.unsqueeze(-2) == classes.unsqueeze(-1)).to(torch.int32)
        first_idx = torch.argmax(hits, dim=-1)  # (..., n_way); first True
        return torch.gather(
            enc, -2, first_idx.unsqueeze(-1).expand(
                first_idx.shape + (enc.shape[-1],)))

    def get_hyper_params(self, params: Params, text: torch.Tensor,
                         targets: torch.Tensor,
                         gen: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
        """(..., n_way, im_hid[-1]+1) generated head."""
        with span("hypernet"):
            class_enc = self.class_text_encoding(params, text, targets, gen)
            return self.hyper_forward(params, class_enc)

    def im_base(self, im_params: Params, x: torch.Tensor, *, train: bool,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Base image net without head: Linear-ReLU-(Dropout) stack, or the
        raw-image backbone (per-task statistics for per-task weights)."""
        if self.raw:
            kw = ({"stage_remat": self.stage_remat}
                  if self.im_encoder_kind == "resnet12" else {})
            return raw_image_net(self.im_encoder_kind).backbone(
                im_params, x, self.compute_dtype, prefix="im_net.", **kw)
        for name in im_net_names(len(self.im_hid_dim)):
            x = torch.relu(layers.linear(im_params[name + ".weight"],
                                         im_params[name + ".bias"], x,
                                         self.compute_dtype))
            x = layers.dropout(x, self.dropout_rate, train, gen)
        return x

    def im_forward(self, im_params: Params, hyper_params: torch.Tensor,
                   x: torch.Tensor, *, train: bool,
                   gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Base MLP then the per-class generated head: ``out @ Wᵀ + b`` with
        W = hyper[..., :-1] (n_way, hid) and b = hyper[..., -1]."""
        out = self.im_base(im_params, x, train=train, gen=gen)
        w = hyper_params[..., :-1]
        b = hyper_params[..., -1]
        return layers.matmul_f32acc(out, w.transpose(-1, -2),
                                    self.compute_dtype) + b.unsqueeze(-2)
