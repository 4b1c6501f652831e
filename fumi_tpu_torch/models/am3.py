"""AM3, the Adaptive Modality Mixture Mechanism (prototypical, no inner
loop).

The PyTorch counterpart of ``fumi_tpu/models/am3.py``:

- ``image_encoder``: Linear(im_emb_dim → prototype_dim) (the reference's
  ``precomputed`` and ``resnet`` branches), or with ``im_encoder_kind``
  conv4 or resnet12 that raw-image backbone and a ``head`` Linear to
  prototype_dim;
- a text encoder plugin (identity for BERT/precomputed, word-embedding
  pooling or a biLSTM over tokens, or the ``rand`` encoder's fresh
  ``2·U(0,1)−1`` noise at every forward);
- ``g``: text → prototype space, Linear-ReLU-Dropout-Linear;
- ``h``: text prototype → λ, Linear-ReLU-Dropout-Linear and a sigmoid.

Parameters are a flat state dict with the reference's names:
``image_encoder.*`` (a backbone's names and its ``head`` under
``image_encoder.``), ``text_encoder.*``, ``g.0.*``, ``g.3.*``, ``h.0.*``
and ``h.3.*``. ``compute_dtype`` is the bf16 policy of
``models/layers.py``; the prototype and distance math stays fp32. Random
draws (the ``rand`` noise, then the dropout masks
of ``g`` and ``h``) come from one ``torch.Generator`` in that order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from fumi_tpu_torch.models import (RAW_IMAGE_ENCODERS,
                                   headless_backbone_init, layers,
                                   raw_image_net, text_encoders)
from fumi_tpu_torch.ops import fewshot

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AM3:
    """Static model spec."""
    im_emb_dim: int
    prototype_dim: int
    text_encoder: text_encoders.TextEncoder
    text_emb_dim: int
    text_hid_dim: int
    dropout: float
    fine_tune: bool
    lamda_fixed: Optional[int]
    # "linear" or a raw-image backbone ("conv4", "resnet12")
    im_encoder_kind: str = "linear"
    im_size: int = 84
    im_channels: int = 3
    resnet12_channels: Tuple[int, ...] = (64, 160, 320, 640)
    compute_dtype: Optional[torch.dtype] = None

    @property
    def raw(self) -> bool:
        return self.im_encoder_kind in RAW_IMAGE_ENCODERS

    def init_params(self, gen: torch.Generator) -> Params:
        params = dict(self.text_encoder.params)
        image_encoder = (self.im_emb_dim, self.prototype_dim)
        if self.raw:
            bb, fdim = headless_backbone_init(
                self.im_encoder_kind, gen, self.im_size, self.im_channels,
                self.resnet12_channels, prefix="image_encoder.")
            params.update(bb)
            image_encoder = (fdim, self.prototype_dim)
        for name, (i, o) in (
                ("image_encoder.head" if self.raw else "image_encoder",
                 image_encoder),
                ("g.0", (self.text_emb_dim, self.text_hid_dim)),
                ("g.3", (self.text_hid_dim, self.prototype_dim)),
                ("h.0", (self.prototype_dim, self.text_hid_dim)),
                ("h.3", (self.text_hid_dim, 1))):
            params[name + ".weight"], params[name + ".bias"] = \
                layers.linear_init(gen, i, o)
        return params

    # -- forward --------------------------------------------------------

    def encode_image(self, params: Params, im: torch.Tensor) -> torch.Tensor:
        """(..., im_emb_dim) -> (..., prototype_dim); raw (B, M, H, W, C) ->
        (B, M, prototype_dim), normalized with the statistics of all B·M
        images, as the JAX package reshapes them."""
        cd = self.compute_dtype
        if self.raw:
            B, M = im.shape[:2]
            feats = raw_image_net(self.im_encoder_kind).backbone(
                params, im.reshape((B * M,) + im.shape[2:]), cd,
                prefix="image_encoder.")
            return layers.linear(params["image_encoder.head.weight"],
                                 params["image_encoder.head.bias"], feats,
                                 cd).reshape(B, M, -1)
        return layers.linear(params["image_encoder.weight"],
                             params["image_encoder.bias"], im, cd)

    def _mlp(self, params: Params, name: str, x: torch.Tensor, train: bool,
             gen: Optional[torch.Generator]) -> torch.Tensor:
        """``name``'s Linear-ReLU-Dropout-Linear."""
        h = torch.relu(layers.linear(params[name + ".0.weight"],
                                     params[name + ".0.bias"], x,
                                     self.compute_dtype))
        h = layers.dropout(h, self.dropout, train, gen)
        return layers.linear(params[name + ".3.weight"],
                             params[name + ".3.bias"], h,
                             self.compute_dtype)

    def forward(self, params: Params, text: torch.Tensor, im: torch.Tensor,
                gen: Optional[torch.Generator] = None, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The support forward pass.

        text: (B, NK, E) precomputed embeddings or (B, NK, T) int tokens;
        im: (B, NK, im_emb_dim).
        Returns ``(im_embeddings, text_embeddings, lamda)`` of shapes
        (B, NK, P), (B, NK, P) and (B, NK, 1)."""
        im_embeddings = self.encode_image(params, im)
        if self.text_encoder.kind == "rand":
            # noise drawn afresh at every forward
            noise = layers.rand(im.shape[:-1] + (self.prototype_dim,), gen)
            text_embeddings = (2.0 * noise - 1.0).to(im.device)
        else:
            enc_params = params
            if not self.fine_tune:
                enc_params = {k: v.detach() for k, v in params.items()
                              if k.startswith("text_encoder.")}
            enc = self.text_encoder.apply(enc_params, text)
            text_embeddings = self._mlp(params, "g", enc, train, gen)
        lamda = torch.sigmoid(self._mlp(params, "h", text_embeddings, train,
                                        gen))
        return im_embeddings, text_embeddings, lamda

    def fixed_lamda(self, lamda: torch.Tensor) -> torch.Tensor:
        """The ``--lamda_fixed`` 0/1 override, else ``lamda`` itself."""
        if self.lamda_fixed == 0:
            return torch.zeros_like(lamda)
        if self.lamda_fixed == 1:
            return torch.ones_like(lamda)
        return lamda

    # -- episode --------------------------------------------------------

    def episode_loss(self, params: Params, episode, num_ways: int,
                     gen: Optional[torch.Generator] = None,
                     train: bool = False):
        """One meta-batch: the support forward (image, text, λ), the
        queries' image embeddings, the ``--lamda_fixed`` override after the
        forward, the λ-fused prototypes and the prototypical cross-entropy
        of the queries. Returns ``(loss, aux)``, aux holding
        ``prototypes``, ``query_emb``, ``lamda`` and ``avg_lamda``."""
        im_emb, text_emb, lamda = self.forward(
            params, episode.support_text, episode.support_im, gen, train)
        query_emb = self.encode_image(params, episode.query_im)
        lamda = self.fixed_lamda(lamda)
        prototypes = fewshot.get_prototypes(im_emb, text_emb, lamda,
                                            episode.support_y, num_ways)
        loss = fewshot.prototypical_loss(prototypes, query_emb,
                                         episode.query_y)
        return loss, {"prototypes": prototypes, "query_emb": query_emb,
                      "lamda": lamda, "avg_lamda": lamda.mean()}
