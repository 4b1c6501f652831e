"""Text-encoder plugins: the identity encoder of precomputed embeddings
(``BERT`` / ``precomputed``) and the ``rand`` noise encoder.

The token encoders (glove/w2v word-embedding pooling and the biLSTMs) are
not ported yet: ROADMAP.md Queue 1, item 5.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from fumi_tpu_torch.core.config import TOKEN_TEXT_ENCODERS
from fumi_tpu_torch.models import layers


class TextEncoder:
    """A text-encoder plugin: params + apply.

    ``apply(params, text) -> (..., M, out_dim)`` over precomputed float
    embeddings. The ``rand`` encoder is handled by the model (FuMI draws
    its noise per episode), but it still carries an unused linear layer to
    match the reference's parameter inventory.
    """

    def __init__(self, kind: str, params: Dict[str, torch.Tensor],
                 apply_fn: Callable, out_dim: int, trainable: bool):
        self.kind = kind
        self.params = params
        self._apply = apply_fn
        self.out_dim = out_dim
        self.trainable = trainable

    def apply(self, params, text):
        return self._apply(params, text)


def make_text_encoder(kind: str, gen: torch.Generator, text_emb_dim: int,
                      fine_tune: bool = False) -> TextEncoder:
    if kind in ("BERT", "precomputed"):
        return TextEncoder(kind, {}, lambda p, t: t, text_emb_dim,
                           trainable=False)
    if kind == "rand":
        w, b = layers.linear_init(gen, text_emb_dim, text_emb_dim)
        return TextEncoder(kind, {"text_encoder.weight": w,
                                  "text_encoder.bias": b},
                           lambda p, t: t, text_emb_dim, trainable=fine_tune)
    if kind in TOKEN_TEXT_ENCODERS:
        raise NotImplementedError(
            f"text encoder {kind!r} is not ported yet (ROADMAP.md Queue 1, "
            "item 5: token text encoders)")
    raise NameError(f"{kind} not allowed as text encoder")
