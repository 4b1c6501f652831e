"""Text-encoder plugins: the identity encoder of precomputed embeddings
(``BERT`` / ``precomputed``), word-embedding pooling (``glove`` / ``w2v``),
the biLSTM encoders (``RNN`` / ``RNNhid``) and the ``rand`` noise encoder.

The counterpart of ``fumi_tpu/models/text_encoders.py``:

- :func:`embedding_weights` is a copy of the JAX package's numpy function
  (OOV words uniform(−1, 1) from ``np.random.RandomState(seed)``, the PAD
  row zeroed, pretrained vectors where given), so the port's table is
  bitwise the JAX package's for the same dictionary.
- Word-embedding pooling: ``mean`` sums every position, the PAD positions
  included (zero rows while the table is frozen), and divides by the count
  of non-PAD tokens, so an all-PAD row is 0/0 = NaN as in the JAX package;
  ``max`` is unmasked.
- The biLSTM: T cell steps, each one batched matmul over both directions
  (the input projections of all steps are one matmul up front), the carry
  ``(h, c)`` frozen on PAD steps by ``torch.where``; the backward
  direction runs the same scan over the time-reversed sequence, where the
  pads lead. ``RNN`` concatenates the final ``h`` of both directions,
  ``RNNhid`` the final ``c``. cuDNN's ``nn.LSTM`` needs the lengths on the
  host to pack the sequences, a host sync every step; unpacked it cannot
  freeze the carry on pads.

Token encoders take ``(..., T)`` int tokens and return ``(..., out_dim)``.
Parameters keep the reference's ``state_dict`` names:
``text_encoder.embed.weight`` and
``text_encoder.rnn.{weight,bias}_{ih,hh}_l0[_reverse]`` (torch's layout,
gate order i, f, g, o).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from fumi_tpu_torch.core.config import TOKEN_TEXT_ENCODERS
from fumi_tpu_torch.models import layers

PAD_WORD = "<PAD>"  # standard-tokenisation pad token

EMBED = "text_encoder.embed.weight"
_RNN = "text_encoder.rnn."


# ---------------------------------------------------------------------------
# Embedding weights
# ---------------------------------------------------------------------------

def embedding_weights(dictionary: Mapping[str, int],
                      vectors: Optional[Mapping[str, np.ndarray]] = None,
                      embedding_dim: int = 300,
                      seed: int = 0) -> np.ndarray:
    """Build the (V, E) embedding matrix.

    - known words take their pretrained vector from ``vectors``;
    - OOV words are uniform(−1, 1);
    - the PAD row is zeroed.
    """
    rng = np.random.RandomState(seed)
    if vectors is not None and len(vectors) > 0:
        any_vec = next(iter(vectors.values()))
        embedding_dim = int(np.asarray(any_vec).shape[-1])
    weights = 2.0 * rng.rand(len(dictionary), embedding_dim) - 1.0
    for word, token in dictionary.items():
        if word == PAD_WORD or word == "PAD":
            weights[token, :] = 0.0
        elif vectors is not None and word in vectors:
            weights[token, :] = np.asarray(vectors[word])
    return weights.astype(np.float32)


def pad_id(dictionary: Mapping[str, int]) -> int:
    """The dictionary's PAD token id (``<PAD>``, else ``PAD``, else 0)."""
    return int(dictionary.get(PAD_WORD, dictionary.get("PAD", 0)))


# ---------------------------------------------------------------------------
# Word-embedding pooling encoder (glove / w2v)
# ---------------------------------------------------------------------------

def word_embedding_apply(embed: torch.Tensor, tokens: torch.Tensor,
                         padding_token: int,
                         pooling_strat: str = "mean") -> torch.Tensor:
    """(..., T) int tokens -> (..., E) pooled embedding."""
    emb = embed[tokens.long()]  # (..., T, E)
    if pooling_strat == "mean":
        seq_lens = (tokens != padding_token).sum(dim=-1, keepdim=True)
        return emb.sum(dim=-2) / seq_lens.to(emb.dtype)
    if pooling_strat == "max":
        return emb.max(dim=-2).values
    raise NameError(f"{pooling_strat} pooling strat not defined")


# ---------------------------------------------------------------------------
# LSTM
# ---------------------------------------------------------------------------

def _rnn_names(sfx: str):
    return [f"{_RNN}{w}_l0{sfx}" for w in ("weight_ih", "weight_hh",
                                            "bias_ih", "bias_hh")]


def lstm_init(gen: torch.Generator, input_dim: int, hidden_dim: int
              ) -> Dict[str, torch.Tensor]:
    """A bidirectional torch ``nn.LSTM``'s default init, every param
    U(−1/√H, 1/√H), drawn from ``gen`` on the CPU: ``weight_ih`` (4H, in),
    ``weight_hh`` (4H, H), biases (4H,), gate order (i, f, g, o)."""
    bound = 1.0 / math.sqrt(hidden_dim)
    params = {}
    for sfx in ("", "_reverse"):
        shapes = ((4 * hidden_dim, input_dim), (4 * hidden_dim, hidden_dim),
                  (4 * hidden_dim,), (4 * hidden_dim,))
        for name, shape in zip(_rnn_names(sfx), shapes):
            params[name] = (torch.rand(shape, generator=gen)
                            * (2 * bound) - bound)
    return params


def bilstm_final_states(params: Dict[str, torch.Tensor], emb: torch.Tensor,
                        mask: torch.Tensor):
    """``(h, c)``, each (2, M, H): the final states of the forward (index
    0) and backward (index 1) directions over (M, T, E) embedded tokens
    with an (M, T) validity mask.

    Padding is a suffix, so the backward direction scans the
    time-reversed sequence: the pads lead, the carry stays frozen until
    the first valid token, and the final carry is the backward state at
    position 0, as torch's packed sequence gives it."""
    M, T, _ = emb.shape
    fwd, bwd = (_rnn_names(s) for s in ("", "_reverse"))
    # both directions' input projections for every step, biases folded in
    x_proj = torch.stack([
        layers.linear(params[fwd[0]], params[fwd[2]] + params[fwd[3]], emb),
        layers.linear(params[bwd[0]], params[bwd[2]] + params[bwd[3]],
                      emb.flip(1))])  # (2, M, T, 4H)
    w_hh = torch.stack([params[fwd[1]], params[bwd[1]]]).transpose(1, 2)
    valid = torch.stack([mask, mask.flip(1)]).unsqueeze(-1)  # (2, M, T, 1)
    H = w_hh.shape[1]
    h = c = emb.new_zeros((2, M, H))
    for t in range(T):
        gates = torch.baddbmm(x_proj[:, :, t], h, w_hh)  # (2, M, 4H)
        act = torch.sigmoid(gates)
        i, f, o = act[..., :H], act[..., H:2 * H], act[..., 3 * H:]
        c_new = f * c + i * torch.tanh(gates[..., 2 * H:3 * H])
        h_new = o * torch.tanh(c_new)
        m = valid[:, :, t]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
    return h, c


def rnn_encoder_apply(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
                      padding_token: int, variant: str = "output"
                      ) -> torch.Tensor:
    """(..., T) tokens -> (..., 2H): the concatenated final ``h``
    (``variant="output"``, the reference's RNN) or ``c`` (``"hidden"``,
    its RnnHid) of both directions."""
    if variant not in ("output", "hidden"):
        raise NameError(f"unknown rnn variant {variant}")
    lead, T = tokens.shape[:-1], tokens.shape[-1]
    flat = tokens.reshape(-1, T)
    emb = params[EMBED][flat.long()]
    h, c = bilstm_final_states(params, emb, flat != padding_token)
    out = h if variant == "output" else c
    return torch.cat([out[0], out[1]], dim=-1).reshape(lead + (-1,))


# ---------------------------------------------------------------------------
# Encoder factory
# ---------------------------------------------------------------------------

class TextEncoder:
    """A text-encoder plugin: params + apply.

    ``apply(params, text) -> (..., out_dim)`` where ``text`` is either
    (..., T) int tokens or (..., E) precomputed float embeddings, by
    ``kind``. The ``rand`` encoder is handled by the model (FuMI and AM3
    draw its noise per episode), but it still carries an unused linear
    layer to match the reference's parameter inventory.
    """

    def __init__(self, kind: str, params: Dict[str, torch.Tensor],
                 apply_fn: Callable, out_dim: int, trainable: bool):
        self.kind = kind
        self.params = params
        self._apply = apply_fn
        self.out_dim = out_dim
        self.trainable = trainable  # --fine_tune

    def apply(self, params, text):
        return self._apply(params, text)


def make_text_encoder(kind: str, gen: torch.Generator, text_emb_dim: int,
                      dictionary: Optional[Mapping[str, int]] = None,
                      pooling_strat: str = "mean", fine_tune: bool = False
                      ) -> TextEncoder:
    """Build a text encoder. Pretrained vectors come from a
    ``dictionary.vectors`` attribute; without them the table is random
    (:func:`embedding_weights`). The LSTM's weights are drawn from
    ``gen``."""
    vectors = getattr(dictionary, "vectors", None)
    if kind in ("BERT", "precomputed"):
        return TextEncoder(kind, {}, lambda p, t: t, text_emb_dim,
                           trainable=False)
    if kind == "rand":
        w, b = layers.linear_init(gen, text_emb_dim, text_emb_dim)
        return TextEncoder(kind, {"text_encoder.weight": w,
                                  "text_encoder.bias": b},
                           lambda p, t: t, text_emb_dim, trainable=fine_tune)
    if kind not in TOKEN_TEXT_ENCODERS:
        raise NameError(f"{kind} not allowed as text encoder")
    if dictionary is None:
        raise ValueError(f"{kind} encoder needs a token dictionary")
    weights = torch.from_numpy(embedding_weights(dictionary, vectors))
    pad = pad_id(dictionary)
    if kind in ("glove", "w2v"):
        def apply_fn(p, t):
            return word_embedding_apply(p[EMBED], t, pad, pooling_strat)
        return TextEncoder(kind, {EMBED: weights}, apply_fn,
                           weights.shape[-1], trainable=fine_tune)
    # RNN / RNNhid: text_emb_dim is the whole encoding, half a direction
    params = {EMBED: weights,
              **lstm_init(gen, weights.shape[-1], text_emb_dim // 2)}
    variant = "output" if kind == "RNN" else "hidden"

    def rnn_fn(p, t):
        return rnn_encoder_apply(p, t, pad, variant)
    return TextEncoder(kind, params, rnn_fn, text_emb_dim,
                       trainable=fine_tune)
