"""PureImageNetwork — the MAML base model.

An MLP over precomputed image embeddings: ReLU hidden stack + linear head
to ``n_way`` logits. Parameters are a flat state dict with the reference's
names, ``net.lin_{i}.*`` for the hidden layers and ``net.lin_final.*``
for the head.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from fumi_tpu_torch.models import layers


def layer_names(params: Dict[str, torch.Tensor]) -> List[str]:
    """Layer prefixes in forward order: ``net.lin_0`` ... ``net.lin_final``."""
    n_hidden = 0
    while f"net.lin_{n_hidden}.weight" in params:
        n_hidden += 1
    return [f"net.lin_{i}" for i in range(n_hidden)] + ["net.lin_final"]


def init(gen: torch.Generator, im_embed_dim: int = 2048, n_way: int = 5,
         hidden_dims: Optional[Sequence[int]] = (256, 64)
         ) -> Dict[str, torch.Tensor]:
    """Params for the [im_embed_dim, *hidden_dims, n_way] linear stack."""
    dims = [im_embed_dim, *(hidden_dims or ()), n_way]
    stack = layers.mlp_init(gen, dims)
    names = [f"net.lin_{i}" for i in range(len(stack) - 1)] + [
        "net.lin_final"]
    params = {}
    for name, (w, b) in zip(names, stack):
        params[name + ".weight"] = w
        params[name + ".bias"] = b
    return params


def apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
          compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Forward: ReLU between layers, raw logits out; ``compute_dtype`` the
    operand dtype of the products (``layers.linear``)."""
    names = layer_names(params)
    for name in names[:-1]:
        x = torch.relu(layers.linear(params[name + ".weight"],
                                     params[name + ".bias"], x,
                                     compute_dtype))
    return layers.linear(params[names[-1] + ".weight"],
                         params[names[-1] + ".bias"], x, compute_dtype)
