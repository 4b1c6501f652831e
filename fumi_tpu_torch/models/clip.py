"""CLIP-style dual encoder with projection heads.

The PyTorch counterpart of ``fumi_tpu/models/clip.py``: two 2-layer MLP
projection heads (text and image) into a shared latent space; the forward
pass returns the full text × image cosine-similarity matrix. Training uses
the symmetric cross-entropy with arange labels; evaluation is
sliding-window retrieval (``train/clip_loop.py``).

Parameters are a flat state dict with the reference's names:
``text_fc.*``, ``text_fc2.*``, ``image_fc.*`` and ``image_fc2.*``.
``compute_dtype`` is the bf16 policy of ``models/layers.py`` (the
normalization stays fp32). Each embedding is
divided by its ``torch.linalg.norm``, as the JAX package divides by
``jnp.linalg.norm``: ``F.normalize`` clamps the norm at an eps and is
another function at small norms.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from fumi_tpu_torch.models import layers
from fumi_tpu_torch.ops.fewshot import cross_entropy

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class CLIP:
    """Static model spec."""
    text_input_dim: int
    image_input_dim: int
    latent_dim: int
    compute_dtype: Optional[torch.dtype] = None

    def init_params(self, gen: torch.Generator) -> Params:
        params = {}
        for name, (i, o) in (
                ("text_fc", (self.text_input_dim, self.latent_dim)),
                ("text_fc2", (self.latent_dim, self.latent_dim)),
                ("image_fc", (self.image_input_dim, self.latent_dim)),
                ("image_fc2", (self.latent_dim, self.latent_dim))):
            params[name + ".weight"], params[name + ".bias"] = \
                layers.linear_init(gen, i, o)
        return params

    def _head(self, params: Params, name: str, x: torch.Tensor
              ) -> torch.Tensor:
        """Linear, ReLU, Linear, then ``t / ‖t‖`` over the last axis."""
        cd = self.compute_dtype
        t = layers.linear(
            params[name + "_fc2.weight"], params[name + "_fc2.bias"],
            torch.relu(layers.linear(params[name + "_fc.weight"],
                                     params[name + "_fc.bias"], x, cd)), cd)
        return t / torch.linalg.norm(t, dim=-1, keepdim=True)

    def encode_text(self, params: Params, text: torch.Tensor) -> torch.Tensor:
        """(..., E_t) -> (..., latent) L2-normalised text embedding."""
        return self._head(params, "text", text)

    def encode_image(self, params: Params, image: torch.Tensor
                     ) -> torch.Tensor:
        """(..., E_i) -> (..., latent) L2-normalised image embedding."""
        return self._head(params, "image", image)

    def forward(self, params: Params, text: torch.Tensor,
                image: torch.Tensor) -> torch.Tensor:
        """(Nt, E_t), (Ni, E_i) -> (Nt, Ni) cosine-similarity matrix. One
        matmul over the shared normalised encoders; serving
        (``ClipRetrieval``) reuses exactly these."""
        t = self.encode_text(params, text)
        i = self.encode_image(params, image)
        return layers.matmul_f32acc(t, i.transpose(-1, -2),
                                    self.compute_dtype)

    def symmetric_ce_loss(self, params: Params, text: torch.Tensor,
                          image: torch.Tensor) -> torch.Tensor:
        """Symmetric cross-entropy on the similarity matrix with arange
        labels. Rows and columns must be class-deduped by the caller."""
        sim = self.forward(params, text, image)
        labels = torch.arange(sim.shape[0], device=sim.device)
        return (cross_entropy(sim, labels) + cross_entropy(sim.T, labels)) / 2

    def retrieval_scores(self, params: Params, text: torch.Tensor,
                         images: torch.Tensor) -> torch.Tensor:
        """Retrieval windows, all at once.

        text: (W, E_t), one text per window (the window's first item);
        images: (W, n_ways, E_i), the window's candidates. Returns (W,)
        fp32 1/0: whether image 0 scored highest for its window's text
        (the first of equal scores wins, as ``jnp.argmax`` picks it)."""
        t = self.encode_text(params, text)  # (W, L)
        i = self.encode_image(params, images)  # (W, n, L)
        sim = layers.matmul_f32acc(t.unsqueeze(-2), i.transpose(-1, -2),
                                   self.compute_dtype)
        return (torch.argmax(sim[:, 0], dim=-1) == 0).to(torch.float32)
