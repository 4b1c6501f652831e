"""The Episode: one meta-batch of few-shot tasks, as tensors.

The counterpart of ``fumi_tpu/core/episode.py``. A meta-batch of ``B``
tasks, ``N`` ways, ``K`` support shots and ``Q`` query shots per class;
support and query are grouped class-major (targets ``[0]*K + [1]*K +
...``). Text rides with the support set only. Labels and ids are int32,
image embeddings fp32, as on the JAX side (the fused kernel takes int32
labels only).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch


class Episode(NamedTuple):
    """A meta-batch of few-shot episodes.

    - ``support_im``:   (B, N*K, D) fp32 image embeddings.
    - ``support_text``: (B, N*K, E) fp32 precomputed text embeddings, or
      (B, N*K, T) int32 token ids for a token text encoder.
    - ``support_text_mask``: always None on the samplers (kept so the
      fields match the JAX package's).
    - ``support_ids``:  (B, N*K) int32 raw image ids.
    - ``support_y``:    (B, N*K) int32 targets in 0..N-1.
    - ``query_im``:     (B, N*Q, D) fp32.
    - ``query_ids``:    (B, N*Q) int32.
    - ``query_y``:      (B, N*Q) int32.
    """

    support_im: torch.Tensor
    support_text: torch.Tensor
    support_text_mask: Optional[torch.Tensor]
    support_ids: torch.Tensor
    support_y: torch.Tensor
    query_im: torch.Tensor
    query_ids: torch.Tensor
    query_y: torch.Tensor

    @property
    def num_tasks(self) -> int:
        return self.support_im.shape[0]


def class_major_labels(batch_size: int, num_ways: int, per_class: int,
                       device: torch.device) -> torch.Tensor:
    """(B, N*per_class) int32 ``[0]*per_class + [1]*per_class + ...``."""
    y = torch.arange(num_ways, dtype=torch.int32, device=device)
    return y.repeat_interleave(per_class).unsqueeze(0).repeat(batch_size, 1)


@dataclasses.dataclass(frozen=True)
class EpisodeSpec:
    """Static episode geometry."""

    batch_size: int  # B: tasks per meta-batch
    num_ways: int  # N
    num_shots: int  # K: support shots per class
    num_query: int  # Q: query shots per class
    im_dim: int  # D
    text_dim: int  # E
    text_is_tokens: bool = False

    @property
    def support_len(self) -> int:
        return self.num_ways * self.num_shots

    @property
    def query_len(self) -> int:
        return self.num_ways * self.num_query

    def zeros(self, device) -> Episode:
        """An all-zeros episode with this geometry on ``device``."""
        B, NK, NQ = self.batch_size, self.support_len, self.query_len
        text_dtype = torch.int32 if self.text_is_tokens else torch.float32

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)
        return Episode(
            support_im=z(B, NK, self.im_dim),
            support_text=z(B, NK, self.text_dim, dtype=text_dtype),
            support_text_mask=None,
            support_ids=z(B, NK, dtype=torch.int32),
            support_y=class_major_labels(B, self.num_ways, self.num_shots,
                                         device),
            query_im=z(B, NQ, self.im_dim),
            query_ids=z(B, NQ, dtype=torch.int32),
            query_y=class_major_labels(B, self.num_ways, self.num_query,
                                       device),
        )
