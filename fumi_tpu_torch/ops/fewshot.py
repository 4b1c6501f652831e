"""Shared episodic math, the PyTorch counterpart of ``fumi_tpu/ops/fewshot.py``.

Class prototypes are a one-hot matmul (segment mean), query→prototype
logits use the matmul expansion ``2·e·p − ‖p‖²`` (the per-query ``‖e‖²``
cancels in softmax and argmax). All functions are batched over the task
axis ``b``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _one_hot_f(targets: torch.Tensor, num_classes: int,
               dtype=torch.float32) -> torch.Tensor:
    """(..., NK) int -> (..., NK, N) float one-hot (out-of-range ids give a
    zero row, as ``jax.nn.one_hot`` does)."""
    classes = torch.arange(num_classes, device=targets.device)
    return (targets.unsqueeze(-1) == classes).to(dtype)


def get_num_samples(targets: torch.Tensor, num_classes: int,
                    dtype=torch.float32) -> torch.Tensor:
    """Per-class sample counts (b, N)."""
    return _one_hot_f(targets, num_classes, dtype).sum(dim=-2)


def get_prototypes(im_embeddings: torch.Tensor,
                   text_embeddings: torch.Tensor,
                   lamdas: torch.Tensor,
                   targets: torch.Tensor,
                   num_classes: int) -> torch.Tensor:
    """λ-fused class prototypes (b, N, D): per-class means of the image and
    text embeddings and of λ, fused ``λ·im + (1−λ)·text``, with the
    ``max(count, 1)`` zero-division guard."""
    dtype = im_embeddings.dtype
    onehot = _one_hot_f(targets, num_classes, dtype)  # (b, NK, N)
    counts = onehot.sum(dim=-2).unsqueeze(-1).clamp_min(1.0)  # (b, N, 1)
    onehot_t = onehot.transpose(-1, -2)
    im_protos = torch.matmul(onehot_t, im_embeddings) / counts
    text_protos = torch.matmul(onehot_t, text_embeddings) / counts
    lam = torch.matmul(onehot_t, lamdas.to(dtype)) / counts
    return lam * im_protos + (1.0 - lam) * text_protos


def prototype_logits(prototypes: torch.Tensor,
                     embeddings: torch.Tensor) -> torch.Tensor:
    """(b, N, D), (b, M, D) -> (b, M, N) logits ``2·e·p − ‖p‖²``."""
    dots = torch.matmul(embeddings, prototypes.transpose(-1, -2))
    p_sq = (prototypes * prototypes).sum(dim=-1)
    return 2.0 * dots - p_sq.unsqueeze(-2)


def pairwise_sqdist(prototypes: torch.Tensor,
                    embeddings: torch.Tensor) -> torch.Tensor:
    """Exact squared Euclidean distances (b, M, N), direct difference form."""
    diff = embeddings.unsqueeze(-2) - prototypes.unsqueeze(-3)
    return (diff * diff).sum(dim=-1)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over every leading position (torch
    ``F.cross_entropy`` semantics on the last axis)."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.long().unsqueeze(-1))
    return nll.mean()


def prototypical_loss(prototypes: torch.Tensor, embeddings: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over negative squared-distance logits."""
    return cross_entropy(prototype_logits(prototypes, embeddings), targets)


def predict_classes(prototypes: torch.Tensor,
                    embeddings: torch.Tensor) -> torch.Tensor:
    """Per-query nearest-prototype class (b, M) int32."""
    return torch.argmax(prototype_logits(prototypes, embeddings),
                        dim=-1).to(torch.int32)


def matching_probs(support_emb: torch.Tensor, support_y: torch.Tensor,
                   query_emb: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Matching-Networks class probabilities (B, NQ, N): softmaxed cosine
    attention over the support samples, mixing their one-hot labels."""
    eps = 1e-8
    s = support_emb / (support_emb.norm(dim=-1, keepdim=True) + eps)
    q = query_emb / (query_emb.norm(dim=-1, keepdim=True) + eps)
    attn = torch.softmax(torch.einsum("bqp,bkp->bqk", q, s), dim=-1)
    onehot = _one_hot_f(support_y, num_classes, s.dtype)
    return torch.einsum("bqk,bkn->bqn", attn, onehot)
