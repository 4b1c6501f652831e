"""The inner-loop SGD update.

Only what serving reads is ported: the plain update ``θ' = θ − α·∇ℓ``
over a state dict. The masked (ANIL) form and the episode losses with an
outer graph are ROADMAP.md Queue 1, items 3 and 6.
"""

from __future__ import annotations

from typing import Dict

import torch


def sgd_inner_update(params: Dict[str, torch.Tensor],
                     grads: Dict[str, torch.Tensor],
                     step_size: float) -> Dict[str, torch.Tensor]:
    """θ' = θ − α·∇ℓ, leaf by leaf."""
    return {k: p - step_size * grads[k] for k, p in params.items()}
