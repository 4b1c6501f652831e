"""What the plain references share: weights from the seed, the precision
switch, the recorded dropout noise, and three steps of Adam.

Plain PyTorch only: nothing here imports the program, JAX or the JAX
package.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, List, Tuple

import torch

Params = Dict[str, torch.Tensor]
# (name, shape, init): init is a float b for U(-b, b), or "ones"/"zeros"
Spec = Tuple[str, Tuple[int, ...], object]


def torch_linear_bound(fan_in: int) -> float:
    """torch.nn.Linear's and nn.Conv2d's default bound 1/sqrt(fan_in)."""
    return 1.0 / math.sqrt(fan_in)


def init_params(specs: Iterable[Spec], seed: int, device) -> Params:
    """Every leaf of ``specs`` from one draw of U(-1, 1) on ``device``,
    each slice scaled to its bound; constants where the spec says so."""
    specs = list(specs)
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 2654435761 + 97) % (1 << 63))
    drawn = [s for s in specs if not isinstance(s[2], str)]
    total = sum(math.prod(shape) for _, shape, _ in drawn)
    flat = torch.rand((total,), generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, shape, init in specs:
        if init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            n = math.prod(shape)
            out[name] = (flat[at:at + n] * float(init)).reshape(shape)
            at += n
    return out


@contextlib.contextmanager
def precision(tf32: bool):
    """fp32 products in IEEE fp32 (``tf32=False``) or in TF32, the control's
    lower precision; the process-wide flags are restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class Noise:
    """The uniform noise a training step drew, in the order it drew it.
    ``take(shape)`` hands out the next draw of that shape; draws of other
    shapes (the sampler's) are passed over. Raises ``LookupError`` where
    the step drew no such noise."""

    def __init__(self, draws: List[torch.Tensor]):
        self.draws = list(draws)
        self.at = 0

    def take(self, shape) -> torch.Tensor:
        shape = tuple(shape)
        while self.at < len(self.draws):
            d = self.draws[self.at]
            self.at += 1
            if tuple(d.shape) == shape:
                return d
        raise LookupError(f"the step drew no more noise of shape {shape}")


def dropout(x: torch.Tensor, rate: float, noise: Noise) -> torch.Tensor:
    """Inverted dropout on the recorded noise: kept where u < 1 - rate,
    scaled by 1 / (1 - rate)."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    u = noise.take(x.shape).to(x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def follow(family, params0: Params, episodes: List[dict],
           noises: List[Noise], train: dict) -> dict:
    """Three (``len(episodes)``) meta-training steps of ``family`` from
    ``params0`` with torch.optim.Adam (coupled L2, as the configuration
    states). Returns each step's loss, the first step's gradient as the
    optimizer takes it (with ``weight_decay * params``) and without the
    decay, and each leaf's change after the last step."""
    wd = float(train["weight_decay"])
    p = {k: v.detach().clone().requires_grad_() for k, v in params0.items()}
    opt = torch.optim.Adam(list(p.values()), lr=float(train["lr"]),
                           betas=tuple(train["adam_betas"]),
                           eps=float(train["adam_eps"]), weight_decay=wd)
    losses, grad1, raw1 = [], None, None
    for episode, noise in zip(episodes, noises):
        loss, grads = family.loss_and_grads(p, episode, noise, train)
        if raw1 is None:
            raw1 = {k: g.detach().clone() for k, g in grads.items()}
            grad1 = {k: raw1[k] + wd * p[k].detach() for k in p}
        for k, t in p.items():
            t.grad = grads[k].detach()
        opt.step()
        losses.append(float(loss))
    delta = {k: p[k].detach() - params0[k] for k in p}
    return {"losses": losses, "grad1": grad1, "raw1": raw1, "delta": delta}


def cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-task mean cross-entropy of (B, M, N) logits: (B,)."""
    B, M, N = logits.shape
    return torch.nn.functional.cross_entropy(
        logits.reshape(B * M, N), y.reshape(-1).long(),
        reduction="none").reshape(B, M).mean(dim=1)
