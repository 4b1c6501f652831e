"""Plain reference of MAML (Finn et al., arXiv:1703.03400) on ResNet-12 at
the few-shot literature's widths 64-160-320-640 (Lee et al., MetaOptNet,
arXiv:1904.03758; after Oreshkin et al., TADAM, arXiv:1805.10123).

The network is four stages, each three units of [3×3 convolution with
padding 1 → batch norm on the images' own statistics (mean and the biased
variance over images, height and width, eps 1e-5)], a leaky ReLU (slope
0.1) after the first two, a shortcut of [1×1 convolution → the same norm]
from the stage's input, the sum through a leaky ReLU and a 2×2 max-pool;
then the global average pool to the last stage's 640 features and a
linear head. Images come as (M, H, W, C) pixels widened to [0, 1].
Meta-training adapts every weight of a task's own copy of the network by
SGD on that task's support cross-entropy, second order, and steps the
outer loss (the query cross-entropy, mean over tasks) with Adam.

Where the network departs from the papers' ResNet-12, as the port builds
it:

- no DropBlock (MetaOptNet regularises its stages with it);
- every convolution has a bias (ahead of a norm, it moves only rounding);
- the norm takes the statistics of the task's own images at train and at
  eval alike (no running averages), as MAML's own networks do;
- the global average pool gives 640 features (MetaOptNet flattens its
  5×5×640 map for its SVM head; TADAM averages it);
- the pool splits a tied window's gradient evenly among the ties
  (``benchmark/reference/maml.py``'s note: uint8 pixels tie, and
  second-order MAML differentiates through the split).

Written with autograd and plain tensor operations, a loop over the tasks
with ``F.conv2d``, in the dtype of the weights it is given, with cuDNN off
(PyTorch's own unfold-and-GEMM convolutions, ``maml.py``'s reason) and
TF32 as the caller's ``precision`` sets it; it imports nothing of the
program. A task's second-order graph at 84×84 is larger than the card
holds beside the program's tables in fp64, so :func:`adapted` keeps each
inner step's inputs alone for the outer backward and builds the step
again there (``torch.utils.checkpoint``): the same values, less memory.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.common import Noise, Params, torch_linear_bound
from benchmark.reference.maml import EPS, plain_convolutions, pool

UNITS = ("c1", "c2", "c3", "sc")
LEAVES = ("weight", "bias", "gamma", "beta")
# the leaky ReLU's slope (the configuration's ``widths.leak``)
LEAK = 0.1


def specs(config: dict):
    """The leaves under the program's names: each stage's units' conv
    weights (out, in, k, k) and biases at ``nn.Conv2d``'s default bound
    (fan_in = in·k², so in for the 1×1 shortcut), the norm's gamma ones and
    beta zeros, the head at ``nn.Linear``'s."""
    w = config["widths"]
    if w["leak"] != LEAK:
        raise ValueError(f"the reference's leak is {LEAK}, the "
                         f"configuration's {w['leak']}")
    k, k_sc = w["kernel"], w["shortcut_kernel"]
    out, cin = [], w["im_channels"]
    for i, ch in enumerate(w["channels"]):
        for unit, (c, kk) in zip(UNITS, ((cin, k), (ch, k), (ch, k),
                                         (cin, k_sc))):
            b = torch_linear_bound(c * kk * kk)
            name = f"blocks.{i}.{unit}"
            out += [(name + ".weight", (ch, c, kk, kk), b),
                    (name + ".bias", (ch,), b),
                    (name + ".gamma", (ch,), "ones"),
                    (name + ".beta", (ch,), "zeros")]
        cin = ch
    b = torch_linear_bound(cin)
    out += [("head.weight", (w["num_ways"], cin), b),
            ("head.bias", (w["num_ways"],), b)]
    return out


def conv_norm(theta: Params, name: str, h: torch.Tensor) -> torch.Tensor:
    """A unit: convolution (SAME) → batch norm on (M, C, H, W)."""
    p = {k: theta[f"{name}.{k}"] for k in LEAVES}
    h = F.conv2d(h, p["weight"], p["bias"],
                 padding=p["weight"].shape[-1] // 2)
    mean = h.mean(dim=(0, 2, 3), keepdim=True)
    var = ((h - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    h = (h - mean) / torch.sqrt(var + EPS)
    return h * p["gamma"].reshape(1, -1, 1, 1) + p["beta"].reshape(
        1, -1, 1, 1)


def forward(theta: Params, x: torch.Tensor) -> torch.Tensor:
    """One task's weights on its (M, H, W, C) images -> (M, N) logits."""
    h = x.permute(0, 3, 1, 2)
    i = 0
    while f"blocks.{i}.c1.weight" in theta:
        name = f"blocks.{i}"
        z = F.leaky_relu(conv_norm(theta, name + ".c1", h), LEAK)
        z = F.leaky_relu(conv_norm(theta, name + ".c2", z), LEAK)
        z = conv_norm(theta, name + ".c3", z)
        h = pool(F.leaky_relu(z + conv_norm(theta, name + ".sc", h), LEAK))
        i += 1
    f = h.mean(dim=(2, 3))
    return f @ theta["head.weight"].T + theta["head.bias"]


def task_loss(theta: Params, x: torch.Tensor, y: torch.Tensor
              ) -> torch.Tensor:
    """Mean cross-entropy of one task's images."""
    with plain_convolutions():
        return F.cross_entropy(forward(theta, x), y.long())


def inner_step(theta: Params, x: torch.Tensor, y: torch.Tensor,
               step_size: float) -> Tuple[torch.Tensor, Dict[str,
                                                             torch.Tensor]]:
    """One inner step of one task from ``theta``: the support loss there
    and the update −α·∇ of every leaf."""
    with torch.enable_grad(), plain_convolutions():
        leaves = {k: v.detach().requires_grad_() for k, v in theta.items()}
        loss = task_loss(leaves, x, y)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), {k: -step_size * g
                           for k, g in zip(leaves, grads)}


def adapted(p: Params, x: torch.Tensor, y: torch.Tensor, steps: int,
            step_size: float) -> Params:
    """``steps`` SGD steps of one task from ``p``, second order; each step
    checkpointed (see the module's docstring)."""
    keys = list(p)

    def step(*vals):
        theta = dict(zip(keys, vals))
        grads = torch.autograd.grad(task_loss(theta, x, y), vals,
                                    create_graph=True)
        return tuple(v - step_size * g for v, g in zip(vals, grads))

    vals = tuple(p[k] for k in keys)
    for _ in range(steps):
        vals = checkpoint(step, *vals, use_reentrant=False)
    return dict(zip(keys, vals))


def loss_and_grads(p: Params, episode: dict, noise: Noise, train: dict):
    """One meta-training step's outer loss and its gradient with respect
    to every leaf of ``p``, a task at a time. ``episode``: support (B, S,
    H, W, C) and labels, query (B, Q, H, W, C) and labels. No noise: the
    network has no dropout."""
    B = episode["s_x"].shape[0]
    keys = list(p)
    total = None
    grads = {k: torch.zeros_like(p[k]) for k in keys}
    with torch.enable_grad(), plain_convolutions():
        for b in range(B):
            theta = adapted(p, episode["s_x"][b], episode["s_y"][b],
                            int(train["inner_steps"]),
                            float(train["step_size"]))
            outer = task_loss(theta, episode["q_x"][b],
                              episode["q_y"][b]) / B
            for k, g in zip(keys, torch.autograd.grad(
                    outer, [p[k] for k in keys])):
                grads[k] = grads[k] + g
            outer = outer.detach()
            total = outer if total is None else total + outer
    return total, grads
