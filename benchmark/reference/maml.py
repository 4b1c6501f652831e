"""Plain reference of MAML (Finn et al., arXiv:1703.03400, §5.2) on
Conv-4-64 (Vinyals et al., arXiv:1606.04080; Snell et al.,
arXiv:1703.05175).

The network is four blocks of [3×3 convolution with padding 1 → batch
norm on the images' own statistics (mean and the biased variance over
images, height and width, eps 1e-5) → ReLU → 2×2 max-pool], then a linear
head over the flattened features in (height, width, channel) order.
Images come as (M, H, W, C) pixels widened to [0, 1]. Meta-training
adapts every weight of a task's own copy of the network by SGD on that
task's support cross-entropy, second order, and steps the outer loss (the
query cross-entropy, mean over tasks) with Adam.

One departure from ``F.max_pool2d``: the pool is a reshape and a max, so a
window whose largest value is tied splits its gradient evenly among the
tied elements (``F.max_pool2d`` sends it all to one of them). uint8
pixels tie often, and second-order MAML differentiates through the split.

Written with autograd and plain tensor operations, a loop over the tasks
with ``F.conv2d``, in the dtype of the weights it is given; it imports
nothing of the program. Its convolutions run with cuDNN off, as PyTorch's
own unfold-and-GEMM kernels: cuDNN, which the program uses, picks FFT and
Winograd algorithms by shape, and on an H100 their rounding parted an
inner step's update from the fp64 reference's by up to 0.4% of a leaf,
where the plain products parted it by under 0.06% (``PERF.md`` §2). On the
CPU the switch changes nothing.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.common import Noise, Params, torch_linear_bound

EPS = 1e-5


@contextlib.contextmanager
def plain_convolutions():
    """cuDNN off inside the block, the forward and the backward alike."""
    old = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = old


def feature_dim(w: dict) -> int:
    side = w["im_size"]
    for _ in range(w["blocks"]):
        side //= 2
    return side * side * w["hidden"]


def specs(config: dict):
    """The leaves under the program's names: conv weights (out, in, 3, 3)
    and biases at ``nn.Conv2d``'s default bound, the norm's gamma ones and
    beta zeros, the head at ``nn.Linear``'s."""
    w = config["widths"]
    k, hidden = w["kernel"], w["hidden"]
    out, cin = [], w["im_channels"]
    for i in range(w["blocks"]):
        b = torch_linear_bound(cin * k * k)
        name = f"convs.{i}"
        out += [(name + ".weight", (hidden, cin, k, k), b),
                (name + ".bias", (hidden,), b),
                (name + ".gamma", (hidden,), "ones"),
                (name + ".beta", (hidden,), "zeros")]
        cin = hidden
    f = feature_dim(w)
    b = torch_linear_bound(f)
    out += [("head.weight", (w["num_ways"], f), b),
            ("head.bias", (w["num_ways"],), b)]
    return out


def pool(x: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 max-pool of (M, C, H, W), an odd last row or column
    dropped; a tied window's gradient is split evenly among the ties."""
    M, C, H, W = x.shape
    x = x[:, :, :H // 2 * 2, :W // 2 * 2]
    return x.reshape(M, C, H // 2, 2, W // 2, 2).amax(dim=(3, 5))


def forward(theta: Params, x: torch.Tensor) -> torch.Tensor:
    """One task's weights on its (M, H, W, C) images -> (M, N) logits."""
    h = x.permute(0, 3, 1, 2)
    i = 0
    while f"convs.{i}.weight" in theta:
        p = {k: theta[f"convs.{i}.{k}"]
             for k in ("weight", "bias", "gamma", "beta")}
        h = F.conv2d(h, p["weight"], p["bias"], padding=1)
        mean = h.mean(dim=(0, 2, 3), keepdim=True)
        var = ((h - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
        h = (h - mean) / torch.sqrt(var + EPS)
        h = h * p["gamma"].reshape(1, -1, 1, 1) + p["beta"].reshape(
            1, -1, 1, 1)
        h = pool(torch.relu(h))
        i += 1
    f = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
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
    """``steps`` SGD steps of one task from ``p``, second order."""
    theta = dict(p)
    for _ in range(steps):
        grads = torch.autograd.grad(task_loss(theta, x, y),
                                    list(theta.values()), create_graph=True)
        theta = {k: v - step_size * g
                 for (k, v), g in zip(theta.items(), grads)}
    return theta


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
