"""Plain reference of FuMI (arXiv:2210.04843; github.com/s-a-malik/fumi).

A hypernetwork, Linear(E, T)-ReLU-Linear(T, H2 + 1), maps each class's
text to that class's row of the image network's head (H2 weights and a
bias). The image network is Linear(D, H1)-ReLU-Dropout-Linear(H1,
H2)-ReLU-Dropout, then the generated head. A class's text is the text of
its first support row. Meta-training adapts the image network and the
generated head together by SGD on the support cross-entropy, second order,
and steps the outer loss (the query cross-entropy, mean over tasks) with
Adam. Serving adapts the same way with no outer graph and no dropout, then
classifies the queries.

Written with autograd and plain tensor operations, in fp32; it imports
nothing of the program.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference.common import (Noise, Params, cross_entropy,
                                        dropout, torch_linear_bound)


def specs(config: dict):
    """The leaves under the reference's state-dict names."""
    w = config["widths"]
    D, (H1, H2) = w["im_emb_dim"], w["im_hid_dim"]
    E, T = w["text_emb_dim"], w["text_hid_dim"]
    out = []
    for name, (o, i) in (("im_net.linear0", (H1, D)),
                         ("im_net.linear1", (H2, H1)),
                         ("hyper_net.0", (T, E)),
                         ("hyper_net.2", (H2 + 1, T))):
        b = torch_linear_bound(i)
        out += [(name + ".weight", (o, i), b), (name + ".bias", (o,), b)]
    return out


def _lin(x, w, b):
    return torch.matmul(x, w.transpose(-1, -2)) + b.unsqueeze(-2)


def hyper_head(p: Params, class_text: torch.Tensor) -> torch.Tensor:
    """(..., N, E) class texts -> (..., N, H2 + 1) generated head rows."""
    h = torch.relu(torch.matmul(class_text, p["hyper_net.0.weight"].T)
                   + p["hyper_net.0.bias"])
    return torch.matmul(h, p["hyper_net.2.weight"].T) + p["hyper_net.2.bias"]


def forward(theta: Dict[str, torch.Tensor], x: torch.Tensor,
            rate: float = 0.0, noise: Noise = None) -> torch.Tensor:
    """Per-task weights (B, ...) on (B, M, D) rows -> (B, M, N) logits."""
    h = torch.relu(_lin(x, theta["w1"], theta["b1"]))
    if noise is not None:
        h = dropout(h, rate, noise)
    h = torch.relu(_lin(h, theta["w2"], theta["b2"]))
    if noise is not None:
        h = dropout(h, rate, noise)
    head = theta["head"]
    return _lin(h, head[..., :-1], head[..., -1])


def _theta(p: Params, head: torch.Tensor) -> Dict[str, torch.Tensor]:
    B = head.shape[0]
    names = {"w1": "im_net.linear0.weight", "b1": "im_net.linear0.bias",
             "w2": "im_net.linear1.weight", "b2": "im_net.linear1.bias"}
    theta = {k: p[v].expand((B,) + tuple(p[v].shape))
             for k, v in names.items()}
    theta["head"] = head
    return theta


def _step(theta, loss, step_size, create_graph):
    keys = list(theta)
    grads = torch.autograd.grad(loss, [theta[k] for k in keys],
                                create_graph=create_graph)
    return {k: theta[k] - step_size * g for k, g in zip(keys, grads)}


def serve_logits(p: Params, s_x: torch.Tensor, s_y: torch.Tensor,
                 q_x: torch.Tensor, class_text: torch.Tensor, steps: int,
                 step_size: float) -> torch.Tensor:
    """R requests at once: support (R, S, D), labels (R, S), queries (R, M,
    D) (padding rows change nothing but their own logits), class texts
    (R, N, E) -> (R, M, N) logits after ``steps`` SGD steps."""
    with torch.no_grad():
        head = hyper_head(p, class_text)
    theta = {k: v.detach().clone() for k, v in _theta(p, head).items()}
    for _ in range(steps):
        with torch.enable_grad():
            theta = {k: v.requires_grad_() for k, v in theta.items()}
            loss = cross_entropy(forward(theta, s_x), s_y).sum()
            theta = {k: v.detach() for k, v in
                     _step(theta, loss, step_size, False).items()}
    with torch.no_grad():
        return forward(theta, q_x)


def loss_and_grads(p: Params, episode: dict, noise: Noise, train: dict):
    """One meta-training step's outer loss and its gradient with respect
    to every leaf of ``p``. ``episode``: support (B, S, D) and labels,
    query (B, Q, D) and labels, class texts (B, N, E)."""
    rate = float(train["dropout"])
    with torch.enable_grad():
        theta = _theta(p, hyper_head(p, episode["class_text"]))
        for _ in range(int(train["inner_steps"])):
            logits = forward(theta, episode["s_x"], rate, noise)
            loss = cross_entropy(logits, episode["s_y"]).sum()
            theta = _step(theta, loss, float(train["step_size"]), True)
        q_logits = forward(theta, episode["q_x"], rate, noise)
        outer = cross_entropy(q_logits, episode["q_y"]).mean()
        keys = list(p)
        grads = torch.autograd.grad(outer, [p[k] for k in keys])
    return outer.detach(), dict(zip(keys, grads))

