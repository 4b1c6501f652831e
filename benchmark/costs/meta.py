"""Model operations of a second-order meta-training step, from the
products' shapes.

A network is a chain of products (linear layers or convolutions); layer 0
reads the data. ``units`` lists each layer's forward operations for one
pass. Counted once, as the algorithm needs them:

- forward: every product once;
- backward: each layer's weight gradient, and its input gradient except
  layer 0's (the data needs none): ``u0 + 2·Σ others``;
- the outer backward through one inner step: through its forward
  products (``u0 + 2·Σ others``) and through its backward products, whose
  operands all depend on the weights except layer 0's data (``u0 +
  4·Σ others``): ``2·u0 + 6·Σ others``.

Elementwise work (activations, normalisation, pooling, the loss, the
optimizer) is left out: next to the products it is small, and leaving it
out keeps a share of the peak from reading high.
"""

from typing import Sequence


def forward(units: Sequence[float]) -> float:
    return float(sum(units))


def backward(units: Sequence[float]) -> float:
    return float(units[0] + 2 * sum(units[1:]))


def outer_through_step(units: Sequence[float]) -> float:
    return float(2 * units[0] + 6 * sum(units[1:]))


def second_order_task(support: Sequence[float], query: Sequence[float],
                      inner_steps: int) -> float:
    """One task: ``inner_steps`` of support forward and backward, the
    query forward and backward, and the outer backward through every
    inner step."""
    per_step = forward(support) + backward(support) + outer_through_step(
        support)
    return inner_steps * per_step + forward(query) + backward(query)
