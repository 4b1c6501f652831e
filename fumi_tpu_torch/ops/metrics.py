"""Classification metrics of a meta-batch, numerically sklearn's.

The counterpart of ``fumi_tpu/ops/metrics.py``. The reference flattens
the meta-batch and calls ``sklearn.metrics.accuracy_score`` and
``precision_recall_fscore_support(average="macro")`` on the host; here
the same quantities come from a confusion matrix on the device, and only
scalars leave it.

The confusion matrix is exact: it counts ``target·N + pred`` in int64, as
``torch.bincount`` would (which on CUDA reads the largest id back to the
host first, a sync inside every train step), and returns the counts as
fp32, as the JAX package returns its one-hot product. Macro averages run
over all N classes (episodic query sets hold every class), and a class
with no predicted or no true sample contributes 0, sklearn's
``zero_division`` default.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def confusion_matrix(targets: torch.Tensor, preds: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """(N, N) fp32 counts; rows are the true class, columns the predicted
    one. Inputs of any shape are flattened, as the reference flattens the
    meta-batch. Out-of-range ids count nowhere, as ``jax.nn.one_hot``
    gives them a zero row."""
    n2 = num_classes * num_classes
    t = targets.reshape(-1).long()
    p = preds.reshape(-1).long()
    keep = (t >= 0) & (t < num_classes) & (p >= 0) & (p < num_classes)
    cell = torch.where(keep, t * num_classes + p, torch.full_like(t, n2))
    counts = torch.zeros(n2 + 1, dtype=torch.int64, device=t.device)
    counts.index_add_(0, cell, torch.ones_like(cell))
    return counts[:n2].reshape(num_classes, num_classes).to(torch.float32)


def _mean(x: torch.Tensor) -> torch.Tensor:
    """The sum times the fp32 reciprocal of the count, as XLA lowers
    ``jnp.mean``: an integer-valued sum (an accuracy) then rounds as the
    JAX package's does."""
    return x.sum() * (1.0 / x.numel())


def accuracy(targets: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """Flat accuracy, ``sklearn.accuracy_score``."""
    return _mean((targets.reshape(-1) == preds.reshape(-1)).to(
        torch.float32))


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` where ``den > 0``, else 0."""
    return torch.where(den > 0, num / den.clamp_min(1e-30),
                       torch.zeros_like(num))


def per_class_prf1(conf: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N,) precision, recall and F1 of each class of a confusion
    matrix."""
    tp = torch.diagonal(conf)
    prec = _safe_div(tp, conf.sum(dim=0))  # TP + FP per class
    rec = _safe_div(tp, conf.sum(dim=1))  # TP + FN per class
    return prec, rec, _safe_div(2.0 * prec * rec, prec + rec)


def macro_prf1(conf: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Macro precision, recall and F1 of a confusion matrix: the class
    means of :func:`per_class_prf1`."""
    prec, rec, f1 = per_class_prf1(conf)
    return _mean(prec), _mean(rec), _mean(f1)


def conf_metrics(conf: torch.Tensor) -> Dict[str, torch.Tensor]:
    """acc (0 for an empty matrix) and macro prec / rec / f1 of a
    confusion matrix: AM3's metrics of a meta-batch."""
    prec, rec, f1 = macro_prf1(conf)
    return {"acc": torch.diagonal(conf).sum() / conf.sum().clamp_min(1.0),
            "prec": prec, "rec": rec, "f1": f1}


def episode_metrics(targets: torch.Tensor, preds: torch.Tensor,
                    num_classes: int) -> Dict[str, torch.Tensor]:
    """acc and macro prec / rec / f1 over a flattened meta-batch."""
    prec, rec, f1 = macro_prf1(confusion_matrix(targets, preds, num_classes))
    return {"acc": accuracy(targets, preds), "prec": prec, "rec": rec,
            "f1": f1}
