"""The port's ``ops/metrics.py`` against ``fumi_tpu.ops.metrics`` on the
CPU, on the same targets and predictions (numpy, from a seed), including
classes that are never predicted and classes that never occur.

Exact: the confusion matrix (integer counts), the accuracy, and each
class's precision, recall and F1 (the same fp32 divisions). The macro
averages add N per-class values, in XLA's vectorised order on the JAX side
and torch's on the port's, so they agree to the last bits: 1e-6
relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fumi_tpu.ops import metrics as jax_metrics
from fumi_tpu_torch.ops import metrics

CASES = {
    # (shape of the meta-batch, num_classes, predicted classes)
    "episode": ((4, 25), 5, None),
    "never_predicted": ((2, 30), 5, (0, 2)),  # classes 1, 3, 4 never
    "one_class_predicted": ((3, 12), 4, (3,)),
    "flat": ((17,), 3, None),
    "many_classes": ((2, 64), 20, None),
}


def inputs(name):
    shape, n, predicted = CASES[name]
    rng = np.random.RandomState(sorted(CASES).index(name))
    targets = rng.randint(0, n, shape).astype(np.int32)
    choices = np.arange(n) if predicted is None else np.asarray(predicted)
    preds = rng.choice(choices, shape).astype(np.int32)
    return targets, preds, n


@pytest.mark.parametrize("name", sorted(CASES))
def test_confusion_matrix_and_metrics_equal_the_jax_packages(name):
    targets, preds, n = inputs(name)
    t, p = torch.from_numpy(targets), torch.from_numpy(preds)
    conf = metrics.confusion_matrix(t, p, n)
    want = np.asarray(jax_metrics.confusion_matrix(
        jnp.asarray(targets), jnp.asarray(preds), n))
    assert conf.dtype == torch.float32
    np.testing.assert_array_equal(conf.numpy(), want)
    tp = jnp.diagonal(jnp.asarray(want))
    j_prec = jax_metrics._safe_div(tp, jnp.sum(jnp.asarray(want), axis=0))
    j_rec = jax_metrics._safe_div(tp, jnp.sum(jnp.asarray(want), axis=1))
    j_f1 = jax_metrics._safe_div(2.0 * j_prec * j_rec, j_prec + j_rec)
    for got, exp in zip(metrics.per_class_prf1(conf), (j_prec, j_rec, j_f1)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    for got, exp in zip(metrics.macro_prf1(conf),
                        jax_metrics.macro_prf1(jnp.asarray(want))):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6,
                                   atol=0)
    got = metrics.episode_metrics(t, p, n)
    exp = jax_metrics.episode_metrics(jnp.asarray(targets),
                                      jnp.asarray(preds), n)
    assert set(got) == set(exp)
    np.testing.assert_array_equal(got["acc"].numpy(), np.asarray(exp["acc"]))
    for k in ("prec", "rec", "f1"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(exp[k]),
                                   rtol=1e-6, atol=0, err_msg=k)
    np.testing.assert_array_equal(
        metrics.accuracy(t, p).numpy(),
        np.asarray(jax_metrics.accuracy(jnp.asarray(targets),
                                        jnp.asarray(preds))))


def test_a_class_never_predicted_has_precision_zero():
    conf = metrics.confusion_matrix(torch.tensor([0, 1, 2, 2]),
                                    torch.tensor([0, 0, 2, 2]), 3)
    prec, rec, f1 = metrics.macro_prf1(conf)
    # class 1 is never predicted: precision 0, recall 0, F1 0
    assert float(prec) == pytest.approx((0.5 + 0.0 + 1.0) / 3)
    assert float(rec) == pytest.approx((1.0 + 0.0 + 1.0) / 3)
    assert float(f1) == pytest.approx((2 / 3 + 0.0 + 1.0) / 3)
    assert float(metrics.conf_metrics(conf)["acc"]) == 0.75


def test_out_of_range_ids_count_nowhere_as_in_jax():
    targets = np.array([0, 1, 5, -1, 2], np.int32)
    preds = np.array([0, 7, 1, 1, 2], np.int32)
    got = metrics.confusion_matrix(torch.from_numpy(targets),
                                   torch.from_numpy(preds), 3)
    want = jax_metrics.confusion_matrix(jnp.asarray(targets),
                                        jnp.asarray(preds), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    empty = metrics.confusion_matrix(torch.zeros(0, dtype=torch.int32),
                                     torch.zeros(0, dtype=torch.int32), 3)
    assert float(metrics.conf_metrics(empty)["acc"]) == 0.0
