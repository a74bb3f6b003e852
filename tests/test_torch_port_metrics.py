"""Port parity of the classification statistics (``eval/metrics.py``): the
port's numpy/scipy ``calculate_stats``, ``mean_ap``, ``mean_auc`` and
``d_prime`` against the JAX package's, which call scikit-learn.

Each field of each class's statistics within 1e-12 (the same float64
arithmetic in the same order): AP, AUC, the sampled precision, recall,
false positive and false negative rate curves, and the accuracy. The
scores carry ties within and across classes; the targets include a class
with one positive, a class with no positive (AP 0, curves -1), one with
every sample positive, and multi-label rows.
"""

import numpy as np
import pytest

from avsiam_tpu.eval import metrics as jm
from avsiam_tpu_torch.eval import metrics as pm

KEYS = ("AP", "auc", "acc", "precisions", "recalls", "fpr", "fnr")


def _case(seed: int, n: int = 200, classes: int = 12, ties: bool = True):
    """(scores [n, classes] float32, targets [n, classes] 0/1): class 0 has
    no positive, class 1 every sample positive, class 2 one positive; the
    scores rounded to a coarse grid where ``ties``."""
    rs = np.random.RandomState(seed)
    y = (rs.rand(n, classes) < 0.2).astype(np.float32)
    y[:, 0] = 0
    y[:, 1] = 1
    y[:, 2] = 0
    y[rs.randint(n), 2] = 1
    s = rs.rand(n, classes).astype(np.float32) + 0.3 * y
    if ties:
        s = np.round(s * 16) / 16
    return s.astype(np.float32), y


def _assert_stats_equal(got, want):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        for key in KEYS:
            np.testing.assert_allclose(np.asarray(g[key], np.float64),
                                       np.asarray(w[key], np.float64),
                                       rtol=0, atol=1e-12,
                                       err_msg=f"class {k} {key}")


@pytest.mark.parametrize("seed,ties", [(0, True), (1, True), (2, False),
                                       (3, True)])
def test_calculate_stats_matches_sklearn(seed, ties):
    s, y = _case(seed, ties=ties)
    got, want = pm.calculate_stats(s, y), jm.calculate_stats(s, y)
    _assert_stats_equal(got, want)
    assert got[0]["auc"] == -1 and got[0]["AP"] == 0.0
    assert got[1]["auc"] == -1 and got[1]["AP"] == 1.0
    assert got[2]["auc"] != -1
    assert abs(pm.mean_ap(got) - jm.mean_ap(want)) <= 1e-12
    assert abs(pm.mean_auc(got) - jm.mean_auc(want)) <= 1e-12


def test_sampled_curves_match_sklearn():
    """Over 2500 samples the curves are sampled every 1000 points (and
    every 7 with ``sample_curves_every=7``)."""
    s, y = _case(4, n=2500, classes=4)
    _assert_stats_equal(pm.calculate_stats(s, y), jm.calculate_stats(s, y))
    _assert_stats_equal(pm.calculate_stats(s, y, sample_curves_every=7),
                        jm.calculate_stats(s, y, sample_curves_every=7))


def test_all_tied_scores_and_single_class_targets():
    """Every score equal (one threshold), and targets of one class only."""
    s = np.full((50, 3), 0.5, np.float32)
    y = np.zeros((50, 3), np.float32)
    y[::3, 0] = 1
    y[:, 1] = 1
    _assert_stats_equal(pm.calculate_stats(s, y), jm.calculate_stats(s, y))


def test_curves_match_sklearn_functions():
    """The building blocks against the sklearn calls they stand for."""
    from sklearn import metrics as sk
    s, y = _case(5, classes=6)
    for k in range(3, 6):
        for got, want in zip(pm.precision_recall_curve(y[:, k], s[:, k]),
                             sk.precision_recall_curve(y[:, k], s[:, k])):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(pm.roc_curve(y[:, k], s[:, k]),
                             sk.roc_curve(y[:, k], s[:, k])):
            np.testing.assert_array_equal(got, want)
        assert pm.average_precision(y[:, k], s[:, k]) == \
            sk.average_precision_score(y[:, k], s[:, k])
        assert pm.roc_auc(y[:, k], s[:, k]) == sk.roc_auc_score(y[:, k],
                                                                s[:, k])


def test_non_binary_targets_are_refused():
    with pytest.raises(ValueError, match="0 or 1"):
        pm.average_precision(np.array([0.0, 0.5, 1.0]),
                             np.array([0.1, 0.2, 0.3]))


@pytest.mark.parametrize("auc", [0.5, 0.75, 0.9, 0.99])
def test_d_prime_matches_jax(auc):
    assert pm.d_prime(auc) == jm.d_prime(auc)
