"""Evaluation metrics (numpy, exact).

Same metric suite the reference logs via sklearn (main.py:86-98): accuracy,
recall, precision, f1, average precision, ROC-AUC — reimplemented directly
so there is no sklearn dependency in the serving path.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Exact ROC-AUC via the Mann-Whitney rank-sum with average ranks for
    ties (matches sklearn.roc_auc_score)."""
    y_true = np.asarray(y_true).astype(bool)
    y_score = np.asarray(y_score, dtype=np.float64)
    npos = int(y_true.sum())
    nneg = y_true.size - npos
    if npos == 0 or nneg == 0:
        return float("nan")
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty_like(y_score)
    sorted_scores = y_score[order]
    # average ranks over tie groups (vectorized)
    n = y_score.size
    base = np.arange(1, n + 1, dtype=np.float64)
    grp = np.concatenate([[0], np.cumsum(np.diff(sorted_scores) != 0)])
    sums = np.bincount(grp, weights=base)
    cnts = np.bincount(grp)
    ranks[order] = (sums / cnts)[grp]
    rank_sum = ranks[y_true].sum()
    return float((rank_sum - npos * (npos + 1) / 2) / (npos * nneg))


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """AP = sum over distinct-threshold steps of (dRecall * Precision),
    tied scores collapsing into one threshold (sklearn semantics)."""
    y_true = np.asarray(y_true).astype(np.float64)
    s = np.asarray(y_score, dtype=np.float64)
    order = np.argsort(-s, kind="mergesort")
    yt = y_true[order]
    ss = s[order]
    npos = yt.sum()
    if npos == 0:
        return float("nan")
    n = yt.size
    last_of_group = np.concatenate([np.nonzero(np.diff(ss))[0], [n - 1]])
    tp = np.cumsum(yt)[last_of_group]
    k = last_of_group + 1.0
    precision = tp / k
    recall = tp / npos
    drecall = np.diff(np.concatenate([[0.0], recall]))
    return float((drecall * precision).sum())


def binary_metrics(y_true: np.ndarray, y_score: np.ndarray) -> Dict[str, float]:
    y_true = np.asarray(y_true)
    y_pred = np.round(np.asarray(y_score))
    tp = float(((y_pred == 1) & (y_true == 1)).sum())
    fp = float(((y_pred == 1) & (y_true == 0)).sum())
    fn = float(((y_pred == 0) & (y_true == 1)).sum())
    precision = tp / (tp + fp) if tp + fp > 0 else 0.0
    recall = tp / (tp + fn) if tp + fn > 0 else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall > 0 else 0.0)
    return {
        "accuracy": float((y_pred == y_true).mean()),
        "recall": recall,
        "precision": precision,
        "f1": f1,
        "ap": average_precision(y_true, y_score),
        "roc_auc": roc_auc(y_true, y_score),
    }
