"""Evaluation metrics on the host, in numpy (port of
``pretrain_gnns_tpu.train.metrics``; the reference calls scikit-learn).

- chem protocol (chem/finetune.py:49-77): a ROC-AUC per task over labels in
  {-1, 0, +1}, missing entries (0) skipped, tasks without both classes
  left out; the mean over the tasks that remain;
- bio protocol (bio/finetune.py:40-65): a ROC-AUC per task over {0, 1}
  labels, NaN where a class is absent;
- mutag/ptc (chem/finetune_mutag_ptc.py:65-78): the accuracy of the
  scores' signs."""

from __future__ import annotations

from typing import List

import numpy as np


def roc_auc(y_true01: np.ndarray, scores: np.ndarray) -> float:
    """ROC-AUC from ranks, ties given their mid-rank (what
    ``sklearn.metrics.roc_auc_score`` computes)."""
    y = np.asarray(y_true01).astype(bool)
    s = np.asarray(scores, np.float64)
    n_pos, n_neg = int(y.sum()), int((~y).sum())
    if n_pos == 0 or n_neg == 0:
        raise ValueError("need both classes")
    order = np.argsort(s, kind="mergesort")
    sorted_s = s[order]
    # each run of equal scores: its first rank (1-based) and its length
    starts = np.flatnonzero(np.r_[True, sorted_s[1:] != sorted_s[:-1]])
    lengths = np.diff(np.r_[starts, len(s)])
    ranks = np.empty(len(s), np.float64)
    ranks[order] = np.repeat(starts + 1 + 0.5 * (lengths - 1), lengths)
    return float(
        (ranks[y].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def chem_mean_auc(y: np.ndarray, scores: np.ndarray) -> float:
    """``y [G, T]`` in {-1, 0, +1}, ``scores [G, T]``: a task counts iff it
    has a positive and a negative label; its AUC is over its non-missing
    entries; the result is the mean over the tasks that count (NaN if
    none)."""
    aucs: List[float] = []
    for t in range(y.shape[1]):
        col = y[:, t]
        if (col == 1).any() and (col == -1).any():
            valid = col != 0
            aucs.append(roc_auc((col[valid] + 1) / 2, scores[valid, t]))
    return float(np.mean(aucs)) if aucs else float("nan")


def bio_auc_array(y01: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """``y01 [G, T]`` in {0, 1}: each task's AUC, NaN where a class is
    absent."""
    out = np.full(y01.shape[1], np.nan)
    for t in range(y01.shape[1]):
        col = y01[:, t]
        if (col == 1).any() and (col == 0).any():
            out[t] = roc_auc(col, scores[:, t])
    return out


def accuracy_from_scores(y: np.ndarray, scores: np.ndarray) -> float:
    """The share of ``sign(score)`` (0 counts as -1) equal to ``y`` in
    {-1, +1}."""
    pred = np.where(scores > 0, 1.0, -1.0)
    return float((pred == y).mean())
