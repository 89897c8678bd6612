"""Split policies as index lists (port of
``pretrain_gnns_tpu.data.splitters``). Each takes indices, labels or
precomputed scaffold strings, not a dataset, and draws from the stream the
reference draws from, so that the evaluation sets are the JAX package's
index for index:

- :func:`scaffold_split`: the deterministic Bemis-Murcko scaffold split
  (chem/splitters.py:27-107);
- :func:`random_scaffold_split`: scaffold groups permuted by
  ``np.random.RandomState(seed)`` (chem/splitters.py:109-171);
- :func:`random_split`: a seeded shuffle split, with python's Mersenne
  ``random.Random(seed).shuffle``, the reference's stream
  (chem/splitters.py:173-229, bio/splitters.py:5-41);
- :func:`cv_random_split`: stratified 10-fold cross-validation
  (chem/splitters.py:232-265), scikit-learn's ``StratifiedKFold(shuffle=
  True, random_state=seed)`` fold assignment written out in numpy;
- :func:`species_split`: train/valid on seven species, test on human
  (bio/splitters.py:43-69)."""

from __future__ import annotations

import random as _pyrandom
from collections import defaultdict
from typing import List, Optional, Sequence, Tuple

import numpy as np

Idx = List[int]

TRAIN_VALID_SPECIES = (3702, 6239, 511145, 7227, 10090, 4932, 7955)
TEST_SPECIES = (9606,)  # human


def _filter_task(n: int, y: Optional[np.ndarray], task_idx: Optional[int],
                 null_value: float) -> np.ndarray:
    """Indices with a non-null label in column ``task_idx`` (or all)."""
    if task_idx is None:
        return np.arange(n)
    return np.where(np.asarray(y)[:, task_idx] != null_value)[0]


def _scaffold_groups(scaffolds: Sequence[str],
                     keep: np.ndarray) -> "defaultdict[str, Idx]":
    """The kept indices grouped by scaffold, groups in first-seen order."""
    groups: "defaultdict[str, Idx]" = defaultdict(list)
    for i in keep:
        groups[scaffolds[int(i)]].append(int(i))
    return groups


def scaffold_split(
    scaffolds: Sequence[str],
    y: Optional[np.ndarray] = None,
    task_idx: Optional[int] = None,
    null_value: float = 0.0,
    frac_train: float = 0.8,
    frac_valid: float = 0.1,
    frac_test: float = 0.1,
) -> Tuple[Idx, Idx, Idx]:
    """``(train, valid, test)`` by scaffold: the groups sorted by (size,
    first index), largest first, fill train, then valid, then test at the
    80/10/10 cutoffs of the kept examples' count."""
    np.testing.assert_almost_equal(frac_train + frac_valid + frac_test, 1.0)
    keep = _filter_task(len(scaffolds), y, task_idx, null_value)
    groups = {k: sorted(v)
              for k, v in _scaffold_groups(scaffolds, keep).items()}
    scaffold_sets = [v for _, v in sorted(
        groups.items(), key=lambda x: (len(x[1]), x[1][0]), reverse=True)]
    train_cutoff = frac_train * len(keep)
    valid_cutoff = (frac_train + frac_valid) * len(keep)
    train, valid, test = [], [], []
    for group in scaffold_sets:
        if len(train) + len(group) > train_cutoff:
            if len(train) + len(valid) + len(group) > valid_cutoff:
                test.extend(group)
            else:
                valid.extend(group)
        else:
            train.extend(group)
    return train, valid, test


def random_scaffold_split(
    scaffolds: Sequence[str],
    y: Optional[np.ndarray] = None,
    task_idx: Optional[int] = None,
    null_value: float = 0.0,
    frac_train: float = 0.8,
    frac_valid: float = 0.1,
    frac_test: float = 0.1,
    seed: int = 0,
) -> Tuple[Idx, Idx, Idx]:
    """``(train, valid, test)`` by scaffold group, the groups (in
    first-seen order) permuted by ``np.random.RandomState(seed)``; a group
    goes to valid, else test, while it fits, else to train. The cutoffs
    count the whole set, filtered or not, as the reference does
    (``len(dataset)``, chem/splitters.py:152-153)."""
    np.testing.assert_almost_equal(frac_train + frac_valid + frac_test, 1.0)
    n_all = len(scaffolds)
    keep = _filter_task(n_all, y, task_idx, null_value)
    sets = list(_scaffold_groups(scaffolds, keep).values())
    order = np.random.RandomState(seed).permutation(len(sets))
    n_valid = int(np.floor(frac_valid * n_all))
    n_test = int(np.floor(frac_test * n_all))
    train, valid, test = [], [], []
    for i in order:
        group = sets[i]
        if len(valid) + len(group) <= n_valid:
            valid.extend(group)
        elif len(test) + len(group) <= n_test:
            test.extend(group)
        else:
            train.extend(group)
    return train, valid, test


def random_split(
    n: int,
    y: Optional[np.ndarray] = None,
    task_idx: Optional[int] = None,
    null_value: float = 0.0,
    frac_train: float = 0.8,
    frac_valid: float = 0.1,
    frac_test: float = 0.1,
    seed: int = 0,
) -> Tuple[Idx, Idx, Optional[Idx]]:
    """``(train, valid, test)`` indices of a seeded shuffle; ``test`` is
    None when ``frac_test`` is 0. With ``task_idx`` only the examples with
    a non-null label in that column are split, and the indices point into
    the whole set."""
    np.testing.assert_almost_equal(frac_train + frac_valid + frac_test, 1.0)
    keep = _filter_task(n, y, task_idx, null_value)
    num = len(keep)
    idx = list(range(num))
    _pyrandom.Random(seed).shuffle(idx)
    a = int(frac_train * num)
    b = a + int(frac_valid * num)
    train = [int(keep[i]) for i in idx[:a]]
    valid = [int(keep[i]) for i in idx[a:b]]
    test = [int(keep[i]) for i in idx[b:]]
    return train, valid, (None if frac_test == 0 else test)


def stratified_folds(labels: Sequence[float], n_splits: int = 10,
                     seed: int = 0) -> np.ndarray:
    """Each example's test fold under scikit-learn's ``StratifiedKFold(
    n_splits, shuffle=True, random_state=seed)``: the classes coded in
    order of first appearance, each class's share of every fold dealt
    round robin over the sorted codes (``bincount(y_order[i::n_splits])``),
    then each class's list of folds shuffled by one
    ``np.random.RandomState(seed)``, class after class."""
    y = np.asarray(labels).reshape(-1)
    _, first, inverse = np.unique(y, return_index=True, return_inverse=True)
    _, class_of = np.unique(first, return_inverse=True)
    codes = class_of[inverse.reshape(-1)]
    n_classes = len(first)
    if np.all(n_splits > np.bincount(codes)):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the "
                         "number of members in each class.")
    y_order = np.sort(codes)
    allocation = np.stack([np.bincount(y_order[i::n_splits],
                                       minlength=n_classes)
                           for i in range(n_splits)])
    rng = np.random.RandomState(seed)
    folds = np.empty(len(y), np.int64)
    for k in range(n_classes):
        of_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(of_class)
        folds[codes == k] = of_class
    return folds


def cv_random_split(
    labels: Sequence[float],
    fold_idx: int = 0,
    n_splits: int = 10,
    seed: int = 0,
) -> Tuple[Idx, Idx]:
    """``(train, valid)`` of fold ``fold_idx`` of the stratified
    ``n_splits``-fold cross-validation (:func:`stratified_folds`), each in
    index order."""
    folds = stratified_folds(labels, n_splits, seed)
    test = folds == fold_idx
    return ([int(i) for i in np.flatnonzero(~test)],
            [int(i) for i in np.flatnonzero(test)])


def species_split(species_ids: np.ndarray,
                  train_valid_species=TRAIN_VALID_SPECIES,
                  test_species=TEST_SPECIES) -> Tuple[Idx, Idx]:
    """``(train_valid, test)`` indices by species; every example must
    belong to exactly one side."""
    species_ids = np.asarray(species_ids)
    tv = np.isin(species_ids, train_valid_species)
    te = np.isin(species_ids, test_species)
    if not np.all(tv.astype(int) + te.astype(int) == 1):
        raise ValueError("every example must be of exactly one side's "
                         "species")
    return ([int(i) for i in np.where(tv)[0]],
            [int(i) for i in np.where(te)[0]])
