"""Split policies as index lists (port of ``random_split`` and
``species_split`` of ``pretrain_gnns_tpu.data.splitters``).

- :func:`random_split`: a seeded shuffle split, with python's Mersenne
  ``random.Random(seed).shuffle``, the reference's stream
  (chem/splitters.py:173-229, bio/splitters.py:5-41);
- :func:`species_split`: train/valid on seven species, test on human
  (bio/splitters.py:43-69).

The scaffold and cross-validation splits wait for fine-tuning."""

from __future__ import annotations

import random as _pyrandom
from typing import List, Optional, Tuple

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
