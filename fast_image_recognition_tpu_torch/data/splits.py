"""Train/test split logic (the port's own copy of
``fast_image_recognition_tpu/data/splits.py``: the same rng calls, so a
seed gives the same indices).

Two splitters exist in the reference and both are reproduced here with a
seeded NumPy RNG in place of C ``rand()``/``random_shuffle`` (the behavioural
contract is per-class counts + determinism given a seed, not the exact C
PRNG stream):

- ``train_test_split_images`` — qt_cpp/db_features.cpp:117-162: one shared
  shuffled index permutation applied to every class; a fixed number of
  images per class (Caltech: 30) or ``ceil(fraction*n)`` clamped to
  ``[1, n-1]`` go to the gallery, the rest to the probe set.
- ``split_by_class_fraction`` — qt_cpp/classification.cpp:942-990: per-class
  independent shuffles; ``fraction >= 1`` means images per class; train
  count clamped to ``[1, n]``; also returns per-feature min/max/mean/std
  computed over the training rows only (classification.cpp:969-989).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Split:
    """Index-based split over a flat [N, D] gallery."""

    train_idx: np.ndarray  # int64 indices into the DB
    test_idx: np.ndarray


def train_test_split_images(
    labels: np.ndarray,
    rng: np.random.Generator,
    train_images_per_class: Optional[int] = 30,
    train_fraction: float = 0.03,
    randomize: bool = True,
    indices_count: int = 400,
) -> Split:
    """The db_features.cpp:117-162 splitter.

    A single permutation of ``range(indices_count)`` is shared across all
    classes; within each class, members whose permuted position comes first
    fill the train quota. ``train_images_per_class=None`` selects the
    FRACTION path (ceil, clamped to [1, n-1])."""
    labels = np.asarray(labels)
    order = np.arange(indices_count)
    if randomize:
        rng.shuffle(order)

    train: list = []
    test: list = []
    num_classes = int(labels.max()) + 1 if labels.size else 0
    for class_ind in range(num_classes):
        members = np.flatnonzero(labels == class_ind)
        n = members.size
        if n == 0:
            continue
        if train_images_per_class is not None:
            db_size = train_images_per_class
        else:
            db_size = int(np.ceil(n * train_fraction))
            if db_size == n:
                db_size = n - 1
            if db_size == 0:
                db_size = 1
        taken = 0
        for pos in order:
            if pos < n:
                idx = members[pos]
                if taken < db_size:
                    train.append(idx)
                else:
                    test.append(idx)
                taken += 1
    return Split(
        train_idx=np.asarray(train, dtype=np.int64),
        test_idx=np.asarray(test, dtype=np.int64),
    )


@dataclasses.dataclass
class FeatureStats:
    """Per-feature statistics over the training rows
    (classification.cpp:53-62, 969-989)."""

    min: np.ndarray
    max: np.ndarray
    mean: np.ndarray
    std: np.ndarray  # Bessel-corrected, matching sqrt((S2-n*m^2)/(n-1))

    @staticmethod
    def from_rows(rows: np.ndarray) -> "FeatureStats":
        rows64 = np.asarray(rows, dtype=np.float64)
        n = rows64.shape[0]
        mean = rows64.mean(axis=0)
        if n > 1:
            s2 = (rows64**2).sum(axis=0)
            var = (s2 - mean * mean * n) / (n - 1)
            std = np.sqrt(np.maximum(var, 0.0))
        else:
            std = np.zeros_like(mean)
        return FeatureStats(
            min=rows64.min(axis=0),
            max=rows64.max(axis=0),
            mean=mean,
            std=std,
        )


def split_by_class_fraction(
    labels: np.ndarray,
    rng: np.random.Generator,
    fraction: float,
    features: Optional[np.ndarray] = None,
) -> Tuple[Split, Optional[FeatureStats]]:
    """The classification.cpp:942-990 splitter.

    ``fraction >= 1`` is an absolute images-per-class count; otherwise
    ``ceil(fraction * n)``. The train count is clamped to [1, n] (a class may
    contribute no test images). Returns training-row feature statistics when
    ``features`` is given."""
    labels = np.asarray(labels)
    train: list = []
    test: list = []
    num_classes = int(labels.max()) + 1 if labels.size else 0
    for class_ind in range(num_classes):
        members = np.flatnonzero(labels == class_ind)
        n = members.size
        if n == 0:
            continue
        perm = rng.permutation(n)
        end = int(fraction) if fraction >= 1 else int(np.ceil(fraction * n))
        if end == 0:
            end = 1
        end = min(end, n)
        train.extend(members[perm[:end]])
        test.extend(members[perm[end:]])
    split = Split(
        train_idx=np.asarray(train, dtype=np.int64),
        test_idx=np.asarray(test, dtype=np.int64),
    )
    stats = None
    if features is not None:
        stats = FeatureStats.from_rows(np.asarray(features)[split.train_idx])
    return split, stats
