"""Synthetic class-clustered unit-norm galleries (JAX ``data/synthetic.py``,
NumPy: a seed gives bit-equal arrays), standing in for the reference's
precomputed feature files."""

from typing import Tuple

import numpy as np

from .feature_io import normalize_features


def make_synthetic_gallery(num_classes: int, images_per_class: int, num_features: int, seed: int = 123,
    within_class_noise: float = 0.35, nonneg: bool = True, l2: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (features [N, D] float32 row-normalized, labels [N] int32)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((num_classes, num_features)).astype(np.float32)
    # center + noise * within_class_noise in place, in JAX's roundings
    raw = rng.standard_normal((num_classes * images_per_class, num_features)).astype(np.float32)
    raw *= within_class_noise
    raw.reshape(num_classes, images_per_class, num_features)[...] += centers[:, None, :]
    if nonneg:
        # Pooled post-ReLU CNN embeddings are non-negative and sparse-ish,
        # which matters for the chi2/KL distances.
        np.maximum(raw, 0.0, out=raw)
        raw += 1e-3
    feats = normalize_features(raw, l2=l2)
    labels = np.repeat(np.arange(num_classes, dtype=np.int32), images_per_class)
    return feats, labels


def make_gallery_and_probes(num_classes: int, gallery_per_class: int, probes_per_class: int, num_features: int,
    seed: int = 123, within_class_noise: float = 0.35):
    """One clustered pool split into (gallery, glabels, probes, plabels) sharing class centers."""
    per = gallery_per_class + probes_per_class
    feats, labels = make_synthetic_gallery(num_classes, per, num_features, seed=seed,
        within_class_noise=within_class_noise)
    gal_mask = (np.arange(feats.shape[0]) % per) < gallery_per_class
    return (feats[gal_mask], labels[gal_mask], feats[~gal_mask], labels[~gal_mask])
