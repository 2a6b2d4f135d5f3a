"""Synthetic gallery generators (the port's own copy of
``fast_image_recognition_tpu/data/synthetic.py``: NumPy, so a seed gives
bit-equal arrays).

The reference's experiments run over shipped precomputed feature files that
are stripped from this mirror (.MISSING_LARGE_BLOBS). These generators
produce class-clustered unit-norm embeddings with the same statistical shape
(C classes, n/class, D dims, L2-normalized, mostly-positive activations like
pooled CNN embeddings) for tests and benchmarks.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from fast_image_recognition_tpu_torch.data.feature_io import normalize_features


def make_synthetic_gallery(
    num_classes: int,
    images_per_class: int,
    num_features: int,
    seed: int = 123,
    within_class_noise: float = 0.35,
    nonneg: bool = True,
    l2: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (features [N, D] float32 row-normalized, labels [N] int32)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((num_classes, num_features)).astype(np.float32)
    # each row's center + noise * within_class_noise, worked in place in one
    # float32 array (the same roundings as the JAX package's temporaries)
    raw = rng.standard_normal((num_classes * images_per_class, num_features)).astype(np.float32)
    raw *= within_class_noise
    raw.reshape(num_classes, images_per_class, num_features)[...] += centers[:, None, :]
    if nonneg:
        # Pooled post-ReLU CNN embeddings are non-negative and sparse-ish,
        # which matters for the chi2/KL distances.
        np.maximum(raw, 0.0, out=raw)
        raw += 1e-3
    feats = normalize_features(raw, l2=l2)
    labels = np.repeat(
        np.arange(num_classes, dtype=np.int32), images_per_class
    )
    return feats, labels


def make_gallery_and_probes(
    num_classes: int,
    gallery_per_class: int,
    probes_per_class: int,
    num_features: int,
    seed: int = 123,
    within_class_noise: float = 0.35,
):
    """One clustered pool split into (gallery, glabels, probes, plabels) —
    probes share the gallery's class centers (unlike two independent
    ``make_synthetic_gallery`` calls, whose centers are unrelated)."""
    per = gallery_per_class + probes_per_class
    feats, labels = make_synthetic_gallery(
        num_classes, per, num_features, seed=seed,
        within_class_noise=within_class_noise,
    )
    gal_mask = (np.arange(feats.shape[0]) % per) < gallery_per_class
    return (
        feats[gal_mask],
        labels[gal_mask],
        feats[~gal_mask],
        labels[~gal_mask],
    )
