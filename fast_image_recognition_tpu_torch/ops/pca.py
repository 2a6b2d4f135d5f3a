"""PCA fit on the host (numpy copy of ``fast_image_recognition_tpu/ops/pca.py``
``fit_pca`` and ``PCAModel``): thin SVD of the mean-centred rows in float64.
Serving fits it on a small sample only (8192 rows by default); the
projection runs on the device."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class PCAModel:
    mean: np.ndarray  # [D]
    components: np.ndarray  # [K, D] rows = principal axes
    explained_variance: np.ndarray  # [K]


def fit_pca(train_rows: np.ndarray, num_components: Optional[int] = None) -> PCAModel:
    """``num_components=None`` keeps all components."""
    x = np.asarray(train_rows, dtype=np.float64)
    mean = x.mean(axis=0)
    _, s, vt = np.linalg.svd(x - mean, full_matrices=False)
    var = (s**2) / max(x.shape[0] - 1, 1)
    k = vt.shape[0] if num_components is None else min(num_components, vt.shape[0])
    return PCAModel(mean=mean, components=vt[:k], explained_variance=var[:k])
