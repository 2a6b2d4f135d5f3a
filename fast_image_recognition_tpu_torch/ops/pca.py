"""PCA fit on the host (JAX ``ops/pca.py`` ``fit_pca``, ``PCAModel``): thin
SVD of the centred rows in float64, on a sample; projection on the device."""

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
