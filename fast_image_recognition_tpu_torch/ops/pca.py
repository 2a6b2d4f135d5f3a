"""PCA (JAX ``ops/pca.py``): thin SVD of the centred rows in float64 on the
host; ``save``/``load`` in JAX's npz layout."""

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


@dataclasses.dataclass
class PCAModel:
    mean: np.ndarray  # [D]
    components: np.ndarray  # [K, D] rows = principal axes
    explained_variance: np.ndarray  # [K]

    def project(self, x) -> np.ndarray:
        """``(x - mean) @ components.T`` in float64."""
        return (np.asarray(x, dtype=np.float64) - self.mean) @ self.components.T

    def project_device(self, x, device: DeviceLike = None) -> torch.Tensor:
        """The same in fp32 on ``x``'s device if a tensor, else on ``device`` (default the card)."""
        dev = x.device if isinstance(x, torch.Tensor) and device is None else resolve_device(device)
        x = torch.as_tensor(x).to(dev, torch.float32)
        mean, comps = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (self.mean, self.components))
        return (x - mean) @ comps.T

    def save(self, path: str) -> None:
        np.savez(path, mean=self.mean, components=self.components, explained_variance=self.explained_variance)

    @staticmethod
    def load(path: str) -> "PCAModel":
        z = np.load(path)
        return PCAModel(z["mean"], z["components"], z["explained_variance"])


def fit_pca(train_rows: np.ndarray, num_components: Optional[int] = None) -> PCAModel:
    """``num_components=None`` keeps all components."""
    x = np.asarray(train_rows, dtype=np.float64)
    mean = x.mean(axis=0)
    _, s, vt = np.linalg.svd(x - mean, full_matrices=False)
    var = (s**2) / max(x.shape[0] - 1, 1)
    k = vt.shape[0] if num_components is None else min(num_components, vt.shape[0])
    return PCAModel(mean=mean, components=vt[:k], explained_variance=var[:k])
