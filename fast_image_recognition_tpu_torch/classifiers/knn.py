"""k-NN with a first-to-K-votes decision (JAX ``classifiers/knn.py``;
qt_cpp/classification.cpp:108-170): mean-centered L2 distances, sorted;
the first class to reach K votes wins."""

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

_QUERY_BLOCK = 256  # queries per [B, N] block (distances, sort and votes)


def _knn_predict(queries, train, labels, mean, k: int, num_classes: int) -> torch.Tensor:
    """[B] int32: the first sorted position where a class reaches K votes (ranks by a stable sort); none: 0, as JAX."""
    q = queries - mean
    t = train - mean
    d = ((q * q).sum(dim=1, keepdim=True) + (t * t).sum(dim=1)[None, :] - 2.0 * q @ t.T) / q.shape[1]
    n = d.shape[1]
    order = torch.sort(d, dim=1, stable=True).indices  # [B, N] ascending
    ls = labels[order]  # [B, N] labels in distance order
    grp = torch.sort(ls, dim=1, stable=True)  # each class's positions, ascending
    pos = torch.arange(n, device=d.device).expand_as(ls)
    new = torch.ones_like(ls, dtype=torch.bool)
    new[:, 1:] = grp.values[:, 1:] != grp.values[:, :-1]
    start = torch.cummax(torch.where(new, pos, 0), dim=1).values
    kth = torch.where(pos - start == k - 1, grp.indices, n)  # the K-th vote's position
    first = kth.min(dim=1, keepdim=True).values
    return torch.where(first[:, 0] < n, ls.gather(1, first.clamp_max(n - 1))[:, 0], 0).to(torch.int32)


class KNNClassifier:
    def __init__(self, k: int, num_classes: int, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.name = f"k-NN, {k}"
        self.k = k
        self.num_classes = num_classes

    def fit(self, x_train: np.ndarray, y_train: np.ndarray):
        self._x = torch.as_tensor(np.asarray(x_train, np.float32), device=self.device)
        self._y = torch.as_tensor(np.asarray(y_train, np.int64), device=self.device)
        self._mean = torch.as_tensor(np.asarray(x_train, np.float64).mean(axis=0).astype(np.float32),
                device=self.device)
        return self

    def predict(self, queries: np.ndarray) -> np.ndarray:
        q = torch.as_tensor(np.asarray(queries, np.float32), device=self.device)
        out = [_knn_predict(q[s : s + _QUERY_BLOCK], self._x, self._y, self._mean, self.k, self.num_classes)
               for s in range(0, q.shape[0], _QUERY_BLOCK)]
        return torch.cat(out).cpu().numpy()
