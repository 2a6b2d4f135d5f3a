"""PNN, Gaussian Parzen windows (JAX ``classifiers/parzen.py``): mean-centred
features, score sum_t exp(-d_t / (2 D var)); the sequential variant adds 32
features a round, pruning below max / 1e9."""

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

VAR = 2e-5  # classification.cpp:190
OUTPUT_DIVIDOR = 1e9  # :185
DELTA_FEATURES = 32  # :182
NEG_INF = -1e30


def _variance(num_features: int) -> float:
    return VAR / 10 if num_features > 2000 else VAR  # :192-193


def _sq_dists(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Raw squared L2 [B, N]: ``|q|^2 + |t|^2 - 2 q.t`` in fp32."""
    return (q * q).sum(dim=1, keepdim=True) + (t * t).sum(dim=1)[None, :] - 2.0 * q @ t.T


def _class_log_sums(log_k: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """Per-class logsumexp of ``log_k`` [B, N] over the one-hot ``cls`` [N, C]; a class with no mass gets NEG_INF."""
    mx = log_k.max(dim=1, keepdim=True).values
    sums = torch.exp(log_k - mx) @ cls
    return torch.where(sums > 0, torch.log(torch.where(sums > 0, sums, 1.0)), NEG_INF) + mx


class PNNClassifier:
    def __init__(self, num_classes: int, bruteforce: bool = True, name: str = "PNN", device: DeviceLike = None):
        self.device = resolve_device(device)
        self.name = name + ("" if bruteforce else " (seq)")
        self.num_classes = num_classes
        self.bruteforce = bruteforce

    def _set(self, x: np.ndarray, y: np.ndarray, mean: np.ndarray, d: int):
        self._x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        self._y = torch.as_tensor(np.asarray(y, np.int64), device=self.device)
        self._mean = torch.as_tensor(np.asarray(mean).astype(np.float32), device=self.device)
        self._cls = torch.nn.functional.one_hot(self._y, self.num_classes).to(torch.float32)  # [N, C]
        self._d = d

    def fit(self, x_train: np.ndarray, y_train: np.ndarray):
        self._set(x_train, y_train, np.asarray(x_train, np.float64).mean(axis=0), x_train.shape[1])
        return self

    def _queries(self, queries: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(queries, np.float32), device=self.device) - self._mean

    def _predict_bf(self, queries: np.ndarray) -> np.ndarray:
        var_scale = 2.0 * self._d * _variance(self._d)
        d = _sq_dists(self._queries(queries), self._x - self._mean)
        scores = _class_log_sums(-d / torch.tensor(var_scale, dtype=torch.float32), self._cls)
        return torch.argmax(scores, dim=1).to(torch.int32).cpu().numpy()

    def _predict_sequential(self, queries: np.ndarray) -> np.ndarray:
        """Chunked accumulation with class pruning (:228-295)."""
        q = self._queries(queries)
        t = self._x - self._mean
        b = q.shape[0]
        var = _variance(self._d)
        dev = q.device
        active = torch.ones((b, self.num_classes), dtype=torch.bool, device=dev)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        best = torch.zeros((b,), dtype=torch.int64, device=dev)
        dist = torch.zeros((b, t.shape[0]), dtype=torch.float32, device=dev)
        for start in range(0, self._d, DELTA_FEATURES):
            end = min(start + DELTA_FEATURES, self._d)
            dist = dist + torch.where(done[:, None], 0.0, _sq_dists(q[:, start:end], t[:, start:end]))
            log_scores = _class_log_sums(-dist / torch.tensor(2.0 * var * end, dtype=torch.float32), self._cls)
            log_scores = torch.where(active, log_scores, NEG_INF)
            best = torch.where(done, best, torch.argmax(log_scores, dim=1))
            max_score = log_scores.max(dim=1, keepdim=True).values
            keep = (log_scores >= max_score - np.log(OUTPUT_DIVIDOR)) & active
            round_done = keep.sum(dim=1) == 1
            active = torch.where(done[:, None], active, keep)
            done = done | round_done
        return best.to(torch.int32).cpu().numpy()

    def predict(self, queries: np.ndarray) -> np.ndarray:
        if self.bruteforce:
            return self._predict_bf(queries)
        return self._predict_sequential(queries)


def k_medoids_per_class(x: np.ndarray, y: np.ndarray, num_classes: int, num_clusters: int = 5, iterations: int = 100
) -> np.ndarray:
    """Per-class k-medoids (classification.cpp:320-388), float64 on the host: prototype rows of x."""
    selected = []
    for c in range(num_classes):
        members = np.flatnonzero(y == c)
        n = members.size
        if n <= num_clusters:
            selected.extend(members.tolist())
            continue
        rows = np.asarray(x[members], np.float64)
        # full pairwise distance matrix, mean over features (:341-343)
        sq = (rows**2).sum(1)
        dmat = (sq[:, None] + sq[None, :] - 2.0 * rows @ rows.T) / rows.shape[1]
        medoids = np.arange(num_clusters)
        for _ in range(iterations):
            assign = np.argmin(dmat[:, medoids], axis=1)
            new_medoids = medoids.copy()
            for ci in range(num_clusters):
                mask = assign == ci
                if not mask.any():
                    continue
                within = dmat[np.ix_(mask, mask)].sum(axis=1)
                new_medoids[ci] = np.flatnonzero(mask)[np.argmin(within)]
            if (new_medoids == medoids).all():
                break
            medoids = new_medoids
        selected.extend(members[medoids].tolist())
    return np.asarray(selected, dtype=np.int64)


class PNNWithClusteringClassifier(PNNClassifier):
    """'PNN with clustering, <k>' (classification.cpp:311-428)."""

    def __init__(self, num_classes: int, num_clusters: int = 5, device: DeviceLike = None):
        super().__init__(num_classes, bruteforce=True, name=f"PNN with clustering, {num_clusters}", device=device)
        self.num_clusters = num_clusters

    def fit(self, x_train: np.ndarray, y_train: np.ndarray):
        proto = k_medoids_per_class(x_train, y_train, self.num_classes, self.num_clusters)
        # the mean is still the full training set's (:404-411)
        self._set(x_train[proto], y_train[proto], np.asarray(x_train, np.float64).mean(axis=0), x_train.shape[1])
        return self
