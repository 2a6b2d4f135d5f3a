"""Face verification (JAX ``evaluation/verification.py``;
ImageTesting.cpp:714-843): 10 splits, 1-NN on 256 dims over one [N, N] device
matrix; the Bayesian variants fit in float64 on the host."""

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..data.splits import train_test_split_images
from ..device import DeviceLike, resolve_device
from .harness import EvalResult
from ..ops.distances import pairwise_distances
from ..ops.pca import fit_pca


def full_pairwise_matrix(
    features: np.ndarray, end: int = 256, block: int = 2048, device: DeviceLike = None
) -> np.ndarray:
    """[N, N] L2 window-mean distances on the first ``end`` dims."""
    dev = resolve_device(device)
    n = features.shape[0]
    end = min(end, features.shape[1])
    feats = torch.as_tensor(np.ascontiguousarray(features[:, :end], np.float32), device=dev)
    out = np.empty((n, n), dtype=np.float32)
    for s in range(0, n, block):
        out[s : s + block] = pairwise_distances(feats[s : s + block], feats).cpu().numpy()
    return out


def verification_test(features: np.ndarray, labels: np.ndarray, tests: int = 10, end: int = 256, seed: int = 13,
    train_images_per_class: Optional[int] = None, train_fraction: float = 0.5, verbose: bool = True,
    device: DeviceLike = None) -> EvalResult:
    """10-split 1-NN verification (ImageTesting.cpp:778-843), the matrix on ``device``; sigma as :838-841."""
    import time

    dmat = full_pairwise_matrix(features, end=end, device=device)
    rng = np.random.default_rng(seed)
    errors = []
    t_total = 0.0
    for t in range(tests):
        split = train_test_split_images(labels, rng, train_images_per_class=train_images_per_class,
            train_fraction=train_fraction)
        t0 = time.perf_counter()
        sub = dmat[np.ix_(split.test_idx, split.train_idx)]
        best = sub.argmin(axis=1)
        preds = labels[split.train_idx][best]
        t_total += time.perf_counter() - t0
        err = 100.0 * (preds != labels[split.test_idx]).mean()
        errors.append(err)
        if verbose:
            print(f"test={t} error={err:.4g} dbSize={len(split.train_idx)} " f"testSize={len(split.test_idx)}")
    errors = np.asarray(errors)
    mean_err = errors.mean()
    sigma = (float(np.sqrt(max((np.sum(errors**2) - tests * mean_err**2) / (tests - 1), 0.0))) if tests > 1 else 0.0)
    result = EvalResult(name=f"verification(first {end} dims)", error_rate=float(mean_err), macro_recall=-1.0,
        ms_per_image=1000.0 * t_total / max(1, tests), checked_percent=100.0, extras={"sigma": sigma})
    if verbose:
        print(f"Avg error={mean_err:.4g} Sigma={sigma:.4g}")
    return result


# Joint Bayesian (ImageTesting.cpp:719-777): F = S_W^-1, G = -(2 S_mu + S_W)^-1
# S_mu F, A = (S_mu + S_W)^-1 - (F + G); r = x1'Ax1 + x2'Ax2 - 2 x1'G x2

@dataclasses.dataclass
class JointBayesianModel:
    A: np.ndarray  # [D, D]
    G: np.ndarray  # [D, D]


def fit_joint_bayesian(features: np.ndarray, labels: np.ndarray, ridge: float = 0.5) -> JointBayesianModel:
    """S_W and S_mu, each + ridge I (ImageTesting.cpp:725-758)."""
    feats = np.asarray(features, np.float64)
    labels = np.asarray(labels)
    d = feats.shape[1]
    means = []
    sw = np.zeros((d, d))
    within_count = 0
    for c in np.unique(labels):
        rows = feats[labels == c]
        mu = rows.mean(axis=0)
        means.append(mu)
        n = len(rows)
        if n > 1:
            cov = (rows - mu).T @ (rows - mu) / (n - 1)
            cov += np.eye(d) * ridge
            within_count += n
            sw += cov * n
    sw /= max(within_count, 1)
    u = np.stack(means)
    su = (u - u.mean(0)).T @ (u - u.mean(0)) / max(len(u) - 1, 1)
    su += np.eye(d) * ridge

    f = np.linalg.inv(sw)
    g = -np.linalg.inv(2 * su + sw) @ su @ f
    a = np.linalg.inv(su + sw) - (f + g)
    return JointBayesianModel(A=a, G=g)


def joint_bayesian_scores(
    model: JointBayesianModel, x1: np.ndarray, x2: np.ndarray, device: DeviceLike = None
) -> np.ndarray:
    """Pairwise log-likelihood-ratio scores on ``device``: r = x1'Ax1 + x2'Ax2 - 2 x1'G x2."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    a, g, q1, q2 = t(model.A), t(model.G), t(x1), t(x2)
    xax1 = (q1 * (q1 @ a)).sum(dim=1)  # [B1]
    xax2 = (q2 * (q2 @ a)).sum(dim=1)  # [B2]
    cross = q1 @ g @ q2.T  # [B1, B2]
    return (xax1[:, None] + xax2[None, :] - 2.0 * cross).cpu().numpy()


def joint_bayesian_verification(model: JointBayesianModel, gallery: np.ndarray, gallery_labels: np.ndarray,
    probes: np.ndarray, probe_labels: np.ndarray, device: DeviceLike = None) -> float:
    """1-NN by max joint-Bayesian similarity; returns error %."""
    scores = joint_bayesian_scores(model, probes, gallery, device=device)
    preds = np.asarray(gallery_labels)[scores.argmax(axis=1)]
    return float(100.0 * (preds != np.asarray(probe_labels)).mean())


# Bayesian within-class metric (the #if 0 variant, ImageTesting.cpp:553-712)

@dataclasses.dataclass
class BayesianMetric:
    pca_components: np.ndarray  # [K, D] within-class difference basis
    inv_covar: np.ndarray  # [K, K]

    def project(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x, np.float64) @ self.pca_components.T


def fit_bayesian_metric(features: np.ndarray, labels: np.ndarray, num_components: int = 96, ridge: float = 0.9,
    seed: int = 0) -> BayesianMetric:
    """Within-class difference PCA + regularized inverse covariance (ImageTesting.cpp:567-599)."""
    rng = np.random.default_rng(seed)
    diffs = []
    for c in np.unique(labels):
        members = np.flatnonzero(labels == c)
        if members.size < 2:
            continue
        for i in members:
            j = i
            while j == i:
                j = members[rng.integers(members.size)]
            diffs.append(features[i].astype(np.float64) - features[j])
    diffs = np.stack(diffs)
    pca = fit_pca(diffs, num_components=num_components)
    proj = (diffs - 0.0) @ pca.components.T  # reference projects raw diffs
    covar = proj.T @ proj / len(proj)
    covar += np.eye(covar.shape[0]) * ridge
    return BayesianMetric(pca_components=pca.components, inv_covar=np.linalg.inv(covar))


def mahalanobis_verification(metric: BayesianMetric, gallery: np.ndarray, gallery_labels: np.ndarray,
    probes: np.ndarray, probe_labels: np.ndarray, device: DeviceLike = None) -> float:
    """1-NN by (x-y)^T inv_covar (x-y) in the projected space (ImageTesting.cpp:672-704): error %."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    a, gq, qq = t(metric.inv_covar), t(metric.project(gallery)), t(metric.project(probes))
    # (x-y)^T A (x-y) = x^T A x + y^T A y - 2 x^T A y  (A symmetric)
    ag = gq @ a  # [N, K]
    xa = (qq * (qq @ a)).sum(dim=1)  # [B]
    ya = (gq * ag).sum(dim=1)  # [N]
    cross = qq @ ag.T  # [B, N]
    d = xa[:, None] + ya[None, :] - 2.0 * cross
    preds = gallery_labels[torch.argmin(d, dim=1).cpu().numpy()]
    return float(100.0 * (preds != probe_labels).mean())
