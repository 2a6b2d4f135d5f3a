"""Multi-exit cascade policies over per-level embeddings (JAX
``cascade/exits.py``): kNN, LinearSVC, entropy and max-softmax exits."""

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


# Per-level linear classifier (SVC-style decision values)


def svc_step(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor, targets: torch.Tensor, lr: float, reg: float):
    """A step of ``mean_n sum_c max(0, 1 - t s)^2 + reg |w|^2``, ``s = x w^T + b``: (w, b)."""
    scores = x @ w.T + b
    hinge = torch.clamp_min(1.0 - targets * scores, 0.0)
    g_scores = -2.0 * hinge * targets / x.shape[0]
    g_w = g_scores.T @ x + 2.0 * reg * w
    return w - lr * g_w, b - lr * g_scores.sum(dim=0)


def svc_descent(x: np.ndarray, y: np.ndarray, num_classes: int, w0: np.ndarray, b0: np.ndarray, steps: int = 200,
    lr: float = 0.05, reg: float = 1e-4, device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
    """``steps`` of :func:`svc_step` (one-vs-rest, fp32) from (w0, b0)."""
    dev = resolve_device(device)
    xt = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    yt = torch.as_tensor(np.asarray(y), dtype=torch.int64).to(dev)
    targets = (yt[:, None] == torch.arange(num_classes, device=dev)[None, :]).to(torch.float32) * 2.0 - 1.0
    w = torch.tensor(np.asarray(w0, np.float32)).to(dev)
    b = torch.tensor(np.asarray(b0, np.float32)).to(dev)
    for _ in range(steps):
        w, b = svc_step(w, b, xt, targets, lr, reg)
    return w.cpu().numpy(), b.cpu().numpy()


def train_linear_svc(x: np.ndarray, y: np.ndarray, num_classes: int, use_sklearn: bool = True, steps: int = 200,
    lr: float = 0.05, reg: float = 1e-4, seed: int = 0, device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
    """(coef, intercept) one-vs-rest: scikit-learn's ``LinearSVC`` where installed, else :func:`svc_descent`."""
    if use_sklearn:
        try:
            from sklearn.svm import LinearSVC

            svc = LinearSVC()
            svc.fit(x, y)
            coef, intercept = svc.coef_, svc.intercept_
            if coef.shape[0] == 1 and num_classes == 2:
                coef = np.vstack([-coef, coef])
                intercept = np.concatenate([-intercept, intercept])
            return coef.astype(np.float32), intercept.astype(np.float32)
        except ImportError:
            pass
    gen = torch.Generator().manual_seed(int(seed))
    w0 = torch.randn((num_classes, np.shape(x)[1]), generator=gen) * 0.01
    w, b = svc_descent(x, y, num_classes, w0.numpy(), np.zeros(num_classes, np.float32), steps, lr, reg, device)
    return w.astype(np.float32), b.astype(np.float32)


def tune_far_threshold(decision_values: np.ndarray, y: np.ndarray, far: float = 0.01) -> float:
    """Per-level threshold (sequential_inference.py:609-631): correct predictions' max scores downward until
    the false accept rate exceeds ``far``."""
    predictions = decision_values.argmax(axis=1)
    max_vals = decision_values.max(axis=1)
    mistakes = max_vals[predictions != y]
    best_threshold = -1.0
    n = len(predictions)
    for threshold in sorted(max_vals[predictions == y])[::-1]:
        if (mistakes > threshold).sum() / n > far:
            if best_threshold == -1.0:
                best_threshold = threshold
            break
        best_threshold = threshold
    return float(best_threshold)


# Batched cascade evaluation


@dataclasses.dataclass
class CascadeResult:
    predictions: np.ndarray  # [B]
    exit_level: np.ndarray  # [B] level each probe exited at
    break_counts: np.ndarray  # [L] per-level exit fractions

    def summary(self) -> str:
        return f"average breaks per layer: {self.break_counts}"


def _finalize(preds_per_level, exit_masks, num_levels) -> CascadeResult:
    """Freeze each probe at its first firing level (the last always fires)."""
    b = preds_per_level[0].shape[0]
    exit_level = np.full(b, num_levels - 1, dtype=np.int64)
    decided = np.zeros(b, dtype=bool)
    preds = np.zeros(b, dtype=np.int64)
    for level in range(num_levels):
        fire = exit_masks[level] & ~decided
        preds[fire] = preds_per_level[level][fire]
        exit_level[fire] = level
        decided |= fire
    counts = np.bincount(exit_level, minlength=num_levels).astype(np.float64) / b
    return CascadeResult(preds, exit_level, counts)


@torch.no_grad()
def _knn_level(gallery: torch.Tensor, g_labels: torch.Tensor, queries: torch.Tensor, ratio: float):
    """One kNN level: ``2 - 2 x.q``; reliable when every row within ``d_min / ratio`` has the best label."""
    d = 2.0 - 2.0 * queries @ gallery.T
    best = torch.argmin(d, dim=1)
    d_min = d.gather(1, best[:, None])[:, 0]
    y_best = g_labels[best]
    within = d <= (d_min / ratio)[:, None]
    same = g_labels[None, :] == y_best[:, None]
    return y_best, (~within | same).all(dim=1)


def _levels_on(xs: Sequence[np.ndarray], dev: torch.device) -> List[torch.Tensor]:
    return [torch.as_tensor(np.asarray(x, np.float32)).to(dev) for x in xs]


def sequential_knn_cascade(x_train_levels: Sequence[np.ndarray], y_train: np.ndarray,
    x_val_levels: Sequence[np.ndarray], ratio: float = 0.8, device: DeviceLike = None) -> CascadeResult:
    """sequential_knn_tester (sequential_inference.py:483-508), batched."""
    dev = resolve_device(device)
    num_levels = len(x_train_levels)
    y_tr = torch.as_tensor(np.asarray(y_train), dtype=torch.int64).to(dev)
    preds, masks = [], []
    for level, (g, q) in enumerate(zip(_levels_on(x_train_levels, dev), _levels_on(x_val_levels, dev))):
        y_best, reliable = _knn_level(g, y_tr, q, ratio)
        reliable = reliable.cpu().numpy()
        preds.append(y_best.cpu().numpy())
        masks.append(np.ones_like(reliable) if level == num_levels - 1 else reliable)
    return _finalize(preds, masks, num_levels)


@dataclasses.dataclass
class LinearExitCascade:
    """A linear classifier a level, exiting on the max decision value (sequential_inference.py:587-686)."""

    coefs: List[np.ndarray]
    intercepts: List[np.ndarray]
    thresholds: List[float]

    @staticmethod
    def train(x_train_levels: Sequence[np.ndarray], y_train: np.ndarray, num_classes: int, far: float = 0.01,
        fixed_threshold: Optional[float] = None, use_sklearn: bool = True, seed: int = 42, device: DeviceLike = None
    ) -> "LinearExitCascade":
        """Per-level classifiers; non-final thresholds tuned on a held-out half to FAR <= ``far``."""
        num_levels = len(x_train_levels)
        coefs, intercepts, thresholds = [], [], []
        rng = np.random.default_rng(seed)
        for level in range(num_levels):
            x = np.asarray(x_train_levels[level], np.float32)
            threshold = fixed_threshold if fixed_threshold is not None else -1.0
            if level < num_levels - 1 and fixed_threshold is None:
                # the half split of model_selection.train_test_split (:611)
                idx = rng.permutation(len(y_train))
                half = len(idx) // 2
                tr, va = idx[:half], idx[half:]
                w, b = train_linear_svc(x[tr], y_train[tr], num_classes, use_sklearn, device=device)
                threshold = tune_far_threshold(x[va] @ w.T + b, y_train[va], far)
            w, b = train_linear_svc(x, y_train, num_classes, use_sklearn, device=device)
            coefs.append(w)
            intercepts.append(b)
            thresholds.append(float(threshold))
        return LinearExitCascade(coefs, intercepts, thresholds)

    @torch.no_grad()
    def evaluate(self, x_val_levels: Sequence[np.ndarray], device: DeviceLike = None) -> CascadeResult:
        dev = resolve_device(device)
        num_levels = len(self.coefs)
        preds, masks = [], []
        for level, x in enumerate(_levels_on(x_val_levels, dev)):
            w = torch.as_tensor(np.asarray(self.coefs[level], np.float32)).to(dev)
            b = torch.as_tensor(np.asarray(self.intercepts[level], np.float32)).to(dev)
            scores = x @ w.T + b
            preds.append(torch.argmax(scores, dim=1).cpu().numpy())
            fire = scores.amax(dim=1) > self.thresholds[level]
            masks.append(np.ones(x.shape[0], dtype=bool) if level == num_levels - 1 else fire.cpu().numpy())
        return _finalize(preds, masks, num_levels)


def entropy_exit_cascade(probs_per_level: Sequence[np.ndarray], threshold: float, mode: str = "entropy"
) -> CascadeResult:
    """BranchyNet (sequential_inference.py:1079-1165) in NumPy: ``'entropy'`` exits at entropy <=
    threshold, ``'max_prob'`` at max > threshold."""
    num_levels = len(probs_per_level)
    preds, masks = [], []
    for level, p in enumerate(probs_per_level):
        p = np.asarray(p, np.float64)
        if mode == "entropy":
            fire = -(p * np.log(np.clip(p, 1e-12, None))).sum(axis=1) <= threshold
        else:
            fire = p.max(axis=1) > threshold
        preds.append(p.argmax(axis=1))
        masks.append(np.ones_like(fire) if level == num_levels - 1 else fire)
    return _finalize(preds, masks, num_levels)


def knn_exits_with_final_classifier(x_train_levels: Sequence[np.ndarray], y_train: np.ndarray,
    x_val_levels: Sequence[np.ndarray], num_classes: int, ratio: float = 0.8, use_sklearn: bool = True,
    device: DeviceLike = None) -> CascadeResult:
    """kNN exits at levels 0..L-2, a LinearSVC at L-1 (sequential_inference.py:725-773)."""
    dev = resolve_device(device)
    num_levels = len(x_train_levels)
    w, b = train_linear_svc(np.asarray(x_train_levels[-1], np.float32), y_train, num_classes, use_sklearn, device=dev)
    y_tr = torch.as_tensor(np.asarray(y_train), dtype=torch.int64).to(dev)
    preds, masks = [], []
    gals, vals = _levels_on(x_train_levels[:-1], dev), _levels_on(x_val_levels[:-1], dev)
    for g, q in zip(gals, vals):
        y_best, reliable = _knn_level(g, y_tr, q, ratio)
        preds.append(y_best.cpu().numpy())
        masks.append(reliable.cpu().numpy())
    scores = np.asarray(x_val_levels[-1], np.float32) @ w.T + b
    preds.append(scores.argmax(axis=1))
    masks.append(np.ones(scores.shape[0], dtype=bool))
    return _finalize(preds, masks, num_levels)
