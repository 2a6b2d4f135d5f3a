"""Evaluation harness (JAX ``evaluation/harness.py``, NumPy):
``testSetRecognition`` (ann.cpp:94-109), ``testRecognitionMethod``
(ImageTesting.cpp:439-501) and ``getThreshold`` (ann.cpp:84-93)."""

import dataclasses
import time
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class EvalResult:
    name: str
    error_rate: float  # percent
    macro_recall: float  # percent
    ms_per_image: float
    checked_percent: float  # average % of gallery probed (-1 if untracked)
    unreliable_percent: float = 0.0
    extras: dict = dataclasses.field(default_factory=dict)

    def summary(self) -> str:
        return (
            f"{self.name} error={self.error_rate:.4g}% "
            f"recall={self.macro_recall:.4g} "
            f"time(ms)={self.ms_per_image:.4g} "
            f"checkedPercent={self.checked_percent:.4g}"
        )


def get_threshold(other_class_dists: np.ndarray, false_accept_rate: float) -> float:
    """FAR quantile via partial selection (ann.cpp:84-93)."""
    d = np.asarray(other_class_dists)
    ind = int(d.size * false_accept_rate)
    return float(np.partition(d, ind)[ind])


def macro_recall_percent(true_labels: np.ndarray, pred_labels: np.ndarray, num_classes: int) -> float:
    """Per-class averaged recall over classes present in the probe set (ImageTesting.cpp:475-484)."""
    recall_sum = 0.0
    present = 0
    for c in range(num_classes):
        mask = true_labels == c
        cnt = int(mask.sum())
        if cnt:
            recall_sum += 100.0 * (pred_labels[mask] == c).sum() / cnt
            present += 1
    return recall_sum / present if present else 0.0


def evaluate_matcher(matcher, gallery_labels: np.ndarray, probe_features: np.ndarray, probe_labels: np.ndarray,
    num_classes: Optional[int] = None, batch_size: int = 1024, verbose: bool = True, warmup: bool = True) -> EvalResult:
    """testSetRecognition (ann.cpp:94-109), batched; ``warmup``: a throwaway batch first."""
    gallery_labels = np.asarray(gallery_labels)
    probe_labels = np.asarray(probe_labels)
    n = probe_features.shape[0]
    if num_classes is None:
        num_classes = int(max(gallery_labels.max(), probe_labels.max())) + 1
    if warmup:
        matcher.search(probe_features[: min(n, batch_size)])

    preds = np.full(n, -1, dtype=np.int64)
    checked = np.zeros(n, dtype=np.float64)
    t0 = time.perf_counter()
    for s in range(0, n, batch_size):
        q = probe_features[s : s + batch_size]
        res = matcher.search(q)
        ok = res.indices >= 0
        preds[s : s + batch_size][ok] = gallery_labels[res.indices[ok]]
        checked[s : s + batch_size] = res.checked_fraction
    elapsed = time.perf_counter() - t0

    errors = (preds != probe_labels).sum()
    result = EvalResult(name=getattr(matcher, "name", type(matcher).__name__), error_rate=100.0 * errors / n,
        macro_recall=macro_recall_percent(probe_labels, preds, num_classes), ms_per_image=1000.0 * elapsed / n,
        checked_percent=float(100.0 * checked.mean()))
    if verbose:
        print(result.summary())
    return result


def evaluate_classifier(name: str, predict: Callable[[np.ndarray], np.ndarray], probe_features: np.ndarray,
    probe_labels: np.ndarray, num_classes: int, unreliable_count: Optional[Callable[[], int]] = None,
    verbose: bool = True) -> EvalResult:
    """Classifier flavour: predict() maps [B, D] -> class labels [B]."""
    probe_labels = np.asarray(probe_labels)
    n = probe_features.shape[0]
    t0 = time.perf_counter()
    preds = np.asarray(predict(probe_features))
    elapsed = time.perf_counter() - t0
    errors = (preds != probe_labels).sum()
    unreliable = unreliable_count() if unreliable_count else 0
    result = EvalResult(name=name, error_rate=100.0 * errors / n,
        macro_recall=macro_recall_percent(probe_labels, preds, num_classes), ms_per_image=1000.0 * elapsed / n,
        checked_percent=-1.0, unreliable_percent=100.0 * unreliable / n)
    if verbose:
        print(result.summary())
    return result


def repeated_splits_eval(run_one: Callable[[int], EvalResult], tests: int = 2, verbose: bool = True) -> EvalResult:
    """Aggregate of repeated random splits, the reference's sigma (ImageTesting.cpp:439-501)."""
    results = [run_one(t) for t in range(tests)]
    err = np.array([r.error_rate for r in results])
    rec = np.array([r.macro_recall for r in results])
    ms = np.array([r.ms_per_image for r in results])
    mean_err = err.mean()
    if tests > 1:
        sigma = float(np.sqrt(max((np.sum(err**2) - tests * mean_err**2) / (tests - 1), 0.0)))
    else:
        sigma = 0.0
    agg = EvalResult(name=results[0].name, error_rate=float(mean_err), macro_recall=float(rec.mean()),
        ms_per_image=float(ms.mean()), checked_percent=float(np.mean([r.checked_percent for r in results])),
        unreliable_percent=float(np.mean([r.unreliable_percent for r in results])), extras={"sigma": sigma})
    if verbose:
        print(
            f"Avg error={agg.error_rate:.4g} Sigma={sigma:.4g} "
            f"recall={agg.macro_recall:.4g} time(ms)={agg.ms_per_image:.4g}"
        )
    return agg
