"""FPNN, PNN with an orthogonal-series (truncated Fourier) kernel
(counterpart of ``fast_image_recognition_tpu/classifiers/fpnn.py``;
qt_cpp/classification.cpp:618-791, arXiv:1708.02733).

- normalization ``scale * (x - mean) / std`` (0 where std == 0), clipped to
  +-0.5 (:637-657);
- fit (:661-696): per (feature, class) ``a_cos[j] = sum cos(pi (j+1) v) /
  n_c * (J-j)/(J(J+1))`` and ``a_sin`` alike, ``J = max(3, ceil((n / C)^(1/3)))``;
- predict (:698-735): class score = sum over features of
  ``fasterlog2(0.5 + sum_j (a_cos cos + a_sin sin))``; the sequential
  variant (:736-791) adds 32 features a round and prunes classes below
  ``max + log2(output_ratio) * features_so_far``.

The predict contracts with fp32 batched matmuls (TF32 off); the fit sums
each class's rows. The fit runs in class blocks and the brute-force
predict in feature blocks, which bounds the [N, D, J] and [B, D, C]
temporaries the JAX package makes whole.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fast_image_recognition_tpu_torch.device import DeviceLike, resolve_device
from fast_image_recognition_tpu_torch.ops.fastmath import fasterlog2, fasterlog2_np

DELTA_FEATURES = 32  # shared with PNN (classification.cpp:182)
NEG_INF = -1e30
MAX_VAL = 0.5  # clip bound (:652-656)
_FIT_ELEMS = 1 << 26  # [classes, rows, features, J] elements per block of the fit
_PREDICT_ELEMS = 1 << 26  # [B, features, C] elements per block of the brute-force predict


def _normalize(x, mean, std, scale):
    safe = torch.where(std != 0, std, 1.0)
    v = torch.where(std != 0, scale * (x - mean) / safe, 0.0)
    return torch.clamp(v, -MAX_VAL, MAX_VAL)


def _angles(v: torch.Tensor, j_terms: int) -> torch.Tensor:
    """``pi * v * (j+1)`` [..., D, J] in fp32, (j+1) = 1..J."""
    j_idx = torch.arange(1, j_terms + 1, dtype=torch.float32, device=v.device)
    return torch.tensor(math.pi, dtype=torch.float32) * v[..., None] * j_idx


def _fit_coeffs(v: torch.Tensor, labels: torch.Tensor, j_terms: int, num_classes: int):
    """(a_cos, a_sin) [D, C, J] from normalized training rows [N, D]: each
    class's rows gathered (in row order, padded to the largest class with
    masked slots) and summed, a block of classes at a time (JAX: a one-hot
    [N, C] matmul, C times the work)."""
    n, d = v.shape
    counts = torch.bincount(labels, minlength=num_classes)
    starts = torch.cumsum(counts, 0) - counts
    order = torch.sort(labels, stable=True).indices
    m = max(1, int(counts.max()))
    slot = torch.arange(m, device=v.device)
    j = torch.arange(j_terms, dtype=torch.float32, device=v.device)
    w = (j_terms - j) / (j_terms * (j_terms + 1))  # (J-j)/(J(J+1))
    a_cos = torch.empty((num_classes, d, j_terms), dtype=torch.float32, device=v.device)
    a_sin = torch.empty_like(a_cos)
    step = max(1, _FIT_ELEMS // (m * d * j_terms))
    for c in range(0, num_classes, step):
        cnt = counts[c : c + step]
        take = (slot[None, :] < cnt[:, None]).to(torch.float32)[:, :, None, None]  # [cc, m, 1, 1]
        ang = _angles(v[order[(starts[c : c + step, None] + slot).clamp_max(n - 1)]], j_terms)  # [cc, m, D, J]
        scale = w / torch.clamp_min(cnt, 1).to(torch.float32)[:, None, None]
        a_cos[c : c + step] = (torch.cos(ang) * take).sum(dim=1) * scale
        a_sin[c : c + step] = (torch.sin(ang) * take).sum(dim=1) * scale
    return a_cos.permute(1, 0, 2).contiguous(), a_sin.permute(1, 0, 2).contiguous()


def _density_logs(v: torch.Tensor, a_cos: torch.Tensor, a_sin: torch.Tensor) -> torch.Tensor:
    """[B, Ds] values, [Ds, C, J] coefficients -> [B, C] summed log2-densities."""
    ang = _angles(v, a_cos.shape[-1]).permute(1, 0, 2)  # [Ds, B, J]
    probab = 0.5 + torch.bmm(torch.cos(ang), a_cos.transpose(1, 2)) + torch.bmm(torch.sin(ang), a_sin.transpose(1, 2))
    return fasterlog2(probab).sum(dim=0)  # [Ds, B, C] -> [B, C]


class FPNNClassifier:
    """'FPNN, <scale>' / '(seq)' naming mirrors classification.cpp:620-621."""

    def __init__(
        self,
        num_classes: int,
        features_scale: float = 1.0,
        bruteforce: bool = True,
        output_ratio: float = 0.9,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        suffix = "" if bruteforce else " (seq)"
        self.name = f"FPNN, {features_scale}{suffix}"
        self.num_classes = num_classes
        self.features_scale = features_scale
        self.bruteforce = bruteforce
        self.output_ratio = output_ratio
        # output_delta = fastlog(output_ratio) (:621), fasterlog2 base
        self.output_delta = float(fasterlog2_np(np.asarray([output_ratio], np.float32))[0])

    def fit(self, x_train: np.ndarray, y_train: np.ndarray):
        x64 = np.asarray(x_train, np.float64)
        n, d = x64.shape
        mean = x64.mean(axis=0)
        if n > 1:
            s2 = (x64**2).sum(axis=0)
            var = (s2 - mean * mean * n) / (n - 1)
            std = np.sqrt(np.maximum(var, 0.0))
        else:
            std = np.zeros_like(mean)
        self._mean = torch.as_tensor(mean.astype(np.float32), device=self.device)
        self._std = torch.as_tensor(std.astype(np.float32), device=self.device)
        j_terms = int(np.ceil((n / self.num_classes) ** (1.0 / 3.0)))
        self.j_terms = max(j_terms, 3)  # min_J (:673-675)
        v = self._normalized(x_train)
        y = torch.as_tensor(np.asarray(y_train, np.int64), device=self.device)
        self._a_cos, self._a_sin = _fit_coeffs(v, y, self.j_terms, self.num_classes)
        self._d = d
        return self

    def _normalized(self, x: np.ndarray) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        return _normalize(x, self._mean, self._std, self.features_scale)

    def _predict_bf(self, queries: np.ndarray) -> np.ndarray:
        v = self._normalized(queries)
        step = max(1, _PREDICT_ELEMS // max(1, v.shape[0] * self.num_classes))
        outputs = sum(_density_logs(v[:, s : s + step], self._a_cos[s : s + step], self._a_sin[s : s + step])
                      for s in range(0, self._d, step))
        return torch.argmax(outputs, dim=1).to(torch.int32).cpu().numpy()

    def _predict_sequential(self, queries: np.ndarray) -> np.ndarray:
        v = self._normalized(queries)
        b, dev = v.shape[0], v.device
        outputs = torch.zeros((b, self.num_classes), dtype=torch.float32, device=dev)
        active = torch.ones((b, self.num_classes), dtype=torch.bool, device=dev)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        best = torch.zeros((b,), dtype=torch.int64, device=dev)
        for start in range(0, self._d, DELTA_FEATURES):
            end = min(start + DELTA_FEATURES, self._d)
            contrib = _density_logs(v[:, start:end], self._a_cos[start:end], self._a_sin[start:end])
            # inactive classes stop accumulating (:757-767)
            outputs = outputs + torch.where(active & ~done[:, None], contrib, 0.0)
            masked = torch.where(active, outputs, NEG_INF)
            best = torch.where(done, best, torch.argmax(masked, dim=1))
            max_out = masked.max(dim=1, keepdim=True).values
            thresh = max_out + torch.tensor(self.output_delta * end, dtype=torch.float32)  # (:778)
            keep = (masked >= thresh) & active
            round_done = keep.sum(dim=1) == 1
            active = torch.where(done[:, None], active, keep)
            done = done | round_done
        return best.to(torch.int32).cpu().numpy()

    def predict(self, queries: np.ndarray) -> np.ndarray:
        if self.bruteforce:
            return self._predict_bf(queries)
        return self._predict_sequential(queries)


def fpnn_oracle_predict(
    query: np.ndarray,
    x_train: np.ndarray,
    y_train: np.ndarray,
    num_classes: int,
    features_scale: float = 1.0,
) -> int:
    """classification.cpp:661-735 in float64 with the cos/sin recurrence."""
    x64 = np.asarray(x_train, np.float64)
    n, d = x64.shape
    mean = x64.mean(axis=0)
    s2 = (x64**2).sum(axis=0)
    var = (s2 - mean * mean * n) / (n - 1)
    std = np.sqrt(np.maximum(var, 0.0))

    def norm(vals):
        v = np.where(std != 0, features_scale * (vals - mean) / np.where(std != 0, std, 1), 0.0)
        return np.clip(v, -0.5, 0.5)

    j_terms = max(int(np.ceil((n / num_classes) ** (1 / 3))), 3)
    a = np.zeros((d, num_classes, 2 * j_terms + 1))
    a[:, :, 0] = 0.5
    vtr = norm(x64)
    counts = np.bincount(y_train, minlength=num_classes)
    for t in range(n):
        c = y_train[t]
        for j in range(j_terms):
            wj = (1.0 / counts[c]) * (j_terms - j) / (j_terms * (j_terms + 1))
            a[:, c, 2 * j + 1] += np.cos(np.pi * (j + 1) * vtr[t]) * wj
            a[:, c, 2 * j + 2] += np.sin(np.pi * (j + 1) * vtr[t]) * wj

    v = norm(np.asarray(query, np.float64))
    outputs = np.zeros(num_classes, dtype=np.float32)
    cos_vals = np.zeros((d, j_terms))
    sin_vals = np.zeros((d, j_terms))
    cos_vals[:, 0] = np.cos(np.pi * v)
    sin_vals[:, 0] = np.sin(np.pi * v)
    for j in range(1, j_terms):
        cos_vals[:, j] = cos_vals[:, j - 1] * cos_vals[:, 0] - sin_vals[:, j - 1] * sin_vals[:, 0]
        sin_vals[:, j] = cos_vals[:, j - 1] * sin_vals[:, 0] + sin_vals[:, j - 1] * cos_vals[:, 0]
    for c in range(num_classes):
        probab = a[:, c, 0].copy()
        for j in range(j_terms):
            probab += a[:, c, 2 * j + 1] * cos_vals[:, j]
            probab += a[:, c, 2 * j + 2] * sin_vals[:, j]
        outputs[c] = fasterlog2_np(probab.astype(np.float32)).sum()
    return int(np.argmax(outputs))
