"""Exact 1-NN over the full gallery (counterpart of
``fast_image_recognition_tpu/search/brute_force.py``).

Reference: the scalar linear scan in qt_cpp/db_features.cpp:319-335 and
qt_cpp/ann.cpp:113-126, with the optional feature-prefix truncation
``max_features``. Here the scan is one batched device computation: the
[B, N] distance block (``ops/distances.py``) and its argmin; chi2/KL over
galleries above ``STREAM_THRESHOLD`` rows go through the streamed tile
scan, and ``precision='int8'`` through the int8 tile-scan kernel with an
exact rescore. As in the JAX package, chi2 does not go to the chi2 kernel
(``ops/chi2_kernel.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fast_image_recognition_tpu_torch.config import DistanceKind
from fast_image_recognition_tpu_torch.device import DeviceLike, resolve_device
from fast_image_recognition_tpu_torch.ops.distances import pairwise_distances, streamed_topk
from fast_image_recognition_tpu_torch.search.base import SearchResult

# Above this many gallery rows, chi2/KL go through the streamed scan-with-
# running-top-k path instead of materializing a [B, N] score matrix.
STREAM_THRESHOLD = 65536


def _top1(queries: torch.Tensor, gallery: torch.Tensor, kind: DistanceKind, max_features: Optional[int], precise: bool):
    end = max_features if max_features else queries.shape[-1]
    d = pairwise_distances(queries, gallery, start=0, end=end, kind=kind, precise=precise)
    idx = torch.argmin(d, dim=1)  # the first (lowest) row at the minimum
    best = d.gather(1, idx[:, None])[:, 0]
    return idx.to(torch.int32), best


class BruteForceMatcher:
    """Exact 1-NN (name "BF" in the reference printouts, ann.h:45). The
    gallery lives on ``device`` (default: the card), which takes the place
    of the JAX package's ``device_resident``; ``search`` takes and returns
    host arrays."""

    def __init__(
        self,
        gallery_features: np.ndarray,
        kind: DistanceKind = DistanceKind.L2,
        max_features: Optional[int] = None,
        precise: bool = True,
        precision: str = "fp32",
        device: DeviceLike = None,
    ):
        self.name = f"BF, {max_features}" if max_features else "BF"
        self.kind = kind
        self.max_features = max_features
        self.precise = precise
        self.precision = precision
        self.device = resolve_device(device)
        gal = torch.as_tensor(np.asarray(gallery_features, dtype=np.float32), device=self.device)
        self._n = gal.shape[0]
        if precision == "int8":
            # Quantized scan (L2 only): int8 rows on the int8 tile-scan
            # kernel, exact rescore of the best row of each of the 16
            # nearest tiles from bf16 rows (ops/distance_kernel.py).
            if kind != DistanceKind.L2 or max_features:
                raise ValueError("precision='int8' supports full-feature L2 only")
            from fast_image_recognition_tpu_torch.ops.distance_kernel import (
                gallery_sq_norms,
                pad_cols,
                pad_gallery,
                quant_gallery_scales,
            )
            from fast_image_recognition_tpu_torch.ops.quant import quantize_rows

            self.name = "BF-int8"
            # columns padded once for the card's 16-byte int8 loads (zeros
            # change no value, scale or dot product)
            q8, scales = quantize_rows(pad_cols(gal))
            self._gal_q = pad_gallery(q8)
            self._gsq = gallery_sq_norms(gal, self._n)
            self._gsc = quant_gallery_scales(scales, self._n)
            self.gallery = pad_gallery(gal.to(torch.bfloat16))
            return
        self.gallery = gal

    def set_budget(self, image_count_to_check: int) -> None:
        pass  # exact method: budget has no meaning

    def search(self, queries: np.ndarray) -> SearchResult:
        q = torch.as_tensor(np.asarray(queries, dtype=np.float32), device=self.device)
        if self.precision == "int8":
            from fast_image_recognition_tpu_torch.ops.distance_kernel import topk_l2_quant

            best, idx = topk_l2_quant(q, self._gal_q, self._gsq, self._gsc, self.gallery, k=1)
            best, idx = best[:, 0], idx[:, 0].to(torch.int32)
        elif self.kind != DistanceKind.L2 and self._n > STREAM_THRESHOLD:
            end = self.max_features or q.shape[-1]
            best, idx = streamed_topk(q, self.gallery, k=1, end=end, kind=self.kind)
            best, idx = best[:, 0], idx[:, 0]
        else:
            idx, best = _top1(q, self.gallery, self.kind, self.max_features, self.precise)
        return SearchResult(
            indices=idx.cpu().numpy(),
            distances=best.cpu().numpy(),
            checked_fraction=np.ones(q.shape[0], dtype=np.float32),
        )
