"""Exact 1-NN (JAX ``search/brute_force.py``): the distance block's argmin;
chi2/KL above ``STREAM_THRESHOLD`` rows streamed; ``precision='int8'`` on the
int8 scan, rescored exactly."""

from typing import Optional

import numpy as np
import torch

from ..config import DistanceKind
from ..device import DeviceLike, resolve_device
from ..ops.distances import pairwise_distances, streamed_topk
from .base import SearchResult

# above this many rows chi2/KL stream tiles instead of a [B, N] block
STREAM_THRESHOLD = 65536


def _top1(queries: torch.Tensor, gallery: torch.Tensor, kind: DistanceKind, max_features: Optional[int], precise: bool):
    end = max_features if max_features else queries.shape[-1]
    d = pairwise_distances(queries, gallery, start=0, end=end, kind=kind, precise=precise)
    idx = torch.argmin(d, dim=1)  # the first (lowest) row at the minimum
    best = d.gather(1, idx[:, None])[:, 0]
    return idx.to(torch.int32), best


class BruteForceMatcher:
    """Exact 1-NN ("BF"), the gallery on ``device``; ``search`` takes and returns host arrays."""

    def __init__(self, gallery_features: np.ndarray, kind: DistanceKind = DistanceKind.L2,
        max_features: Optional[int] = None, precise: bool = True, precision: str = "fp32", device: DeviceLike = None):
        self.name = f"BF, {max_features}" if max_features else "BF"
        self.kind = kind
        self.max_features = max_features
        self.precise = precise
        self.precision = precision
        self.device = resolve_device(device)
        gal = torch.as_tensor(np.asarray(gallery_features, dtype=np.float32), device=self.device)
        self._n = gal.shape[0]
        if precision == "int8":
            # int8 (L2 only): the int8 tile scan,
            # kernel, exact rescore of the best row of each of the 16
            # nearest tiles from bf16 rows (ops/distance_kernel.py).
            if kind != DistanceKind.L2 or max_features:
                raise ValueError("precision='int8' supports full-feature L2 only")
            from ..ops.distance_kernel import gallery_sq_norms, pad_cols, pad_gallery, quant_gallery_scales
            from ..ops.quant import quantize_rows

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
            from ..ops.distance_kernel import topk_l2_quant

            best, idx = topk_l2_quant(q, self._gal_q, self._gsq, self._gsc, self.gallery, k=1)
            best, idx = best[:, 0], idx[:, 0].to(torch.int32)
        elif self.kind != DistanceKind.L2 and self._n > STREAM_THRESHOLD:
            end = self.max_features or q.shape[-1]
            best, idx = streamed_topk(q, self.gallery, k=1, end=end, kind=self.kind)
            best, idx = best[:, 0], idx[:, 0]
        else:
            idx, best = _top1(q, self.gallery, self.kind, self.max_features, self.precise)
        return SearchResult(indices=idx.cpu().numpy(), distances=best.cpu().numpy(),
            checked_fraction=np.ones(q.shape[0], dtype=np.float32))
