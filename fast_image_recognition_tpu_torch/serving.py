"""End-to-end recognition serving on the card (counterpart of
``fast_image_recognition_tpu/serving.py`` ``RecognitionService``).

One call per batch: the BN- and preprocess-folded backbone forward on raw
uint8 images, L2 normalization, and a 1-NN match against a
device-resident bf16 gallery.

- ``match='pca'`` with ``pca_scan='packed'`` and ``select='exact'``: a
  PCA-``pca_dim`` projection of the gallery is scanned by the certified
  packed tile-min-2 kernel (``kernels/packed_scan.cu``); the best row of
  each of the ``rescore`` nearest tiles is rescored in full D; probes whose
  rescored distance does not clear the certificate's lower bound by the
  ``escalate`` slack take the exact full-D scan (``kernels/topk_l2.cu``).
  Only those probes are scanned, and a batch that is certified whole skips
  the scan: the check costs one host sync.
- ``match='exact'``: the exact full-D scan for every probe.

Other modes of the JAX service (``int8``, ``sharded``, the f32/bf16/int8
PCA scans, approximate tile selection) raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from fast_image_recognition_tpu_torch.device import DeviceLike, resolve_device
from fast_image_recognition_tpu_torch.models.fold import make_serving_fn
from fast_image_recognition_tpu_torch.ops.distance_kernel import (
    pack_gallery_aug,
    pad_gallery,
    topk_candidates_l2_packed_cert,
    topk_l2,
)
from fast_image_recognition_tpu_torch.ops.pca import fit_pca

# gallery rows projected per step: bounds the bf16 temporaries of the fit
_PROJECTION_ROWS = 65536


def _normalize(emb: torch.Tensor) -> torch.Tensor:
    emb = emb.to(torch.float32)
    return emb / torch.clamp_min(torch.linalg.vector_norm(emb, dim=1, keepdim=True), 1e-30)


class RecognitionService:
    """Folded-backbone extract + device-resident gallery 1-NN.

    ``variables`` holds the numpy ``params``/``batch_stats`` of a checkpoint
    (or pass a built module as ``serving_fn``). ``gallery`` is ``[N, D]``
    host float rows (L2-normalized) or an already padded bf16 tensor on
    ``device`` (pass ``n_valid`` for the true row count). ``labels``
    (optional ``[N]``) makes :meth:`identify` return labels too. After each
    ``match='pca'`` call, ``last_escalated`` holds the ``[B]`` bool mask of
    the probes that took the exact scan. The defaults are the main path's
    (``bench.py --config e2e``): PCA-124, packed scan, rescore 48, slack 0.05.
    """

    def __init__(
        self,
        variables: Optional[Dict[str, Any]],
        info: Dict[str, Any],
        gallery,
        *,
        labels: Optional[np.ndarray] = None,
        resolution: Optional[int] = None,
        match: str = "pca",
        pca_dim: int = 124,
        rescore: int = 48,
        pca_scan: str = "packed",
        select: str = "exact",
        escalate: Optional[float] = 0.05,
        n_valid: Optional[int] = None,
        pca_sample: int = 8192,
        serving_fn: Optional[torch.nn.Module] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.resolution = int(resolution or info["resolution"])
        self.match = match
        self.rescore = int(rescore)
        if match not in ("pca", "exact"):
            raise NotImplementedError(f"match={match!r} is not ported yet")
        if match == "pca" and (pca_scan != "packed" or select != "exact" or escalate is None):
            raise NotImplementedError(
                "only match='pca' with pca_scan='packed', select='exact' and an "
                "escalate slack is ported"
            )
        self.serve = serving_fn if serving_fn is not None else make_serving_fn(
            variables, info, resolution=self.resolution, device=self.device
        )

        if isinstance(gallery, torch.Tensor) and gallery.dtype == torch.bfloat16:
            self.gallery = gallery.to(self.device)
            self.n_valid = int(n_valid if n_valid is not None else gallery.shape[0])
        else:
            g = torch.as_tensor(np.asarray(gallery, np.float32))
            self.n_valid = int(n_valid if n_valid is not None else g.shape[0])
            self.gallery = pad_gallery(g.to(self.device, torch.bfloat16))
        self.labels = None if labels is None else np.asarray(labels)
        self.escalate = float(escalate) if match == "pca" else None

        if match == "pca":
            # fit on a small host sample: only these rows leave the device
            m = min(self.n_valid, pca_sample)
            sample = self.gallery[:m].to(torch.float32).cpu().numpy()
            pca = fit_pca(sample, num_components=min(pca_dim, sample.shape[1]))
            self.pca_dim = int(pca.components.shape[0])
            self._mu = torch.tensor(pca.mean, dtype=torch.float32, device=self.device)
            self._w = torch.tensor(pca.components.T, dtype=torch.float32, device=self.device)
            mu16, w16 = self._mu.to(torch.bfloat16), self._w.to(torch.bfloat16)
            gal_pca = torch.empty(
                (self.gallery.shape[0], self.pca_dim), dtype=torch.bfloat16, device=self.device
            )
            for s in range(0, self.gallery.shape[0], _PROJECTION_ROWS):
                gal_pca[s : s + _PROJECTION_ROWS] = (
                    self.gallery[s : s + _PROJECTION_ROWS] - mu16
                ) @ w16
            self.gal_aug = pack_gallery_aug(gal_pca, self.n_valid)
            del gal_pca

    # ------------------------------------------------------------------ #

    def _certified(self, emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The PCA path before escalation: [B, D] fp32 normalized
        embeddings -> (cand [B, R] int64 rows, the rescored best row of
        each probe [B] int64, escalate mask [B] bool)."""
        qp = (emb - self._mu) @ self._w
        cand, bound = topk_candidates_l2_packed_cert(qp, self.gal_aug, self.pca_dim, self.rescore)
        cand = cand.to(torch.int64)
        # rescore in fp32 from bf16 rows (a bf16 einsum would round the
        # products' sum to bf16 and flip near-tie winners)
        rows = self.gallery[cand].to(torch.float32)  # [B, R, D]
        e16 = emb.to(torch.bfloat16).to(torch.float32)
        cross = torch.einsum("bd,brd->br", e16, rows)
        rsq = torch.einsum("brd,brd->br", rows, rows)
        d = rsq - 2.0 * cross  # + |q|^2, constant per probe
        best = torch.argmin(d, dim=1, keepdim=True)
        idx_fast = cand.gather(1, best)[:, 0]
        # certificate: the rescored best (true squared L2) must clear the
        # lower bound on every unscored row, with slack for bf16 operand
        # rounding and the 2^-13 key quantization
        qsq = (emb * emb).sum(dim=1)
        d1 = d.gather(1, best)[:, 0] + qsq
        slack = self.escalate
        esc = d1 + slack * qsq > (1.0 - slack) * bound
        return cand, idx_fast, esc

    def _match_emb(self, emb: torch.Tensor) -> torch.Tensor:
        """[B, D] fp32 normalized embeddings -> [B] int64 gallery rows."""
        if self.match == "exact":
            _, idx = topk_l2(emb, self.gallery, k=1, n_valid=self.n_valid)
            return idx[:, 0].to(torch.int64)
        _, idx, esc = self._certified(emb)
        self.last_escalated = esc
        if bool(esc.any()):
            rows_esc = esc.nonzero()[:, 0]
            _, ei = topk_l2(emb[rows_esc], self.gallery, k=1, n_valid=self.n_valid)
            idx = idx.index_put((rows_esc,), ei[:, 0].to(torch.int64))
        return idx

    @torch.no_grad()
    def embed(self, images) -> torch.Tensor:
        """Raw image batch -> L2-normalized ``[B, D]`` fp32 embeddings on
        the service device."""
        images = torch.as_tensor(images, device=self.device)
        return _normalize(self.serve(images)["embedding"])

    @torch.no_grad()
    def identify_device(self, images) -> torch.Tensor:
        """Raw uint8 NHWC image batch -> ``[B]`` int64 gallery rows on the
        device (the timing-loop surface)."""
        return self._match_emb(self.embed(images))

    def identify(self, images) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Raw image batch -> (gallery rows [B] int64, labels [B] or None)."""
        idx = self.identify_device(images).cpu().numpy()
        return idx, (None if self.labels is None else self.labels[idx])
