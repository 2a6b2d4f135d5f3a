"""End-to-end recognition serving on the card (counterpart of
``fast_image_recognition_tpu/serving.py``: ``RecognitionService``,
``CascadeRecognitionService``, ``make_tap_embed_fn``, ``build_service`` and
``build_cascade_service``).

``RecognitionService``: per batch the BN- and preprocess-folded backbone
on raw uint8 images, L2 normalization and a 1-NN match:

- ``match='pca'``: the best row of each of the ``rescore`` nearest tiles
  of a PCA-``pca_dim`` projection, rescored in full D. ``pca_scan``:
  ``'f32'`` (default) and ``'bf16'``, the tile-min scan
  (``kernels/tile_scan.cu``) with fp32 or bf16 scores; ``'int8'``, its
  int8 version; ``'packed'`` (bench.py's main path at PCA-124), the packed
  scans of ``kernels/packed_scan.cu``: with ``select='exact'`` and an
  ``escalate`` slack the min-2 scan certifies each probe and the rest take
  the exact scan (``kernels/topk_l2.cu``) in one masked launch, with no
  host sync; with ``escalate=None`` the single-min scan, uncertified.
- ``match='exact'``: the exact full-D scan.
- ``match='int8'``: the int8 full-D scan, the best rows of the
  ``min(rescore, 16)`` nearest tiles rescored.
- ``match='sharded'``: the gallery split over ``mesh``'s devices
  (``parallel/sharded_gallery.py``), each shard scanned on its device
  (``sharded_scan`` ``'exact'``, or ``'packed'``: PCA fit on the first
  ``pca_sample`` rows, tile_g 512, shard-local rescore), merged on the first.

``select='approx'`` (JAX ``lax.approx_min_k``) takes the exact selection,
as XLA does off the TPU, and turns the certificate off.

``CascadeRecognitionService``: the early-exit twin; the backbone runs in
segments ending at exit taps, the live probes are matched after each
(single-min packed scan, rescore) and exit when ``d1 < ratio^2 * d2``;
survivors are compacted into the next segment's static capacity. No host
sync per batch.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fast_image_recognition_tpu_torch.device import DeviceLike, resolve_device
from fast_image_recognition_tpu_torch.models.efficientnet import (
    backbone_info,
    block_plan,
    default_taps,
)
from fast_image_recognition_tpu_torch.models.fold import make_serving_fn
from fast_image_recognition_tpu_torch.models.inference import FoldedEfficientNet
from fast_image_recognition_tpu_torch.ops.distance_kernel import (
    gallery_sq_norms,
    pack_gallery_aug,
    pad_cols,
    pad_gallery,
    quant_gallery_scales,
    rescore_rows,
    topk_candidates_l2,
    topk_candidates_l2_packed,
    topk_candidates_l2_packed_cert,
    topk_candidates_l2_quant,
    topk_l2,
    topk_l2_quant,
)
from fast_image_recognition_tpu_torch.ops.pca import fit_pca
from fast_image_recognition_tpu_torch.ops.quant import quantize_rows

# gallery rows projected per step: bounds the bf16 temporaries of the fit
_PROJECTION_ROWS = 65536
_SHARD_TILE_G = 512  # the sharded scans' row tile (JAX serving.py:130, :279)


def _normalize(emb: torch.Tensor) -> torch.Tensor:
    emb = emb.to(torch.float32)
    return emb / torch.clamp_min(torch.linalg.vector_norm(emb, dim=1, keepdim=True), 1e-30)


def _device_gallery(gallery, n_valid: Optional[int], device: torch.device) -> Tuple[torch.Tensor, int]:
    """Host float rows -> padded bf16 rows on ``device``; a bf16 tensor is
    taken as already padded. Returns (gallery, n_valid)."""
    if isinstance(gallery, torch.Tensor) and gallery.dtype == torch.bfloat16:
        return gallery.to(device), int(n_valid if n_valid is not None else gallery.shape[0])
    g = torch.as_tensor(np.asarray(gallery, np.float32))
    n = int(n_valid if n_valid is not None else g.shape[0])
    return pad_gallery(g.to(device, torch.bfloat16)), n


def _pca_project(gallery: torch.Tensor, n_valid: int, pca_dim: int, pca_sample: int):
    """PCA fit on a small host sample of the gallery (only these rows
    leave the device) and the projection of every (padded) row in bf16:
    (pca_dim, mean [D] fp32, components [D, P] fp32, projected rows [Np, P]
    bf16)."""
    m = min(n_valid, pca_sample)
    sample = gallery[:m].to(torch.float32).cpu().numpy()
    pca = fit_pca(sample, num_components=min(pca_dim, sample.shape[1]))
    dev = gallery.device
    mu = torch.tensor(pca.mean, dtype=torch.float32, device=dev)
    w = torch.tensor(pca.components.T, dtype=torch.float32, device=dev)
    mu16, w16 = mu.to(torch.bfloat16), w.to(torch.bfloat16)
    gal_pca = torch.empty((gallery.shape[0], w.shape[1]), dtype=torch.bfloat16, device=dev)
    for s in range(0, gallery.shape[0], _PROJECTION_ROWS):
        gal_pca[s : s + _PROJECTION_ROWS] = (gallery[s : s + _PROJECTION_ROWS] - mu16) @ w16
    return int(w.shape[1]), mu, w, gal_pca


class RecognitionService:
    """Folded-backbone extract + device-resident gallery 1-NN.

    ``variables`` holds the numpy ``params``/``batch_stats`` of a checkpoint
    (or pass a built module as ``serving_fn``). ``gallery`` is ``[N, D]``
    host float rows (L2-normalized) or an already padded bf16 tensor on
    ``device`` (pass ``n_valid`` for the true row count). ``labels``
    (optional ``[N]``) makes :meth:`identify` return labels too. The
    defaults are the JAX package's: PCA-128, the fp32-score tile scan,
    rescore 48. ``escalate`` applies only to ``pca_scan='packed'`` with
    ``select='exact'`` (bench.py's main path passes ``pca_dim=124,
    pca_scan='packed'``); after each such call ``last_escalated`` holds
    the ``[B]`` bool mask of the probes that took the exact scan.
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
        pca_dim: int = 128,
        rescore: int = 48,
        pca_scan: str = "f32",
        select: str = "exact",
        escalate: Optional[float] = 0.05,
        n_valid: Optional[int] = None,
        pca_sample: int = 8192,
        serving_fn: Optional[torch.nn.Module] = None,
        sharded_scan: str = "exact",
        mesh=None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.resolution = int(resolution or info["resolution"])
        self.dim = int(info["embedding_dim"])
        self.match = match
        self.rescore = int(rescore)
        if match not in ("pca", "exact", "int8", "sharded"):
            raise ValueError(f"unknown match mode {match!r}")
        if match == "sharded" and sharded_scan not in ("exact", "packed"):
            raise ValueError(f"unknown sharded_scan {sharded_scan!r}")
        if match == "pca" and pca_scan not in ("packed", "f32", "bf16", "int8"):
            raise ValueError(f"unknown pca_scan {pca_scan!r}")
        if select not in ("exact", "approx"):
            raise ValueError(f"unknown select {select!r}")
        self.select = select
        self.serve = serving_fn if serving_fn is not None else make_serving_fn(
            variables, info, resolution=self.resolution, device=self.device
        )

        self.labels = None if labels is None else np.asarray(labels)
        if match == "sharded":
            self._build_sharded(gallery, n_valid, sharded_scan, mesh, pca_dim, pca_sample)
            self.escalate = None
            return
        self.gallery, self.n_valid = _device_gallery(gallery, n_valid, self.device)
        # the certificate exists only for the packed min-2 scan with the
        # exact selection (JAX serving.py:151-158)
        self.escalate = (
            float(escalate)
            if escalate is not None and match == "pca" and pca_scan == "packed" and select == "exact"
            else None
        )
        self.pca_scan = pca_scan

        if match == "pca":
            self.pca_dim, self._mu, self._w, gal_pca = _pca_project(
                self.gallery, self.n_valid, pca_dim, pca_sample
            )
            if pca_scan == "packed":
                self.gal_aug = pack_gallery_aug(gal_pca, self.n_valid)
            else:
                gal_pca = pad_cols(gal_pca)  # once, for the card's 16-byte loads
                self._gal_sq = gallery_sq_norms(gal_pca, self.n_valid)
                if pca_scan == "int8":
                    gal_pca, pscales = quantize_rows(gal_pca)
                    self._gal_sc = quant_gallery_scales(pscales, self.n_valid)
                self._gal_pca = gal_pca
        elif match == "int8":
            self._gal_q, scales = quantize_rows(pad_cols(self.gallery))
            self._gal_sq = gallery_sq_norms(self.gallery, self.n_valid)
            self._gal_sc = quant_gallery_scales(scales, self.n_valid)

    def _build_sharded(self, gallery, n_valid, sharded_scan, mesh, pca_dim, pca_sample):
        """``match='sharded'`` (JAX serving.py:104-131): the first ``n_valid``
        rows split over ``mesh``'s gallery axis in bf16 (the JAX package
        shards every row it is given); for ``'packed'`` a PCA fit on the
        first ``pca_sample`` rows as fp32 and per-shard packed projections
        at tile_g 512."""
        from fast_image_recognition_tpu_torch.parallel.mesh import gallery_mesh
        from fast_image_recognition_tpu_torch.parallel.sharded_gallery import (
            shard_gallery,
            shard_gallery_pca_aug,
        )

        self.mesh = mesh if mesh is not None else gallery_mesh()
        g = gallery if isinstance(gallery, torch.Tensor) else torch.as_tensor(np.asarray(gallery, np.float32))
        self.n_valid = int(n_valid if n_valid is not None else g.shape[0])
        g = g[: self.n_valid]
        self.gallery, self._shard_valid = shard_gallery(g, self.mesh)
        self.sharded_scan = sharded_scan
        if sharded_scan == "packed":
            sample = g[: min(self.n_valid, pca_sample)].to(torch.float32).cpu().numpy()
            pca = fit_pca(sample, num_components=min(pca_dim, sample.shape[1]))
            self.pca_dim = int(pca.components.shape[0])
            self._mu = torch.tensor(pca.mean, dtype=torch.float32, device=self.device)
            self._w = torch.tensor(pca.components.T, dtype=torch.float32, device=self.device)
            self._gal_aug = shard_gallery_pca_aug(
                self.gallery, self._shard_valid, self.mesh, self._mu, self._w, tile_g=_SHARD_TILE_G
            )

    # ------------------------------------------------------------------ #

    def _match_sharded(self, emb: torch.Tensor) -> torch.Tensor:
        """[B] int32 global rows from the sharded scans, with no host sync
        (the per-shard valid counts are host ints fixed at build)."""
        from fast_image_recognition_tpu_torch.parallel.sharded_gallery import (
            sharded_topk_l2,
            sharded_topk_pca_packed,
        )

        if self.sharded_scan == "packed":
            _, idx = sharded_topk_pca_packed(
                emb, self._gal_aug, self.gallery, self.mesh, self._mu, self._w, k=1, rescore=self.rescore,
                n_valid_per_shard=self._shard_valid, tile_g=_SHARD_TILE_G,
            )
        else:
            _, idx = sharded_topk_l2(emb, self.gallery, self.mesh, k=1, n_valid_per_shard=self._shard_valid)
        return idx[:, 0].to(self.device)

    def _certified(self, emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The packed PCA path before escalation: [B, D] fp32 normalized
        embeddings -> (cand [B, R] int64 rows, the rescored best row of
        each probe [B] int64, escalate mask [B] bool)."""
        qp = (emb - self._mu) @ self._w
        cand, bound = topk_candidates_l2_packed_cert(qp, self.gal_aug, self.pca_dim, self.rescore)
        cand = cand.to(torch.int64)
        d = rescore_rows(self.gallery, emb, cand)  # + |q|^2, constant per probe
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

    def _candidates(self, emb: torch.Tensor) -> torch.Tensor:
        """Uncertified PCA candidates [B, R] int64 of the configured scan."""
        qp = (emb - self._mu) @ self._w
        if self.pca_scan == "packed":
            cand = topk_candidates_l2_packed(qp, self.gal_aug, self.pca_dim, self.rescore, select=self.select)
        elif self.pca_scan == "int8":
            cand = topk_candidates_l2_quant(
                qp, self._gal_pca, self._gal_sq, self._gal_sc, self.rescore, select=self.select
            )
        else:
            cand = topk_candidates_l2(
                qp, self._gal_pca, self.rescore, n_valid=self.n_valid, gsq=self._gal_sq,
                precise_scores=self.pca_scan != "bf16", select=self.select,
            )
        return cand.to(torch.int64)

    def _match_emb(self, emb: torch.Tensor) -> torch.Tensor:
        """[B, D] fp32 normalized embeddings -> [B] int32 gallery rows on
        the device, with no host sync."""
        if self.match == "exact":
            _, idx = topk_l2(emb, self.gallery, k=1, n_valid=self.n_valid)
            return idx[:, 0]
        if self.match == "sharded":
            return self._match_sharded(emb)
        if self.match == "int8":
            _, idx = topk_l2_quant(
                emb, self._gal_q, self._gal_sq, self._gal_sc, self.gallery, k=1, r=min(self.rescore, 16)
            )
            return idx[:, 0]
        if self.escalate is None:
            cand = self._candidates(emb)
            best = torch.argmin(rescore_rows(self.gallery, emb, cand), dim=1, keepdim=True)
            return cand.gather(1, best)[:, 0].to(torch.int32)
        _, idx, esc = self._certified(emb)
        self.last_escalated = esc
        return self._escalate(emb, idx, esc)

    def _escalate(self, emb: torch.Tensor, idx_fast: torch.Tensor, esc: torch.Tensor) -> torch.Tensor:
        """[B] int32 rows: the exact scan's answer where ``esc`` holds, the
        certified pick elsewhere. One ``topk_l2`` launch whatever ``esc``
        holds, with no host sync: the escalated probes move to the front
        (their order kept), so only the ceil(n_esc / 64) query blocks that
        hold them scan and the rest return at once."""
        e = esc.to(torch.int32)
        # destination of each probe: escalated ones first, each group in order
        pos = torch.where(esc, e.cumsum(0) - 1, e.sum() + (1 - e).cumsum(0) - 1)
        front = torch.empty_like(emb).index_copy_(0, pos, emb)
        mask = torch.empty_like(esc).index_copy_(0, pos, esc)
        _, ei = topk_l2(front, self.gallery, k=1, n_valid=self.n_valid, row_mask=mask)
        return torch.where(esc, ei[pos, 0], idx_fast.to(torch.int32))

    @torch.no_grad()
    def _embed(self, images) -> torch.Tensor:
        """Raw image batch -> L2-normalized ``[B, D]`` fp32 embeddings on
        the service device."""
        images = torch.as_tensor(images, device=self.device)
        return _normalize(self.serve(images)["embedding"])

    def embed(self, images) -> np.ndarray:
        """Raw image batch -> L2-normalized ``[B, D]`` fp32 embeddings as a
        host numpy array (the extract-features product)."""
        return self._embed(images).cpu().numpy()

    @torch.no_grad()
    def identify_device(self, images) -> torch.Tensor:
        """Raw uint8 NHWC image batch -> ``[B]`` int32 gallery rows on the
        device (the timing-loop surface: nothing waits for the host)."""
        return self._match_emb(self._embed(images))

    def identify(self, images) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Raw image batch -> (gallery rows [B] int64, labels [B] or None)."""
        idx = self.identify_device(images).cpu().numpy().astype(np.int64)
        return idx, (None if self.labels is None else self.labels[idx])

    def match_flops(self, batch: int) -> float:
        """Match FLOPs per batch (the backbone's are apart): the full-D scan
        for ``exact`` and ``int8`` (int8 changes the rate, not the count);
        projection, PCA scan and rescore for ``pca``; for the sharded packed
        scan the projection and rescore run on every shard."""
        if self.match == "sharded" and self.sharded_scan == "packed":
            s = self.mesh.shape["gallery"]
            return (
                2.0 * batch * self.dim * self.pca_dim * s
                + 2.0 * batch * self.n_valid * self.pca_dim
                + 2.0 * batch * self.rescore * self.dim * 2 * s
            )
        if self.match in ("exact", "int8", "sharded"):
            return 2.0 * batch * self.n_valid * self.dim
        return (
            2.0 * batch * self.dim * self.pca_dim
            + 2.0 * batch * self.n_valid * self.pca_dim
            + 2.0 * batch * self.rescore * self.dim * 2
        )


# ---------------------------------------------------------------------- #
# early-exit cascade                                                      #
# ---------------------------------------------------------------------- #


def _grid_pool(h: torch.Tensor, g: int) -> torch.Tensor:
    """NCHW activation ``[B, C, H, W]`` -> ``[B, g*g*C]`` fp32 adaptive mean
    pooling, flattened in the JAX package's NHWC order ``(gh, gw, C)``. H
    and W are cropped to a multiple of the grid first; g=1 is plain GAP."""
    b, c, hh, ww = h.shape
    gh, gw = min(g, hh), min(g, ww)
    h = h[:, :, : (hh // gh) * gh, : (ww // gw) * gw].to(torch.float32)
    h = h.reshape(b, c, gh, hh // gh, gw, ww // gw).mean(dim=(3, 5))
    return h.permute(0, 2, 3, 1).reshape(b, gh * gw * c)


def _tap_forward(net: FoldedEfficientNet, images: torch.Tensor, taps: Sequence[str], grid: int):
    """Whole forward: (grid-pooled feats of the tapped blocks in network
    order, normalized final embedding)."""
    tapset = set(taps)
    h = net.stem(images)
    feats = []
    for name, blk in zip(net.names, net.blocks):
        h = blk(h)
        if name in tapset:
            feats.append(_grid_pool(h, grid))
    return feats, _normalize(net.head(h))


def make_tap_embed_fn(
    variables: Optional[Dict[str, Any]],
    info: Dict[str, Any],
    resolution: Optional[int] = None,
    taps: Sequence[str] = (),
    grid: int = 1,
    *,
    serving_fn: Optional[FoldedEfficientNet] = None,
    device: DeviceLike = None,
) -> Callable:
    """``fn(images) -> (list of [B, g*g*C_l] fp32 tap feats, [B, D]
    normalized final embedding)`` over the folded forward: the extractor
    that builds per-level galleries. grid=1 is plain GAP, the tap embedding
    the level-gallery cascade matches on."""
    dev = resolve_device(device)
    net = serving_fn if serving_fn is not None else make_serving_fn(
        variables, info, resolution=resolution, device=dev
    )

    @torch.no_grad()
    def fn(images):
        return _tap_forward(net, torch.as_tensor(images, device=dev), taps, grid)

    return fn


def _solve_readouts(feats: List[np.ndarray], emb: np.ndarray, ridge: float) -> List[np.ndarray]:
    """Ridge fit per tap of ``[feats, 1] @ A ~ emb`` on the host in fp32:
    ``A = (X^T X + ridge * n * I)^-1 X^T emb``, ``[F_l + 1, D]`` each."""
    out = []
    for x in feats:
        x = np.concatenate([x, np.ones((len(x), 1), np.float32)], axis=1)
        xtx = x.T @ x + ridge * len(x) * np.eye(x.shape[1], dtype=np.float32)
        out.append(np.linalg.solve(xtx, x.T @ emb))
    return out


class CascadeRecognitionService:
    """Early-exit recognition serving (``CascadeRecognitionService`` of the
    JAX package, serving.py:483).

    The backbone runs in segments that end at the exit ``taps``. After each
    segment the live probes get an embedding and are matched: the packed
    single-min scan (``kernels/packed_scan.cu``) picks the best row of each
    of the ``rescore`` nearest tiles, those rows are rescored in full D,
    and a probe exits when ``d1 < ratio^2 * d2``. ``d2`` is the runner-up
    candidate (``d2_rule='row'``) or the nearest candidate of another label
    (``'class'``, which needs ``labels``). Survivors, least confident
    first, are compacted into the next segment's static capacity; the
    overflow exits with this level's answer and is counted as forced.

    Two modes:

    - ``galleries=None`` (readout): an affine readout per tap, ridge-fit on
      calibration images, predicts the final embedding from grid-pooled
      tap features; every level matches against the final gallery in its
      PCA space.
    - ``galleries=[...]`` (level): one gallery per tap, row-aligned with
      the final gallery; each level matches its own GAP tap embedding
      against its own gallery, unprojected.

    ``variables`` holds the numpy ``params``/``batch_stats`` of a checkpoint
    (or pass a built module as ``serving_fn``). ``ratio`` is read at every
    call. :meth:`identify_device` makes no host sync: capacities are
    Python ints, from :meth:`calibrate` or a fixed default.
    """

    def __init__(
        self,
        variables: Optional[Dict[str, Any]],
        info: Dict[str, Any],
        gallery,
        *,
        labels: Optional[np.ndarray] = None,
        resolution: Optional[int] = None,
        taps: Optional[Sequence[str]] = None,
        grid: int = 2,
        pca_dim: int = 124,
        rescore: int = 48,
        ratio: float = 0.7,
        d2_rule: str = "row",
        n_valid: Optional[int] = None,
        pca_sample: int = 8192,
        calib_total: int = 4096,
        calib_batch: int = 1024,
        ridge: float = 1e-3,
        calib_images=None,
        galleries: Optional[Sequence] = None,
        seed: int = 17,
        serving_fn: Optional[FoldedEfficientNet] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.info = info
        self.resolution = int(resolution or info["resolution"])
        self.dim = int(info["embedding_dim"])
        self.grid = int(grid)
        self.rescore = int(rescore)
        self.ratio = float(ratio)
        if d2_rule not in ("row", "class"):
            raise ValueError("d2_rule must be 'row' or 'class'")
        if d2_rule == "class" and labels is None:
            raise ValueError("d2_rule='class' needs gallery labels")
        self.d2_rule = d2_rule
        self.labels = None if labels is None else np.asarray(labels)
        self.net = serving_fn if serving_fn is not None else make_serving_fn(
            variables, info, resolution=self.resolution, device=self.device
        )

        plan = block_plan(info["variant"])
        if taps is None:
            taps = default_taps(info["variant"], "early")[:2]
        self.taps = list(taps)
        name_to_idx = {b["name"]: i for i, b in enumerate(plan)}
        tap_idx = [name_to_idx[t] for t in self.taps]
        if tap_idx != sorted(tap_idx):
            raise ValueError("taps must be in network order")
        bounds = [0] + [i + 1 for i in tap_idx] + [len(plan)]
        self.segments = list(zip(bounds[:-1], bounds[1:]))
        self.num_levels = len(self.segments)

        self.gallery, self.n_valid = _device_gallery(gallery, n_valid, self.device)
        # the ratio rule needs a real runner-up, so small galleries shrink
        # the scan tile until there are >= 8 tiles (1M rows stay at 1024);
        # galleries stay padded to 1024 rows, so whole pad tiles can exist
        self._tile_g = 1024
        while self._tile_g > 128 and self.n_valid < 8 * self._tile_g:
            self._tile_g //= 2
        self.pca_dim, self._mu, self._w, gal_pca = _pca_project(self.gallery, self.n_valid, pca_dim, pca_sample)
        self._gal_aug = pack_gallery_aug(gal_pca, self.n_valid, self._tile_g)
        del gal_pca
        self._labels_dev = None
        if d2_rule == "class":
            lab_pad = np.full(int(self.gallery.shape[0]), -1, np.int64)
            lab_pad[: self.n_valid] = self.labels[: self.n_valid]
            self._labels_dev = torch.as_tensor(lab_pad, device=self.device)

        self.mode = "readout" if galleries is None else "level"
        self._readouts: Optional[List[torch.Tensor]] = None
        self._tap_assets: List[Dict[str, Any]] = []
        if self.mode == "level":
            if len(galleries) != self.num_levels - 1:
                raise ValueError(
                    f"need one tap gallery per exit level ({self.num_levels - 1}), "
                    f"got {len(galleries)}"
                )
            self.grid = 1
            for g_l in galleries:
                if int(g_l.shape[0]) < self.n_valid:
                    raise ValueError(
                        "tap galleries must be row-aligned with the final gallery "
                        "(row r = the same enrolled image at every level); got "
                        f"{int(g_l.shape[0])} rows < n_valid {self.n_valid}"
                    )
                gpad, _ = _device_gallery(g_l, self.n_valid, self.device)
                if gpad.shape[0] != self.gallery.shape[0]:
                    raise ValueError(
                        "tap galleries must pad to the final gallery's row count "
                        "(pass n_valid and same pre-pad row counts)"
                    )
                self._tap_assets.append({
                    "gal": gpad,
                    "aug": pack_gallery_aug(gpad, self.n_valid, self._tile_g),
                    "dim": int(gpad.shape[1]),
                })
        else:
            self._fit_readouts(calib_images, calib_total, calib_batch, ridge, seed)
        self.survivor_fractions: Optional[List[float]] = None
        self._capacities: Optional[Tuple[int, ...]] = None

    # ------------------------------------------------------------------ #

    def _fit_readouts(self, calib_images, calib_total, calib_batch, ridge, seed) -> None:
        """Ridge-fit per-tap affine readouts tap feats -> final embedding on
        calibration images (given, or uint8 noise drawn from
        ``np.random.default_rng(seed)`` in the JAX package's order)."""
        rng = np.random.default_rng(seed)
        res = self.resolution
        if calib_images is not None:
            calib_images = np.asarray(calib_images)
            calib_total = len(calib_images)
        feats: Optional[List[list]] = None
        embs = []
        done = 0
        with torch.no_grad():
            while done < calib_total:
                b = min(calib_batch, calib_total - done)
                if calib_images is not None:
                    imgs = calib_images[done : done + b]
                else:
                    imgs = rng.integers(0, 255, (b, res, res, 3), np.int64).astype(np.uint8)
                f, e = _tap_forward(self.net, torch.as_tensor(imgs, device=self.device), self.taps, self.grid)
                if feats is None:
                    feats = [[] for _ in f]
                for j, t in enumerate(f):
                    feats[j].append(t.cpu().numpy())
                embs.append(e.cpu().numpy())
                done += b
        readouts = _solve_readouts([np.concatenate(fl) for fl in feats], np.concatenate(embs), ridge)
        self._readouts = [torch.as_tensor(a, dtype=torch.float32, device=self.device) for a in readouts]

    def _match_top2(self, emb, gal_aug, gallery, project: bool = True, dim: Optional[int] = None):
        """Normalized [b, D] queries -> (best row [b] int64, d1 [b], d2 [b])
        via the single-min packed candidate scan and an fp32 rescore of the
        bf16 rows. d1/d2 are true squared L2 distances (|q|^2 = 1).
        ``project=True`` scans in the final gallery's PCA space; ``False``
        scans the query as it is against a same-space (tap) gallery."""
        qp = (emb - self._mu) @ self._w if project else emb
        cand = topk_candidates_l2_packed(
            qp, gal_aug, dim if dim is not None else self.pca_dim, self.rescore, self._tile_g
        ).to(torch.int64)
        d = torch.clamp_min(1.0 + rescore_rows(gallery, emb, cand), 0.0)
        # whole pad tiles (the gallery pads to 1024 rows, the tile may be
        # smaller) give zero rows at d = 1 that could beat every real row
        d = torch.where(cand < self.n_valid, d, math.inf)
        if d.shape[1] < 2:
            # one candidate: no runner-up, so the rule must never fire
            return cand[:, 0], d[:, 0], d[:, 0]
        if self.d2_rule == "class":
            best = torch.argmin(d, dim=1, keepdim=True)
            clab = self._labels_dev[cand]  # [b, R]
            d2 = torch.where(clab != clab.gather(1, best), d, math.inf).min(dim=1).values
            return cand.gather(1, best)[:, 0], d.gather(1, best)[:, 0], d2
        # stable ascending sort = lax.top_k(-d, 2): ties to the lower column
        top = torch.sort(d, dim=1, stable=True).indices[:, :2]
        d12 = d.gather(1, top)
        return cand.gather(1, top[:, :1])[:, 0], d12[:, 0], d12[:, 1]

    def _level_match(self, level: int, emb: torch.Tensor):
        """Match at ``level`` (the last level is the final embedding)."""
        if self.mode == "level" and level < self.num_levels - 1:
            a = self._tap_assets[level]
            return self._match_top2(emb, a["aug"], a["gal"], project=False, dim=a["dim"])
        return self._match_top2(emb, self._gal_aug, self.gallery)

    def _level_embedding(self, level: int, h: torch.Tensor) -> torch.Tensor:
        """Normalized embedding of a tap's activation: GAP (level mode) or
        the readout's prediction of the final embedding."""
        if self.mode == "level":
            return _normalize(_grid_pool(h, 1))
        a = self._readouts[level]
        return _normalize(_grid_pool(h, self.grid) @ a[:-1] + a[-1])

    def _run(self, images: torch.Tensor, caps: Tuple[int, ...], trace: Optional[list] = None):
        """One batch through the cascade -> ``[2B+1]`` int32
        ``[preds | exit_level | forced]``. With ``trace`` a list, each
        level appends its ``gidx``, ``live``, ``d1`` and ``margin``."""
        net = self.net
        b = int(images.shape[0])
        dev = images.device
        ratio2 = self.ratio * self.ratio
        preds = torch.zeros((b,), dtype=torch.int32, device=dev)
        exit_level = torch.zeros((b,), dtype=torch.int32, device=dev)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        gidx = torch.arange(b, device=dev)
        forced = torch.zeros((), dtype=torch.int32, device=dev)
        carry = images
        for level, (start, end) in enumerate(self.segments):
            final = level == self.num_levels - 1
            h = net.run_blocks(net.stem(carry) if level == 0 else carry, start, end)
            emb = _normalize(net.head(h)) if final else self._level_embedding(level, h)
            lp, d1, d2 = self._level_match(level, emb)
            live = ~done[gidx]
            # fire iff sqrt(d1/d2) < ratio  <=>  ratio^2 * d2 - d1 > 0
            margin = ratio2 * d2 - d1
            fire = live if final else (margin > 0) & live
            preds = preds.index_copy(0, gidx, torch.where(live, lp.to(torch.int32), preds[gidx]))
            lvl = torch.full_like(gidx, level, dtype=torch.int32)
            exit_level = exit_level.index_copy(0, gidx, torch.where(live, lvl, exit_level[gidx]))
            done = done.index_copy(0, gidx, done[gidx] | fire)
            if trace is not None:
                trace.append({"gidx": gidx, "live": live, "d1": d1, "margin": margin})
            if final:
                break
            surv = live & ~fire
            c_next = min(caps[level + 1], int(gidx.shape[0]))
            # keep the least confident survivors (most negative margin);
            # the overflow, closest to firing, exits here and is counted
            order = torch.sort(torch.where(surv, margin, math.inf), stable=True).indices[:c_next]
            forced = forced + torch.clamp_min(surv.sum(dtype=torch.int32) - c_next, 0)
            gidx = gidx[order]
            carry = h[order]
        return torch.cat([preds, exit_level, forced[None]])

    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def calibrate(self, images, slack: float = 1.3, multiple: int = 64) -> List[float]:
        """Measure per-level survivor fractions on a representative batch
        and size the static capacities: ``cap_l = roundup(B * frac * slack,
        multiple)``, at most B."""
        x = torch.as_tensor(images, device=self.device)
        feats, _ = _tap_forward(self.net, x, self.taps, self.grid)
        b = int(x.shape[0])
        alive = np.ones(b, dtype=bool)
        fractions: List[float] = []
        for level in range(self.num_levels - 1):
            if self.mode == "level":
                emb = _normalize(feats[level])
            else:
                a = self._readouts[level]
                emb = _normalize(feats[level] @ a[:-1] + a[-1])
            _, d1, d2 = self._level_match(level, emb)
            margin = (self.ratio * self.ratio * d2 - d1).cpu().numpy()
            alive = alive & ~(margin > 0)
            fractions.append(float(alive.mean()))
        self.survivor_fractions = fractions
        caps = [b]
        m = min(multiple, b)
        for frac in fractions:
            c = max(1, math.ceil(b * frac * slack))
            caps.append(min(b, -(-c // m) * m))
        self._capacities = tuple(caps)
        return fractions

    def capacities_for(self, batch: int) -> Tuple[int, ...]:
        if self._capacities is not None and self._capacities[0] == batch:
            return self._capacities
        # uncalibrated default: a quarter of the batch per later level
        return (batch,) + (max(64, batch // 4) if batch >= 256 else batch,) * (self.num_levels - 1)

    @torch.no_grad()
    def identify_device(self, images, capacities: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Raw uint8 NHWC image batch -> ``[2B+1]`` int32 on the device:
        ``[preds | exit_level | forced]`` (the timing-loop surface)."""
        x = torch.as_tensor(images, device=self.device)
        caps = tuple(capacities) if capacities else self.capacities_for(int(x.shape[0]))
        return self._run(x, caps)

    def identify(self, images, capacities: Optional[Sequence[int]] = None):
        """Raw image batch -> (gallery rows [B] int64, labels [B] or None,
        stats with ``break_counts`` and ``forced_fraction``)."""
        packed = self.identify_device(images, capacities).cpu().numpy()
        b = (packed.shape[0] - 1) // 2
        idx = packed[:b].astype(np.int64)
        exit_level = packed[b : 2 * b]
        stats = {
            "break_counts": (np.bincount(exit_level, minlength=self.num_levels) / b).tolist(),
            "forced_fraction": float(packed[2 * b]) / b,
        }
        return idx, (None if self.labels is None else self.labels[idx]), stats


def build_service(
    variant: str,
    gallery,
    labels: Optional[np.ndarray] = None,
    *,
    seed: int = 0,
    variables: Dict[str, Any],
    **kwargs,
) -> RecognitionService:
    """Recognition service from a zoo variant name and a checkpoint's numpy
    ``params``/``batch_stats``. ``seed`` seeds the JAX package's random
    backbone init; the port does not initialize weights, so it is taken
    for the same signature and not used."""
    del seed
    return RecognitionService(variables, backbone_info(variant), gallery, labels=labels, **kwargs)


def build_cascade_service(
    variant: str,
    gallery,
    labels: Optional[np.ndarray] = None,
    *,
    seed: int = 0,
    variables: Dict[str, Any],
    **kwargs,
) -> CascadeRecognitionService:
    """Cascade service from a zoo variant name and a checkpoint's numpy
    ``params``/``batch_stats``. ``seed`` is taken as in
    :func:`build_service` and not passed on: the service's own ``seed``
    (17) seeds its calibration noise, as in the JAX package."""
    del seed
    return CascadeRecognitionService(variables, backbone_info(variant), gallery, labels=labels, **kwargs)
