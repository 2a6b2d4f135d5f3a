"""Recognition serving on the card (JAX ``serving.py``): ``RecognitionService``,
``CascadeRecognitionService`` (the early-exit twin), ``make_tap_embed_fn`` and
``build_service``. No host sync a batch."""

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models import backbone_info, create_backbone
from .models.efficientnet import default_taps
from .models.fold import MBCONV_FAMILIES, make_serving_fn
from .models.inference import FoldedEfficientNet, make_infer_fn, mbconv_plan
from .ops.distance_kernel import (gallery_sq_norms, pack_gallery_aug, pad_cols, pad_gallery, quant_gallery_scales,
    rescore_rows, topk_candidates_l2, topk_candidates_l2_packed, topk_candidates_l2_packed_cert,
    topk_candidates_l2_quant, topk_l2, topk_l2_quant)
from .ops.pca import fit_pca
from .ops.quant import quantize_rows

# gallery rows projected per step: bounds the bf16 temporaries of the fit
_PROJECTION_ROWS = 65536
_SHARD_TILE_G = 512  # the sharded scans' row tile (JAX serving.py:130, :279)


def _mbconv_only(info: Dict[str, Any]) -> None:
    """JAX's cascade taps the functional fold's ladder (its serving.py:570-574)."""
    if info.get("family") not in MBCONV_FAMILIES:
        raise NotImplementedError(f"the cascade service taps MBConv families only, as JAX's (its serving.py:570-574); "
                f"{info.get('family')!r} cascades through cascade/engine.py")


def _tap_net(variables, info: Dict[str, Any], resolution: int, device: torch.device) -> FoldedEfficientNet:
    """The folded forward the cascade taps: JAX's folds the torch-mode mean and runs swish at stem and head whatever
    the family."""
    return make_infer_fn(variables, info["variant"], resolution=resolution, activation="swish", device=device)


def _normalize(emb: torch.Tensor) -> torch.Tensor:
    emb = emb.to(torch.float32)
    return emb / torch.clamp_min(torch.linalg.vector_norm(emb, dim=1, keepdim=True), 1e-30)


def _device_gallery(gallery, n_valid: Optional[int], device: torch.device) -> Tuple[torch.Tensor, int]:
    """(padded bf16 rows on ``device``, n_valid); a bf16 tensor is taken as padded."""
    if isinstance(gallery, torch.Tensor) and gallery.dtype == torch.bfloat16:
        return gallery.to(device), int(n_valid if n_valid is not None else gallery.shape[0])
    g = torch.as_tensor(np.asarray(gallery, np.float32))
    n = int(n_valid if n_valid is not None else g.shape[0])
    return pad_gallery(g.to(device, torch.bfloat16)), n


def _pca_project(gallery: torch.Tensor, n_valid: int, pca_dim: int, pca_sample: int):
    """PCA fit on a host sample, every row projected in bf16: (pca_dim, mean, components, rows)."""
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
    """Folded-backbone extract + device-resident 1-NN, JAX's defaults; ``last_escalated``: the probes a certified
    call escalated."""

    def __init__(self, variables: Optional[Dict[str, Any]], info: Dict[str, Any], gallery, *,
        labels: Optional[np.ndarray] = None, resolution: Optional[int] = None, match: str = "pca", pca_dim: int = 128,
        rescore: int = 48, pca_scan: str = "f32", select: str = "exact", escalate: Optional[float] = 0.05,
        n_valid: Optional[int] = None, pca_sample: int = 8192, folded: bool = True,
        serving_fn: Optional[torch.nn.Module] = None, sharded_scan: str = "exact", mesh=None, device: DeviceLike = None
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
            variables, info, resolution=self.resolution, device=self.device, folded=folded
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
            self.pca_dim, self._mu, self._w, gal_pca = _pca_project(self.gallery, self.n_valid, pca_dim, pca_sample)
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
        """The first ``n_valid`` rows over the mesh's gallery axis; ``'packed'``: per-shard PCA, tile_g 512."""
        from .parallel.mesh import gallery_mesh
        from .parallel.sharded_gallery import (shard_gallery, shard_gallery_pca_aug)

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
        """[B] int32 global rows from the sharded scans, no host sync."""
        from .parallel.sharded_gallery import (sharded_topk_l2, sharded_topk_pca_packed)

        if self.sharded_scan == "packed":
            _, idx = sharded_topk_pca_packed(
                emb, self._gal_aug, self.gallery, self.mesh, self._mu, self._w, k=1, rescore=self.rescore,
                n_valid_per_shard=self._shard_valid, tile_g=_SHARD_TILE_G)
        else:
            _, idx = sharded_topk_l2(emb, self.gallery, self.mesh, k=1, n_valid_per_shard=self._shard_valid)
        return idx[:, 0].to(self.device)

    def _certified(self, emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Before escalation: (candidate rows [B, R], the rescored best [B], escalate mask [B])."""
        qp = (emb - self._mu) @ self._w
        cand, bound = topk_candidates_l2_packed_cert(qp, self.gal_aug, self.pca_dim, self.rescore)
        cand = cand.to(torch.int64)
        d = rescore_rows(self.gallery, emb, cand)  # + |q|^2, constant per probe
        best = torch.argmin(d, dim=1, keepdim=True)
        idx_fast = cand.gather(1, best)[:, 0]
        # certificate: the rescored best must clear every unscored row's bound, with slack for bf16 operand
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
            cand = topk_candidates_l2(qp, self._gal_pca, self.rescore, n_valid=self.n_valid, gsq=self._gal_sq,
                precise_scores=self.pca_scan != "bf16", select=self.select)
        return cand.to(torch.int64)

    def _match_emb(self, emb: torch.Tensor) -> torch.Tensor:
        """Normalized embeddings -> [B] int32 rows on the device, no host sync."""
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
        """The exact scan's rows where ``esc`` (escalated probes first: only their query blocks scan), else the
        certified pick; one ``topk_l2``."""
        e = esc.to(torch.int32)
        # destination of each probe: escalated ones first, each group in order
        pos = torch.where(esc, e.cumsum(0) - 1, e.sum() + (1 - e).cumsum(0) - 1)
        front = torch.empty_like(emb).index_copy_(0, pos, emb)
        mask = torch.empty_like(esc).index_copy_(0, pos, esc)
        _, ei = topk_l2(front, self.gallery, k=1, n_valid=self.n_valid, row_mask=mask)
        return torch.where(esc, ei[pos, 0], idx_fast.to(torch.int32))

    @torch.no_grad()
    def _embed(self, images) -> torch.Tensor:
        """Raw image batch -> L2-normalized ``[B, D]`` fp32 embeddings on the service device."""
        images = torch.as_tensor(images, device=self.device)
        return _normalize(self.serve(images)["embedding"])

    def embed(self, images) -> np.ndarray:
        """Images -> L2-normalized ``[B, D]`` fp32 embeddings on the host."""
        return self._embed(images).cpu().numpy()

    @torch.no_grad()
    def identify_device(self, images) -> torch.Tensor:
        """uint8 NHWC images -> ``[B]`` int32 rows on the device."""
        return self._match_emb(self._embed(images))

    def identify(self, images) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Raw image batch -> (gallery rows [B] int64, labels [B] or None)."""
        idx = self.identify_device(images).cpu().numpy().astype(np.int64)
        return idx, (None if self.labels is None else self.labels[idx])

    def match_flops(self, batch: int) -> float:
        """Match FLOPs a batch, the backbone's apart."""
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


# early-exit cascade


def _grid_pool(h: torch.Tensor, g: int) -> torch.Tensor:
    """NCHW -> ``[B, g*g*C]`` fp32 adaptive mean pool in JAX's NHWC order, H and W cropped to a multiple of g."""
    b, c, hh, ww = h.shape
    gh, gw = min(g, hh), min(g, ww)
    h = h[:, :, : (hh // gh) * gh, : (ww // gw) * gw].to(torch.float32)
    h = h.reshape(b, c, gh, hh // gh, gw, ww // gw).mean(dim=(3, 5))
    return h.permute(0, 2, 3, 1).reshape(b, gh * gw * c)


def _tap_forward(net: FoldedEfficientNet, images: torch.Tensor, taps: Sequence[str], grid: int):
    """(grid-pooled feats of the tapped blocks, normalized final embedding)."""
    tapset = set(taps)
    h = net.stem(images)
    feats = []
    for name, blk in zip(net.names, net.blocks):
        h = blk(h)
        if name in tapset:
            feats.append(_grid_pool(h, grid))
    return feats, _normalize(net.head(h))


def make_tap_embed_fn(variables: Optional[Dict[str, Any]], info: Dict[str, Any], resolution: Optional[int] = None,
    taps: Sequence[str] = (), grid: int = 1, *, serving_fn: Optional[FoldedEfficientNet] = None,
    device: DeviceLike = None) -> Callable:
    """The per-level gallery extractor ``fn(images) -> (tap feats, normalized embedding)``."""
    _mbconv_only(info)
    dev = resolve_device(device)
    net = serving_fn if serving_fn is not None else _tap_net(variables, info, resolution, dev)

    @torch.no_grad()
    def fn(images):
        return _tap_forward(net, torch.as_tensor(images, device=dev), taps, grid)

    return fn


def _solve_readouts(feats: List[np.ndarray], emb: np.ndarray, ridge: float) -> List[np.ndarray]:
    """Ridge fit per tap of ``[feats, 1] @ A ~ emb`` in fp32 on the host."""
    out = []
    for x in feats:
        x = np.concatenate([x, np.ones((len(x), 1), np.float32)], axis=1)
        xtx = x.T @ x + ridge * len(x) * np.eye(x.shape[1], dtype=np.float32)
        out.append(np.linalg.solve(xtx, x.T @ emb))
    return out


class CascadeRecognitionService:
    """Early-exit serving: after each segment the live probes matched, exiting at ``d1 < ratio^2 * d2``;
    survivors, least confident first, fill static capacities; ``galleries=None``: ridge readouts."""

    def __init__(self, variables: Optional[Dict[str, Any]], info: Dict[str, Any], gallery, *,
        labels: Optional[np.ndarray] = None, resolution: Optional[int] = None, taps: Optional[Sequence[str]] = None,
        grid: int = 2, pca_dim: int = 124, rescore: int = 48, ratio: float = 0.7, d2_rule: str = "row",
        n_valid: Optional[int] = None, pca_sample: int = 8192, calib_total: int = 4096, calib_batch: int = 1024,
        ridge: float = 1e-3, calib_images=None, galleries: Optional[Sequence] = None, seed: int = 17,
        serving_fn: Optional[FoldedEfficientNet] = None, device: DeviceLike = None):
        _mbconv_only(info)
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
        self.net = serving_fn if serving_fn is not None else _tap_net(variables, info, self.resolution, self.device)

        plan = mbconv_plan(info["variant"])[0]
        if taps is None:  # JAX's: default_taps(getattr(model, "variant", "b0"), "early")[:2]
            taps = default_taps(info["variant"] if info["family"] == "efficientnet" else "b0", "early")[:2]
        self.taps = list(taps)
        name_to_idx = {b["name"]: i for i, b in enumerate(plan)}
        tap_idx = [name_to_idx[t] for t in self.taps]
        if tap_idx != sorted(tap_idx):
            raise ValueError("taps must be in network order")
        bounds = [0] + [i + 1 for i in tap_idx] + [len(plan)]
        self.segments = list(zip(bounds[:-1], bounds[1:]))
        self.num_levels = len(self.segments)

        self.gallery, self.n_valid = _device_gallery(gallery, n_valid, self.device)
        # the ratio rule needs a runner-up: small galleries shrink the tile to >= 8 tiles (pads stay
        # at 1024 rows, so whole pad tiles can exist)
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
                self._tap_assets.append({"gal": gpad, "aug": pack_gallery_aug(gpad, self.n_valid, self._tile_g),
                    "dim": int(gpad.shape[1])})
        else:
            self._fit_readouts(calib_images, calib_total, calib_batch, ridge, seed)
        self.survivor_fractions: Optional[List[float]] = None
        self._capacities: Optional[Tuple[int, ...]] = None

    # ------------------------------------------------------------------ #

    def _fit_readouts(self, calib_images, calib_total, calib_batch, ridge, seed) -> None:
        """Ridge-fit per-tap readouts to the final embedding (calibration noise in JAX's order)."""
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
        """Queries -> (best row, d1, d2): single-min scan + fp32 rescore."""
        qp = (emb - self._mu) @ self._w if project else emb
        cand = topk_candidates_l2_packed(
            qp, gal_aug, dim if dim is not None else self.pca_dim, self.rescore, self._tile_g
        ).to(torch.int64)
        d = torch.clamp_min(1.0 + rescore_rows(gallery, emb, cand), 0.0)
        # whole pad tiles give zero rows at d = 1, which could beat real rows
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
        """A tap's normalized GAP (level mode) or readout prediction."""
        if self.mode == "level":
            return _normalize(_grid_pool(h, 1))
        a = self._readouts[level]
        return _normalize(_grid_pool(h, self.grid) @ a[:-1] + a[-1])

    def _run(self, images: torch.Tensor, caps: Tuple[int, ...], trace: Optional[list] = None):
        """``[preds | exit_level | forced]``; ``trace`` gets each level's ``gidx``, ``live``, ``d1``, ``margin``."""
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
            # keep the least confident survivors; the overflow exits here, counted
            order = torch.sort(torch.where(surv, margin, math.inf), stable=True).indices[:c_next]
            forced = forced + torch.clamp_min(surv.sum(dtype=torch.int32) - c_next, 0)
            gidx = gidx[order]
            carry = h[order]
        return torch.cat([preds, exit_level, forced[None]])

    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def calibrate(self, images, slack: float = 1.3, multiple: int = 64) -> List[float]:
        """Survivor fractions a level; capacities ``roundup(B * frac * slack)``, at most B."""
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
        """``[preds | exit_level | forced]`` int32 on the device."""
        x = torch.as_tensor(images, device=self.device)
        caps = tuple(capacities) if capacities else self.capacities_for(int(x.shape[0]))
        return self._run(x, caps)

    def identify(self, images, capacities: Optional[Sequence[int]] = None):
        """(rows, labels or None, ``break_counts``, ``forced_fraction``)."""
        packed = self.identify_device(images, capacities).cpu().numpy()
        b = (packed.shape[0] - 1) // 2
        idx = packed[:b].astype(np.int64)
        exit_level = packed[b : 2 * b]
        stats = {"break_counts": (np.bincount(exit_level, minlength=self.num_levels) / b).tolist(),
            "forced_fraction": float(packed[2 * b]) / b}
        return idx, (None if self.labels is None else self.labels[idx]), stats


def _builder(cls, variant, gallery, labels, seed, variables, kwargs):
    """JAX serving.py:1076-1128; ``variables=None`` draws a backbone from ``seed``."""
    info = backbone_info(variant)
    if variables is None:
        _, variables = create_backbone(variant, 0, seed=seed, device=kwargs.get("device"))
    return cls(variables, info, gallery, labels=labels, **kwargs)


def build_service(variant: str, gallery, labels: Optional[np.ndarray] = None, *, seed: int = 0,
        variables: Optional[Dict[str, Any]] = None, **kwargs) -> RecognitionService:
    return _builder(RecognitionService, variant, gallery, labels, seed, variables, kwargs)


def build_cascade_service(variant: str, gallery, labels: Optional[np.ndarray] = None, *, seed: int = 0,
        variables: Optional[Dict[str, Any]] = None, **kwargs) -> CascadeRecognitionService:
    """As :func:`build_service`; the service's own ``seed`` (17) seeds its calibration noise, as in JAX."""
    return _builder(CascadeRecognitionService, variant, gallery, labels, seed, variables, kwargs)
