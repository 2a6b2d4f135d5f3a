"""Gallery scans of the serving path (counterpart of the packed-scan and
top-k part of ``fast_image_recognition_tpu/ops/distance_kernel.py``).

Each wrapper runs the hand-written CUDA kernel (``kernels/*.cu``) on a CUDA
tensor and its plain PyTorch version (``kernels/plain.py``) on a CPU
tensor; any other device raises. Shapes, padding and the augmented layouts
live here, in Python the CPU tests reach.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fast_image_recognition_tpu_torch.kernels import build, plain

BIG_DIST = plain.BIG_DIST
TILE_G = plain.TILE_G
_PAD_SQ_NORM = 1e38  # finite in bf16: BIG_DIST rounds to inf, and inf - inf = NaN


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _row_sq_norms(g: torch.Tensor) -> torch.Tensor:
    """fp32 |row|^2 of a bf16 matrix (exact squares, fp32 sums)."""
    gf = g.to(torch.float32)
    return (gf * gf).sum(dim=1)


def pad_gallery(gallery: torch.Tensor) -> torch.Tensor:
    """Zero-pad rows to a tile multiple (once, at build time)."""
    n = gallery.shape[0]
    np_ = _round_up(max(n, TILE_G), TILE_G)
    if np_ == n:
        return gallery
    return torch.nn.functional.pad(gallery, (0, 0, 0, np_ - n))


def gallery_sq_norms(gallery: torch.Tensor, n_valid: int) -> torch.Tensor:
    """|g|^2 in the tile layout ``[roundup(n_tiles, 8), TILE_G]`` fp32,
    BIG_DIST on rows >= n_valid."""
    gallery = pad_gallery(gallery)
    np_ = gallery.shape[0]
    n_tiles = np_ // TILE_G
    gsq = _row_sq_norms(gallery)
    gsq = torch.where(torch.arange(np_, device=gsq.device) < n_valid, gsq, BIG_DIST)
    gsq = gsq.view(n_tiles, TILE_G)
    n_rows = _round_up(n_tiles, 8)
    if n_rows != n_tiles:
        gsq = torch.nn.functional.pad(gsq, (0, 0, 0, n_rows - n_tiles), value=BIG_DIST)
    return gsq


def pack_gallery_aug(gallery: torch.Tensor, n_valid: Optional[int] = None) -> torch.Tensor:
    """Augmented bf16 gallery ``[g, |g|^2_hi, |g|^2_lo, 1, 1]``, columns
    padded to a 128 multiple, rows to ``TILE_G`` with |g|^2 = 1e38. With the
    query-side ``[-2q, 1, 1, |q|^2_hi, |q|^2_lo]`` one bf16 dot gives the
    whole squared distance; the hi/lo split carries the norm to ~2^-17."""
    n = gallery.shape[0] if n_valid is None else int(n_valid)
    g = pad_gallery(gallery).to(torch.bfloat16)
    np_, d = g.shape
    gsq = torch.where(torch.arange(np_, device=g.device) < n, _row_sq_norms(g), _PAD_SQ_NORM)
    hi = gsq.to(torch.bfloat16)
    lo = (gsq - hi.to(torch.float32)).to(torch.bfloat16)
    aug = torch.zeros((np_, _round_up(d + 4, 128)), dtype=torch.bfloat16, device=g.device)
    aug[:, :d] = g
    aug[:, d] = hi
    aug[:, d + 1] = lo
    aug[:, d + 2 : d + 4] = 1
    return aug


def _augment_queries(queries: torch.Tensor, d: int, da: int) -> torch.Tensor:
    """Query-side ``[-2q, 1, 1, |q|^2_hi, |q|^2_lo]`` in bf16."""
    b, dq = queries.shape
    if dq != d or d + 4 > da:
        raise ValueError(f"queries [{b}, {dq}] do not fit d={d}, da={da}")
    qf = queries.to(torch.float32)
    qsq = (qf * qf).sum(dim=1)
    qhi = qsq.to(torch.bfloat16)
    qlo = (qsq - qhi.to(torch.float32)).to(torch.bfloat16)
    qa = torch.zeros((b, da), dtype=torch.bfloat16, device=queries.device)
    qa[:, :d] = (-2.0 * qf).to(torch.bfloat16)
    qa[:, d : d + 2] = 1
    qa[:, d + 2] = qhi
    qa[:, d + 3] = qlo
    return qa


def _key_to_dist(keys: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min((keys & ~(TILE_G - 1)).view(torch.float32), 0.0)


def tilemin2_keys(q_aug: torch.Tensor, g_aug: torch.Tensor):
    """Per (query, tile) min and second-min packed keys, ``[B, n_tiles]``
    int32 each: ``kernels/packed_scan.cu`` on the card, the plain version
    on the CPU."""
    if _on_card(q_aug):
        return build.launch_tilemin2_packed(q_aug, g_aug)
    return plain.tilemin2_packed_plain(q_aug, g_aug)


def decode_tile_keys(k1: torch.Tensor, k2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Packed keys -> (d1, global row of each tile's best, d2)."""
    tiles = torch.arange(k1.shape[1], dtype=torch.int32, device=k1.device) * TILE_G
    out_i = tiles[None, :] + (k1 & (TILE_G - 1))
    return _key_to_dist(k1), out_i, _key_to_dist(k2)


def tile_min2_l2_packed(
    queries: torch.Tensor, gallery_aug: torch.Tensor, d: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d1 [B, n_tiles] raw squared L2 of each tile's best row, its global
    index [B, n_tiles], d2 [B, n_tiles] the tile's second-best distance).
    Distances are not divided by ``d`` and are quantized toward zero by
    ~2^-13 relative (conservative for a lower bound)."""
    qa = _augment_queries(queries, d, gallery_aug.shape[1])
    k1, k2 = tilemin2_keys(qa, gallery_aug)
    return decode_tile_keys(k1, k2)


def certify_tiles(
    d1t: torch.Tensor, it: torch.Tensor, d2t: torch.Tensor, r: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile (d1, row, d2) -> (cand [B, R] rows of the R nearest tiles,
    bound [B]); see :func:`topk_candidates_l2_packed_cert`."""
    n_tiles = d1t.shape[1]
    r = min(r, n_tiles)
    k = min(r + 1, n_tiles)
    # stable ascending sort = lax.top_k(-d1t): ties to the lower tile
    sel = torch.sort(d1t, dim=1, stable=True).indices[:, :k]
    cand = it.gather(1, sel[:, :r])
    if k > r:
        unsel = d1t.gather(1, sel[:, r : r + 1])[:, 0]
    else:  # every tile selected: nothing unselected to bound
        unsel = torch.full((d1t.shape[0],), BIG_DIST, dtype=torch.float32, device=d1t.device)
    sel_m2 = d2t.gather(1, sel[:, :r]).min(dim=1).values
    return cand, torch.minimum(unsel, sel_m2)


def topk_candidates_l2_packed_cert(
    queries: torch.Tensor, gallery_aug: torch.Tensor, d: int, r: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Certified candidates: (cand [B, R] rows, bound [B]).

    ``bound`` lower-bounds (up to bf16 operand rounding and the 2^-13 key
    quantization) the true full-D squared distance of every row outside
    ``cand``: unselected tiles have a PCA-space min >= the (R+1)-th tile
    min, and unscored rows of selected tiles are >= their tile's second
    min; projection only shrinks distances."""
    return certify_tiles(*tile_min2_l2_packed(queries, gallery_aug, d), r)


def topk_l2(
    queries: torch.Tensor,
    gallery: torch.Tensor,
    k: int = 1,
    *,
    n_valid: Optional[int] = None,
    window: Optional[Tuple[int, int]] = None,
    precise: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact L2 top-k over the gallery: (distances [B, k] divided by D,
    indices [B, k] int32, -1 past ``n_valid``). Queries are rounded to the
    gallery's bf16 (an fp32 gallery is cast to bf16 first), as the JAX
    package's non-precise path does."""
    if window is not None:
        raise NotImplementedError("topk_l2(window=...) is not ported yet")
    if precise:
        raise NotImplementedError("topk_l2(precise=True) is not ported yet")
    if not 1 <= k <= 16:
        raise NotImplementedError(f"topk_l2 supports 1 <= k <= 16, got k={k}")
    n = gallery.shape[0] if n_valid is None else int(n_valid)
    if gallery.dtype != torch.bfloat16:
        gallery = gallery.to(torch.bfloat16)
    q = queries.to(gallery.dtype).contiguous()
    d = q.shape[1]
    if _on_card(q):
        dist, idx = build.launch_topk_l2(q, gallery.contiguous(), k, n)
    else:
        dist, idx = plain.topk_l2_plain(q, gallery, k, n)
    return dist / d, idx
