"""Gallery scans (JAX ``ops/distance_kernel.py``): CUDA kernels on CUDA tensors,
plain versions on CPU ones; on the card a gallery is 8 lanes wide a multiple
(16 for int8): :func:`pad_cols`."""

from typing import Optional, Tuple

import torch

from ..kernels import build, plain
from .quant import quantize_rows

BIG_DIST = plain.BIG_DIST
TILE_G = plain.TILE_G
_PAD_SQ_NORM = 1e38  # finite in bf16: BIG_DIST rounds to inf, and inf - inf = NaN
TOPK_SLAB = build.TOPK_MAX_K  # topk_l2 columns per scan; a larger k runs in slabs


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _row_sq_norms(g: torch.Tensor, chunk_rows: int = 65536) -> torch.Tensor:
    """fp32 |row|^2 of a bf16 matrix, chunked (no fp32 copy)."""
    out = torch.empty((g.shape[0],), dtype=torch.float32, device=g.device)
    for s in range(0, g.shape[0], chunk_rows):
        gf = g[s : s + chunk_rows].to(torch.float32)
        out[s : s + chunk_rows] = (gf * gf).sum(dim=1)
    return out


COL_ALIGN = 16  # 16-byte vectors: 8 bf16 or 16 int8 lanes


def pad_cols(x: torch.Tensor, m: int = COL_ALIGN) -> torch.Tensor:
    """Zero columns up to a multiple of ``m``; queries keep their width."""
    d = x.shape[1]
    return x if d % m == 0 else torch.nn.functional.pad(x, (0, _round_up(d, m) - d))


def _match_cols(q: torch.Tensor, g: torch.Tensor, m: int) -> torch.Tensor:
    """Queries zero-padded to the gallery's width."""
    dq, dg = q.shape[1], g.shape[1]
    if dg not in (dq, _round_up(dq, COL_ALIGN)):
        raise ValueError(f"queries [{q.shape[0]}, {dq}] do not fit a gallery of width {dg}")
    if g.device.type == "cuda" and dg % m:
        raise ValueError(f"gallery width {dg} is not a multiple of {m}: pad it once with pad_cols")
    return q if dq == dg else torch.nn.functional.pad(q, (0, dg - dq))


def _check_tile_g(tile_g: int) -> int:
    if tile_g not in (128, 256, 512, 1024):
        raise ValueError(f"tile_g must be a power of two from 128 to 1024, got {tile_g}")
    return tile_g


def pad_gallery(gallery: torch.Tensor, tile_g: int = TILE_G) -> torch.Tensor:
    """Zero-pad rows to a tile multiple (once, at build time)."""
    n = gallery.shape[0]
    np_ = _round_up(max(n, tile_g), _check_tile_g(tile_g))
    if np_ == n:
        return gallery
    return torch.nn.functional.pad(gallery, (0, 0, 0, np_ - n))


def _tile_rows(v: torch.Tensor, tile_g: int, fill: float) -> torch.Tensor:
    """Per-row values -> the kernel layout ``[roundup(n_tiles, 8), tile_g]``, the rest ``fill``."""
    n_tiles = v.shape[0] // tile_g
    v = v.view(n_tiles, tile_g)
    n_rows = _round_up(n_tiles, 8)
    if n_rows != n_tiles:
        v = torch.nn.functional.pad(v, (0, 0, 0, n_rows - n_tiles), value=fill)
    return v


def gallery_sq_norms(gallery: torch.Tensor, n_valid: int, tile_g: int = TILE_G) -> torch.Tensor:
    """|g|^2 in the tile layout, fp32, BIG_DIST past n_valid."""
    gallery = pad_gallery(gallery, tile_g)
    gsq = _row_sq_norms(gallery)
    gsq = torch.where(torch.arange(gallery.shape[0], device=gsq.device) < n_valid, gsq, BIG_DIST)
    return _tile_rows(gsq, tile_g, BIG_DIST)


def quant_gallery_scales(scales: torch.Tensor, n_valid: int, tile_g: int = TILE_G) -> torch.Tensor:
    """Dequantization scales in the tile layout, 0 past n_valid."""
    n = scales.shape[0]
    np_ = _round_up(max(n, tile_g), _check_tile_g(tile_g))
    s = torch.nn.functional.pad(scales.to(torch.float32), (0, np_ - n))
    s = torch.where(torch.arange(np_, device=s.device) < n_valid, s, 0.0)
    return _tile_rows(s, tile_g, 0.0)


def pack_gallery_aug(gallery: torch.Tensor, n_valid: Optional[int] = None, tile_g: int = TILE_G) -> torch.Tensor:
    """Augmented bf16 gallery ``[g, |g|^2_hi, |g|^2_lo, 1, 1]`` (columns to 128,
    rows to ``tile_g`` with |g|^2 = 1e38): with the query's ``[-2q, 1, 1,
    |q|^2_hi, |q|^2_lo]`` one dot is the squared distance."""
    n = gallery.shape[0] if n_valid is None else int(n_valid)
    g = pad_gallery(gallery, tile_g).to(torch.bfloat16)
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


def _key_to_dist(keys: torch.Tensor, tile_g: int = TILE_G) -> torch.Tensor:
    return torch.clamp_min((keys & ~(tile_g - 1)).view(torch.float32), 0.0)


def _key_to_row(keys: torch.Tensor, tile_g: int = TILE_G) -> torch.Tensor:
    """Global gallery row of each ``[B, n_tiles]`` packed key."""
    tiles = torch.arange(keys.shape[1], dtype=torch.int32, device=keys.device) * tile_g
    return tiles[None, :] + (keys & (tile_g - 1))


def tilemin_keys(q_aug: torch.Tensor, g_aug: torch.Tensor, tile_g: int) -> torch.Tensor:
    """Per (query, tile) min packed key, int32."""
    if _on_card(q_aug):
        return build.launch_tilemin_packed(q_aug, g_aug, tile_g)
    return plain.tilemin_packed_plain(q_aug, g_aug, tile_g)


def tile_min_l2_packed(
    queries: torch.Tensor, gallery_aug: torch.Tensor, d: int, tile_g: int = TILE_G
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(each tile's best distance / ``d``, its row), ~2^-13 relative: callers rescore."""
    qa = _augment_queries(queries, d, gallery_aug.shape[1])
    keys = tilemin_keys(qa, gallery_aug, _check_tile_g(tile_g))
    return _key_to_dist(keys, tile_g) / d, _key_to_row(keys, tile_g)


def _select_tiles(d: torch.Tensor, r: int, select: str) -> torch.Tensor:
    """The R nearest tiles, ties to the lower; ``'approx'`` the same (``approx_min_k`` is exact off the TPU)."""
    if select not in ("exact", "approx"):
        raise ValueError(f"unknown select {select!r}")
    return torch.sort(d, dim=1, stable=True).indices[:, :r]


def topk_candidates_l2_packed(queries: torch.Tensor, gallery_aug: torch.Tensor, d: int, r: int, tile_g: int = TILE_G,
    select: str = "exact") -> torch.Tensor:
    """The best row of each of the R nearest tiles; callers rescore."""
    dt, it = tile_min_l2_packed(queries, gallery_aug, d, tile_g)
    return it.gather(1, _select_tiles(dt, min(r, dt.shape[1]), select))


def rescore_rows(gallery: torch.Tensor, emb: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """``|g|^2 - 2 q.g`` of rows ``cand`` in fp32 from bf16 operands."""
    rows = gallery[cand].to(torch.float32)  # [B, R, D]
    e16 = emb.to(torch.bfloat16).to(torch.float32)
    cross = torch.einsum("bd,brd->br", e16, rows)
    rsq = torch.einsum("brd,brd->br", rows, rows)
    return rsq - 2.0 * cross


def tilemin2_keys(q_aug: torch.Tensor, g_aug: torch.Tensor):
    """Per (query, tile) min and second-min packed keys, int32."""
    if _on_card(q_aug):
        return build.launch_tilemin2_packed(q_aug, g_aug)
    return plain.tilemin2_packed_plain(q_aug, g_aug)


def decode_tile_keys(k1: torch.Tensor, k2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Packed keys -> (d1, global row of each tile's best, d2)."""
    return _key_to_dist(k1), _key_to_row(k1), _key_to_dist(k2)


def tile_min2_l2_packed(
    queries: torch.Tensor, gallery_aug: torch.Tensor, d: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d1 of each tile's best row, its row, d2 the second best), ~2^-13 relative toward zero."""
    qa = _augment_queries(queries, d, gallery_aug.shape[1])
    k1, k2 = tilemin2_keys(qa, gallery_aug)
    return decode_tile_keys(k1, k2)


def certify_tiles(d1t: torch.Tensor, it: torch.Tensor, d2t: torch.Tensor, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile (d1, row, d2) -> (cand [B, R], bound [B]): :func:`topk_candidates_l2_packed_cert`."""
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
    """(cand [B, R] rows, bound [B]): ``bound`` lower-bounds every row outside ``cand`` (up to bf16
    rounding): the (R+1)-th tile min, selected tiles' second mins."""
    return certify_tiles(*tile_min2_l2_packed(queries, gallery_aug, d), r)


def tilemin_scores(
    q: torch.Tensor, g: torch.Tensor, gsq: torch.Tensor, tile_g: int, bf16_scores: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (query, tile) min of ``|g|^2 - 2 q.g`` (bf16 operands) and its lowest row."""
    gsq = gsq.reshape(-1)
    q = _match_cols(q, g, 8)
    if _on_card(q):
        return build.launch_tilemin(q, g, gsq, tile_g, bf16_scores)
    return plain.tilemin_plain(q, g, gsq, tile_g, bf16_scores)


def tile_min_l2(queries: torch.Tensor, gallery: torch.Tensor, *, n_valid: Optional[int] = None, tile_g: int = TILE_G,
    gsq: Optional[torch.Tensor] = None, precise_scores: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile L2 min (dist / D, row); ``precise_scores=False`` rounds the scores to bf16."""
    d = queries.shape[1]
    n = gallery.shape[0] if n_valid is None else int(n_valid)
    gallery = pad_gallery(gallery, _check_tile_g(tile_g))
    if gallery.dtype != torch.bfloat16:
        gallery = gallery.to(torch.bfloat16)
    if gsq is None:
        gsq = gallery_sq_norms(gallery, n, tile_g)
    qf = queries.to(torch.float32)
    qsq = (qf * qf).sum(dim=1)
    out_d, out_i = tilemin_scores(queries.to(torch.bfloat16).contiguous(), gallery, gsq, tile_g, not precise_scores)
    return torch.clamp_min(out_d + qsq[:, None], 0.0) / d, out_i


def topk_candidates_l2(queries: torch.Tensor, gallery: torch.Tensor, r: int, *, n_valid: Optional[int] = None,
    tile_g: int = TILE_G, gsq: Optional[torch.Tensor] = None, precise_scores: bool = True, select: str = "exact"
) -> torch.Tensor:
    """The best rows of the R nearest tiles by :func:`tile_min_l2`; callers rescore."""
    dt, it = tile_min_l2(queries, gallery, n_valid=n_valid, tile_g=tile_g, gsq=gsq, precise_scores=precise_scores)
    return it.gather(1, _select_tiles(dt, min(r, dt.shape[1]), select))


def tilemin_quant_scores(q: torch.Tensor, qs: torch.Tensor, g: torch.Tensor, gsq: torch.Tensor, gsc: torch.Tensor,
    tile_g: int, compute: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (query, tile) min of ``gsq - (2 s_q)(q.g s_g)`` (int8 operands) and its lowest row."""
    gsq, gsc = gsq.reshape(-1), gsc.reshape(-1)
    q = _match_cols(q, g, 16)
    if _on_card(q):
        return build.launch_tilemin_quant(q, qs, g, gsq, gsc, tile_g, compute)
    return plain.tilemin_quant_plain(q, qs, g, gsq, gsc, tile_g, compute)


def tile_min_l2_quant(queries: torch.Tensor, gallery_q: torch.Tensor, gsq_rows: torch.Tensor, gsc_rows: torch.Tensor, *,
    tile_g: int = TILE_G, compute: str = "int8") -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile approximate L2 min over int8 rows (dist / D, row); ``gsq_rows``: unquantized norms."""
    if compute not in ("int8", "bf16"):
        raise ValueError(f"compute must be 'int8' or 'bf16', got {compute!r}")
    d = queries.shape[1]
    qf = queries.to(torch.float32)
    qsq = (qf * qf).sum(dim=1)
    q_i8, qs = quantize_rows(qf)
    out_d, out_i = tilemin_quant_scores(q_i8, qs, gallery_q, gsq_rows, gsc_rows, _check_tile_g(tile_g), compute)
    return torch.clamp_min(out_d + qsq[:, None], 0.0) / d, out_i


def topk_candidates_l2_quant(queries: torch.Tensor, gallery_q: torch.Tensor, gsq_rows: torch.Tensor,
    gsc_rows: torch.Tensor, r: int, *, tile_g: int = TILE_G, compute: str = "int8", select: str = "exact"
) -> torch.Tensor:
    """:func:`topk_candidates_l2` over an int8 gallery."""
    dt, it = tile_min_l2_quant(queries, gallery_q, gsq_rows, gsc_rows, tile_g=tile_g, compute=compute)
    return it.gather(1, _select_tiles(dt, min(r, dt.shape[1]), select))


def topk_l2_quant(queries: torch.Tensor, gallery_q: torch.Tensor, gsq_rows: torch.Tensor, gsc_rows: torch.Tensor,
    rescore_gallery: torch.Tensor, k: int = 1, *, r: int = 16, tile_g: int = TILE_G, compute: str = "int8"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of the ``r`` nearest int8 tiles' rows, rescored in fp32: (distances / D, rows)."""
    cand = topk_candidates_l2_quant(queries, gallery_q, gsq_rows, gsc_rows, r, tile_g=tile_g, compute=compute)
    rows = rescore_gallery[cand.long()].to(torch.float32)  # [B, R, D]
    qf = queries.to(rescore_gallery.dtype).to(torch.float32)
    cross = torch.einsum("bd,brd->br", qf, rows)
    rsq = torch.einsum("brd,brd->br", rows, rows)
    qsq = (qf * qf).sum(dim=1)
    dist = torch.clamp_min(qsq[:, None] + rsq - 2.0 * cross, 0.0)
    # stable ascending sort = lax.top_k(-dist): ties to the earlier column
    sel = torch.sort(dist, dim=1, stable=True).indices[:, : min(k, cand.shape[1])]
    return dist.gather(1, sel) / queries.shape[1], cand.gather(1, sel)


def topk_l2(queries: torch.Tensor, gallery: torch.Tensor, k: int = 1, *, n_valid: Optional[int] = None,
    window: Optional[Tuple[int, int]] = None, precise: bool = False, row_mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact L2 top-k: (distances / window width, rows, -1 past ``n_valid``), bf16 or ``precise=True``;
    ``row_mask``: False rows empty. Past :data:`TOPK_SLAB` in slabs above the last's final entry. Distances
    summed again as ``(q - g)^2`` (pass 3)."""
    if k < 1:
        raise ValueError(f"topk_l2 takes k >= 1, got k={k}")
    n = gallery.shape[0] if n_valid is None else int(n_valid)
    d = queries.shape[1]
    start, end = (0, d) if window is None else (int(window[0]), int(window[1]))
    if not 0 <= start < end <= d:
        raise ValueError(f"window must satisfy 0 <= start < end <= {d}, got {window}")
    if precise:
        if row_mask is not None:
            raise ValueError("row_mask is not taken with precise=True")
        if gallery.dtype not in (torch.float32, torch.bfloat16):
            gallery = gallery.to(torch.float32)
        q = queries.to(torch.float32).contiguous()
    else:
        if gallery.dtype != torch.bfloat16:
            gallery = gallery.to(torch.bfloat16)
        q = queries.to(torch.bfloat16).contiguous()
    gallery = gallery.contiguous()
    q = _match_cols(q, gallery, 8)
    card = _on_card(q)

    def scan(kk: int, floor):
        if card:
            return build.launch_topk_l2(q, gallery, kk, n, window, precise, row_mask, floor)
        return plain.topk_l2_plain(q, gallery, kk, n, window, precise, row_mask, floor=floor)

    if k <= TOPK_SLAB:
        dist, idx = scan(k, None)
    else:
        # slabs of at most TOPK_SLAB, as even as they come (each one > 16, a
        # list kernel's k on the card); each above the last one's final entry
        n_slabs = -(-k // TOPK_SLAB)
        widths = [k // n_slabs + (j < k % n_slabs) for j in range(n_slabs)]
        parts, floor = [], None
        for kk in widths:
            d_s, i_s = scan(kk, floor)
            parts.append((d_s, i_s))
            floor = (d_s[:, -1], i_s[:, -1])
        dist, idx = torch.cat([d for d, _ in parts], dim=1), torch.cat([i for _, i in parts], dim=1)
    rescore = build.launch_topk_rescore if card else plain.topk_rescore_plain
    dist, idx = rescore(q, gallery, dist, idx, window)
    return dist / (end - start), idx
