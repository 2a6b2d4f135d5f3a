"""Gallery scans of the serving paths (counterpart of
``fast_image_recognition_tpu/ops/distance_kernel.py``: the packed, bf16 and
int8 tile scans, the candidate selections built on them, and the exact
top-k with its feature window and fp32 ``precise`` mode).

Each wrapper runs the hand-written CUDA kernel (``kernels/*.cu``) on a CUDA
tensor and its plain PyTorch version (``kernels/plain.py``) on a CPU
tensor; any other device raises. Shapes, padding and the augmented layouts
live here, in Python the CPU tests reach. A gallery may carry
:func:`pad_cols` zero columns past its queries' width; on the card its
width must be a multiple of 8 lanes (16 for the int8 scans), so a caller
pads it once where it is built.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fast_image_recognition_tpu_torch.kernels import build, plain
from fast_image_recognition_tpu_torch.ops.quant import quantize_rows

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
    """fp32 |row|^2 of a bf16 matrix (exact squares, fp32 sums), a chunk
    of rows at a time (no fp32 copy of a large gallery)."""
    out = torch.empty((g.shape[0],), dtype=torch.float32, device=g.device)
    for s in range(0, g.shape[0], chunk_rows):
        gf = g[s : s + chunk_rows].to(torch.float32)
        out[s : s + chunk_rows] = (gf * gf).sum(dim=1)
    return out


COL_ALIGN = 16  # the card's scans load 16-byte vectors: 8 bf16 or 16 int8 lanes


def pad_cols(x: torch.Tensor, m: int = COL_ALIGN) -> torch.Tensor:
    """Zero columns up to a multiple of ``m``: pad a gallery once, where it
    is built (zeros change no dot product or norm). The scans take such a
    gallery with queries of the unpadded width."""
    d = x.shape[1]
    return x if d % m == 0 else torch.nn.functional.pad(x, (0, _round_up(d, m) - d))


def _match_cols(q: torch.Tensor, g: torch.Tensor, m: int) -> torch.Tensor:
    """Queries zero-padded (cheap, per call) to the gallery's width, which
    may exceed theirs by :func:`pad_cols`'s padding. On the card the
    gallery's width must be a multiple of ``m``: the scans never copy a
    gallery per call."""
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
    """Per-row values [Np] -> the kernel layout ``[roundup(n_tiles, 8),
    tile_g]``, extra rows filled with ``fill``."""
    n_tiles = v.shape[0] // tile_g
    v = v.view(n_tiles, tile_g)
    n_rows = _round_up(n_tiles, 8)
    if n_rows != n_tiles:
        v = torch.nn.functional.pad(v, (0, 0, 0, n_rows - n_tiles), value=fill)
    return v


def gallery_sq_norms(gallery: torch.Tensor, n_valid: int, tile_g: int = TILE_G) -> torch.Tensor:
    """|g|^2 in the tile layout ``[roundup(n_tiles, 8), tile_g]`` fp32,
    BIG_DIST on rows >= n_valid. Compute it once per gallery and pass it
    to the scans."""
    gallery = pad_gallery(gallery, tile_g)
    gsq = _row_sq_norms(gallery)
    gsq = torch.where(torch.arange(gallery.shape[0], device=gsq.device) < n_valid, gsq, BIG_DIST)
    return _tile_rows(gsq, tile_g, BIG_DIST)


def quant_gallery_scales(scales: torch.Tensor, n_valid: int, tile_g: int = TILE_G) -> torch.Tensor:
    """Per-row dequantization scales in the layout of
    :func:`gallery_sq_norms`, 0 on rows >= n_valid and on pads."""
    n = scales.shape[0]
    np_ = _round_up(max(n, tile_g), _check_tile_g(tile_g))
    s = torch.nn.functional.pad(scales.to(torch.float32), (0, np_ - n))
    s = torch.where(torch.arange(np_, device=s.device) < n_valid, s, 0.0)
    return _tile_rows(s, tile_g, 0.0)


def pack_gallery_aug(
    gallery: torch.Tensor, n_valid: Optional[int] = None, tile_g: int = TILE_G
) -> torch.Tensor:
    """Augmented bf16 gallery ``[g, |g|^2_hi, |g|^2_lo, 1, 1]``, columns
    padded to a 128 multiple, rows to ``tile_g`` with |g|^2 = 1e38. With the
    query-side ``[-2q, 1, 1, |q|^2_hi, |q|^2_lo]`` one bf16 dot gives the
    whole squared distance; the hi/lo split carries the norm to ~2^-17."""
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
    """Per (query, tile) min packed key, ``[B, n_tiles]`` int32: the
    single-min kernel of ``kernels/packed_scan.cu`` on the card, the plain
    version on the CPU."""
    if _on_card(q_aug):
        return build.launch_tilemin_packed(q_aug, g_aug, tile_g)
    return plain.tilemin_packed_plain(q_aug, g_aug, tile_g)


def tile_min_l2_packed(
    queries: torch.Tensor, gallery_aug: torch.Tensor, d: int, tile_g: int = TILE_G
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dist [B, n_tiles] squared L2 of each tile's best row divided by
    ``d``, its global row [B, n_tiles] int32). Distances are quantized to
    ~2^-13 relative: they select tiles, and the caller rescores."""
    qa = _augment_queries(queries, d, gallery_aug.shape[1])
    keys = tilemin_keys(qa, gallery_aug, _check_tile_g(tile_g))
    return _key_to_dist(keys, tile_g) / d, _key_to_row(keys, tile_g)


def _select_tiles(d: torch.Tensor, r: int, select: str) -> torch.Tensor:
    """[B, n_tiles] tile minima -> [B, R] columns of the R nearest tiles.
    A stable ascending sort is ``lax.top_k(-d)``'s rule: ties go to the
    lower tile. ``select='approx'`` (JAX ``lax.approx_min_k`` at recall
    0.99) takes the same exact selection: XLA lowers ``approx_min_k`` to
    an exact top-k off the TPU too, same rows in the same order, and an
    exact selection meets any recall target."""
    if select not in ("exact", "approx"):
        raise ValueError(f"unknown select {select!r}")
    return torch.sort(d, dim=1, stable=True).indices[:, :r]


def topk_candidates_l2_packed(
    queries: torch.Tensor,
    gallery_aug: torch.Tensor,
    d: int,
    r: int,
    tile_g: int = TILE_G,
    select: str = "exact",
) -> torch.Tensor:
    """Candidate rows [B, R] int32: the best row of each of the R nearest
    tiles by the single-min packed scan. They hold the exact 1-NN up to
    bf16 operand rounding and the key quantization; callers rescore."""
    dt, it = tile_min_l2_packed(queries, gallery_aug, d, tile_g)
    return it.gather(1, _select_tiles(dt, min(r, dt.shape[1]), select))


def rescore_rows(gallery: torch.Tensor, emb: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """``|g|^2 - 2 q.g`` [B, R] of the candidate rows ``cand`` [B, R], in
    fp32 from the bf16 rows and the bf16-rounded query (a bf16 einsum would
    round the products' sum to bf16 and flip near-tie winners)."""
    rows = gallery[cand].to(torch.float32)  # [B, R, D]
    e16 = emb.to(torch.bfloat16).to(torch.float32)
    cross = torch.einsum("bd,brd->br", e16, rows)
    rsq = torch.einsum("brd,brd->br", rows, rows)
    return rsq - 2.0 * cross


def tilemin2_keys(q_aug: torch.Tensor, g_aug: torch.Tensor):
    """Per (query, tile) min and second-min packed keys, ``[B, n_tiles]``
    int32 each: ``kernels/packed_scan.cu`` on the card, the plain version
    on the CPU."""
    if _on_card(q_aug):
        return build.launch_tilemin2_packed(q_aug, g_aug)
    return plain.tilemin2_packed_plain(q_aug, g_aug)


def decode_tile_keys(k1: torch.Tensor, k2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Packed keys -> (d1, global row of each tile's best, d2)."""
    return _key_to_dist(k1), _key_to_row(k1), _key_to_dist(k2)


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


def tilemin_scores(
    q: torch.Tensor, g: torch.Tensor, gsq: torch.Tensor, tile_g: int, bf16_scores: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (query, tile) min of ``|g|^2 - 2 q.g`` over bf16 operands and its
    lowest row, ``[B, n_tiles]`` fp32 and int32: ``kernels/tile_scan.cu`` on
    the card, the plain version on the CPU."""
    gsq = gsq.reshape(-1)
    q = _match_cols(q, g, 8)
    if _on_card(q):
        return build.launch_tilemin(q, g, gsq, tile_g, bf16_scores)
    return plain.tilemin_plain(q, g, gsq, tile_g, bf16_scores)


def tile_min_l2(
    queries: torch.Tensor,
    gallery: torch.Tensor,
    *,
    n_valid: Optional[int] = None,
    tile_g: int = TILE_G,
    gsq: Optional[torch.Tensor] = None,
    precise_scores: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-gallery-tile L2 min: (dist [B, n_tiles] squared L2 of each
    tile's best row divided by D, its global row [B, n_tiles] int32).

    The products always run on bf16 operands (fp32 inputs are rounded), so
    the 1-NN stays in its tile's min up to bf16 operand rounding; callers
    rescore. ``precise_scores=False`` rounds the scores to bf16 as well,
    which makes near-equal rows tie (the lowest row wins). ``gsq``: a
    precomputed :func:`gallery_sq_norms` of the same gallery. |q|^2 is
    taken from the queries as given, before the bf16 cast."""
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


def topk_candidates_l2(
    queries: torch.Tensor,
    gallery: torch.Tensor,
    r: int,
    *,
    n_valid: Optional[int] = None,
    tile_g: int = TILE_G,
    gsq: Optional[torch.Tensor] = None,
    precise_scores: bool = True,
    select: str = "exact",
) -> torch.Tensor:
    """Candidate rows [B, R] int32: the best row of each of the R nearest
    tiles by :func:`tile_min_l2`. They hold the exact 1-NN up to bf16
    operand rounding; callers rescore."""
    dt, it = tile_min_l2(
        queries, gallery, n_valid=n_valid, tile_g=tile_g, gsq=gsq, precise_scores=precise_scores
    )
    return it.gather(1, _select_tiles(dt, min(r, dt.shape[1]), select))


def tilemin_quant_scores(
    q: torch.Tensor,
    qs: torch.Tensor,
    g: torch.Tensor,
    gsq: torch.Tensor,
    gsc: torch.Tensor,
    tile_g: int,
    compute: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (query, tile) min of ``gsq - (2 s_q)(q.g s_g)`` over int8
    operands and its lowest row: ``kernels/tile_scan.cu`` on the card, the
    plain version on the CPU."""
    gsq, gsc = gsq.reshape(-1), gsc.reshape(-1)
    q = _match_cols(q, g, 16)
    if _on_card(q):
        return build.launch_tilemin_quant(q, qs, g, gsq, gsc, tile_g, compute)
    return plain.tilemin_quant_plain(q, qs, g, gsq, gsc, tile_g, compute)


def tile_min_l2_quant(
    queries: torch.Tensor,
    gallery_q: torch.Tensor,
    gsq_rows: torch.Tensor,
    gsc_rows: torch.Tensor,
    *,
    tile_g: int = TILE_G,
    compute: str = "int8",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-gallery-tile approximate L2 min over an int8 gallery (padded to
    ``tile_g`` rows): (dist [B, n_tiles] divided by D, global row [B,
    n_tiles] int32). Queries are quantized per row here; ``gsq_rows`` is
    :func:`gallery_sq_norms` of the gallery before quantization and
    ``gsc_rows`` :func:`quant_gallery_scales`. ``compute='int8'`` takes
    the exact int32 dot, ``'bf16'`` sums bf16 products in fp32."""
    if compute not in ("int8", "bf16"):
        raise ValueError(f"compute must be 'int8' or 'bf16', got {compute!r}")
    d = queries.shape[1]
    qf = queries.to(torch.float32)
    qsq = (qf * qf).sum(dim=1)
    q_i8, qs = quantize_rows(qf)
    out_d, out_i = tilemin_quant_scores(q_i8, qs, gallery_q, gsq_rows, gsc_rows, _check_tile_g(tile_g), compute)
    return torch.clamp_min(out_d + qsq[:, None], 0.0) / d, out_i


def topk_candidates_l2_quant(
    queries: torch.Tensor,
    gallery_q: torch.Tensor,
    gsq_rows: torch.Tensor,
    gsc_rows: torch.Tensor,
    r: int,
    *,
    tile_g: int = TILE_G,
    compute: str = "int8",
    select: str = "exact",
) -> torch.Tensor:
    """:func:`topk_candidates_l2` over an int8 gallery: [B, R] int32 rows,
    the 1-NN among them up to int8 rounding near-ties; callers rescore."""
    dt, it = tile_min_l2_quant(queries, gallery_q, gsq_rows, gsc_rows, tile_g=tile_g, compute=compute)
    return it.gather(1, _select_tiles(dt, min(r, dt.shape[1]), select))


def topk_l2_quant(
    queries: torch.Tensor,
    gallery_q: torch.Tensor,
    gsq_rows: torch.Tensor,
    gsc_rows: torch.Tensor,
    rescore_gallery: torch.Tensor,
    k: int = 1,
    *,
    r: int = 16,
    tile_g: int = TILE_G,
    compute: str = "int8",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-rescored top-k over an int8-scanned gallery: the best row of
    each of the ``r`` nearest tiles by the int8 scan, rescored in fp32 from
    ``rescore_gallery``'s rows and the queries in its dtype. Returns
    (distances [B, k'] divided by D, rows [B, k'] int32) with
    ``k' = min(k, r, n_tiles)``; ties go to the earlier candidate."""
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


def topk_l2(
    queries: torch.Tensor,
    gallery: torch.Tensor,
    k: int = 1,
    *,
    n_valid: Optional[int] = None,
    window: Optional[Tuple[int, int]] = None,
    precise: bool = False,
    row_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact L2 top-k over the gallery: (distances [B, k] divided by the
    window width, indices [B, k] int32, -1 past ``n_valid``).

    By default queries are rounded to bf16 (an fp32 gallery is cast to
    bf16 first), as the JAX package's fast path does. ``precise=True`` is
    the fp32 oracle: fp32 queries against the rows as stored (fp32, or bf16
    upcast exactly), contracted in fp32. ``window=(start, end)`` scans the
    feature lanes [start, end) only. ``row_mask`` ([B] bool, not with
    ``precise``): query rows where it is False come back empty
    ``(BIG_DIST / width, -1)``, and on the card the kernel skips query
    blocks without a True, so a mask that is all False costs one launch
    and no scan (and no host sync). Any k >= 1: above :data:`TOPK_SLAB`
    (``build.TOPK_MAX_K``, 256, the most one launch takes) the top-k is
    scanned in slabs, each admitting only the (distance, row) after the
    previous slab's last entry, so the slabs join into the exact top-k with
    the same ties."""
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
    return dist / (end - start), idx
