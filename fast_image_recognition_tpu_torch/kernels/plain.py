"""Plain PyTorch versions of the port's CUDA kernels.

Each computes the same function as its kernel, in straightforward chunked
PyTorch: the CPU tests run them, and ``chip_smoke.py`` holds each kernel
against its plain version on the card. The card's main path never calls
them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

BIG_DIST = 3.4e38
INT_BIG = 2**31 - 1
TILE_G = 1024  # gallery rows per tile of the min-2 packed scan, as in packed_scan.cu


def tilemin_packed_plain(
    q_aug: torch.Tensor,  # [B, Da] bf16 augmented queries
    g_aug: torch.Tensor,  # [Np, Da] bf16 augmented gallery, Np % tile_g == 0
    tile_g: int = TILE_G,
    chunk_rows: int = 65536,
) -> torch.Tensor:
    """Per (query, gallery tile) min packed int32 key
    ``(f32 bits of the augmented dot) & ~(tile_g-1) | row_in_tile``,
    ``[B, n_tiles]`` (counterpart of ``_tilemin_packed_kernel``,
    ops/distance_kernel.py:350)."""
    b = q_aug.shape[0]
    n_tiles = g_aug.shape[0] // tile_g
    qf = q_aug.to(torch.float32)
    rows = torch.arange(tile_g, dtype=torch.int32, device=q_aug.device)
    out = torch.empty((b, n_tiles), dtype=torch.int32, device=q_aug.device)
    step = max(1, chunk_rows // tile_g)
    for t0 in range(0, n_tiles, step):
        t1 = min(t0 + step, n_tiles)
        g = g_aug[t0 * tile_g : t1 * tile_g].to(torch.float32)
        # bf16 x bf16 products are exact in fp32; only the sum order differs
        cross = (qf @ g.T).view(b, t1 - t0, tile_g)
        out[:, t0:t1] = ((cross.view(torch.int32) & ~(tile_g - 1)) | rows).min(dim=2).values
    return out


def tilemin2_packed_plain(
    q_aug: torch.Tensor,  # [B, Da] bf16 augmented queries
    g_aug: torch.Tensor,  # [Np, Da] bf16 augmented gallery, Np % TILE_G == 0
    chunk_tiles: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (query, gallery tile) min and second-min packed int32 key:
    ``(f32 bits of the augmented dot) & ~(TILE_G-1) | row_in_tile``.
    Returns ``(k1, k2)``, each ``[B, n_tiles]`` int32 (counterpart of
    ``_tilemin2_packed_kernel``, ops/distance_kernel.py:393)."""
    b = q_aug.shape[0]
    n_tiles = g_aug.shape[0] // TILE_G
    qf = q_aug.to(torch.float32)
    rows = torch.arange(TILE_G, dtype=torch.int32, device=q_aug.device)
    k1 = torch.empty((b, n_tiles), dtype=torch.int32, device=q_aug.device)
    k2 = torch.empty_like(k1)
    for t0 in range(0, n_tiles, chunk_tiles):
        t1 = min(t0 + chunk_tiles, n_tiles)
        g = g_aug[t0 * TILE_G : t1 * TILE_G].to(torch.float32)
        # bf16 x bf16 products are exact in fp32; only the sum order differs
        cross = (qf @ g.T).view(b, t1 - t0, TILE_G)
        key = (cross.view(torch.int32) & ~(TILE_G - 1)) | rows
        m1 = key.min(dim=2).values
        key = torch.where(key == m1[..., None], INT_BIG, key)
        k1[:, t0:t1] = m1
        k2[:, t0:t1] = key.min(dim=2).values
    return k1, k2


def _tile_argmin(s: torch.Tensor, tile_g: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, rows] scores of whole tiles -> per tile (min, lowest row at the
    min) ``[B, rows // tile_g]``: the ``_masked_argmin`` rule, equal values
    go to the lowest row."""
    b = s.shape[0]
    s = s.view(b, -1, tile_g)
    mins = s.min(dim=2).values
    cols = torch.arange(tile_g, dtype=torch.int32, device=s.device)
    arg = torch.where(s == mins[..., None], cols, INT_BIG).min(dim=2).values
    return mins, arg


def tilemin_plain(
    q: torch.Tensor,  # [B, D] bf16
    g: torch.Tensor,  # [Np, D] bf16, Np % tile_g == 0
    gsq: torch.Tensor,  # [>= Np] fp32 |g|^2 in row order, BIG_DIST on pad rows
    tile_g: int = TILE_G,
    bf16_scores: bool = False,
    chunk_rows: int = 65536,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (query, tile) min and argmin of ``|g|^2 - 2 q.g`` (counterpart of
    ``_tilemin_kernel``, ops/distance_kernel.py:174): bf16 x bf16 products
    summed in fp32; the score in fp32, or with ``bf16_scores`` rounded to
    bf16 at each step (``|g|^2``, ``2 q.g`` and their difference, nearest
    even). Returns (min [B, n_tiles] fp32, global row [B, n_tiles] int32);
    ties go to the lowest row."""
    b = q.shape[0]
    n_tiles = g.shape[0] // tile_g
    qf = q.to(torch.float32)
    out_d = torch.empty((b, n_tiles), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, n_tiles), dtype=torch.int32, device=q.device)
    step = max(1, chunk_rows // tile_g)
    for t0 in range(0, n_tiles, step):
        t1 = min(t0 + step, n_tiles)
        r0, r1 = t0 * tile_g, t1 * tile_g
        cross2 = 2.0 * (qf @ g[r0:r1].to(torch.float32).T)
        gs = gsq[r0:r1]
        if bf16_scores:
            s = (_bf16(gs)[None, :] - _bf16(cross2)).to(torch.bfloat16).to(torch.float32)
        else:
            s = gs[None, :] - cross2
        mins, arg = _tile_argmin(s, tile_g)
        out_d[:, t0:t1] = mins
        out_i[:, t0:t1] = arg + torch.arange(t0, t1, dtype=torch.int32, device=q.device)[None, :] * tile_g
    return out_d, out_i


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def tilemin_quant_plain(
    q: torch.Tensor,  # [B, D] int8
    qs: torch.Tensor,  # [B] fp32 query scales
    g: torch.Tensor,  # [Np, D] int8, Np % tile_g == 0
    gsq: torch.Tensor,  # [>= Np] fp32 true |g|^2, BIG_DIST on pad rows
    gsc: torch.Tensor,  # [>= Np] fp32 row scales, 0 on pad rows
    tile_g: int = TILE_G,
    compute: str = "int8",
    chunk_rows: int = 32768,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (query, tile) min and argmin of ``|g|^2 - (2 s_q)(q.g s_g)`` in
    fp32, one rounding per operation in that order (counterpart of
    ``_tilemin_quant_kernel``, ops/distance_kernel.py:671). ``'int8'``:
    the exact integer dot (float64 sums of int8 products are exact here),
    rounded to fp32; ``'bf16'``: the int8 values as bf16 (exact), products
    summed in fp32. Returns (min [B, n_tiles] fp32, global row int32)."""
    if compute not in ("int8", "bf16"):
        raise ValueError(f"compute must be 'int8' or 'bf16', got {compute!r}")
    b = q.shape[0]
    n_tiles = g.shape[0] // tile_g
    wide = torch.float64 if compute == "int8" else torch.float32
    qw = q.to(wide)
    qs2 = (2.0 * qs.to(torch.float32))[:, None]
    out_d = torch.empty((b, n_tiles), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, n_tiles), dtype=torch.int32, device=q.device)
    step = max(1, chunk_rows // tile_g)
    for t0 in range(0, n_tiles, step):
        t1 = min(t0 + step, n_tiles)
        r0, r1 = t0 * tile_g, t1 * tile_g
        cross = (qw @ g[r0:r1].to(wide).T).to(torch.float32)
        s = gsq[r0:r1][None, :] - qs2 * (cross * gsc[r0:r1][None, :])
        mins, arg = _tile_argmin(s, tile_g)
        out_d[:, t0:t1] = mins
        out_i[:, t0:t1] = arg + torch.arange(t0, t1, dtype=torch.int32, device=q.device)[None, :] * tile_g
    return out_d, out_i


def topk_l2_plain(
    q: torch.Tensor,  # [B, D] bf16, or fp32 with ``precise``
    g: torch.Tensor,  # [N, D] bf16 (or fp32 with ``precise``)
    k: int,
    n_valid: Optional[int] = None,
    window: Optional[Tuple[int, int]] = None,
    precise: bool = False,
    row_mask: Optional[torch.Tensor] = None,
    chunk_rows: int = 65536,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact L2 top-k: ``max(|q|^2 + |g|^2 - 2 q.g, 0)`` in fp32 from the
    stored values, rows >= n_valid excluded, ties to the lowest row index,
    empty slots ``(BIG_DIST, -1)``. ``window=(start, end)`` zeroes the
    feature lanes outside ``[start, end)`` in q, g and |q|^2. ``precise``
    takes fp32 queries and contracts in fp32 (never TF32). Query rows where
    ``row_mask`` is False come back empty. Returns raw squared distances
    ``[B, k]`` fp32 and indices ``[B, k]`` int32 (counterpart of
    ``_topk_kernel``, ops/distance_kernel.py:92)."""
    n = g.shape[0] if n_valid is None else int(n_valid)
    b, dim = q.shape
    qf = q.to(torch.float32)
    fmask = None
    if window is not None:
        lanes = torch.arange(dim, device=q.device)
        fmask = ((lanes >= window[0]) & (lanes < window[1])).to(torch.float32)
        qf = qf * fmask
    qsq = (qf * qf).sum(dim=1, keepdim=True)
    best_d = torch.full((b, k), BIG_DIST, dtype=torch.float32, device=q.device)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=q.device)
    for r0 in range(0, n, chunk_rows):
        r1 = min(r0 + chunk_rows, n)
        gf = g[r0:r1].to(torch.float32)
        if fmask is not None:
            gf = gf * fmask
        gsq = (gf * gf).sum(dim=1)
        d = torch.clamp_min((qsq + gsq[None, :]) - 2.0 * (qf @ gf.T), 0.0)
        idx = torch.arange(r0, r1, device=q.device).expand(b, -1)
        # carry first, rows ascending: a stable sort keeps the lowest index
        all_d = torch.cat([best_d, d], dim=1)
        all_i = torch.cat([best_i, idx], dim=1)
        order = torch.sort(all_d, dim=1, stable=True).indices[:, :k]
        best_d = all_d.gather(1, order)
        best_i = all_i.gather(1, order)
    if row_mask is not None:
        best_d = torch.where(row_mask[:, None], best_d, BIG_DIST)
        best_i = torch.where(row_mask[:, None], best_i, -1)
    return best_d, best_i.to(torch.int32)


def chi2_nn_plain(
    q: torch.Tensor,  # [B, D] fp32
    g: torch.Tensor,  # [N, D] fp32 or bf16
    n_valid: Optional[int] = None,
    tile_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """chi2 1-NN: per query the least ``sum (g - q)^2 / max(g + q, 1e-30)``
    in fp32 with exact division over rows [0, n_valid), and the lowest row
    at it (counterpart of ``_chi2_kernel``, ops/chi2_kernel.py:55). Works
    through ``tile_rows`` gallery rows at a time (default: the [B, tile, D]
    broadcast under 2^26 elements, a multiple of 128 rows, as
    ``_elementwise_tile`` is driven). Returns (min [B] fp32, unnormalized;
    row [B] int32)."""
    b, d = q.shape
    n = g.shape[0] if n_valid is None else int(n_valid)
    if tile_rows is None:
        tile_rows = max(128, (1 << 26) // max(b * d, 1)) // 128 * 128
    qf = q.to(torch.float32)[:, None, :]
    best_d = torch.full((b,), BIG_DIST, dtype=torch.float32, device=q.device)
    best_i = torch.full((b,), -1, dtype=torch.int32, device=q.device)
    for r0 in range(0, n, tile_rows):
        gt = g[r0 : min(r0 + tile_rows, n)].to(torch.float32)[None]
        s = (qf + gt).clamp_min_(1e-30)
        dist = (qf - gt).square_().div_(s).sum(dim=2)  # [B, T]
        del s
        m = dist.min(dim=1).values
        cols = torch.arange(dist.shape[1], dtype=torch.int32, device=q.device)
        arg = torch.where(dist == m[:, None], cols, INT_BIG).min(dim=1).values
        better = m < best_d  # strict: an earlier tile keeps its row on a tie
        best_i = torch.where(better, arg + r0, best_i)
        best_d = torch.where(better, m, best_d)
    return best_d, best_i


def act_plain(x: torch.Tensor, activation: str) -> torch.Tensor:
    """The MBConv activations on fp32 values (``_act``,
    ops/mbconv_kernel.py:76): ``relu6`` or swish."""
    return torch.clamp(x, 0.0, 6.0) if activation == "relu6" else F.silu(x)


def mbconv_plain(
    x: torch.Tensor,  # [B, Cin, H, W] in the working dtype (bf16 on the card)
    q: Dict[str, torch.Tensor],  # ops.mbconv_kernel.prepare_params layout
    kernel: int,
    pads: Tuple[Tuple[int, int], Tuple[int, int]],  # ((low, high) in H, (low, high) in W)
    activation: str,
    residual: bool,
    chunk: int = 64,
) -> torch.Tensor:
    """One folded stride-1 MBConv block, ``[B, Cout, H, W]`` channels_last
    in ``x.dtype`` (counterpart of ``_mbconv_kernel``,
    ops/mbconv_kernel.py:82). It rounds to ``x.dtype`` where
    ``kernels/mbconv.cu`` rounds to bf16: the hidden tensor after expand,
    bias and activation; the depthwise output after its bias and
    activation (the kernel stores it between its two launches; the TPU
    kernel keeps it in fp32); the SE-scaled hidden before the project; the
    output. The depthwise sums, the SE pool (of the unrounded depthwise
    output) and the SE MLP stay fp32, and the project adds bias and
    residual in fp32. In fp32 every rounding is a no-op."""
    dt = x.dtype
    b, _, h, w = x.shape
    ce = q["w_dw"].shape[1]
    cout = q["w_proj"].shape[1]
    (pl_h, ph_h), (pl_w, ph_w) = pads
    w_dw = q["w_dw"].t().reshape(ce, 1, kernel, kernel)
    out = torch.empty((b, cout, h, w), dtype=dt, device=x.device, memory_format=torch.channels_last)
    for s in range(0, b, chunk):
        xs = x[s : s + chunk].permute(0, 2, 3, 1).to(torch.float32)  # NHWC
        hid = xs
        if "w_exp" in q:
            hid = act_plain(xs @ q["w_exp"].to(torch.float32) + q["b_exp"], activation).to(dt)
        hid = F.pad(hid.permute(0, 3, 1, 2).to(torch.float32), (pl_w, ph_w, pl_h, ph_h))
        a = act_plain(F.conv2d(hid, w_dw, groups=ce) + q["b_dw"][None, :, None, None], activation)
        d = a.to(dt).to(torch.float32)
        if "w_se1" in q:
            se = F.silu(a.mean(dim=(2, 3)) @ q["w_se1"] + q["b_se1"])
            gate = torch.sigmoid(se @ q["w_se2"] + q["b_se2"])
            d = (d * gate[:, :, None, None]).to(dt).to(torch.float32)
        y = d.permute(0, 2, 3, 1) @ q["w_proj"].to(torch.float32) + q["b_proj"]
        if residual:
            y = y + xs
        out[s : s + chunk] = y.permute(0, 3, 1, 2).to(dt)
    return out
