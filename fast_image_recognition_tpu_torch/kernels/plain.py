"""Plain PyTorch versions of the CUDA kernels, in chunks: what the CPU runs and
``chip_smoke.py`` holds each kernel against."""

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
    """Per (query, tile) min key ``(f32 bits of the dot) & ~(tile_g-1) | row_in_tile`` (``_tilemin_packed_kernel``)."""
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
    """Per (query, tile) min and second-min keys ``(k1, k2)`` (``_tilemin2_packed_kernel`` :393)."""
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
    """[B, rows] scores -> per tile (min, lowest row at it) (``_masked_argmin``)."""
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
    """Per (query, tile) min and lowest argmin of ``|g|^2 - 2 q.g``, fp32 or (``bf16_scores``) bf16 scores."""
    qf = q.to(torch.float32)

    def score(r0, r1):
        cross2, gs = 2.0 * (qf @ g[r0:r1].to(torch.float32).T), gsq[r0:r1]
        return _bf16(_bf16(gs)[None, :] - _bf16(cross2)) if bf16_scores else gs[None, :] - cross2

    return _tile_scan(score, q.shape[0], g.shape[0] // tile_g, tile_g, chunk_rows, q.device)


def _tile_scan(score, b: int, n_tiles: int, tile_g: int, chunk_rows: int, device):
    """Per-tile (min, lowest row) of ``score(r0, r1)`` [B, r1 - r0], ``chunk_rows`` at a time."""
    out_d = torch.empty((b, n_tiles), dtype=torch.float32, device=device)
    out_i = torch.empty((b, n_tiles), dtype=torch.int32, device=device)
    step = max(1, chunk_rows // tile_g)
    for t0 in range(0, n_tiles, step):
        t1 = min(t0 + step, n_tiles)
        mins, arg = _tile_argmin(score(t0 * tile_g, t1 * tile_g), tile_g)
        out_d[:, t0:t1] = mins
        out_i[:, t0:t1] = arg + torch.arange(t0, t1, dtype=torch.int32, device=device)[None, :] * tile_g
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
    """Per (query, tile) min and argmin of ``|g|^2 - (2 s_q)(q.g s_g)`` (``_tilemin_quant_kernel``), one fp32
    rounding an operation."""
    if compute not in ("int8", "bf16"):
        raise ValueError(f"compute must be 'int8' or 'bf16', got {compute!r}")
    wide = torch.float64 if compute == "int8" else torch.float32
    qw, qs2 = q.to(wide), (2.0 * qs.to(torch.float32))[:, None]

    def score(r0, r1):
        cross = (qw @ g[r0:r1].to(wide).T).to(torch.float32)
        return gsq[r0:r1][None, :] - qs2 * (cross * gsc[r0:r1][None, :])

    return _tile_scan(score, q.shape[0], g.shape[0] // tile_g, tile_g, chunk_rows, q.device)


def topk_l2_plain(
    q: torch.Tensor,  # [B, D] bf16, or fp32 with ``precise``
    g: torch.Tensor,  # [N, D] bf16 (or fp32 with ``precise``)
    k: int,
    n_valid: Optional[int] = None,
    window: Optional[Tuple[int, int]] = None,
    precise: bool = False,
    row_mask: Optional[torch.Tensor] = None,
    chunk_rows: int = 65536,
    floor: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact L2 top-k: ``max(|q|^2 + |g|^2 - 2 q.g, 0)`` in fp32, ties low, empty ``(BIG_DIST, -1)``;
    ``floor=(d, row)``: only what follows. ``torch.topk`` of keys ``bits(d) << 32 | (row + 1)``."""
    n = g.shape[0] if n_valid is None else int(n_valid)
    b, dim = q.shape
    qf = q.to(torch.float32)
    fmask = None
    if window is not None:
        lanes = torch.arange(dim, device=q.device)
        fmask = ((lanes >= window[0]) & (lanes < window[1])).to(torch.float32)
        qf = qf * fmask
    qsq = (qf * qf).sum(dim=1, keepdim=True)
    empty = (torch.tensor(BIG_DIST, dtype=torch.float32).view(torch.int32).to(torch.int64) << 32).item()
    best = torch.full((b, k), empty, dtype=torch.int64, device=q.device)  # (BIG_DIST, row -1)
    floor_key = None
    if floor is not None:
        fd, fi = floor[0].to(torch.float32).contiguous(), floor[1].to(torch.int64)
        floor_key = torch.where(fi < 0, torch.iinfo(torch.int64).max,
                ((fd.view(torch.int32).to(torch.int64) & 0x7FFFFFFF) << 32) | (fi + 1))[:, None]
    for r0 in range(0, n, chunk_rows):
        r1 = min(r0 + chunk_rows, n)
        gf = g[r0:r1].to(torch.float32)
        if fmask is not None:
            gf = gf * fmask
        gsq = (gf * gf).sum(dim=1)
        d = torch.clamp_min((qsq + gsq[None, :]) - 2.0 * (qf @ gf.T), 0.0)
        bits = d.view(torch.int32).to(torch.int64) & 0x7FFFFFFF  # -0.0 as 0.0
        keys = (bits << 32) | torch.arange(r0 + 1, r1 + 1, device=q.device)
        if floor_key is not None:
            keys = torch.where(keys > floor_key, keys, empty)
        best = torch.topk(torch.cat([best, keys], dim=1), k, dim=1, largest=False, sorted=True).values
    best_d = (best >> 32).to(torch.int32).view(torch.float32)
    best_i = ((best & 0xFFFFFFFF) - 1).to(torch.int32)
    if row_mask is not None:
        best_d = torch.where(row_mask[:, None], best_d, BIG_DIST)
        best_i = torch.where(row_mask[:, None], best_i, -1)
    return best_d, best_i


def topk_rescore_plain(q: torch.Tensor, g: torch.Tensor, d: torch.Tensor, idx: torch.Tensor, window: Optional[Tuple[int,
        int]] = None, chunk: int = 1 << 24) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 3: each pick's d as the fp32 sum of ``(q - g)^2`` over the window, lists sorted again, empty
    slots last."""
    lo, hi = window or (0, q.shape[1])
    valid, out = idx >= 0, d.clone()
    step = max(1, chunk // max(1, idx.shape[1] * (hi - lo)))
    for s in range(0, idx.shape[0], step):
        rows = g[idx[s : s + step].clamp_min(0).long(), lo:hi].to(torch.float32)  # [b, k, W]
        out[s : s + step] = rows.sub_(q[s : s + step, None, lo:hi].to(torch.float32)).square_().sum(dim=2)
    out = torch.where(valid, out, d)
    keys = torch.where(valid, (out.view(torch.int32).to(torch.int64) << 32) | (idx.to(torch.int64) + 1),
            torch.iinfo(torch.int64).max)
    order = torch.sort(keys, dim=1, stable=True).indices
    return out.gather(1, order), idx.gather(1, order)


def split_bf16x3(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``split_queries``' bf16 terms: ``hi = bf16(q)``, ``mid = bf16(q - hi)``,
    ``lo = bf16(q - hi - mid)`` (``hi + mid + lo = q`` to ~2^-27)."""
    qf = q.to(torch.float32)
    hi = qf.to(torch.bfloat16)
    r = qf - hi.to(torch.float32)
    mid = r.to(torch.bfloat16)
    lo = (r - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def chi2_nn_plain(
    q: torch.Tensor,  # [B, D] fp32
    g: torch.Tensor,  # [N, D] fp32 or bf16
    n_valid: Optional[int] = None,
    tile_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """chi2 1-NN: per query the least ``sum (g - q)^2 / max(g + q, 1e-30)`` in fp32, its lowest row."""
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
    """The MBConv activations on fp32 values (``_act``, ops/mbconv_kernel.py:76): ``relu6`` or swish."""
    return torch.clamp(x, 0.0, 6.0) if activation == "relu6" else F.silu(x)


def dw_rows(q: Dict[str, torch.Tensor], kernel: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(w_dw [k*k, Ce], b_dw, b_exp) fp32 from the ``dw_aux`` of params ``q``."""
    ce = q["w_proj_t"].shape[1]
    aux = q["dw_aux"].permute(1, 0, 2).reshape(kernel * kernel + 2, -1)[:, :ce]
    return aux[: kernel * kernel], aux[kernel * kernel], aux[kernel * kernel + 1]


def mbconv_plain(
    x: torch.Tensor,  # [B, Cin, H, W] in the working dtype (bf16 on the card)
    q: Dict[str, torch.Tensor],  # ops.mbconv_kernel.prepare_params layout
    kernel: int,
    pads: Tuple[Tuple[int, int], Tuple[int, int]],  # ((low, high) in H, (low, high) in W)
    activation: str,
    residual: bool,
    chunk: int = 64,
) -> torch.Tensor:
    """A folded stride-1 MBConv block, rounded where ``mbconv.cu`` rounds to bf16."""
    dt = x.dtype
    b, _, h, w = x.shape
    cout, ce = q["w_proj_t"].shape
    (pl_h, ph_h), (pl_w, ph_w) = pads
    w_dw, b_dw, b_exp = dw_rows(q, kernel)
    w_dw = w_dw.t().reshape(ce, 1, kernel, kernel)
    out = torch.empty((b, cout, h, w), dtype=dt, device=x.device, memory_format=torch.channels_last)
    for s in range(0, b, chunk):
        xs = x[s : s + chunk].permute(0, 2, 3, 1).to(torch.float32)  # NHWC
        hid = xs
        if "w_exp_t" in q:
            hid = act_plain(xs @ q["w_exp_t"].t().to(torch.float32) + b_exp, activation).to(dt)
        hid = F.pad(hid.permute(0, 3, 1, 2).to(torch.float32), (pl_w, ph_w, pl_h, ph_h))
        a = act_plain(F.conv2d(hid, w_dw, groups=ce) + b_dw[None, :, None, None], activation)
        d = a.to(dt).to(torch.float32)
        if "w_se1" in q:
            se = F.silu(a.mean(dim=(2, 3)) @ q["w_se1"] + q["b_se1"])
            gate = torch.sigmoid(se @ q["w_se2"] + q["b_se2"])
            d = (d * gate[:, :, None, None]).to(dt).to(torch.float32)
        y = d.permute(0, 2, 3, 1) @ q["w_proj_t"].t().to(torch.float32) + q["b_proj"]
        if residual:
            y = y + xs
        out[s : s + chunk] = y.permute(0, 3, 1, 2).to(dt)
    return out
