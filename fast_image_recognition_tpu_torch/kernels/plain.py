"""Plain PyTorch versions of the port's CUDA kernels.

Each computes the same function as its kernel, in straightforward chunked
PyTorch: the CPU tests run them, and ``chip_smoke.py`` holds each kernel
against its plain version on the card. The card's main path never calls
them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

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


def topk_l2_plain(
    q: torch.Tensor,  # [B, D] bf16
    g: torch.Tensor,  # [N, D] bf16
    k: int,
    n_valid: Optional[int] = None,
    chunk_rows: int = 65536,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact L2 top-k: ``max(|q|^2 + |g|^2 - 2 q.g, 0)`` in fp32 from bf16
    values, rows >= n_valid excluded, ties to the lowest row index, empty
    slots ``(BIG_DIST, -1)``. Returns raw squared distances ``[B, k]`` fp32
    and indices ``[B, k]`` int32 (counterpart of ``_topk_kernel``,
    ops/distance_kernel.py:92)."""
    n = g.shape[0] if n_valid is None else int(n_valid)
    b = q.shape[0]
    qf = q.to(torch.float32)
    qsq = (qf * qf).sum(dim=1, keepdim=True)
    best_d = torch.full((b, k), BIG_DIST, dtype=torch.float32, device=q.device)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=q.device)
    for r0 in range(0, n, chunk_rows):
        r1 = min(r0 + chunk_rows, n)
        gf = g[r0:r1].to(torch.float32)
        gsq = (gf * gf).sum(dim=1)
        d = torch.clamp_min((qsq + gsq[None, :]) - 2.0 * (qf @ gf.T), 0.0)
        idx = torch.arange(r0, r1, device=q.device).expand(b, -1)
        # carry first, rows ascending: a stable sort keeps the lowest index
        all_d = torch.cat([best_d, d], dim=1)
        all_i = torch.cat([best_i, idx], dim=1)
        order = torch.sort(all_d, dim=1, stable=True).indices[:, :k]
        best_d = all_d.gather(1, order)
        best_i = all_i.gather(1, order)
    return best_d, best_i.to(torch.int32)
