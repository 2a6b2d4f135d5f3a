"""Window distances L2, chi2 and KL (JAX ``ops/distances.py``;
db_features.cpp:22-42): NumPy oracles bit-equal to JAX's, the rest PyTorch on
the tensors' device (fp32, TF32 off; chi2/KL over bounded tiles)."""

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import DistanceKind
from ..kernels.plain import BIG_DIST


# NumPy oracles

def oracle_distance(lhs: np.ndarray, rhs: np.ndarray, start: int = 0, end: int | None = None,
    kind: DistanceKind = DistanceKind.L2) -> np.float32:
    """Scalar fp32 sequential sums as db_features.cpp:22-42."""
    lhs = np.asarray(lhs, dtype=np.float32)
    rhs = np.asarray(rhs, dtype=np.float32)
    if end is None:
        end = lhs.shape[-1]
    dist = np.float32(0)
    for i in range(start, end):
        a = lhs[i]
        b = rhs[i]
        if kind == DistanceKind.L2:
            dist += (a - b) * (a - b)
        else:
            s = a + b
            if s > 0:
                if kind == DistanceKind.CHI2:
                    dist += (a - b) * (a - b) / s
                else:  # KL (the commented variant, db_features.cpp:33-36)
                    if a > 0:
                        dist += a * np.float32(np.log(2 * a / s))
                    if b > 0:
                        dist += b * np.float32(np.log(2 * b / s))
    return np.float32(dist / np.float32(end - start))


def oracle_pairwise(queries: np.ndarray, gallery: np.ndarray, start: int = 0, end: int | None = None,
    kind: DistanceKind = DistanceKind.L2) -> np.ndarray:
    """Vectorized float64 NumPy pairwise distances [B, N]."""
    q = np.asarray(queries, dtype=np.float64)
    g = np.asarray(gallery, dtype=np.float64)
    if end is None:
        end = q.shape[-1]
    qw = q[:, None, start:end]
    gw = g[None, :, start:end]
    if kind == DistanceKind.L2:
        d = ((qw - gw) ** 2).sum(-1)
    elif kind == DistanceKind.CHI2:
        s = qw + gw
        d = np.where(s > 0, (qw - gw) ** 2 / np.where(s > 0, s, 1.0), 0.0).sum(-1)
    else:
        s = qw + gw
        safe = np.where(s > 0, s, 1.0)
        ta = np.where((s > 0) & (qw > 0), qw * np.log(2 * np.where(qw > 0, qw, 1.0) / safe), 0.0)
        tb = np.where((s > 0) & (gw > 0), gw * np.log(2 * np.where(gw > 0, gw, 1.0) / safe), 0.0)
        d = (ta + tb).sum(-1)
    return d / (end - start)


# PyTorch implementations

def _l2_block(q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``max(|q|^2 + |g|^2 - 2 q.g, 0)`` [B, T] in fp32."""
    q, g = q.to(torch.float32), g.to(torch.float32)
    cross = q @ g.T
    qn = (q * q).sum(dim=1, keepdim=True)
    gn = (g * g).sum(dim=1)[None, :]
    return torch.clamp_min(qn + gn - 2.0 * cross, 0.0)


def pairwise_distances(queries: torch.Tensor, gallery: torch.Tensor, start: int = 0, end: int | None = None,
    kind: DistanceKind = DistanceKind.L2, precise: bool = True) -> torch.Tensor:
    """fp32 window distances: L2 by the expansion (``precise``: fp32 operands, else bf16); chi2/KL over tiles."""
    if end is None:
        end = queries.shape[-1]
    q = queries[:, start:end].to(torch.float32)
    g = gallery[:, start:end].to(torch.float32)
    if kind == DistanceKind.L2:
        if not precise:
            q, g = q.to(torch.bfloat16), g.to(torch.bfloat16)
        d = _l2_block(q, g)
    else:
        d = _elementwise_blocked(q, g, kind)
    return d / (end - start)


def _elementwise_tile(q: torch.Tensor, g_tile: torch.Tensor, kind: DistanceKind) -> torch.Tensor:
    """chi2/KL sums of one tile: [B, T]."""
    qw = q[:, None, :]
    gw = g_tile[None, :, :]
    s = qw + gw
    pos = s > 0
    safe = torch.where(pos, s, 1.0)
    if kind == DistanceKind.CHI2:
        return torch.where(pos, (qw - gw).square() / safe, 0.0).sum(dim=-1)
    ta = torch.where(pos & (qw > 0), qw * torch.log(2.0 * torch.where(qw > 0, qw, 1.0) / safe), 0.0)
    tb = torch.where(pos & (gw > 0), gw * torch.log(2.0 * torch.where(gw > 0, gw, 1.0) / safe), 0.0)
    return (ta + tb).sum(dim=-1)


def _elementwise_block_size(b: int, d: int, budget_elems: int = 1 << 26) -> int:
    """Gallery tile size keeping the [B, tile, D] broadcast under ~256 MB fp32."""
    tile = max(128, budget_elems // max(b * d, 1))
    return (tile // 128) * 128 or 128


def _elementwise_blocked(q: torch.Tensor, g: torch.Tensor, kind: DistanceKind) -> torch.Tensor:
    """chi2/KL pairwise sums [B, N] computed gallery-tile-by-tile."""
    tile = _elementwise_block_size(*q.shape)
    return torch.cat([_elementwise_tile(q, g[s : s + tile], kind) for s in range(0, g.shape[0], tile)], dim=1)


def streamed_topk(queries: torch.Tensor, gallery: torch.Tensor, k: int = 1, start: int = 0, end: int | None = None,
    kind: DistanceKind = DistanceKind.CHI2, tile_n: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k least window distances over tiles, ties to the lower row; empty (3.4e38 / width, -1)."""
    if end is None:
        end = queries.shape[-1]
    width = end - start
    q = queries[:, start:end].to(torch.float32)
    g = gallery[:, start:end]
    b, dim = q.shape
    n = g.shape[0]
    if tile_n is None:
        tile_n = _elementwise_block_size(b, dim)
    best_d = torch.full((b, k), BIG_DIST, dtype=torch.float32, device=q.device)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=q.device)
    for t0 in range(0, n, tile_n):
        g_tile = g[t0 : t0 + tile_n].to(torch.float32)
        d = _l2_block(q, g_tile) if kind == DistanceKind.L2 else _elementwise_tile(q, g_tile, kind)
        idx = torch.arange(t0, t0 + g_tile.shape[0], device=q.device).expand(b, -1)
        cat_d = torch.cat([best_d, d], dim=1)
        cat_i = torch.cat([best_i, idx], dim=1)
        order = torch.sort(cat_d, dim=1, stable=True).indices[:, :k]
        best_d, best_i = cat_d.gather(1, order), cat_i.gather(1, order)
    return best_d / width, best_i.to(torch.int32)


def window_distance_update(partial_sum: torch.Tensor, queries: torch.Tensor, gallery: torch.Tensor, start: int,
    end: int, total_start: int, kind: DistanceKind = DistanceKind.L2) -> torch.Tensor:
    """Running window means from [total_start, start) to [total_start, end) (ImageTesting.cpp:165-180)."""
    old_w = start - total_start
    new_w = end - total_start
    delta = pairwise_distances(queries, gallery, start=start, end=end, kind=kind)
    return (partial_sum * old_w + delta * (end - start)) / new_w
