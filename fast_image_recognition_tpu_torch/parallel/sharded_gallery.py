"""Mesh-sharded gallery search with a top-k merge (counterpart of
``fast_image_recognition_tpu/parallel/sharded_gallery.py``).

The gallery is split on N into one shard per device of the mesh's gallery
axes; each shard runs the exact scan (``topk_l2``, ``kernels/topk_l2.cu``)
or the packed PCA scan (``kernels/packed_scan.cu``) with a shard-local
exact rescore, and only each shard's k (distance, global row) pairs per
query are copied to the first shard's device and merged. One process
holds every shard and launches the shards one after another, as
``jax.shard_map`` does from one controller; launches are asynchronous, so
shards on different cards overlap. Several axes flatten first-axis-major,
as ``jax.lax.all_gather`` over them does.

Merge: the shard-major ``[B, S*k]`` pairs, a stable sort by distance
(``lax.top_k(-d)``: ties to the lower position, which is the lower global
row, since each shard's list is in (distance, row) order). As in JAX, a
slot past a shard's valid rows (-1) passes ``i < n_valid`` and becomes
``shard * rows - 1`` at ``BIG_DIST / width``; shard 0's own -1 slots sort
first among those, so the output shows -1 there.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fast_image_recognition_tpu_torch.ops.distance_kernel import (
    BIG_DIST,
    pack_gallery_aug,
    rescore_rows,
    topk_candidates_l2_packed,
    topk_l2,
)
from fast_image_recognition_tpu_torch.parallel.mesh import Mesh
from fast_image_recognition_tpu_torch.search.base import SearchResult

_PROJECTION_ROWS = 65536  # shard rows projected per step: bounds the fp32 temporaries


def _merge_gathered(
    gat_d: torch.Tensor,  # [S, B, k] distances from all shards
    gat_i: torch.Tensor,  # [S, B, k] global indices from all shards
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    s, b, kk = gat_d.shape
    flat_d = gat_d.permute(1, 0, 2).reshape(b, s * kk)
    flat_i = gat_i.permute(1, 0, 2).reshape(b, s * kk)
    pos = torch.sort(flat_d, dim=1, stable=True).indices[:, :k]
    return flat_d.gather(1, pos), flat_i.gather(1, pos)


def _gather(parts: Sequence[Tuple[torch.Tensor, torch.Tensor]], dev: torch.device):
    """Per-shard ``(d [B, k], i [B, k])`` -> ``[S, B, k]`` each on ``dev``."""
    return (torch.stack([d.to(dev) for d, _ in parts]), torch.stack([i.to(dev) for _, i in parts]))


def _valid_counts(n_valid_per_shard, n_shards: int, rows: int) -> List[int]:
    if n_valid_per_shard is None:
        return [rows] * n_shards
    return [int(v) for v in np.asarray(n_valid_per_shard)]


def _check_shards(shards: Sequence[torch.Tensor], mesh: Mesh, axes: Tuple[str, ...]) -> list:
    devs = mesh.shard_devices(axes)
    if len(shards) != len(devs):
        raise ValueError(f"{len(shards)} shards for a mesh of {len(devs)} shards over {axes}")
    return devs


def sharded_topk_l2(
    queries: torch.Tensor,
    gallery_shards: Sequence[torch.Tensor],  # S x [rows, D], shard s on mesh device s
    mesh: Mesh,
    k: int = 1,
    *,
    n_valid_per_shard: Optional[np.ndarray] = None,
    window: Optional[Tuple[int, int]] = None,
    precise: bool = False,
    axes: Tuple[str, ...] = ("gallery",),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k over ``shard_gallery``'s shards, on the first shard's
    device: one ``topk_l2`` per shard with its valid count (a host int)."""
    devs = _check_shards(gallery_shards, mesh, axes)
    rows = int(gallery_shards[0].shape[0])
    nv = _valid_counts(n_valid_per_shard, len(devs), rows)
    parts = []
    for s, (g, dev) in enumerate(zip(gallery_shards, devs)):
        d, i = topk_l2(queries.to(dev), g, k=k, n_valid=nv[s], window=window, precise=precise)
        valid = i < nv[s]
        parts.append((torch.where(valid, d, BIG_DIST), torch.where(valid, i + s * rows, -1)))
    return _merge_gathered(*_gather(parts, devs[0]), k)


def shard_gallery_pca_aug(
    gallery_shards: Sequence[torch.Tensor],
    n_valid_per_shard: np.ndarray,
    mesh: Mesh,
    mu,  # [D] PCA mean
    w,  # [D, P] PCA components
    *,
    tile_g: int = 1024,
    axes: Tuple[str, ...] = ("gallery",),
) -> List[torch.Tensor]:
    """Per shard, ``pack_gallery_aug`` of its fp32 PCA projection."""
    devs = _check_shards(gallery_shards, mesh, axes)
    nv = _valid_counts(n_valid_per_shard, len(devs), int(gallery_shards[0].shape[0]))
    out = []
    for s, (g, dev) in enumerate(zip(gallery_shards, devs)):
        mu32 = torch.as_tensor(mu, dtype=torch.float32).to(dev)
        w32 = torch.as_tensor(w, dtype=torch.float32).to(dev)
        gp = torch.empty((g.shape[0], w32.shape[1]), dtype=torch.float32, device=dev)
        for r in range(0, g.shape[0], _PROJECTION_ROWS):
            gp[r : r + _PROJECTION_ROWS] = (g[r : r + _PROJECTION_ROWS].to(torch.float32) - mu32) @ w32
        out.append(pack_gallery_aug(gp, nv[s], tile_g=tile_g))
    return out


def sharded_topk_pca_packed(
    queries: torch.Tensor,  # [B, D] fp32 (full-D embeddings)
    gal_aug_shards: Sequence[torch.Tensor],  # shard_gallery_pca_aug(...) output
    gallery_shards: Sequence[torch.Tensor],  # S x [rows, D] full-D bf16 rows (exact rescore)
    mesh: Mesh,
    mu,
    w,  # [D, P]
    *,
    k: int = 1,
    rescore: int = 48,
    n_valid_per_shard: Optional[np.ndarray] = None,
    tile_g: int = 1024,
    select: str = "exact",
    axes: Tuple[str, ...] = ("gallery",),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k by the packed PCA scan, ``rescore`` candidates a shard
    rescored from its bf16 rows; k capped at the candidates."""
    devs = _check_shards(gallery_shards, mesh, axes)
    rows = int(gallery_shards[0].shape[0])
    nv = _valid_counts(n_valid_per_shard, len(devs), rows)
    w = torch.as_tensor(w, dtype=torch.float32)
    pca_dim, d_full = int(w.shape[1]), int(queries.shape[1])
    qf = queries.to(torch.float32)
    qp = (qf - torch.as_tensor(mu, dtype=torch.float32).to(qf.device)) @ w.to(qf.device)
    qsq = (qf * qf).sum(dim=1)
    parts, kk = [], k
    for s, (ga, g, dev) in enumerate(zip(gal_aug_shards, gallery_shards, devs)):
        cand = topk_candidates_l2_packed(qp.to(dev), ga, pca_dim, rescore, tile_g=tile_g, select=select)
        cand = cand.to(torch.int64)  # [B, R] shard-local rows
        dloc = (rescore_rows(g, qf.to(dev), cand) + qsq.to(dev)[:, None]) / d_full
        dloc = torch.where(cand < nv[s], dloc, BIG_DIST)
        kk = min(k, dloc.shape[1])
        pos = torch.sort(dloc, dim=1, stable=True).indices[:, :kk]
        top_d = dloc.gather(1, pos)
        top_i = torch.where(top_d < BIG_DIST / 2, cand.gather(1, pos) + s * rows, -1)
        parts.append((top_d, top_i.to(torch.int32)))
    return _merge_gathered(*_gather(parts, devs[0]), kk)


def shard_gallery(
    gallery,
    mesh: Mesh,
    tile_g: int = 512,
    dtype: torch.dtype = torch.bfloat16,
    axes: Tuple[str, ...] = ("gallery",),
) -> Tuple[List[torch.Tensor], np.ndarray]:
    """Rows -> (one zero-padded shard per device, ``ceil(N / S)`` rows
    rounded up to ``tile_g``; per-shard valid counts)."""
    devs = mesh.shard_devices(axes)
    n_shards = len(devs)
    g = torch.as_tensor(np.asarray(gallery, np.float32)) if not isinstance(gallery, torch.Tensor) else gallery
    n, d = g.shape
    rows = -(-n // n_shards)  # ceil
    rows = -(-rows // tile_g) * tile_g  # round up to the kernel tile
    n_valid = np.asarray([max(0, min(rows, n - s * rows)) for s in range(n_shards)], dtype=np.int32)
    shards = []
    for s, dev in enumerate(devs):
        part = g[s * rows : s * rows + int(n_valid[s])].to(dev, dtype)
        shards.append(torch.nn.functional.pad(part, (0, 0, 0, rows - part.shape[0])))
    return shards, n_valid


class ShardedGalleryMatcher:
    """Exact 1-NN over a mesh-sharded gallery; ``precise`` stores fp32
    shards for the fp32 oracle pass."""

    def __init__(
        self,
        gallery_features: np.ndarray,
        mesh: Mesh,
        kind=None,  # only L2 is accelerated; kept for API symmetry
        precise: bool = False,
        tile_g: int = 512,
    ):
        self.name = f"BF(sharded x{mesh.shape['gallery']})"
        self.mesh = mesh
        self.precise = precise
        self.tile_g = tile_g
        self.device = mesh.shard_devices(("gallery",))[0]
        dtype = torch.float32 if precise else torch.bfloat16
        self.gallery, self.n_valid = shard_gallery(gallery_features, mesh, tile_g=tile_g, dtype=dtype)
        self._n = gallery_features.shape[0]

    def set_budget(self, image_count_to_check: int) -> None:
        pass

    def search_device(self, queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return sharded_topk_l2(
            queries, self.gallery, self.mesh, k=1, n_valid_per_shard=self.n_valid, precise=self.precise
        )

    def search(self, queries: np.ndarray) -> SearchResult:
        q = torch.as_tensor(np.asarray(queries, np.float32), device=self.device)
        d, i = self.search_device(q)
        return SearchResult(
            indices=i[:, 0].cpu().numpy(),
            distances=d[:, 0].cpu().numpy(),
            checked_fraction=np.ones(q.shape[0], dtype=np.float32),
        )
