"""Directed Enumeration Method (DEM), maximum-likelihood approximate 1-NN
(counterpart of ``fast_image_recognition_tpu/search/dem.py``; reference:
qt_cpp/ann.h:61-100, ann.cpp:269-507).

``DirectedEnumerationMatcher`` (PIVOT mode, ann.cpp:270): up to 32 greedy
most-far pivots, ``P[p, n] = d(pivot_p, row_n)`` and an early-exit
threshold at the FAR quantile of each pivot's distance to its nearest
other-class row; a query probes the pivots, ranks the rows by ``L[n] =
sum_p (d(q, p) - P[p, n])^2`` and probes them in that order until a
distance clears the threshold or the budget runs out. ``FullMatrixDEM``
(non-PIVOT, ann.cpp:283-300, 474-499) refines the likelihood after every
probe from the full N x N matrix.

Batched as in JAX: the likelihood is one fp32 matmul (TF32 off: it
cancels about 2500:1), the probe order an ascending selection (exact where
JAX takes ``lax.approx_min_k``, as XLA off the TPU; ties to the lower
row), the early exit a first-below-threshold scan. ``probe_mode='exact'``
computes every distance; ``'gather'`` only the ``budget`` candidates' from
bf16 rows. ``search_device`` makes no host sync. The index builds on the
host (``select_pivots``: float64, the NumPy oracle's arithmetic, on the
matcher's device) or from device rows (``from_device``, fp32).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from fast_image_recognition_tpu_torch.config import DistanceKind
from fast_image_recognition_tpu_torch.device import DeviceLike, resolve_device
from fast_image_recognition_tpu_torch.evaluation.harness import get_threshold
from fast_image_recognition_tpu_torch.ops.distances import (
    _elementwise_blocked,
    oracle_pairwise,
    pairwise_distances,
)
from fast_image_recognition_tpu_torch.search.base import SearchResult

BIG = 3.4e38
_NORM_ROWS = 65536  # gallery rows per step of the fp32 norm pass


def _num_pivots(n: int, pivot_fraction: float, min_pivots: int, max_pivots: int) -> int:
    return min(max(int(n * pivot_fraction), min_pivots), max_pivots, n)


def _distance_row(f64: torch.Tensor, p: int, kind: DistanceKind) -> np.ndarray:
    """float64 window-mean distances of row ``p`` to every row (the
    arithmetic of ``oracle_pairwise``) as a host array."""
    q = f64[p : p + 1]
    if kind == DistanceKind.L2:
        d = (f64 - q).square().sum(dim=1)
    else:
        d = _elementwise_blocked(q, f64, kind)[0]
    return (d / f64.shape[1]).cpu().numpy()


def select_pivots(
    features: np.ndarray,
    labels: np.ndarray,
    rng: np.random.Generator,
    pivot_fraction: float = 0.015,
    min_pivots: int = 5,
    max_pivots: int = 32,
    kind: DistanceKind = DistanceKind.L2,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy most-far pivot selection and the P matrix (ann.cpp:302-331):
    the first pivot is random, each next one the row of the largest summed
    distance to the pivots so far. Returns (pivot indices [P] int64,
    P matrix [P, N] float32, per-pivot min distance to another class [P])."""
    dev = resolve_device(device)
    labels = np.asarray(labels)
    f64 = torch.as_tensor(np.asarray(features, np.float64)).to(dev)
    n = f64.shape[0]
    num = _num_pivots(n, pivot_fraction, min_pivots, max_pivots)
    pivots = [int(rng.integers(n))]
    rows, other_min = [], []
    cum_far = np.zeros(n, dtype=np.float64)
    for ii in range(num):
        p = pivots[ii]
        d = _distance_row(f64, p, kind)
        rows.append(d.astype(np.float32))
        other = d[labels != labels[p]]
        other_min.append(float(other.min()) if other.size else np.float32(BIG))
        cum_far += d
        if ii < num - 1:
            far = cum_far.copy()
            far[np.asarray(pivots)] = -1e12
            pivots.append(int(np.argmax(far)))
    return (
        np.asarray(pivots, dtype=np.int64),
        np.stack(rows),
        np.asarray(other_min, dtype=np.float32),
    )


def _row_sq_norms(gallery: torch.Tensor) -> torch.Tensor:
    """[N] fp32 squared norms of the stored rows (exact bf16 squares summed
    in fp32), in steps that bound the fp32 temporaries."""
    return torch.cat([
        gallery[s : s + _NORM_ROWS].to(torch.float32).square().sum(dim=1)
        for s in range(0, gallery.shape[0], _NORM_ROWS)
    ])


def select_pivots_device(
    gallery: torch.Tensor,
    labels,  # [N] int, host or device
    seed: int = 0,
    pivot_fraction: float = 0.015,
    min_pivots: int = 5,
    max_pivots: int = 32,
) -> Tuple[np.ndarray, torch.Tensor, np.ndarray]:
    """The same greedy build on a gallery already on the device (L2 only):
    each step is one ``[N, D] @ [D]`` product of the stored rows (bf16 rows:
    exact products summed in fp32), and only the pivot ids and minima come
    back to the host, once. Returns (pivot indices [P] int64 host, P matrix
    [P, N] fp32 on the device, per-pivot other-class min [P] fp32 host)."""
    dev = gallery.device
    n, dim = gallery.shape
    num = _num_pivots(n, pivot_fraction, min_pivots, max_pivots)
    labels = labels if isinstance(labels, torch.Tensor) else torch.as_tensor(np.asarray(labels))
    labels_d = labels.to(dev, torch.int64)
    g32 = gallery.to(torch.float32)
    gal_sq = _row_sq_norms(gallery)
    rng = np.random.default_rng(seed)
    p_idx = torch.full((1,), int(rng.integers(n)), dtype=torch.int64, device=dev)
    chosen = torch.zeros(n, dtype=torch.bool, device=dev)
    chosen[p_idx] = True
    cum_far = torch.zeros(n, dtype=torch.float32, device=dev)
    rows, other_mins, idxs = [], [], [p_idx]
    for ii in range(num):
        pf = g32.index_select(0, p_idx)[0]
        cross = g32 @ pf
        d = torch.clamp_min(gal_sq + pf.square().sum() - 2.0 * cross, 0.0) / dim
        other = torch.where(labels_d != labels_d.index_select(0, p_idx), d, BIG)
        other_mins.append(other.min())
        rows.append(d)
        cum_far = cum_far + d
        if ii < num - 1:
            p_idx = torch.where(chosen, -1e12, cum_far).argmax().view(1)
            chosen[p_idx] = True
            idxs.append(p_idx)
    pivot_idx = torch.cat(idxs).cpu().numpy().astype(np.int64)
    other_min = torch.stack(other_mins).cpu().numpy().astype(np.float32)
    return pivot_idx, torch.stack(rows), other_min


def _first_ascending(values: torch.Tensor, k: int) -> torch.Tensor:
    """Columns [B, k] of the k least values of each row, ascending, ties to
    the lower column (a stable ascending sort's first k columns; a tie
    across the k-th place may take another of the tied columns)."""
    if k >= values.shape[1]:
        return torch.sort(values, dim=1, stable=True).indices
    vals, idx = torch.topk(values, k, dim=1, largest=False, sorted=False)
    idx, perm = torch.sort(idx, dim=1)
    order = torch.sort(vals.gather(1, perm), dim=1, stable=True).indices
    return idx.gather(1, order)


def _first_true(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(any [B], index of the first True [B], 0 where none)."""
    return mask.any(dim=1), torch.argmax(mask.to(torch.uint8), dim=1)


def _pivot_phase(d_qp: torch.Tensor, pivot_idx: torch.Tensor, threshold: float):
    """Pivots probed in order; the first below the threshold ends the query
    (ann.cpp:441-462). Returns (best pivot row, its distance, pivots
    checked, exited)."""
    p = d_qp.shape[1]
    any_below, first_below = _first_true(d_qp < threshold)
    pcols = torch.arange(p, device=d_qp.device)[None, :]
    probed = torch.where(any_below[:, None], pcols <= first_below[:, None], True)
    masked = torch.where(probed, d_qp, BIG)
    arg = torch.argmin(masked, dim=1)
    best_d = masked.gather(1, arg[:, None])[:, 0]
    checked = torch.where(any_below, first_below + 1, p)
    return pivot_idx[arg], best_d, checked, any_below


def _likelihood(d_qp, p_matrix, pm_sq, pivot_mask) -> torch.Tensor:
    """``L = |d_qp|^2 + |P|^2 - 2 d_qp.P`` [B, N] with true fp32 products
    (TF32 stays off, ``device.py``); pivots are excluded (BIG)."""
    qp_sq = d_qp.square().sum(dim=1, keepdim=True)
    lik = qp_sq + pm_sq[None, :] - 2.0 * (d_qp @ p_matrix)
    return torch.where(pivot_mask[None, :], BIG, lik)


def _probe_phase(d_ordered, order, budget: int, threshold: float, pivots):
    """Candidates probed in likelihood order until one falls below the
    threshold (ann.cpp:472-501); the pivot best wins ties and stands for
    the queries that exited at the pivots. Returns (row int32, distance,
    checked int32)."""
    best_p_idx, best_p_dist, pivots_checked, exited = pivots
    any_bt, first_bt = _first_true(d_ordered < threshold)
    checked_rows = torch.where(any_bt, first_bt + 1, budget)
    cols = torch.arange(budget, device=d_ordered.device)[None, :]
    d_probed = torch.where(cols < checked_rows[:, None], d_ordered, BIG)
    arg = torch.argmin(d_probed, dim=1)
    best_dist = d_probed.gather(1, arg[:, None])[:, 0]
    best_idx = order.gather(1, arg[:, None])[:, 0]
    use_p = exited | (best_p_dist <= best_dist)
    checked = torch.where(exited, pivots_checked, pivots_checked + checked_rows)
    return (
        torch.where(use_p, best_p_idx, best_idx).to(torch.int32),
        torch.where(use_p, best_p_dist, best_dist),
        checked.to(torch.int32),
    )


@dataclasses.dataclass
class DEMIndex:
    pivot_indices: np.ndarray
    p_matrix: Optional[np.ndarray]
    threshold: float


class DirectedEnumerationMatcher:
    """Matcher-protocol DEM ("dem" in the reference's printouts) on
    ``device`` (the card unless given)."""

    def __init__(
        self,
        gallery_features: np.ndarray,
        gallery_labels: np.ndarray,
        false_accept_rate: float = 0.01,
        threshold: float = 0.0,
        image_count_to_check: int = 0,
        kind: DistanceKind = DistanceKind.L2,
        seed: int = 0,
        pivot_fraction: float = 0.015,
        max_pivots: int = 32,
        probe_mode: str = "exact",
        device: DeviceLike = None,
    ):
        """``probe_mode='exact'`` computes the full distance matrix and
        selects the reference's probe set; ``'gather'`` touches only the
        top-budget candidates (L2 only)."""
        if probe_mode not in ("exact", "gather"):
            raise ValueError(f"unknown probe_mode {probe_mode!r}")
        if probe_mode == "gather" and kind != DistanceKind.L2:
            raise ValueError("gather mode supports L2 only")
        self.device = resolve_device(device)
        self.name = "dem" if probe_mode == "exact" else "dem(gather)"
        self.kind = kind
        self.probe_mode = probe_mode
        feats = np.asarray(gallery_features, np.float32)
        self._n = feats.shape[0]
        rng = np.random.default_rng(seed)
        pivots, p_matrix, other_min = select_pivots(
            feats, gallery_labels, rng, pivot_fraction=pivot_fraction, max_pivots=max_pivots,
            kind=kind, device=self.device,
        )
        if threshold <= 0:
            threshold = get_threshold(other_min, false_accept_rate)
        self.index = DEMIndex(pivots, p_matrix, float(threshold))
        dtype = torch.bfloat16 if probe_mode == "gather" else torch.float32
        self.gallery = torch.from_numpy(feats).to(self.device, dtype)
        self._setup(
            torch.from_numpy(feats[pivots]).to(self.device),
            torch.from_numpy(p_matrix).to(self.device),
            image_count_to_check,
        )

    @classmethod
    def from_device(
        cls,
        gallery_dev: torch.Tensor,
        labels,
        false_accept_rate: float = 0.01,
        threshold: float = 0.0,
        image_count_to_check: int = 0,
        seed: int = 0,
        pivot_fraction: float = 0.015,
        max_pivots: int = 32,
        probe_mode: str = "gather",
        device: DeviceLike = None,
    ) -> "DirectedEnumerationMatcher":
        """Build the index from a gallery tensor without a host copy of its
        rows (L2 only): pivots and P matrix by ``select_pivots_device`` on
        the stored rows (bf16 for ``'gather'``, fp32 for ``'exact'``); the
        P matrix stays on the device (``index.p_matrix`` is None)."""
        if probe_mode not in ("exact", "gather"):
            raise ValueError(f"unknown probe_mode {probe_mode!r}")
        self = object.__new__(cls)
        self.device = resolve_device(device)
        self.name = "dem" if probe_mode == "exact" else "dem(gather)"
        self.kind = DistanceKind.L2
        self.probe_mode = probe_mode
        self._n = int(gallery_dev.shape[0])
        dtype = torch.bfloat16 if probe_mode == "gather" else torch.float32
        self.gallery = gallery_dev.to(self.device, dtype)
        pivots, p_matrix_dev, other_min = select_pivots_device(
            self.gallery, labels, seed=seed, pivot_fraction=pivot_fraction, max_pivots=max_pivots
        )
        if threshold <= 0:
            threshold = get_threshold(other_min, false_accept_rate)
        self.index = DEMIndex(pivots, None, float(threshold))
        piv = torch.from_numpy(pivots).to(self.device)
        self._setup(self.gallery.index_select(0, piv).to(torch.float32), p_matrix_dev, image_count_to_check)
        return self

    def _setup(self, pivot_feats: torch.Tensor, p_matrix: torch.Tensor, image_count_to_check: int) -> None:
        """Device tensors every search reads: the pivots' rows, the P
        matrix and its column norms, the pivot mask and (gather) the rows'
        squared norms."""
        self._pivot_feats = pivot_feats
        self._p_matrix = p_matrix
        self._pivot_idx = torch.from_numpy(self.index.pivot_indices).to(self.device)
        self._pm_sq = p_matrix.square().sum(dim=0)
        self._pivot_mask = torch.zeros(self._n, dtype=torch.bool, device=self.device)
        self._pivot_mask[self._pivot_idx] = True
        self._gal_sq = _row_sq_norms(self.gallery) if self.probe_mode == "gather" else None
        # the JAX package compares against jnp.float32(threshold)
        self._threshold = float(np.float32(self.index.threshold))
        self.set_budget(image_count_to_check)

    def set_budget(self, image_count_to_check: int) -> None:
        """The budget counts every distance, pivots included
        (distanceCalcCount, ann.cpp:429, 472), clamped to the gallery; a
        budget at or below the pivot count leaves no candidate probe."""
        n_pivots = len(self.index.pivot_indices)
        n_cand = self._n - n_pivots
        if image_count_to_check <= 0 or image_count_to_check >= self._n:
            image_count_to_check = self._n
        self.budget = int(np.clip(image_count_to_check - n_pivots, 0, n_cand))

    @torch.no_grad()
    def search_device(self, queries_dev: torch.Tensor):
        """Device in, device out, no host sync: (best row [B] int32, its
        distance [B] fp32, distances computed [B] int32)."""
        q = queries_dev.to(self.device, torch.float32)
        thr = self._threshold
        if self.probe_mode == "gather":
            d_qp = pairwise_distances(q, self._pivot_feats)
        else:
            d_all = pairwise_distances(q, self.gallery, kind=self.kind)
            d_qp = d_all[:, self._pivot_idx]
        pivots = _pivot_phase(d_qp, self._pivot_idx, thr)
        if self.budget == 0:
            # the pivot phase spends imageCountToCheck (ann.cpp:472)
            return pivots[0].to(torch.int32), pivots[1], pivots[2].to(torch.int32)
        lik = _likelihood(d_qp, self._p_matrix, self._pm_sq, self._pivot_mask)
        order = _first_ascending(lik, self.budget)
        if self.probe_mode == "gather":
            b, dim = q.shape
            rows = self.gallery.index_select(0, order.reshape(-1)).view(b, self.budget, dim)
            q16 = q.to(torch.bfloat16).to(torch.float32)
            cross = torch.bmm(rows.to(torch.float32), q16[:, :, None])[:, :, 0]
            d_ordered = (q.square().sum(dim=1, keepdim=True) + self._gal_sq[order] - 2.0 * cross) / dim
        else:
            d_ordered = d_all.gather(1, order)
        return _probe_phase(d_ordered, order, self.budget, thr, pivots)

    def search(self, queries: np.ndarray) -> SearchResult:
        q = torch.as_tensor(np.asarray(queries, np.float32)).to(self.device)
        if self.probe_mode == "gather":
            # keep the gathered candidate block under ~1 GB of bf16 rows
            max_chunk = max(1, int(1e9 // max(self.budget * q.shape[1] * 2, 1)))
            outs = [self.search_device(q[s : s + max_chunk]) for s in range(0, q.shape[0], max_chunk)]
            idx, dist, checked = (torch.cat([o[i] for o in outs]) for i in range(3))
        else:
            idx, dist, checked = self.search_device(q)
        return SearchResult(
            indices=idx.cpu().numpy(),
            distances=dist.cpu().numpy(),
            checked_fraction=checked.cpu().numpy().astype(np.float32) / self._n,
        )


# ---------------------------------------------------------------------------
# Non-PIVOT (full-matrix) DEM: ann.cpp:283-300, 474-499 under #ifndef PIVOT
# ---------------------------------------------------------------------------


@torch.no_grad()
def _dem_full_search(queries, gallery, p_full, start_idx, threshold: float, budget: int, kind: DistanceKind):
    """One probe per query per step, all queries in lockstep: the start
    images in order, then the unprobed row of least likelihood; after each
    probe ``lik[mu] += (d - P[cand, mu])^2`` for the queries still active.
    Returns (best row int32, distance, checked int32)."""
    b, n = queries.shape[0], gallery.shape[0]
    dev = queries.device
    d_all = pairwise_distances(queries, gallery, kind=kind)
    rows = torch.arange(b, device=dev)
    n_start = start_idx.shape[0]
    lik = torch.zeros((b, n), dtype=torch.float32, device=dev)
    probed = torch.zeros((b, n), dtype=torch.bool, device=dev)
    best_d = torch.full((b,), BIG, dtype=torch.float32, device=dev)
    best_i = torch.full((b,), -1, dtype=torch.int64, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    checked = torch.zeros(b, dtype=torch.int32, device=dev)
    for i in range(min(budget, n)):
        if i < n_start:
            cand = start_idx[i].expand(b)
        else:
            cand = torch.argmin(torch.where(probed, BIG, lik), dim=1)
        d = d_all.gather(1, cand[:, None])[:, 0]
        act = ~done
        improved = act & (d < best_d)
        best_d = torch.where(improved, d, best_d)
        best_i = torch.where(improved, cand, best_i)
        checked = checked + act.to(torch.int32)
        done = done | (act & (d < threshold))
        delta = d[:, None] - p_full[cand]
        lik = lik + torch.where(act[:, None], delta * delta, 0.0)
        probed[rows, cand] = True
    return best_i.to(torch.int32), best_d, checked


class FullMatrixDEM:
    """Non-PIVOT DEM ("dem" with ``#ifndef PIVOT``): the full N x N distance
    matrix (fp32 on ``device``) refines the likelihood after every probe.
    O(N^2) memory: small galleries only, as in the reference."""

    def __init__(
        self,
        gallery_features: np.ndarray,
        gallery_labels: np.ndarray,
        false_accept_rate: float = 0.01,
        threshold: float = 0.0,
        image_count_to_check: int = 0,
        kind: DistanceKind = DistanceKind.L2,
        seed: int = 0,
        pivot_fraction: float = 0.015,
        max_pivots: int = 32,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.name = "dem(full)"
        self.kind = kind
        feats = np.asarray(gallery_features, np.float32)
        self._n = feats.shape[0]
        rng = np.random.default_rng(seed)
        # the same greedy most-far start images as the PIVOT build
        starts, _, _ = select_pivots(
            feats, gallery_labels, rng, pivot_fraction=pivot_fraction, max_pivots=max_pivots,
            kind=kind, device=self.device,
        )
        self.gallery = torch.from_numpy(feats).to(self.device)
        self._p_full = pairwise_distances(self.gallery, self.gallery, kind=kind)
        if threshold <= 0:
            # FAR quantile of each row's min distance to another class
            # (ann.cpp:286-297)
            labels = np.asarray(gallery_labels)
            p_full = self._p_full.cpu().numpy()
            other = np.where(labels[None, :] != labels[:, None], p_full, BIG).min(axis=1)
            threshold = get_threshold(other.astype(np.float32), false_accept_rate)
        self.threshold = float(threshold)
        self._start_idx = torch.from_numpy(starts).to(self.device)
        self.set_budget(image_count_to_check)

    def set_budget(self, image_count_to_check: int) -> None:
        if image_count_to_check <= 0 or image_count_to_check >= self._n:
            image_count_to_check = self._n
        self.budget = int(image_count_to_check)

    def search(self, queries: np.ndarray) -> SearchResult:
        q = torch.as_tensor(np.asarray(queries, np.float32)).to(self.device)
        idx, dist, checked = _dem_full_search(
            q, self.gallery, self._p_full, self._start_idx, float(np.float32(self.threshold)),
            self.budget, self.kind,
        )
        return SearchResult(
            indices=idx.cpu().numpy(),
            distances=dist.cpu().numpy(),
            checked_fraction=checked.cpu().numpy().astype(np.float32) / self._n,
        )


# ---------------------------------------------------------------------------
# NumPy oracles: the reference's sequential walks, one query at a time
# ---------------------------------------------------------------------------


def dem_full_oracle_search(
    query: np.ndarray,
    gallery: np.ndarray,
    p_full: np.ndarray,
    start_idx: np.ndarray,
    threshold: float,
    budget: int,
    kind: DistanceKind = DistanceKind.L2,
) -> Tuple[int, float, int]:
    """Sequential non-PIVOT walk (ann.cpp:474-499) with per-probe
    refinement. Returns (best_index, best_distance, checked)."""
    n = gallery.shape[0]
    if budget <= 0 or budget >= n:
        budget = n
    lik = np.zeros(n, np.float64)
    probed = np.zeros(n, np.bool_)
    best_idx, best_dist, checked = -1, np.inf, 0
    for step in range(budget):
        if step < len(start_idx):
            cand = int(start_idx[step])
            if probed[cand]:
                continue
        else:
            cand = int(np.argmin(np.where(probed, np.inf, lik)))
        d = oracle_pairwise(query[None], gallery[cand : cand + 1], kind=kind)[0, 0]
        checked += 1
        if d < best_dist:
            best_dist, best_idx = d, cand
            if d < threshold:
                break
        delta = d - p_full[cand]
        lik += np.where(probed, 0.0, delta * delta)
        probed[cand] = True
    return best_idx, float(best_dist), checked


def dem_oracle_search(
    query: np.ndarray,
    gallery: np.ndarray,
    index: DEMIndex,
    budget: int,
    kind: DistanceKind = DistanceKind.L2,
) -> Tuple[int, float, int]:
    """Sequential PIVOT walk (ann.cpp:416-507). Returns (best_index,
    best_distance, distance_calc_count)."""
    n = gallery.shape[0]
    if budget <= 0 or budget >= n:
        budget = n
    threshold = index.threshold
    checked = 0
    best_idx, best_dist = -1, np.inf
    d_qp = np.empty(len(index.pivot_indices), dtype=np.float64)
    for i, p in enumerate(index.pivot_indices):
        d = oracle_pairwise(query[None], gallery[p : p + 1], kind=kind)[0, 0]
        checked += 1
        d_qp[i] = d
        if d < best_dist:
            best_dist, best_idx = d, int(p)
            if d < threshold:
                return best_idx, float(best_dist), checked
    lik = ((d_qp[:, None] - index.p_matrix) ** 2).sum(axis=0)
    lik[index.pivot_indices] = np.inf
    order = np.argsort(lik, kind="stable")
    n_pivots = len(index.pivot_indices)
    cand_budget = int(np.clip(budget - n_pivots, 0, n - n_pivots))
    for j in range(cand_budget):
        cand = int(order[j])
        d = oracle_pairwise(query[None], gallery[cand : cand + 1], kind=kind)[0, 0]
        checked += 1
        if d < best_dist:
            best_dist, best_idx = d, cand
            if d < threshold:
                break
    return best_idx, float(best_dist), checked
