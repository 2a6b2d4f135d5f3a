"""Small-world graph ANN (JAX ``search/small_world.py``; ann.cpp:214-235): a
``topk_l2`` neighbour table plus seeded random edges; the walk's active mask is
read on the host every :data:`SYNC_EVERY` waves."""

from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.distance_kernel import pad_gallery, topk_l2
from ..ops.pca import fit_pca
from .base import SearchResult

BIG = 3.4e38
SYNC_EVERY = 8  # waves between the host's reads of "any query active"


def build_neighbor_table(gallery: torch.Tensor, k_nn: int = 11, k_rand: int = 4, seed: int = 0,
        batch: int = 1024) -> torch.Tensor:
    """[N, k_nn + k_rand] int32 neighbours, no self loops: a ``topk_l2`` a ``batch`` of rows."""
    n = int(gallery.shape[0])
    padded = pad_gallery(gallery.to(torch.bfloat16))
    knn = []
    for s in range(0, n, batch):
        _, idx = topk_l2(gallery[s : s + batch], padded, k=k_nn + 1, n_valid=n)
        idx = idx.cpu().numpy()
        # self sorts last in a stable sort by is-self (any one duplicate on ties)
        order = np.argsort(idx == (s + np.arange(idx.shape[0]))[:, None], axis=1, kind="stable")[:, :k_nn]
        knn.append(np.take_along_axis(idx, order, axis=1).astype(np.int32))
    rand = np.random.default_rng(seed).integers(0, n, size=(n, k_rand), dtype=np.int64).astype(np.int32)
    return torch.from_numpy(np.concatenate([np.concatenate(knn), rand], axis=1)).to(gallery.device)


def _bit_of(ids: torch.Tensor) -> torch.Tensor:
    """``1 << (id & 31)`` as int32 (bit 31 is the sign bit: uint32's pattern)."""
    return torch.bitwise_left_shift(torch.ones_like(ids, dtype=torch.int32), (ids & 31).to(torch.int32))


def _mark(visited: torch.Tensor, ids: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Scatter-add ``bits`` [B, M] into each row's words ``ids >> 5``."""
    b, nw = visited.shape
    flat = torch.arange(b, device=ids.device)[:, None] * nw + (ids >> 5)
    return visited.view(-1).scatter_add_(0, flat.reshape(-1).long(), bits.reshape(-1)).view(b, nw)


class _Walk:
    """The wave both searches share, over one query batch."""

    def __init__(self, queries, gallery, gallery_sqnorm, neighbors, beam, budget):
        self.b, self.d = queries.shape
        self.n, self.k = gallery.shape[0], neighbors.shape[1]
        self.q32 = queries.to(torch.float32)
        self.qn = (self.q32 * self.q32).sum(dim=1)
        self.gallery, self.gsq, self.neighbors = gallery, gallery_sqnorm, neighbors
        self.beam, self.budget = beam, budget
        self.rows = torch.arange(self.b, device=queries.device)[:, None]

    def true_dist(self, ids: torch.Tensor) -> torch.Tensor:
        """ids [B, M] -> window-mean L2 (db_features.cpp:40) in fp32."""
        dots = torch.einsum("bmd,bd->bm", self.gallery[ids].to(torch.float32), self.q32)
        return (self.qn[:, None] + self.gsq[ids] - 2.0 * dots) / self.d

    def start(self, ids, d, visited, checked, active):
        order = torch.sort(d, dim=1, stable=True).indices[:, : self.beam]
        exp = torch.zeros((self.b, self.beam), dtype=torch.bool, device=d.device)
        return ids.gather(1, order), d.gather(1, order), exp, visited, checked, active

    def wave(self, front_ids, front_d, front_exp, visited, checked, active):
        """Expand the active queries' closest unexpanded slots, as many as the budget allows (>= 1)."""
        b, beam, k, dev = self.b, self.beam, self.k, front_d.device
        w_act = torch.clamp(torch.div(self.budget - checked, k, rounding_mode="floor"), 1, beam)
        unexp = ~front_exp
        expand = unexp & (torch.cumsum(unexp.int(), dim=1) <= w_act[:, None]) & active[:, None]
        cand = self.neighbors[front_ids].reshape(b, beam * k).long()
        slot = torch.repeat_interleave(expand, k, dim=1)
        seen = (visited[self.rows, cand >> 5] & _bit_of(cand)) != 0
        # each distinct candidate once (non-expanded slots' keys never alias)
        srt = torch.sort(torch.where(slot, cand, cand + self.n), dim=1, stable=True)
        dup = torch.cat([torch.zeros((b, 1), dtype=torch.bool, device=dev), srt.values[:, 1:] == srt.values[:, :-1]],
                dim=1)
        fresh = ~seen & slot & ~torch.empty_like(dup).scatter_(1, srt.indices, dup)
        dc = torch.where(fresh, self.true_dist(cand), BIG)
        visited = _mark(visited, cand, torch.where(fresh, _bit_of(cand), 0))  # once, unset: add == OR
        checked = checked + fresh.sum(dim=1).int()
        front_exp = front_exp | expand
        m_d, m_i = torch.cat([front_d, dc], 1), torch.cat([front_ids, cand], 1)
        m_e = torch.cat([front_exp, torch.zeros((b, beam * k), dtype=torch.bool, device=dev)], 1)
        pick = torch.sort(m_d, dim=1, stable=True).indices[:, :beam]
        keep = active[:, None]  # this wave's probes were paid for: keep them
        return (torch.where(keep, m_i.gather(1, pick), front_ids), torch.where(keep, m_d.gather(1, pick), front_d),
                torch.where(keep, m_e.gather(1, pick), front_exp), visited, checked)


def _run(step, state, max_steps: int):
    """At most ``max_steps`` waves; "any active" read on the host every :data:`SYNC_EVERY` waves."""
    for s in range(max_steps):
        if s % SYNC_EVERY == 0 and not bool(state[-1].any()):
            break
        state = step(state)
    return state


def _sw_search(queries, gallery, gallery_sqnorm, neighbors, entry_ids, beam: int, budget: int, max_steps: int):
    """The graph walk from ``entry_ids``: (best id, distance, computations)."""
    w = _Walk(queries, gallery, gallery_sqnorm, neighbors, beam, budget)
    ids = entry_ids.long()
    visited = _mark(torch.zeros((w.b, (w.n + 31) // 32), dtype=torch.int32, device=ids.device), ids, _bit_of(ids))
    checked = torch.full((w.b,), ids.shape[1], dtype=torch.int32, device=ids.device)
    state = w.start(ids, w.true_dist(ids), visited, checked, torch.ones(w.b, dtype=torch.bool, device=ids.device))

    def step(st):
        *front, active = st
        front_ids, front_d, front_exp, visited, checked = w.wave(*front, active)
        # NSW/efSearch stop: every beam slot expanded, or the budget spent
        active = active & (~front_exp).any(dim=1) & (checked < budget)
        return front_ids, front_d, front_exp, visited, checked, active

    front_ids, front_d, _, _, checked, _ = _run(step, state, max_steps)
    return front_ids[:, 0].int(), front_d[:, 0], checked


def _sw_search_routed(queries, gallery, gallery_sqnorm, neighbors, sample_ids, beam: int, budget: int, max_steps: int):
    """Routed, restarting search from the ranked sample: (best id, distance, checked, final beam)."""
    w = _Walk(queries, gallery, gallery_sqnorm, neighbors, beam, budget)
    dev, sample_ids = queries.device, sample_ids.long()
    s = sample_ids.shape[0]
    sf = gallery[sample_ids].to(torch.float32)
    d_s = (w.qn[:, None] + gallery_sqnorm[sample_ids][None, :] - 2.0 * w.q32 @ sf.T) / w.d
    order_s = torch.sort(d_s, dim=1, stable=True).indices
    sorted_ids, sorted_d = sample_ids[order_s], d_s.gather(1, order_s)
    base = torch.zeros((1, (w.n + 31) // 32), dtype=torch.int32, device=dev)  # every query visits the sample
    visited = _mark(base, sample_ids[None, :], _bit_of(sample_ids[None, :])).expand(w.b, -1).clone()
    front = (sorted_ids[:, :beam], sorted_d[:, :beam], torch.zeros((w.b, beam), dtype=torch.bool, device=dev))
    r0 = torch.ones(w.b, dtype=torch.int32, device=dev)
    state = (*front, visited, torch.full((w.b,), s, dtype=torch.int32, device=dev), front[0][:, 0], front[1][:, 0],
            r0, torch.full((w.b,), s < budget, dtype=torch.bool, device=dev))
    lanes = torch.arange(beam, device=dev)[None, :]

    def step(st):
        front_ids, front_d, front_exp, visited, checked, best_id, best_d, r, active = st
        front_ids, front_d, front_exp, visited, checked = w.wave(front_ids, front_d, front_exp, visited, checked,
                active)
        better = front_d[:, 0] < best_d  # fold the head into the best before a restart
        best_d, best_id = torch.where(better, front_d[:, 0], best_d), torch.where(better, front_ids[:, 0], best_id)
        saturated, in_budget = ~(~front_exp).any(dim=1), checked < budget
        want = active & saturated & in_budget & (r < s // beam)
        cols = torch.clamp(r[:, None].long() * beam + lanes, 0, s - 1)
        rm = want[:, None]
        front_ids = torch.where(rm, sorted_ids.gather(1, cols), front_ids)
        front_d = torch.where(rm, sorted_d.gather(1, cols), front_d)
        active = active & in_budget & (~saturated | want)
        return front_ids, front_d, front_exp & ~rm, visited, checked, best_id, best_d, r + want.int(), active

    front_ids, front_d, _, _, checked, best_id, best_d, _, _ = _run(step, state, max_steps)
    better = front_d[:, 0] < best_d
    best_d, best_id = torch.where(better, front_d[:, 0], best_d), torch.where(better, front_ids[:, 0], best_id)
    return best_id.int(), best_d, checked, front_ids


def rescore_full_d(q_full, best_id, front_ids, checked_walk, gallery, gallery_sqnorm, pca_dim: int):
    """Full-D rescore of a PCA walk's beam; ``checked`` in full-D-equivalent computations."""
    d = q_full.shape[1]
    ids = torch.cat([best_id[:, None].long(), front_ids.long()], dim=1)
    dots = torch.einsum("brd,bd->br", gallery[ids], q_full)
    dist = ((q_full * q_full).sum(dim=1)[:, None] + gallery_sqnorm[ids] - 2.0 * dots) / d
    j = torch.argmin(dist, dim=1, keepdim=True)
    eq = checked_walk.to(torch.float32) * (pca_dim / d) + ids.shape[1]
    return ids.gather(1, j)[:, 0].int(), dist.gather(1, j)[:, 0], eq


class SmallWorldMatcher:
    """Budgeted graph-ANN matcher ("small_world_rand", ann.cpp:214)."""

    def __init__(self, gallery_features: np.ndarray, k_nn: int = 11, k_rand: int = 4, beam: int = 8,
            image_count_to_check: int = 0, seed: int = 0, sample_pool: int = 8192, pca_dim: int = 0,
            device: DeviceLike = None):
        self.device = resolve_device(device)
        self.name = f"small_world_rand(NN={k_nn + k_rand},beam={beam})"
        self._n, self._d = gallery_features.shape
        self.beam, self.seed = int(beam), seed
        self.gallery = torch.as_tensor(np.asarray(gallery_features, np.float32), device=self.device)
        self.gallery_sqnorm = (self.gallery * self.gallery).sum(dim=1)
        self.pca_dim = int(pca_dim) if 0 < pca_dim < self._d else 0
        self._walk_gallery, self._walk_sqnorm, self._budget_scale = self.gallery, self.gallery_sqnorm, 1
        if self.pca_dim:  # walk in the projection, rescore the final beam in full D
            pca = fit_pca(np.asarray(gallery_features, np.float32)[: min(self._n, 8192)], num_components=self.pca_dim)
            self._mu = torch.tensor(pca.mean, dtype=torch.float32, device=self.device)
            self._w = torch.tensor(pca.components.T, dtype=torch.float32, device=self.device)  # [D, P]
            self._walk_gallery = (self.gallery - self._mu) @ self._w
            self._walk_sqnorm = (self._walk_gallery * self._walk_gallery).sum(dim=1)
            self._budget_scale = max(1, self._d // self.pca_dim)
            self.name += f",pca{self.pca_dim}"
        self.neighbors = build_neighbor_table(self._walk_gallery, k_nn=k_nn, k_rand=k_rand, seed=seed)
        # the routing pool: a seeded sample; a search scans its first S rows
        pool = np.random.default_rng(seed + 2).choice(self._n, size=min(self._n, int(sample_pool)), replace=False)
        self._sample_pool = torch.from_numpy(pool.astype(np.int32)).to(self.device)
        self.set_budget(image_count_to_check)

    def _sample_size(self, walk_budget: int) -> int:
        """Routing-scan size in walk-space probes, a multiple of beam."""
        beam = min(self.beam, self._n)
        s = min(int(self._sample_pool.shape[0]), max(4 * beam, walk_budget // 2), max(beam, walk_budget))
        return max(beam, (s // beam) * beam)

    def set_budget(self, image_count_to_check: int) -> None:
        if image_count_to_check <= 0 or image_count_to_check > self._n:
            image_count_to_check = self._n
        self.budget = int(image_count_to_check)

    def _entry_ids(self, b: int) -> torch.Tensor:
        """Seeded random entry points [b, beam] int32, distinct per row."""
        rng = np.random.default_rng(self.seed + 1)
        beam = min(self.beam, self._n)
        entries = rng.integers(0, self._n, size=(b, beam), dtype=np.int64)
        for _ in range(64):  # resample only the rows with a repeat
            srt = np.sort(entries, axis=1)
            dup = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
            if not dup.any():
                break
            entries[dup] = rng.integers(0, self._n, size=(int(dup.sum()), beam), dtype=np.int64)
        else:  # pragma: no cover - n ~ beam: deterministic fill
            entries = np.argsort(rng.random((b, self._n)), axis=1)[:, :beam]
        return torch.from_numpy(entries.astype(np.int32)).to(self.device)

    def search_device(self, queries_dev: torch.Tensor, entries: Optional[torch.Tensor] = None):
        """(best id, distance, computations) on the device; ``entries``: the pure walk."""
        beam, k = min(self.beam, self._n), int(self.neighbors.shape[1])
        q_full = torch.as_tensor(queries_dev, device=self.device).to(torch.float32)
        q_walk = (q_full - self._mu) @ self._w if self.pca_dim else q_full
        if entries is not None:
            return _sw_search(q_walk, self._walk_gallery, self._walk_sqnorm, self.neighbors, entries, beam=beam,
                    budget=self.budget, max_steps=self.budget + beam * k + 8)
        # PCA: the arithmetic budget buys D/P walk probes; beam + 1 rescores at full weight
        walk_budget = (min(self._n, max(1, self.budget - beam - 1) * self._budget_scale) if self.pca_dim
                else self.budget)
        best_id, best_d, checked, front_ids = _sw_search_routed(
            q_walk, self._walk_gallery, self._walk_sqnorm, self.neighbors,
            self._sample_pool[: self._sample_size(walk_budget)], beam=beam, budget=walk_budget,
            max_steps=walk_budget + beam * k + 8,  # a safety net: <= budget + beam expansions happen
        )
        if not self.pca_dim:
            return best_id, best_d, checked
        return rescore_full_d(q_full, best_id, front_ids, checked, self.gallery, self.gallery_sqnorm, self.pca_dim)

    def search(self, queries: np.ndarray) -> SearchResult:
        idx, dist, checked = self.search_device(torch.as_tensor(np.asarray(queries, np.float32), device=self.device))
        return SearchResult(indices=idx.cpu().numpy().astype(np.int32), distances=dist.cpu().numpy().astype(np.float32),
                checked_fraction=checked.cpu().numpy().astype(np.float32) / self._n)
