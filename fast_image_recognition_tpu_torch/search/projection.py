"""Budgeted ANN baselines (JAX ``search/projection.py``): ``proj_incsort`` on the
device over the rows nearest in a projection; FLANN's kd-forest on the host."""

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.distances import pairwise_distances
from ..ops.pca import fit_pca
from .base import SearchResult

BIG = 3.4e38


def _proj_search(
    queries: torch.Tensor,  # [B, D]
    gallery: torch.Tensor,  # [N, D]
    proj: torch.Tensor,  # [D, P]
    gallery_proj: torch.Tensor,  # [N, P]
    budget: int,
):
    """(best row, its true distance) among the ``budget`` rows nearest each query in the projection."""
    d_all = pairwise_distances(queries, gallery)  # [B, N] true distances
    qp = queries @ proj  # [B, P]
    # projected L2 ranking (one matmul via the expansion)
    qn = (qp * qp).sum(dim=1, keepdim=True)
    gn = (gallery_proj * gallery_proj).sum(dim=1)[None, :]
    d_proj = qn + gn - 2.0 * qp @ gallery_proj.T
    order = torch.sort(d_proj, dim=1, stable=True).indices[:, :budget]
    d_cand = d_all.gather(1, order)
    best = torch.argmin(d_cand, dim=1, keepdim=True)
    return order.gather(1, best)[:, 0].to(torch.int32), d_cand.gather(1, best)[:, 0]


class ProjectionIndexMatcher:
    """'proj_incsort'-style budgeted matcher ("nmslib", ann.cpp:201)."""

    def __init__(
        self,
        gallery_features: np.ndarray,
        proj_dim: int = 32,  # projDim=32 (ann.cpp:232)
        proj_type: str = "random",  # or 'pca'
        image_count_to_check: int = 0,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.name = f"proj_incsort({proj_type}{proj_dim})"
        self._n, d = gallery_features.shape
        if proj_type == "pca":
            pca = fit_pca(gallery_features, num_components=proj_dim)
            proj = pca.components.T.astype(np.float32)
        else:
            rng = np.random.default_rng(seed)
            proj = (rng.standard_normal((d, proj_dim)) / np.sqrt(proj_dim)).astype(np.float32)
        self.gallery = torch.as_tensor(np.asarray(gallery_features, np.float32), device=self.device)
        self.proj = torch.from_numpy(np.ascontiguousarray(proj)).to(self.device)
        self.gallery_proj = self.gallery @ self.proj
        self.set_budget(image_count_to_check)

    def set_budget(self, image_count_to_check: int) -> None:
        if image_count_to_check <= 0 or image_count_to_check > self._n:
            image_count_to_check = self._n
        self.budget = int(image_count_to_check)

    def search_device(self, queries: torch.Tensor):
        """Device in, device out: (best row [B] int32, distance [B])."""
        return _proj_search(queries.to(torch.float32), self.gallery, self.proj, self.gallery_proj, self.budget)

    def search(self, queries: np.ndarray) -> SearchResult:
        q = torch.as_tensor(np.asarray(queries, np.float32), device=self.device)
        idx, dist = self.search_device(q)
        return SearchResult(indices=idx.cpu().numpy(), distances=dist.cpu().numpy(),
            checked_fraction=np.full(q.shape[0], self.budget / self._n, dtype=np.float32))


class _FlatForest:
    """Randomized kd-forest in flat arrays (FLANN): splits at a sampled mean of a random high-variance dim, a count
    median where that degenerates."""

    def __init__(self, data: np.ndarray, num_trees: int, leaf_size: int, rng, top_dims: int = 5, sample: int = 128,
        pool_dims: int = 32):
        n, d = data.shape
        small_node = max(2 * sample, 4 * leaf_size)
        gpool = np.argpartition(data.var(axis=0), -min(pool_dims, d))[-min(pool_dims, d):]
        dim_l, val_l, left_l, right_l, leaf_of = [], [], [], [], []
        leaves = []  # list of id arrays, padded later
        roots = []

        def new_node():
            dim_l.append(-1)
            val_l.append(0.0)
            left_l.append(-1)
            right_l.append(-1)
            leaf_of.append(-1)
            return len(dim_l) - 1

        for _ in range(num_trees):
            root = new_node()
            roots.append(root)
            stack = [(root, np.arange(n))]
            while stack:
                node, idx = stack.pop()
                if len(idx) <= leaf_size:
                    leaf_of[node] = len(leaves)
                    leaves.append(idx)
                    continue
                if len(idx) > small_node:
                    srows = rng.choice(idx, sample, replace=False)
                    sub = data[srows]
                    var = sub.var(axis=0)
                    cand = np.argpartition(var, -top_dims)[-top_dims:]
                    dim = int(rng.choice(cand))
                    val = float(sub[:, dim].mean())
                else:
                    dim = int(rng.choice(gpool))
                    val = float(data[idx, dim].mean())
                col = data[idx, dim]
                mask = col < val
                if not mask.any() or mask.all():
                    order = np.argsort(col)
                    half = len(idx) // 2
                    li, ri = idx[order[:half]], idx[order[half:]]
                    val = float(col[order[min(half, len(order) - 1)]])
                    if len(li) == 0 or len(ri) == 0:
                        leaf_of[node] = len(leaves)
                        leaves.append(idx)
                        continue
                else:
                    li, ri = idx[mask], idx[~mask]
                dim_l[node], val_l[node] = dim, val
                lnode, rnode = new_node(), new_node()
                left_l[node], right_l[node] = lnode, rnode
                stack.append((lnode, li))
                stack.append((rnode, ri))

        self.dim = np.asarray(dim_l, np.int32)
        self.val = np.asarray(val_l, np.float32)
        self.left = np.asarray(left_l, np.int32)
        self.right = np.asarray(right_l, np.int32)
        self.leaf_of = np.asarray(leaf_of, np.int32)
        self.roots = np.asarray(roots, np.int32)
        lmax = max((len(ids) for ids in leaves), default=leaf_size)
        self.leaf_size = max(leaf_size, lmax)
        self.leaf_ids = np.full((len(leaves), self.leaf_size), -1, np.int32)
        for i, ids in enumerate(leaves):
            self.leaf_ids[i, : len(ids)] = ids


def _heap_push(hb, hn, hs, rows, bound, node):
    """Vectorized binary-heap push of (bound, node) for each probe in ``rows``, sifted up in lockstep."""
    i = hs[rows].copy()
    hb[rows, i] = bound
    hn[rows, i] = node
    hs[rows] += 1
    r = rows
    while len(r):
        live = i > 0
        r, i = r[live], i[live]
        if not len(r):
            break
        p = (i - 1) // 2
        swap = hb[r, i] < hb[r, p]
        rs, is_, ps = r[swap], i[swap], p[swap]
        tb, tn = hb[rs, is_].copy(), hn[rs, is_].copy()
        hb[rs, is_], hn[rs, is_] = hb[rs, ps], hn[rs, ps]
        hb[rs, ps], hn[rs, ps] = tb, tn
        r, i = rs, ps


def _heap_pop(hb, hn, hs, rows):
    """Pops each probe's root and sifts down; slots at or past ``hs`` hold +inf."""
    bound = hb[rows, 0].copy()
    node = hn[rows, 0].copy()
    last = hs[rows] - 1
    hb[rows, 0] = hb[rows, last]
    hn[rows, 0] = hn[rows, last]
    hb[rows, last] = np.inf
    hs[rows] -= 1
    r, i = rows, np.zeros(len(rows), np.int64)
    sz = hs[rows]
    while len(r):
        l = 2 * i + 1
        live = l < sz  # also guarantees l, l+1 are in-array (sz <= H-1)
        r, i, sz = r[live], i[live], sz[live]
        if not len(r):
            break
        l = 2 * i + 1
        lb, rb = hb[r, l], hb[r, l + 1]
        c = np.where(rb < lb, l + 1, l)
        cb = np.minimum(lb, rb)
        swap = cb < hb[r, i]
        rs, is_, cs = r[swap], i[swap], c[swap]
        tb, tn = hb[rs, is_].copy(), hn[rs, is_].copy()
        hb[rs, is_], hn[rs, is_] = hb[rs, cs], hn[rs, cs]
        hb[rs, cs], hn[rs, cs] = tb, tn
        r, i, sz = rs, cs, sz[swap]
    return bound, node


class KDTreeMatcher:
    """Host kd-forest: 4 randomized trees, best-first, a budget of distances (<= 0: exact)."""

    def __init__(
        self,
        gallery_features: np.ndarray,
        leaf_size: int = 16,
        num_trees: int = 4,  # KDTreeIndexParams(4), ann.cpp:180
        image_count_to_check: int = 0,
        seed: int = 0,
    ):
        self.name = "flann"
        self.data = np.asarray(gallery_features, np.float32)
        self._n, self._d = self.data.shape
        self._norms = np.einsum("nd,nd->n", self.data, self.data)
        rng = np.random.default_rng(seed)
        self.forest = _FlatForest(self.data, num_trees, leaf_size, rng)
        self.set_budget(image_count_to_check)

    def set_budget(self, image_count_to_check: int) -> None:
        if image_count_to_check <= 0 or image_count_to_check > self._n:
            image_count_to_check = self._n
        self.checks = int(image_count_to_check)

    def _search_batch(self, q: np.ndarray):
        """FLANN's best-first traversal, every probe in lockstep."""
        f = self.forest
        B = q.shape[0]
        n, L = self._n, f.leaf_size
        qn = np.einsum("bd,bd->b", q, q)
        H = 64
        hb = np.full((B, H), np.inf, np.float32)
        hn = np.zeros((B, H), np.int32)
        hs = np.zeros(B, np.int64)
        for root in f.roots:
            _heap_push(hb, hn, hs, np.arange(B), np.zeros(B, np.float32), np.full(B, root, np.int32))
        visited = np.zeros((B, (n + 7) // 8), np.uint8)  # bitmap dedup
        best_d = np.full(B, np.inf, np.float32)
        best_i = np.full(B, -1, np.int64)
        checked = np.zeros(B, np.int64)
        active = np.ones(B, bool)
        while active.any():
            rows = np.nonzero(active)[0]
            done = hs[rows] == 0
            if not done.all():
                live = rows[~done]
                bound, node = _heap_pop(hb, hn, hs, live)
                certified = bound >= best_d[live]
                active[live[certified]] = False
                live, node = live[~certified], node[~certified]
                bound = bound[~certified]
            else:
                live = rows[:0]
            active[rows[done]] = False
            if len(live) == 0:
                continue
            cur = node
            while True:
                internal = f.left[cur] >= 0
                if not internal.any():
                    break
                li, ci = live[internal], cur[internal]
                if hs.max() + 1 >= hb.shape[1]:  # grow heaps
                    pad = np.full_like(hb, np.inf)
                    hb = np.concatenate([hb, pad], axis=1)
                    hn = np.concatenate([hn, np.zeros_like(hn)], axis=1)
                diff = q[li, f.dim[ci]] - f.val[ci]
                near = np.where(diff < 0, f.left[ci], f.right[ci])
                far = np.where(diff < 0, f.right[ci], f.left[ci])
                _heap_push(hb, hn, hs, li, bound[internal] + diff * diff, far.astype(np.int32))
                nxt = cur.copy()
                nxt[internal] = near
                cur = nxt
            ids = f.leaf_ids[f.leaf_of[cur]]  # [b, L]
            safe = np.maximum(ids, 0)
            fresh = (ids >= 0) & ((visited[live[:, None], safe >> 3] >> (safe & 7)) & 1 == 0)
            room = (self.checks - checked[live])[:, None]
            keep = fresh & (np.cumsum(fresh, axis=1) <= room)
            kl, kp = np.nonzero(keep)
            kid = ids[kl, kp]
            np.bitwise_or.at(visited, (live[kl], kid >> 3), (1 << (kid & 7)).astype(np.uint8))
            checked[live] += keep.sum(axis=1)
            dd = (self._norms[safe] - 2.0 * np.einsum("bld,bd->bl", self.data[safe], q[live]) + qn[live, None])
            dd[~keep] = np.inf
            j = np.argmin(dd, axis=1)
            cand_d = dd[np.arange(len(live)), j]
            better = cand_d < best_d[live]
            upd = live[better]
            best_d[upd] = cand_d[better]
            best_i[upd] = ids[better, j[better]]
            active[live[checked[live] >= self.checks]] = False
        return best_i, best_d, checked

    def search(self, queries: np.ndarray) -> SearchResult:
        q = np.asarray(queries, np.float32)
        best_i, best_d, checked = self._search_batch(q)
        return SearchResult(indices=best_i.astype(np.int32), distances=np.maximum(best_d, 0.0) / self._d,
            checked_fraction=checked.astype(np.float32) / self._n)
