"""Three-way-decision sequential classifiers (JAX ``cascade/twd.py``;
ImageTesting.cpp:74-288): ``ConventionalTWD``, ``ProposedTWD`` (JAX's
``lax.scan`` a Python loop)."""

import dataclasses
import enum
from typing import Tuple

import numpy as np
import torch

from ..config import DistanceKind
from ..device import DeviceLike, resolve_device
from ..ops.distances import oracle_pairwise, pairwise_distances

BIG = 1e30


class TWDType(str, enum.Enum):
    POSTERIORS = "posteriors"  # ImageTesting.cpp:139-156
    DIST_DIFF = "diff"  # :157-159
    DIST_RATIO = "ratio"  # :161-163


def _class_min(d: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Per-class min distance: [B, N] x [N] -> [B, C] (BIG where empty)."""
    b = d.shape[0]
    out = torch.full((b, num_classes), BIG, dtype=d.dtype, device=d.device)
    return out.scatter_reduce(1, labels[None, :].expand(b, -1), d, "amin")


@torch.no_grad()
def _twd_stage1(queries, gallery, labels, num_classes: int, reduced: int, threshold: float, twd_type: TWDType,
        kind: DistanceKind, top_probabs: int = 5, dist_weight: float = 100.0):
    """Stage-1 distances over the reduced prefix: (d1, best row, reliable)."""
    d1 = pairwise_distances(queries, gallery, 0, reduced, kind)
    best_idx = torch.argmin(d1, dim=1)
    best_dist = d1.gather(1, best_idx[:, None])[:, 0]
    best_class = labels[best_idx]
    cmin = _class_min(d1, labels, num_classes)
    second_dist = cmin.scatter(1, best_class[:, None], BIG).amin(dim=1)
    if twd_type == TWDType.POSTERIORS:
        probabs = torch.exp(-cmin * dist_weight)  # exp(-100 d), :119
        top = torch.topk(probabs, min(top_probabs, num_classes), dim=1).values
        reliable = torch.exp(-best_dist * dist_weight) / top.sum(dim=1) > threshold
    elif twd_type == TWDType.DIST_DIFF:
        reliable = (second_dist - best_dist) > threshold
    else:
        reliable = (best_dist / second_dist) < threshold
    return d1, best_idx, reliable


@torch.no_grad()
def _twd_refine(queries, d1, gallery, reduced: int, refine_to: int, kind: DistanceKind) -> torch.Tensor:
    """Refinement on the stage-1 sums for the unreliable probes: their best row over ``refine_to``."""
    d_delta = pairwise_distances(queries, gallery, reduced, refine_to, kind)
    d2 = (d1 * reduced + d_delta * (refine_to - reduced)) / refine_to
    return torch.argmin(d2, dim=1)


@dataclasses.dataclass
class ConventionalTWD:
    """The name follows ImageTesting.cpp:90-106's printouts."""

    gallery: np.ndarray
    labels: np.ndarray
    num_classes: int
    twd_type: TWDType
    threshold: float
    reduced_features: int = 64
    refine_to: int = 256
    kind: DistanceKind = DistanceKind.L2
    device: DeviceLike = None

    def __post_init__(self):
        prefix = {TWDType.POSTERIORS: "TWD posteriors", TWDType.DIST_DIFF: "TWD diff", TWDType.DIST_RATIO: "TWD ratio"
        }[self.twd_type]
        self.name = f"{prefix}, {self.threshold}"
        self._dev = resolve_device(self.device)
        self._g = torch.as_tensor(np.asarray(self.gallery, np.float32)).to(self._dev)
        self._l = torch.as_tensor(np.asarray(self.labels), dtype=torch.int64).to(self._dev)
        self._unreliable = 0

    def reset_counters(self):
        self._unreliable = 0

    @property
    def unreliable_count(self) -> int:
        return self._unreliable

    def predict(self, queries: np.ndarray) -> np.ndarray:
        q = torch.as_tensor(np.asarray(queries, np.float32)).to(self._dev)
        d1, best_idx, reliable = _twd_stage1(
            q, self._g, self._l, self.num_classes, self.reduced_features, self.threshold, self.twd_type, self.kind
        )
        final_idx = best_idx.cpu().numpy()
        unrel = np.flatnonzero(~reliable.cpu().numpy())
        if unrel.size:
            sel = torch.from_numpy(unrel).to(self._dev)
            refined = _twd_refine(q[sel], d1[sel], self._g, self.reduced_features, self.refine_to, self.kind)
            final_idx[unrel] = refined.cpu().numpy()
        self._unreliable += int(unrel.size)
        return np.asarray(self.labels)[final_idx]


@torch.no_grad()
def _proposed_twd(queries, gallery, labels, num_classes: int, chunk: int, max_features: int, inv_theta: float,
        kind: DistanceKind, granularity: str):
    """Returns (predicted labels [B], needed a second round [B], best row [B])."""
    b, n = queries.shape[0], gallery.shape[0]
    dev = queries.device
    dist = torch.zeros((b, n), dtype=torch.float32, device=dev)
    active = torch.ones((b, n), dtype=torch.bool, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    best_idx = torch.zeros(b, dtype=torch.int64, device=dev)
    needed_round2 = torch.zeros(b, dtype=torch.bool, device=dev)
    for ci in range(max_features // chunk):
        start = ci * chunk
        # chunk-mean distances accumulate (ImageTesting.cpp:243)
        d_chunk = pairwise_distances(queries, gallery, start, start + chunk, kind)
        dist = dist + torch.where(done[:, None], 0.0, d_chunk)
        masked = torch.where(active, dist, BIG)
        round_best_idx = torch.argmin(masked, dim=1)
        round_best = masked.gather(1, round_best_idx[:, None])[:, 0]
        best_idx = torch.where(done, best_idx, round_best_idx)
        thresh = round_best * inv_theta
        if granularity == "instance":
            keep = masked <= thresh[:, None]
            other_alive = keep & (labels[None, :] != labels[best_idx][:, None])
            num_variants = 1 + other_alive.sum(dim=1)
        else:
            keep_class = _class_min(masked, labels, num_classes) <= thresh[:, None]
            num_variants = keep_class.sum(dim=1)
            keep = keep_class[:, labels]
        round_done = num_variants == 1
        if ci == 0:
            needed_round2 = ~round_done
        active = torch.where(done[:, None], active, active & keep)
        done = done | round_done
    return labels[best_idx], needed_round2, best_idx


@dataclasses.dataclass
class ProposedTWD:
    """'Proposed TWD, <chunk>, <1/theta>' (ImageTesting.cpp:201-205)."""

    gallery: np.ndarray
    labels: np.ndarray
    num_classes: int
    chunk_features: int = 32
    theta: float = 0.7
    max_features: int = 256
    kind: DistanceKind = DistanceKind.L2
    granularity: str = "instance"  # CHECK_ALL_INSTANCES (:206)
    device: DeviceLike = None

    def __post_init__(self):
        if self.granularity not in ("instance", "class"):
            raise ValueError(f"unknown granularity {self.granularity!r}")
        self.name = f"Proposed TWD, {self.chunk_features}, {1.0 / self.theta}"
        self._dev = resolve_device(self.device)
        self._g = torch.as_tensor(np.asarray(self.gallery, np.float32)).to(self._dev)
        self._l = torch.as_tensor(np.asarray(self.labels), dtype=torch.int64).to(self._dev)
        self._unreliable = 0

    def reset_counters(self):
        self._unreliable = 0

    @property
    def unreliable_count(self) -> int:
        return self._unreliable

    def predict(self, queries: np.ndarray) -> np.ndarray:
        preds, needed2, _ = _proposed_twd(
            torch.as_tensor(np.asarray(queries, np.float32)).to(self._dev), self._g, self._l, self.num_classes,
            self.chunk_features, self.max_features, 1.0 / self.theta, self.kind, self.granularity)
        self._unreliable += int(needed2.sum().item())
        return preds.cpu().numpy()


# NumPy oracle of ImageTesting.cpp (CHECK_ALL_INSTANCES), for parity tests


def proposed_twd_oracle(query: np.ndarray, gallery: np.ndarray, labels: np.ndarray, chunk: int, theta: float,
    max_features: int = 256) -> Tuple[int, bool]:
    """ImageTesting.cpp:207-288 for one probe in float64: (class, more than one round)."""
    n = gallery.shape[0]
    inv_theta = 1.0 / theta
    distances = np.zeros(n)
    check = np.ones(n, dtype=bool)
    best_ind = -1
    needed2 = False
    for cur in range(0, max_features, chunk):
        d_chunk = oracle_pairwise(query[None], gallery, cur, cur + chunk)[0]
        distances[check] += d_chunk[check]
        masked = np.where(check, distances, np.inf)
        j = int(np.argmin(masked))
        best_dist = BIG
        if masked[j] < BIG:
            best_dist, best_ind = masked[j], j
        dropped = check & (distances > best_dist * inv_theta)
        num_variants = 1 + int(np.sum(check & ~dropped & (labels != labels[best_ind])))
        check &= ~dropped
        if num_variants == 1:
            break
        if cur == 0:
            needed2 = True
    return int(labels[best_ind]), needed2
