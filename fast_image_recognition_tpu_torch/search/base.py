"""Matcher interface (the port's own copy of
``fast_image_recognition_tpu/search/base.py``).

The reference's harness contract is ``ClassificationMethod``: construct over
the gallery, ``setImageCountToCheck`` for budgeted methods, ``recognize`` one
probe at a time, with ``distanceCalcCount`` / ``avgCheckedPercent``
instrumentation (qt_cpp/ann.h:9-39). The TPU-native contract is batched:
``search`` takes a [B, D] probe block and returns per-probe results plus the
fraction of the gallery actually probed (exact methods report 1.0)."""

from __future__ import annotations

import dataclasses
from typing import Protocol

import numpy as np


@dataclasses.dataclass
class SearchResult:
    indices: np.ndarray  # [B] int32 best gallery row per probe (-1 if none)
    distances: np.ndarray  # [B] float32 best distance
    checked_fraction: np.ndarray  # [B] float32 fraction of gallery probed


class Matcher(Protocol):
    name: str

    def set_budget(self, image_count_to_check: int) -> None:
        """Budget of gallery rows an approximate method may probe
        (ann.h:20-22); exact matchers ignore it."""
        ...

    def search(self, queries: np.ndarray) -> SearchResult:
        ...
