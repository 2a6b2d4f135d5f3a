"""Matcher interface (JAX ``search/base.py``): the reference's
``ClassificationMethod`` (qt_cpp/ann.h:9-39) batched: ``search`` takes
[B, D] probes and returns per-probe results and the probed fraction."""

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
        """Gallery rows an approximate method may probe (ann.h:20-22); exact matchers ignore it."""
        ...

    def search(self, queries: np.ndarray) -> SearchResult:
        ...
