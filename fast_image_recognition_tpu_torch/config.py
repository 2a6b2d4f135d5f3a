"""Runtime configuration of the port: the port's own copy of
``fast_image_recognition_tpu/config.py``, same fields and defaults, in
place of the reference's compile-time defines (qt_cpp/db.h:4-91,
db_features.h:10-12, ann.cpp:270) and module constants
(tf_keras/sequential_inference.py:36-38).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence


class DistanceKind(str, enum.Enum):
    """Distance selected by USE_L2_DISTANCE / chi2 / KL in the reference
    (qt_cpp/db_features.cpp:22-42)."""

    L2 = "l2"
    CHI2 = "chi2"
    KL = "kl"


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """The dataset selection (qt_cpp/db.h:4-91)."""

    name: str = "caltech"
    features_file: str = "101_ObjectCategories_inception_resnet_v2.txt"
    features_count: int = 1536  # db.h:79-91
    skip_class_substrings: Sequence[str] = ("BACKGROUND_Google", "257.clutter")  # db_features.cpp:60-64
    max_classes: Optional[int] = None  # db_features.cpp:66-70
    # train split: per class, or ceil(fraction * n) (db_features.cpp:117-162)
    train_images_per_class: Optional[int] = 30
    train_fraction: float = 0.03


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """1-NN / ANN matcher options (qt_cpp/ann.h, qt_cpp/ann.cpp)."""

    distance: DistanceKind = DistanceKind.L2
    image_count_to_check: int = 0  # rows a budgeted method probes, 0: all (ann.h:20-22)
    # DEM pivots: max(5, 0.015*N) capped at 32 (ann.cpp:371-379)
    dem_pivot_fraction: float = 0.015
    dem_min_pivots: int = 5
    dem_max_pivots: int = 32
    false_accept_rate: float = 0.01  # DEM early exit (ann.h:64)
    query_tile: int = 128
    gallery_tile: int = 1024
    precision: str = "fp32"  # or 'int8': the int8 scan + exact rescore


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    """Early-exit cascade options (qt_cpp/ImageTesting.cpp:74-288)."""

    chunk_features: int = 32  # ImageTesting.cpp:221-224
    max_features: int = 256  # :169-171
    distance_ratio: float = 0.7  # :533-535
    knn_distance_ratio: float = 0.8  # sequential_inference.py:496
    svc_threshold: float = 0.06  # :655
    svc_far: float = 0.01  # :622-631


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout (``parallel/mesh.py``)."""

    data: int = 1
    gallery: int = 1
    model: int = 1


@dataclasses.dataclass(frozen=True)
class FrameworkConfig:
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    matcher: MatcherConfig = dataclasses.field(default_factory=MatcherConfig)
    cascade: CascadeConfig = dataclasses.field(default_factory=CascadeConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    seed: int = 123  # RANDOM_SEED (sequential_inference.py:30-32)
