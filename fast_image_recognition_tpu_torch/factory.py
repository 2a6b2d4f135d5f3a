"""Config-driven construction (JAX ``factory.py``): a ``FrameworkConfig`` picks
the dataset, matcher and cascade; on ``device`` but the host kd-forest."""

from typing import Optional

import numpy as np

from .config import CascadeConfig, DatasetConfig, MatcherConfig
from .device import DeviceLike

METHODS = ("bf", "bf-sharded", "dem", "dem-gather", "dem-full", "proj", "sw", "kdtree")


def load_dataset_from_config(cfg: DatasetConfig, seed: int = 123):
    """(gallery, glabels, probes, plabels, num_classes) from the configured file and split."""
    from .data import load_feature_file, train_test_split_images

    db = load_feature_file(cfg.features_file, features_count=cfg.features_count,
        skip_class_substrings=tuple(cfg.skip_class_substrings), max_classes=cfg.max_classes)
    split = train_test_split_images(db.labels, np.random.default_rng(seed),
        train_images_per_class=cfg.train_images_per_class, train_fraction=cfg.train_fraction)
    return (db.features[split.train_idx], db.labels[split.train_idx], db.features[split.test_idx],
        db.labels[split.test_idx], db.num_classes)


def build_matcher(method: str, gallery: np.ndarray, labels: np.ndarray, cfg: Optional[MatcherConfig] = None,
    seed: int = 0, mesh=None, device: DeviceLike = None):
    """A matcher of :data:`METHODS`; ``bf-sharded`` takes ``mesh``."""
    cfg = cfg or MatcherConfig()
    if method == "bf":
        from .search import BruteForceMatcher

        return BruteForceMatcher(gallery, kind=cfg.distance, precision=cfg.precision, device=device)
    if method == "bf-sharded":
        from .parallel import ShardedGalleryMatcher, gallery_mesh

        if mesh is None:
            mesh = gallery_mesh(devices=None if device is None else [device])
        return ShardedGalleryMatcher(gallery, mesh, tile_g=cfg.gallery_tile)
    if method in ("dem", "dem-gather", "dem-full"):
        from .search.dem import DirectedEnumerationMatcher, FullMatrixDEM

        kw = dict(false_accept_rate=cfg.false_accept_rate, image_count_to_check=cfg.image_count_to_check,
            kind=cfg.distance, seed=seed, pivot_fraction=cfg.dem_pivot_fraction, max_pivots=cfg.dem_max_pivots,
            device=device)
        if method == "dem-full":
            return FullMatrixDEM(gallery, labels, **kw)
        return DirectedEnumerationMatcher(
            gallery, labels, probe_mode="gather" if method == "dem-gather" else "exact", **kw
        )
    if method == "proj":
        from .search.projection import ProjectionIndexMatcher

        m = ProjectionIndexMatcher(gallery, seed=seed, device=device)
        if cfg.image_count_to_check:
            m.set_budget(cfg.image_count_to_check)
        return m
    if method == "sw":
        # a baseline (the reference's off-by-default NMSLIB
        # small_world_rand, qt_cpp/ann.h:121-157), never a recommended matcher
        from .search.small_world import SmallWorldMatcher

        return SmallWorldMatcher(gallery, image_count_to_check=cfg.image_count_to_check, seed=seed, device=device)
    if method == "kdtree":
        from .search.projection import KDTreeMatcher

        return KDTreeMatcher(gallery)
    raise ValueError(f"unknown matcher method {method!r}")


def build_twd_classifiers(gallery: np.ndarray, labels: np.ndarray, num_classes: int,
    cfg: Optional[CascadeConfig] = None, device: DeviceLike = None):
    """The testRecognition classifier battery (ImageTesting.cpp:525-538) from config thresholds."""
    from .cascade import ConventionalTWD, ProposedTWD, TWDType

    cfg = cfg or CascadeConfig()
    d = gallery.shape[1]
    refine_to = min(cfg.max_features, d)
    reduced = min(64, d)
    conv = dict(reduced_features=reduced, refine_to=refine_to, device=device)
    return [ConventionalTWD(gallery, labels, num_classes, TWDType.POSTERIORS, 0.24, **conv), ConventionalTWD(gallery,
            labels, num_classes, TWDType.DIST_DIFF, 0.003, **conv), ConventionalTWD(gallery, labels, num_classes,
            TWDType.DIST_RATIO, cfg.distance_ratio, **conv), ProposedTWD(gallery, labels, num_classes,
            min(cfg.chunk_features, d), cfg.distance_ratio, max_features=refine_to, device=device), ProposedTWD(gallery,
            labels, num_classes, min(64, d), cfg.distance_ratio, max_features=refine_to, device=device)]
