"""Video frame-set recognition (JAX ``evaluation/video.py``): per-video
log-posterior fusion on the device."""

import dataclasses
import time
from typing import Callable, Dict

import numpy as np
import torch

from ..data.feature_io import FeatureDB
from ..data.video_io import VideoDB
from ..device import DeviceLike, resolve_device
from ..ops.distances import pairwise_distances


@dataclasses.dataclass
class IdentityIntersection:
    """The common person set with both sides remapped into one class-id
    space (person2indexMapNew, video.cpp:212-236)."""

    gallery_mask: np.ndarray  # [N] stills of common identities
    video_mask: np.ndarray  # [V] videos of common identities
    new_id: Dict[str, int]  # common person name -> new class id
    gallery_labels: np.ndarray  # [N] new ids (-1 where masked)
    video_labels: np.ndarray  # [V] new ids (-1 where masked)

    @property
    def num_classes(self) -> int:
        return len(self.new_id)


def intersect_identities(db: FeatureDB, videos: VideoDB) -> IdentityIntersection:
    """video.cpp:182-210 (set_intersection over sorted names)."""
    common = sorted(set(db.class_names) & set(videos.person_names))
    new_id = {name: i for i, name in enumerate(common)}
    g_old_to_new = np.asarray([new_id.get(name, -1) for name in db.class_names], np.int64)
    v_old_to_new = np.asarray([new_id.get(name, -1) for name in videos.person_names], np.int64)
    g_labels = g_old_to_new[db.labels]
    v_labels = v_old_to_new[videos.video_person]
    return IdentityIntersection(gallery_mask=g_labels >= 0, video_mask=v_labels >= 0, new_id=new_id,
        gallery_labels=g_labels, video_labels=v_labels)


def sample_probe_frames(videos: VideoDB, step: int = 10) -> np.ndarray:
    """Every ``step``-th frame of each video (video.cpp:219)."""
    idx = []
    for v in range(videos.num_videos):
        idx.extend(np.flatnonzero(videos.frame_video == v)[::step].tolist())
    return np.asarray(idx, np.int64)


@dataclasses.dataclass
class VideoEvalResult:
    frame_error: float  # per-frame error % (the reference's metric)
    video_error: float  # per-video error % after aggregation
    ms_per_frame: float
    aggregation: str


def _aggregate(frame_dists: np.ndarray, frame_pred: np.ndarray, frame_video: np.ndarray, num_classes: int,
    num_videos: int, mode: str) -> np.ndarray:
    """Per-video decision from per-frame evidence (-1 for a video with no sampled frame)."""
    preds = np.zeros(num_videos, dtype=np.int64)
    for v in range(num_videos):
        mask = frame_video == v
        if not mask.any():
            preds[v] = -1
        elif mode == "min_distance":
            preds[v] = frame_pred[mask][np.argmin(frame_dists[mask])]
        elif mode == "majority":
            preds[v] = np.bincount(frame_pred[mask], minlength=num_classes).argmax()
        else:
            raise ValueError(mode)
    return preds


def make_video_fusion_fn(gallery: np.ndarray, gallery_labels: np.ndarray, num_classes: int, num_videos: int,
    dist_weight: float = 100.0, device: DeviceLike = None) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The fusion with the gallery on ``device``: ``fn(probes, frame_video) -> classes a video``."""
    dev = resolve_device(device)
    g = torch.as_tensor(np.asarray(gallery, np.float32)).to(dev)
    gl = torch.as_tensor(np.asarray(gallery_labels), dtype=torch.int64).to(dev)

    @torch.no_grad()
    def fn(probes, frame_video) -> torch.Tensor:
        d = pairwise_distances(torch.as_tensor(probes).to(dev, torch.float32), g)
        f = d.shape[0]
        cmin = torch.full((f, num_classes), 1e30, dtype=torch.float32, device=dev)
        cmin = cmin.scatter_reduce(1, gl[None, :].expand(f, -1), d, "amin")
        logp = torch.log_softmax(-dist_weight * cmin, dim=1)
        fv = torch.as_tensor(frame_video).to(dev, torch.int64)
        video_logp = torch.zeros((num_videos, num_classes), dtype=torch.float32, device=dev)
        return torch.argmax(video_logp.index_add_(0, fv, logp), dim=1)

    return fn


def video_log_posterior_fusion(probes: np.ndarray, gallery: np.ndarray, gallery_labels: np.ndarray,
    frame_video: np.ndarray, num_classes: int, num_videos: int, dist_weight: float = 100.0, device: DeviceLike = None
) -> np.ndarray:
    """Per-frame class log-posteriors (softmax of ``-w`` x min class distance) summed a video."""
    fn = make_video_fusion_fn(gallery, gallery_labels, num_classes, num_videos, dist_weight, device=device)
    return fn(np.asarray(probes, np.float32), np.asarray(frame_video)).cpu().numpy()


def evaluate_video_recognition(matcher, gallery_labels: np.ndarray, videos: VideoDB, video_labels: np.ndarray,
    probe_frames_idx: np.ndarray, num_classes: int, aggregation: str = "min_distance", batch_size: int = 1024
) -> VideoEvalResult:
    """Frame-level recognition (the reference's metric) and per-video fusion through a matcher."""
    probes = videos.frames[probe_frames_idx]
    frame_video = videos.frame_video[probe_frames_idx]
    frame_truth = video_labels[frame_video]
    t0 = time.perf_counter()
    preds = np.full(len(probes), -1, dtype=np.int64)
    dists = np.full(len(probes), np.inf)
    for s in range(0, len(probes), batch_size):
        res = matcher.search(probes[s : s + batch_size])
        ok = res.indices >= 0
        preds[s : s + batch_size][ok] = gallery_labels[res.indices[ok]]
        dists[s : s + batch_size] = res.distances
    elapsed = time.perf_counter() - t0
    frame_error = 100.0 * (preds != frame_truth).mean()
    video_pred = _aggregate(dists, preds, frame_video, num_classes, videos.num_videos, aggregation)
    valid = np.asarray([np.any(frame_video == v) for v in range(videos.num_videos)])
    video_error = 100.0 * (video_pred[valid] != video_labels[valid]).mean()
    return VideoEvalResult(frame_error=float(frame_error), video_error=float(video_error),
        ms_per_frame=1000.0 * elapsed / max(len(probes), 1), aggregation=aggregation)
