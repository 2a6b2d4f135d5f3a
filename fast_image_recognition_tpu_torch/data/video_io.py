"""YTF-style video feature files (JAX ``data/video_io.py``; video.cpp:35-97):
per frame a name and floats, zeroed below 1e-4 and L2-normalized."""

import dataclasses
from typing import List

import numpy as np

from .feature_io import normalize_features


@dataclasses.dataclass
class VideoDB:
    """Flat frame arrays with video and person indices."""

    frames: np.ndarray  # [F, D] float32 normalized frame features
    frame_video: np.ndarray  # [F] video id per frame
    video_person: np.ndarray  # [V] person id per video
    person_names: List[str]

    @property
    def num_videos(self) -> int:
        return len(self.video_person)

    def person_of_frame(self, frame_idx: np.ndarray) -> np.ndarray:
        return self.video_person[self.frame_video[frame_idx]]


def load_videos(path: str, features_count: int, l2: bool = True) -> VideoDB:
    rows: List[np.ndarray] = []
    frame_video: List[int] = []
    video_person: List[int] = []
    person_names: List[str] = []
    with open(path, "r") as fh:
        while True:
            name_line = fh.readline()
            if not name_line:
                break
            person = name_line.strip()
            if not person:
                continue
            videos_count_line = fh.readline()
            if not videos_count_line:
                break
            person_id = len(person_names)
            person_names.append(person)
            for _ in range(int(videos_count_line.split()[0])):
                frames_count = int(fh.readline().split()[0])
                video_id = len(video_person)
                video_person.append(person_id)
                for _ in range(frames_count):
                    fh.readline()  # the frame's file name
                    vec = np.asarray(fh.readline().split(), dtype=np.float32)
                    if vec.size < features_count:
                        vec = np.pad(vec, (0, features_count - vec.size))
                    rows.append(vec[:features_count])
                    frame_video.append(video_id)
    frames = normalize_features(np.stack(rows), l2=l2) if rows else np.zeros((0, features_count), np.float32)
    return VideoDB(frames=frames, frame_video=np.asarray(frame_video, np.int64),
        video_person=np.asarray(video_person, np.int64), person_names=person_names)


def write_videos(path: str, frames: np.ndarray, frame_video: np.ndarray, video_person: np.ndarray,
    person_names: List[str]) -> None:
    """Inverse of :func:`load_videos`, for fixtures and caches."""
    with open(path, "w") as fh:
        for person_id, person in enumerate(person_names):
            vids = np.flatnonzero(np.asarray(video_person) == person_id)
            fh.write(f"{person}\n{len(vids)}\n")
            for v in vids:
                fidx = np.flatnonzero(np.asarray(frame_video) == v)
                fh.write(f"{len(fidx)}\n")
                for fi in fidx:
                    fh.write(f"frame_{fi:06d}.jpg\n")
                    fh.write(" ".join(repr(float(x)) for x in frames[fi]))
                    fh.write("\n")
