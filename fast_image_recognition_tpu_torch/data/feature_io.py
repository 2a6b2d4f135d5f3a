"""Text feature files (JAX ``data/feature_io.py``; qt_cpp
db_features.cpp:44-116): 3-line records, the reference's load-time
filters, zeroing and normalization. NumPy engine only."""

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

ZERO_EPS = 1e-4  # db_features.cpp:85-87


@dataclasses.dataclass
class FeatureDB:
    """Flat gallery arrays, labels in first-seen class order."""

    features: np.ndarray
    labels: np.ndarray
    class_names: List[str]
    file_names: List[str]

    @property
    def num_images(self) -> int:
        return int(self.features.shape[0])

    @property
    def num_features(self) -> int:
        return int(self.features.shape[1])

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    def class_counts(self) -> np.ndarray:
        return np.bincount(self.labels, minlength=self.num_classes)

    def drop_singleton_classes(self) -> "FeatureDB":
        """Classes with more than one image (ann.cpp:34-36), relabelled densely."""
        counts = self.class_counts()
        keep_classes = np.flatnonzero(counts > 1)
        remap = -np.ones(self.num_classes, dtype=np.int64)
        remap[keep_classes] = np.arange(len(keep_classes))
        mask = remap[self.labels] >= 0
        return FeatureDB(features=self.features[mask], labels=remap[self.labels[mask]].astype(np.int32),
            class_names=[self.class_names[c] for c in keep_classes],
            file_names=[f for f, m in zip(self.file_names, mask) if m])


def normalize_features(raw: np.ndarray, l2: bool = True, zero_eps: float = ZERO_EPS) -> np.ndarray:
    """Zero tiny entries, then each row over its L2 norm (``l2``) or its sum (db_features.cpp:80-101)."""
    feats = np.array(raw, dtype=np.float32)  # a copy, divided in place below
    feats[np.abs(feats) < zero_eps] = 0.0
    wide = feats.astype(np.float64)
    if l2:
        np.square(wide, out=wide)
        denom = np.sqrt(np.sum(wide, axis=1))
    else:
        denom = np.sum(wide, axis=1)
    del wide
    # The reference divides unconditionally; guard only against exact zero
    # rows to avoid NaN poisoning whole arrays.
    denom = np.where(denom == 0.0, 1.0, denom)
    feats /= denom[:, None].astype(np.float32)
    return feats


def load_feature_file(path: str, features_count: int, skip_class_substrings: Sequence[str] = (),
    max_classes: Optional[int] = None, l2_normalize: bool = True, engine: str = "auto") -> FeatureDB:
    """Parse the 3-line format in NumPy; ``engine='native'`` raises until ``runtime/native.py`` is ported."""
    if engine == "native":
        raise NotImplementedError("engine='native' needs the port of runtime/native.py (with runtime/ingest.cpp), "
                "not there yet; use engine='auto' or 'python'")
    file_names: List[str] = []
    class_names: List[str] = []
    class_index = {}
    labels: List[int] = []
    rows: List[np.ndarray] = []

    with open(path, "r") as fh:
        while True:
            file_name = fh.readline()
            if not file_name:
                break
            class_name = fh.readline()
            if not class_name:
                break
            feat_line = fh.readline()
            if not feat_line:
                break
            class_name = class_name.lstrip().rstrip("\r\n")
            if any(s in class_name for s in skip_class_substrings):
                continue
            if class_name not in class_index:
                if max_classes is not None and len(class_index) >= max_classes:
                    break  # CASIA identity cap (db_features.cpp:66-70)
                class_index[class_name] = len(class_index)
                class_names.append(class_name)
            vec = np.asarray(feat_line.split(), dtype=np.float32)
            if vec.size < features_count:
                vec = np.pad(vec, (0, features_count - vec.size))
            rows.append(vec[:features_count])
            labels.append(class_index[class_name])
            file_names.append(file_name.strip())

    if rows:
        features = normalize_features(np.stack(rows), l2=l2_normalize)
    else:
        features = np.zeros((0, features_count), dtype=np.float32)
    return FeatureDB(features=features, labels=np.asarray(labels, dtype=np.int32), class_names=class_names,
        file_names=file_names)


def write_feature_file(path: str, features: np.ndarray, labels: np.ndarray, class_names: Sequence[str],
    file_names: Optional[Sequence[str]] = None) -> None:
    """Write the 3-line record format (qt_cpp/dnn_feature_extractor.py:58-64)."""
    features = np.asarray(features)
    with open(path, "w") as fh:
        for i in range(features.shape[0]):
            name = file_names[i] if file_names is not None else f"img_{i:06d}.jpg"
            fh.write(f"{name}\n")
            fh.write(f"{class_names[int(labels[i])]}\n")
            fh.write(" ".join(repr(float(v)) for v in features[i]))
            fh.write("\n")
