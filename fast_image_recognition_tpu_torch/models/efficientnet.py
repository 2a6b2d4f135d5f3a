"""EfficientNet static configuration (counterpart of the static half of
``fast_image_recognition_tpu/models/efficientnet.py``: ``VARIANTS``,
``round_filters``, ``round_repeats``, ``block_plan``, ``default_taps`` and
the preprocessing constants). The trainable flax module is not ported:
the port serves folded weights only (``models/inference.py``)."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List

# torchvision-style ImageNet normalization on 0..255 inputs
# (dnn_feature_extractor.py:116-119 in the reference)
MEAN_RGB = (0.485 * 255, 0.456 * 255, 0.406 * 255)
STDDEV_RGB = (0.229 * 255, 0.224 * 255, 0.225 * 255)


@dataclasses.dataclass(frozen=True)
class Variant:
    width: float
    depth: float
    resolution: int
    dropout: float


VARIANTS: Dict[str, Variant] = {
    "b0": Variant(1.0, 1.0, 224, 0.2),
    "b1": Variant(1.0, 1.1, 240, 0.2),
    "b2": Variant(1.1, 1.2, 260, 0.3),
    "b3": Variant(1.2, 1.4, 300, 0.3),
    "b4": Variant(1.4, 1.8, 380, 0.4),
    "b5": Variant(1.6, 2.2, 456, 0.4),
    "b6": Variant(1.8, 2.6, 528, 0.5),
    "b7": Variant(2.0, 3.1, 600, 0.5),
}

# (kernel, stride, expand, in_filters, out_filters, repeats, se_ratio)
_BASE_BLOCKS = (
    (3, 1, 1, 32, 16, 1, 0.25),
    (3, 2, 6, 16, 24, 2, 0.25),
    (5, 2, 6, 24, 40, 2, 0.25),
    (3, 2, 6, 40, 80, 3, 0.25),
    (5, 1, 6, 80, 112, 3, 0.25),
    (5, 2, 6, 112, 192, 4, 0.25),
    (3, 1, 6, 192, 320, 1, 0.25),
)


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def block_plan(variant: str) -> List[Dict[str, Any]]:
    """Flat list of block configs named 'block{stage}{letter}'."""
    v = VARIANTS[variant]
    plan = []
    for stage, (k, s, e, fi, fo, r, se) in enumerate(_BASE_BLOCKS, start=1):
        fi = round_filters(fi, v.width)
        fo = round_filters(fo, v.width)
        for i in range(round_repeats(r, v.depth)):
            plan.append(
                dict(
                    name=f"block{stage}{chr(ord('a') + i)}",
                    kernel=k,
                    stride=s if i == 0 else 1,
                    expand=e,
                    in_filters=fi if i == 0 else fo,
                    out_filters=fo,
                    se_ratio=se,
                    stage=stage,
                    activation="swish",
                )
            )
    return plan


_TAP_PRESETS = {
    "deep": ((5, (0.15, 0.6)), (6, (0.1, 0.45)), (7, (0.0,))),
    "early": ((3, (0.0,)), (4, (0.0,)), (5, (0.0, 0.6)), (6, (0.45,)), (7, (0.0,))),
}


def default_taps(variant: str, preset: str = "deep") -> List[str]:
    """Exit-tap block names at fixed fractional stage depths."""
    by_stage: Dict[int, List[str]] = {}
    for b in block_plan(variant):
        by_stage.setdefault(b["stage"], []).append(b["name"])
    out: List[str] = []
    for stage, fracs in _TAP_PRESETS[preset]:
        names = by_stage[stage]
        for f in fracs:
            t = names[min(int(round(f * len(names))), len(names) - 1)]
            if t not in out:
                out.append(t)
    return out


def backbone_info(name: str) -> Dict[str, Any]:
    """Static facts the serving surface needs (``models/__init__.py``
    ``backbone_info`` of the JAX package, EfficientNet family only)."""
    if name not in VARIANTS:
        raise NotImplementedError(f"backbone {name!r} is not ported yet")
    v = VARIANTS[name]
    return dict(
        family="efficientnet",
        variant=name,
        resolution=v.resolution,
        embedding_dim=round_filters(1280, v.width),
        taps=default_taps(name),
        preprocess="torch",
    )
