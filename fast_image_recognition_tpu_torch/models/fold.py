"""Serving-function dispatch (counterpart of
``fast_image_recognition_tpu/models/fold.py`` ``make_serving_fn``,
MBConv/EfficientNet branch only)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from fast_image_recognition_tpu_torch.device import DeviceLike
from fast_image_recognition_tpu_torch.models.efficientnet import TF_MODE_MEAN, TF_MODE_STD
from fast_image_recognition_tpu_torch.models.inference import FoldedEfficientNet, make_infer_fn


def make_serving_fn(
    variables: Dict[str, Any],
    info: Dict[str, Any],
    resolution: Optional[int] = None,
    taps: Sequence[str] = (),
    device: DeviceLike = None,
) -> FoldedEfficientNet:
    """Folded bf16 serving module on ``device``: raw uint8 NHWC images ->
    ``{'embedding', 'taps'}``, through :func:`make_infer_fn` with the
    family's preprocess constants (TF_MODE_* for ``preprocess == 'tf'``).
    ``variables`` holds the numpy ``params``/``batch_stats`` trees of a
    checkpoint."""
    if info.get("family") != "efficientnet":
        raise NotImplementedError(
            f"family {info.get('family')!r} is not ported; only EfficientNet serves"
        )
    pp = info.get("preprocess", "torch")
    if pp not in ("torch", "tf"):
        raise NotImplementedError(f"preprocess {pp!r} is not ported")
    mean, std = (TF_MODE_MEAN, TF_MODE_STD) if pp == "tf" else (None, None)
    return make_infer_fn(
        variables, info["variant"], taps=taps, resolution=int(resolution or info["resolution"]),
        mean=mean, std=std, device=device,
    )
