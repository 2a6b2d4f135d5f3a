"""Serving-function dispatch (counterpart of
``fast_image_recognition_tpu/models/fold.py`` ``make_serving_fn``,
MBConv/EfficientNet branch only)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from fast_image_recognition_tpu_torch.device import DeviceLike, resolve_device
from fast_image_recognition_tpu_torch.models.inference import (
    FoldedEfficientNet,
    fold_backbone,
    fold_preprocess_into_stem,
)


def make_serving_fn(
    variables: Dict[str, Any],
    info: Dict[str, Any],
    resolution: Optional[int] = None,
    taps: Sequence[str] = (),
    device: DeviceLike = None,
) -> FoldedEfficientNet:
    """Folded bf16 serving module on ``device``: raw uint8 NHWC images ->
    ``{'embedding', 'taps'}``. ``variables`` holds the numpy
    ``params``/``batch_stats`` trees of a checkpoint."""
    if info.get("family") != "efficientnet":
        raise NotImplementedError(
            f"family {info.get('family')!r} is not ported; only EfficientNet serves"
        )
    if info.get("preprocess", "torch") != "torch":
        raise NotImplementedError("only the MEAN_RGB/STDDEV_RGB preprocess is ported")
    dev = resolve_device(device)
    res = int(resolution or info["resolution"])
    folded, configs = fold_backbone(variables, info["variant"])
    folded = fold_preprocess_into_stem(folded, res)
    module = FoldedEfficientNet(folded, configs, res, taps=taps)
    return module.to(dev).eval()
