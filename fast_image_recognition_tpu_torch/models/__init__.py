"""Backbones of the port (EfficientNet B0-B7 so far)."""

from fast_image_recognition_tpu_torch.models.efficientnet import (  # noqa: F401
    EfficientNet,
    backbone_info,
    create_efficientnet,
    default_taps,
)
