"""The port's backbone zoo (JAX ``models/__init__.py``): EfficientNet
B0-B7, MobileNetV2 at any width, MobileNetV1 and InceptionResNetV2; the
other zoo names raise."""

from typing import Any, Dict, Optional

import torch

from fast_image_recognition_tpu_torch.device import DeviceLike
from fast_image_recognition_tpu_torch.models import efficientnet as _eff
from fast_image_recognition_tpu_torch.models.efficientnet import (  # noqa: F401
    VARIANTS,
    EfficientNet,
    create_efficientnet,
    default_taps,
)
from fast_image_recognition_tpu_torch.models.inception_resnet import (  # noqa: F401
    INCEPTION_RESNET_EMBED_DIM,
    InceptionResNetV2,
    create_inception_resnet_v2,
    default_taps_inception_resnet,
)
from fast_image_recognition_tpu_torch.models.mobilenet import (  # noqa: F401
    MobileNetV1,
    MobileNetV2,
    _make_divisible,
    create_mobilenet_v1,
    create_mobilenetv2,
    default_taps_mobilenet,
    default_taps_mobilenet_v1,
    mobilenet_plan,
    parse_mobilenet_width,
)

_IRV2 = "inception_resnet_v2"


def _not_ported(name: str) -> None:
    """JAX's other zoo members raise ``NotImplementedError``, unknown names
    ``ValueError`` (JAX :123)."""
    if name in ("inception_v3", "resnet50", "resnet50v2", "resnet101v2", "resnet152v2", "vgg19"):
        raise NotImplementedError(f"backbone {name!r} is not ported yet: ROADMAP.md §1 queue 2")
    raise ValueError(f"unknown backbone {name!r}")


def backbone_info(name: str) -> Dict[str, Any]:
    """Static facts about a zoo member (JAX :37-123): resolution,
    embedding dim, default taps, family and preprocess."""
    if name in VARIANTS:
        return _eff.backbone_info(name)
    if name.startswith("mobilenetv2"):
        width = parse_mobilenet_width(name)
        return dict(family="mobilenetv2", variant=name, resolution=224,
                    embedding_dim=_make_divisible(1280 * max(width, 1.0)), taps=default_taps_mobilenet(width),
                    preprocess="tf")
    if name == "mobilenetv1":
        return dict(family="mobilenetv1", variant=name, resolution=224, embedding_dim=1024,
                    taps=default_taps_mobilenet_v1(), preprocess="tf")
    if name == _IRV2:
        return dict(family=_IRV2, variant=_IRV2, resolution=299, embedding_dim=INCEPTION_RESNET_EMBED_DIM,
                    taps=default_taps_inception_resnet(), preprocess="tf")
    _not_ported(name)


def build_backbone(name: str, num_classes: int = 0, dtype: torch.dtype = torch.bfloat16):
    """Module for a zoo name, weights not drawn (JAX :126-159)."""
    if name in VARIANTS:
        return EfficientNet(variant=name, num_classes=num_classes, dtype=dtype)
    if name.startswith("mobilenetv2"):
        return MobileNetV2(parse_mobilenet_width(name), num_classes, dtype)
    if name.startswith("mobilenetv1"):  # any suffix, as JAX's (backbone_info takes 'mobilenetv1' only)
        return MobileNetV1(num_classes=num_classes, dtype=dtype)
    if name == _IRV2:
        return InceptionResNetV2(num_classes=num_classes, dtype=dtype)
    _not_ported(name)


def create_backbone(name: str, num_classes: int = 0, seed: int = 0, resolution: Optional[int] = None,
                    device: DeviceLike = None, dtype: torch.dtype = torch.bfloat16):
    """``(module on device, flax-layout numpy variables)`` with flax's
    default init drawn from ``seed`` (JAX :162-216)."""
    if name in VARIANTS:
        return create_efficientnet(name, num_classes, seed, resolution, dtype, device)
    if name.startswith("mobilenetv2"):
        return create_mobilenetv2(parse_mobilenet_width(name), num_classes, seed, resolution or 224, dtype, device)
    if name.startswith("mobilenetv1"):
        return create_mobilenet_v1(1.0, num_classes, seed, resolution or 224, dtype, device)
    if name == _IRV2:
        return create_inception_resnet_v2(num_classes, seed, resolution or 299, dtype, device)
    _not_ported(name)


def default_taps_for(name: str):
    return backbone_info(name)["taps"]
