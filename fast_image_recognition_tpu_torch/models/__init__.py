"""The port's backbone zoo (JAX ``models/__init__.py``); other names raise
``ValueError``."""

from typing import Any, Dict, Optional

import torch

from ..device import DeviceLike
from . import efficientnet as _eff
from .efficientnet import VARIANTS, EfficientNet, create_efficientnet, default_taps  # noqa: F401
from .inception_resnet import (INCEPTION_RESNET_EMBED_DIM, InceptionResNetV2, create_inception_resnet_v2,  # noqa: F401
    default_taps_inception_resnet)
from .inception_v3 import (INCEPTION_V3_EMBED_DIM, InceptionV3, create_inception_v3,  # noqa: F401
    default_taps_inception_v3)
from .mobilenet import (MobileNetV1, MobileNetV2, _make_divisible, create_mobilenet_v1,  # noqa: F401
    create_mobilenetv2, default_taps_mobilenet, default_taps_mobilenet_v1, mobilenet_plan, parse_mobilenet_width)
from .pruning import (METRICS, apoz_hidden_scores, class_sep_hidden_scores, l1_kernel_importance,  # noqa: F401
    leave_one_out_importance, parameter_count, prune_backbone, prune_efficientnet, round_down_multiple,
    taylor_importance)
from .resnet import RESNET_EMBED_DIM, ResNet, create_resnet, default_taps_resnet, resnet_plan  # noqa: F401
from .vgg import VGG19, VGG19_EMBED_DIM, create_vgg19, default_taps_vgg  # noqa: F401

_IRV2 = "inception_resnet_v2"
RESNETS = ("resnet50", "resnet50v2", "resnet101v2", "resnet152v2")


def _unknown(name: str):
    raise ValueError(f"unknown backbone {name!r}")


def backbone_info(name: str) -> Dict[str, Any]:
    """Resolution, embedding dim, default taps, family and preprocess of a zoo member."""
    if name in VARIANTS:
        return _eff.backbone_info(name)
    if name.startswith("mobilenetv2"):
        width = parse_mobilenet_width(name)
        return dict(family="mobilenetv2", variant=name, resolution=224, embedding_dim=_make_divisible(1280 * max(width,
                1.0)), taps=default_taps_mobilenet(width), preprocess="tf")
    facts = {"mobilenetv1": ("mobilenetv1", 224, 1024, default_taps_mobilenet_v1, "tf"),
            _IRV2: (_IRV2, 299, INCEPTION_RESNET_EMBED_DIM, default_taps_inception_resnet, "tf"),
            "inception_v3": ("inception_v3", 299, INCEPTION_V3_EMBED_DIM, default_taps_inception_v3, "tf"),
            "vgg19": ("vgg", 224, VGG19_EMBED_DIM, default_taps_vgg, "caffe")}
    # keras resnet_v2.preprocess_input is 'tf' mode, v1's 'caffe'
    facts.update({r: ("resnet", 224, RESNET_EMBED_DIM, lambda r=r: default_taps_resnet(r),
            "tf" if r.endswith("v2") else "caffe") for r in RESNETS})
    if name not in facts:
        _unknown(name)
    family, res, dim, taps, pp = facts[name]
    return dict(family=family, variant=name, resolution=res, embedding_dim=dim, taps=taps(), preprocess=pp)


def build_backbone(name: str, num_classes: int = 0, dtype: torch.dtype = torch.bfloat16):
    """Module for a zoo name, weights not drawn (JAX :126-159)."""
    if name in VARIANTS:
        return EfficientNet(variant=name, num_classes=num_classes, dtype=dtype)
    if name.startswith("mobilenetv2"):
        return MobileNetV2(parse_mobilenet_width(name), num_classes, dtype)
    if name.startswith("mobilenetv1"):  # any suffix, as JAX's (backbone_info takes 'mobilenetv1' only)
        return MobileNetV1(num_classes=num_classes, dtype=dtype)
    if name in RESNETS:
        return ResNet(name, num_classes, dtype)
    cls = {_IRV2: InceptionResNetV2, "inception_v3": InceptionV3, "vgg19": VGG19}.get(name) or _unknown(name)
    return cls(num_classes=num_classes, dtype=dtype)


def create_backbone(name: str, num_classes: int = 0, seed: int = 0, resolution: Optional[int] = None,
        device: DeviceLike = None, dtype: torch.dtype = torch.bfloat16):
    """``(module on device, flax-layout numpy variables)``, flax's init from ``seed`` (JAX :162-216)."""
    if name in VARIANTS:
        return create_efficientnet(name, num_classes, seed, resolution, dtype, device)
    if name.startswith("mobilenetv2"):
        return create_mobilenetv2(parse_mobilenet_width(name), num_classes, seed, resolution or 224, dtype, device)
    if name.startswith("mobilenetv1"):
        return create_mobilenet_v1(1.0, num_classes, seed, resolution or 224, dtype, device)
    if name in RESNETS:
        return create_resnet(name, num_classes, seed, resolution or 224, dtype, device)
    make = {_IRV2: (create_inception_resnet_v2, 299), "inception_v3": (create_inception_v3, 299),
            "vgg19": (create_vgg19, 224)}.get(name) or _unknown(name)
    return make[0](num_classes, seed, resolution or make[1], dtype, device)


def default_taps_for(name: str):
    return backbone_info(name)["taps"]
