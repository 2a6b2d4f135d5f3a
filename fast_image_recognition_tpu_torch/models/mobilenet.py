"""MobileNetV2 and V1 (JAX ``models/mobilenet.py``): plans, taps and modules in
``efficientnet.py``'s idiom (V2 is its ``MBConv``, relu6, no SE); flax numpy
trees in and out."""

import functools
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from ..device import DeviceLike
from .efficientnet import EfficientNet, _act, _BatchNorm, _Conv, _conv_bn, _pool, create, round_filters

# (expand t, out channels c, repeats n, first stride s)
_MBV2_BLOCKS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
        (6, 320, 1, 1))
# (out channels, stride) of each depthwise-separable layer
_MBV1_LAYERS = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2), (512, 1), (512, 1), (512, 1), (512, 1),
        (512, 1), (1024, 2), (1024, 1))
_relu6 = _act("relu6")


def _make_divisible(v: float, divisor: int = 8) -> int:
    return round_filters(v, 1.0, divisor)


def parse_mobilenet_width(name: str) -> float:
    """'mobilenetv2' 1.0, 'mobilenetv2_1.4' and 'mobilenetv2_140' 1.4 (JAX ``models/__init__.py:27-34``)."""
    if "_" not in name:
        return 1.0
    width = float(name.split("_", 1)[1])
    return width / 100.0 if width > 10 else width


def mobilenet_plan(width: float = 1.0) -> List[Dict[str, Any]]:
    plan, fi = [], _make_divisible(32 * width)
    for stage, (t, c, n, s) in enumerate(_MBV2_BLOCKS, start=1):
        fo = _make_divisible(c * width)
        for i in range(n):
            plan.append(dict(name=f"block{stage}{chr(ord('a') + i)}", kernel=3, stride=s if i == 0 else 1, expand=t,
                    in_filters=fi if i == 0 else fo, out_filters=fo, se_ratio=0.0, stage=stage, activation="relu6"))
        fi = fo
    return plan


def default_taps_mobilenet(width: float = 1.0) -> List[str]:
    """The last block of stages 3-6."""
    by_stage = {b["stage"]: b["name"] for b in mobilenet_plan(width)}
    return [by_stage[s] for s in (3, 4, 5, 6)]


def mobilenet_v1_plan(width: float = 1.0) -> List[Dict[str, Any]]:
    plan, fi = [], _make_divisible(32 * width)
    for i, (c, s) in enumerate(_MBV1_LAYERS, start=1):
        fo = _make_divisible(c * width)
        plan.append(dict(name=f"conv_dw_{i}", stride=s, in_filters=fi, out_filters=fo, stage=i))
        fi = fo
    return plan


def default_taps_mobilenet_v1(width: float = 1.0) -> List[str]:
    return ["conv_dw_5", "conv_dw_11"]


class MobileNetV2(EfficientNet):
    """MobileNetV2 with segments and exit taps; ``num_classes=0``: the pooled extractor."""

    def __init__(self, width: float = 1.0, num_classes: int = 0, dtype: torch.dtype = torch.bfloat16,
            hidden_overrides: Optional[Dict[str, int]] = None, resolution: int = 224):
        nn.Module.__init__(self)
        self.width, self.resolution, self.drop_connect, self.drop_rate = float(width), int(resolution), 0.0, 0.2
        self._build(mobilenet_plan(width), _make_divisible(32 * width), _make_divisible(1280 * max(width, 1.0)),
                num_classes, dtype, hidden_overrides)


class DepthwiseSeparable(nn.Module):
    """Depthwise 3x3 + BN + relu6, pointwise 1x1 + BN + relu6 (``folded``: each BN a bias of its conv)."""

    def __init__(self, cfg: Dict[str, Any], hidden_filters: Optional[int] = None, folded: bool = False):
        super().__init__()
        fi, fo = cfg["in_filters"], cfg["out_filters"]
        self.dw_conv = _Conv(fi, fi, 3, cfg["stride"], groups=fi, bias=folded)
        self.pw_conv = _Conv(fi, fo, 1, bias=folded)
        self.dw_bn, self.pw_bn = (None, None) if folded else (_BatchNorm(fi), _BatchNorm(fo))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _relu6(_conv_bn(self.pw_conv, self.pw_bn, _relu6(_conv_bn(self.dw_conv, self.dw_bn, x))))


class MobileNetV1(EfficientNet):
    """MobileNetV1; ``folded=True`` takes a folded tree, each BN's bias on its conv."""

    def __init__(self, width: float = 1.0, num_classes: int = 0, dtype: torch.dtype = torch.bfloat16,
            resolution: int = 224, folded: bool = False):
        nn.Module.__init__(self)
        self.width, self.resolution = float(width), int(resolution)
        self._build(mobilenet_v1_plan(width), _make_divisible(32 * width), None, num_classes, dtype,
                block=functools.partial(DepthwiseSeparable, folded=folded), activation="relu6", folded=folded)

    def head_pool(self, x: torch.Tensor) -> torch.Tensor:
        return _pool(x)


def create_mobilenetv2(width: float = 1.0, num_classes: int = 0, seed: int = 0, resolution: int = 224,
        dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None):
    """``(model on device, its flax-layout numpy variables)``, flax's init from ``seed``."""
    return create(MobileNetV2(width, num_classes, dtype), seed, resolution, device)


def create_mobilenet_v1(width: float = 1.0, num_classes: int = 0, seed: int = 0, resolution: int = 224,
        dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None):
    return create(MobileNetV1(width, num_classes, dtype), seed, resolution, device)
