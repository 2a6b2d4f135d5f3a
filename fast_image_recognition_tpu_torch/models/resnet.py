"""ResNet50 (v1) and ResNet50/101/152V2 (JAX ``models/resnet.py``): v1 biased
conv-BN-ReLU bottlenecks, stride on stages 3-5's first block; v2
pre-activation, stride on stages 2-4's last. BN eps 1.001e-5."""

from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike
from .zoo import ConvBN, ZooNet, _BatchNorm, _pool, create

RESNET_EMBED_DIM = 2048
RESNET_EPS = 1.001e-5
_DEPTHS = {"resnet50": (3, 4, 6, 3), "resnet50v2": (3, 4, 6, 3), "resnet101v2": (3, 4, 23, 3),
        "resnet152v2": (3, 8, 36, 3)}
_FILTERS = (64, 128, 256, 512)  # bottleneck width per stage (out = 4x)


def resnet_plan(variant: str) -> List[Dict[str, Any]]:
    v2, plan = variant.endswith("v2"), []
    for s, (blocks, f) in enumerate(zip(_DEPTHS[variant], _FILTERS), start=2):
        for i in range(1, blocks + 1):
            stride = 2 if ((i == blocks and s != 5) if v2 else (i == 1 and s != 2)) else 1
            plan.append(dict(name=f"conv{s}_block{i}", filters=f, stride=stride, conv_shortcut=i == 1, stage=s))
    return plan


def default_taps_resnet(variant: str) -> List[str]:
    """The reference's ResNet152V2 taps (sequential_inference.py:385); else stage 4's first, middle and last."""
    if variant == "resnet152v2":
        return ["conv4_block1", "conv4_block18", "conv4_block36"]
    n4 = _DEPTHS[variant][2]
    return [f"conv4_block{i}" for i in dict.fromkeys((1, max(1, n4 // 2), n4))]


class Bottleneck(nn.Module):
    """keras block1 (v1) or block2 (v2; a strided identity shortcut is a subsample). ``folded``: each BN in its conv's
    bias, v2's ``preact_bn`` kept."""

    def __init__(self, cin: int, cfg: Dict[str, Any], v2: bool, folded: bool):
        super().__init__()
        f, s, bn, e = cfg["filters"], cfg["stride"], not folded, RESNET_EPS
        self.v2, self.stride = v2, s
        self.preact_bn = _BatchNorm(cin, e) if v2 else None
        self.shortcut = ConvBN(cin, 4 * f, 1, s, relu=False, bn=bn and not v2, bias=True, eps=e) \
            if cfg["conv_shortcut"] else None
        bias = folded or not v2  # v2's conv1 and conv2 have no bias of their own
        self.conv1 = ConvBN(cin, f, 1, 1 if v2 else s, bn=bn, bias=bias, eps=e)
        self.conv2 = ConvBN(f, f, 3, s if v2 else 1, bn=bn, bias=bias, eps=e)
        self.conv3 = ConvBN(f, 4 * f, 1, relu=False, bn=bn and not v2, bias=True, eps=e)

    def forward(self, x):
        if not self.v2:
            sc = x if self.shortcut is None else self.shortcut(x)
            return F.relu(sc + self.conv3(self.conv2(self.conv1(x))))
        pre = F.relu(self.preact_bn(x))
        sc = self.shortcut(pre) if self.shortcut is not None else x[:, :, ::self.stride, ::self.stride]
        return sc + self.conv3(self.conv2(self.conv1(pre)))


class ResNet(ZooNet):
    """``num_classes=0``: the pooled 2048-d extractor; ``folded=True`` takes a folded tree."""

    def __init__(self, variant: str = "resnet152v2", num_classes: int = 0, dtype: torch.dtype = torch.bfloat16,
            folded: bool = False):
        super().__init__()
        self.variant, self.num_classes, self.dtype = variant, int(num_classes), dtype
        self.v2, self.plan = variant.endswith("v2"), resnet_plan(variant)
        self.stem_conv = ConvBN(3, 64, 7, 2, relu=not self.v2, bn=not (folded or self.v2), bias=True, eps=RESNET_EPS)
        blocks, c = [], 64
        for cfg in self.plan:
            blocks.append(Bottleneck(c, cfg, self.v2, folded))
            c = 4 * cfg["filters"]
        self.blocks = nn.ModuleList(blocks)
        self.post_bn = _BatchNorm(c, RESNET_EPS) if self.v2 else None
        self.fc = nn.Linear(RESNET_EMBED_DIM, self.num_classes) if self.num_classes else None

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(self.stem_conv(self._to_nchw(x)), 3, 2, 1)

    def head_pool(self, x: torch.Tensor) -> torch.Tensor:
        return _pool(F.relu(self.post_bn(x)) if self.v2 else x)

    def _layers(self):
        yield ("conv1_conv",), None if self.v2 else ("conv1_bn",), self.stem_conv
        for cfg, blk in zip(self.plan, self.blocks):
            n = cfg["name"]
            if self.v2:
                yield None, (n, "preact_bn"), blk.preact_bn
            if blk.shortcut is not None:
                yield (n, "shortcut_conv"), None if self.v2 else (n, "shortcut_bn"), blk.shortcut
            for k in (1, 2, 3):
                yield (n, f"conv{k}"), None if (self.v2 and k == 3) else (n, f"bn{k}"), getattr(blk, f"conv{k}")
        if self.v2:
            yield None, ("post_bn",), self.post_bn


def create_resnet(variant: str = "resnet152v2", num_classes: int = 0, seed: int = 0, resolution: int = 224,
        dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None):
    return create(ResNet(variant, num_classes, dtype), seed, resolution, device)
