"""VGG19, 512-d (JAX ``models/vgg.py``): each conv (bias, ReLU) a block, a 2x2 max
pool after each stage's last conv (in ``run_blocks``; a tap reads before it);
``params`` only."""

from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike
from .zoo import ConvBN, ZooNet, _pool, create

VGG19_EMBED_DIM = 512
_STAGES = ((1, 2, 64), (2, 2, 128), (3, 4, 256), (4, 4, 512), (5, 4, 512))  # (stage, convs, filters)


def vgg_plan() -> List[Dict[str, Any]]:
    return [dict(name=f"block{stage}_conv{i}", filters=f, stage=stage, pool_after=i == convs)
            for stage, convs, f in _STAGES for i in range(1, convs + 1)]


def default_taps_vgg() -> List[str]:
    return ["block3_conv4", "block4_conv4"]


class VGG19(ZooNet):
    """``num_classes=0``: the pooled 512-d extractor."""

    def __init__(self, num_classes: int = 0, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes, self.dtype, self.plan = int(num_classes), dtype, vgg_plan()
        cins = [3] + [cfg["filters"] for cfg in self.plan[:-1]]
        self.blocks = nn.ModuleList(ConvBN(c, cfg["filters"], 3, bn=False) for c, cfg in zip(cins, self.plan))
        self.fc = nn.Linear(VGG19_EMBED_DIM, self.num_classes) if self.num_classes else None

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        return self._to_nchw(x)

    def _after(self, i: int, h: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(h, 2, 2) if self.plan[i]["pool_after"] else h

    def head_pool(self, x: torch.Tensor) -> torch.Tensor:
        return _pool(x)

    def _layers(self):
        for cfg, conv in zip(self.plan, self.blocks):
            yield (cfg["name"],), None, conv


def create_vgg19(num_classes: int = 0, seed: int = 0, resolution: int = 224, dtype: torch.dtype = torch.bfloat16,
        device: DeviceLike = None):
    return create(VGG19(num_classes, dtype), seed, resolution, device)
