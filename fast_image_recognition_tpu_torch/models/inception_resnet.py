"""InceptionResNetV2, the 1536-d gallery producer (JAX
``models/inception_resnet.py``) on ``models/zoo.py``'s blocks; ``folded=True``:
each conv carries its folded BN as a bias."""

from typing import Any, Dict, List

import torch
from torch import nn

from ..device import DeviceLike
from .zoo import _V, ConvBN, ZooNet, _Block, _pool, branch_layers, create, run_stem, stem_convs

INCEPTION_RESNET_EMBED_DIM = 1536

# kind -> (in channels, branches, residual scale or None), in _Block's notation
_KINDS = {
    "mixed5b": (192, [[(96, 1)], [(48, 1), (64, 5)], [(64, 1), (96, 3), (96, 3)], ["avg", (64, 1)]], None),
    "block35": (320, [[(32, 1)], [(32, 1), (32, 3)], [(32, 1), (48, 3), (64, 3)]], 0.17),
    "mixed6a": (320, [[(384, 3, 2, _V)], [(256, 1), (256, 3), (384, 3, 2, _V)], ["max"]], None),
    "block17": (1088, [[(192, 1)], [(128, 1), (160, (1, 7)), (192, (7, 1))]], 0.10),
    "mixed7a": (1088, [[(256, 1), (384, 3, 2, _V)], [(256, 1), (288, 3, 2, _V)],
        [(256, 1), (288, 3), (320, 3, 2, _V)], ["max"]], None),
    "block8": (2080, [[(192, 1)], [(192, 1), (224, (1, 3)), (256, (3, 1))]], 0.20),
}


def inception_resnet_plan() -> List[Dict[str, Any]]:
    plan = [dict(name="mixed5b", kind="mixed5b", stage=1)]
    plan += [dict(name=f"block35_{i + 1}", kind="block35", stage=2) for i in range(10)]
    plan += [dict(name="mixed6a", kind="mixed6a", stage=3)]
    plan += [dict(name=f"block17_{i + 1}", kind="block17", stage=4) for i in range(20)]
    plan += [dict(name="mixed7a", kind="mixed7a", stage=5)]
    plan += [dict(name=f"block8_{i + 1}", kind="block8", stage=6) for i in range(10)]
    return plan


def default_taps_inception_resnet() -> List[str]:
    return ["block17_10", "block17_20", "block8_5"]


class InceptionResNetV2(ZooNet):
    """``num_classes=0``: the pooled 1536-d extractor; ``head_conv`` is ``conv_7b``."""

    drop_rate = 0.2

    def __init__(self, num_classes: int = 0, dtype: torch.dtype = torch.bfloat16, folded: bool = False):
        super().__init__()
        self.num_classes, self.dtype, self.plan = int(num_classes), dtype, inception_resnet_plan()
        self.stem_mod = stem_convs(not folded)
        self.blocks = nn.ModuleList(_Block(_KINDS[b["kind"]], not folded, dtype, b["name"] == "block8_10")
                for b in self.plan)
        self.head_conv = ConvBN(2080, INCEPTION_RESNET_EMBED_DIM, bn=not folded)
        self.fc = nn.Linear(INCEPTION_RESNET_EMBED_DIM, self.num_classes) if self.num_classes else None

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        return run_stem(self.stem_mod, self._to_nchw(x))

    def head_pool(self, x: torch.Tensor) -> torch.Tensor:
        return _pool(self.head_conv(x))

    def _layers(self):
        return branch_layers(self.stem_mod, self.plan, self.blocks, [(("conv_7b",), self.head_conv)])


def create_inception_resnet_v2(num_classes: int = 0, seed: int = 0, resolution: int = 299,
        dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None):
    """VALID stem reductions need ``resolution`` >= 75 (kept as ``model.resolution``)."""
    return create(InceptionResNetV2(num_classes, dtype), seed, resolution, device)
