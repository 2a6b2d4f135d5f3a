"""InceptionV3, 2048-d (JAX ``models/inception_v3.py``): branch tables over
``models/zoo.py``'s ``_Block`` (a pool branch's conv is ``bp``)."""

from typing import Any, Dict, List

import torch
from torch import nn

from ..device import DeviceLike
from .zoo import _V, ZooNet, _Block, _pool, branch_layers, create, run_stem, stem_convs

INCEPTION_V3_EMBED_DIM = 2048


def inception_v3_plan() -> List[Dict[str, Any]]:
    plan = [dict(name=f"mixed{i}", kind="mixed35", pool_filters=32 if i == 0 else 64, stage=1) for i in range(3)]
    plan += [dict(name="mixed3", kind="mixed3", stage=2)]
    inner = {4: 128, 5: 160, 6: 160, 7: 192}
    plan += [dict(name=f"mixed{i}", kind="mixed17", inner=inner[i], stage=3) for i in range(4, 8)]
    plan += [dict(name="mixed8", kind="mixed8", stage=4)]
    plan += [dict(name=f"mixed{i}", kind="mixed8x8", stage=5) for i in (9, 10)]
    return plan


def default_taps_inception_v3() -> List[str]:
    return ["mixed4", "mixed7", "mixed9"]


def _spec(cfg):
    """(in channels, branches, None) of a block, in ``_KINDS``'s notation."""
    kind, name = cfg["kind"], cfg["name"]
    if kind == "mixed35":
        cin = {"mixed0": 192, "mixed1": 256, "mixed2": 288}[name]
        return cin, [[(64, 1)], [(48, 1), (64, 5)], [(64, 1), (96, 3), (96, 3)], ["avg", (cfg["pool_filters"], 1)]], None
    if kind == "mixed3":
        return 288, [[(384, 3, 2, _V)], [(64, 1), (96, 3), (96, 3, 2, _V)], ["max"]], None
    if kind == "mixed17":
        c = cfg["inner"]
        return 768, [[(192, 1)], [(c, 1), (c, (1, 7)), (192, (7, 1))],
                [(c, 1), (c, (7, 1)), (c, (1, 7)), (c, (7, 1)), (192, (1, 7))], ["avg", (192, 1)]], None
    if kind == "mixed8":
        return 768, [[(192, 1), (320, 3, 2, _V)], [(192, 1), (192, (1, 7)), (192, (7, 1)), (192, 3, 2, _V)],
                ["max"]], None
    split = [(384, (1, 3)), (384, (3, 1))]
    return 1280 if name == "mixed9" else 2048, [[(320, 1)], [(384, 1), split], [(448, 1), (384, 3), split],
            ["avg", (192, 1)]], None


class InceptionV3(ZooNet):
    """``num_classes=0``: the pooled 2048-d extractor (no head conv)."""

    drop_rate = 0.2

    def __init__(self, num_classes: int = 0, dtype: torch.dtype = torch.bfloat16, folded: bool = False):
        super().__init__()
        self.num_classes, self.dtype, self.plan = int(num_classes), dtype, inception_v3_plan()
        self.stem_mod = stem_convs(not folded)
        self.blocks = nn.ModuleList(_Block(_spec(b), not folded, dtype, pool_name="bp") for b in self.plan)
        self.fc = nn.Linear(INCEPTION_V3_EMBED_DIM, self.num_classes) if self.num_classes else None

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        return run_stem(self.stem_mod, self._to_nchw(x))

    def head_pool(self, x: torch.Tensor) -> torch.Tensor:
        return _pool(x)

    def _layers(self):
        return branch_layers(self.stem_mod, self.plan, self.blocks)


def create_inception_v3(num_classes: int = 0, seed: int = 0, resolution: int = 299,
        dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None):
    """The stem's VALID reductions need ``resolution`` >= 75."""
    return create(InceptionV3(num_classes, dtype), seed, resolution, device)
