"""EfficientNet B0-B7 (JAX ``models/efficientnet.py``): the plan and the trainable
module (bf16 convs, TF 'SAME' pads, BN in fp32); flax numpy trees in and out."""

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike
from .zoo import ZooNet, _BatchNorm, _pool, batch_stats, create, keep_mask

# torchvision's normalization on 0..255 (dnn_feature_extractor.py:116-119)
MEAN_RGB = (0.485 * 255, 0.456 * 255, 0.406 * 255)
STDDEV_RGB = (0.229 * 255, 0.224 * 255, 0.225 * 255)
# Keras 'tf' mode (x/127.5 - 1): MobileNets, Inceptions, ResNetV2
TF_MODE_MEAN = (127.5, 127.5, 127.5)
TF_MODE_STD = (127.5, 127.5, 127.5)


@dataclasses.dataclass(frozen=True)
class Variant:
    width: float
    depth: float
    resolution: int
    dropout: float


VARIANTS: Dict[str, Variant] = {"b0": Variant(1.0, 1.0, 224, 0.2), "b1": Variant(1.0, 1.1, 240, 0.2),
    "b2": Variant(1.1, 1.2, 260, 0.3), "b3": Variant(1.2, 1.4, 300, 0.3), "b4": Variant(1.4, 1.8, 380, 0.4),
    "b5": Variant(1.6, 2.2, 456, 0.4), "b6": Variant(1.8, 2.6, 528, 0.5), "b7": Variant(2.0, 3.1, 600, 0.5)}

# (kernel, stride, expand, in_filters, out_filters, repeats, se_ratio)
_BASE_BLOCKS = ((3, 1, 1, 32, 16, 1, 0.25), (3, 2, 6, 16, 24, 2, 0.25), (5, 2, 6, 24, 40, 2, 0.25),
    (3, 2, 6, 40, 80, 3, 0.25), (5, 1, 6, 80, 112, 3, 0.25), (5, 2, 6, 112, 192, 4, 0.25), (3, 1, 6, 192, 320, 1, 0.25))


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def block_plan(variant: str) -> List[Dict[str, Any]]:
    """Flat list of block configs named 'block{stage}{letter}'."""
    v = VARIANTS[variant]
    plan = []
    for stage, (k, s, e, fi, fo, r, se) in enumerate(_BASE_BLOCKS, start=1):
        fi = round_filters(fi, v.width)
        fo = round_filters(fo, v.width)
        for i in range(round_repeats(r, v.depth)):
            plan.append(dict(name=f"block{stage}{chr(ord('a') + i)}", kernel=k, stride=s if i == 0 else 1, expand=e,
                    in_filters=fi if i == 0 else fo, out_filters=fo, se_ratio=se, stage=stage, activation="swish"))
    return plan


_TAP_PRESETS = {"deep": ((5, (0.15, 0.6)), (6, (0.1, 0.45)), (7, (0.0,))),
    "early": ((3, (0.0,)), (4, (0.0,)), (5, (0.0, 0.6)), (6, (0.45,)), (7, (0.0,)))}


def default_taps(variant: str, preset: str = "deep") -> List[str]:
    """Exit-tap block names at fixed fractional stage depths."""
    by_stage: Dict[int, List[str]] = {}
    for b in block_plan(variant):
        by_stage.setdefault(b["stage"], []).append(b["name"])
    out: List[str] = []
    for stage, fracs in _TAP_PRESETS[preset]:
        names = by_stage[stage]
        for f in fracs:
            t = names[min(int(round(f * len(names))), len(names) - 1)]
            if t not in out:
                out.append(t)
    return out


def backbone_info(name: str) -> Dict[str, Any]:
    """Static facts of an EfficientNet (JAX ``backbone_info``)."""
    if name not in VARIANTS:
        raise NotImplementedError(f"backbone {name!r} is not ported yet")
    v = VARIANTS[name]
    return dict(family="efficientnet", variant=name, resolution=v.resolution,
        embedding_dim=round_filters(1280, v.width), taps=default_taps(name), preprocess="torch")


def _resize(images: torch.Tensor, resolution: Optional[int]) -> torch.Tensor:
    """fp32 NHWC, resized where the size differs (antialiased, as ``jax.image.resize`` shrinks)."""
    x = images.to(torch.float32)
    if resolution is not None and (x.shape[1] != resolution or x.shape[2] != resolution):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(resolution, resolution), mode="bilinear",
            align_corners=False, antialias=True).permute(0, 2, 3, 1)
    return x


def preprocess_images(images: torch.Tensor, resolution: Optional[int] = None, mean: Sequence[float] = MEAN_RGB,
    std: Sequence[float] = STDDEV_RGB) -> torch.Tensor:
    """uint8/float NHWC ``[B, H, W, 3]`` -> normalized fp32 NHWC, resized first."""
    x = _resize(images, resolution)
    m = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return (x - m) / s


# Keras 'caffe' mode (RGB -> BGR less the ImageNet means): VGG19, ResNet50
CAFFE_MEAN_BGR = (103.939, 116.779, 123.68)


def preprocess_images_caffe(images: torch.Tensor, resolution: Optional[int] = None,
        mean: Sequence[float] = CAFFE_MEAN_BGR) -> torch.Tensor:
    """RGB NHWC -> BGR less the mean, resized first."""
    x = _resize(images, resolution).flip(-1)
    return x - torch.as_tensor(mean, dtype=torch.float32, device=x.device)


# the module (inference)


def _same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """TF 'SAME': total = max((ceil(n/s)-1)*s + k - n, 0), low = total//2."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):  # F.pad order: W then H
        total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    if any(pads):
        x = F.pad(x, pads)
    return x


def _act(name: str):
    if name == "relu6":
        return lambda x: torch.clamp(x, 0.0, 6.0)
    return F.silu


class _Conv(nn.Module):
    """flax ``nn.Conv``, ``'SAME'`` pads; the fp32 OIHW weight cast to the input's dtype a call."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1, bias: bool = False):
        super().__init__()
        self.k, self.stride, self.groups = k, stride, groups
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor, fp32_out: bool = False) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        x, w = _same_pad(x, self.k, self.stride), self.weight.to(x.dtype)
        if fp32_out:  # operands rounded to x's dtype, the result unrounded
            x, w, b = x.float(), w.float(), None if b is None else b.float()
        return F.conv2d(x, w, b, self.stride, groups=self.groups)


def _conv_bn(conv: _Conv, bn: _BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """``bn(conv(x))`` as XLA runs it: the conv's fp32 result into the BN, rounded once after it."""
    return conv(x) if bn is None else bn(conv(x, fp32_out=True), x.dtype)


class SqueezeExcite(nn.Module):
    def __init__(self, filters: int, se_filters: int):
        super().__init__()
        self.reduce = _Conv(filters, se_filters, 1, bias=True)
        self.expand = _Conv(se_filters, filters, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        se = x.to(torch.float32).mean(dim=(2, 3), keepdim=True).to(x.dtype)
        se = self.expand(F.silu(self.reduce(se)))
        return x * torch.sigmoid(se)


class MBConv(nn.Module):
    """Inverted residual: expand, depthwise, (SE), project, the residual where the shape keeps."""

    def __init__(self, cfg: Dict[str, Any], hidden_filters: Optional[int] = None):
        super().__init__()
        fi, fo, k, stride = cfg["in_filters"], cfg["out_filters"], cfg["kernel"], cfg["stride"]
        self.act = _act(cfg.get("activation", "swish"))
        filters = hidden_filters or fi * cfg["expand"]
        self.has_expand = cfg["expand"] != 1
        if self.has_expand:
            self.expand_conv = _Conv(fi, filters, 1)
            self.expand_bn = _BatchNorm(filters)
        self.dw_conv = _Conv(filters, filters, k, stride, groups=filters)
        self.dw_bn = _BatchNorm(filters)
        self.se = SqueezeExcite(filters, max(1, int(fi * cfg["se_ratio"]))) if cfg["se_ratio"] > 0 else None
        self.project_conv = _Conv(filters, fo, 1)
        self.project_bn = _BatchNorm(fo)
        self.residual = stride == 1 and fi == fo

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, keep: float = 1.0) -> torch.Tensor:
        h = x
        if self.has_expand:
            h = self.act(_conv_bn(self.expand_conv, self.expand_bn, h))
        h = self.act(_conv_bn(self.dw_conv, self.dw_bn, h))
        if self.se is not None:
            h = self.se(h)
        h = _conv_bn(self.project_conv, self.project_bn, h)
        if mask is not None:
            h = drop_path(h, mask, keep)
        return h + x if self.residual else h


def drop_path(h: torch.Tensor, mask: torch.Tensor, keep: float) -> torch.Tensor:
    """Stochastic depth (JAX :229-235): kept rows ``h / keep`` in ``h``'s dtype, the rest 0."""
    return torch.where(mask[:, None, None, None], h / keep, 0.0).to(h.dtype)


def _remat_block(blk: nn.Module, h: torch.Tensor, mask, keep: float) -> torch.Tensor:
    # recomputed in the backward pass, after ZooNet.forward's train mode has ended
    with batch_stats(blk, commit=False):
        return blk(h) if mask is None else blk(h, mask, keep)


class EfficientNet(ZooNet):
    """EfficientNet with segments and taps; train mode keeps block i's residual with probability ``1 -
    drop_connect * i / n`` (``drop_masks(i, batch)`` replays masks); ``remat`` recomputes blocks backward."""

    drop_connect, drop_masks, remat = 0.2, None, False

    def __init__(self, variant: str = "b0", num_classes: int = 0, dtype: torch.dtype = torch.bfloat16,
        hidden_overrides: Optional[Dict[str, int]] = None, remat: bool = False):
        super().__init__()
        v = VARIANTS[variant]
        self.variant, self.resolution, self.remat, self.drop_rate = variant, v.resolution, remat, v.dropout
        self._build(block_plan(variant), round_filters(32, v.width), round_filters(1280, v.width), num_classes, dtype,
                hidden_overrides)

    def _build(self, plan, stem_filters: int, head_filters: Optional[int], num_classes: int, dtype: torch.dtype,
            hidden_overrides=None, block=None, activation: Optional[str] = None, folded: bool = False) -> None:
        """Stem, ``block(cfg, hidden)`` a config, head, dense layer; ``folded``: the stem's BN as a bias."""
        self.num_classes = int(num_classes)
        self.dtype = dtype
        self.hidden_overrides = dict(hidden_overrides or {})
        self.plan = plan
        self.act = _act(activation or plan[0].get("activation", "swish"))
        self.stem_conv = _Conv(3, stem_filters, 3, stride=2, bias=folded)
        self.stem_bn = None if folded else _BatchNorm(stem_filters)
        self.blocks = nn.ModuleList((block or MBConv)(c, self.hidden_overrides.get(c["name"])) for c in plan)
        feat = self.plan[-1]["out_filters"]
        self.head_conv = self.head_bn = None
        if head_filters is not None:
            self.head_conv = _Conv(feat, head_filters, 1)
            self.head_bn = _BatchNorm(head_filters)
            feat = head_filters
        self.fc = nn.Linear(feat, self.num_classes) if self.num_classes > 0 else None
        self.last_masks: Dict[int, torch.Tensor] = {}

    def _block(self, i: int, h: torch.Tensor, train: bool, rng) -> torch.Tensor:
        blk, keep, mask = self.blocks[i], 1.0 - self.drop_connect * i / len(self.plan), None
        if train and getattr(blk, "residual", False) and keep < 1.0:
            mask = self.drop_masks(i, h.shape[0]) if self.drop_masks else keep_mask(h.shape[0], keep, rng, h.device)
            self.last_masks[i] = mask
        if train and self.remat:
            return checkpoint(_remat_block, blk, h, mask, keep, use_reentrant=False)
        return blk(h) if mask is None else blk(h, mask, keep)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> the stem's activation (NCHW, channels_last)."""
        return self.act(_conv_bn(self.stem_conv, self.stem_bn, self._to_nchw(x)))

    def head_pool(self, x: torch.Tensor) -> torch.Tensor:
        """Head conv + BN + activation + global average pool -> [B, F] fp32."""
        return _pool(self.act(_conv_bn(self.head_conv, self.head_bn, x)))

    def _layers(self):
        """Each conv at (flax path, None, conv), each BN at (None, path, BN), the SE's convs too."""
        named = [(("stem_conv",), self.stem_conv), (("stem_bn",), self.stem_bn)]
        for cfg, blk in zip(self.plan, self.blocks):
            named += [((cfg["name"], n), getattr(blk, n, None)) for n in ("expand_conv", "expand_bn", "dw_conv",
                    "dw_bn", "project_conv", "project_bn", "pw_conv", "pw_bn")]
            if getattr(blk, "se", None) is not None:
                named += [((cfg["name"], "se", "reduce"), blk.se.reduce), ((cfg["name"], "se", "expand"), blk.se.expand)]
        named += [(("head_conv",), self.head_conv), (("head_bn",), self.head_bn)]
        for path, m in named:
            if m is not None:
                yield (path, None, m) if isinstance(m, _Conv) else (None, path, m)


def create_efficientnet(variant: str = "b0", num_classes: int = 0, seed: int = 0, resolution: Optional[int] = None,
    dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None):
    """``(model on device, flax-layout numpy variables)``, flax's default init from ``seed``."""
    model = EfficientNet(variant=variant, num_classes=num_classes, dtype=dtype)
    return create(model, seed, resolution or VARIANTS[variant].resolution, device)
