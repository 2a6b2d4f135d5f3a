"""EfficientNet B0-B7 (JAX ``models/efficientnet.py``): the plan and the
module at inference (bf16 convs, TF 'SAME' pads, BN in fp32, fp32 weights
cast at each call); flax numpy trees in and out; ``train=True`` raises."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fast_image_recognition_tpu_torch.device import DeviceLike, resolve_device

# torchvision-style ImageNet normalization on 0..255 inputs
# (dnn_feature_extractor.py:116-119 in the reference)
MEAN_RGB = (0.485 * 255, 0.456 * 255, 0.406 * 255)
STDDEV_RGB = (0.229 * 255, 0.224 * 255, 0.225 * 255)
# Keras "tf"-mode preprocess_input (x/127.5 - 1), the MobileNet(V2) /
# Inception* / ResNetV2 members' preprocess
TF_MODE_MEAN = (127.5, 127.5, 127.5)
TF_MODE_STD = (127.5, 127.5, 127.5)


@dataclasses.dataclass(frozen=True)
class Variant:
    width: float
    depth: float
    resolution: int
    dropout: float


VARIANTS: Dict[str, Variant] = {
    "b0": Variant(1.0, 1.0, 224, 0.2),
    "b1": Variant(1.0, 1.1, 240, 0.2),
    "b2": Variant(1.1, 1.2, 260, 0.3),
    "b3": Variant(1.2, 1.4, 300, 0.3),
    "b4": Variant(1.4, 1.8, 380, 0.4),
    "b5": Variant(1.6, 2.2, 456, 0.4),
    "b6": Variant(1.8, 2.6, 528, 0.5),
    "b7": Variant(2.0, 3.1, 600, 0.5),
}

# (kernel, stride, expand, in_filters, out_filters, repeats, se_ratio)
_BASE_BLOCKS = (
    (3, 1, 1, 32, 16, 1, 0.25),
    (3, 2, 6, 16, 24, 2, 0.25),
    (5, 2, 6, 24, 40, 2, 0.25),
    (3, 2, 6, 40, 80, 3, 0.25),
    (5, 1, 6, 80, 112, 3, 0.25),
    (5, 2, 6, 112, 192, 4, 0.25),
    (3, 1, 6, 192, 320, 1, 0.25),
)


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
            plan.append(
                dict(
                    name=f"block{stage}{chr(ord('a') + i)}",
                    kernel=k,
                    stride=s if i == 0 else 1,
                    expand=e,
                    in_filters=fi if i == 0 else fo,
                    out_filters=fo,
                    se_ratio=se,
                    stage=stage,
                    activation="swish",
                )
            )
    return plan


_TAP_PRESETS = {
    "deep": ((5, (0.15, 0.6)), (6, (0.1, 0.45)), (7, (0.0,))),
    "early": ((3, (0.0,)), (4, (0.0,)), (5, (0.0, 0.6)), (6, (0.45,)), (7, (0.0,))),
}


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
    """Static facts the serving surface needs (``models/__init__.py``
    ``backbone_info`` of the JAX package, EfficientNet family only)."""
    if name not in VARIANTS:
        raise NotImplementedError(f"backbone {name!r} is not ported yet")
    v = VARIANTS[name]
    return dict(
        family="efficientnet",
        variant=name,
        resolution=v.resolution,
        embedding_dim=round_filters(1280, v.width),
        taps=default_taps(name),
        preprocess="torch",
    )


def preprocess_images(
    images: torch.Tensor,
    resolution: Optional[int] = None,
    mean: Sequence[float] = MEAN_RGB,
    std: Sequence[float] = STDDEV_RGB,
) -> torch.Tensor:
    """uint8/float NHWC ``[B, H, W, 3]`` -> normalized fp32 NHWC, resized
    first where the size differs (``F.interpolate(antialias=True)``, as
    ``jax.image.resize(method='bilinear')`` shrinks)."""
    x = images.to(torch.float32)
    if resolution is not None and (x.shape[1] != resolution or x.shape[2] != resolution):
        x = F.interpolate(
            x.permute(0, 3, 1, 2), size=(resolution, resolution), mode="bilinear",
            align_corners=False, antialias=True,
        ).permute(0, 2, 3, 1)
    m = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return (x - m) / s


# the module (inference)

_BN_EPS = 1e-3
# flax lecun_normal: a standard normal truncated to [-2, 2], scaled by
# sqrt(1 / fan_in) / 0.8796 (the truncated law's standard deviation)
_TRUNC_STD = 0.87962566103423978


def _same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """TF 'SAME': total = max((ceil(n/s)-1)*s + k - n, 0), low = total//2."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):  # F.pad order: W then H
        total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    if any(pads):
        x = F.pad(x, pads)
    return x


def _lecun_normal(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal()``: ``truncated_normal(-2, 2) * sqrt(1/fan_in) /
    0.8796``, drawn by the inverse CDF from ``gen``."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(shape, generator=gen, dtype=torch.float64) * (hi - lo) + lo
    x = torch.erfinv(u) * math.sqrt(2.0)
    return (x * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)).to(torch.float32)


def _act(name: str):
    if name == "relu6":
        return lambda x: torch.clamp(x, 0.0, 6.0)
    return F.silu


class _Conv(nn.Module):
    """flax ``nn.Conv`` with ``'SAME'`` padding; the weight is OIHW fp32
    (flax keeps HWIO), cast to the input's dtype at each call."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1, bias: bool = False):
        super().__init__()
        self.k, self.stride, self.groups = k, stride, groups
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def init_(self, gen: torch.Generator) -> None:
        fan_in = self.weight.shape[1] * self.k * self.k
        self.weight.data = _lecun_normal(self.weight.shape, fan_in, gen)

    def forward(self, x: torch.Tensor, fp32_out: bool = False) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        x, w = _same_pad(x, self.k, self.stride), self.weight.to(x.dtype)
        if fp32_out:  # operands rounded to x's dtype, the result unrounded
            x, w, b = x.float(), w.float(), None if b is None else b.float()
        return F.conv2d(x, w, b, self.stride, groups=self.groups)

    def export(self) -> Dict[str, np.ndarray]:
        out = {"kernel": self.weight.detach().permute(2, 3, 1, 0).cpu().numpy()}
        if self.bias is not None:
            out["bias"] = self.bias.detach().cpu().numpy()
        return out

    def load(self, p: Dict[str, Any]) -> None:
        self.weight.data = torch.tensor(np.asarray(p["kernel"], np.float32)).permute(3, 2, 0, 1).contiguous()
        if self.bias is not None:
            self.bias.data = torch.tensor(np.asarray(p["bias"], np.float32))


class _BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over running statistics: ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias`` in fp32, rounded to ``x``'s dtype."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        mul = torch.rsqrt(self.var + _BN_EPS) * self.scale
        y = (x.to(torch.float32) - self.mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(dtype or x.dtype)

    def export(self):
        t = lambda v: v.detach().cpu().numpy()  # noqa: E731
        return {"scale": t(self.scale), "bias": t(self.bias)}, {"mean": t(self.mean), "var": t(self.var)}

    def load(self, p: Dict[str, Any], s: Dict[str, Any]) -> None:
        for name, tree in (("scale", p), ("bias", p), ("mean", s), ("var", s)):
            getattr(self, name).data = torch.tensor(np.asarray(tree[name], np.float32))


def _conv_bn(conv: _Conv, bn: _BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """``bn(conv(x))`` as XLA runs it: the conv's fp32 result enters the BN
    unrounded, rounded once after it to ``x``'s dtype (a rounding between
    them doubled the folded-vs-unfolded gap of the bf16 module). No BN: a
    folded conv, its bias added before the one rounding."""
    return conv(x) if bn is None else bn(conv(x, fp32_out=True), x.dtype)


def _pool(h: torch.Tensor) -> torch.Tensor:
    """Global average pool as ``jnp.mean`` takes it: summed in fp32, the
    mean rounded to the activation's dtype, returned as fp32."""
    return h.to(torch.float32).mean(dim=(2, 3)).to(h.dtype).to(torch.float32)


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
    """Inverted-residual block: expand 1x1 -> depthwise -> (SE) -> project
    1x1 with a linear bottleneck, and the residual where the shape keeps."""

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.has_expand:
            h = self.act(_conv_bn(self.expand_conv, self.expand_bn, h))
        h = self.act(_conv_bn(self.dw_conv, self.dw_bn, h))
        if self.se is not None:
            h = self.se(h)
        h = _conv_bn(self.project_conv, self.project_bn, h)
        return h + x if self.residual else h


class EfficientNet(nn.Module):
    """EfficientNet backbone with segment execution and exit taps
    (``num_classes=0``: the pooled-embedding extractor)."""

    def __init__(
        self,
        variant: str = "b0",
        num_classes: int = 0,
        dtype: torch.dtype = torch.bfloat16,
        hidden_overrides: Optional[Dict[str, int]] = None,
    ):
        super().__init__()
        v = VARIANTS[variant]
        self.variant, self.resolution = variant, v.resolution
        self._build(block_plan(variant), round_filters(32, v.width), round_filters(1280, v.width), num_classes, dtype,
                    hidden_overrides)

    def _build(self, plan, stem_filters: int, head_filters: Optional[int], num_classes: int, dtype: torch.dtype,
               hidden_overrides=None, block=None, activation: Optional[str] = None, folded: bool = False) -> None:
        """The layers of a plan: stem conv + BN, ``block(cfg, hidden)``
        (default ``MBConv``) per config, the head conv + BN (none where
        ``head_filters`` is None) and the dense layer; ``activation`` (default
        the plan's) at the stem and the head; ``folded``: a stem conv with
        its BN as a bias."""
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

    def block_names(self) -> List[str]:
        return [c["name"] for c in self.plan]

    def plan_configs(self) -> List[Dict[str, Any]]:
        """Static block configs (the folding and cascade engines read them)."""
        return [dict(c) for c in self.plan]

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> the stem's activation (NCHW, channels_last)."""
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return self.act(_conv_bn(self.stem_conv, self.stem_bn, x))

    def run_blocks(self, x: torch.Tensor, start: int = 0, end: Optional[int] = None) -> torch.Tensor:
        """Blocks ``[start, end)``: the cascade's segment primitive."""
        for blk in self.blocks[start:end]:
            x = blk(x)
        return x

    def head_pool(self, x: torch.Tensor) -> torch.Tensor:
        """Head conv + BN + activation + global average pool -> [B, F] fp32."""
        return _pool(self.act(_conv_bn(self.head_conv, self.head_bn, x)))

    def forward(
        self,
        x: torch.Tensor,
        train: bool = False,
        taps: Optional[Sequence[str]] = None,
        include_logits: Optional[bool] = None,
    ) -> Dict[str, Any]:
        """``{'embedding': [B, F] fp32, 'taps': {name: [B, C] fp32 pooled
        block output}, 'logits': [B, num_classes] when asked}``."""
        if train:
            raise NotImplementedError("training (batch statistics, dropout, stochastic depth) is not ported")
        if include_logits is None:
            include_logits = self.num_classes > 0
        tapset = set(taps or ())
        h = self.stem(x)
        tap_out: Dict[str, torch.Tensor] = {}
        for cfg, blk in zip(self.plan, self.blocks):
            h = blk(h)
            if cfg["name"] in tapset:
                tap_out[cfg["name"]] = _pool(h)
        emb = self.head_pool(h)
        out: Dict[str, Any] = {"embedding": emb, "taps": tap_out}
        if include_logits and self.fc is not None:
            out["logits"] = self.fc(emb)  # dropout is the identity at inference
        return out

    def _layers(self):
        """(flax scope, module) of every conv and BatchNorm, and the SE and
        dense layers, in the flax tree's naming."""
        yield ("stem_conv",), self.stem_conv
        if self.stem_bn is not None:
            yield ("stem_bn",), self.stem_bn
        for cfg, blk in zip(self.plan, self.blocks):
            for name in ("expand_conv", "expand_bn", "dw_conv", "dw_bn", "project_conv", "project_bn", "pw_conv",
                         "pw_bn"):
                if getattr(blk, name, None) is not None:
                    yield (cfg["name"], name), getattr(blk, name)
            if getattr(blk, "se", None) is not None:
                yield (cfg["name"], "se", "reduce"), blk.se.reduce
                yield (cfg["name"], "se", "expand"), blk.se.expand
        if self.head_conv is not None:
            yield ("head_conv",), self.head_conv
            yield ("head_bn",), self.head_bn

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        """flax's default init from ``torch.Generator().manual_seed(seed)``:
        truncated lecun-normal kernels, zero biases, BatchNorm scale 1,
        bias 0, mean 0, var 1."""
        gen = torch.Generator().manual_seed(int(seed))
        for _, layer in self._layers():
            if isinstance(layer, _Conv):
                layer.init_(gen)
                if layer.bias is not None:
                    layer.bias.zero_()
            else:
                for name, value in (("scale", 1.0), ("bias", 0.0), ("mean", 0.0), ("var", 1.0)):
                    getattr(layer, name).fill_(value)
        if self.fc is not None:
            self.fc.weight.data = _lecun_normal(self.fc.weight.shape[::-1], self.fc.in_features, gen).T.contiguous()
            self.fc.bias.zero_()

    def export_variables(self) -> Dict[str, Any]:
        """The flax ``{'params', 'batch_stats'}`` trees as numpy fp32 arrays
        (HWIO kernels; the dense kernel [F, C])."""
        params: Dict[str, Any] = {}
        stats: Dict[str, Any] = {}

        def at(tree, scope):
            for key in scope:
                tree = tree.setdefault(key, {})
            return tree

        for scope, layer in self._layers():
            if isinstance(layer, _Conv):
                at(params, scope).update(layer.export())
            else:
                p, s = layer.export()
                at(params, scope).update(p)
                at(stats, scope).update(s)
        if self.fc is not None:
            params["fc"] = {"kernel": self.fc.weight.detach().T.cpu().numpy(),
                            "bias": self.fc.bias.detach().cpu().numpy()}
        return {"params": params, "batch_stats": stats}

    @torch.no_grad()
    def load_variables(self, variables: Dict[str, Any]) -> "EfficientNet":
        """Copy flax ``{'params', 'batch_stats'}`` trees (numpy or any array
        type ``np.asarray`` takes) into the module, on its device."""
        dev = self.stem_conv.weight.device

        def at(tree, scope):
            for key in scope:
                tree = tree[key]
            return tree

        for scope, layer in self._layers():
            if isinstance(layer, _Conv):
                layer.load(at(variables["params"], scope))
            else:
                layer.load(at(variables["params"], scope), at(variables["batch_stats"], scope))
        if self.fc is not None:
            fc = variables["params"]["fc"]
            self.fc.weight.data = torch.tensor(np.asarray(fc["kernel"], np.float32)).T.contiguous()
            self.fc.bias.data = torch.tensor(np.asarray(fc["bias"], np.float32))
        return self.to(dev)


def create_efficientnet(
    variant: str = "b0",
    num_classes: int = 0,
    seed: int = 0,
    resolution: Optional[int] = None,
    dtype: torch.dtype = torch.bfloat16,
    device: DeviceLike = None,
):
    """Build the module with flax's default init drawn from ``seed`` and
    return ``(model on device, its flax-layout numpy variables)``. The
    module takes any resolution; ``resolution`` (default the variant's) is
    kept on it as ``model.resolution``."""
    dev = resolve_device(device)
    model = EfficientNet(variant=variant, num_classes=num_classes, dtype=dtype)
    model.init_weights(seed)
    model.resolution = int(resolution or VARIANTS[variant].resolution)
    variables = model.export_variables()
    return model.to(dev).eval(), variables
