"""Folded EfficientNet serving forward (counterpart of
``fast_image_recognition_tpu/models/inference.py``: ``fold_backbone``,
``fold_preprocess_into_stem``, ``fold_stem_space_to_depth``, the folded
stem, blocks and head, ``folded_forward`` and ``make_infer_fn``).

Every inference BatchNorm is folded into its conv in float64 on the host,
and the ``(x - mean) / std`` preprocess into the stem (raw uint8 images; a
constant correction map keeps the fold exact at the SAME-padding borders).
Images of another size take the explicit path: resize, normalize, raw
stem. ``fused=True`` sends every stride-1 MBConv block to
``ops.mbconv_kernel`` (the CUDA kernel on the card); stride-2 blocks and
:meth:`run_blocks` stay per-op, as in JAX. The public surface keeps JAX's
NHWC images and HWIO weights; the module runs NCHW in ``channels_last``
with OIHW weights and pads every conv explicitly (TF "SAME" is asymmetric
at stride 2).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fast_image_recognition_tpu_torch.device import DeviceLike, resolve_device
from fast_image_recognition_tpu_torch.models.efficientnet import (
    MEAN_RGB,
    STDDEV_RGB,
    VARIANTS,
    _same_pad,
    block_plan,
    preprocess_images,
)
from fast_image_recognition_tpu_torch.ops.mbconv_kernel import mbconv, prepare_params

_BN_EPS = 1e-3


def _fold_conv_bn(kernel, bn_scale, bn_bias, bn_mean, bn_var, dtype):
    """Fold an inference BatchNorm into the conv that feeds it (float64)."""
    k = np.asarray(kernel, np.float64)
    s = np.asarray(bn_scale, np.float64) / np.sqrt(
        np.asarray(bn_var, np.float64) + _BN_EPS
    )
    b = np.asarray(bn_bias, np.float64) - np.asarray(bn_mean, np.float64) * s
    return (
        torch.from_numpy(k * s).to(dtype),  # scales the output-channel axis
        torch.from_numpy(b).to(dtype),
    )


def fold_backbone(
    variables: Dict[str, Any], variant: str, dtype: torch.dtype = torch.bfloat16
) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """``{'params', 'batch_stats'}`` numpy trees (``utils.checkpoint``) ->
    (folded tensors in the JAX layout: HWIO kernels, [C, S] SE denses;
    static block configs)."""
    params = variables["params"]
    stats = variables["batch_stats"]

    def conv_bn(bp, bs, conv, bn):
        return _fold_conv_bn(
            bp[conv]["kernel"], bp[bn]["scale"], bp[bn]["bias"],
            bs[bn]["mean"], bs[bn]["var"], dtype,
        )

    folded: Dict[str, Any] = {}
    folded["stem_w"], folded["stem_b"] = conv_bn(params, stats, "stem_conv", "stem_bn")
    folded["head_w"], folded["head_b"] = conv_bn(params, stats, "head_conv", "head_bn")
    blocks, configs = [], []
    for cfg in block_plan(variant):
        name = cfg["name"]
        bp, bs = params[name], stats[name]
        entry: Dict[str, Any] = {}
        has_expand = "expand_conv" in bp
        if has_expand:
            entry["w_exp"], entry["b_exp"] = conv_bn(bp, bs, "expand_conv", "expand_bn")
        entry["w_dw"], entry["b_dw"] = conv_bn(bp, bs, "dw_conv", "dw_bn")
        has_se = "se" in bp
        if has_se:
            # 1x1 convs on the pooled vector -> fp32 dense layers
            se = bp["se"]
            entry["w_se1"] = torch.tensor(np.asarray(se["reduce"]["kernel"])[0, 0], dtype=torch.float32)
            entry["b_se1"] = torch.tensor(np.asarray(se["reduce"]["bias"]), dtype=torch.float32)
            entry["w_se2"] = torch.tensor(np.asarray(se["expand"]["kernel"])[0, 0], dtype=torch.float32)
            entry["b_se2"] = torch.tensor(np.asarray(se["expand"]["bias"]), dtype=torch.float32)
        entry["w_proj"], entry["b_proj"] = conv_bn(bp, bs, "project_conv", "project_bn")
        blocks.append(entry)
        configs.append(
            dict(
                name=name,
                kernel=cfg["kernel"],
                stride=cfg["stride"],
                has_expand=has_expand,
                has_se=has_se,
                activation=cfg.get("activation", "swish"),
                residual=cfg["stride"] == 1 and cfg["in_filters"] == cfg["out_filters"],
            )
        )
    folded["blocks"] = blocks
    return folded, configs


def _conv(x, w_oihw, b, stride: int = 1, groups: int = 1):
    x = _same_pad(x, w_oihw.shape[-1], stride)
    return F.conv2d(x, w_oihw, b, stride=stride, groups=groups)


def _oihw(w_hwio: torch.Tensor) -> torch.Tensor:
    w = w_hwio.permute(3, 2, 0, 1)
    return w.contiguous(memory_format=torch.channels_last)


def fold_preprocess_into_stem(
    folded: Dict[str, Any],
    resolution: int,
    dtype: torch.dtype = torch.bfloat16,
    mean: Optional[Sequence[float]] = None,
    std: Optional[Sequence[float]] = None,
) -> Dict[str, Any]:
    """Adds ``stem_pp_w`` (HWIO, scaled by 1/std) and ``stem_pp_corr``
    ([1, R/2, R/2, C] fp32): conv((x-m)/s, W) == conv(x, W/s) - conv(m, W/s).
    ``mean``/``std`` default to MEAN_RGB/STDDEV_RGB (TF_MODE_* for the
    Keras 'tf'-mode families)."""
    std = torch.tensor(STDDEV_RGB if std is None else std, dtype=torch.float32)
    mean = torch.tensor(MEAN_RGB if mean is None else mean, dtype=torch.float32)
    w = folded["stem_w"].to(torch.float32)  # [3, 3, 3, C], dtype-rounded
    w_pp = w / std[None, None, :, None]
    const = mean[None, :, None, None].expand(1, 3, resolution, resolution)
    corr = _conv(const.contiguous(), w_pp.permute(3, 2, 0, 1).contiguous(), None, stride=2)
    out = dict(folded)
    out["stem_pp_w"] = w_pp.to(dtype)
    out["stem_pp_corr"] = corr.permute(0, 2, 3, 1).contiguous()  # NHWC fp32
    return out


def fold_stem_space_to_depth(folded: Dict[str, Any], resolution: int) -> Dict[str, Any]:
    """Rewrite the preprocess-folded stride-2 3x3 stem as a stride-1 2x2
    conv over 12-channel half-resolution blocks (adds ``stem_s2d_w``
    [2, 2, 12, C] HWIO): ``K2[p, q, (r, s, c), o] = Wpad[2p + r, 2q + s, c,
    o]`` with W zero-padded to 4x4 taps; the input packs ``x[2i+r, 2j+s,
    c]`` into channel ``(r*2+s)*3+c``. Exact for even resolutions (SAME
    pad_low is 0 there); odd ones and other kernel sizes keep the plain
    stem. Opt-in, as in the JAX package."""
    if resolution % 2:
        return folded
    w = folded["stem_pp_w"]  # [3, 3, 3, C]
    k, _, cin, cout = w.shape
    if k != 3:
        return folded
    w4 = F.pad(w, (0, 0, 0, 0, 0, 1, 0, 1))  # [4, 4, 3, C]
    k2 = w4.reshape(2, 2, 2, 2, cin, cout).permute(0, 2, 1, 3, 4, 5)
    out = dict(folded)
    out["stem_s2d_w"] = k2.reshape(2, 2, 4 * cin, cout).contiguous()
    return out


class _FoldedBlock(nn.Module):
    """One MBConv block with BN folded (``models/inference.py::_block``)."""

    def __init__(self, p: Dict[str, torch.Tensor], cfg: Dict[str, Any]):
        super().__init__()
        if cfg.get("activation", "swish") != "swish":
            raise NotImplementedError("only swish MBConv blocks are ported")
        self.stride = int(cfg["stride"])
        self.has_expand = bool(cfg["has_expand"])
        self.has_se = bool(cfg["has_se"])
        self.residual = bool(cfg["residual"])
        if self.has_expand:
            self.register_buffer("w_exp", _oihw(p["w_exp"]))
            self.register_buffer("b_exp", p["b_exp"].clone())
        self.register_buffer("w_dw", _oihw(p["w_dw"]))  # [C, 1, k, k]
        self.register_buffer("b_dw", p["b_dw"].clone())
        if self.has_se:
            for n in ("w_se1", "b_se1", "w_se2", "b_se2"):
                self.register_buffer(n, p[n].clone())
        self.register_buffer("w_proj", _oihw(p["w_proj"]))
        self.register_buffer("b_proj", p["b_proj"].clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.has_expand:
            h = F.silu(_conv(h, self.w_exp, self.b_exp))
        h = F.silu(_conv(h, self.w_dw, self.b_dw, self.stride, groups=h.shape[1]))
        if self.has_se:
            s = h.to(torch.float32).mean(dim=(2, 3))
            s = F.silu(s @ self.w_se1 + self.b_se1)
            s = torch.sigmoid(s @ self.w_se2 + self.b_se2)
            h = h * s.to(h.dtype)[:, :, None, None]
        h = _conv(h, self.w_proj, self.b_proj)
        if self.residual:
            h = h + x
        return h


class _FusedBlock(nn.Module):
    """One stride-1 MBConv block through ``ops.mbconv_kernel.mbconv``: the
    fused CUDA kernel on the card, its plain version on the CPU. It runs
    in bf16, the kernel's type, and returns the module's dtype."""

    def __init__(self, p: Dict[str, torch.Tensor], cfg: Dict[str, Any]):
        super().__init__()
        q = prepare_params(p, cfg)
        for n, t in q.items():
            self.register_buffer(n, t)
        self.param_names = tuple(q)
        self.cfg = {k: cfg[k] for k in ("kernel", "stride", "has_expand", "has_se", "residual")}
        self.cfg["activation"] = cfg.get("activation", "swish")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # a no-op where the producer already wrote channels_last (cuDNN does)
        h = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        y = mbconv(h, {n: getattr(self, n) for n in self.param_names}, self.cfg)
        return y.to(x.dtype)


class FoldedEfficientNet(nn.Module):
    """BN- and preprocess-folded EfficientNet forward on raw images.

    ``forward(images)``: uint8 (or 0..255 float) NHWC ``[B, R', R', 3]`` ->
    ``{'embedding': [B, F] fp32 pooled features, 'taps': {name: [B, C] fp32}}``.
    At the module's resolution with the preprocess folded (``stem_pp_w``)
    the stem reads the raw images (``folded_stem_pp``; with ``stem_s2d_w``
    as a space-to-depth conv); otherwise the images are resized to the
    resolution and normalized with ``mean``/``std`` first
    (``preprocess_images`` + ``folded_stem``). ``fused=True`` runs the
    stride-1 blocks of :meth:`forward` through the fused MBConv kernel.
    The segment primitives :meth:`stem`, :meth:`run_blocks` and
    :meth:`head` run the same forward in pieces, per-op (the early-exit
    cascade runs stem -> blocks ``[0, e0)`` -> ``[e0, e1)`` -> ... -> head
    on a shrinking batch); their activations are NCHW in ``channels_last``
    memory.
    """

    def __init__(
        self,
        folded: Dict[str, Any],
        configs: List[Dict[str, Any]],
        resolution: int,
        taps: Sequence[str] = (),
        fused: bool = False,
        mean: Optional[Sequence[float]] = None,
        std: Optional[Sequence[float]] = None,
    ):
        super().__init__()
        self.resolution = int(resolution)
        self.dtype = folded["stem_w"].dtype
        self.names = [c["name"] for c in configs]
        self.taps = tuple(taps)
        self.mean = tuple(MEAN_RGB if mean is None else mean)
        self.std = tuple(STDDEV_RGB if std is None else std)
        self.register_buffer("stem_w", _oihw(folded["stem_w"]))  # raw stem, explicit preprocess
        self.register_buffer("stem_b", folded["stem_b"].clone())
        self.folded_preprocess = "stem_pp_w" in folded
        self.space_to_depth = "stem_s2d_w" in folded
        if self.folded_preprocess:
            self.register_buffer("stem_pp_w", _oihw(folded["stem_pp_w"]))
            corr = folded["stem_pp_corr"].permute(0, 3, 1, 2).to(self.dtype)
            self.register_buffer("stem_corr", corr.contiguous(memory_format=torch.channels_last))
        if self.space_to_depth:
            self.register_buffer("stem_s2d_w", _oihw(folded["stem_s2d_w"]))
        self.blocks = nn.ModuleList(
            _FoldedBlock(p, c) for p, c in zip(folded["blocks"], configs)
        )
        self.fused_blocks = nn.ModuleDict(
            {str(i): _FusedBlock(p, c) for i, (p, c) in enumerate(zip(folded["blocks"], configs))
             if fused and c["stride"] == 1}
        )
        self.register_buffer("head_w", _oihw(folded["head_w"]))
        self.register_buffer("head_b", folded["head_b"].clone())

    def stem(self, images: torch.Tensor) -> torch.Tensor:
        """Raw NHWC images -> the stem's activation."""
        r = self.resolution
        if self.folded_preprocess and images.shape[1] == r and images.shape[2] == r:
            if self.space_to_depth:
                # [B, R, R, 3] -> [B, R/2, R/2, 12], channel (r*2+s)*3+c, then
                # the SAME high pad and a stride-1 2x2 VALID conv
                b, _, _, c = images.shape
                x = images.to(self.dtype).reshape(b, r // 2, 2, r // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
                x = x.reshape(b, r // 2, r // 2, 4 * c).permute(0, 3, 1, 2)
                h = F.conv2d(F.pad(x, (0, 1, 0, 1)), self.stem_s2d_w, self.stem_b)
            else:
                # NHWC -> NCHW view: already channels_last in memory
                x = images.permute(0, 3, 1, 2).to(self.dtype)
                h = _conv(x, self.stem_pp_w, self.stem_b, stride=2)
            return F.silu(h - self.stem_corr)
        x = preprocess_images(images, r, self.mean, self.std).to(self.dtype).permute(0, 3, 1, 2)
        return F.silu(_conv(x, self.stem_w, self.stem_b, stride=2))

    def raw_stem(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC images as given, neither resized nor normalized -> the
        stem's activation (``folded_stem``; the early-exit engine's
        level 0, whose inputs are the trainable module's)."""
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        return F.silu(_conv(x, self.stem_w, self.stem_b, stride=2))

    def run_blocks(self, h: torch.Tensor, start: int = 0, end: Optional[int] = None) -> torch.Tensor:
        """Blocks ``[start, end)``, per-op (``folded_blocks``)."""
        for blk in self.blocks[start:end]:
            h = blk(h)
        return h

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """Head conv + swish + fp32 global mean pool -> ``[B, F]``
        (``folded_head``)."""
        h = F.silu(_conv(h, self.head_w, self.head_b))
        return h.to(torch.float32).mean(dim=(2, 3))

    def forward(self, images: torch.Tensor) -> Dict[str, Any]:
        h = self.stem(images)
        taps: Dict[str, torch.Tensor] = {}
        for i, (name, blk) in enumerate(zip(self.names, self.blocks)):
            h = self.fused_blocks[str(i)](h) if str(i) in self.fused_blocks else blk(h)
            if name in self.taps:
                taps[name] = h.to(torch.float32).mean(dim=(2, 3))
        return {"embedding": self.head(h), "taps": taps}


def make_infer_fn(
    variables: Dict[str, Any],
    variant: str = "b0",
    taps: Sequence[str] = (),
    resolution: Optional[int] = None,
    dtype: torch.dtype = torch.bfloat16,
    fold_preprocess: bool = True,
    mean: Optional[Sequence[float]] = None,
    std: Optional[Sequence[float]] = None,
    fused: bool = False,
    space_to_depth: bool = False,
    device: DeviceLike = None,
) -> FoldedEfficientNet:
    """Fold a checkpoint's numpy ``params``/``batch_stats`` and return the
    serving module on ``device`` (JAX ``make_infer_fn``, which returns
    ``(fn, folded)``; here the module holds both). ``mean``/``std`` select
    the preprocessing constants (default MEAN_RGB/STDDEV_RGB).
    ``fused=True`` runs the stride-1 MBConv blocks through the fused
    kernel; ``space_to_depth=True`` (with ``fold_preprocess``) rewrites the
    stem as a space-to-depth conv."""
    dev = resolve_device(device)
    folded, configs = fold_backbone(variables, variant, dtype=dtype)
    res = int(resolution or VARIANTS[variant].resolution)
    if fold_preprocess:
        folded = fold_preprocess_into_stem(folded, res, dtype=dtype, mean=mean, std=std)
        if space_to_depth:
            folded = fold_stem_space_to_depth(folded, res)
    module = FoldedEfficientNet(folded, configs, res, taps=taps, fused=fused, mean=mean, std=std)
    return module.to(dev).eval()
