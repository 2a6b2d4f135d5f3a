"""Folded EfficientNet serving forward in PyTorch (counterpart of
``fast_image_recognition_tpu/models/inference.py``: ``_fold_conv_bn``,
``fold_backbone``, ``fold_preprocess_into_stem``, ``_block``,
``folded_stem_pp``, ``folded_head`` and ``folded_forward(fused=False)``).

Every inference BatchNorm is folded into the conv before it
(``W' = W * gamma/sqrt(var+eps)``, ``b = beta - mean * gamma/sqrt(var+eps)``)
in float64 on the host, and the ``(x - MEAN_RGB) / STDDEV_RGB`` preprocess
is folded into the stem: the stem reads raw uint8 images, and a constant
correction map (the conv of the constant mean image) makes the fold exact
at the SAME-padding borders too.

Layout: the public surface keeps the JAX package's NHWC images and HWIO
folded weights, so tests compare like with like; the module itself runs
NCHW tensors in ``channels_last`` memory (what cuDNN wants) with OIHW
weights. TF "SAME" padding is asymmetric on stride-2 layers, so every
conv pads explicitly with ``F.pad`` instead of ``padding='same'``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fast_image_recognition_tpu_torch.models.efficientnet import (
    MEAN_RGB,
    STDDEV_RGB,
    block_plan,
)

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


def _same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """TF 'SAME': total = max((ceil(n/s)-1)*s + k - n, 0), low = total//2."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):  # F.pad order: W then H
        total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    if any(pads):
        x = F.pad(x, pads)
    return x


def _conv(x, w_oihw, b, stride: int = 1, groups: int = 1):
    x = _same_pad(x, w_oihw.shape[-1], stride)
    return F.conv2d(x, w_oihw, b, stride=stride, groups=groups)


def _oihw(w_hwio: torch.Tensor) -> torch.Tensor:
    w = w_hwio.permute(3, 2, 0, 1)
    return w.contiguous(memory_format=torch.channels_last)


def fold_preprocess_into_stem(
    folded: Dict[str, Any], resolution: int, dtype: torch.dtype = torch.bfloat16
) -> Dict[str, Any]:
    """Adds ``stem_pp_w`` (HWIO, scaled by 1/STD) and ``stem_pp_corr``
    ([1, R/2, R/2, C] fp32): conv((x-m)/s, W) == conv(x, W/s) - conv(m, W/s)."""
    std = torch.tensor(STDDEV_RGB, dtype=torch.float32)
    mean = torch.tensor(MEAN_RGB, dtype=torch.float32)
    w = folded["stem_w"].to(torch.float32)  # [3, 3, 3, C], dtype-rounded
    w_pp = w / std[None, None, :, None]
    const = mean[None, :, None, None].expand(1, 3, resolution, resolution)
    corr = _conv(const.contiguous(), w_pp.permute(3, 2, 0, 1).contiguous(), None, stride=2)
    out = dict(folded)
    out["stem_pp_w"] = w_pp.to(dtype)
    out["stem_pp_corr"] = corr.permute(0, 2, 3, 1).contiguous()  # NHWC fp32
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


class FoldedEfficientNet(nn.Module):
    """BN- and preprocess-folded EfficientNet forward on raw images.

    ``forward(images)``: uint8 (or 0..255 float) NHWC ``[B, R, R, 3]`` ->
    ``{'embedding': [B, F] fp32 pooled features, 'taps': {name: [B, C] fp32}}``.
    """

    def __init__(
        self,
        folded: Dict[str, Any],
        configs: List[Dict[str, Any]],
        resolution: int,
        taps: Sequence[str] = (),
    ):
        super().__init__()
        if "stem_pp_w" not in folded:
            raise ValueError("fold_preprocess_into_stem(...) first")
        self.resolution = int(resolution)
        self.dtype = folded["stem_pp_w"].dtype
        self.names = [c["name"] for c in configs]
        self.taps = tuple(taps)
        self.register_buffer("stem_w", _oihw(folded["stem_pp_w"]))
        self.register_buffer("stem_b", folded["stem_b"].clone())
        corr = folded["stem_pp_corr"].permute(0, 3, 1, 2).to(self.dtype)
        self.register_buffer("stem_corr", corr.contiguous(memory_format=torch.channels_last))
        self.blocks = nn.ModuleList(
            _FoldedBlock(p, c) for p, c in zip(folded["blocks"], configs)
        )
        self.register_buffer("head_w", _oihw(folded["head_w"]))
        self.register_buffer("head_b", folded["head_b"].clone())

    def forward(self, images: torch.Tensor) -> Dict[str, Any]:
        if images.shape[1] != self.resolution or images.shape[2] != self.resolution:
            raise ValueError(
                f"images are {tuple(images.shape[1:3])}, the folded stem "
                f"expects {self.resolution}x{self.resolution}"
            )
        # NHWC -> NCHW view: already channels_last in memory
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        h = _conv(x, self.stem_w, self.stem_b, stride=2) - self.stem_corr
        h = F.silu(h)
        taps: Dict[str, torch.Tensor] = {}
        for name, blk in zip(self.names, self.blocks):
            h = blk(h)
            if name in self.taps:
                taps[name] = h.to(torch.float32).mean(dim=(2, 3))
        h = F.silu(_conv(h, self.head_w, self.head_b))
        return {"embedding": h.to(torch.float32).mean(dim=(2, 3)), "taps": taps}
