"""Procedural texture images rendered on the device (counterpart of
``fast_image_recognition_tpu/data/synthetic_device.py``).

Class prototypes are band-limited sums of 2-D sinusoids; an affine warp of
a prototype composes with the sinusoid argument, so every instance is
evaluated analytically at its warped coordinates (no gathers, no
interpolation). Per-class parameters come from the same numpy stream as
the JAX package (``make_class_params`` is a verbatim copy), so a class seed
names the same textures in both packages. Per-instance draws (warp,
brightness, contrast, noise) come from a ``torch.Generator``; they differ
from JAX's threefry draws, so the two packages agree on the distribution
of instances, not on each instance.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fast_image_recognition_tpu_torch.device import DeviceLike, resolve_device

_TWO_PI = 2.0 * math.pi


def make_class_params(num_classes: int, seed: int = 0, waves: int = 6) -> Dict[str, np.ndarray]:
    """Per-class texture parameters, host-side (tiny); the draw order is
    the JAX package's, bit for bit."""
    rng = np.random.default_rng(seed)
    C, W = num_classes, waves
    fx = np.empty((C, 3, W), np.float32)
    fy = np.empty((C, 3, W), np.float32)
    ph = np.empty((C, 3, W), np.float32)
    amp = np.empty((C, 3, W), np.float32)
    cast = np.empty((C, 3), np.float32)
    for c in range(C):
        for ch in range(3):
            fx[c, ch] = rng.uniform(-6.0, 6.0, W).astype(np.float32)
            fy[c, ch] = rng.uniform(-6.0, 6.0, W).astype(np.float32)
            ph[c, ch] = rng.uniform(0, 2 * np.pi, W).astype(np.float32)
            amp[c, ch] = rng.uniform(0.4, 1.0, W).astype(np.float32)
        cast[c] = rng.uniform(0.6, 1.0, 3).astype(np.float32)
    return {"fx": fx, "fy": fy, "ph": ph, "amp": amp, "cast": cast}


def _proto_norms(params: Dict[str, torch.Tensor], res: int, chunk: int = 32):
    """[C] (lo, inv_scale): joint min and 1/(max - min) of each unwarped
    prototype rendered at ``res``."""
    dev = params["fx"].device
    u = torch.linspace(0.0, 1.0, res, dtype=torch.float32, device=dev)
    vv, uu = torch.meshgrid(u, u, indexing="ij")  # v = rows, u = cols
    los, his = [], []
    for s in range(0, params["fx"].shape[0], chunk):
        p = {k: params[k][s : s + chunk, :, :, None, None] for k in ("fx", "fy", "ph", "amp")}
        arg = _TWO_PI * (p["fx"] * uu + p["fy"] * vv) + p["ph"]  # [c, 3, W, res, res]
        img = (torch.sin(arg) * p["amp"]).sum(dim=2)  # [c, 3, res, res]
        los.append(img.amin(dim=(1, 2, 3)))
        his.append(img.amax(dim=(1, 2, 3)))
    lo, hi = torch.cat(los), torch.cat(his)
    return lo, 1.0 / torch.clamp_min(hi - lo, 1e-6)


def _render_batch(per: Dict[str, torch.Tensor], noise: torch.Tensor, res: int, waves: int) -> torch.Tensor:
    """Batched render. ``per``: [B]-leading instance + class parameters;
    ``noise``: [B, 3, res, res]. Returns uint8 NHWC [B, res, res, 3]."""
    dev = noise.device
    c = (res - 1) / 2.0
    ar = torch.arange(res, dtype=torch.float32, device=dev)
    xx = ar[None, None, :]  # [1, 1, res]: column coordinate
    yy = ar[None, :, None]  # [1, res, 1]: row coordinate

    def s(v):
        return v[:, None, None]

    def w4(v):
        return v[:, :, None, None]

    def s4(v):
        return v[:, None, None, None]

    ca, sa = torch.cos(s(per["angle"])), torch.sin(s(per["angle"]))
    inv = 1.0 / s(per["scale"])
    tx, ty = s(per["tx"]), s(per["ty"])
    xs = ((xx - c - tx) * ca + (yy - c - ty) * sa) * inv + c
    ys = (-(xx - c - tx) * sa + (yy - c - ty) * ca) * inv + c
    us = (xs / (res - 1))[:, None]  # [B, 1, res, res] texture coordinates
    vs = (ys / (res - 1))[:, None]
    img = torch.zeros(noise.shape, dtype=torch.float32, device=dev)
    for w in range(waves):
        arg = _TWO_PI * (w4(per["fx"][:, :, w]) * us + w4(per["fy"][:, :, w]) * vs) + w4(per["ph"][:, :, w])
        img = img + w4(per["amp"][:, :, w]) * torch.sin(arg)
    img = (img - s4(per["lo"])) * s4(per["inv_scale"])
    img = img * w4(per["cast"])
    img = (img - 0.5) * s4(per["contrast"]) + 0.5
    img = img + s4(per["bright"])
    img = img + s4(per["namp"]) * noise
    img = (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)
    return img.permute(0, 2, 3, 1).contiguous()


def make_render_fn(
    params: Dict[str, np.ndarray],
    res: int,
    device: DeviceLike = None,
    max_rotate: float = 0.44,
    scale_range: Tuple[float, float] = (0.8, 1.2),
    max_shift: float = 0.1,
    noise_lo: float = 0.0,
    noise_hi: float = 0.25,
):
    """Returns ``render(class_ids [B] int64 tensor, generator) -> uint8
    [B, res, res, 3]`` on ``device``."""
    dev = resolve_device(device)
    pd = {k: torch.as_tensor(v, device=dev) for k, v in params.items()}
    lo, inv_scale = _proto_norms(pd, res)
    waves = int(params["fx"].shape[-1])

    def uniform(b, lo_, hi_, gen):
        return torch.rand(b, generator=gen, device=dev) * (hi_ - lo_) + lo_

    @torch.no_grad()
    def render(class_ids: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        b = class_ids.shape[0]
        per = {
            "angle": uniform(b, -max_rotate, max_rotate, gen),
            "scale": uniform(b, scale_range[0], scale_range[1], gen),
            "tx": uniform(b, -max_shift, max_shift, gen) * res,
            "ty": uniform(b, -max_shift, max_shift, gen) * res,
            "bright": uniform(b, -0.1, 0.1, gen),
            "contrast": uniform(b, 0.85, 1.15, gen),
            "namp": uniform(b, noise_lo, noise_hi, gen),
        }
        noise = torch.randn((b, 3, res, res), generator=gen, device=dev)
        for k in ("fx", "fy", "ph", "amp", "cast"):
            per[k] = pd[k][class_ids]
        per["lo"] = lo[class_ids]
        per["inv_scale"] = inv_scale[class_ids]
        return _render_batch(per, noise, res, waves)

    return render


def device_dataset(
    num_classes: int,
    per_class: int,
    res: int,
    seed: int = 0,
    chunk: int = 256,
    class_seed: Optional[int] = None,
    device: DeviceLike = None,
    **aug,
):
    """(images uint8 [C*per, res, res, 3] on ``device``, labels np int64),
    class-major. ``class_seed`` names the textures, ``seed`` the instances."""
    dev = resolve_device(device)
    params = make_class_params(num_classes, seed if class_seed is None else class_seed)
    render = make_render_fn(params, res, device=dev, **aug)
    labels = np.repeat(np.arange(num_classes, dtype=np.int64), per_class)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = torch.empty((labels.shape[0], res, res, 3), dtype=torch.uint8, device=dev)
    for s in range(0, labels.shape[0], chunk):
        ids = torch.as_tensor(labels[s : s + chunk], device=dev)
        out[s : s + chunk] = render(ids, gen)
    return out, labels
