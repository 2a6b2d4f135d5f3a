"""The many-class synthetic image dataset (JAX ``data/synthetic_images.py``),
NumPy only, bit-equal to JAX's for the same arguments."""

from typing import Tuple

import numpy as np


def _class_prototypes(num_classes: int, res: int, rng: np.random.Generator, waves: int = 6) -> np.ndarray:
    """[C, res, res, 3] in [0, 1], under ~6 cycles an image."""
    yy, xx = np.meshgrid(np.linspace(0.0, 1.0, res, dtype=np.float32), np.linspace(0.0, 1.0, res, dtype=np.float32),
            indexing="ij")
    protos = np.zeros((num_classes, res, res, 3), np.float32)
    for c in range(num_classes):
        img = np.zeros((res, res, 3), np.float32)
        for ch in range(3):
            fx = rng.uniform(-6.0, 6.0, waves).astype(np.float32)
            fy = rng.uniform(-6.0, 6.0, waves).astype(np.float32)
            ph = rng.uniform(0, 2 * np.pi, waves).astype(np.float32)
            amp = rng.uniform(0.4, 1.0, waves).astype(np.float32)
            img[..., ch] = np.tensordot(np.sin(2.0 * np.pi * (fx[:, None, None] * xx + fy[:, None, None] * yy)
                    + ph[:, None, None]), amp, axes=(0, 0))
        img -= img.min()
        img /= max(img.max(), 1e-6)
        protos[c] = img * rng.uniform(0.6, 1.0, 3).astype(np.float32)
    return protos


def _affine_sample(proto: np.ndarray, angle: float, scale: float, tx: float, ty: float) -> np.ndarray:
    """Inverse-mapped affine warp, bilinear, reflect padding."""
    r = proto.shape[0]
    c = (r - 1) / 2.0
    yy, xx = np.meshgrid(np.arange(r, dtype=np.float32), np.arange(r, dtype=np.float32), indexing="ij")
    ca, sa = np.cos(angle), np.sin(angle)
    xs = ((xx - c - tx) * ca + (yy - c - ty) * sa) / scale + c
    ys = (-(xx - c - tx) * sa + (yy - c - ty) * ca) / scale + c
    x0, y0 = np.floor(xs).astype(np.int64), np.floor(ys).astype(np.int64)
    wx, wy = (xs - x0)[..., None], (ys - y0)[..., None]

    def at(yi, xi):
        yi, xi = np.abs(yi), np.abs(xi)
        yi = np.where(yi >= r, 2 * (r - 1) - yi, yi).clip(0, r - 1)
        xi = np.where(xi >= r, 2 * (r - 1) - xi, xi).clip(0, r - 1)
        return proto[yi, xi]

    top = at(y0, x0) * (1 - wx) + at(y0, x0 + 1) * wx
    bot = at(y0 + 1, x0) * (1 - wx) + at(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def make_synthetic_image_dataset(num_classes: int = 128, per_class: int = 60, res: int = 112, seed: int = 0,
        max_rotate: float = 0.44, scale_range: Tuple[float, float] = (0.8, 1.2),
        max_shift: float = 0.1, noise_lo: float = 0.0,
        noise_hi: float = 0.25) -> Tuple[np.ndarray, np.ndarray]:
    """(images [C * per, res, res, 3] uint8, labels int64), grouped by class."""
    rng = np.random.default_rng(seed)
    protos = _class_prototypes(num_classes, res, rng)
    images = np.empty((num_classes * per_class, res, res, 3), np.uint8)
    labels = np.repeat(np.arange(num_classes, dtype=np.int64), per_class)
    for i in range(len(images)):
        img = _affine_sample(protos[i // per_class], angle=rng.uniform(-max_rotate, max_rotate),
                scale=rng.uniform(*scale_range), tx=rng.uniform(-max_shift, max_shift) * res,
                ty=rng.uniform(-max_shift, max_shift) * res)
        bright, contrast = rng.uniform(-0.1, 0.1), rng.uniform(0.85, 1.15)
        img = (img - 0.5) * contrast + 0.5 + bright
        img = img + rng.normal(0.0, rng.uniform(noise_lo, noise_hi), img.shape).astype(np.float32)
        images[i] = (img.clip(0.0, 1.0) * 255.0).astype(np.uint8)
    return images, labels


def split_synthetic_image_dataset(images: np.ndarray, labels: np.ndarray, train_per_class: int,
        seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(train_idx, val_idx): a shuffled split a class."""
    rng = np.random.default_rng(seed)
    tr, va = [], []
    for c in np.unique(labels):
        idx = rng.permutation(np.nonzero(labels == c)[0])
        tr.append(idx[:train_per_class])
        va.append(idx[train_per_class:])
    return np.concatenate(tr), np.concatenate(va)
