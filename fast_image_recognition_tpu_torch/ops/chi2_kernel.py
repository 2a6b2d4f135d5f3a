"""Chi-square 1-NN over the full feature window (counterpart of
``fast_image_recognition_tpu/ops/chi2_kernel.py::chi2_nn``).

The reference's chi-square distance (qt_cpp/db_features.cpp:27-32,
``sum (a-b)^2/(a+b)`` normalized by the window width) has no matmul form:
one reciprocal per (query, row, feature) triple pins it to the card's
special-function units. On a CUDA tensor the scan is one launch of the
hand-written kernel ``kernels/chi2.cu`` (approximate reciprocal, gallery
read at its storage width, every query block in one grid); on a CPU
tensor it is the plain version ``kernels/plain.py::chi2_nn_plain`` (exact
division). Either way the winner is the lowest row at the least sum, and
``refine=True`` rescores each winner with the exact fp32 formula in plain
PyTorch, as the JAX package does outside its kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from fast_image_recognition_tpu_torch.device import DeviceLike, resolve_device
from fast_image_recognition_tpu_torch.kernels import build, plain
from fast_image_recognition_tpu_torch.ops.distance_kernel import _on_card

ArrayLike = Union[torch.Tensor, np.ndarray]


def chi2_nn(
    queries: ArrayLike,  # [B, D] fp32
    gallery: ArrayLike,  # [N, D] fp32 or bf16
    *,
    n_valid: Optional[int] = None,
    tile_g: int = 256,
    refine: bool = True,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """chi-square 1-NN over rows [0, n_valid): (distances [B] fp32 divided
    by D, the reference's window normalization, db_features.cpp:40; rows
    [B] int32).

    Tensors are scanned where they lie; host data (numpy), or any input
    when ``device`` is given, is moved to ``device``, which defaults to
    the card. ``tile_g`` is the plain version's gallery rows per step (the
    kernel tiles by 64 rows); the answer does not depend on it. Without
    ``refine`` the distance is the scan's own: the kernel's approximate
    reciprocal is up to 1 ulp off per term."""
    if device is not None or not (torch.is_tensor(queries) and torch.is_tensor(gallery)):
        dev = resolve_device(device)
        queries = torch.as_tensor(queries, device=dev)
        gallery = torch.as_tensor(gallery, device=dev)
    if gallery.dtype not in (torch.float32, torch.bfloat16):
        gallery = gallery.to(torch.float32)
    q32 = queries.to(torch.float32).contiguous()
    gallery = gallery.contiguous()
    b, d = q32.shape
    n = int(gallery.shape[0])
    n_valid = n if n_valid is None else min(int(n_valid), n)
    if n_valid < 1 or tile_g < 1:
        raise ValueError(f"chi2_nn needs n_valid >= 1 and tile_g >= 1, got n_valid={n_valid}, tile_g={tile_g}")
    if _on_card(q32):
        dist, idx = build.launch_chi2(q32, gallery, n_valid)
    else:
        dist, idx = plain.chi2_nn_plain(q32, gallery, n_valid, tile_rows=tile_g)
    if refine:
        rows = gallery[idx.long()].to(torch.float32)
        s = rows + q32
        diff = rows - q32
        dist = torch.where(s > 0, diff * diff / torch.where(s > 0, s, 1.0), 0.0).sum(dim=1)
    return dist / d, idx
