"""chi2 1-NN over the window (JAX ``ops/chi2_kernel.py``): ``kernels/chi2.cu`` on
a CUDA tensor, ``plain.chi2_nn_plain`` on a CPU one; ``refine=True`` rescores
each winner exactly, as JAX."""

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels import build, plain
from .distance_kernel import _on_card

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
    """(distances / D, rows) over rows [0, n_valid) on ``device``."""
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
