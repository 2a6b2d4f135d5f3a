"""Symmetric per-row int8 quantization (JAX ``ops/quant.py``), bit-equal: ``round(x
/ s)`` half-to-even in [-127, 127], ``s = max|x| / 127`` (1 for a zero row)."""

from typing import Tuple

import torch

# rows a step: bounds the fp32 temporaries
_CHUNK_ROWS = 65536


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 [N, D], scales [N]) with ``values[i] * scales[i] ~= x[i]``, in chunks (no fp32 copy)."""
    n = x.shape[0]
    values = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((n,), dtype=torch.float32, device=x.device)
    for s in range(0, n, _CHUNK_ROWS):
        xf = x[s : s + _CHUNK_ROWS].to(torch.float32)
        absmax = xf.abs().amax(dim=1)
        sc = torch.where(absmax > 0, absmax / 127.0, 1.0)
        values[s : s + _CHUNK_ROWS] = torch.clamp(torch.round(xf / sc[:, None]), -127, 127).to(torch.int8)
        scales[s : s + _CHUNK_ROWS] = sc
    return values, scales


def dequantize_rows(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` (fp32)."""
    return values.to(torch.float32) * scales[:, None]
