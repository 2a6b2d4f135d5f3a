"""Symmetric int8 row quantization for the gallery match path (the port's
own copy of ``fast_image_recognition_tpu/ops/quant.py``).

Per-row symmetric absmax: ``values[i] = round(x[i] / s[i])`` clipped to
[-127, 127], with ``s[i] = max|x[i]| / 127`` (1 for an all-zero row).
Rounding is half-to-even, as ``jnp.round`` does, so values and scales are
bit-equal to the JAX package's on the same rows. The int8 scans keep the
true ``|g|^2`` (computed before quantization), so only the cross term is
approximate.
"""

from __future__ import annotations

from typing import Tuple

import torch

# rows quantized per step: bounds the fp32 temporaries on a 1M-row gallery
_CHUNK_ROWS = 65536


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization: (values int8 [N, D], scales
    fp32 [N]) with ``values[i] * scales[i] ~= x[i]``. Works through the
    rows in chunks, so a bf16 gallery never has a whole fp32 copy."""
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
