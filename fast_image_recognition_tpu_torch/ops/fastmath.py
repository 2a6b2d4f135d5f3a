"""Fast math approximations (counterpart of
``fast_image_recognition_tpu/ops/fastmath.py``).

``fasterlog2`` is the bit-hack log2 approximation the reference uses for the
FPNN log-density sums (qt_cpp/classification.cpp:64-79, Paul Mineiro's
fastapprox family). The torch version reads the fp32 bits as an unsigned
32-bit integer (``int32`` widened to ``int64`` and masked, since bits at or
above 2^31 read negative in ``int32``) and rounds every step to fp32, so it
matches ``fasterlog2_np`` bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

_C0, _C1, _C2, _C3 = 124.22544637, 1.498030302, 1.72587999, 0.3520887068


def fasterlog2(x: torch.Tensor) -> torch.Tensor:
    """Elementwise fp32 approximation of log2(x) on ``x``'s device;
    classification.cpp:64-73."""
    x = torch.as_tensor(x).to(torch.float32)
    bits = x.view(torch.int32)
    m = ((bits & 0x007FFFFF) | (0x7E << 23)).view(torch.float32)
    y = (bits.to(torch.int64) & 0xFFFFFFFF).to(torch.float32) * (1.0 / (1 << 23))

    def c(v):  # an fp32 constant, as the reference's float literals
        return torch.tensor(v, dtype=torch.float32, device=x.device)

    return y - c(_C0) - c(_C1) * m - c(_C2) / (c(_C3) + m)


def fasterlog2_np(x: np.ndarray) -> np.ndarray:
    """NumPy oracle for fasterlog2 (same bit manipulation)."""
    x = np.asarray(x, dtype=np.float32)
    bits = x.view(np.uint32)
    mantissa_bits = (bits & np.uint32(0x007FFFFF)) | np.uint32(0x7E << 23)
    m = mantissa_bits.view(np.float32)
    y = bits.astype(np.float32) * np.float32(1.0 / (1 << 23))
    return (
        y
        - np.float32(_C0)
        - np.float32(_C1) * m
        - np.float32(_C2) / (np.float32(_C3) + m)
    ).astype(np.float32)
