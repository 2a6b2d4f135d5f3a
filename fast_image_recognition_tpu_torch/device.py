"""Device resolution for the port: the card by default, never the CPU on its
own (``default_device()`` raises without a GPU); tests pass ``device="cpu"``."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def _set_numerics() -> None:
    # The JAX CPU reference computes fp32 products in true fp32; TF32 would
    # keep ~3 decimal digits and flip near-tie rescores. Convolutions follow
    # the same rule so a float32 model means float32 on the card too.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def default_device() -> torch.device:
    """The card (``cuda``); raises when none is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run the port's plain PyTorch path"
        )
    _set_numerics()
    return torch.device("cuda")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> :func:`default_device`; anything else as given."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
        _set_numerics()
    return dev

