"""Device resolution for the port: the card by default, never the CPU on its
own (``default_device()`` raises without a GPU); tests pass ``device="cpu"``."""

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def _set_numerics() -> None:
    # fp32 means fp32, as on JAX's CPU: TF32 would flip near-tie rescores
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

