"""PyTorch + CUDA port of ``fast_image_recognition_tpu`` for one H100: entry
points run on the card unless given ``device="cpu"``."""

from .device import default_device, resolve_device

__all__ = ["default_device", "resolve_device"]
