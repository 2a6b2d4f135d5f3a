"""PyTorch + CUDA port of ``fast_image_recognition_tpu`` for one H100, without
JAX. Entry points run on the card unless given ``device="cpu"``; a kernel
wrapper runs its plain version (``kernels/plain.py``) on a CPU tensor."""

from fast_image_recognition_tpu_torch.device import default_device, resolve_device

__all__ = ["default_device", "resolve_device"]
