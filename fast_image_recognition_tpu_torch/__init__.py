"""PyTorch + CUDA port of ``fast_image_recognition_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference; this package imports
neither it nor JAX. Entry points run on the card unless the caller passes
``device="cpu"``; on a CPU tensor every kernel wrapper runs its plain
PyTorch version (``kernels/plain.py``), on a CUDA tensor it launches the
hand-written kernel (``kernels/*.cu``) or raises.
"""

from fast_image_recognition_tpu_torch.device import default_device, resolve_device

__all__ = ["default_device", "resolve_device"]
