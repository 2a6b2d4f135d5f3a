"""Matmul and conv FLOPs of one call (JAX ``utils/flops.py``) by
``FlopCounterMode``; a ctypes kernel is opaque, as a Pallas call to JAX: count
its per-op twin."""

import torch


def fn_flops(fn, *args, **kwargs) -> float:
    """The FLOPs of ``fn(*args, **kwargs)``, run once under ``torch.no_grad()``."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as mode:
        fn(*args, **kwargs)
    return float(mode.get_total_flops())
