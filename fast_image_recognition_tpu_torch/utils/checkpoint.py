"""Checkpoint loading without flax (counterpart of
``fast_image_recognition_tpu/utils/checkpoint.py`` ``load_variables``)."""

from __future__ import annotations

from typing import Any

from fast_image_recognition_tpu_torch.utils.msgpack_lite import msgpack_restore


def load_variables(path: str) -> Any:
    """Flax-msgpack checkpoint -> nested dicts of numpy arrays, leaf for
    leaf what the JAX package's ``load_variables(path)`` returns."""
    with open(path, "rb") as fh:
        return msgpack_restore(fh.read())
