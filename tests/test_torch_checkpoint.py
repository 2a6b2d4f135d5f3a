"""The port's flax-free checkpoint decoder against flax's own loader.

Tolerance: none. Every leaf must come back bit-identical (same dtype, same
shape, same bytes); bfloat16 leaves, which numpy has no dtype for, come
back widened exactly to float32.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

from fast_image_recognition_tpu.utils.checkpoint import load_variables as jax_load
from fast_image_recognition_tpu_torch.utils import msgpack_lite
from fast_image_recognition_tpu_torch.utils.checkpoint import load_variables

CKPT = os.path.join(
    os.path.dirname(__file__), "..", "benchmarks", "trained_b0_224_synthetic1024_s0.npz"
)


def _assert_tree_equal(port, ref, path=""):
    if isinstance(ref, dict):
        assert isinstance(port, dict), path
        assert set(port) == set(ref), (path, set(port) ^ set(ref))
        for k in ref:
            _assert_tree_equal(port[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, np.ndarray) and ref.dtype == jnp.bfloat16:
        assert port.dtype == np.float32 and port.shape == ref.shape, path
        np.testing.assert_array_equal(port, ref.astype(np.float32), err_msg=path)
    elif isinstance(ref, np.ndarray):
        assert port.dtype == ref.dtype and port.shape == ref.shape, path
        np.testing.assert_array_equal(port, ref, err_msg=path)
    else:
        assert type(port) is type(ref) and port == ref, (path, port, ref)


def test_trained_b0_checkpoint_matches_flax_leaf_for_leaf():
    port = load_variables(CKPT)
    ref = jax_load(CKPT)
    assert set(port) == {"params", "batch_stats", "heads"}
    _assert_tree_equal(port, ref)


def _tiny_tree():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "long": rng.standard_normal((10, 30)).astype(np.float32),
        "f64": rng.standard_normal(5),
        "f16": rng.standard_normal((2, 2)).astype(np.float16),
        "bf16": np.asarray(jnp.asarray(rng.standard_normal(6), jnp.bfloat16)),
        "i8": np.array([-128, -1, 0, 127], np.int8),
        "u16": np.array([0, 65535], np.uint16),
        "i64": np.array([-(2**62), 2**62], np.int64),
        "bool": np.array([True, False]),
        "empty": np.zeros((0, 3), np.float32),
        "scalar": np.float32(1.5),
        "nested": {
            "deep": {"x": np.arange(7, dtype=np.int32)},
            "ints": [0, 127, 128, 255, 256, 65536, 2**32, 2**40, -1, -32, -33, -129, -(2**40)],
            "floats": [0.5, -2.25, 1e300],
            "text": "x" * 40,
            "flags": [True, False, None],
            "cplx": 1.5 - 2.0j,
        },
        "big": {str(i): np.full((i + 1,), i, np.int16) for i in range(20)},
    }


@pytest.mark.parametrize("chunk_limit", [None, 64])
def test_tiny_flax_tree_roundtrip(monkeypatch, chunk_limit):
    """Several dtypes, every msgpack int/str/array/map width, numpy scalars,
    complex numbers, and (with a small chunk limit) flax's chunked arrays."""
    if chunk_limit is not None:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk_limit)
    data = serialization.msgpack_serialize(_tiny_tree())
    if chunk_limit is not None:
        assert b"__msgpack_chunked_array__" in data
    _assert_tree_equal(msgpack_lite.msgpack_restore(data), serialization.msgpack_restore(data))


@pytest.mark.parametrize("bad", [b"\x92\x01", b"\xc1", b"\x01\x02"])
def test_malformed_msgpack_raises(bad):
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(bad)
