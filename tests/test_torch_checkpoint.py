"""The flax-free checkpoint codec against flax's and JAX's: every leaf
bit-identical (bfloat16 widened exactly to float32); the writer gives flax's
bytes."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import fast_image_recognition_tpu.utils.checkpoint as J
from fast_image_recognition_tpu.utils.checkpoint import load_variables as jax_load
from fast_image_recognition_tpu_torch.utils import checkpoint as P
from fast_image_recognition_tpu_torch.utils import msgpack_lite
from fast_image_recognition_tpu_torch.utils.checkpoint import load_variables

CKPT = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "trained_b0_224_synthetic1024_s0.npz")


def _assert_tree_equal(port, ref, path=""):
    if isinstance(ref, dict):
        assert isinstance(port, dict), path
        assert set(port) == set(ref), (path, set(port) ^ set(ref))
        for k in ref:
            _assert_tree_equal(port[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert type(port) is type(ref) and len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _assert_tree_equal(a, b, f"{path}/{i}")
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
    return {"f32": rng.standard_normal((3, 4)).astype(np.float32), "long": rng.standard_normal((10,
            30)).astype(np.float32), "f64": rng.standard_normal(5), "f16": rng.standard_normal((2,
            2)).astype(np.float16), "bf16": np.asarray(jnp.asarray(rng.standard_normal(6), jnp.bfloat16)),
            "i8": np.array([-128, -1, 0, 127], np.int8), "u16": np.array([0, 65535], np.uint16),
            "i64": np.array([-(2**62), 2**62], np.int64), "bool": np.array([True, False]), "empty": np.zeros((0, 3),
            np.float32), "scalar": np.float32(1.5), "nested": {"deep": {"x": np.arange(7, dtype=np.int32)}, "ints": [0,
            127, 128, 255, 256, 65536, 2**32, 2**40, -1, -32, -33, -129, -(2**40)], "floats": [0.5, -2.25, 1e300],
            "text": "x" * 40, "flags": [True, False, None], "cplx": 1.5 - 2.0j}, "big": {str(i): np.full((i + 1,), i,
            np.int16) for i in range(20)}}


@pytest.mark.parametrize("chunk_limit", [None, 64])
def test_tiny_flax_tree_roundtrip(monkeypatch, chunk_limit):
    """dtypes, every msgpack width, numpy scalars, complex, and (small chunk limit) chunked arrays."""
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


def test_port_writes_what_flax_writes(tmp_path):
    """Lists, fp32, int32, bf16 (a tensor): flax's bytes, read by JAX; JAX's file
    read by the port, lists restored by a template."""
    bf = torch.randn(6).to(torch.bfloat16)
    tree = {"params": {"w": np.arange(12, dtype=np.float32).reshape(3, 4), "i": np.arange(5, dtype=np.int32)},
            "heads": [{"w": np.ones((2, 3), np.float32), "b": bf}, {"w": np.zeros((2, 3), np.float32), "b": bf}],
            "n": 3, "x": 0.5}
    jtree = dict(tree, heads=[dict(h, b=jnp.asarray(bf.float().numpy(), jnp.bfloat16)) for h in tree["heads"]])
    P.save_variables(str(tmp_path / "port.msgpack"), tree)
    assert (tmp_path / "port.msgpack").read_bytes() == serialization.to_bytes(jtree)
    _assert_tree_equal(load_variables(str(tmp_path / "port.msgpack")), jax_load(str(tmp_path / "port.msgpack")))
    J.save_variables(str(tmp_path / "jax.msgpack"), jtree)
    got = P.load_variables(str(tmp_path / "jax.msgpack"), template=tree)
    assert isinstance(got["heads"], list)
    _assert_tree_equal(got, J.load_variables(str(tmp_path / "jax.msgpack"), template=jtree))


def test_oversized_array_raises(monkeypatch):
    monkeypatch.setattr(msgpack_lite, "MAX_CHUNK_SIZE", 64)
    with pytest.raises(ValueError, match="chunk size"):
        msgpack_lite.to_bytes({"a": np.zeros(17, np.float32)})


def test_best_checkpoint_early_stopping_ema_and_cache(tmp_path):
    seq = [0.5, 0.7, 0.6, 0.7, 0.9, 0.8, 0.8, 0.85]
    for mode in ("max", "min"):
        pb, jb = P.BestCheckpoint(str(tmp_path / "p"), mode), J.BestCheckpoint(str(tmp_path / "j"), mode)
        ps, js = P.EarlyStopping(2, mode), J.EarlyStopping(2, mode)
        for i, m in enumerate(seq):
            v = {"step": np.array([i], np.int32)}
            assert pb.update(m, v) == jb.update(m, v) and ps.update(m) == js.update(m)
            assert (pb.best, ps.best, ps.bad_epochs) == (jb.best, js.best, js.bad_epochs)
        assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()
    f32 = np.float32
    e, p = {"a": np.ones(3, f32), "b": [np.zeros(2, f32)]}, {"a": np.arange(3, dtype=f32), "b": [np.ones(2, f32)]}
    _assert_tree_equal(P.ema_update(e, p, 0.9), jax.tree_util.tree_map(np.asarray, J.ema_update(e, p, 0.9)))
    levels, labels = [np.ones((2, 3), np.float32), np.zeros((2, 5), np.float32)], np.array([1, 0])
    P.EmbeddingCache(str(tmp_path / "c"), "net").save("_t", levels, labels)
    assert J.EmbeddingCache(str(tmp_path / "c"), "net").exists("_t")
    for (a, la), (b, lb) in [(P.EmbeddingCache(str(tmp_path / "c"), "net").load("_t"),
         J.EmbeddingCache(str(tmp_path / "c"), "net").load("_t"))]:
        assert la.tolist() == lb.tolist() and all(np.array_equal(x, y) for x, y in zip(a, b)) and len(a) == 2
