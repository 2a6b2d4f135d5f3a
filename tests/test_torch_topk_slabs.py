"""``topk_l2`` in slabs above the last slab's floor: the plain pass at a small
slab width equals JAX's and one pass bit for bit (64 duplicate rows tie across
slabs). Tolerances: bf16 2^-12 relative, precise 2^-16 absolute, indices equal
but at fp64 ties."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_image_recognition_tpu.ops.distance_kernel as J
import fast_image_recognition_tpu_torch.ops.distance_kernel as P
from fast_image_recognition_tpu_torch.kernels import plain
from test_torch_synthetic import _one_thread, _unit  # noqa: F401
from test_torch_topk_large_k import check_topk

N, DIM, B = 320, 16, 3
SLAB = 64  # slab width of the CPU runs (the card's is build.TOPK_MAX_K, 256)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(23)
    g = _unit(rng.standard_normal((N, DIM)))
    g[256:320] = g[:64]  # exact duplicates: rows r and r + 256 tie
    q = _unit(g[rng.integers(0, 64, B)] + 0.5 * rng.standard_normal((B, DIM)) / np.sqrt(DIM))
    return q, g


def _port(q, g, k, monkeypatch, slab=SLAB, **kw):
    monkeypatch.setattr(P, "TOPK_SLAB", slab)
    d, i = P.topk_l2(torch.from_numpy(q), torch.from_numpy(g).to(torch.bfloat16), k, **kw)
    return d.numpy(), i.numpy()


@pytest.mark.parametrize("k,mode", [(300, "bf16"), (N, "precise")])
def test_topk_l2_slabs_match_jax(data, k, mode, monkeypatch):
    q, g = data
    kw = dict(precise=True) if mode == "precise" else {}
    jd, ji = (np.asarray(x) for x in J.topk_l2(jnp.asarray(q), jnp.asarray(g, jnp.bfloat16), k, **kw))
    check_topk(q, g, k, mode, (jd, ji), _port(q, g, k, monkeypatch, **kw), (0, DIM), 256, N)


@pytest.mark.parametrize("kw", [{}, dict(precise=True), dict(window=(3, 13))])
@pytest.mark.parametrize("k", [70, 300, N + 5])
def test_slabs_equal_the_single_pass(data, k, kw, monkeypatch):
    """Slabs of 64 = the single pass bit for bit, ties and the (BIG_DIST, -1) tail included."""
    q, g = data
    one = _port(q, g, k, monkeypatch, slab=k, **kw)
    slabs = _port(q, g, k, monkeypatch, **kw)
    np.testing.assert_array_equal(slabs[0], one[0])
    np.testing.assert_array_equal(slabs[1], one[1])
    if k > N:
        assert (one[1][:, N:] == -1).all()


def test_plain_floor_admits_only_entries_after_it(data):
    """With a floor, the entries strictly after it in (distance, row) order; an empty floor admits nothing."""
    q, g = data
    qt, gt = torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(g).to(torch.bfloat16)
    d, i = plain.topk_l2_plain(qt, gt, N)
    floor = (d[:, 99], i[:, 99])
    fd, fi = plain.topk_l2_plain(qt, gt, 50, floor=floor)
    assert torch.equal(fd, d[:, 100:150]) and torch.equal(fi, i[:, 100:150])
    empty = (torch.full((B,), plain.BIG_DIST), torch.full((B,), -1, dtype=torch.int32))
    ed, ei = plain.topk_l2_plain(qt, gt, 5, floor=empty)
    assert (ei == -1).all() and (ed == torch.tensor(plain.BIG_DIST, dtype=torch.float32)).all()
