"""``topk_l2`` for k > 16 against JAX's (512 duplicate rows: ties to the lowest),
and the card kernels' argument rules. Tolerances: bf16 2^-12 relative, precise
2^-16 absolute, indices equal but at fp64 ties within that."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_image_recognition_tpu.ops.distance_kernel as J
import fast_image_recognition_tpu_torch.ops.distance_kernel as P
from fast_image_recognition_tpu_torch.kernels import build
from test_torch_synthetic import _one_thread, _unit  # noqa: F401

N, DIM, B = 4096, 64, 6
WINDOW = (5, 61)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    g = _unit(rng.standard_normal((N, DIM)))
    g[2048:2560] = g[:512]  # exact duplicates: rows r and r + 2048 tie
    q = _unit(g[rng.integers(0, 512, B)] + 0.5 * rng.standard_normal((B, DIM)) / np.sqrt(DIM))
    return q, g


def _rescored(q, g, rows, lo, hi):
    """float64 squared distances of ``rows`` [B, k] over lanes [lo, hi)."""
    d = g[rows][:, :, lo:hi] - q[:, None, lo:hi]
    return (d * d).sum(axis=2)


@pytest.mark.parametrize("mode", ["bf16", "precise", "window"])
@pytest.mark.parametrize("k", [17, 24, 40])
def test_topk_l2_large_k_matches_jax(data, k, mode):
    q, g = data
    kw = dict(precise=True) if mode == "precise" else dict(window=WINDOW) if mode == "window" else {}
    lo, hi = WINDOW if mode == "window" else (0, DIM)
    jd, ji = (np.asarray(x) for x in J.topk_l2(jnp.asarray(q), jnp.asarray(g, jnp.bfloat16), k, **kw))
    pd, pi = (x.numpy() for x in P.topk_l2(torch.from_numpy(q), torch.from_numpy(g).to(torch.bfloat16), k, **kw))
    check_topk(q, g, k, mode, (jd, ji), (pd, pi), (lo, hi), 2048, 2560)


def check_topk(q, g, k, mode, jax_out, port_out, lanes, dup0, dup1):
    """The port's top-k against JAX's: shapes, distinct rows in the gallery, sorted; distances within the mode's
    tolerance; rows that differ tie in fp64 within it; each row at its distance; a duplicate row in [dup0, dup1)
    of row r - dup0 comes after it."""
    (jd, ji), (pd, pi), (lo, hi) = jax_out, port_out, lanes
    assert pd.shape == pi.shape == (len(q), k) and pi.dtype == np.int32
    assert ((pi >= 0) & (pi < len(g))).all() and all(len(set(r)) == k for r in pi)
    assert (np.diff(pd, axis=1) >= 0).all()
    width = hi - lo
    # both sides scan bf16 rows; the bf16 mode's queries are bf16 too
    gb = torch.from_numpy(g).to(torch.bfloat16).double().numpy()
    qs = q.astype(np.float64) if mode == "precise" else torch.from_numpy(q).to(torch.bfloat16).double().numpy()
    if mode == "precise":
        tol = np.full_like(jd, 2.0**-16, dtype=np.float64)  # on the raw squared distance
        np.testing.assert_array_less(np.abs(pd - jd) * width, tol)
    else:
        tol = 2.0**-12 * np.abs(jd) * width
        np.testing.assert_allclose(pd, jd, rtol=2.0**-12, atol=0)
    dp, dj = _rescored(qs, gb, pi, lo, hi), _rescored(qs, gb, ji, lo, hi)
    differ = pi != ji
    assert (np.abs(dp - dj)[differ] <= tol[differ]).all()
    # every returned row sits at the distance returned for it
    assert (np.abs(dp - pd * width) <= np.maximum(tol, 1e-6)).all()
    # a duplicate ties with its original exactly: where one of them is
    # returned, the lower row is too, and comes first
    for row in pi:
        pos = {r: j for j, r in enumerate(row)}
        assert all(r - dup0 in pos and pos[r - dup0] < pos[r] for r in row if dup0 <= r < dup1)


def test_packed_scan_checks_take_any_width():
    """The packed scans take any Da % 16 == 0 (the queries stream through the ring above 640) and any tile count."""
    for da in (640, 768, 832, 1536):
        assert build.packed_scan_tiles((1024, da), (1024 * 1024, da), 1024) == 1024
    assert build.packed_scan_tiles((192, 768), (70_000 * 128, 768), 128) == 70_000
    for bad in [((8, 760), (1024, 760), 1024), ((8, 768), (1000, 768), 1024), ((8, 768), (1024, 640), 1024),
            ((8, 768), (1024, 768), 64)]:
        with pytest.raises(ValueError):
            build.packed_scan_tiles(*bad)


def test_tile_scan_checks_take_more_than_65535_tiles():
    assert build.tile_scan_tiles((1024, 128), (70_000 * 128, 128), 8, 128) == 70_000
    assert build.tile_scan_tiles((1, 16), (70_000 * 2048, 16), 16, 1024) == 140_000  # > 65,535 segments of 2,048
    assert build.tile_scan_tiles((64, 1536), (1024 * 1024, 1536), 16, 1024) == 1024
    with pytest.raises(ValueError):
        build.tile_scan_tiles((1, 16), (2**31, 16), 16, 1024)  # past int32 rows
    with pytest.raises(ValueError):
        build.tile_scan_tiles((1, 24), (1024, 24), 16, 1024)  # int8 rows of 16-byte vectors


def test_topk_checks_take_k_256_and_more_than_65535_segments():
    n = 65_536 * 2048 + 5  # 65,537 segments of 2,048 rows
    assert build.topk_l2_args((1024, 64), (n, 64), 256, n, None) == (0, 64)
    assert build.topk_l2_args((3, 64), (70_000, 64), 17, 70_000, (5, 61)) == (5, 61)
    for k in (0, build.TOPK_MAX_K + 1):
        with pytest.raises(ValueError):
            build.topk_l2_args((3, 64), (4096, 64), k, 4096, None)


@pytest.mark.parametrize("precise,k", [(False, 1), (False, 16), (False, 17), (True, 1), (True, build.TOPK_MAX_K)])
def test_topk_checks_stop_at_int32_rows_less_one_segment(precise, k):
    """The card-free rules refuse what the launcher refuses: rows past int32 less
    one segment (2,048 bf16 k <= 16, else 8,192)."""
    seg = build.topk_l2_segment_rows_for(precise, k)
    assert seg == (8192 if precise or k > 16 else 2048)
    n = 2**31 - 1 - seg
    assert build.topk_l2_args((4, 8), (n, 8), k, n, None, precise) == (0, 8)
    with pytest.raises(ValueError):
        build.topk_l2_args((4, 8), (n + 1, 8), k, n + 1, None, precise)
