"""The Hopper scans' plain versions at the kernels' tile edges against JAX's
interpret mode: top-k rtol 1e-3, indices but at 2^-12 ties; packed keys
2^-12 + 1e-6, rows but at such ties, certified sets but a tile swapped,
bounds 2^-12 and sound (<= the unscored rows' least distance x 1.03 + 1e-4);
int8 minima 2^-20 + 1e-8 (1.28e-6 raw: an FMA), rows but at fp64 ties."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_image_recognition_tpu.ops.distance_kernel as J
import fast_image_recognition_tpu_torch.ops.distance_kernel as P
from fast_image_recognition_tpu.ops.quant import quantize_rows as j_quantize
from fast_image_recognition_tpu_torch.ops.quant import quantize_rows
from test_torch_synthetic import _one_thread, _unit  # noqa: F401

REL = 2.0**-12


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).double().numpy()


def _data(n, n_valid, d, b, seed):
    """Unit rows and queries near rows of the gallery; the rows past n_valid are copies of the queries."""
    rng = np.random.default_rng(seed)
    g = _unit(rng.standard_normal((n, d)))
    q = _unit(g[rng.integers(0, n_valid, b)] + 0.3 * rng.standard_normal((b, d)) / np.sqrt(d))
    m = min(b, n - n_valid)
    g[n_valid : n_valid + m] = q[:m]
    return g, q


def _check_topk(q, g, n_valid, window, jd, ji, pd, pi):
    lo, hi = window if window is not None else (0, q.shape[1])
    assert pi.dtype == np.int32 and pi.shape == ji.shape
    assert ((pi >= 0) & (pi < n_valid)).all() and ((ji >= 0) & (ji < n_valid)).all()
    np.testing.assert_allclose(pd, jd, rtol=1e-3)
    qb, gb = _bf16(q)[:, lo:hi], _bf16(g)[:, lo:hi]
    d_port = ((qb[:, None, :] - gb[pi]) ** 2).sum(-1)
    d_jax = ((qb[:, None, :] - gb[ji]) ** 2).sum(-1)
    np.testing.assert_allclose(pd * (hi - lo), d_port, rtol=1e-3, atol=1e-5)
    assert ((pi == ji) | (np.abs(d_port - d_jax) <= REL * d_jax + 1e-7)).all()


# (rows, n_valid, D, B, k, window): the card's edge kinds, not their product (JAX compiles each shape)
TOPK_CASES = [(300, 100, 8, 1, 1, None), (300, 100, 8, 129, 16, (1, 7)), (700, 555, 40, 127, 3, (5, 37)),
    (700, 555, 40, 129, 1, (1, 39)), (700, 555, 40, 1, 16, None), (700, 555, 40, 128, 2, (8, 32))] + [
    (3072, 3000, 124, b, k, None) for b in (8, 130) for k in (1, 4, 16)]


@pytest.mark.parametrize("n, n_valid, d, b, k, window", TOPK_CASES)
def test_topk_l2_edges_match_jax(n, n_valid, d, b, k, window):
    g, q = _data(n, n_valid, d, b, seed=n + b + k)
    jd, ji = (np.asarray(x) for x in J.topk_l2(jnp.asarray(q), jnp.asarray(g, jnp.bfloat16), k, n_valid=n_valid,
            window=window))
    pd, pi = (x.numpy() for x in P.topk_l2(torch.from_numpy(q), torch.from_numpy(g).to(torch.bfloat16), k,
            n_valid=n_valid, window=window))
    _check_topk(q, g, n_valid, window, jd, ji, pd, pi)


@pytest.mark.parametrize("mask", ["empty", "first", "last", 64, 65, 128, 129])
def test_topk_l2_row_masks_match_jax(mask):
    """Row masks on 129 queries: masked-in rows JAX's answer, the rest empty."""
    n, n_valid, d, b, k = 700, 555, 40, 129, 3
    g, q = _data(n, n_valid, d, b, seed=11)
    jd, ji = (np.asarray(x) for x in J.topk_l2(jnp.asarray(q), jnp.asarray(g, jnp.bfloat16), k, n_valid=n_valid))
    on = np.zeros(b, dtype=bool)
    if mask == "first":
        on[0] = True
    elif mask == "last":
        on[-1] = True
    elif mask != "empty":
        on[:mask] = True
    pd, pi = (x.numpy() for x in P.topk_l2(torch.from_numpy(q), torch.from_numpy(g).to(torch.bfloat16), k,
            n_valid=n_valid, row_mask=torch.from_numpy(on)))
    assert (pi[~on] == -1).all() and (pd[~on] > 1e36).all()
    _check_topk(q[on], g, n_valid, None, jd[on], ji[on], pd[on], pi[on])


# (rows, n_valid, d, Da, B): Da 48 a ragged chunk; 900 of 2500 rows leaves two whole-pad tiles
MIN2_CASES = [(2500, 900, 40, 48, 1), (2500, 900, 40, 48, 129), (700, 555, 124, 128, 127), (700, 555, 124, 128, 128),
    (3000, 3000, 124, 128, 8), (3000, 3000, 124, 128, 130)]


@pytest.mark.parametrize("n, n_valid, d, da, b", MIN2_CASES)
def test_tile_min2_and_certificate_edges_match_jax(n, n_valid, d, da, b):
    g, q = _data(n, n_valid, d, b, seed=n + b)
    jaug = J.pack_gallery_aug(jnp.asarray(g, jnp.bfloat16), n_valid)[:, :da]
    paug = P.pack_gallery_aug(torch.from_numpy(g).to(torch.bfloat16), n_valid)[:, :da].contiguous()
    jd1, ji, jd2 = (np.asarray(x) for x in J.tile_min2_l2_packed(jnp.asarray(q), jaug, d))
    pd1, pi, pd2 = (x.numpy() for x in P.tile_min2_l2_packed(torch.from_numpy(q), paug, d))
    np.testing.assert_allclose(pd1, jd1, rtol=REL, atol=1e-6)
    np.testing.assert_allclose(pd2, jd2, rtol=REL, atol=1e-6)
    whole_pad = np.arange(pd1.shape[1]) * 1024 >= n_valid
    assert (pi[:, ~whole_pad] < n_valid).all() and (pd1[:, whole_pad] > 1e37).all()
    # a tile's best row may differ only at a near-tie of the bf16 values
    qb, gb = _bf16(q), _bf16(g)
    rows = np.minimum(pi, n - 1), np.minimum(ji, n - 1)
    d_port, d_jax = (((qb[:, None, :] - gb[r]) ** 2).sum(-1) for r in rows)
    real = ~whole_pad[None, :]
    assert (((pi == ji) | (np.abs(d_port - d_jax) <= REL * d_jax + 1e-6)) | ~real).all()

    r = 2 if whole_pad.sum() else 1  # fewer candidates than tiles with a valid row
    jc, jb = (np.asarray(x) for x in J.topk_candidates_l2_packed_cert(jnp.asarray(q), jaug, d, r))
    pc, pb = (x.numpy() for x in P.topk_candidates_l2_packed_cert(torch.from_numpy(q), paug, d, r))
    np.testing.assert_allclose(pb, jb, rtol=REL)
    for row in range(b):
        if set(pc[row]) != set(jc[row]):
            kth = np.sort(jd1[row])[r - 1 : r + 1]
            assert kth[1] - kth[0] <= REL * kth[1] + 1e-6
        # sound: the bound exceeds the true unscored minimum by no more than bf16 operand rounding
        unscored = np.setdiff1d(np.arange(n_valid), pc[row])
        assert pb[row] <= ((q[row] - g[unscored]) ** 2).sum(-1).min() * 1.03 + 1e-4


# (rows, n_valid, d, Da, B, tile_g): tile_g 256 and 512, whole-pad tiles past n_valid
SINGLE_CASES = [(1100, 700, 40, 48, 1, 256), (1100, 700, 124, 128, 129, 256), (1100, 700, 40, 48, 192, 256),
    (1100, 700, 124, 128, 1, 512), (1100, 700, 40, 48, 129, 512), (1100, 700, 124, 128, 192, 512)]


@pytest.mark.parametrize("n, n_valid, d, da, b, tile_g", SINGLE_CASES)
def test_tile_min_packed_edges_match_jax(n, n_valid, d, da, b, tile_g):
    g, q = _data(n, n_valid, d, b, seed=n + b + tile_g)
    jaug = J.pack_gallery_aug(jnp.asarray(g, jnp.bfloat16), n_valid, tile_g)[:, :da]
    paug = P.pack_gallery_aug(torch.from_numpy(g).to(torch.bfloat16), n_valid, tile_g)[:, :da].contiguous()
    jd, ji = (np.asarray(x) for x in J.tile_min_l2_packed(jnp.asarray(q), jaug, d, tile_g=tile_g))
    pd, pi = (x.numpy() for x in P.tile_min_l2_packed(torch.from_numpy(q), paug, d, tile_g))
    assert pi.dtype == np.int32 and pd.shape == pi.shape == (b, paug.shape[0] // tile_g)
    np.testing.assert_allclose(pd, jd, rtol=REL, atol=1e-6)
    whole_pad = np.arange(pd.shape[1]) * tile_g >= n_valid
    assert whole_pad.any() and (pi[:, ~whole_pad] < n_valid).all() and (pd[:, whole_pad] > 1e35).all()
    # a tile's best row may differ only at a near-tie of the bf16 values
    qb, gb = _bf16(q), _bf16(g)
    rows = np.minimum(pi, n - 1), np.minimum(ji, n - 1)
    d_port, d_jax = (((qb[:, None, :] - gb[r]) ** 2).sum(-1) for r in rows)
    assert ((pi == ji) | (np.abs(d_port - d_jax) <= REL * d_jax + 1e-6) | whole_pad[None, :]).all()


# (rows, n_valid, D, B, tile_g): D 16 and 144 (ragged lines), B 1 and 129, tile_g 128 and 1024
QUANT_CASES = [(1100, 700, 16, 1, 128), (1100, 700, 16, 129, 1024), (1100, 700, 144, 129, 128),
    (1100, 700, 144, 1, 1024)]
QUANT_REL = 2.0**-20


@pytest.mark.parametrize("n, n_valid, d, b, tile_g", QUANT_CASES)
def test_tile_min_quant_int8_edges_match_jax(n, n_valid, d, b, tile_g):
    g, q = _data(n, n_valid, d, b, seed=n + d + b)
    gp = np.zeros((-(-n // tile_g) * tile_g, d), np.float32)
    gp[:n] = g
    jg, pg = jnp.asarray(gp, jnp.bfloat16), torch.from_numpy(gp).to(torch.bfloat16)
    (jq, js), (pq, ps) = j_quantize(jg), quantize_rows(pg)
    j_assets = (jq, J.gallery_sq_norms(jg, n_valid, tile_g), J.quant_gallery_scales(js, n_valid, tile_g))
    p_assets = (pq, P.gallery_sq_norms(pg, n_valid, tile_g), P.quant_gallery_scales(ps, n_valid, tile_g))
    jd, ji = (np.asarray(x) for x in J.tile_min_l2_quant(jnp.asarray(q), *j_assets, tile_g=tile_g, compute="int8"))
    pd, pi = (x.numpy() for x in P.tile_min_l2_quant(torch.from_numpy(q), *p_assets, tile_g=tile_g, compute="int8"))
    n_tiles = gp.shape[0] // tile_g
    assert pi.dtype == np.int32 and pd.shape == pi.shape == (b, n_tiles)
    np.testing.assert_allclose(pd * d, jd * d, rtol=QUANT_REL, atol=1e-8 * 128)
    # whole-pad tiles: the pad score 3.4e38 at the tile's first row
    whole_pad = np.arange(n_tiles) * tile_g >= n_valid
    first = (np.arange(n_tiles) * tile_g)[None, whole_pad]
    assert whole_pad.any() and (pi[:, whole_pad] == first).all() and (ji[:, whole_pad] == first).all()
    assert (pi[:, ~whole_pad] < n_valid).all() and (pd[:, whole_pad] > 1e36).all()
    # each row's int8 score, recomputed in float64 from the same operands
    qv, qs = (a.numpy().astype(np.float64) for a in quantize_rows(torch.from_numpy(q)))
    gv = pq.numpy().astype(np.float64)
    gsq, gsc = (a.numpy().reshape(-1).astype(np.float64) for a in p_assets[1:])

    def score(rows):
        return gsq[rows] - 2.0 * qs[:, None] * np.einsum("bd,btd->bt", qv, gv[rows]) * gsc[rows]

    assert ((pi == ji) | (np.abs(score(pi) - score(ji)) <= QUANT_REL * np.abs(score(ji)) + 1e-6)).all()
