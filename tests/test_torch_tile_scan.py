"""The bf16 tile scan and top-k against JAX's interpret mode: fp32 scores
minima 2^-20 (+1e-6 after |q|^2), rows but at ties; bf16 scores equal, ties
low, and where JAX keeps fp32 excess and its ``_masked_argmin`` wraps, a row
of that tile at the minimum; ``precise=True`` 2^-20 + 1e-7; ``window`` the
same, outside lanes zeroed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_image_recognition_tpu.ops.distance_kernel as J
import fast_image_recognition_tpu_torch.ops.distance_kernel as P
from test_torch_synthetic import _one_thread, _unit  # noqa: F401


N_VALID, N_PAD, DIM, B = 2900, 3072, 64, 24
F32_REL = 2.0**-20


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    g = _unit(rng.standard_normal((N_VALID, DIM)))
    q = _unit(g[rng.integers(0, N_VALID, B)] + 0.3 * rng.standard_normal((B, DIM)) / np.sqrt(DIM))
    # padded past n_valid to 3072 rows: tiles of 128 end with a ragged
    # tile (2816..2943, 84 valid rows) and a whole pad tile (2944..3071)
    gp = np.zeros((N_PAD, DIM), np.float32)
    gp[:N_VALID] = g
    return q, g, gp


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).double().numpy()


@pytest.mark.parametrize("precise_scores", [True, False])
@pytest.mark.parametrize("tile_g", [128, 1024])
def test_tile_min_l2_matches_jax(data, precise_scores, tile_g):
    q, _, gp = data
    jd, ji = (np.asarray(x) for x in J.tile_min_l2(jnp.asarray(q), jnp.asarray(gp, jnp.bfloat16), n_valid=N_VALID,
            tile_g=tile_g, precise_scores=precise_scores))
    pd, pi = (x.numpy() for x in P.tile_min_l2(torch.from_numpy(q), torch.from_numpy(gp).to(torch.bfloat16),
            n_valid=N_VALID, tile_g=tile_g, precise_scores=precise_scores))
    n_tiles = N_PAD // tile_g
    assert pd.shape == pi.shape == (B, n_tiles) and pi.dtype == np.int32
    tiles = np.arange(n_tiles)[None, :] * tile_g
    assert ((pi >= tiles) & (pi < tiles + tile_g)).all()
    if tile_g == 128:  # the whole pad tile: BIG_DIST (fp32) or inf (bf16)
        assert (pi[:, -1] == N_PAD - 128).all()
        assert (np.isinf(pd[:, -1]) if not precise_scores else pd[:, -1] > 1e36).all()
        np.testing.assert_array_equal(np.isinf(pd), np.isinf(jd))
        assert (pi[:, -2] < N_VALID).all()  # n_valid inside the ragged tile
    fin = np.isfinite(jd)
    # the score the port's row has, recomputed from the bf16 operands
    qb, gb = _bf16(q), _bf16(gp)
    gsq = (gb * gb).sum(1)
    s_port = gsq[pi] - 2.0 * np.einsum("bd,btd->bt", qb, gb[pi])
    qsq = (q.astype(np.float64) ** 2).sum(1)[:, None]
    if precise_scores:
        np.testing.assert_allclose(pd[fin], jd[fin], rtol=F32_REL, atol=1e-6)
        valid = fin & (pi < N_VALID)
        np.testing.assert_allclose(((s_port + qsq) / DIM)[valid], pd[valid], rtol=F32_REL, atol=1e-6)
        s_jax = gsq[ji] - 2.0 * np.einsum("bd,btd->bt", qb, gb[ji])
        assert ((pi == ji) | (np.abs(s_port - s_jax) <= F32_REL * np.abs(s_jax) + 1e-6)).all()
    else:
        # equal minima; |q|^2 ~ 1, summed in another order, adds an ulp
        # of 1 (2^-23), left at ~2e-9 by the division by D
        np.testing.assert_allclose(pd[fin], jd[fin], rtol=F32_REL, atol=1e-8)
        ok = (ji >= tiles) & (ji < tiles + tile_g)  # JAX found its row
        np.testing.assert_array_equal(pi[ok], ji[ok])
        assert ok.mean() > 0.9
        # where JAX found none, the port's row scores the reported minimum
        # in bf16 (|g|^2 and 2 q.g rounded, then their difference)
        r16 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()  # noqa: E731
        s16 = r16(r16(gsq[pi]) - r16(2.0 * np.einsum("bd,btd->bt", qb, gb[pi])))
        valid = ~ok & (pi < N_VALID)
        np.testing.assert_allclose((s16 + qsq)[valid] / DIM, pd[valid], rtol=F32_REL, atol=1e-8)


@pytest.mark.parametrize("precise_scores", [True, False])
def test_topk_candidates_l2_matches_jax(data, precise_scores):
    """R = 5 of 24 tiles with a given ``gsq``: the same rows but a tile swapped at a near-tie."""
    q, _, gp = data
    r, tile_g = 5, 128
    jg = jnp.asarray(gp, jnp.bfloat16)
    pg = torch.from_numpy(gp).to(torch.bfloat16)
    jgsq = J.gallery_sq_norms(jg, N_VALID, tile_g)
    pgsq = P.gallery_sq_norms(pg, N_VALID, tile_g)
    jc = np.asarray(J.topk_candidates_l2(jnp.asarray(q), jg, r, n_valid=N_VALID, tile_g=tile_g, gsq=jgsq,
            precise_scores=precise_scores))
    pc = P.topk_candidates_l2(torch.from_numpy(q), pg, r, n_valid=N_VALID, tile_g=tile_g, gsq=pgsq,
            precise_scores=precise_scores).numpy()
    assert pc.shape == (B, r) and pc.dtype == np.int32 and (pc < N_VALID).all()
    jd = np.asarray(J.tile_min_l2(jnp.asarray(q), jg, n_valid=N_VALID, tile_g=tile_g, precise_scores=precise_scores)[0])
    for b in range(B):
        if (pc[b] // tile_g).tolist() != (jc[b] // tile_g).tolist():
            kth = np.sort(jd[b])[r - 1 : r + 1]  # the swapped tiles tie
            assert kth[1] - kth[0] <= 2.0**-8 * kth[1]
    same_tiles = (pc // tile_g == jc // tile_g).all(1)
    assert same_tiles.mean() > 0.9
    if precise_scores:
        assert (pc == jc)[same_tiles].mean() > 0.99


@pytest.mark.parametrize("gal_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("window", [None, (8, 40)])
def test_topk_l2_precise_and_window_match_jax(data, gal_dtype, window):
    q, g, _ = data
    k = 4
    jnp_dt, t_dt = (jnp.bfloat16, torch.bfloat16) if gal_dtype == "bf16" else (jnp.float32, torch.float32)
    jg = jnp.asarray(g, jnp_dt)
    pg = torch.from_numpy(g).to(t_dt)
    jd, ji = (np.asarray(x) for x in J.topk_l2(jnp.asarray(q), jg, k, n_valid=N_VALID, window=window, precise=True))
    pd, pi = (x.numpy() for x in P.topk_l2(torch.from_numpy(q), pg, k, n_valid=N_VALID, window=window, precise=True))
    assert pi.dtype == np.int32 and pi.shape == (B, k)
    lo, hi = window or (0, DIM)
    np.testing.assert_allclose(pd, jd, rtol=F32_REL, atol=1e-7)
    # the stored rows (bf16 values or fp32) against the fp32 queries
    gs = pg.double().numpy()[:, lo:hi]
    qs = q.astype(np.float64)[:, lo:hi]
    d_port = ((qs[:, None, :] - gs[pi]) ** 2).sum(-1) / (hi - lo)
    d_jax = ((qs[:, None, :] - gs[ji]) ** 2).sum(-1) / (hi - lo)
    np.testing.assert_allclose(pd, d_port, rtol=1e-5, atol=1e-7)
    assert ((pi == ji) | (np.abs(d_port - d_jax) <= F32_REL * d_jax + 1e-7)).all()


def test_topk_l2_window_bf16_and_row_mask(data):
    """bf16 with a window = JAX's (rtol 1e-3); ``row_mask`` empties the rows it leaves out."""
    q, g, _ = data
    jg = jnp.asarray(g, jnp.bfloat16)
    pg = torch.from_numpy(g).to(torch.bfloat16)
    jd, ji = (np.asarray(x) for x in J.topk_l2(jnp.asarray(q), jg, 2, n_valid=N_VALID, window=(16, 48)))
    pd, pi = (x.numpy() for x in P.topk_l2(torch.from_numpy(q), pg, 2, n_valid=N_VALID, window=(16, 48)))
    np.testing.assert_allclose(pd, jd, rtol=1e-3)
    qb, gb = _bf16(q)[:, 16:48], _bf16(g)[:, 16:48]
    d_port = ((qb[:, None, :] - gb[pi]) ** 2).sum(-1)
    d_jax = ((qb[:, None, :] - gb[ji]) ** 2).sum(-1)
    assert ((pi == ji) | (np.abs(d_port - d_jax) <= 2.0**-12 * d_jax + 1e-7)).all()
    mask = torch.from_numpy(np.arange(B) % 3 == 0)
    md, mi = P.topk_l2(torch.from_numpy(q), pg, 2, n_valid=N_VALID, window=(16, 48), row_mask=mask)
    m = mask.numpy()
    np.testing.assert_array_equal(mi.numpy()[m], pi[m])
    assert (mi.numpy()[~m] == -1).all() and (md.numpy()[~m] > 1e36).all()
    with pytest.raises(ValueError):
        P.topk_l2(torch.from_numpy(q), pg, 1, precise=True, row_mask=mask)
    with pytest.raises(ValueError):
        P.topk_l2(torch.from_numpy(q), pg, 1, window=(40, 40))


@pytest.mark.parametrize("scan", ["tile_min_l2", "topk_l2", "topk_l2_precise", "tile_min_l2_quant"])
def test_scans_take_a_column_padded_gallery(data, scan):
    """A gallery padded once by ``pad_cols`` (60 -> 64) answers as the unpadded
    one: rows equal, distances 2^-20 relative + 1e-7; other widths refused."""
    q, _, gp = data
    d = 60
    qt = torch.from_numpy(q[:, :d].copy())
    g = torch.from_numpy(gp[:, :d].copy()).to(torch.bfloat16)
    gpad = P.pad_cols(g)
    assert gpad.shape == (N_PAD, 64) and not gpad[:, d:].any()

    def run(gal):
        if scan == "tile_min_l2":
            return P.tile_min_l2(qt, gal, n_valid=N_VALID, tile_g=128)
        if scan.startswith("topk_l2"):
            return P.topk_l2(qt, gal, 3, n_valid=N_VALID, precise=scan.endswith("precise"))
        gq, sc = P.quantize_rows(gal)
        return P.tile_min_l2_quant(qt, gq, P.gallery_sq_norms(gal, N_VALID, 128),
                P.quant_gallery_scales(sc, N_VALID, 128), tile_g=128)

    (d0, i0), (d1, i1) = run(g), run(gpad)
    np.testing.assert_array_equal(i1.numpy(), i0.numpy())
    np.testing.assert_allclose(d1.numpy(), d0.numpy(), rtol=F32_REL, atol=1e-7)
    with pytest.raises(ValueError, match="do not fit"):
        run(P.pad_cols(g, 128))
