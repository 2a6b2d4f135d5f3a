"""The int8 path against JAX's: ``quantize_rows`` bit-equal; norms 2^-20,
scales equal; ``tile_min_l2_quant`` minima 2^-20 + 1e-8, rows but where JAX
contracts an FMA and rows tie within 2^-20; candidates but a tile swapped at
such a tie, rescored 2^-20 + 1e-8."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_image_recognition_tpu.ops.distance_kernel as J
import fast_image_recognition_tpu_torch.ops.distance_kernel as P
from fast_image_recognition_tpu.ops.quant import dequantize_rows as j_dequantize
from fast_image_recognition_tpu.ops.quant import quantize_rows as j_quantize
from fast_image_recognition_tpu_torch.ops.quant import dequantize_rows, quantize_rows
from test_torch_synthetic import _one_thread, _unit  # noqa: F401


N_VALID, N_PAD, DIM, B = 2900, 3072, 128, 24
REL = 2.0**-20


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    g = _unit(rng.standard_normal((N_VALID, DIM)))
    q = _unit(g[rng.integers(0, N_VALID, B)] + 0.3 * rng.standard_normal((B, DIM)) / np.sqrt(DIM))
    gp = np.zeros((N_PAD, DIM), np.float32)
    gp[:N_VALID] = g
    jg = jnp.asarray(gp, jnp.bfloat16)
    pg = torch.from_numpy(gp).to(torch.bfloat16)
    jq, js = j_quantize(jg)
    pq, ps = quantize_rows(pg)
    j_assets = (jq, J.gallery_sq_norms(jg, N_VALID), J.quant_gallery_scales(js, N_VALID))
    p_assets = (pq, P.gallery_sq_norms(pg, N_VALID), P.quant_gallery_scales(ps, N_VALID))
    return q, (jg, pg), j_assets, p_assets, (js, ps)


def test_quantize_rows_bit_equal():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 40)).astype(np.float32)
    x[3] = 0.0  # all-zero row: scale 1, values 0
    # exact halves: x / s lands on k + 0.5 (s = 1 when the absmax is 127)
    x[5] = np.float32(0.0)
    x[5, :4] = [127.0, 0.5, 1.5, -2.5]
    x[6] = rng.standard_normal(40).astype(np.float32) * 1e-30  # tiny scale
    jv, js = (np.asarray(a) for a in j_quantize(jnp.asarray(x)))
    pv, ps = (a.numpy() for a in quantize_rows(torch.from_numpy(x)))
    assert pv.dtype == np.int8 and ps.dtype == np.float32
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(ps.view(np.int32), js.view(np.int32))
    np.testing.assert_array_equal(pv[5, :4], [127, 0, 2, -2])  # half to even
    assert ps[3] == 1.0 and (pv[3] == 0).all()
    np.testing.assert_array_equal(dequantize_rows(torch.from_numpy(pv), torch.from_numpy(ps)).numpy(),
        np.asarray(j_dequantize(jnp.asarray(jv), jnp.asarray(js))))
    # a bf16 gallery, chunked on the port's side, gives the same values
    gb = torch.from_numpy(x).to(torch.bfloat16)
    jv2, js2 = (np.asarray(a) for a in j_quantize(jnp.asarray(x, jnp.bfloat16)))
    pv2, ps2 = (a.numpy() for a in quantize_rows(gb))
    np.testing.assert_array_equal(pv2, jv2)
    np.testing.assert_array_equal(ps2, js2)


@pytest.mark.parametrize("tile_g", [128, 1024])
def test_gallery_layouts_match_jax(data, tile_g):
    _, (jg, pg), _, _, (js, ps) = data
    jn = np.asarray(J.gallery_sq_norms(jg, N_VALID, tile_g))
    pn = P.gallery_sq_norms(pg, N_VALID, tile_g).numpy()
    assert pn.shape == jn.shape == (-(-(N_PAD // tile_g) // 8) * 8, tile_g)
    np.testing.assert_allclose(pn, jn, rtol=REL)
    assert (pn.reshape(-1)[N_VALID:] == np.float32(3.4e38)).all()
    jsc = np.asarray(J.quant_gallery_scales(js, N_VALID, tile_g))
    psc = P.quant_gallery_scales(ps, N_VALID, tile_g).numpy()
    np.testing.assert_array_equal(psc, jsc)
    assert (psc.reshape(-1)[N_VALID:] == 0).all()


@pytest.mark.parametrize("compute", ["int8", "bf16"])
def test_tile_min_l2_quant_matches_jax(data, compute):
    q, _, j_assets, p_assets, _ = data
    jd, ji = (np.asarray(x) for x in J.tile_min_l2_quant(jnp.asarray(q), *j_assets, compute=compute))
    pd, pi = (x.numpy() for x in P.tile_min_l2_quant(torch.from_numpy(q), *p_assets, compute=compute))
    assert pd.shape == pi.shape == (B, N_PAD // 1024) and pi.dtype == np.int32
    np.testing.assert_allclose(pd, jd, rtol=REL, atol=1e-8)
    # each row's int8 score, recomputed in float64 from the same operands
    qv, qs = (a.numpy().astype(np.float64) for a in quantize_rows(torch.from_numpy(q)))
    gv = p_assets[0].numpy().astype(np.float64)
    gsq, gsc = (a.numpy().reshape(-1).astype(np.float64) for a in p_assets[1:])

    def score(rows):
        return gsq[rows] - 2.0 * qs[:, None] * np.einsum("bd,btd->bt", qv, gv[rows]) * gsc[rows]

    assert ((pi == ji) | (np.abs(score(pi) - score(ji)) <= REL * np.abs(score(ji)) + 1e-6)).all()
    assert (pi == ji).mean() > 0.95


@pytest.mark.parametrize("compute", ["int8", "bf16"])
def test_topk_l2_quant_and_candidates_match_jax(data, compute):
    q, (jg, pg), j_assets, p_assets, _ = data
    tile_g = 1024  # the int8 assets' tiles; 3 tiles, so r caps at 3
    jc = np.asarray(J.topk_candidates_l2_quant(jnp.asarray(q), *j_assets, 2, compute=compute))
    pc = P.topk_candidates_l2_quant(torch.from_numpy(q), *p_assets, 2, compute=compute).numpy()
    assert pc.shape == (B, 2) and pc.dtype == np.int32
    jd_t = np.asarray(J.tile_min_l2_quant(jnp.asarray(q), *j_assets, compute=compute)[0])
    swapped = (pc // tile_g != jc // tile_g).any(1)
    for b in np.nonzero(swapped)[0]:
        kth = np.sort(jd_t[b])[1:3]
        assert kth[1] - kth[0] <= REL * kth[1] + 1e-8
    jd, ji = (np.asarray(x) for x in J.topk_l2_quant(jnp.asarray(q), *j_assets, jg, k=2, r=16, compute=compute))
    pd, pi = (x.numpy() for x in P.topk_l2_quant(torch.from_numpy(q), *p_assets, pg, k=2, r=16, compute=compute))
    assert pi.shape == (B, 2) and pi.dtype == np.int32
    same = (pi == ji).all(1)
    assert same.mean() > 0.95
    np.testing.assert_allclose(pd[same], jd[same], rtol=REL, atol=1e-8)
    # the rescored distances are the bf16 rows' true distances to the
    # bf16-rounded queries
    qb = torch.from_numpy(q).to(torch.bfloat16).double().numpy()
    gb = pg.double().numpy()
    np.testing.assert_allclose(pd, ((qb[:, None, :] - gb[pi]) ** 2).sum(-1) / DIM, rtol=1e-5, atol=1e-8)
