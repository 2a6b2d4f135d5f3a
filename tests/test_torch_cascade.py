"""``CascadeRecognitionService`` and its single-min scan against JAX's: scan
distances 2^-12 relative, rows but at such ties; readouts on JAX's features
1e-3, on the port's 5e-2 (bf16); rows, levels, forced exits equal but where
``ratio^2 * d2 - d1`` is within 2^-8 d1 of 0 or rows tie within 2^-8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_image_recognition_tpu.ops.distance_kernel as J
import fast_image_recognition_tpu_torch.ops.distance_kernel as P
from fast_image_recognition_tpu.models import backbone_info as jax_info
from fast_image_recognition_tpu.serving import CascadeRecognitionService as JaxCascade
from fast_image_recognition_tpu.serving import _grid_pool as jax_grid_pool
from fast_image_recognition_tpu_torch.kernels import plain
from fast_image_recognition_tpu_torch.models.efficientnet import backbone_info
from fast_image_recognition_tpu_torch.serving import (CascadeRecognitionService, _grid_pool, _solve_readouts,
    build_cascade_service, make_tap_embed_fn)
from test_torch_synthetic import _one_thread, jax_b0  # noqa: F401


RES = 32
REL = 2.0**-12
TIE = 2.0**-8


def _unit(x):
    x = np.asarray(x, np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-30)


@pytest.fixture(scope="module")
def weights():
    return jax_b0(RES)


# the single-min packed scan


@pytest.mark.parametrize("tile_g", [128, 1024])
@pytest.mark.parametrize("d", [40, 124])
def test_tile_min_packed_and_candidates_match_jax(tile_g, d):
    n_valid, b, r = 2900, 24, 6  # n_valid is no tile multiple
    rng = np.random.default_rng(tile_g + d)
    g = _unit(rng.standard_normal((n_valid, d)))
    q = _unit(g[rng.integers(0, n_valid, b)] + 0.4 * rng.standard_normal((b, d)) / np.sqrt(d))
    jaug = J.pack_gallery_aug(J.pad_gallery(jnp.asarray(g, jnp.bfloat16)), n_valid, tile_g=tile_g)
    paug = P.pack_gallery_aug(P.pad_gallery(torch.from_numpy(g).to(torch.bfloat16)), n_valid, tile_g=tile_g)
    np.testing.assert_array_equal(paug.float().numpy()[:, :d], np.asarray(jaug.astype(jnp.float32))[:, :d])
    n_tiles = 3072 // tile_g
    assert paug.shape == (3072, 128)

    # raw keys: the plain version against the Pallas kernel's
    qa = P._augment_queries(torch.from_numpy(q), d, 128)
    pk = plain.tilemin_packed_plain(qa, paug, tile_g).numpy()
    jk = np.asarray(J._tilemin_packed_block(jnp.pad(J._augment_queries(jnp.asarray(q), d, 128), ((0, 128 - b), (0, 0))),
        jaug, d, tile_g, True)).T[:b]
    assert pk.shape == jk.shape == (b, n_tiles)
    assert (pk == jk).mean() > 0.9

    jd, ji = (np.asarray(x) for x in J.tile_min_l2_packed(jnp.asarray(q), jaug, d, tile_g=tile_g))
    pd, pi = (x.numpy() for x in P.tile_min_l2_packed(torch.from_numpy(q), paug, d, tile_g))
    assert pi.dtype == np.int32
    np.testing.assert_allclose(pd, jd, rtol=REL, atol=1e-7)
    # rows differ only at 2^-12 ties of the shared bf16 values' distances
    qb = torch.from_numpy(q).to(torch.bfloat16).double().numpy()
    gb = np.concatenate([torch.from_numpy(g).to(torch.bfloat16).double().numpy(), np.full((3072 - n_valid, d), 9.0)])
    dist = ((qb[:, None, :] - gb[None]) ** 2).sum(-1)
    dp, dj = np.take_along_axis(dist, pi, 1), np.take_along_axis(dist, ji, 1)
    assert ((pi == ji) | (np.abs(dp - dj) <= REL * dj + 1e-7)).all()
    if tile_g == 128:  # rows 2944.. form a whole pad tile: its best is a pad row
        assert (pi[:, -1] >= n_valid).all()

    jc = np.asarray(J.topk_candidates_l2_packed(jnp.asarray(q), jaug, d, r, tile_g=tile_g))
    pc = P.topk_candidates_l2_packed(torch.from_numpy(q), paug, d, r, tile_g).numpy()
    assert pc.shape == jc.shape == (b, min(r, n_tiles))
    for row in range(b):
        if set(pc[row]) != set(jc[row]):
            kth = np.sort(jd[row])[r - 1 : r + 1]  # the tiles swapped at a near-tie
            assert kth[1] - kth[0] <= REL * kth[1] + 1e-7
    # select='approx' is the exact selection in both packages off the TPU
    ja = np.asarray(J.topk_candidates_l2_packed(jnp.asarray(q), jaug, d, r, tile_g=tile_g, select="approx"))
    pa = P.topk_candidates_l2_packed(torch.from_numpy(q), paug, d, r, tile_g, select="approx").numpy()
    np.testing.assert_array_equal(ja, jc)
    np.testing.assert_array_equal(pa, pc)
    with pytest.raises(ValueError):
        P.topk_candidates_l2_packed(torch.from_numpy(q), paug, d, r, tile_g, select="nope")
    with pytest.raises(ValueError):
        P.pack_gallery_aug(torch.from_numpy(g), n_valid, tile_g=64)


def test_tilemin_packed_plain_ties_and_pads():
    """Equal rows: the lower row wins (keys order by (distance, row)); pad rows (|g|^2 = 1e38) never win."""
    rng = np.random.default_rng(1)
    base = _unit(rng.standard_normal((4, 60)))
    g = np.concatenate([base, base])  # rows i and i+4 identical, one tile
    paug = P.pack_gallery_aug(P.pad_gallery(torch.from_numpy(g).to(torch.bfloat16)), 8, tile_g=128)
    qa = P._augment_queries(torch.from_numpy(base[[2, 0]]), 60, 128)
    keys = plain.tilemin_packed_plain(qa, paug, 128)
    assert keys.shape == (2, 8)
    np.testing.assert_array_equal((keys[:, 0] & 127).numpy(), [2, 0])
    assert ((keys[:, 1:] & ~127).view(torch.float32) > 1e37).all()


def test_grid_pool_matches_jax():
    rng = np.random.default_rng(2)
    h = rng.standard_normal((3, 7, 9, 5)).astype(np.float32)  # NHWC, odd sizes crop
    for g in (1, 2, 4):
        ref = np.asarray(jax_grid_pool(jnp.asarray(h), g))
        got = _grid_pool(torch.from_numpy(h).permute(0, 3, 1, 2), g).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


# readout mode (the recipe of tests/test_cascade_serving.py)

R_BATCH, R_GAL = 16, 512
R_KW = dict(resolution=RES, pca_dim=32, rescore=8, pca_sample=256, calib_total=64, calib_batch=32)


@pytest.fixture(scope="module")
def readout(weights):
    model, variables, np_vars = weights
    rng = np.random.default_rng(0)
    images = (rng.random((R_BATCH, RES, RES, 3)) * 255).astype(np.uint8)
    embed = make_tap_embed_fn(np_vars, backbone_info("b0"), RES, device="cpu")
    emb = embed(torch.from_numpy(images))[1].numpy()
    gal = _unit(rng.normal(size=(R_GAL, emb.shape[1])))
    true_idx = rng.choice(R_GAL, size=R_BATCH, replace=False)
    gal[true_idx] = emb
    js = JaxCascade(model, variables, jax_info("b0"), gal, **R_KW)
    ps = build_cascade_service("b0", gal, variables=np_vars, device="cpu", **R_KW)
    return js, ps, images, gal, true_idx, emb


def _packed(svc, images, caps=None, jax_side=False):
    out = svc.identify_device(images if jax_side else torch.from_numpy(images), caps)
    out = np.asarray(out) if jax_side else out.numpy()
    b = (len(out) - 1) // 2
    return out[:b], out[b : 2 * b], int(out[-1])


def test_readout_fit_matches_jax(readout):
    js, ps, *_ = readout
    assert ps.mode == js.mode == "readout" and ps.num_levels == js.num_levels == 3
    assert ps.segments == js.segments and ps._tile_g == js._tile_g == 128
    # JAX's calibration pass recorded: the same noise images and its features
    seen = []
    fwd = js._tap_forward_jit()
    js._tap_fwd = lambda folded, imgs: seen.append((np.asarray(imgs), fwd(folded, imgs))) or seen[-1][1]
    try:
        js._fit_readouts(None, 64, 32, 1e-3, 17)
    finally:
        js._tap_fwd = fwd
    rng = np.random.default_rng(17)
    for imgs, _ in seen:
        np.testing.assert_array_equal(rng.integers(0, 255, imgs.shape, np.int64).astype(np.uint8), imgs)
    feats = [np.concatenate([np.asarray(f[j]) for _, (f, _) in seen]) for j in range(2)]
    emb = np.concatenate([np.asarray(e) for _, (_, e) in seen])
    for mine, ref, own in zip(_solve_readouts(feats, emb, 1e-3), js._readouts, ps._readouts):
        ref = np.asarray(ref)
        assert np.abs(mine - ref).max() <= 1e-3 * np.abs(ref).max()
        assert np.linalg.norm(own.numpy() - ref) <= 5e-2 * np.linalg.norm(ref)


def test_readout_identify_matches_jax(readout):
    """Random weights: nothing fires, every probe gets its planted row at the last level."""
    js, ps, images, gal, true_idx, _ = readout
    ji, _, jst = js.identify(images)
    pi, plab, pst = ps.identify(images)
    assert plab is None
    np.testing.assert_array_equal(pi, true_idx)
    np.testing.assert_array_equal(pi, ji)
    assert pst == jst == {"break_counts": [0.0, 0.0, 1.0], "forced_fraction": 0.0}


def test_readout_capacity_overflow_matches_jax(readout):
    """Capacities (16, 4, 4): the same 12 probes forced out at level 0 with the same rows, on JAX's readouts."""
    js, ps, images, gal, true_idx, _ = readout
    own = ps._readouts
    ps._readouts = [torch.from_numpy(np.array(a)) for a in js._readouts]
    try:
        jp, jl, jf = _packed(js, images, (16, 4, 4), jax_side=True)
        pp, pl, pf = _packed(ps, images, (16, 4, 4))
    finally:
        ps._readouts = own
    assert pf == jf == R_BATCH - 4
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_array_equal(np.bincount(pl, minlength=3), [12, 0, 4])
    # a forced row differs only at a near-tie of the level-0 prediction
    moved = pp != jp
    if moved.any():
        with torch.no_grad():
            net = ps.net
            h = net.run_blocks(net.stem(torch.from_numpy(images)), *ps.segments[0])
            e = ps._level_embedding(0, h).numpy()
        dj = ((e - gal[jp]) ** 2).sum(1)
        dp = ((e - gal[pp]) ** 2).sum(1)
        assert (np.abs(dp - dj)[moved] <= TIE * dj[moved]).all()


def test_readout_calibrate_matches_jax(readout):
    js, ps, images, *_ = readout
    assert ps.calibrate(images, slack=1.2) == js.calibrate(images, slack=1.2) == [1.0, 1.0]
    assert ps.capacities_for(R_BATCH) == js.capacities_for(R_BATCH) == (16, 16, 16)
    assert ps.survivor_fractions == [1.0, 1.0]
    assert ps.capacities_for(1024) == js.capacities_for(1024) == (1024, 256, 256)


# level mode: a planted layout with exits at every level

L_TAPS = ["block3a", "block4a", "block5c"]
L_PROBES, L_VALID = 16, 1500  # 4 levels, 4 probes per exit level; tile_g 128


def _level_layout(feats):
    """Row-aligned galleries (3 taps + final): probe p's row r_p (label p) and twin t_p (100 + p) in another
    tile hold its embedding before level p // 4 (d1 = d2: no exit), r_p alone after."""
    rng = np.random.default_rng(3)
    r = 90 * np.arange(L_PROBES) + 7
    t = (r + 700) % L_VALID  # never an r row, always another 128-row tile
    labels = 1000 + np.arange(L_VALID)
    labels[r], labels[t] = np.arange(L_PROBES), 100 + np.arange(L_PROBES)
    gals = []
    for level, f in enumerate(feats):
        g = _unit(rng.standard_normal((L_VALID, f.shape[1])))
        g[r] = _unit(f)
        twin = np.arange(L_PROBES) // 4 > level
        g[t[twin]] = _unit(f[twin])
        gals.append(g)
    return gals, labels, r


@pytest.fixture(scope="module")
def level(weights):
    model, variables, np_vars = weights
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (L_PROBES, RES, RES, 3)).astype(np.uint8)
    embed = make_tap_embed_fn(np_vars, backbone_info("b0"), RES, L_TAPS, device="cpu")
    feats, emb = embed(torch.from_numpy(images))
    gals, labels, planted = _level_layout([f.numpy() for f in feats] + [emb.numpy()])
    return model, variables, np_vars, images, gals, labels, planted


def _level_kw(level, d2_rule):
    *_, gals, labels, _ = level
    return dict(labels=labels, resolution=RES, taps=L_TAPS, galleries=gals[:-1], d2_rule=d2_rule, rescore=8, ratio=0.85)


def _level_port(level, d2_rule):
    _, _, np_vars, _, gals, *_ = level
    return CascadeRecognitionService(np_vars, backbone_info("b0"), gals[-1], device="cpu", **_level_kw(level, d2_rule))


def test_level_mode_matches_jax(level):
    """Both ``d2_rule``s on one pair of services (JAX's compiled programs dropped)."""
    model, variables, _, images, gals, labels, planted = level
    js = JaxCascade(model, variables, jax_info("b0"), gals[-1], **_level_kw(level, "class"))
    ps = _level_port(level, "class")
    assert ps.mode == "level" and ps.grid == 1 and ps._tile_g == js._tile_g == 128
    assert ps.num_levels == 4 and ps.segments == js.segments
    assert ps.gallery.shape[0] == 2048  # whole pad tiles past row 1500
    for d2_rule in ("class", "row"):
        js.d2_rule = ps.d2_rule = d2_rule
        js._fused_fns, js._match2_jit = {}, None
        jp, jl, jf = _packed(js, images, jax_side=True)
        trace = []
        with torch.no_grad():
            out = ps._run(torch.from_numpy(images), ps.capacities_for(L_PROBES), trace).numpy()
        pp, pl, pf = out[:L_PROBES], out[L_PROBES:-1], int(out[-1])
        # near-ties of the exit rule at any level a probe was live
        tie = np.zeros(L_PROBES, bool)
        for t in trace:
            m, d1, live = t["margin"].numpy(), t["d1"].numpy(), t["live"].numpy()
            tie[t["gidx"].numpy()[live]] |= (np.abs(m) <= TIE * d1)[live]
        same = (pp == jp) & (pl == jl)
        assert (same | tie).all(), (d2_rule, pp, jp, pl, jl)
        assert abs(pf - jf) <= tie.sum()
        # the layout's intent, on both sides: probe p exits at level p // 4
        # with its planted row
        np.testing.assert_array_equal(jl, np.arange(L_PROBES) // 4)
        np.testing.assert_array_equal(pl, np.arange(L_PROBES) // 4)
        np.testing.assert_array_equal(pp, planted)
        idx, lab, stats = ps.identify(images)
        np.testing.assert_array_equal(lab, labels[planted])
        assert stats == {"break_counts": [0.25] * 4, "forced_fraction": 0.0}
        assert ps.calibrate(images) == js.calibrate(images) == [0.75, 0.5, 0.25]
        assert ps.capacities_for(L_PROBES) == js.capacities_for(L_PROBES)
        ps._capacities = js._capacities = None


def test_level_mode_ratio_is_read_at_call_time(level):
    """No cache keeps a stale ratio: at ratio 0 nothing exits early."""
    _, _, _, images, *_ = level
    ps = _level_port(level, "class")
    ps.ratio = 0.0
    _, pl, _ = _packed(ps, images)
    assert (pl == 3).all()


def test_errors_match_jax(weights, level):
    model, variables, np_vars = weights
    _, _, _, _, gals, labels, _ = level
    rows = gals[-1]
    for kw, exc in (
        (dict(galleries=[gals[0][:1000], gals[1], gals[2]], taps=L_TAPS, labels=labels, d2_rule="class"), "row-aligned"),
        (dict(d2_rule="nearest"), "d2_rule"), (dict(d2_rule="class"), "labels"),
        (dict(galleries=gals[:2], taps=L_TAPS), "one tap gallery")):
        with pytest.raises(ValueError, match=exc):
            JaxCascade(model, variables, jax_info("b0"), rows, resolution=RES, **kw)
        with pytest.raises(ValueError, match=exc):
            CascadeRecognitionService(np_vars, backbone_info("b0"), rows, resolution=RES, device="cpu", **kw)
