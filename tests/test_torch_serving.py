"""The port's RecognitionService against the JAX package's on the same
random-init B0@64 weights, probe images and gallery, end to end
(``pca`` with the packed scan, ``exact``); the other scans and the
builders are held against JAX at the match level in
test_torch_serving_modes.py.

The gallery lies in a 96-dimensional span that holds the probes'
embeddings, so PCA-124 keeps every distance and the packed scan's
certificate can clear: each probe has one planted row (noise 0.02) and 40
distractors (noise 0.5) of its own, and filler rows elsewhere in the span.
Tolerance: top-1 rows identical, except where the port's and the JAX
package's picks are at squared distances within 2^-8 relative of each
other (bf16 backbones that round at other places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_image_recognition_tpu.models import backbone_info as jax_info
from fast_image_recognition_tpu.models import create_backbone
from fast_image_recognition_tpu.models.fold import make_serving_fn as jax_serving_fn
from fast_image_recognition_tpu.ops.distance_kernel import topk_candidates_l2_packed_cert
from fast_image_recognition_tpu.serving import RecognitionService as JaxService
from fast_image_recognition_tpu_torch.models.efficientnet import backbone_info
from fast_image_recognition_tpu_torch.models.fold import make_serving_fn
from fast_image_recognition_tpu_torch.parallel import gallery_mesh
from fast_image_recognition_tpu_torch.serving import RecognitionService
from test_torch_synthetic import _one_thread  # noqa: F401  (autouse: one torch/BLAS thread)


RES, PROBES, N = 64, 32, 4000


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    # parameters do not depend on the resolution; a small init compiles faster
    model, variables = create_backbone("b0", 0, resolution=32)
    variables = jax.device_get(variables)
    jax_serve = jax_serving_fn(model, variables, jax_info("b0"), resolution=RES)
    np_vars = jax.tree_util.tree_map(
        np.asarray, {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    )
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (PROBES, RES, RES, 3)).astype(np.uint8)
    serve = make_serving_fn(np_vars, backbone_info("b0"), resolution=RES, device="cpu")
    with torch.no_grad():
        emb = _unit(serve(torch.from_numpy(images))["embedding"].numpy())
    basis, _ = np.linalg.qr(np.concatenate([emb, rng.standard_normal((64, 1280))]).T)
    basis = basis.T.astype(np.float32)  # [96, 1280] orthonormal rows

    def in_span(n, scale):
        return scale * (rng.standard_normal((n, 96)) / np.sqrt(96)).astype(np.float32) @ basis

    rows = [_unit(rng.standard_normal((N, 96)).astype(np.float32) @ basis)]
    planted = rng.choice(N, PROBES, replace=False)
    gal = rows[0]
    free = np.setdiff1d(np.arange(N), planted)
    rng.shuffle(free)
    for i in range(PROBES):
        gal[planted[i]] = _unit(emb[i] + in_span(1, 0.02)[0])
        gal[free[i * 40 : (i + 1) * 40]] = _unit(emb[i] + in_span(40, 0.5))
    return model, (variables, jax_serve), np_vars, serve, images, gal, planted


def _pair(setup, **kw):
    """Both services with the same arguments: bench.py's main-path PCA
    (124, packed) unless ``kw`` says otherwise."""
    model, (variables, jax_serve), np_vars, serve, images, gal, _ = setup
    kw = {"pca_dim": 124, "pca_scan": "packed", **kw}
    js = JaxService(model, variables, jax_info("b0"), gal, resolution=RES, serving_fn=jax_serve, **kw)
    ps = RecognitionService(None, backbone_info("b0"), gal, resolution=RES, serving_fn=serve,
                            device="cpu", **kw)
    return np.asarray(js.identify_device(images)), ps.identify_device(torch.from_numpy(images)).numpy(), ps


def _assert_same_top1(setup, ji, pi):
    _, _, _, serve, images, gal, _ = setup
    with torch.no_grad():
        emb = _unit(serve(torch.from_numpy(images))["embedding"].numpy())
    dj = ((emb - gal[ji]) ** 2).sum(1)
    dp = ((emb - gal[pi]) ** 2).sum(1)
    assert ((ji == pi) | (np.abs(dj - dp) <= 2.0**-8 * dj)).all()


@pytest.mark.parametrize("escalate,rescore", [(0.05, 2), (10.0, 48)])
def test_pca_packed_certified_top1_matches_jax(setup, escalate, rescore):
    ji, pi, ps = _pair(setup, escalate=escalate, rescore=rescore)
    _assert_same_top1(setup, ji, pi)
    np.testing.assert_array_equal(pi, setup[-1])  # the planted rows win
    esc = ps.last_escalated.numpy()
    if escalate >= 1.0:
        assert esc.all()  # forced: every probe takes the exact scan
    else:
        assert not esc.any()  # the certificate clears every probe


def test_pca_packed_uncertified_top1_matches_jax(setup):
    """``escalate=None``: the rescored best of the single-min packed scan's
    candidates, uncertified (JAX serving.py:298-305); rescore 2 of the
    gallery's 4 tiles, so the tile selection decides."""
    ji, pi, ps = _pair(setup, escalate=None, rescore=2)
    _assert_same_top1(setup, ji, pi)
    np.testing.assert_array_equal(pi, setup[-1])  # the planted rows win
    assert ps.escalate is None and not hasattr(ps, "last_escalated")


@pytest.mark.parametrize("clustered", [False, True])
def test_certified_pick_is_nearest_candidate(setup, clustered):
    """The pick before escalation is the candidate nearest the probe by a
    plain fp32 rescore, within 2^-12 relative + 1e-5 (fp32 rounding of
    1280-term sums); on the planted gallery it is the planted row and
    nothing escalates. ``clustered`` replaces the first rows with 32 per
    probe (noise 0.5), where the pick is a near-tie among them."""
    _, _, _, serve, images, gal, planted = setup
    with torch.no_grad():
        emb = torch.from_numpy(_unit(serve(torch.from_numpy(images))["embedding"].numpy()))
    if clustered:
        rng = np.random.default_rng(7)
        gal = gal.copy()
        gal[: PROBES * 32] = _unit(
            np.repeat(emb.numpy(), 32, axis=0) + 0.5 * rng.standard_normal((PROBES * 32, 1280)) / np.sqrt(1280)
        )
    ps = RecognitionService(None, backbone_info("b0"), gal, resolution=RES, serving_fn=serve, device="cpu",
                            pca_dim=124, pca_scan="packed")
    cand, pick, esc = ps._certified(emb)
    assert cand.shape == (PROBES, 4)  # rescore 48, capped at the gallery's 4 tiles
    assert pick.shape == esc.shape == (PROBES,)
    assert (cand == pick[:, None]).any(dim=1).all()
    e16 = emb.to(torch.bfloat16).to(torch.float32)
    g = ps.gallery.to(torch.float32)
    d_cand = ((e16[:, None, :] - g[cand]) ** 2).sum(-1).min(dim=1).values
    d_pick = ((e16 - g[pick]) ** 2).sum(-1)
    assert (d_pick <= d_cand + 2.0**-12 * d_cand + 1e-5).all()
    if not clustered:
        np.testing.assert_array_equal(pick.numpy(), planted)
        assert not esc.any()


def test_exact_match_top1_matches_jax(setup):
    ji, pi, _ = _pair(setup, match="exact")
    _assert_same_top1(setup, ji, pi)
    assert pi.dtype == ji.dtype == np.int32  # identify_device's rows


def test_identify_labels_and_unported_modes(setup):
    """``identify`` returns int64 rows and their labels, also through
    ``match='sharded'`` over two CPU shards (held against JAX in
    test_torch_sharded.py); unknown modes raise (``select='approx'`` is held
    against JAX in test_torch_select_approx.py)."""
    _, _, np_vars, serve, images, gal, planted = setup
    labels = np.arange(N) % 7
    ps = RecognitionService(None, backbone_info("b0"), gal, labels=labels, resolution=RES,
                            serving_fn=serve, device="cpu", match="exact")
    idx, lab = ps.identify(images[:4])
    np.testing.assert_array_equal(idx, planted[:4])
    np.testing.assert_array_equal(lab, labels[planted[:4]])
    assert idx.dtype == np.int64
    sh = RecognitionService(None, backbone_info("b0"), gal, labels=labels, resolution=RES, serving_fn=serve,
                            device="cpu", match="sharded", mesh=gallery_mesh(devices=["cpu"] * 2))
    idx_s, lab_s = sh.identify(images[:4])
    np.testing.assert_array_equal(idx_s, idx)
    np.testing.assert_array_equal(lab_s, lab)
    for kw in (dict(match="nope"), dict(pca_scan="nope"), dict(select="nope"),
               dict(match="sharded", sharded_scan="nope")):
        with pytest.raises(ValueError):
            RecognitionService(None, backbone_info("b0"), gal, serving_fn=serve, device="cpu", **kw)


def _jax_escalation(js, emb):
    """The JAX service's certificate test (serving.py:326-356) on ``emb``:
    (escalate mask, margin of the test). The service does not expose it."""
    e = jnp.asarray(emb)
    cand, bound = topk_candidates_l2_packed_cert(
        (e - js._mu) @ js._w, js.match_args[0], js.pca_dim, js.rescore
    )
    rows = np.asarray(js.gallery.astype(jnp.float32))[np.asarray(cand)]
    e16 = np.asarray(e.astype(jnp.bfloat16).astype(jnp.float32))
    d1 = ((rows * rows).sum(-1) - 2.0 * np.einsum("bd,brd->br", e16, rows)).min(1)
    qsq = (emb * emb).sum(1)
    lhs = d1 + qsq + js.escalate * qsq
    rhs = (1.0 - js.escalate) * np.asarray(bound)
    return lhs > rhs, np.abs(lhs - rhs) / rhs


@pytest.mark.parametrize("clustered", [False, True])
def test_defaults_top1_and_escalation_mask_match_jax(setup, clustered):
    """The main path's service (PCA-124 packed, rescore 48, slack 0.05):
    same embeddings in, same top-1 and same certificate decisions out. With 32 rows per
    identity (the class-structured workload of chip_smoke.py) the within-
    tile second minimum is as near as the best row, so both packages
    escalate every probe; on the planted gallery neither does."""
    model, (variables, jax_serve), _, serve, images, gal, _ = setup
    with torch.no_grad():
        emb = _unit(serve(torch.from_numpy(images))["embedding"].numpy())
    if clustered:
        rng = np.random.default_rng(7)
        gal = gal.copy()
        rows = _unit(np.repeat(emb, 32, axis=0) + 0.5 * rng.standard_normal((PROBES * 32, 1280)) / np.sqrt(1280))
        gal[: PROBES * 32] = rows
    js = JaxService(model, variables, jax_info("b0"), gal, resolution=RES, pca_dim=124,
                    pca_scan="packed", serving_fn=jax_serve)
    ps = RecognitionService(None, backbone_info("b0"), gal, resolution=RES, serving_fn=serve,
                            device="cpu", pca_dim=124, pca_scan="packed")
    pi = ps._match_emb(torch.from_numpy(emb)).numpy()
    ji = np.asarray(js._match_emb(jnp.asarray(emb), *js.match_args))
    dj, dp = ((emb - gal[ji]) ** 2).sum(1), ((emb - gal[pi]) ** 2).sum(1)
    assert ((ji == pi) | (np.abs(dj - dp) <= 2.0**-8 * dj)).all()
    jesc, margin = _jax_escalation(js, emb)
    pesc = ps.last_escalated.numpy()
    # a decision may differ only where the test sits on its threshold
    assert ((jesc == pesc) | (margin < 2.0**-8)).all()
    assert pesc.all() if clustered else not pesc.any()


def test_return_types_match_jax(setup):
    """As in the JAX package, ``identify_device`` gives int32 rows on the
    device (the JAX side's are checked in the tests above) and ``embed`` a
    host numpy [B, D] fp32 array of unit rows; ``identify`` int64 rows."""
    _, _, _, serve, images, gal, planted = setup
    ps = RecognitionService(None, backbone_info("b0"), gal, resolution=RES, serving_fn=serve, device="cpu",
                            match="exact")
    rows = ps.identify_device(torch.from_numpy(images[:4]))
    assert isinstance(rows, torch.Tensor) and rows.dtype == torch.int32
    emb = ps.embed(images[:4])
    assert isinstance(emb, np.ndarray) and emb.dtype == np.float32 and emb.shape == (4, 1280)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(emb, ps._embed(images[:4]).numpy())
    idx, _ = ps.identify(images[:4])
    assert idx.dtype == np.int64
    np.testing.assert_array_equal(idx, planted[:4])
