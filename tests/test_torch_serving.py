"""RecognitionService against JAX's, random-init B0@64, planted rows. Tolerance:
top-1 equal but at picks within 2^-8 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_image_recognition_tpu.models import backbone_info as jax_info
from fast_image_recognition_tpu.models.fold import make_serving_fn as jax_serving_fn
from fast_image_recognition_tpu.ops.distance_kernel import topk_candidates_l2_packed_cert
from fast_image_recognition_tpu.serving import RecognitionService as JaxService
from fast_image_recognition_tpu_torch.models.efficientnet import backbone_info
from fast_image_recognition_tpu_torch.models.fold import make_serving_fn
from fast_image_recognition_tpu_torch.parallel import gallery_mesh
from fast_image_recognition_tpu_torch.serving import RecognitionService
from test_torch_synthetic import _one_thread, _unit, jax_b0, planted_gallery  # noqa: F401


RES, PROBES, N = 64, 32, 4000


@pytest.fixture(scope="module")
def setup():
    # parameters do not depend on the resolution; a small init compiles faster
    model, variables, np_vars = jax_b0(32)
    jax_serve = jax_serving_fn(model, variables, jax_info("b0"), resolution=RES)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (PROBES, RES, RES, 3)).astype(np.uint8)
    serve = make_serving_fn(np_vars, backbone_info("b0"), resolution=RES, device="cpu")
    with torch.no_grad():
        emb = _unit(serve(torch.from_numpy(images))["embedding"].numpy())
    gal, planted = planted_gallery(emb, N, rng)
    return model, (variables, jax_serve), np_vars, serve, images, gal, planted


def _pair(setup, **kw):
    """Both services, the main path's PCA (124, packed) unless ``kw`` says otherwise."""
    model, (variables, jax_serve), np_vars, serve, images, gal, _ = setup
    kw = {"pca_dim": 124, "pca_scan": "packed", **kw}
    js = JaxService(model, variables, jax_info("b0"), gal, resolution=RES, serving_fn=jax_serve, **kw)
    ps = RecognitionService(None, backbone_info("b0"), gal, resolution=RES, serving_fn=serve, device="cpu", **kw)
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
    """``escalate=None``: the uncertified rescored best (JAX serving.py:298-305); rescore 2 of 4 tiles."""
    ji, pi, ps = _pair(setup, escalate=None, rescore=2)
    _assert_same_top1(setup, ji, pi)
    np.testing.assert_array_equal(pi, setup[-1])  # the planted rows win
    assert ps.escalate is None and not hasattr(ps, "last_escalated")


@pytest.mark.parametrize("clustered", [False, True])
def test_certified_pick_is_nearest_candidate(setup, clustered):
    """The pick before escalation is the candidate nearest by fp32 (2^-12 + 1e-5); planted: the planted row
    unescalated; ``clustered``: a near-tie among its 32 rows."""
    _, _, _, serve, images, gal, planted = setup
    with torch.no_grad():
        emb = torch.from_numpy(_unit(serve(torch.from_numpy(images))["embedding"].numpy()))
    if clustered:
        rng = np.random.default_rng(7)
        gal = gal.copy()
        gal[: PROBES * 32] = _unit(np.repeat(emb.numpy(), 32, axis=0) + 0.5 * rng.standard_normal((PROBES * 32,
            1280)) / np.sqrt(1280))
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
    """``identify`` gives int64 rows and labels, also sharded over two CPU shards; unknown modes raise."""
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
    """JAX's certificate test (serving.py:326-356) on ``emb``: (escalate mask, margin)."""
    e = jnp.asarray(emb)
    cand, bound = topk_candidates_l2_packed_cert((e - js._mu) @ js._w, js.match_args[0], js.pca_dim, js.rescore)
    rows = np.asarray(js.gallery.astype(jnp.float32))[np.asarray(cand)]
    e16 = np.asarray(e.astype(jnp.bfloat16).astype(jnp.float32))
    d1 = ((rows * rows).sum(-1) - 2.0 * np.einsum("bd,brd->br", e16, rows)).min(1)
    qsq = (emb * emb).sum(1)
    lhs = d1 + qsq + js.escalate * qsq
    rhs = (1.0 - js.escalate) * np.asarray(bound)
    return lhs > rhs, np.abs(lhs - rhs) / rhs


@pytest.mark.parametrize("clustered", [False, True])
def test_defaults_top1_and_escalation_mask_match_jax(setup, clustered):
    """The main path's service: same top-1 and certificate decisions. With 32 rows
    an identity both escalate every probe; on the planted gallery neither."""
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
    """``identify_device`` int32 rows on the device, ``embed`` host [B, D] fp32 unit rows, ``identify`` int64."""
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
