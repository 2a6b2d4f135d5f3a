"""``select='approx'`` against JAX's (``approx_min_k`` is exact off the TPU).
Tolerances: the same tiles in the same order as JAX's (equal minima ordered by
the lower tile); services' labels equal but at picks within 2^-8 relative;
approx = ``select='exact', escalate=None`` rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_image_recognition_tpu.ops.distance_kernel as J
import fast_image_recognition_tpu_torch.ops.distance_kernel as P
from fast_image_recognition_tpu.models import backbone_info as jax_info
from fast_image_recognition_tpu.models.fold import make_serving_fn as jax_serving_fn
from fast_image_recognition_tpu.serving import RecognitionService as JaxService
from fast_image_recognition_tpu_torch.models.efficientnet import backbone_info
from fast_image_recognition_tpu_torch.models.fold import make_serving_fn
from fast_image_recognition_tpu_torch.serving import RecognitionService
from test_torch_synthetic import _one_thread, _unit, jax_b0  # noqa: F401

RES, PROBES, N = 32, 24, 3000


@pytest.fixture(scope="module")
def setup():
    model, variables, np_vars = jax_b0(RES)
    jax_serve = jax_serving_fn(model, variables, jax_info("b0"), resolution=RES)
    serve = make_serving_fn(np_vars, backbone_info("b0"), resolution=RES, device="cpu")
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (PROBES, RES, RES, 3)).astype(np.uint8)
    with torch.no_grad():
        emb = _unit(serve(torch.from_numpy(images))["embedding"].numpy())
    # each probe has 30 rows around it (noise 0.3) among random filler rows
    gal = _unit(rng.standard_normal((N, emb.shape[1])))
    for i in range(PROBES):
        gal[i * 30 : (i + 1) * 30] = _unit(emb[i] + 0.3 * rng.standard_normal((30, emb.shape[1])) / 36.0)
    labels = np.arange(N) // 30
    return model, variables, jax_serve, serve, images, emb, gal, labels


def test_select_tiles_equals_jax_approx_min_k():
    rng = np.random.default_rng(0)
    for b, n_tiles, r in ((5, 300, 48), (3, 64, 64), (7, 1000, 17)):
        d = rng.random((b, n_tiles)).astype(np.float32)
        want = np.asarray(J._select_tiles(jnp.asarray(d), r, "approx"))
        np.testing.assert_array_equal(want, np.asarray(J._select_tiles(jnp.asarray(d), r, "exact")))
        np.testing.assert_array_equal(P._select_tiles(torch.from_numpy(d), r, "approx").numpy(), want)
        # among equal minima approx_min_k leaves the order open: the same
        # tile minima are selected, ascending
        d = np.round(d * 20)
        want = np.asarray(J._select_tiles(jnp.asarray(d), r, "approx"))
        got = P._select_tiles(torch.from_numpy(d), r, "approx").numpy()
        rows = np.arange(b)[:, None]
        np.testing.assert_array_equal(d[rows, got], d[rows, want])
        np.testing.assert_array_equal(got, np.asarray(J._select_tiles(jnp.asarray(d), r, "exact")))
    with pytest.raises(ValueError):
        P._select_tiles(torch.from_numpy(d), r, "nope")


def test_approx_service_labels_match_jax(setup):
    """bench.py's service (PCA-124 packed, the single-min scan under ``select='approx'``) against JAX's."""
    model, variables, jax_serve, serve, images, emb, gal, labels = setup
    kw = dict(pca_dim=124, pca_scan="packed", rescore=8, select="approx")
    js = JaxService(model, variables, jax_info("b0"), gal, labels=labels, resolution=RES, serving_fn=jax_serve, **kw)
    ps = RecognitionService(None, backbone_info("b0"), gal, labels=labels, resolution=RES, serving_fn=serve,
            device="cpu", **kw)
    assert js.escalate is None and ps.escalate is None  # the certificate needs the exact selection
    ji, jl = js.identify(images)
    pi, pl = ps.identify(images)
    dj, dp = ((emb - gal[ji]) ** 2).sum(1), ((emb - gal[pi]) ** 2).sum(1)
    assert ((jl == pl) | (np.abs(dj - dp) <= 2.0**-8 * dj)).all()
    assert (pl == np.arange(PROBES)).mean() >= 0.9


@pytest.mark.parametrize("pca_scan", ["packed", "f32", "bf16", "int8"])
def test_approx_service_equals_exact_selection(setup, pca_scan):
    """Every scan's approx service gives its exact selection's rows without escalation."""
    _, _, _, serve, images, _, gal, labels = setup
    svc = RecognitionService(None, backbone_info("b0"), gal, labels=labels, resolution=RES, serving_fn=serve,
            pca_dim=124 if pca_scan == "packed" else 128, pca_scan=pca_scan, rescore=8,
            select="approx", device="cpu")
    assert svc.escalate is None and svc.select == "approx"
    rows = svc.identify(images)[0]
    svc.select = "exact"  # the same service and gallery, the exact selection, no escalation
    np.testing.assert_array_equal(rows, svc.identify(images)[0])
