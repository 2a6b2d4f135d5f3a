"""RecognitionService's match modes against JAX's on the same embeddings.
Tolerance: top-1 equal but at picks within 2^-8 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_image_recognition_tpu.models import backbone_info as jax_info
from fast_image_recognition_tpu.serving import RecognitionService as JaxService
from fast_image_recognition_tpu_torch.models.efficientnet import backbone_info
from fast_image_recognition_tpu_torch.serving import RecognitionService
from test_torch_synthetic import _one_thread, _unit  # noqa: F401


PROBES, N, DIM = 32, 4000, 1280
# no backbone runs here: the services are matched on embeddings directly
JAX_STUB, PORT_STUB = (None, None), torch.nn.Identity()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    basis, _ = np.linalg.qr(rng.standard_normal((DIM, 96)))
    basis = basis.T.astype(np.float32)  # [96, DIM] orthonormal rows

    def in_span(n, scale):
        return scale * (rng.standard_normal((n, 96)) / np.sqrt(96)).astype(np.float32) @ basis

    emb = _unit(in_span(PROBES, 1.0))
    gal = _unit(in_span(N, 1.0))
    planted = rng.choice(N, PROBES, replace=False)
    free = np.setdiff1d(np.arange(N), planted)
    rng.shuffle(free)
    for i in range(PROBES):
        gal[planted[i]] = _unit(emb[i] + in_span(1, 0.02)[0])
        gal[free[i * 40 : (i + 1) * 40]] = _unit(emb[i] + in_span(40, 0.5))
    clustered = gal.copy()
    clustered[: PROBES * 32] = _unit(
        np.repeat(emb, 32, axis=0) + 0.5 * rng.standard_normal((PROBES * 32, DIM)) / np.sqrt(DIM)
    )
    return emb, gal, clustered, planted


def _services(data, clustered, **kw):
    emb, gal, gal_c, _ = data
    gal = gal_c if clustered else gal
    kw = {"pca_sample": 1024, **kw}  # the gallery spans 96 dimensions
    js = JaxService(None, None, jax_info("b0"), gal, serving_fn=JAX_STUB, **kw)
    ps = RecognitionService(None, backbone_info("b0"), gal, serving_fn=PORT_STUB, device="cpu", **kw)
    return js, ps, emb, gal


def _same_emb_top1(js, ps, emb, gal):
    """Both matched on the same embeddings: int32 rows, top-1 equal up to near-ties. (JAX rows, port rows)."""
    ji = np.asarray(js._match_emb(jnp.asarray(emb), *js.match_args))
    pi = ps._match_emb(torch.from_numpy(emb)).numpy()
    assert pi.dtype == ji.dtype == np.int32
    dj, dp = ((emb - gal[ji]) ** 2).sum(1), ((emb - gal[pi]) ** 2).sum(1)
    assert ((ji == pi) | (np.abs(dj - dp) <= 2.0**-8 * dj)).all()
    return ji, pi


@pytest.mark.parametrize("clustered", [False, True])
def test_jax_defaults_top1_matches_jax(data, clustered):
    """JAX's defaults (PCA-128, fp32-score tile scan) in both packages."""
    js, ps, emb, gal = _services(data, clustered)
    assert ps.pca_dim == js.pca_dim == 128
    assert getattr(ps, "pca_scan", None) == js.pca_scan == "f32"
    assert ps.escalate is None and js.escalate is None
    ji, pi = _same_emb_top1(js, ps, emb, gal)
    assert (pi == ji).mean() >= 0.9
    if not clustered:
        np.testing.assert_array_equal(pi, data[-1])


@pytest.mark.parametrize(
    "kw", [dict(pca_scan="bf16"), dict(pca_scan="int8"), dict(match="int8")], ids=["bf16", "int8", "match-int8"]
)
@pytest.mark.parametrize("clustered", [False, True])
def test_scan_modes_top1_match_jax(data, kw, clustered):
    """``pca_scan`` bf16 and int8 (rescore 2 of 4 tiles) and ``match='int8'``:
    top-1 equal up to near-ties, planted rows found."""
    kw = {"rescore": 2, **kw} if "pca_scan" in kw else kw
    _, pi = _same_emb_top1(*_services(data, clustered, **kw))
    if not clustered:
        np.testing.assert_array_equal(pi, data[-1])


def test_escalation_is_one_masked_scan(data, monkeypatch):
    """One exact scan a certified call, mask on the device, escalated probes first: exact rows where a probe
    escalates, the pick elsewhere."""
    import fast_image_recognition_tpu_torch.serving as port_serving

    emb, gal, gal_c, planted = data
    emb = torch.from_numpy(emb)
    calls = []
    real = port_serving.topk_l2

    def counted(*args, **kw):
        calls.append(kw.get("row_mask"))
        return real(*args, **kw)

    monkeypatch.setattr(port_serving, "topk_l2", counted)
    for g, clustered in ((gal, False), (gal_c, True)):
        ps = RecognitionService(None, backbone_info("b0"), g, serving_fn=PORT_STUB, device="cpu",
                pca_dim=124, pca_scan="packed", pca_sample=1024)
        calls.clear()
        idx = ps._match_emb(emb)
        n_esc = int(ps.last_escalated.sum())
        assert len(calls) == 1 and torch.equal(calls[0], torch.arange(len(emb)) < n_esc)
        # the planted rows certify; near-tie clusters escalate (some probes)
        assert bool(ps.last_escalated.any()) == clustered
        _, exact = real(emb, ps.gallery, k=1, n_valid=ps.n_valid)
        _, cand_pick, _ = ps._certified(emb)
        want = torch.where(ps.last_escalated, exact[:, 0].long(), cand_pick)
        np.testing.assert_array_equal(idx.numpy(), want.numpy())
        if not clustered:
            np.testing.assert_array_equal(idx.numpy(), planted)


@pytest.mark.parametrize("pattern", ["none", "all", "scattered"])
def test_escalate_scans_the_escalated_probes_in_front(data, monkeypatch, pattern):
    """``_escalate`` scans the escalated probes first under a prefix mask and puts each answer back at its probe."""
    import fast_image_recognition_tpu_torch.serving as port_serving

    emb, gal, _, _ = data
    emb = torch.from_numpy(emb)
    b = len(emb)
    esc = {"none": torch.zeros(b, dtype=torch.bool), "all": torch.ones(b, dtype=torch.bool),
           "scattered": torch.from_numpy(np.random.default_rng(5).random(b) < 0.2)}[pattern]
    seen = []
    real = port_serving.topk_l2

    def spy(q, *args, **kw):
        seen.append((q, kw["row_mask"]))
        return real(q, *args, **kw)

    monkeypatch.setattr(port_serving, "topk_l2", spy)
    ps = RecognitionService(None, backbone_info("b0"), gal, serving_fn=PORT_STUB, device="cpu",
            pca_dim=124, pca_scan="packed", pca_sample=1024)
    pick = torch.arange(b, dtype=torch.int64) + 7
    idx = ps._escalate(emb, pick, esc)
    n_esc = int(esc.sum())
    (q, mask), = seen
    assert torch.equal(mask, torch.arange(b) < n_esc)
    assert torch.equal(q[:n_esc], emb[esc])
    _, exact = real(emb, ps.gallery, k=1, n_valid=ps.n_valid)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), torch.where(esc, exact[:, 0], pick.to(torch.int32)).numpy())


def test_build_service_matches_jax(data, monkeypatch):
    """``build_service`` from a name and variables as JAX's (its discarded init stubbed): settings, rows and labels."""
    import fast_image_recognition_tpu.models as jax_models
    from fast_image_recognition_tpu.serving import build_service as jax_build_service
    from fast_image_recognition_tpu_torch.serving import build_service

    emb, gal, _, planted = data
    monkeypatch.setattr(jax_models, "create_backbone", lambda *a, **k: (None, {}))
    labels = np.arange(N) % 11
    kw = dict(resolution=64, rescore=2, pca_sample=1024, seed=3)
    js = jax_build_service("b0", gal, labels, variables={}, serving_fn=JAX_STUB, **kw)
    ps = build_service("b0", gal, labels, variables=None, serving_fn=PORT_STUB, device="cpu", **kw)
    assert (ps.pca_dim, ps.rescore, ps.resolution, ps.pca_scan) == (js.pca_dim, js.rescore, js.resolution, js.pca_scan)
    ji, pi = _same_emb_top1(js, ps, emb, gal)
    np.testing.assert_array_equal(pi, planted)
    np.testing.assert_array_equal(ps.labels[pi], js.labels[ji])


@pytest.mark.parametrize("builder", ["build_service", "build_cascade_service"])
def test_builders_keep_the_service_seed(monkeypatch, builder):
    """``seed`` seeds the backbone init and never the service's own ``seed``, in both packages."""
    import fast_image_recognition_tpu.models as jax_models
    import fast_image_recognition_tpu.serving as jax_serving
    import fast_image_recognition_tpu_torch.serving as port_serving

    seen = {}

    def recorder(pkg):
        def make(*args, **kw):
            seen[pkg] = kw.get("seed", "service default")
        return make

    cls = "RecognitionService" if builder == "build_service" else "CascadeRecognitionService"
    monkeypatch.setattr(jax_serving, cls, recorder("jax"))
    monkeypatch.setattr(port_serving, cls, recorder("port"))
    monkeypatch.setattr(jax_models, "create_backbone", lambda *a, **k: (None, {}))
    gal = np.zeros((8, DIM), np.float32)
    getattr(jax_serving, builder)("b0", gal, seed=5, variables={})
    getattr(port_serving, builder)("b0", gal, seed=5, variables={})
    assert seen == {"jax": "service default", "port": "service default"}
