"""Exit policies and TWD classifiers against JAX's. Tolerances: kNN and linear
exits and TWD give equal predictions, levels and unreliable counts; the NumPy
helpers are equal; the squared-hinge descent from JAX's weights lands within
1e-5 of JAX's after 200 steps."""

import jax
import numpy as np
import pytest

import fast_image_recognition_tpu.cascade.exits as JX
import fast_image_recognition_tpu.cascade.twd as JT
import fast_image_recognition_tpu_torch.cascade.exits as PX
import fast_image_recognition_tpu_torch.cascade.twd as PT
from fast_image_recognition_tpu.data import make_gallery_and_probes
from fast_image_recognition_tpu.ops import oracle_pairwise
from test_torch_synthetic import _one_thread  # noqa: F401


@pytest.fixture(scope="module")
def levels():
    """Three levels of embeddings of rising quality, as the JAX test's."""
    out = [make_gallery_and_probes(12, 15, 4, 64, seed=91, within_class_noise=n) for n in (1.6, 0.8, 0.3)]
    return [o[0] for o in out], out[0][1], [o[2] for o in out], out[0][3]


@pytest.fixture(scope="module")
def twd_data():
    return make_gallery_and_probes(16, 10, 2, 256, seed=81)


def _same_cascade(p, j):
    np.testing.assert_array_equal(p.predictions, j.predictions)
    np.testing.assert_array_equal(p.exit_level, j.exit_level)
    np.testing.assert_allclose(p.break_counts, j.break_counts)


@pytest.mark.parametrize("ratio", [0.8, 0.6])
def test_sequential_knn_cascade_matches_jax(levels, ratio):
    x_train, y_train, x_val, y_val = levels
    got = PX.sequential_knn_cascade(x_train, y_train, x_val, ratio=ratio, device="cpu")
    _same_cascade(got, JX.sequential_knn_cascade(x_train, y_train, x_val, ratio=ratio))
    assert np.isclose(got.break_counts.sum(), 1.0)
    assert ratio != 0.8 or 0 < got.break_counts[0] < 1  # the reference's ratio exits some early


def test_linear_exit_cascade_matches_jax(levels):
    x_train, y_train, x_val, y_val = levels
    for kw in (dict(far=0.01), dict(fixed_threshold=0.06)):
        pc = PX.LinearExitCascade.train(x_train, y_train, num_classes=12, device="cpu", **kw)
        jc = JX.LinearExitCascade.train(x_train, y_train, num_classes=12, **kw)
        assert pc.thresholds == jc.thresholds
        got = pc.evaluate(x_val, device="cpu")
        _same_cascade(got, jc.evaluate(x_val))
    assert (got.predictions == y_val).mean() > 0.8


def test_svc_descent_from_jax_initial_weights(levels):
    x_train, y_train, _, _ = levels
    x = x_train[2]
    jw, jb = JX.train_linear_svc(x, y_train, 12, use_sklearn=False)
    w0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (12, x.shape[1])) * 0.01)
    pw, pb = PX.svc_descent(x, y_train, 12, w0, np.zeros(12, np.float32), device="cpu")
    np.testing.assert_allclose(pw, jw, atol=1e-5)
    np.testing.assert_allclose(pb, jb, atol=1e-5)
    w, b = PX.train_linear_svc(x, y_train, 12, use_sklearn=False, device="cpu")
    assert ((x @ w.T + b).argmax(1) == y_train).mean() > 0.9


def test_tune_far_threshold_and_entropy_exits_equal_jax():
    rng = np.random.default_rng(0)
    n, c = 400, 5
    y = rng.integers(0, c, n)
    dv = rng.normal(0, 0.1, (n, c))
    dv[np.arange(n), y] += 1.0
    bad = rng.choice(n, 40, replace=False)
    dv[bad] = rng.normal(0, 0.1, (40, c))
    dv[bad, (y[bad] + 1) % c] += 0.5
    for far in (0.0, 0.01, 0.05):
        assert PX.tune_far_threshold(dv, y, far) == JX.tune_far_threshold(dv, y, far)
    probs = [rng.dirichlet(np.ones(6) * 0.3, 100) for _ in range(3)]
    for mode, t in (("entropy", 0.8), ("max_prob", 0.7)):
        _same_cascade(PX.entropy_exit_cascade(probs, t, mode), JX.entropy_exit_cascade(probs, t, mode))


def test_hybrid_knn_svc_matches_jax(levels):
    x_train, y_train, x_val, y_val = levels
    got = PX.knn_exits_with_final_classifier(x_train, y_train, x_val, num_classes=12, device="cpu")
    _same_cascade(got, JX.knn_exits_with_final_classifier(x_train, y_train, x_val, num_classes=12))
    assert (got.predictions == y_val).mean() > 0.75


@pytest.mark.parametrize("granularity,chunk", [("instance", 32), ("class", 64)])
def test_proposed_twd_matches_jax_and_oracle(twd_data, granularity, chunk):
    gallery, glabels, probes, plabels = twd_data
    pc = PT.ProposedTWD(gallery, glabels, 16, chunk_features=chunk, theta=0.7, granularity=granularity, device="cpu")
    jc = JT.ProposedTWD(gallery, glabels, 16, chunk_features=chunk, theta=0.7, granularity=granularity)
    preds = pc.predict(probes)
    np.testing.assert_array_equal(preds, jc.predict(probes))
    assert pc.unreliable_count == jc.unreliable_count
    assert pc.name == jc.name and (preds == plabels).mean() > 0.9
    if granularity == "instance":
        agree = unreliable = 0
        for i in range(probes.shape[0]):
            want, needed2 = PT.proposed_twd_oracle(probes[i], gallery, glabels, chunk, 0.7)
            assert (want, needed2) == JT.proposed_twd_oracle(probes[i], gallery, glabels, chunk, 0.7)
            agree += int(preds[i] == want)
            unreliable += int(needed2)
        assert agree >= int(0.95 * probes.shape[0])
        assert abs(pc.unreliable_count - unreliable) <= 2
    pc.reset_counters()
    assert pc.unreliable_count == 0


@pytest.mark.parametrize("twd_type,threshold",
    [(PT.TWDType.POSTERIORS, 0.24), (PT.TWDType.DIST_DIFF, 0.003), (PT.TWDType.DIST_RATIO, 0.7)])
def test_conventional_twd_matches_jax(twd_data, twd_type, threshold):
    gallery, glabels, probes, plabels = twd_data
    pc = PT.ConventionalTWD(gallery, glabels, 16, twd_type, threshold, device="cpu")
    jc = JT.ConventionalTWD(gallery, glabels, 16, JT.TWDType(twd_type.value), threshold)
    preds = pc.predict(probes)
    np.testing.assert_array_equal(preds, jc.predict(probes))
    assert pc.unreliable_count == jc.unreliable_count and pc.name == jc.name
    assert (preds == plabels).mean() > 0.9


def test_conventional_twd_limits_are_prefix_brute_force(twd_data):
    gallery, glabels, probes, _ = twd_data
    always = PT.ConventionalTWD(gallery, glabels, 16, PT.TWDType.DIST_RATIO, threshold=1e9, device="cpu")
    np.testing.assert_array_equal(always.predict(probes), glabels[oracle_pairwise(probes, gallery, 0, 64).argmin(1)])
    assert always.unreliable_count == 0
    never = PT.ConventionalTWD(gallery, glabels, 16, PT.TWDType.DIST_DIFF, threshold=1e9, device="cpu")
    np.testing.assert_array_equal(never.predict(probes), glabels[oracle_pairwise(probes, gallery, 0, 256).argmin(1)])
    assert never.unreliable_count == probes.shape[0]
    # refining only the unreliable probes equals refining every probe
    c = PT.ConventionalTWD(gallery, glabels, 16, PT.TWDType.DIST_RATIO, 0.8, reduced_features=16, refine_to=64,
            device="cpu")
    preds = c.predict(probes)
    q = c._g.new_tensor(probes)
    d1, best, reliable = PT._twd_stage1(q, c._g, c._l, 16, 16, 0.8, PT.TWDType.DIST_RATIO, c.kind)
    refined = PT._twd_refine(q, d1, c._g, 16, 64, c.kind)
    want = np.where(reliable.numpy(), best.numpy(), refined.numpy())
    np.testing.assert_array_equal(preds, glabels[want])
    assert c.unreliable_count == int((~reliable).sum())
