"""The exact 1-NN matcher and harness against JAX's: rows equal but at fp64
ties within 2^-16 relative; distances rtol 2e-4, atol 1e-7, int8 rescored
2^-20 + 1e-8; the file -> split -> match -> evaluate slice equal (but
``ms_per_image``)."""

import dataclasses

import numpy as np
import pytest

import fast_image_recognition_tpu.data as JD
import fast_image_recognition_tpu.evaluation as JE
from fast_image_recognition_tpu.config import DistanceKind as JKind
from fast_image_recognition_tpu.ops import oracle_pairwise as j_oracle
from fast_image_recognition_tpu.search import BruteForceMatcher as JMatcher
from fast_image_recognition_tpu_torch import data as PD
from fast_image_recognition_tpu_torch import evaluation as PE
from fast_image_recognition_tpu_torch.config import DistanceKind
from fast_image_recognition_tpu_torch.search import BruteForceMatcher, SearchResult
from fast_image_recognition_tpu_torch.search import brute_force
from test_torch_synthetic import _one_thread  # noqa: F401


def _sets(name):
    """(gallery, probes, matcher kwargs, oracle end) of a case."""
    if name == "l2":
        g, _ = PD.make_synthetic_gallery(16, 8, 96, seed=21)
        p, _ = PD.make_synthetic_gallery(16, 2, 96, seed=22)
        return g, p[:20], {}, None
    if name == "max_features_64":
        g, _ = PD.make_synthetic_gallery(8, 8, 128, seed=31)
        p, _ = PD.make_synthetic_gallery(8, 1, 128, seed=32)
        return g, p, {"max_features": 64}, 64
    if name == "l2_fast":
        g, _ = PD.make_synthetic_gallery(16, 8, 96, seed=23)
        p, _ = PD.make_synthetic_gallery(16, 1, 96, seed=24)
        return g, p, {"precise": False}, None
    if name in ("chi2", "kl"):
        g, _ = PD.make_synthetic_gallery(8, 8, 64, seed=41, l2=False)
        p, _ = PD.make_synthetic_gallery(8, 1, 64, seed=42, l2=False)
        return g, p, {"kind": name}, None
    if name in ("chi2_streamed", "kl_streamed"):
        # above STREAM_THRESHOLD: 65,600 rows at D = 8 go through streamed_topk
        g, _ = PD.make_synthetic_gallery(656, 100, 8, seed=43, l2=False)
        p, _ = PD.make_synthetic_gallery(656, 1, 8, seed=44, l2=False)
        return g, p[:6], {"kind": name.split("_")[0]}, None
    raise KeyError(name)


@pytest.mark.parametrize("name", ["l2", "max_features_64", "l2_fast", "chi2", "kl", "chi2_streamed", "kl_streamed"])
def test_matcher_matches_jax(name):
    g, p, kw, end = _sets(name)
    jkw = dict(kw, kind=JKind(kw["kind"])) if "kind" in kw else kw
    pkw = dict(kw, kind=DistanceKind(kw["kind"])) if "kind" in kw else kw
    if name.endswith("streamed"):
        assert g.shape[0] > brute_force.STREAM_THRESHOLD
    jm, pm = JMatcher(g, **jkw), BruteForceMatcher(g, device="cpu", **pkw)
    assert pm.name == jm.name
    jr, pr = jm.search(p), pm.search(p)
    assert isinstance(pr, SearchResult)
    assert pr.indices.dtype == np.int32 and pr.distances.dtype == np.float32
    assert pr.checked_fraction.dtype == np.float32 and (pr.checked_fraction == 1.0).all()
    oracle = j_oracle(p, g, 0, end, jkw.get("kind", JKind.L2))
    rows = np.arange(p.shape[0])
    tie = np.abs(oracle[rows, pr.indices] - oracle[rows, jr.indices]) <= 2.0**-16 * oracle[rows, jr.indices]
    assert ((pr.indices == jr.indices) | tie).all()
    np.testing.assert_allclose(pr.distances, jr.distances, rtol=2e-4, atol=1e-7)
    if kw.get("precise", True):
        assert ((pr.indices == oracle.argmin(1)) | tie).all()


def test_int8_matcher_matches_jax():
    """int8 over 3000 rows (a ragged last tile): rows = JAX's, distances 2^-20 relative."""
    g, _ = PD.make_synthetic_gallery(30, 100, 64, seed=51)
    p, _ = PD.make_synthetic_gallery(30, 1, 64, seed=52)
    jr = JMatcher(g, precision="int8").search(p)
    pm = BruteForceMatcher(g, precision="int8", device="cpu")
    pr = pm.search(p)
    assert pm.name == "BF-int8"
    assert pr.indices.dtype == np.int32 and pr.distances.dtype == np.float32
    np.testing.assert_array_equal(pr.indices, jr.indices)
    np.testing.assert_allclose(pr.distances, jr.distances, rtol=2.0**-20, atol=1e-8)
    for kw in ({"kind": DistanceKind.CHI2}, {"max_features": 32}):
        with pytest.raises(ValueError, match="int8"):
            BruteForceMatcher(g, precision="int8", device="cpu", **kw)


def test_end_to_end_slice_matches_jax(tmp_path):
    """write -> load -> split -> match -> evaluate in both packages (tests/test_brute_force.py:46-73)."""
    feats, labels = PD.make_synthetic_gallery(10, 20, 64, seed=5)
    names = [f"class_{c:03d}" for c in range(10)]
    pp, jp = tmp_path / "port.txt", tmp_path / "jax.txt"
    PD.write_feature_file(str(pp), feats, labels, names)
    JD.write_feature_file(str(jp), feats, labels, names)
    assert pp.read_text() == jp.read_text()

    pdb = PD.load_feature_file(str(pp), features_count=64)
    jdb = JD.load_feature_file(str(jp), features_count=64, engine="python")
    np.testing.assert_array_equal(pdb.features, jdb.features)
    np.testing.assert_array_equal(pdb.labels, jdb.labels)
    ps = PD.train_test_split_images(pdb.labels, np.random.default_rng(13), train_images_per_class=12)
    js = JD.train_test_split_images(jdb.labels, np.random.default_rng(13), train_images_per_class=12)
    np.testing.assert_array_equal(ps.train_idx, js.train_idx)
    np.testing.assert_array_equal(ps.test_idx, js.test_idx)

    args = lambda db, s: (db.labels[s.train_idx], db.features[s.test_idx], db.labels[s.test_idx])  # noqa: E731
    pres = PE.evaluate_matcher(BruteForceMatcher(pdb.features[ps.train_idx], device="cpu"), *args(pdb, ps),
            num_classes=pdb.num_classes, verbose=False)
    jres = JE.evaluate_matcher(JMatcher(jdb.features[js.train_idx]), *args(jdb, js),
            num_classes=jdb.num_classes, verbose=False)
    for f in ("name", "error_rate", "macro_recall", "checked_percent", "unreliable_percent", "extras"):
        assert getattr(pres, f) == getattr(jres, f), f
    assert pres.error_rate < 5.0 and pres.macro_recall > 95.0 and pres.checked_percent == 100.0
    assert pres.ms_per_image > 0.0
    summary = pres.summary().split()
    assert summary[0] == "BF" and summary[1:3] == jres.summary().split()[1:3]


def test_harness_helpers_match_jax():
    """The harness helpers' fields but the times equal."""
    rng = np.random.default_rng(3)
    d = rng.uniform(0, 1, 501)
    assert PE.get_threshold(d, 0.01) == JE.get_threshold(d, 0.01)
    true, pred = rng.integers(0, 7, 200), rng.integers(0, 7, 200)
    from fast_image_recognition_tpu.evaluation.harness import macro_recall_percent as j_recall
    from fast_image_recognition_tpu_torch.evaluation.harness import macro_recall_percent

    assert macro_recall_percent(true, pred, 9) == j_recall(true, pred, 9)
    feats = rng.standard_normal((200, 4))
    pc = PE.evaluate_classifier("c", lambda x: pred, feats, true, 7, unreliable_count=lambda: 3, verbose=False)
    jc = JE.evaluate_classifier("c", lambda x: pred, feats, true, 7, unreliable_count=lambda: 3, verbose=False)
    for f in ("name", "error_rate", "macro_recall", "checked_percent", "unreliable_percent"):
        assert getattr(pc, f) == getattr(jc, f), f

    def run(mod):
        return lambda t: mod.EvalResult("m", [4.0, 7.5, 5.0][t], [90.0, 85.0, 88.0][t], 1.0, 100.0)

    pa, ja = PE.repeated_splits_eval(run(PE), 3, verbose=False), JE.repeated_splits_eval(run(JE), 3, verbose=False)
    assert dataclasses.asdict(pa) == dataclasses.asdict(ja) and pa.extras["sigma"] > 0
