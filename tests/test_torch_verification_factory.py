"""Verification, factory and config against JAX's: the pairwise matrix within
1e-6, verification errors and sigma equal, joint-Bayesian scores 1e-4 relative,
feature-file rows 1e-6 (JAX's C++ parser), the eight matchers' rows equal."""

import dataclasses

import numpy as np
import pytest
import torch

import fast_image_recognition_tpu.config as JCFG
import fast_image_recognition_tpu.evaluation.verification as JV
import fast_image_recognition_tpu.factory as JFAC
import fast_image_recognition_tpu_torch.config as PCFG
import fast_image_recognition_tpu_torch.evaluation.verification as PV
import fast_image_recognition_tpu_torch.factory as PFAC
from fast_image_recognition_tpu.data import make_gallery_and_probes, write_feature_file
from fast_image_recognition_tpu.parallel.mesh import gallery_mesh as jax_gallery_mesh
from fast_image_recognition_tpu_torch.parallel import gallery_mesh
from test_torch_synthetic import _one_thread  # noqa: F401


@pytest.fixture(scope="module")
def sets():
    return make_gallery_and_probes(10, 12, 2, 64, seed=151)


def test_full_pairwise_matrix_matches_jax():
    g, _, _, _ = make_gallery_and_probes(6, 8, 2, 64, seed=5)
    want = JV.full_pairwise_matrix(g, end=32, block=16)
    got = PV.full_pairwise_matrix(g, end=32, block=16, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_verification_test_matches_jax():
    g, gl, _, _ = make_gallery_and_probes(10, 20, 1, 64, seed=6, within_class_noise=1.2)
    want = JV.verification_test(g, gl, tests=10, end=48, verbose=False)
    got = PV.verification_test(g, gl, tests=10, end=48, verbose=False, device="cpu")
    assert got.name == want.name and got.error_rate == want.error_rate and got.extras == want.extras
    assert got.error_rate > 0.0


def test_bayesian_verification_matches_jax():
    g, gl, p, pl = make_gallery_and_probes(10, 20, 4, 32, seed=8, within_class_noise=1.0)
    model = JV.fit_joint_bayesian(g, gl)
    pmodel = PV.fit_joint_bayesian(g, gl)
    np.testing.assert_array_equal(pmodel.A, model.A)
    want = JV.joint_bayesian_scores(model, p, g)
    got = PV.joint_bayesian_scores(pmodel, p, g, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    assert PV.joint_bayesian_verification(pmodel, g, gl, p, pl, device="cpu") == JV.joint_bayesian_verification(
        model, g, gl, p, pl)
    metric = JV.fit_bayesian_metric(g, gl, num_components=16)
    pmetric = PV.fit_bayesian_metric(g, gl, num_components=16)
    np.testing.assert_allclose(pmetric.inv_covar, metric.inv_covar, rtol=1e-9)
    assert PV.mahalanobis_verification(pmetric, g, gl, p, pl, device="cpu") == JV.mahalanobis_verification(
        metric, g, gl, p, pl)


def test_config_defaults_match_jax():
    for name in ("DatasetConfig", "MatcherConfig", "CascadeConfig", "MeshConfig", "FrameworkConfig"):
        j, p = getattr(JCFG, name)(), getattr(PCFG, name)()
        assert [f.name for f in dataclasses.fields(p)] == [f.name for f in dataclasses.fields(j)]
        for f in dataclasses.fields(p):
            jv, pv = getattr(j, f.name), getattr(p, f.name)
            if dataclasses.is_dataclass(jv):
                assert dataclasses.asdict(pv) == dataclasses.asdict(jv)
            else:
                assert pv == jv


@pytest.mark.parametrize("method", PFAC.METHODS)
def test_build_matcher_matches_jax(sets, method):
    g, gl, p, pl = sets
    cfg = PCFG.MatcherConfig(image_count_to_check=40)
    jcfg = JCFG.MatcherConfig(image_count_to_check=40)
    if method == "bf-sharded":
        pm = PFAC.build_matcher(method, g, gl, cfg, seed=1, mesh=gallery_mesh(devices=["cpu"] * 2))
        jm = JFAC.build_matcher(method, g, gl, jcfg, seed=1, mesh=jax_gallery_mesh(2))
    else:
        pm = PFAC.build_matcher(method, g, gl, cfg, seed=1, device="cpu")
        jm = JFAC.build_matcher(method, g, gl, jcfg, seed=1)
    assert pm.name == jm.name
    pr, jr = pm.search(p), jm.search(p)
    np.testing.assert_array_equal(pr.indices, jr.indices)
    floor = 0.6 if method == "sw" else 0.9
    assert (gl[pr.indices] == pl).mean() > floor


def test_build_matcher_unknown_and_twd_battery(sets):
    g, gl, p, pl = sets
    with pytest.raises(ValueError, match="unknown matcher"):
        PFAC.build_matcher("bogus", g, gl, device="cpu")
    port = PFAC.build_twd_classifiers(g, gl, 10, device="cpu")
    jax_ = JFAC.build_twd_classifiers(g, gl, 10)
    assert [c.name for c in port] == [c.name for c in jax_]
    for pc, jc in zip(port, jax_):
        np.testing.assert_array_equal(pc.predict(p), np.asarray(jc.predict(p)))


def test_dataset_from_config_matches_jax(tmp_path, sets):
    g, gl, p, pl = sets
    path = tmp_path / "db.txt"
    write_feature_file(str(path), np.concatenate([g, p]), np.concatenate([gl, pl]), [f"c{i}" for i in range(10)])
    kw = dict(features_file=str(path), features_count=64, train_images_per_class=10)
    want = JFAC.load_dataset_from_config(JCFG.DatasetConfig(**kw), seed=5)
    got = PFAC.load_dataset_from_config(PCFG.DatasetConfig(**kw), seed=5)
    for a, b in zip(got[1:4:2], want[1:4:2]):  # labels
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[0:4:2], want[0:4:2]):  # rows: JAX's default loader is its C++ parser
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    assert got[4] == want[4]
