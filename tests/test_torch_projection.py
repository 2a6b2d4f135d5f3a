"""The port's projection and kd-forest matchers against the JAX package's
(100 classes x 10 rows, D = 64). Tolerances: rows and checked fractions
equal, projection distances within 1e-6 absolute; the kd-forest (the same
numpy code) bit-equal.
"""

import numpy as np
import pytest

import fast_image_recognition_tpu.search.projection as J
import fast_image_recognition_tpu_torch.search.projection as P
from fast_image_recognition_tpu.data import make_gallery_and_probes
from test_torch_synthetic import _one_thread  # noqa: F401  (autouse: one torch/BLAS thread)


@pytest.fixture(scope="module")
def dataset():
    return make_gallery_and_probes(100, 10, 2, 64, seed=0)


@pytest.mark.parametrize("kw,budget", [({}, 50), ({"proj_type": "pca"}, 100), ({}, 0)])
def test_projection_matcher_matches_jax(dataset, kw, budget):
    g, _, p, _ = dataset
    jm = J.ProjectionIndexMatcher(g, **kw)
    jm.set_budget(budget)
    pm = P.ProjectionIndexMatcher(g, device="cpu", **kw)
    pm.set_budget(budget)
    assert pm.name == jm.name and pm.budget == jm.budget
    jr, pr = jm.search(p), pm.search(p)
    np.testing.assert_array_equal(pr.indices, jr.indices)
    np.testing.assert_array_equal(pr.checked_fraction, jr.checked_fraction)
    np.testing.assert_allclose(pr.distances, jr.distances, rtol=0, atol=1e-6)


@pytest.mark.parametrize("budget", [0, 60])
def test_kdtree_matches_jax(dataset, budget):
    g, _, p, _ = dataset
    jr = J.KDTreeMatcher(g, image_count_to_check=budget).search(p)
    pr = P.KDTreeMatcher(g, image_count_to_check=budget).search(p)
    np.testing.assert_array_equal(pr.indices, jr.indices)
    np.testing.assert_array_equal(pr.distances, jr.distances)
    np.testing.assert_array_equal(pr.checked_fraction, jr.checked_fraction)
    if budget == 0:  # unlimited checks: the exact 1-NN
        d = ((p[:, None, :].astype(np.float64) - g[None]) ** 2).sum(-1)
        np.testing.assert_array_equal(pr.indices, d.argmin(1))
