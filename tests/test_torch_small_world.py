"""The port's small-world search against the JAX package's (200 classes x
10 rows, D = 64). Tolerances: the neighbour table, rows and counts equal
(stable sorts, the same numpy generators); distances within 1e-6 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_image_recognition_tpu.search.small_world as J
import fast_image_recognition_tpu_torch.search.small_world as P
from fast_image_recognition_tpu.data import make_gallery_and_probes
from test_torch_synthetic import _one_thread  # noqa: F401  (autouse: one torch/BLAS thread)


@pytest.fixture(scope="module")
def dataset():
    return make_gallery_and_probes(200, 10, 1, 64, seed=0)


def test_neighbor_table_matches_jax(dataset):
    g = dataset[0]
    want = np.asarray(J.build_neighbor_table(jnp.asarray(g), k_nn=11, k_rand=4, seed=0))
    got = P.build_neighbor_table(torch.from_numpy(g), k_nn=11, k_rand=4, seed=0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not (got.numpy()[:, :11] == np.arange(g.shape[0])[:, None]).any()  # no self loops


@pytest.mark.parametrize("kw,budget", [({}, 50), ({}, 400), ({"pca_dim": 16}, 200)])
def test_routed_search_matches_jax(dataset, kw, budget):
    """The routed, restarting search at a tight and a loose budget, and the
    PCA-space walk with its full-D rescore."""
    g, _, p, _ = dataset
    jm = J.SmallWorldMatcher(g, seed=0, **kw)
    jm.set_budget(budget)
    pm = P.SmallWorldMatcher(g, seed=0, device="cpu", **kw)
    pm.set_budget(budget)
    assert pm.name == jm.name
    np.testing.assert_array_equal(pm.neighbors.numpy(), np.asarray(jm.neighbors))
    jr, pr = jm.search(p), pm.search(p)
    np.testing.assert_array_equal(pr.indices, jr.indices)
    np.testing.assert_array_equal(pr.checked_fraction, jr.checked_fraction)
    np.testing.assert_allclose(pr.distances, jr.distances, rtol=0, atol=1e-6)


def test_graph_walk_from_entries_matches_jax(dataset, monkeypatch):
    """The pure walk from the seeded per-row-distinct entries; the host
    reads "any active" every wave here and every SYNC_EVERY waves by
    default, with the same answers."""
    g, _, p, _ = dataset
    jm = J.SmallWorldMatcher(g, seed=0)
    jm.set_budget(100)
    pm = P.SmallWorldMatcher(g, seed=0, device="cpu")
    pm.set_budget(100)
    je, pe = jm._entry_ids(p.shape[0]), pm._entry_ids(p.shape[0])
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))
    ji, jd, jc = (np.asarray(x) for x in jm.search_device(jnp.asarray(p), entries=je))
    pi, pd, pc = pm.search_device(torch.from_numpy(p), entries=pe)
    np.testing.assert_array_equal(pi.numpy(), ji)
    np.testing.assert_array_equal(pc.numpy(), jc)
    np.testing.assert_allclose(pd.numpy(), jd, rtol=0, atol=1e-6)
    monkeypatch.setattr(P, "SYNC_EVERY", 1)
    pi1, _, pc1 = pm.search_device(torch.from_numpy(p), entries=pe)
    np.testing.assert_array_equal(pi1.numpy(), ji)
    np.testing.assert_array_equal(pc1.numpy(), jc)
