"""DEM against JAX's (N = 384, D = 96): host pivots equal, P and minima rtol
1e-5; device pivots equal, P rtol 2e-4 + atol 1e-5 of the host's; rows vs the
oracle >= 92 %, checked within 2 on >= 90 % (JAX's bounds), vs JAX >= 92 %,
labels >= 97 %; full matrix >= 90 % / 85 %."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_image_recognition_tpu.search.dem as J
import fast_image_recognition_tpu_torch.search.dem as P
from fast_image_recognition_tpu.data import make_gallery_and_probes
from fast_image_recognition_tpu_torch.config import DistanceKind
from fast_image_recognition_tpu_torch.evaluation import evaluate_matcher
from fast_image_recognition_tpu_torch.search import BruteForceMatcher
from test_torch_synthetic import _one_thread  # noqa: F401


@pytest.fixture(scope="module")
def data():
    return make_gallery_and_probes(32, 12, 2, 96, seed=71)  # N=384


@pytest.fixture(scope="module")
def matcher(data):
    gallery, glabels, _, _ = data
    return P.DirectedEnumerationMatcher(gallery, glabels, seed=3, device="cpu")


def test_host_pivots_match_jax(data):
    gallery, glabels, _, _ = data
    jp, jm, jo = J.select_pivots(gallery, glabels, np.random.default_rng(0))
    pp, pm, po = P.select_pivots(gallery, glabels, np.random.default_rng(0), device="cpu")
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_allclose(pm, jm, rtol=1e-5)
    np.testing.assert_allclose(po, jo, rtol=1e-5)
    assert len(pp) == min(32, max(5, int(gallery.shape[0] * 0.015)))
    # chi2 pivots too (the exact probe mode takes any kind)
    jp, jm, _ = J.select_pivots(gallery, glabels, np.random.default_rng(1), kind=DistanceKind.CHI2)
    pp, pm, _ = P.select_pivots(gallery, glabels, np.random.default_rng(1), kind=DistanceKind.CHI2, device="cpu")
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_allclose(pm, jm, rtol=1e-5)


def test_device_build_matches_host_build(data):
    gallery, glabels, probes, _ = data
    piv_h, pm_h, om_h = P.select_pivots(gallery, glabels, np.random.default_rng(9), device="cpu")
    piv_d, pm_d, om_d = P.select_pivots_device(torch.from_numpy(gallery), torch.from_numpy(glabels), seed=9)
    piv_j, _, _ = J.select_pivots_device(jnp.asarray(gallery), glabels, seed=9)
    np.testing.assert_array_equal(piv_d, piv_h)
    np.testing.assert_array_equal(piv_d, piv_j)
    np.testing.assert_allclose(pm_d.numpy(), pm_h, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(om_d, om_h, rtol=2e-4, atol=1e-5)
    host_m = P.DirectedEnumerationMatcher(gallery, glabels, seed=9, probe_mode="gather", image_count_to_check=60,
            device="cpu")
    dev_m = P.DirectedEnumerationMatcher.from_device(torch.from_numpy(gallery), glabels, seed=9,
            image_count_to_check=60, device="cpu")
    assert dev_m.budget == host_m.budget and dev_m.index.p_matrix is None
    assert abs(dev_m.index.threshold - host_m.index.threshold) <= 1e-3 * max(1.0, abs(host_m.index.threshold))
    r_h, r_d = host_m.search(probes), dev_m.search(probes)
    assert float(np.mean(glabels[r_h.indices] == glabels[r_d.indices])) >= 0.9


def test_matches_oracle_probe_semantics(data, matcher):
    gallery, _, probes, _ = data
    budget = 60
    matcher.set_budget(budget)
    res = matcher.search(probes)
    agree = checked_close = 0
    for i in range(probes.shape[0]):
        oi, _, oc = P.dem_oracle_search(probes[i], gallery, matcher.index, budget)
        agree += int(res.indices[i] == oi)
        checked_close += int(abs(int(round(res.checked_fraction[i] * gallery.shape[0])) - oc) <= 2)
    assert agree >= int(0.92 * probes.shape[0])
    assert checked_close >= int(0.9 * probes.shape[0])


def test_oracles_equal_jax(data, matcher):
    """The port's NumPy walks are the JAX package's."""
    gallery, _, probes, _ = data
    for i in range(0, probes.shape[0], 8):
        assert P.dem_oracle_search(probes[i], gallery, matcher.index, 60) == J.dem_oracle_search(
            probes[i], gallery, J.DEMIndex(*dataclass_fields(matcher.index)), 60)
    full = P.FullMatrixDEM(gallery, data[1], seed=3, device="cpu")
    p_full, starts = full._p_full.numpy(), full._start_idx.numpy()
    for i in range(0, probes.shape[0], 16):
        assert P.dem_full_oracle_search(probes[i], gallery, p_full, starts, full.threshold, 50) == \
            J.dem_full_oracle_search(probes[i], gallery, p_full, starts, full.threshold, 50)


def dataclass_fields(index):
    return index.pivot_indices, index.p_matrix, index.threshold


@pytest.mark.parametrize("probe_mode", ["exact", "gather"])
@pytest.mark.parametrize("budget", [0, 40, 120])
def test_rows_match_jax(data, probe_mode, budget):
    gallery, glabels, probes, _ = data
    jm = J.DirectedEnumerationMatcher(gallery, glabels, seed=3, probe_mode=probe_mode)
    pm = P.DirectedEnumerationMatcher(gallery, glabels, seed=3, probe_mode=probe_mode, device="cpu")
    np.testing.assert_array_equal(pm.index.pivot_indices, jm.index.pivot_indices)
    assert pm.index.threshold == pytest.approx(jm.index.threshold, rel=1e-6)
    jm.set_budget(budget)
    pm.set_budget(budget)
    assert pm.budget == jm.budget
    rj, rp = jm.search(probes), pm.search(probes)
    assert rp.indices.dtype == np.int32 and rp.checked_fraction.dtype == np.float32
    assert (rp.indices == rj.indices).mean() >= 0.92
    assert (glabels[rp.indices] == glabels[rj.indices]).mean() >= 0.97


def test_full_budget_matches_brute_force(data, matcher):
    gallery, glabels, probes, _ = data
    matcher.set_budget(0)
    res = matcher.search(probes)
    bf = BruteForceMatcher(gallery, device="cpu").search(probes)
    assert (glabels[res.indices] == glabels[bf.indices]).mean() >= 0.95


def test_accuracy_improves_with_budget(data):
    gallery, glabels, probes, plabels = data
    m = P.DirectedEnumerationMatcher(gallery, glabels, seed=5, threshold=1e-12, device="cpu")
    errors, checked = [], []
    for ratio in (0.05, 0.2, 0.6):
        m.set_budget(int(ratio * gallery.shape[0]))
        r = evaluate_matcher(m, glabels, probes, plabels, num_classes=32, verbose=False)
        errors.append(r.error_rate)
        checked.append(r.checked_percent)
    assert errors[-1] <= errors[0] + 1e-9
    assert checked[0] < checked[-1] <= 100.0


def test_early_exit_reduces_checked(data):
    gallery, glabels, _, _ = data
    m = P.DirectedEnumerationMatcher(gallery, glabels, seed=7, device="cpu")
    m.set_budget(gallery.shape[0])
    res = m.search(gallery[:16])  # self-queries: distance 0 < threshold
    assert (res.checked_fraction * gallery.shape[0] <= len(m.index.pivot_indices) + 2).all()
    np.testing.assert_array_equal(glabels[res.indices], glabels[:16])


def test_gather_mode_matches_exact(data):
    gallery, glabels, probes, _ = data
    exact = P.DirectedEnumerationMatcher(gallery, glabels, seed=3, device="cpu")
    gather = P.DirectedEnumerationMatcher(gallery, glabels, seed=3, probe_mode="gather", device="cpu")
    for budget in (40, 120):
        exact.set_budget(budget)
        gather.set_budget(budget)
        re, rg = exact.search(probes), gather.search(probes)
        assert (re.indices == rg.indices).mean() > 0.9
        assert (glabels[re.indices] == glabels[rg.indices]).mean() > 0.97


def test_gather_mode_rejects_chi2(data):
    gallery, glabels, _, _ = data
    with pytest.raises(ValueError, match="L2 only"):
        P.DirectedEnumerationMatcher(gallery, glabels, kind=DistanceKind.CHI2, probe_mode="gather", device="cpu")


def test_budget_at_or_below_pivot_count_probes_zero_candidates(data, matcher):
    gallery, _, probes, _ = data
    n_pivots = len(matcher.index.pivot_indices)
    matcher.set_budget(n_pivots)
    assert matcher.budget == 0
    res = matcher.search(probes)
    for i in range(probes.shape[0]):
        oi, od, oc = P.dem_oracle_search(probes[i], gallery, matcher.index, n_pivots)
        assert int(round(res.checked_fraction[i] * gallery.shape[0])) == oc
        assert res.indices[i] == oi
        np.testing.assert_allclose(res.distances[i], od, rtol=1e-4)
    matcher.set_budget(0)


@pytest.mark.parametrize("probe_mode", ["exact", "gather"])
def test_batch_invariance(data, probe_mode):
    gallery, glabels, probes, _ = data
    m = P.DirectedEnumerationMatcher(gallery, glabels, seed=3, probe_mode=probe_mode, device="cpu")
    m.set_budget(60)
    batched = m.search(probes)
    singles = np.concatenate([m.search(probes[i : i + 1]).indices for i in range(probes.shape[0])])
    assert (batched.indices == singles).mean() >= 0.95
    assert (glabels[batched.indices] == glabels[singles]).mean() >= 0.97


def test_search_device_stays_on_device(data, matcher):
    _, _, probes, _ = data
    matcher.set_budget(60)
    idx, dist, checked = matcher.search_device(torch.from_numpy(probes))
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32 and checked.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), matcher.search(probes).indices)


def test_full_dem_matches_oracle_and_jax(data):
    gallery, glabels, probes, _ = data
    jf = J.FullMatrixDEM(gallery, glabels, seed=3)
    pf = P.FullMatrixDEM(gallery, glabels, seed=3, device="cpu")
    assert pf.threshold == pytest.approx(jf.threshold, rel=1e-5)
    budget = 60
    jf.set_budget(budget)
    pf.set_budget(budget)
    res = pf.search(probes)
    p_full, starts = pf._p_full.numpy(), pf._start_idx.numpy()
    agree = checked_close = 0
    for i in range(probes.shape[0]):
        oi, _, oc = P.dem_full_oracle_search(probes[i], gallery, p_full, starts, pf.threshold, budget)
        agree += int(res.indices[i] == oi)
        checked_close += int(abs(int(round(res.checked_fraction[i] * gallery.shape[0])) - oc) <= 2)
    assert agree >= int(0.9 * probes.shape[0])
    assert checked_close >= int(0.85 * probes.shape[0])
    assert (res.indices == jf.search(probes).indices).mean() >= 0.9


def test_full_dem_unlimited_budget_is_exact(data):
    gallery, glabels, probes, _ = data
    m = P.FullMatrixDEM(gallery, glabels, threshold=1e-12, seed=3, device="cpu")
    m.set_budget(0)
    res = m.search(probes)
    bf = BruteForceMatcher(gallery, device="cpu").search(probes)
    np.testing.assert_array_equal(res.indices, bf.indices)
    np.testing.assert_allclose(res.distances, bf.distances, rtol=1e-4, atol=1e-5)
