"""The port's window distances (``ops/distances.py``) against the JAX
package's on the same numpy-seeded inputs (the sets of
tests/test_distances.py).

Tolerances:
- ``oracle_distance`` / ``oracle_pairwise``: the port's copies are the
  same NumPy code, so bit-equal;
- ``pairwise_distances``: rtol 2e-4, atol 1e-7 (tests/test_distances.py's
  own bound against the oracle; fp32 sums in another order); L2 with
  ``precise=False``: rtol 0.05, atol 1e-4, as tests/test_distances.py
  holds the bf16 path;
- ``streamed_topk``: distances within rtol 2e-4, atol 1e-7; rows equal,
  except two rows whose fp64 oracle distances agree within 2^-16 relative
  (fp32 sums in another order may order them either way);
- ``window_distance_update``: rtol 1e-5, atol 1e-8, as
  tests/test_distances.py holds the identity.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_image_recognition_tpu.config import DistanceKind as JKind
from fast_image_recognition_tpu.data import make_synthetic_gallery
from fast_image_recognition_tpu.ops import distances as J
from fast_image_recognition_tpu_torch.config import DistanceKind
from fast_image_recognition_tpu_torch.ops import distances as P
from test_torch_synthetic import _one_thread  # noqa: F401  (autouse: one torch/BLAS thread)

KINDS = ["l2", "chi2", "kl"]
WINDOWS = [(0, None), (0, 32), (16, 48)]


@pytest.fixture(scope="module")
def small_sets():
    g, _ = make_synthetic_gallery(8, 8, 64, seed=11)
    q, _ = make_synthetic_gallery(8, 2, 64, seed=12)
    return q[:6], g[:40]


def test_kinds_are_the_jax_values():
    assert [k.value for k in DistanceKind] == [k.value for k in JKind]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("window", WINDOWS + [(32, 64)])
def test_oracles_bit_equal(small_sets, kind, window):
    q, g = small_sets
    start, end = window
    np.testing.assert_array_equal(
        P.oracle_pairwise(q, g, start, end, DistanceKind(kind)), J.oracle_pairwise(q, g, start, end, JKind(kind))
    )
    for i, j in [(0, 0), (3, 17), (5, 39)]:
        a = P.oracle_distance(q[i], g[j], start, end, DistanceKind(kind))
        b = J.oracle_distance(q[i], g[j], start, end, JKind(kind))
        assert a.dtype == np.float32 and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("window", WINDOWS)
def test_pairwise_matches_jax(small_sets, kind, window):
    q, g = small_sets
    start, end = window
    got = P.pairwise_distances(torch.from_numpy(q), torch.from_numpy(g), start, end, DistanceKind(kind))
    want = np.asarray(J.pairwise_distances(q, g, start=start, end=end, kind=JKind(kind)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-7)


@pytest.mark.parametrize("window", WINDOWS)
def test_pairwise_l2_fast_path_matches_jax(small_sets, window):
    q, g = small_sets
    start, end = window
    got = P.pairwise_distances(torch.from_numpy(q), torch.from_numpy(g), start, end, precise=False)
    want = np.asarray(J.pairwise_distances(q, g, start=start, end=end, precise=False))
    np.testing.assert_allclose(got.numpy(), want, rtol=0.05, atol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 5])
def test_streamed_topk_matches_jax(kind, k):
    """300 rows in tiles of 128 (the last one ragged), and the default
    tile (one tile here); a window for L2."""
    g, _ = make_synthetic_gallery(30, 10, 64, seed=5, l2=kind == "l2")
    q, _ = make_synthetic_gallery(30, 1, 64, seed=6, l2=kind == "l2")
    q = q[:7]
    end = 48 if kind == "l2" else None
    oracle = J.oracle_pairwise(q, g, 0, end, JKind(kind))
    for tile_n in (128, None):
        jd, ji = (np.asarray(a) for a in J.streamed_topk(q, g, k=k, end=end, kind=JKind(kind), tile_n=tile_n))
        pd, pi = P.streamed_topk(torch.from_numpy(q), torch.from_numpy(g), k=k, end=end, kind=DistanceKind(kind),
                                 tile_n=tile_n)
        assert pd.shape == (7, k) and pi.dtype == torch.int32
        pd, pi = pd.numpy(), pi.numpy()
        np.testing.assert_allclose(pd, jd, rtol=2e-4, atol=1e-7)
        rows = np.arange(7)[:, None]
        tie = np.abs(oracle[rows, pi] - oracle[rows, ji]) <= 2.0**-16 * oracle[rows, ji]
        assert ((pi == ji) | tie).all()


def test_streamed_topk_pads_past_the_gallery():
    """k > N: the slots past the gallery hold (3.4e38 / width, -1), as in
    JAX; equal rows go to the lower index."""
    g = np.abs(np.random.default_rng(0).standard_normal((3, 16))).astype(np.float32)
    g = np.concatenate([g, g[:1]])  # row 3 equals row 0
    q = g[:2] + 0.01
    jd, ji = (np.asarray(a) for a in J.streamed_topk(q, g, k=6, kind=JKind.CHI2, tile_n=128))
    pd, pi = P.streamed_topk(torch.from_numpy(q), torch.from_numpy(g), k=6, kind=DistanceKind.CHI2, tile_n=128)
    np.testing.assert_array_equal(pi.numpy(), ji)
    np.testing.assert_allclose(pd.numpy(), jd, rtol=2e-4, atol=1e-7)
    assert (pi.numpy()[:, 4:] == -1).all()
    assert list(pi.numpy()[0, :2]) == [0, 3]


def test_window_refinement_identity_matches_jax(small_sets):
    q, g = small_sets
    pq, pg = torch.from_numpy(q), torch.from_numpy(g)
    d32 = P.pairwise_distances(pq, pg, start=0, end=32)
    d64 = P.window_distance_update(d32, pq, pg, start=32, end=64, total_start=0)
    fresh = P.pairwise_distances(pq, pg, start=0, end=64)
    np.testing.assert_allclose(d64.numpy(), fresh.numpy(), rtol=1e-5, atol=1e-8)
    jd = J.window_distance_update(J.pairwise_distances(q, g, start=0, end=32), jnp.asarray(q), jnp.asarray(g),
                                  start=32, end=64, total_start=0)
    np.testing.assert_allclose(d64.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-8)
