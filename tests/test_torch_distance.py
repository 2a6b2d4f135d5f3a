"""The port's gallery scans (plain PyTorch versions, as they run on the CPU)
against the JAX package's Pallas kernels in interpret mode.

Tolerances, each from the arithmetic the two sides share:
- packed keys: both take bf16 x bf16 products summed in fp32, in another
  order; the masked low 10 bits hide most of that, so decoded distances
  agree within 2^-12 relative and the rows they carry agree except where
  two rows tie within that;
- certified candidates: identical sets except tiles swapped at such a
  near-tie; the bound within 2^-12 relative;
- exact top-k: identical indices except near-ties (distance gap under
  2^-12 relative), distances to rtol 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_image_recognition_tpu.ops.distance_kernel as J
import fast_image_recognition_tpu_torch.ops.distance_kernel as P
from fast_image_recognition_tpu_torch.kernels import build

N_VALID, N_PAD, DIM = 3000, 4096, 124
REL = 2.0**-12


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def gallery():
    rng = np.random.default_rng(0)
    g = _unit(rng.standard_normal((N_VALID, DIM)))
    return g, J.pack_gallery_aug(jnp.asarray(g, jnp.bfloat16), N_VALID), P.pack_gallery_aug(
        torch.from_numpy(g).to(torch.bfloat16), N_VALID
    )


def _queries(g, b, seed):
    rng = np.random.default_rng(seed)
    base = g[rng.integers(0, N_VALID, b)]
    return _unit(base + 0.4 * rng.standard_normal((b, DIM)) / np.sqrt(DIM))


def test_pack_gallery_aug_layout(gallery):
    g, jaug, paug = gallery
    jaug = np.asarray(jaug.astype(jnp.float32))
    paug = paug.float().numpy()
    assert paug.shape == jaug.shape == (N_PAD - 1024, 128)  # 3000 rows -> 3 tiles
    np.testing.assert_array_equal(paug[:, :DIM], jaug[:, :DIM])
    np.testing.assert_array_equal(paug[:, DIM + 2 :], jaug[:, DIM + 2 :])
    # |g|^2 = hi + lo: the fp32 sums differ in order by a few ulp, which
    # can move the bf16 hi/lo split; the pair carries |g|^2 to 2^-16
    np.testing.assert_allclose(
        paug[:, DIM] + paug[:, DIM + 1], jaug[:, DIM] + jaug[:, DIM + 1], rtol=2.0**-16
    )
    assert (paug[N_VALID:, DIM] > 1e37).all()


@pytest.mark.parametrize("b", [8, 130])
def test_tile_min2_and_certificate_match_jax(gallery, b):
    g, jaug, paug = gallery
    q = _queries(g, b, seed=b)
    jd1, ji, jd2 = (np.asarray(x) for x in J.tile_min2_l2_packed(jnp.asarray(q), jaug, DIM))
    pd1, pi, pd2 = (x.numpy() for x in P.tile_min2_l2_packed(torch.from_numpy(q), paug, DIM))
    np.testing.assert_allclose(pd1, jd1, rtol=REL, atol=1e-6)
    np.testing.assert_allclose(pd2, jd2, rtol=REL, atol=1e-6)
    moved = pi != ji  # a tile's best row may differ only at a near-tie
    dense = ((q[:, None, :] - g[None, :, :]) ** 2).sum(-1)
    d_other = dense[np.arange(b)[:, None], np.minimum(pi, N_VALID - 1)]
    d_ref = dense[np.arange(b)[:, None], np.minimum(ji, N_VALID - 1)]
    assert (np.abs(d_other - d_ref)[moved] <= 2e-2 * d_ref[moved] + 1e-4).all()
    assert moved.mean() < 0.02

    r = 2  # fewer candidates than tiles, so both halves of the bound act
    jc, jb = (np.asarray(x) for x in J.topk_candidates_l2_packed_cert(jnp.asarray(q), jaug, DIM, r))
    pc, pb = (x.numpy() for x in P.topk_candidates_l2_packed_cert(torch.from_numpy(q), paug, DIM, r))
    np.testing.assert_allclose(pb, jb, rtol=REL)
    for row in range(b):
        if set(pc[row]) != set(jc[row]):
            # the swapped tiles' minima tie within the shared rounding
            kth = np.sort(jd1[row])[r - 1 : r + 1]
            assert kth[1] - kth[0] <= REL * kth[1] + 1e-6
        # soundness: the bound never exceeds the true unscored minimum by
        # more than bf16 operand rounding
        unscored = np.setdiff1d(np.arange(N_VALID), pc[row])
        assert pb[row] <= dense[row, unscored].min() * 1.03 + 1e-4


@pytest.mark.parametrize("b", [8, 130])
@pytest.mark.parametrize("k", [1, 4, 16])
def test_topk_l2_matches_jax(gallery, b, k):
    g, _, _ = gallery
    q = _queries(g, b, seed=100 + b)
    jg = J.pad_gallery(jnp.asarray(g, jnp.bfloat16))
    pg = P.pad_gallery(torch.from_numpy(g).to(torch.bfloat16))
    jd, ji = (np.asarray(x) for x in J.topk_l2(jnp.asarray(q), jg, k, n_valid=N_VALID))
    pd, pi = (x.numpy() for x in P.topk_l2(torch.from_numpy(q), pg, k, n_valid=N_VALID))
    assert pi.dtype == np.int32 and pi.shape == (b, k)
    np.testing.assert_allclose(pd, jd, rtol=1e-3)
    # rows may differ only where their true distances (from the bf16 values
    # both sides scan) tie within fp32 sum-order rounding
    qb = torch.from_numpy(q).to(torch.bfloat16).double().numpy()
    gb = torch.from_numpy(g).to(torch.bfloat16).double().numpy()
    d_port = ((qb[:, None, :] - gb[pi]) ** 2).sum(-1)
    d_jax = ((qb[:, None, :] - gb[ji]) ** 2).sum(-1)
    np.testing.assert_allclose(pd * DIM, d_port, rtol=1e-3, atol=1e-5)
    assert ((pi == ji) | (np.abs(d_port - d_jax) <= REL * d_jax + 1e-7)).all()


def test_topk_l2_ties_and_pads():
    """Duplicated rows: the lower index wins, as the TPU kernel's masked
    argmin + carry-first merge decide; k > n_valid: -1 past the valid rows."""
    rng = np.random.default_rng(5)
    base = _unit(rng.standard_normal((6, 32)))
    g = np.concatenate([base, base, base[:2]])  # rows i, i+6, i+12 identical
    q = base[[3, 0, 5]]
    for k in (2, 3):
        jd, ji = (np.asarray(x) for x in J.topk_l2(jnp.asarray(q), jnp.asarray(g, jnp.bfloat16), k))
        pd, pi = (x.numpy() for x in P.topk_l2(torch.from_numpy(q), torch.from_numpy(g).to(torch.bfloat16), k))
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pi[:, 0], [3, 0, 5])
        np.testing.assert_array_equal(pi[:, 1], [9, 6, 11])
    jd, ji = (np.asarray(x) for x in J.topk_l2(jnp.asarray(q), jnp.asarray(g, jnp.bfloat16), 16, n_valid=5))
    pd, pi = (x.numpy() for x in P.topk_l2(torch.from_numpy(q), torch.from_numpy(g).to(torch.bfloat16), 16, n_valid=5))
    np.testing.assert_array_equal(pi, ji)
    assert (pi[:, 5:] == -1).all() and (pi[:, :5] >= 0).all()
    np.testing.assert_allclose(pd, jd, rtol=1e-3)


def test_gallery_sq_norms_layout(gallery):
    g, _, _ = gallery
    jg = np.asarray(J.gallery_sq_norms(jnp.asarray(g, jnp.bfloat16), N_VALID))
    pg = P.gallery_sq_norms(torch.from_numpy(g).to(torch.bfloat16), N_VALID).numpy()
    assert pg.shape == jg.shape == (8, 1024)
    np.testing.assert_allclose(pg, jg, rtol=1e-6)  # 124-term fp32 sums, another order


def test_unported_options_raise_and_card_wrappers_check_device():
    q = torch.zeros((2, 16), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        P.topk_l2(q, q, 1, window=(0, 8))
    with pytest.raises(NotImplementedError):
        P.topk_l2(q, q, 1, precise=True)
    with pytest.raises(NotImplementedError):
        P.topk_l2(q, q, 17)
    with pytest.raises(ValueError):
        P.topk_l2(q.to("meta"), q.to("meta"), 1)
    # the launchers refuse CPU tensors before any build is attempted
    with pytest.raises(ValueError, match="CUDA"):
        build.launch_topk_l2(q, q, 1, 2)
    with pytest.raises(ValueError, match="CUDA"):
        build.launch_tilemin2_packed(q, q)
