"""Gallery layouts and top-k rules against JAX's interpret-mode kernels.
Tolerances: packed layouts equal, |g|^2 to 2^-16; ties to the lowest row;
near-collinear distances within 2^-20 of fp64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_image_recognition_tpu.ops.distance_kernel as J
import fast_image_recognition_tpu_torch.ops.distance_kernel as P
from fast_image_recognition_tpu_torch.kernels import build
from test_torch_synthetic import _one_thread, _unit  # noqa: F401


N_VALID, N_PAD, DIM = 3000, 4096, 124


@pytest.fixture(scope="module")
def gallery():
    rng = np.random.default_rng(0)
    g = _unit(rng.standard_normal((N_VALID, DIM)))
    return g, J.pack_gallery_aug(jnp.asarray(g, jnp.bfloat16), N_VALID), P.pack_gallery_aug(
        torch.from_numpy(g).to(torch.bfloat16), N_VALID
    )


def test_pack_gallery_aug_layout(gallery):
    g, jaug, paug = gallery
    jaug = np.asarray(jaug.astype(jnp.float32))
    paug = paug.float().numpy()
    assert paug.shape == jaug.shape == (N_PAD - 1024, 128)  # 3000 rows -> 3 tiles
    np.testing.assert_array_equal(paug[:, :DIM], jaug[:, :DIM])
    np.testing.assert_array_equal(paug[:, DIM + 2 :], jaug[:, DIM + 2 :])
    # |g|^2 = hi + lo to 2^-16 (sum order can move the bf16 split)
    np.testing.assert_allclose(
        paug[:, DIM] + paug[:, DIM + 1], jaug[:, DIM] + jaug[:, DIM + 1], rtol=2.0**-16
    )
    assert (paug[N_VALID:, DIM] > 1e37).all()


def test_topk_l2_ties_and_pads():
    """Duplicated rows: the lower index wins; k > n_valid: -1 past the valid rows."""
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
    """An unknown ``select``, k < 1 and other devices raise; launchers refuse CPU tensors before a build."""
    q = torch.zeros((2, 16), dtype=torch.bfloat16)
    g = P.pad_gallery(q, 128)
    torch.testing.assert_close(P.topk_candidates_l2(q, g, 1, tile_g=128, select="approx"),
            P.topk_candidates_l2(q, g, 1, tile_g=128), rtol=0, atol=0)
    with pytest.raises(ValueError):
        P.topk_candidates_l2(q, g, 1, tile_g=128, select="nope")
    with pytest.raises(ValueError):
        P.topk_l2(q, q, 0)
    assert P.topk_l2(q, q, 17, precise=True)[1].shape == (2, 17)
    with pytest.raises(ValueError):
        P.topk_l2(q.to("meta"), q.to("meta"), 1)
    with pytest.raises(ValueError):
        P.tile_min_l2(q.to("meta"), q.to("meta"), tile_g=128)
    f = q.float()
    i8 = torch.zeros((2, 16), dtype=torch.int8)
    rows = torch.zeros(1024)
    with pytest.raises(ValueError, match="CUDA"):
        build.launch_topk_l2(q, q, 1, 2)
    with pytest.raises(ValueError, match="CUDA"):
        build.launch_topk_l2(f, q, 1, 2, window=(0, 8), precise=True)
    with pytest.raises(ValueError, match="CUDA"):
        build.launch_tilemin2_packed(q, q)
    with pytest.raises(ValueError, match="CUDA"):
        build.launch_tilemin_packed(q, q, 128)
    with pytest.raises(ValueError, match="CUDA"):
        build.launch_tilemin(q, q, rows, 128, False)
    with pytest.raises(ValueError, match="CUDA"):
        build.launch_tilemin_quant(i8, rows, i8, rows, rows, 128, "int8")


def test_topk_l2_near_collinear_distances():
    """Cosines ~0.99996: JAX's expansion cancels; the port's pass 3 gives (q -
    g)^2 within 2^-20 of fp64, ascending, JAX's top-1."""
    rng = np.random.default_rng(7)
    gt = torch.from_numpy(_unit(rng.standard_normal(2048) + 0.002 * rng.standard_normal((512, 2048)))).bfloat16()
    q = torch.from_numpy(_unit(gt[:8].double().numpy() + 2e-4 * rng.standard_normal((8, 2048)))).bfloat16()
    pd, pi = (x.numpy() for x in P.topk_l2(q, gt, 4))
    jd, ji = (np.asarray(x) for x in J.topk_l2(jnp.asarray(q.float().numpy()), jnp.asarray(gt.float().numpy()), 4))
    qd, gd = q.double().numpy()[:, None], gt.double().numpy()
    exact, dj = (((qd - gd[i]) ** 2).sum(-1) / 2048 for i in (pi, ji))
    np.testing.assert_allclose(pd, exact, rtol=2.0**-20)
    assert (np.diff(pd, axis=1) >= 0).all() and (pi[:, 0] == ji[:, 0]).all()
    assert np.abs(jd - dj).max() > 100 * np.abs(pd - exact).max()
