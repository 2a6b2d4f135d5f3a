"""Sharded search against JAX's (8 simulated CPU devices). Tolerances: rows equal,
distances 1e-6; shards bit-equal; packed projections but bf16 flips (< 0.1 %);
the service's rows = JAX's service fed the port's embeddings and the unsharded
``exact``'s."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_image_recognition_tpu.parallel.sharded_gallery as JS
from fast_image_recognition_tpu.data import make_synthetic_gallery
from fast_image_recognition_tpu.models import backbone_info as jax_info
from fast_image_recognition_tpu.ops import oracle_pairwise
from fast_image_recognition_tpu.ops.pca import fit_pca
from fast_image_recognition_tpu.parallel.mesh import gallery_mesh as jax_gallery_mesh
from fast_image_recognition_tpu.serving import RecognitionService as JaxService
from fast_image_recognition_tpu_torch.models.efficientnet import backbone_info, create_efficientnet
from fast_image_recognition_tpu_torch.models.fold import make_serving_fn
from fast_image_recognition_tpu_torch.parallel import (Mesh, ShardedGalleryMatcher, gallery_mesh, make_mesh,
    shard_gallery, shard_gallery_pca_aug, sharded_topk_l2, sharded_topk_pca_packed)
from fast_image_recognition_tpu_torch.serving import RecognitionService
from test_torch_synthetic import _one_thread, _unit, planted_gallery  # noqa: F401

TILE = 128


@pytest.fixture(scope="module")
def sets():
    gallery, _ = make_synthetic_gallery(24, 30, 128, seed=61)  # N=720
    probes, _ = make_synthetic_gallery(24, 1, 128, seed=62)
    return probes[:12], gallery


def cpu_mesh(s):
    return gallery_mesh(devices=["cpu"] * s)


@pytest.mark.parametrize("n_shards,precise,k,n", [(2, False, 3, 720), (4, True, 3, 720), (8, False, 5, 300), (2, False,
        8, 5)])
def test_sharded_topk_l2_matches_jax(sets, n_shards, precise, k, n):
    """(8, 300 rows, k=5): shards 3-7 empty; (2, 5 rows, k=8): JAX's tail (BIG_DIST / D, -1)."""
    q, g = sets
    g = g[:n]
    jm = jax_gallery_mesh(n_shards)
    jg, jn = JS.shard_gallery(g, jm, tile_g=TILE, dtype=jnp.float32 if precise else jnp.bfloat16)
    jd, ji = JS.sharded_topk_l2(q, jg, jm, k=k, n_valid_per_shard=jn, precise=precise, tile_g=TILE)
    pm = cpu_mesh(n_shards)
    pg, pn = shard_gallery(g, pm, tile_g=TILE, dtype=torch.float32 if precise else torch.bfloat16)
    np.testing.assert_array_equal(pn, jn)
    for s, shard in enumerate(pg):
        want = np.asarray(jg, np.float32)[s * shard.shape[0] : (s + 1) * shard.shape[0]]
        np.testing.assert_array_equal(shard.to(torch.float32).numpy(), want)
    pd, pi = sharded_topk_l2(torch.from_numpy(q), pg, pm, k=k, n_valid_per_shard=pn, precise=precise)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    if n < k:
        assert (pi.numpy()[:, n:] == -1).all()


def test_sharded_topk_pca_packed_matches_jax(sets):
    """Planted probes near rows of every shard and four off-gallery ones."""
    _, g = sets
    rng = np.random.default_rng(3)
    planted = np.linspace(0, len(g) - 1, 12).astype(int)
    q = np.concatenate([g[planted] + 0.01 * rng.standard_normal((12, 128)).astype(np.float32),
            0.1 * rng.standard_normal((4, 128)).astype(np.float32)])
    pca = fit_pca(g, num_components=28)
    mu, w = pca.mean, pca.components.T
    jm = jax_gallery_mesh(4)
    jg, jn = JS.shard_gallery(g, jm, tile_g=TILE, dtype=jnp.bfloat16)
    ja = JS.shard_gallery_pca_aug(jg, jn, jm, mu, w, tile_g=TILE)
    jd, ji = JS.sharded_topk_pca_packed(q, ja, jg, jm, mu, w, k=2, rescore=3, n_valid_per_shard=jn, tile_g=TILE)
    pm = cpu_mesh(4)
    pg, pn = shard_gallery(g, pm, tile_g=TILE)
    pa = shard_gallery_pca_aug(pg, pn, pm, mu, w, tile_g=TILE)
    assert [a.shape[0] for a in pa] == [s.shape[0] for s in pg]  # row-aligned with the shards
    flips = np.asarray(ja, np.float32) != torch.cat(pa).to(torch.float32).numpy()
    assert flips.mean() < 1e-3
    pd, pi = sharded_topk_pca_packed(torch.from_numpy(q), pa, pg, pm, mu, w, k=2, rescore=3,
            n_valid_per_shard=pn, tile_g=TILE)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pi.numpy()[:12, 0], planted)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


def test_matcher_two_level_mesh_and_shapes(sets):
    """The matcher finds the fp64 argmin; ('dcn', 'gallery') flattens as 8."""
    q, g = sets
    res = ShardedGalleryMatcher(g, cpu_mesh(4), precise=True, tile_g=32).search(q)
    dense = oracle_pairwise(q, g)
    np.testing.assert_array_equal(res.indices, dense.argmin(1))
    grid = np.empty(8, dtype=object)
    grid[:] = [torch.device("cpu")] * 8
    mesh2 = Mesh(grid.reshape(2, 4), ("dcn", "gallery"))
    axes = ("dcn", "gallery")
    pg, pn = shard_gallery(g, mesh2, tile_g=32, dtype=torch.float32, axes=axes)
    d2, i2 = sharded_topk_l2(torch.from_numpy(q), pg, mesh2, k=2, n_valid_per_shard=pn, precise=True, axes=axes)
    pg8, pn8 = shard_gallery(g, cpu_mesh(8), tile_g=32, dtype=torch.float32)
    d8, i8 = sharded_topk_l2(torch.from_numpy(q), pg8, cpu_mesh(8), k=2, n_valid_per_shard=pn8, precise=True)
    np.testing.assert_array_equal(i2.numpy(), i8.numpy())
    np.testing.assert_array_equal(i2.numpy()[:, 0], dense.argmin(1))
    mesh = make_mesh(data=2, gallery=2, model=2, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 2, "gallery": 2, "model": 2}
    assert len(mesh.shard_devices(("gallery",))) == 2
    with pytest.raises(ValueError):
        make_mesh(data=4, gallery=4, model=4, devices=["cpu"] * 8)


RES, PROBES, N = 64, 16, 4000


@pytest.fixture(scope="module")
def service_setup():
    """The port's B0 at 32 px, 64-px probes, 4,000 rows in a 96-d span of their embeddings."""
    _, variables = create_efficientnet("b0", seed=0, resolution=32, device="cpu")
    serve = make_serving_fn(variables, backbone_info("b0"), resolution=RES, device="cpu")
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (PROBES, RES, RES, 3)).astype(np.uint8)
    with torch.no_grad():
        emb = _unit(serve(torch.from_numpy(images))["embedding"].to(torch.float32).numpy())
    gal, planted = planted_gallery(emb, N, rng)
    return serve, images, emb, gal, planted


@pytest.mark.parametrize("scan", ["exact", "packed"])
def test_sharded_service_matches_jax(service_setup, scan):
    serve, images, emb, gal, planted = service_setup
    kw = dict(match="sharded", sharded_scan=scan, pca_dim=124, rescore=48)
    ps = RecognitionService(None, backbone_info("b0"), gal, resolution=RES, serving_fn=serve,
            mesh=cpu_mesh(4), device="cpu", **kw)
    with torch.no_grad():
        p_emb = ps._embed(torch.from_numpy(images)).numpy()
    js = JaxService(None, None, jax_info("b0"), gal, resolution=RES, mesh=jax_gallery_mesh(4),
            serving_fn=(lambda e, _images: {"embedding": e}, jnp.asarray(p_emb)), **kw)
    ji = np.asarray(js.identify_device(images))
    pi = ps.identify_device(torch.from_numpy(images))
    assert pi.dtype == torch.int32 and pi.shape == (PROBES,)
    np.testing.assert_array_equal(pi.numpy(), ji)
    np.testing.assert_array_equal(pi.numpy(), planted)
    exact = RecognitionService(None, backbone_info("b0"), gal, resolution=RES, serving_fn=serve, match="exact",
            device="cpu")
    np.testing.assert_array_equal(pi.numpy(), exact.identify_device(torch.from_numpy(images)).numpy())
    assert ps.match_flops(PROBES) == js.match_flops(PROBES)
