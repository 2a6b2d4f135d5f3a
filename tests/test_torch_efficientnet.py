"""The folded EfficientNet forward (preprocess fold, s2d stem, explicit resize)
against JAX's. Tolerances: fp32 rtol 1e-4 of max |reference| (covers the
resize's weights); bf16 cosine >= 0.999; the s2d stem 2e-5 (JAX's)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_image_recognition_tpu.models import backbone_info as jax_info
from fast_image_recognition_tpu.models import create_backbone
from fast_image_recognition_tpu.models import efficientnet as jeff
from fast_image_recognition_tpu.models.efficientnet import EfficientNet
from fast_image_recognition_tpu.models.fold import make_serving_fn as jax_serving_fn
from fast_image_recognition_tpu.models import inference as jinf
from fast_image_recognition_tpu_torch.models import inference as pinf
from fast_image_recognition_tpu_torch.models import efficientnet as peff
from fast_image_recognition_tpu_torch.models.efficientnet import default_taps
from fast_image_recognition_tpu_torch.models.fold import make_serving_fn
from fast_image_recognition_tpu_torch.models.efficientnet import backbone_info
from fast_image_recognition_tpu_torch.utils.checkpoint import load_variables
from test_torch_synthetic import _one_thread  # noqa: F401


CKPT = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "trained_b0_224_synthetic1024_s0.npz")
TAPS = ("block1a", "block2a", "block3a", *default_taps("b0"))


def _jax_forward(variables, res, images, dtype, taps=TAPS):
    model = EfficientNet(variant="b0", dtype=dtype)
    folded, configs = jinf.fold_backbone(model, variables, dtype=dtype)
    folded = jinf.fold_preprocess_into_stem(folded, res, dtype=dtype)
    fn = jax.jit(lambda f, x: jinf.folded_forward(f, configs, x, taps=taps, resolution=res, dtype=dtype))
    out = fn(folded, jnp.asarray(images))
    return np.asarray(out["embedding"]), {k: np.asarray(v) for k, v in out["taps"].items()}


def _port_forward(variables, res, images, dtype, taps=TAPS):
    folded, configs = pinf.fold_backbone(variables, "b0", dtype=dtype)
    folded = pinf.fold_preprocess_into_stem(folded, res, dtype=dtype)
    module = pinf.FoldedEfficientNet(folded, configs, res, taps=taps)
    with torch.no_grad():
        out = module(torch.from_numpy(images))
    return out["embedding"].numpy(), {k: v.numpy() for k, v in out["taps"].items()}


def _close(port, ref, rtol):
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


@pytest.fixture(scope="module")
def random_b0_64():
    # parameters do not depend on the resolution; a small init compiles faster
    _, variables = create_backbone("b0", 0, resolution=32, dtype=jnp.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    )
    images = np.random.default_rng(0).integers(0, 256, (3, 64, 64, 3)).astype(np.uint8)
    return variables, images


@pytest.fixture(scope="module")
def trained():
    v = load_variables(CKPT)
    return {"params": v["params"], "batch_stats": v["batch_stats"]}


def test_random_init_b0_64_fp32_embedding_and_taps(random_b0_64):
    variables, images = random_b0_64
    jemb, jtaps = _jax_forward(variables, 64, images, jnp.float32)
    pemb, ptaps = _port_forward(variables, 64, images, torch.float32)
    assert pemb.shape == jemb.shape == (3, 1280)
    _close(pemb, jemb, 1e-4)
    assert set(ptaps) == set(jtaps) == set(TAPS)
    for name in TAPS:
        _close(ptaps[name], jtaps[name], 1e-4)


def test_trained_b0_224_fp32_full_width(trained):
    images = np.random.default_rng(1).integers(0, 256, (2, 224, 224, 3)).astype(np.uint8)
    jemb, _ = _jax_forward(trained, 224, images, jnp.float32, taps=())
    pemb, _ = _port_forward(trained, 224, images, torch.float32, taps=())
    _close(pemb, jemb, 1e-4)


def test_trained_b0_bf16_serving_module_direction(trained):
    """The serving module (bf16, as on the card) against the JAX bf16 fold."""
    images = np.random.default_rng(2).integers(0, 256, (4, 64, 64, 3)).astype(np.uint8)
    jemb, _ = _jax_forward(trained, 64, images, jnp.bfloat16, taps=())
    serve = make_serving_fn(trained, backbone_info("b0"), resolution=64, device="cpu")
    with torch.no_grad():
        pemb = serve(torch.from_numpy(images))["embedding"].numpy()
    cos = (pemb * jemb).sum(1) / (np.linalg.norm(pemb, axis=1) * np.linalg.norm(jemb, axis=1))
    assert (cos >= 0.999).all(), cos


def test_same_padding_matches_tf_rule():
    """Stride-2 SAME pads low = total // 2 (asymmetric), as XLA does."""
    for n, k, s in [(224, 3, 2), (112, 5, 2), (7, 5, 1), (9, 3, 2), (14, 3, 2)]:
        x = np.random.default_rng(n + k).standard_normal((1, n, n, 2)).astype(np.float32)
        w = np.random.default_rng(k).standard_normal((k, k, 2, 3)).astype(np.float32)
        ref = np.asarray(jinf._conv(jnp.asarray(x), jnp.asarray(w), jnp.zeros(3), stride=s))
        out = pinf._conv(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w).permute(3, 2, 0, 1), None,
            stride=s).permute(0, 2, 3, 1).numpy()
        assert out.shape == ref.shape
        _close(out, ref, 1e-5)


def _cos(a, b):
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def test_wrong_resolution_and_family_raise(random_b0_64):
    """A 64-px image into a 32-px module is resized as JAX resizes it; an unknown family raises."""
    variables, images = random_b0_64
    serve = make_serving_fn(variables, backbone_info("b0"), resolution=32, device="cpu")
    with torch.no_grad():
        pemb = serve(torch.from_numpy(images))["embedding"].numpy()
    model = EfficientNet(variant="b0")
    jfn, jparams = jax_serving_fn(model, variables, jax_info("b0"), resolution=32)
    jemb = np.asarray(jax.jit(jfn)(jparams, jnp.asarray(images))["embedding"], np.float32)
    assert pemb.shape == jemb.shape == (3, 1280)
    assert (_cos(pemb, jemb) >= 0.999).all(), _cos(pemb, jemb)
    with pytest.raises(ValueError):
        make_serving_fn(variables, {"family": "alexnet", "resolution": 224}, device="cpu")


def test_preprocess_constants_and_resize_match_jax():
    assert peff.TF_MODE_MEAN == jeff.TF_MODE_MEAN and peff.TF_MODE_STD == jeff.TF_MODE_STD
    assert peff.MEAN_RGB == jeff.MEAN_RGB and peff.STDDEV_RGB == jeff.STDDEV_RGB
    rng = np.random.default_rng(4)
    for size, res, kw in [(64, 32, {}), (24, 37, {}), (50, 32, dict(mean=peff.TF_MODE_MEAN, std=peff.TF_MODE_STD))]:
        x = rng.integers(0, 256, (2, size, size, 3)).astype(np.uint8)
        want = np.asarray(jeff.preprocess_images(jnp.asarray(x), res, **kw))
        got = peff.preprocess_images(torch.from_numpy(x), res, **kw).numpy()
        assert got.shape == want.shape == (2, res, res, 3)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size,tf_mode", [(64, False), (20, False), (32, True), (48, True)])
def test_explicit_preprocess_branch_matches_jax_fp32(random_b0_64, size, tf_mode):
    """Other sizes (64, 48, 20) resize, normalize and run the raw stem; at 32 px
    the folded stem runs; ``tf_mode`` too."""
    variables, _ = random_b0_64
    images = np.random.default_rng(size).integers(0, 256, (2, size, size, 3)).astype(np.uint8)
    kw = dict(mean=peff.TF_MODE_MEAN, std=peff.TF_MODE_STD) if tf_mode else {}
    model = EfficientNet(variant="b0", dtype=jnp.float32)
    jfn, jfolded = jinf.make_infer_fn(model, variables, resolution=32, dtype=jnp.float32, **kw)
    want = np.asarray(jax.jit(jfn)(jfolded, jnp.asarray(images))["embedding"])
    module = pinf.make_infer_fn(variables, "b0", resolution=32, dtype=torch.float32, device="cpu", **kw)
    with torch.no_grad():
        got = module(torch.from_numpy(images))["embedding"].numpy()
    _close(got, want, 1e-4)


def test_space_to_depth_stem_is_exact_fp32(random_b0_64):
    """fold_stem_space_to_depth re-lays the same linear map out."""
    variables, images = random_b0_64
    model = EfficientNet(variant="b0", dtype=jnp.float32)
    _, jfolded = jinf.make_infer_fn(model, variables, resolution=64, dtype=jnp.float32, space_to_depth=True)
    module = pinf.make_infer_fn(variables, "b0", resolution=64, dtype=torch.float32, space_to_depth=True, device="cpu")
    plain_stem = pinf.make_infer_fn(variables, "b0", resolution=64, dtype=torch.float32, device="cpu")
    assert module.space_to_depth and not plain_stem.space_to_depth
    np.testing.assert_allclose(module.stem_s2d_w.permute(2, 3, 1, 0).numpy(), np.asarray(jfolded["stem_s2d_w"]),
            rtol=1e-6, atol=1e-7)
    x = torch.from_numpy(images)
    with torch.no_grad():
        np.testing.assert_allclose(module.stem(x).numpy(), plain_stem.stem(x).numpy(), rtol=2e-5, atol=2e-5)
        e1 = module(x)["embedding"].numpy()
        e2 = plain_stem(x)["embedding"].numpy()
    np.testing.assert_allclose(e1, e2, rtol=2e-5, atol=2e-5)
