"""The port's folded EfficientNet forward against the JAX package's
``folded_forward`` (``fused=False``) on the same uint8 images and weights.

Tolerances: in float32 both sides compute the same convolutions with
another summation order, so embeddings and taps agree to rtol 1e-4 of the
reference's largest magnitude. In bf16 the two frameworks round
intermediates at different places; the embeddings must then point the
same way (cosine >= 0.999).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_image_recognition_tpu.models import create_backbone
from fast_image_recognition_tpu.models.efficientnet import EfficientNet
from fast_image_recognition_tpu.models import inference as jinf
from fast_image_recognition_tpu_torch.models import inference as pinf
from fast_image_recognition_tpu_torch.models.efficientnet import default_taps
from fast_image_recognition_tpu_torch.models.fold import make_serving_fn
from fast_image_recognition_tpu_torch.models.efficientnet import backbone_info
from fast_image_recognition_tpu_torch.utils.checkpoint import load_variables

CKPT = os.path.join(
    os.path.dirname(__file__), "..", "benchmarks", "trained_b0_224_synthetic1024_s0.npz"
)
TAPS = ("block1a", "block2a", "block3a", *default_taps("b0"))


def _jax_forward(variables, res, images, dtype, taps=TAPS):
    model = EfficientNet(variant="b0", dtype=dtype)
    folded, configs = jinf.fold_backbone(model, variables, dtype=dtype)
    folded = jinf.fold_preprocess_into_stem(folded, res, dtype=dtype)
    fn = jax.jit(
        lambda f, x: jinf.folded_forward(f, configs, x, taps=taps, resolution=res, dtype=dtype)
    )
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
        out = pinf._conv(
            torch.from_numpy(x).permute(0, 3, 1, 2),
            torch.from_numpy(w).permute(3, 2, 0, 1),
            None,
            stride=s,
        ).permute(0, 2, 3, 1).numpy()
        assert out.shape == ref.shape
        _close(out, ref, 1e-5)


def test_wrong_resolution_and_family_raise(random_b0_64):
    variables, images = random_b0_64
    serve = make_serving_fn(variables, backbone_info("b0"), resolution=32, device="cpu")
    with pytest.raises(ValueError):
        serve(torch.from_numpy(images))
    with pytest.raises(NotImplementedError):
        make_serving_fn(variables, {"family": "mobilenetv2", "resolution": 224}, device="cpu")
