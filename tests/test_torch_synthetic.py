"""The port's device renderer against JAX's: ``make_class_params`` bit-equal; on
identical instance parameters and noise the uint8 images within 1 (a
quantization edge)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import fast_image_recognition_tpu.data.synthetic_device as J
import fast_image_recognition_tpu_torch.data.synthetic_device as P


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def jax_b0(res=32, **kw):
    """JAX's B0 init: (module, host variables, their params and batch_stats as numpy)."""
    from fast_image_recognition_tpu.models import create_efficientnet

    model, v = create_efficientnet("b0", 0, resolution=res, **kw)
    v = jax.device_get(v)
    return model, v, jax.tree_util.tree_map(np.asarray, {k: v[k] for k in ("params", "batch_stats")})


def planted_gallery(emb, n, rng):
    """n rows in a 96-d span holding the unit rows ``emb``: per probe a planted row (noise 0.02) and 40
    distractors (0.5), the rest random in the span. (gallery, planted rows)."""
    b = len(emb)
    basis = np.linalg.qr(np.concatenate([emb, rng.standard_normal((96 - b, emb.shape[1]))]).T)[0].T.astype(np.float32)
    span = lambda k, s: s * (rng.standard_normal((k, 96)) / np.sqrt(96)).astype(np.float32) @ basis  # noqa: E731
    gal = _unit(rng.standard_normal((n, 96)).astype(np.float32) @ basis)
    planted = rng.choice(n, b, replace=False)
    free = rng.permutation(np.setdiff1d(np.arange(n), planted))
    for i in range(b):
        gal[planted[i]] = _unit(emb[i] + span(1, 0.02)[0])
        gal[free[i * 40 : (i + 1) * 40]] = _unit(emb[i] + span(40, 0.5))
    return gal, planted


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch and BLAS thread for the module (several workers on a few cores stall each other's pools: 10x slower).
    Port test files import it, autouse there too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("num_classes,seed", [(5, 0), (17, 3000)])
def test_class_params_bit_equal(num_classes, seed):
    a, b = J.make_class_params(num_classes, seed), P.make_class_params(num_classes, seed)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("res", [32, 57])
def test_render_batch_matches_jax_on_identical_instances(res):
    params = J.make_class_params(7, seed=3)
    lo, inv = J._proto_norms({k: jnp.asarray(v) for k, v in params.items()}, res)
    plo, pinv = P._proto_norms({k: torch.as_tensor(v) for k, v in params.items()}, res)
    np.testing.assert_allclose(plo.numpy(), np.asarray(lo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pinv.numpy(), np.asarray(inv), rtol=1e-5)

    rng = np.random.default_rng(res)
    b = 6
    ids = rng.integers(0, 7, b)
    per = {"angle": rng.uniform(-0.44, 0.44, b), "scale": rng.uniform(0.8, 1.2, b),
        "tx": rng.uniform(-0.1, 0.1, b) * res, "ty": rng.uniform(-0.1, 0.1, b) * res,
        "bright": rng.uniform(-0.1, 0.1, b), "contrast": rng.uniform(0.85, 1.15, b), "namp": rng.uniform(0.0, 0.25, b)}
    per = {k: v.astype(np.float32) for k, v in per.items()}
    for k in ("fx", "fy", "ph", "amp", "cast"):
        per[k] = params[k][ids]
    per["lo"], per["inv_scale"] = np.asarray(lo)[ids], np.asarray(inv)[ids]
    noise = rng.standard_normal((b, 3, res, res)).astype(np.float32)
    ref = np.asarray(J._render_batch({k: jnp.asarray(v) for k, v in per.items()}, jnp.asarray(noise), res, 6))
    out = P._render_batch({k: torch.as_tensor(v) for k, v in per.items()}, torch.as_tensor(noise), res, 6)
    assert out.dtype == torch.uint8 and out.shape == ref.shape == (b, res, res, 3)
    assert np.abs(out.numpy().astype(int) - ref.astype(int)).max() <= 1


def test_device_dataset_is_seeded_and_class_major():
    a, la = P.device_dataset(3, 2, 24, seed=7, chunk=4, device="cpu")
    b, lb = P.device_dataset(3, 2, 24, seed=7, chunk=4, device="cpu")
    c, _ = P.device_dataset(3, 2, 24, seed=8, chunk=4, device="cpu")
    assert a.shape == (6, 24, 24, 3) and a.dtype == torch.uint8
    np.testing.assert_array_equal(la, [0, 0, 1, 1, 2, 2])
    assert torch.equal(a, b) and not torch.equal(a, c)
    np.testing.assert_array_equal(la, lb)
