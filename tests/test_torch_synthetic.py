"""The port's device renderer against the JAX package's.

Tolerances: ``make_class_params`` is a verbatim numpy copy, so bit-equal.
``_render_batch`` evaluates the same float32 expressions in another
framework; on identical per-instance parameters and noise the uint8 images
agree within 1 (a value that lands on a quantization edge).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import fast_image_recognition_tpu.data.synthetic_device as J
import fast_image_recognition_tpu_torch.data.synthetic_device as P


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch and BLAS thread for this module: the suite runs several
    workers on a few cores, where spinning thread pools stall each other
    (a module took 10x longer with the default pools under load). Every
    port test file that computes imports this fixture, which makes it
    autouse there too."""
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
    per = {
        "angle": rng.uniform(-0.44, 0.44, b),
        "scale": rng.uniform(0.8, 1.2, b),
        "tx": rng.uniform(-0.1, 0.1, b) * res,
        "ty": rng.uniform(-0.1, 0.1, b) * res,
        "bright": rng.uniform(-0.1, 0.1, b),
        "contrast": rng.uniform(0.85, 1.15, b),
        "namp": rng.uniform(0.0, 0.25, b),
    }
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
