"""The port's classifiers and ``fasterlog2`` against the JAX package's
(10 classes x 12 + 4 rows at D = 48, noise 1.0, so some probes err).
Tolerances: ``fasterlog2`` bit-equal; predictions equal (no near-ties
here); FPNN coefficients within 1e-6 absolute; k-medoids equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_image_recognition_tpu.classifiers as J
import fast_image_recognition_tpu.classifiers.fpnn as JF
import fast_image_recognition_tpu.classifiers.parzen as JP
import fast_image_recognition_tpu.ops.fastmath as JM
import fast_image_recognition_tpu_torch.classifiers as P
import fast_image_recognition_tpu_torch.classifiers.fpnn as PF
import fast_image_recognition_tpu_torch.classifiers.parzen as PP
from fast_image_recognition_tpu.data import make_gallery_and_probes
from fast_image_recognition_tpu_torch.ops.fastmath import fasterlog2, fasterlog2_np
from test_torch_synthetic import _one_thread  # noqa: F401  (autouse: one torch/BLAS thread)

C = 10


@pytest.fixture(scope="module")
def data():
    return make_gallery_and_probes(C, 12, 4, 48, seed=3, within_class_noise=1.0)


def test_fasterlog2_bit_equal():
    rng = np.random.default_rng(0)
    x = (np.abs(rng.standard_normal(20000)) * 10.0 ** rng.integers(-38, 38, 20000)).astype(np.float32)
    x = np.concatenate([x, np.asarray([0.0, 1e-45, 1e-40, 3.4e38, 1.0, 0.5, -1.0, -2.5e10], np.float32)])
    want = fasterlog2_np(x).view(np.uint32)
    np.testing.assert_array_equal(fasterlog2(torch.from_numpy(x)).numpy().view(np.uint32), want)
    np.testing.assert_array_equal(JM.fasterlog2_np(x).view(np.uint32), want)
    np.testing.assert_array_equal(np.asarray(JM.fasterlog2(jnp.asarray(x))).view(np.uint32), want)


CASES = [
    ("knn1", lambda: J.KNNClassifier(1, C), lambda: P.KNNClassifier(1, C, device="cpu")),
    ("knn3", lambda: J.KNNClassifier(3, C), lambda: P.KNNClassifier(3, C, device="cpu")),
    ("knn20", lambda: J.KNNClassifier(20, C), lambda: P.KNNClassifier(20, C, device="cpu")),  # no class reaches 20
    ("pnn", lambda: J.PNNClassifier(C), lambda: P.PNNClassifier(C, device="cpu")),
    ("pnn-seq", lambda: J.PNNClassifier(C, bruteforce=False), lambda: P.PNNClassifier(C, bruteforce=False,
                                                                                      device="cpu")),
    ("pnn-clustering", lambda: J.PNNWithClusteringClassifier(C), lambda: P.PNNWithClusteringClassifier(
        C, device="cpu")),
    ("fpnn", lambda: J.FPNNClassifier(C), lambda: P.FPNNClassifier(C, device="cpu")),
    ("fpnn-seq", lambda: J.FPNNClassifier(C, features_scale=0.5, bruteforce=False),
     lambda: P.FPNNClassifier(C, features_scale=0.5, bruteforce=False, device="cpu")),
]


@pytest.mark.parametrize("name,make_jax,make_port", CASES, ids=[c[0] for c in CASES])
def test_classifier_matches_jax(data, name, make_jax, make_port):
    xtr, ytr, xte, yte = data
    jc, pc = make_jax().fit(xtr, ytr), make_port().fit(xtr, ytr)
    assert pc.name == jc.name
    want, got = np.asarray(jc.predict(xte)), pc.predict(xte)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if name == "knn20":
        assert (got == 0).all()  # JAX's argmin over all-N positions
    if name in ("pnn", "fpnn"):
        assert 0.0 < float(np.mean(got != yte)) < 0.5  # the data has errors to agree on
    if name == "fpnn":
        np.testing.assert_allclose(pc._a_cos.numpy(), np.asarray(jc._a_cos), rtol=0, atol=1e-6)
        np.testing.assert_allclose(pc._a_sin.numpy(), np.asarray(jc._a_sin), rtol=0, atol=1e-6)
        oracle = [PF.fpnn_oracle_predict(xte[i], xtr, ytr, C) for i in range(8)]
        assert oracle == [JF.fpnn_oracle_predict(xte[i], xtr, ytr, C) for i in range(8)]
        np.testing.assert_array_equal(got[:8], oracle)
        jc, pc = make_jax().fit(xtr[:-5], ytr[:-5]), make_port().fit(xtr[:-5], ytr[:-5])  # a smaller class
        np.testing.assert_allclose(pc._a_sin.numpy(), np.asarray(jc._a_sin), rtol=0, atol=1e-6)


def test_k_medoids_matches_jax(data):
    xtr, ytr, _, _ = data
    np.testing.assert_array_equal(PP.k_medoids_per_class(xtr, ytr, C, 3), JP.k_medoids_per_class(xtr, ytr, C, 3))
