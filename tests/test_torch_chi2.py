"""chi2 1-NN (``plain.chi2_nn_plain``, exact division) against JAX's interpret
mode; ``chi2_cost`` tiny. Rows = the fp64 argmin (bf16 gallery >= 90 %),
distances rtol 2e-5, atol 1e-7; vs JAX indices equal but where the oracle's two
least lie within 2^-7 (JAX's reciprocal is up to 2^-8 off a term), refined
distances rtol 2e-5, atol 1e-7, unrefined 4e-3. CPU tensors refused."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_image_recognition_tpu.config import DistanceKind as JKind
from fast_image_recognition_tpu.ops.chi2_kernel import chi2_nn as j_chi2_nn
from fast_image_recognition_tpu.ops.distances import oracle_pairwise as j_oracle
from fast_image_recognition_tpu_torch.kernels import build
from fast_image_recognition_tpu_torch.ops.chi2_kernel import chi2_nn
from fast_image_recognition_tpu_torch.scripts import chi2_cost
from test_torch_synthetic import _one_thread  # noqa: F401

NEAR_TIE = 2.0**-7


def _features(n, d, seed):
    """Non-negative L2-normalized rows (the loader's contract)."""
    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal((n, d))).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _case(name):
    """(queries, gallery fp32 values, n_valid, bf16 gallery) of a case."""
    if name == "300x64_b5":
        return _features(5, 64, 1), _features(300, 64, 0), None, False
    if name == "1024x128_b17":
        return _features(17, 128, 1), _features(1024, 128, 0), None, False
    if name == "n_valid_40_zero_rows":
        g = np.concatenate([_features(40, 32, 2), np.zeros((24, 32), np.float32)])
        return _features(4, 32, 3), g, 40, False
    if name == "bf16_gallery":
        return _features(8, 96, 5), _features(512, 96, 4), None, True
    if name == "b260_two_query_blocks":
        return _features(260, 32, 7), _features(300, 32, 6), None, False
    if name == "duplicate_rows":
        g = _features(200, 48, 8)
        q = _features(6, 48, 9)
        g[[60, 90, 150]] = g[30]  # the same row four times
        q[0] = g[30]  # ... and a query at it
        g[[120, 121]] = q[1]  # a query's exact match, twice
        return q, g, None, False
    raise KeyError(name)


CASES = ["300x64_b5", "1024x128_b17", "n_valid_40_zero_rows", "bf16_gallery", "b260_two_query_blocks", "duplicate_rows"]


def _check(name, refine):
    q, g, n_valid, bf16 = _case(name)
    jg = jnp.asarray(g, jnp.bfloat16) if bf16 else jnp.asarray(g)
    pg = torch.from_numpy(g).to(torch.bfloat16) if bf16 else torch.from_numpy(g)
    jd, ji = (np.asarray(a) for a in j_chi2_nn(jnp.asarray(q), jg, n_valid=n_valid, refine=refine))
    pd, pi = chi2_nn(torch.from_numpy(q), pg, n_valid=n_valid, refine=refine)
    pd, pi = pd.numpy(), pi.numpy()
    assert pd.dtype == np.float32 and pi.dtype == np.int32 and pi.shape == (q.shape[0],)
    nv = g.shape[0] if n_valid is None else n_valid
    od = j_oracle(q, np.asarray(pg[:nv].to(torch.float32)), kind=JKind.CHI2)
    two = np.sort(od, axis=1)[:, :2]
    near = two[:, 1] - two[:, 0] <= NEAR_TIE * two[:, 1]
    assert ((pi == ji) | near).all(), (pi, ji)
    assert (pi == od.argmin(1)).mean() >= (0.9 if bf16 else 1.0)
    if not bf16:
        np.testing.assert_allclose(pd, od.min(1), rtol=2e-5, atol=1e-7)
    same = pi == ji
    np.testing.assert_allclose(pd[same], jd[same], rtol=2e-5 if refine else 4e-3, atol=1e-7)
    return q, g, pi, od


@pytest.mark.parametrize("name", CASES)
def test_chi2_nn_matches_jax(name):
    q, g, pi, od = _check(name, refine=True)
    if name == "duplicate_rows":
        assert pi[0] == 30  # the lowest of four equal rows
        assert pi[1] == 120
    if name == "n_valid_40_zero_rows":
        assert (pi < 40).all()


@pytest.mark.parametrize("name", ["300x64_b5", "n_valid_40_zero_rows", "duplicate_rows"])
def test_chi2_nn_unrefined_matches_jax(name):
    _check(name, refine=False)


def test_chi2_nn_host_data_and_card_launcher():
    """Host data goes to ``device``; tensors stay where they lie; the CUDA
    launcher refuses CPU tensors; the plain step size changes nothing."""
    q, g = _features(9, 40, 11), _features(333, 40, 12)
    a = chi2_nn(q, g, device="cpu")
    b = chi2_nn(torch.from_numpy(q), torch.from_numpy(g), tile_g=7)
    assert torch.equal(a[1], b[1]) and torch.allclose(a[0], b[0], rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        build.launch_chi2(torch.from_numpy(q), torch.from_numpy(g), 333)
    with pytest.raises(ValueError):
        chi2_nn(q, g, n_valid=0, device="cpu")


def test_chi2_cost_lines_on_cpu():
    """The script's lines at a tiny size: every kind and field, top-1 = the fp64 oracle, L1-normalized data."""
    kinds = ",".join(chi2_cost.KINDS)
    lines = chi2_cost.main(["--gallery", "640", "--batch", "16", "--dim", "24", "--iters", "1", "--kinds", kinds,
            "--device", "cpu"])
    assert [ln["metric"].split("(")[1].split()[0] for ln in lines] == list(chi2_cost.KINDS)
    for ln in lines:
        assert set(ln) == {"metric", "value", "unit", "sec_per_batch", "elem_triples_per_sec", "probe_agreement",
                "device"}
        assert ln["unit"] == "queries/sec/cpu" and ln["device"] == "cpu"
        assert ln["probe_agreement"] == 1.0, ln
    g, q = chi2_cost.make_data(640, 16, 24, torch.device("cpu"))
    torch.testing.assert_close(g.sum(dim=1), torch.ones(640), rtol=1e-5, atol=0)
    torch.testing.assert_close(q.sum(dim=1), torch.ones(16), rtol=1e-5, atol=0)
    # q - g = (e - s g) / (1 + s) with |e| <= 0.05 / D and s = sum(e) <= 0.05
    assert ((q - g[:16]).abs() <= 0.05 / 24 + 0.05 * g[:16] + 1e-7).all()
    with pytest.raises(ValueError, match="unknown kinds"):
        chi2_cost.main(["--kinds", "chi3", "--device", "cpu"])


def test_chi2_cost_without_warmup(monkeypatch):
    """``--warmup 0`` calls a kind ``--iters`` times, then once on its probes."""
    from fast_image_recognition_tpu_torch.ops import distances

    calls, real = [], distances.streamed_topk
    monkeypatch.setattr(distances, "streamed_topk", lambda *a, **k: calls.append(1) or real(*a, **k))
    for warmup in (0, 1):
        calls.clear()
        ln, = chi2_cost.main(["--gallery", "640", "--batch", "16", "--dim", "24", "--iters", "2", "--warmup",
                str(warmup), "--kinds", "kl", "--device", "cpu"])
        assert len(calls) == 2 + 1 + warmup and ln["probe_agreement"] == 1.0
