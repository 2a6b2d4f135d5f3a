"""The arithmetic of the port's precise ``topk_l2`` on the card
(``split_queries``, then ``topk_pass1_split_sm90`` over bf16 rows or
``topk_pass1_split6_sm90`` over fp32 rows), held on the CPU through its
mirror ``kernels/plain.py::split_bf16x3`` and the host-side sizes in
``kernels/build.py``, and the port's precise ``topk_l2`` over fp32 rows
against the JAX package's.

- The three-term split reconstructs fp32 queries, or row blocks split as
  the card splits them, within 2^-26 relative (8 bits a term: ~2^-27), or
  2^-133 absolute among the bf16 subnormals.
- Over bf16 rows the three products, summed per 64-feature chunk lo, mid,
  hi in a fresh accumulator and then into fp32 as the kernel sums them,
  stay within 2^-20 of the fp32 matmul for unit vectors (16x inside the
  smoke run's 2^-16 gate); over fp32 rows the six products (hi.lo, lo.hi,
  mid.mid, hi.mid, mid.hi, hi.hi; the dropped ones under 2^-25 of sum
  |g q|), summed per 32-feature chunk in that order, within 2^-20 of fp64.
- The lo terms matter: on queries = a bf16 row x (1 + 2^-9 + 2^-18) the hi
  + mid product misses the fp64 distance by > 1.5 x 2^-18 while the plain
  pass and the three terms stay within 2^-18; over fp32 rows made the same
  way with queries half a row, the six products stay within 2^-18 and the
  bf16-row pass's three miss by > 1.5 x 2^-18 (the smoke run's probes).
- The query planes hold B rounded up to whole 128-query boxes; every ring
  fits a Hopper block's 227 KB.
- ``topk_l2(precise=True)`` over full-significand fp32 rows (plain: an fp32
  matmul) equals JAX's (interpret mode, a HIGHEST fp32 dot): distances
  within 2^-16 absolute, rows equal but where their fp64 distances tie
  within that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import fast_image_recognition_tpu.ops.distance_kernel as J
import fast_image_recognition_tpu_torch.ops.distance_kernel as P
from fast_image_recognition_tpu_torch.kernels import build, plain
from test_torch_synthetic import _one_thread  # noqa: F401  (autouse: one torch/BLAS thread)

PROBE_TOL = 2.0**-18  # chip_smoke.py SPLIT_PROBE_TOL


@settings(max_examples=60, deadline=None)
@given(st.integers(-149, 126), st.integers(0, 2**31 - 1), st.sampled_from([(256,), (128, 32)]))
def test_split_reconstructs_fp32_queries(exp2, seed, shape):
    """Magnitudes from the smallest fp32 subnormal to below 2^127 (every term
    stays finite), each value a random 24-bit significand: a query, or a
    [128 x 32] box of rows as the six-product pass splits it on the card."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(1.0, 2.0, shape) * rng.choice([-1.0, 1.0], shape)
    q = torch.from_numpy((m * 2.0**exp2).astype(np.float32))
    hi, mid, lo = plain.split_bf16x3(q)
    rec = hi.double() + mid.double() + lo.double()
    err = (rec - q.double()).abs()
    bound = torch.maximum(2.0**-26 * q.double().abs(), torch.full_like(err, 2.0**-133))
    assert bool((err <= bound).all()), float((err / bound).max())
    # each term is at most half an ulp of bf16 of the remainder before it
    assert bool((mid.double().abs() <= 2.0**-8 * q.double().abs() + 2.0**-133).all())


# (query term, row term) of the six-product pass, in the kernel's order:
# smallest first, 0 hi, 1 mid, 2 lo
SIX = [(0, 2), (2, 0), (1, 1), (0, 1), (1, 0), (0, 0)]
THREE = [(0, 1), (1, 0), (0, 0)]  # what a pass without hi.lo, lo.hi and mid.mid would keep


def _six_products_fp32(q, g, chunk=32):
    """q.g^T of fp32 queries and fp32 rows as ``topk_pass1_split6_sm90``
    sums it: both split into three bf16 terms, per ``chunk`` features the
    six products in SIX's order into a fresh fp32 accumulator, then into
    the running fp32 sum."""
    qt, gt = plain.split_bf16x3(q), plain.split_bf16x3(g)
    total = torch.zeros((q.shape[0], g.shape[0]), dtype=torch.float32)
    for c0 in range(0, q.shape[1], chunk):
        part = torch.zeros_like(total)
        for a, b in SIX:
            part = part + qt[a][:, c0 : c0 + chunk].float() @ gt[b][:, c0 : c0 + chunk].float().T
        total = total + part
    return total


@pytest.mark.parametrize("dim, rows", [
    pytest.param(40, "bf16", id="40"), pytest.param(1280, "bf16", id="1280"), pytest.param(1536, "bf16", id="1536"),
    pytest.param(40, "fp32", id="fp32-rows-40"), pytest.param(1280, "fp32", id="fp32-rows-1280"),
    pytest.param(1536, "fp32", id="fp32-rows-1536"),
])
def test_three_bf16_products_give_the_fp32_dot(dim, rows):
    """bf16 rows: the three products of the split queries; fp32 rows: the
    six products of the split queries and rows."""
    rng = np.random.default_rng(dim)
    g = rng.standard_normal((64, dim))
    g = torch.from_numpy(g / np.linalg.norm(g, axis=1, keepdims=True)).to(torch.bfloat16)
    q = rng.standard_normal((8, dim))
    q = torch.from_numpy((q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32))
    if rows == "fp32":
        g = rng.standard_normal((64, dim))
        g = torch.from_numpy((g / np.linalg.norm(g, axis=1, keepdims=True)).astype(np.float32))
        assert float((g - g.to(torch.bfloat16).float()).abs().max()) > 0  # the mid and lo terms are there
        exact = q.double() @ g.double().T
        six = sum(plain.split_bf16x3(q)[a].double() @ plain.split_bf16x3(g)[b].double().T for a, b in SIX)
        assert bool(((six - exact).abs() <= 2.0**-25 * (q.double().abs() @ g.double().abs().T)).all())
        assert float((_six_products_fp32(q, g).double() - exact).abs().max()) <= 2.0**-20
        return
    hi, mid, lo = plain.split_bf16x3(q)
    g64 = g.double()
    exact = q.double() @ g64.T
    three = (hi.double() + mid.double() + lo.double()) @ g64.T
    assert bool(((three - exact).abs() <= 2.0**-26 * (q.double().abs() @ g64.abs().T)).all())
    # the kernel's fp32 order: per 64-feature chunk lo, mid, hi into a fresh accumulator
    total = torch.zeros((8, 64), dtype=torch.float32)
    for c0 in range(0, dim, 64):
        part = torch.zeros((8, 64), dtype=torch.float32)
        for term in (lo, mid, hi):
            part = part + term[:, c0 : c0 + 64].float() @ g[:, c0 : c0 + 64].float().T
        total = total + part
    fp32 = q @ g.float().T
    assert float((total.double() - exact).abs().max()) <= 2.0**-20
    assert float((total - fp32).abs().max()) <= 2.0**-20


def test_split_host_sizes():
    assert [build.topk_l2_split_plane_rows(b) for b in (1, 128, 129, 1024, 1025)] == [128, 128, 256, 1024, 1152]
    for k in (1, 2, 8, 16, 17, 64, build.TOPK_MAX_K):
        smem = build.topk_l2_split_smem_for(k)
        assert smem <= 232448, k
        # the register lists of k <= 16 merge through the idle ring: 3 stages of 64 KB
        if k <= 16:
            assert build.TOPK_QUERY_ROWS * 4 * 16 * 8 <= 3 * (3 * 128 * 128 + 128 * 128) < smem
    assert build.topk_l2_split_smem_for(1) == build.topk_l2_split_smem_for(16)
    assert build.topk_l2_split_smem_for(17) == build.topk_l2_split_smem_for(build.TOPK_MAX_K)
    # the six-product pass over fp32 rows: plane stages of 48 KB, fp32 boxes of 16 KB
    for k in (1, 16, 17, build.TOPK_MAX_K):
        assert build.topk_l2_split6_smem_for(k) <= 232448, k
    assert build.topk_l2_split6_smem_for(1) == build.topk_l2_split6_smem_for(16) == 216144
    assert build.topk_l2_split6_smem_for(17) == build.topk_l2_split6_smem_for(build.TOPK_MAX_K) == 220728
    # k <= 16 merges through the idle plane ring: 3 stages of 48 KB
    assert build.TOPK_QUERY_ROWS * 4 * 16 * 8 <= 3 * 6 * 128 * 64


@pytest.mark.parametrize("b, window", [(130, None), (257, (5, 1277))])
def test_lo_term_probe_separates_three_terms_from_two(b, window):
    torch.manual_seed(41)
    n, d, tol = 512, 1280, 2.0**-18
    g = torch.randn((n, d))
    g = (g / torch.linalg.vector_norm(g, dim=1, keepdim=True)).to(torch.bfloat16)
    lo_, hi_ = window if window is not None else (0, d)
    q = (g[:b].float() * (1.0 + 2.0**-9 + 2.0**-18)).contiguous()
    kd, ki = plain.topk_l2_plain(q, g, 1, n, window=window, precise=True)
    assert torch.equal(ki[:, 0], torch.arange(b, dtype=ki.dtype))
    qw = torch.zeros_like(q)
    qw[:, lo_:hi_] = q[:, lo_:hi_]
    hi, mid, lo = (t[:, lo_:hi_].double() for t in plain.split_bf16x3(qw))
    assert bool((lo != 0).float().mean() > 0.99)
    gd = g[:b, lo_:hi_].double()
    qsq = (qw.double() ** 2).sum(1)
    exact = ((q[:, lo_:hi_].double() - gd) ** 2).sum(1)

    def dist(terms):
        return qsq + (gd * gd).sum(1) - 2.0 * (terms * gd).sum(1)

    assert float((kd[:, 0].double() - exact).abs().max()) <= tol
    assert float((dist(hi + mid + lo) - exact).abs().max()) <= tol
    assert float((dist(hi + mid) - exact).abs().min()) > 1.5 * tol


@pytest.mark.parametrize("b, window", [(130, None), (257, (5, 1277))])
def test_row_split_probe_separates_six_products_from_three(b, window):
    """The smoke run's probe of the six-product pass, on its data: rows a
    unit bf16 row times 1 + 2^-9 + 2^-18, queries half a row."""
    torch.manual_seed(43)
    n, d = 512, 1280
    h = torch.randn((n, d))
    h = (h / torch.linalg.vector_norm(h, dim=1, keepdim=True)).to(torch.bfloat16).float()
    g = (h * (1.0 + 2.0**-9 + 2.0**-18)).contiguous()
    q = (0.5 * g[:b]).contiguous()
    lo_, hi_ = window if window is not None else (0, d)
    gt = [t[:b, lo_:hi_] for t in plain.split_bf16x3(g)]
    qt = [t[:, lo_:hi_] for t in plain.split_bf16x3(q)]
    assert bool((gt[2] != 0).float().mean() > 0.99) and bool((qt[2] != 0).float().mean() > 0.99)
    kd, ki = plain.topk_l2_plain(q, g, 1, n, window=window, precise=True)
    assert torch.equal(ki[:, 0], torch.arange(b, dtype=ki.dtype))
    qw, gw = q[:, lo_:hi_].double(), g[:b, lo_:hi_].double()
    exact = ((qw - gw) ** 2).sum(1)
    qsq, gsq = (qw * qw).sum(1), (gw * gw).sum(1)

    def dist(pairs):
        return qsq + gsq - 2.0 * sum((qt[a].double() * gt[c].double()).sum(1) for a, c in pairs)

    cross = _six_products_fp32(q[:, lo_:hi_].contiguous(), g[:b, lo_:hi_].contiguous()).diagonal()
    kernel_order = torch.clamp_min(q[:, lo_:hi_].square().sum(1) + g[:b, lo_:hi_].square().sum(1) - 2.0 * cross, 0.0)
    assert float((kd[:, 0].double() - exact).abs().max()) <= PROBE_TOL
    assert float((kernel_order.double() - exact).abs().max()) <= PROBE_TOL
    assert float((dist(SIX) - exact).abs().max()) <= PROBE_TOL
    assert float((dist(THREE) - exact).abs().min()) > 1.5 * PROBE_TOL


@pytest.mark.parametrize("window", [None, (5, 123)])
@pytest.mark.parametrize("k", [1, 17])
def test_precise_topk_over_fp32_rows_matches_jax(k, window):
    rng = np.random.default_rng(47)
    n, d, b = 2048, 128, 8
    g = rng.standard_normal((n, d))
    g = (g / np.linalg.norm(g, axis=1, keepdims=True)).astype(np.float32)
    assert (torch.from_numpy(g).to(torch.bfloat16).float().numpy() != g).mean() > 0.99  # full significands
    q = g[rng.integers(0, n, b)] + 0.3 * rng.standard_normal((b, d)) / np.sqrt(d)
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    lo, hi = window if window is not None else (0, d)
    jd, ji = (np.asarray(x) for x in J.topk_l2(jnp.asarray(q), jnp.asarray(g), k, window=window, precise=True))
    pd, pi = (x.numpy() for x in P.topk_l2(torch.from_numpy(q), torch.from_numpy(g), k, window=window, precise=True))
    assert pd.shape == pi.shape == (b, k) and pi.dtype == np.int32 and ((pi >= 0) & (pi < n)).all()
    width = hi - lo
    tol = 2.0**-16  # raw squared distances: fp32 dots of unit vectors in another order
    np.testing.assert_array_less(np.abs(pd - jd) * width, tol)

    def rescored(rows):
        diff = g[rows][:, :, lo:hi].astype(np.float64) - q[:, None, lo:hi].astype(np.float64)
        return (diff * diff).sum(axis=2)

    dp, dj = rescored(pi), rescored(ji)
    differ = pi != ji
    assert (np.abs(dp - dj)[differ] <= tol).all()
    assert (np.abs(dp - pd * width) <= tol).all()
