"""The arithmetic of the port's precise ``topk_l2`` over bf16 rows on the
card (``kernels/topk_l2.cu``: ``split_queries`` and
``topk_pass1_split_sm90``), held on the CPU through its mirror
``kernels/plain.py::split_bf16x3`` and the host-side sizes in
``kernels/build.py``.

- The three-term split reconstructs an fp32 query within 2^-26 relative
  (the terms carry 8 bits each: ~2^-27), or 2^-133 absolute where the terms
  fall among the bf16 subnormals (half their spacing, 2^-134).
- Against a bf16 gallery the three bf16 products are exact, so their sum is
  the fp32 query's dot product to the split's 2^-26 of sum |g q|; summed in
  fp32 the way the kernel sums them (per 64-feature chunk lo, mid, hi in a
  fresh accumulator, then added into a running fp32 sum) they stay within
  2^-20 of the fp32 matmul for unit vectors, 16x inside the 2^-16 gate the
  smoke run holds the card's kernel to.
- The lo term is not lost in the gate's slack: on queries made as a bf16
  row times 1 + 2^-9 + 2^-18 every lane's lo term has the row's sign, and
  the hi + mid product misses the fp64 distance to the row by more than
  1.5 x 2^-18, while the plain fp32 pass and the three terms stay within
  2^-18 of it (the smoke run's probe of the card kernel, checked here on
  its data).
- The query planes hold B rounded up to whole 128-query boxes, and every
  ring fits a Hopper block's 227 KB.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fast_image_recognition_tpu_torch.kernels import build, plain
from test_torch_synthetic import _one_thread  # noqa: F401  (autouse: one torch/BLAS thread)


@settings(max_examples=60, deadline=None)
@given(st.integers(-149, 126), st.integers(0, 2**31 - 1))
def test_split_reconstructs_fp32_queries(exp2, seed):
    """Magnitudes from the smallest fp32 subnormal to below 2^127 (every term
    stays finite), each value a random 24-bit significand."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(1.0, 2.0, 256) * rng.choice([-1.0, 1.0], 256)
    q = torch.from_numpy((m * 2.0**exp2).astype(np.float32))
    hi, mid, lo = plain.split_bf16x3(q)
    rec = hi.double() + mid.double() + lo.double()
    err = (rec - q.double()).abs()
    bound = torch.maximum(2.0**-26 * q.double().abs(), torch.full_like(err, 2.0**-133))
    assert bool((err <= bound).all()), float((err / bound).max())
    # each term is at most half an ulp of bf16 of the remainder before it
    assert bool((mid.double().abs() <= 2.0**-8 * q.double().abs() + 2.0**-133).all())


@pytest.mark.parametrize("dim", [40, 1280, 1536])
def test_three_bf16_products_give_the_fp32_dot(dim):
    rng = np.random.default_rng(dim)
    g = rng.standard_normal((64, dim))
    g = torch.from_numpy(g / np.linalg.norm(g, axis=1, keepdims=True)).to(torch.bfloat16)
    q = rng.standard_normal((8, dim))
    q = torch.from_numpy((q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32))
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
