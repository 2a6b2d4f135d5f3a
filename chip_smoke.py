#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from the
sources in the checkout with ``nvcc``, holds every kernel against its plain
PyTorch version at the shapes of the paths below and at odd ones (widths
that are no multiple of 8, batches of 1 and 130, tiles of nothing but
padding), and drives, each with its own launch counts:

- the main serving path at full width (bench.py's plain e2e line:
  EfficientNet-B0 at 224 from the trained checkpoint, a 1M-row
  class-structured gallery, PCA-124 certified packed scan, 48-row rescore,
  exact escalation at slack 0.05 in one masked launch per call, batch
  1024), once under ``torch.cuda.set_sync_debug_mode("error")``, with its
  answers checked against ``match='exact'`` and the pick before escalation
  against a plain rescore, and its exact step timed at 5 % escalation;
  ``match='exact'``; the fp32 oracle
  (``topk_l2(precise=True)``, bench.py's ``_exact_fp32_nn``) that every
  agreement below is taken against;
- the JAX package's default service (PCA-128, fp32-score tile scan) and
  its ``pca_scan='bf16'``, ``pca_scan='int8'`` and ``match='int8'`` modes
  on the same gallery;
- the early-exit twin (bench.py's cascade line): the level-gallery cascade
  with exit taps block3a/block4a/block5c, four row-aligned 1M-row
  galleries, ratio 0.85, ``d2_rule='class'`` and capacities calibrated at
  slack 1.3 on held-out probes, rerun with its scan bound to the plain
  version to hold its decisions; ``escalate=None``; a planted 1M-row layout
  where the certificate clears (also without a host sync);
- bench.py's ``--config bf``: a 1M x 1536 bf16 gallery, the fused bf16
  scan, a feature-window scan of it, and ``--quant``: the int8 scan with
  exact rescore, ``compute`` int8 and bf16;
- the opt-in fused MBConv forward (``make_infer_fn(fused=True,
  space_to_depth=True)``): the fused block kernel against its plain
  version at each of B0's twelve stride-1 blocks, fed the per-op forward's
  activations, and at edge shapes (batches of 1 and 130, an odd plane,
  relu6, no SE, no expand, k=7, an inflated expand bias); the
  space-to-depth stem against the plain stem at fp32; and the plain
  line's service on the fused module, its embedding held against the
  per-op forward's and its labels against the per-op line's;
- chi2 1-NN: the chi2 kernel against its plain version (exact division)
  at ``scripts/chi2_cost.py``'s shape (1024 x 102,400 x 1536, fp32 and
  bf16 rows) and at edge shapes (B = 1 and 130, D = 100, rows past
  n_valid, equal rows); the port's ``chi2_cost`` with every kind, its
  probe agreement with the fp64 oracle gated; and the exact brute-force
  harness: a feature-file round trip, then ``evaluate_matcher`` on
  ``BruteForceMatcher`` (L2, a 256-feature prefix, int8, chi2 and KL on
  sum-normalized rows) over ``make_gallery_and_probes``' 102,400 rows, the
  L2 rows held against an fp64 argmin and the chi2 rows against
  ``chi2_nn``'s.

One flushed line per phase, with the seconds since start. The line before
the card's name and power limit holds the kernels' JSON; the last line is
``{"ok": true, "device": ...}``. Any failure raises and the exit code is
not 0. It needs one card and imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

T0 = time.time()
BUDGET_S = 300.0  # a run takes one to two minutes of command time
CKPT = os.path.join("benchmarks", "trained_b0_224_synthetic1024_s0.npz")
GALLERY = 1_000_000
IDENTITIES = 4096
BATCH = 1024
RES = 224
TIMED_CALLS = 5
TAPS = ["block3a", "block4a", "block5c"]  # bench.py's cascade exit taps
RATIO = 0.85  # bench.py --cascade-ratio
SLACK = 1.3  # bench.py --slack
NEAR_TIE = 2.0**-8  # exit-rule margin within NEAR_TIE * d1 of zero
BF_DIM = 1536  # bench.py --config bf
BF_WINDOW = (256, 1024)  # a feature window of the bf gallery (the TWD partial-range scan)
# published dense peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_FP32_FLOPS = 67e12  # CUDA-core FMA, no tensor cores
PEAK_HBM_BYTES = 3.35e12


def phase(msg: str) -> None:
    elapsed = time.time() - T0
    print(f"[{elapsed:7.1f}s] {msg}", flush=True)
    if elapsed > BUDGET_S:
        raise TimeoutError(f"smoke run over its {BUDGET_S:.0f} s budget")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Host-clock mean of ``fn()`` between two device syncs (the first
    keeps work queued before the call out of its time)."""
    import torch

    torch.cuda.synchronize()
    t = time.time()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.time() - t) / reps * 1e3


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_launches(path: str, launches: dict, **counts) -> None:
    """Record the launch counts of ``path`` (counted since the last reset)
    and require ``counts``, every other kernel 0."""
    from fast_image_recognition_tpu_torch.kernels import build

    launches[path] = dict(build.LAUNCHES)
    want = {k: counts.get(k, 0) for k in build.LAUNCHES}
    if launches[path] != want:
        raise AssertionError(f"{path} launches {launches[path]}, expected {want}")


def _unit(x):
    import torch

    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=1, keepdim=True), 1e-30)


def class_structured_gallery(n: int, class_embs, sigma: float, seed: int = 1):
    """``n`` rows (padded to 1024) clustered around ``K`` enrolled identity
    embeddings, ~n/K contiguous rows each: normalize(e_c + sigma/sqrt(D) *
    noise), sigma the measured intra-class spread. Port of bench.py's
    ``_class_structured_gallery_device``; rows are drawn on the card from a
    ``torch.Generator``. Returns (bf16 [n_pad, D] on the card, labels
    [n_pad] int, pad rows -1)."""
    import numpy as np
    import torch

    k, dim = class_embs.shape
    dev = class_embs.device
    n_pad = -(-n // 1024) * 1024
    m = -(-n_pad // k)
    labels = np.repeat(np.arange(k, dtype=np.int64), m)[:n_pad]
    labels[n:] = -1
    lab = torch.as_tensor(np.maximum(labels, 0), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    gal = torch.empty((n_pad, dim), dtype=torch.bfloat16, device=dev)
    chunk = 65536
    for s in range(0, n_pad, chunk):
        e = class_embs[lab[s : s + chunk]]
        rows = e + (sigma / math.sqrt(dim)) * torch.randn(e.shape, generator=gen, device=dev)
        inv = torch.rsqrt(torch.clamp_min((rows * rows).sum(dim=1), 1e-30))
        gal[s : s + chunk] = (rows * inv[:, None]).to(torch.bfloat16)
    return gal, labels


def planted_gallery(n: int, b: int, dim: int, dev, seed: int = 2):
    """A layout where the certificate clears: ``b`` unit probes and ``n``
    rows (padded to 1024) in one random 96-dimensional span, which PCA-124
    keeps whole. Each probe has one planted row (noise 0.02) and 40
    distractors (noise 0.5) at random places; the other rows are random
    unit vectors of the span. Returns (probes [b, dim] fp32, gallery bf16
    [n_pad, dim], planted rows [b] int64), all on the card."""
    import torch

    rank, distract = 96, 40
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    basis = torch.linalg.qr(torch.randn((dim, rank), generator=gen, device=dev))[0].T  # [96, dim]

    def unit(x):
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)

    def in_span(m, scale):
        return (scale / math.sqrt(rank)) * torch.randn((m, rank), generator=gen, device=dev) @ basis

    n_pad = -(-n // 1024) * 1024
    gal = torch.zeros((n_pad, dim), dtype=torch.bfloat16, device=dev)
    for s in range(0, n, 65536):
        m = min(65536, n - s)
        gal[s : s + m] = unit(in_span(m, 1.0)).to(torch.bfloat16)
    probes = unit(in_span(b, 1.0))
    perm = torch.randperm(n, generator=gen, device=dev)
    planted = perm[:b]
    gal[planted] = unit(probes + in_span(b, 0.02)).to(torch.bfloat16)
    near = probes.repeat_interleave(distract, dim=0)
    gal[perm[b : b * (distract + 1)]] = unit(near + in_span(b * distract, 0.5)).to(torch.bfloat16)
    return probes, gal, planted


def check_certified_pick(svc, emb, idx_exact):
    """The PCA path's pick before escalation, held against a plain fp32
    rescore of the same candidates: it must sit at their least distance
    (within 2^-12 relative + 1e-5, the fp32 rounding of 1280-term sums).
    Returns its row agreement with the exact answer, %."""
    import torch

    cand, idx_fast, _ = svc._certified(emb)
    e16 = emb.to(torch.bfloat16).to(torch.float32)
    d_cand = ((e16[:, None, :] - svc.gallery[cand].to(torch.float32)) ** 2).sum(-1)
    d_fast = ((e16 - svc.gallery[idx_fast].to(torch.float32)) ** 2).sum(-1)
    d_min = d_cand.min(dim=1).values
    in_cand = bool((cand == idx_fast[:, None]).any(dim=1).all())
    if not in_cand or not bool((d_fast <= d_min + 2.0**-12 * d_min + 1e-5).all()):
        raise AssertionError("the rescored pick is not the nearest of its candidates")
    return 100.0 * (idx_fast == idx_exact).float().mean().item()


def check_cert_scan(svc, emb, report):
    """Packed scan kernel vs its plain version on the main path's tensors:
    the service's augmented PCA gallery and the batch's projected probes."""
    import torch

    from fast_image_recognition_tpu_torch.kernels import build, plain
    from fast_image_recognition_tpu_torch.ops import distance_kernel as dk

    qp = (emb - svc._mu) @ svc._w
    qa = dk._augment_queries(qp, svc.pca_dim, svc.gal_aug.shape[1])
    ga = svc.gal_aug
    k1, k2 = build.launch_tilemin2_packed(qa, ga)
    p1, p2 = plain.tilemin2_packed_plain(qa, ga)
    torch.cuda.synchronize()
    kd1, ki, kd2 = dk.decode_tile_keys(k1, k2)
    pd1, pi, pd2 = dk.decode_tile_keys(p1, p2)
    scale = torch.clamp_min(pd1.abs().max(), 1e-30)
    err = max((kd1 - pd1).abs().max().item(), (kd2 - pd2).abs().max().item())
    key_eq = (k1 == p1).float().mean().item()
    # fp32 sum order may move a distance across a masked-bit boundary; the
    # decoded distances must still agree within 2^-12 relative
    rel = err / scale.item()
    # the rows the keys carry, rescored here in fp32 from the same bf16
    # operands: each must sit at its key's distance (the key keeps it to
    # 2^-13, the sum order to less), and the kernel's best row may differ
    # from the plain one's only at a near-tie
    rows_ok = True
    qf = qa.to(torch.float32)
    for keys, kd, pd in ((k1, kd1, pd1), (k2, kd2, pd2)):
        d_rows = []
        for kk in (keys, p1 if keys is k1 else p2):
            rows = dk.decode_tile_keys(kk, kk)[1].long()
            d_rows.append(torch.clamp_min(torch.einsum("bd,btd->bt", qf, ga[rows].to(torch.float32)), 0.0))
        tol = 2.0**-12 * d_rows[1].abs() + 1e-6
        rows_ok = rows_ok and bool(((d_rows[0] - kd).abs() <= tol).all())
        rows_ok = rows_ok and bool(((d_rows[0] - d_rows[1]).abs() <= tol).all())
    rows_ok = rows_ok and bool(((k1 & 1023) != (k2 & 1023)).all())
    kc, kb = dk.certify_tiles(kd1, ki, kd2, svc.rescore)
    pc, pb = dk.certify_tiles(pd1, pi, pd2, svc.rescore)
    same_set = (kc.sort(dim=1).values == pc.sort(dim=1).values).all(dim=1)
    bound_rel = ((kb - pb).abs() / torch.clamp_min(pb.abs(), 1e-30)).max().item()
    # a candidate set may differ only by a tile swapped at a near-tie
    gap_ok = True
    if not bool(same_set.all()):
        bad = (~same_set).nonzero()[:, 0]
        r = min(svc.rescore, kd1.shape[1]) - 1
        kth_k = kd1.sort(dim=1).values[bad, r]
        kth_p = pd1.sort(dim=1).values[bad, r]
        gap_ok = bool(((kth_k - kth_p).abs() <= 2.0**-12 * kth_p.abs() + 1e-6).all())
    b, da = qa.shape
    np_ = ga.shape[0]
    n_tiles = k1.shape[1]
    ms = cuda_ms(lambda: build.launch_tilemin2_packed(qa, ga), reps=10)
    plain_ms = cuda_ms(lambda: plain.tilemin2_packed_plain(qa, ga), reps=2)
    yard_ms = cuda_ms(
        lambda: (qa @ ga.T).view(b, n_tiles, 1024).min(dim=2), reps=3
    )
    b_ms, b_by = bound(2.0 * b * np_ * da, np_ * da * 2 + b * da * 2 + 2 * b * n_tiles * 4)
    phase(
        f"packed scan B={b} Np={np_} Da={da}: keys equal {100 * key_eq:.3f}%, "
        f"max |d| gap {err:.3e} ({rel:.2e} rel), candidate sets equal "
        f"{100 * same_set.float().mean().item():.3f}%, bound gap {bound_rel:.2e} rel; "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, matmul+min yardstick "
        f"{yard_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})"
    )
    if rel > 2.0**-12 or bound_rel > 2.0**-12 or not gap_ok or not rows_ok:
        raise AssertionError("packed scan kernel disagrees with its plain version")
    report["tilemin2_packed"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, yardstick_matmul_min_ms=yard_ms,
    )


def check_topk(gallery, n_valid, queries, k, report=None, key="topk_l2", window=None, precise=False):
    """topk_l2 kernel (bf16, windowed or precise) vs its plain version on
    the path's gallery. The kernel's rows are rescored here: each must sit
    at the distance the kernel reports, and may differ from the plain pick
    only where the two tie within the sum-order tolerance: 2^-12 relative
    + 1e-6 for bf16 products; 2^-16 absolute for the fp32 oracle (sums of
    1536 products of unit vectors in another order: ~sqrt(D) 2^-24 typical,
    D 2^-24 at worst)."""
    import torch

    from fast_image_recognition_tpu_torch.kernels import build, plain

    q = queries.to(torch.float32 if precise else torch.bfloat16).contiguous()
    launch = lambda: build.launch_topk_l2(q, gallery, k, n_valid, window=window, precise=precise)  # noqa: E731
    kd, ki = launch()
    pd, pi = plain.topk_l2_plain(q, gallery, k, n_valid, window=window, precise=precise)
    torch.cuda.synchronize()
    err = (kd - pd).abs().max().item()
    idx_eq = (ki == pi).float().mean().item()
    b, dim = q.shape
    lo, hi = window if window is not None else (0, dim)
    in_range = bool(((ki >= 0) & (ki < n_valid)).all())
    rows = gallery[ki.clamp(0, n_valid - 1).long()][:, :, lo:hi].to(torch.float32)  # [B, k, W]
    qf = q[:, lo:hi].to(torch.float32)
    d_rows = torch.clamp_min(
        (qf * qf).sum(1)[:, None] + (rows * rows).sum(2) - 2.0 * torch.einsum("bd,bkd->bk", qf, rows), 0.0
    )
    del rows
    tol = torch.full_like(pd, 2.0**-16) if precise else 2.0**-12 * pd.abs() + 1e-6
    ok = in_range and bool(((ki == pi) | ((d_rows - pd).abs() <= tol)).all())
    ok = ok and bool(((kd - d_rows).abs() <= tol).all())
    width = hi - lo
    ms = cuda_ms(launch, reps=3)
    plain_ms = cuda_ms(lambda: plain.topk_l2_plain(q, gallery, k, n_valid, window=window, precise=precise), reps=1)
    # yardsticks, not the same function: the library's matmul of the same
    # operands (fp32 in true fp32 for the oracle, on an fp32 copy of the
    # gallery; the window's columns for a windowed scan) plus topk or min
    g = gallery[:n_valid]
    if precise:
        g = g.to(torch.float32)
        yard_ms = cuda_ms(lambda: torch.topk(q @ g.T, k, dim=1), reps=1)
    elif window is not None:
        ql, gl = q[:, lo:hi], g[:, lo:hi]
        yard_ms = cuda_ms(lambda: (ql @ gl.T).min(dim=1), reps=1)
        ql = gl = None
    else:
        yard_ms = cuda_ms(lambda: torch.topk(q @ g.T, k, dim=1), reps=1)
    g = None
    b_ms, b_by = bound(2.0 * b * n_valid * width, n_valid * width * gallery.element_size() + b * width * q.element_size()
                       + b * k * 8, PEAK_FP32_FLOPS if precise else PEAK_BF16_FLOPS)
    variant = "precise" if precise else f"window {window}" if window else "bf16"
    phase(
        f"topk_l2 ({variant}) B={b} N={n_valid} D={dim} k={k}: indices equal {100 * idx_eq:.3f}%, "
        f"max |d| gap {err:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"matmul+{'min' if window else 'topk'} yardstick {yard_ms:.3f} ms, "
        f"bound {b_ms:.3f} ms ({b_by})"
    )
    if not ok:
        raise AssertionError(f"topk_l2 kernel ({variant}, k={k}) disagrees with its plain version")
    if report is not None:
        report.setdefault(key, []).append(dict(
            shape=f"B={b} N={n_valid} D={dim} k={k}" + (f" window={list(window)}" if window else ""),
            max_abs_err=err, indices_equal=idx_eq, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None, **{f"yardstick_matmul_{'min' if window else 'topk'}_ms": yard_ms},
        ))


def check_tile_scan(name, q, g, gsq, tile_g, report, *, bf16_scores=False, quant=None):
    """bf16 tile scan (``quant=None``) or int8 tile scan (``quant=(qs, gsc,
    compute)``) kernel vs its plain version on the path's tensors. Scores
    lie within [-3, 3] here (|g|^2 <= 1 and unit queries): the fp32 sum
    order of the dot moves them by < 2^-16, a bf16 score, rounded three
    times by at most half a bf16 ulp below magnitude 4, by < 2^-6, and the
    int8 scan with bf16 products summed in fp32
    past 2^24 by < 2^-12 of its cross term. The kernel's minima must agree
    with the plain ones within that; its rows, rescored here from the same
    operands, must sit at its minima within that, and may differ from the
    plain rows only at such ties. A minimum at a row past n_valid (its
    |g|^2 is BIG_DIST) is not rescored from the row's data. ``report=None``
    checks without timing. Returns (kernel minima, kernel rows, plain
    minima)."""
    import torch

    from fast_image_recognition_tpu_torch.kernels import build, plain

    gsq = gsq.reshape(-1)
    if quant is None:
        launch = lambda: build.launch_tilemin(q, g, gsq, tile_g, bf16_scores)  # noqa: E731
        run_plain = lambda: plain.tilemin_plain(q, g, gsq, tile_g, bf16_scores)  # noqa: E731
        tol = 2.0**-6 if bf16_scores else 2.0**-16
    else:
        qs, gsc, compute = quant
        gsc = gsc.reshape(-1)
        launch = lambda: build.launch_tilemin_quant(q, qs, g, gsq, gsc, tile_g, compute)  # noqa: E731
        run_plain = lambda: plain.tilemin_quant_plain(q, qs, g, gsq, gsc, tile_g, compute)  # noqa: E731
        tol = 0.0 if compute == "int8" else 2.0**-12
    kd, ki = launch()
    pd, pi = run_plain()
    torch.cuda.synchronize()
    fin = torch.isfinite(pd)
    err = (kd - pd)[fin].abs().max().item()
    both_inf = bool((torch.isinf(kd) == torch.isinf(pd)).all())
    idx_eq = (ki == pi).float().mean().item()
    val_eq = (kd == pd).float().mean().item()

    # rescore the returned rows from the same operands (fp32 sums; float64
    # for the exact int8 dot)
    def rescore(rows):
        wide = torch.float64 if quant is not None and quant[2] == "int8" else torch.float32
        cross = torch.einsum("bd,btd->bt", q.to(wide), g[rows.long()].to(wide)).to(torch.float32)
        if quant is None:
            return gsq[rows.long()] - 2.0 * cross
        return gsq[rows.long()] - (2.0 * qs)[:, None] * (cross * gsc[rows.long()])

    if quant is None:  # score magnitude scale for the bf16 tolerance
        scale = 1.0
    else:
        scale = (2.0 * qs.abs().max() * gsc.abs().max() * q.shape[1] * 127 * 127).item()
    atol = tol * scale + (2.0**-16 if quant is None or quant[2] != "int8" else 0.0)
    d_k, d_p = rescore(ki), rescore(pi)
    fin_k = torch.isfinite(kd) & (gsq[ki.long()] < 1e37)
    rows_ok = bool(((d_k - kd).abs() <= atol)[fin_k].all()) and bool(((ki == pi) | ((d_k - d_p).abs() <= atol)).all())
    ok = err <= atol and both_inf and rows_ok and bool((ki // tile_g == torch.arange(ki.shape[1], device=ki.device)).all())
    b, d = q.shape
    np_ = g.shape[0]
    n_tiles = ki.shape[1]
    if report is None:
        phase(
            f"tile scan {name} B={b} Np={np_} D={d} tile_g={tile_g}: rows equal {100 * idx_eq:.3f}%, minima "
            f"equal {100 * val_eq:.3f}%, max |min| gap {err:.3e} (tolerance {atol:.3e}), rescored rows "
            f"{'ok' if rows_ok else 'WRONG'}"
        )
        if not ok:
            raise AssertionError(f"tile scan kernel disagrees with its plain version ({name})")
        return kd, ki, pd
    ms = cuda_ms(launch, reps=10 if d <= 128 else 3)
    plain_ms = cuda_ms(run_plain, reps=1)
    if quant is None:
        yard_ms = cuda_ms(lambda: (q @ g.T).view(b, n_tiles, tile_g).min(dim=2), reps=3)
        b_ms, b_by = bound(2.0 * b * np_ * d, np_ * d * 2 + np_ * 4 + b * d * 2 + b * n_tiles * 8)
    else:
        # the library's matmul of the same operands, then the per-tile min:
        # torch._int_mm (int8 x int8 -> int32) for compute int8, a bf16
        # matmul of the same values for compute bf16
        if quant[2] == "int8":
            yard = lambda: torch._int_mm(q, g.t()).view(b, n_tiles, tile_g).min(dim=2)  # noqa: E731
        else:
            gb, qb = g.to(torch.bfloat16), q.to(torch.bfloat16)
            yard = lambda: (qb @ gb.T).view(b, n_tiles, tile_g).min(dim=2)  # noqa: E731
        try:
            yard_ms = cuda_ms(yard, reps=3)
        except RuntimeError as e:  # a yardstick, not a gate: say why it is missing
            print(f"  {name}: matmul+min yardstick not measured: {str(e).splitlines()[0]}", flush=True)
            yard_ms = None
        yard = gb = qb = None
        peak = PEAK_INT8_OPS if quant[2] == "int8" else PEAK_BF16_FLOPS
        b_ms, b_by = bound(2.0 * b * np_ * d, np_ * d + 2 * np_ * 4 + b * d + b * 4 + b * n_tiles * 8, peak)
    phase(
        f"tile scan {name} B={b} Np={np_} D={d} tile_g={tile_g}: rows equal {100 * idx_eq:.3f}%, minima "
        f"equal {100 * val_eq:.3f}%, max |min| gap {err:.3e} (tolerance {atol:.3e}), rescored rows "
        f"{'ok' if rows_ok else 'WRONG'}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, matmul+min yardstick "
        f"{'not measured' if yard_ms is None else f'{yard_ms:.3f} ms'}, bound {b_ms:.3f} ms ({b_by})"
    )
    if not ok:
        raise AssertionError(f"tile scan kernel disagrees with its plain version ({name})")
    report.append(dict(
        shape=name, b=b, np=np_, d=d, tile_g=tile_g, max_abs_err=err, rows_equal=idx_eq, minima_equal=val_eq,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None, yardstick_matmul_min_ms=yard_ms,
    ))
    return kd, ki, pd


# (rows, n_valid, D, B) off the main path: widths no multiple of 8, a
# batch of 1 and one past two query blocks, n_valid inside a tile
EDGE_SHAPES = [(5000, 4321, 124, 130), (9000, 9000, 40, 64), (3000, 2900, 120, 1)]


def check_edge_shapes(dev):
    """The tile scans and the top-k variants against their plain versions
    at :data:`EDGE_SHAPES`, untimed: galleries padded with ``pad_cols`` as
    the services pad them, tile_g 128 to 1024, so that some tiles hold
    nothing but rows past n_valid (real rows up to the gallery's size,
    zeros after). There each minimum must equal the plain one bit for
    bit: BIG_DIST with fp32 scores, inf with bf16 scores, at the tile's
    first row. Returns the number of such whole-pad (query, tile) pairs
    checked."""
    import torch

    from fast_image_recognition_tpu_torch.kernels import plain
    from fast_image_recognition_tpu_torch.ops import distance_kernel as dk
    from fast_image_recognition_tpu_torch.ops.quant import quantize_rows

    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    big = torch.tensor(plain.BIG_DIST, dtype=torch.float32).item()
    pad_pairs = 0
    for n, nv, d, b in EDGE_SHAPES:
        g32 = _unit(torch.randn((n, d), generator=gen, device=dev))
        q32 = _unit(g32[:b] + 0.1 * torch.randn((b, d), generator=gen, device=dev))
        q16 = dk.pad_cols(q32.to(torch.bfloat16), 8)
        tag = f"edge N={n} n_valid={nv} D={d} B={b}"
        for tg in (128, 256, 512, 1024):
            g16 = dk.pad_cols(dk.pad_gallery(g32.to(torch.bfloat16), tg), 8)
            gsq = dk.gallery_sq_norms(g16, nv, tg)
            scans = [(f"{tag} {'bf16' if bf else 'f32'}-scores",
                      dict(q=q16, g=g16, bf16_scores=bf), float("inf") if bf else big) for bf in (False, True)]
            if tg == 128:
                gq, gs = quantize_rows(g16)
                qq, qs = quantize_rows(q32)
                gsc = dk.quant_gallery_scales(gs, nv, tg)
                scans += [(f"{tag} int8-scan-{c}", dict(q=dk.pad_cols(qq), g=dk.pad_cols(gq), quant=(qs, gsc, c)), big)
                          for c in ("int8", "bf16")]
            for name, kw, pad_value in scans:
                kd, ki, pd = check_tile_scan(name, kw.pop("q"), kw.pop("g"), gsq, tg, None, **kw)
                whole_pad = torch.arange(kd.shape[1], device=dev) * tg >= nv
                if bool(whole_pad.any()):
                    first = (torch.arange(kd.shape[1], device=dev, dtype=torch.int32) * tg)[None, whole_pad]
                    if not (bool((kd[:, whole_pad] == pd[:, whole_pad]).all())
                            and bool((kd[:, whole_pad] == pad_value).all())
                            and bool((ki[:, whole_pad] == first).all())):
                        raise AssertionError(f"whole-pad tiles disagree ({name}, tile_g={tg})")
                    pad_pairs += int(whole_pad.sum()) * b
        q8 = dk.pad_cols(q32, 8)
        check_topk(dk.pad_cols(g32, 8), nv, q8, 16, precise=True)  # fp32 rows
        g8 = dk.pad_cols(g32.to(torch.bfloat16), 8)
        check_topk(g8, nv, q8, 3, window=(5, d - 3), precise=True)
        check_topk(g8, nv, q8, 5, window=(1, d - 1))
        check_topk(g8, nv, q8, 16)
    return pad_pairs


def check_single_scan(name, qa, ga, tile_g, report):
    """Single-min packed scan kernel vs its plain version on the cascade's
    tensors: equal keys, decoded distances within 2^-12 relative, and the
    rows the keys carry rescored here in fp32: each must sit at its key's
    distance, and the kernel's row may differ from the plain one's only at
    a near-tie."""
    import torch

    from fast_image_recognition_tpu_torch.kernels import build, plain
    from fast_image_recognition_tpu_torch.ops import distance_kernel as dk

    keys = build.launch_tilemin_packed(qa, ga, tile_g)
    ref = plain.tilemin_packed_plain(qa, ga, tile_g)
    torch.cuda.synchronize()
    kd, pd = dk._key_to_dist(keys, tile_g), dk._key_to_dist(ref, tile_g)
    err = (kd - pd).abs().max().item()
    rel = err / max(pd.abs().max().item(), 1e-30)
    key_eq = (keys == ref).float().mean().item()
    qf = qa.to(torch.float32)
    d_rows = [
        torch.clamp_min(torch.einsum("bd,btd->bt", qf, ga[dk._key_to_row(k, tile_g).long()].to(torch.float32)), 0.0)
        for k in (keys, ref)
    ]
    tol = 2.0**-12 * d_rows[1].abs() + 1e-6
    rows_ok = bool(((d_rows[0] - kd).abs() <= tol).all()) and bool(((d_rows[0] - d_rows[1]).abs() <= tol).all())
    row_eq = ((keys & (tile_g - 1)) == (ref & (tile_g - 1))).float().mean().item()
    b, da = qa.shape
    np_ = ga.shape[0]
    n_tiles = keys.shape[1]
    ms = cuda_ms(lambda: build.launch_tilemin_packed(qa, ga, tile_g), reps=10)
    plain_ms = cuda_ms(lambda: plain.tilemin_packed_plain(qa, ga, tile_g), reps=2)
    yard_ms = cuda_ms(lambda: (qa @ ga.T).view(b, n_tiles, tile_g).min(dim=2), reps=3)
    b_ms, b_by = bound(2.0 * b * np_ * da, np_ * da * 2 + b * da * 2 + b * n_tiles * 4)
    phase(
        f"single-min scan {name} B={b} Np={np_} Da={da} tile_g={tile_g}: keys equal "
        f"{100 * key_eq:.3f}%, rows equal {100 * row_eq:.3f}%, max |d| gap {err:.3e} "
        f"({rel:.2e} rel), rescored rows {'ok' if rows_ok else 'WRONG'}; kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, matmul+min yardstick {yard_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})"
    )
    if rel > 2.0**-12 or not rows_ok:
        raise AssertionError(f"single-min scan kernel disagrees with its plain version ({name})")
    report.setdefault("shapes", []).append(dict(
        shape=name, b=b, np=np_, da=da, tile_g=tile_g, max_abs_err=err, keys_equal=key_eq,
        ms=ms, plain_ms=plain_ms, yardstick_matmul_min_ms=yard_ms, bound_ms=b_ms, bound_by=b_by,
    ))


def check_partial_escalation(svc, emb, gallery, dev, share: float = 0.05):
    """The exact scan of the escalated probes when about ``share`` of the
    batch escalates (the certificate's working case; the class-structured
    layout escalates every probe, the planted one none), three ways on
    the same embeddings and mask: the service's ``_escalate`` (escalated
    probes moved to the front, one masked launch), the same mask with
    the probes left in place (every 64-query block with an escalated
    probe scans), and the gather of the escalated rows behind a host sync
    (``nonzero``), as the previous serving code did. All three must give
    the same rows. Returns the timings (host clock between syncs)."""
    import torch

    from fast_image_recognition_tpu_torch.ops import distance_kernel as dk

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    esc = torch.rand(emb.shape[0], generator=gen, device=dev) < share
    with torch.no_grad():
        _, pick, _ = svc._certified(emb)
    pick = pick.to(torch.int32)

    def grouped():
        return svc._escalate(emb, pick, esc)

    def in_place():
        _, ei = dk.topk_l2(emb, gallery, 1, n_valid=svc.n_valid, row_mask=esc)
        return torch.where(esc, ei[:, 0], pick)

    def gathered():
        rows = esc.nonzero()[:, 0]
        out = pick.clone()
        if rows.numel():
            out[rows] = dk.topk_l2(emb[rows], gallery, 1, n_valid=svc.n_valid)[1][:, 0]
        return out

    ways = {"front": grouped, "in_place": in_place, "gather_sync": gathered}
    with torch.no_grad():
        outs = {k: f() for k, f in ways.items()}
        if not all(bool((o == outs["gather_sync"]).all()) for o in outs.values()):
            raise AssertionError("the escalation ways disagree")
        ms = {k: [] for k in ways}
        for k in ("gather_sync", "front", "in_place", "in_place", "front", "gather_sync"):
            ms[k].append(host_ms(ways[k], TIMED_CALLS))
    n_esc = int(esc.sum())
    # 64-query blocks of the exact scan that hold an escalated probe (BATCH % 64 == 0)
    front_blocks, in_place_blocks = -(-n_esc // 64), int(esc.view(-1, 64).any(dim=1).sum())
    row = dict(escalated=n_esc, batch=emb.shape[0], scanned_blocks_front=front_blocks,
               scanned_blocks_in_place=in_place_blocks, **{f"{k}_ms": v for k, v in ms.items()})
    phase(
        f"partial escalation ({n_esc} of {emb.shape[0]} probes): exact step {ms['front']} ms with the escalated "
        f"probes in front ({front_blocks} query blocks scan), {ms['in_place']} ms in place ({in_place_blocks} blocks), "
        f"{ms['gather_sync']} ms by gather behind a host sync; same rows all three"
    )
    return row


def random_unit_gallery(n: int, dim: int, dev, seed: int = 1):
    """bench.py's ``_planted_gallery_device`` with nothing to plant (its bf
    config): every row, padding included (n rounded up to 1024), is
    normalize(N(0, I)) in bf16, drawn on the card from a ``torch.Generator``
    a chunk at a time (no fp32 copy of the gallery)."""
    import torch

    n_pad = -(-n // 1024) * 1024
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    gal = torch.empty((n_pad, dim), dtype=torch.bfloat16, device=dev)
    for s in range(0, n_pad, 65536):
        rows = torch.randn((min(65536, n_pad - s), dim), generator=gen, device=dev)
        gal[s : s + rows.shape[0]] = (rows * torch.rsqrt(torch.clamp_min((rows * rows).sum(1), 1e-30))[:, None]).to(
            torch.bfloat16
        )
    return gal


def near_ties(trace, caps, b):
    """[b] bool: probes whose exit-rule margin lies within NEAR_TIE * d1 of
    zero, or of the margin at a capacity cut, at a level where they were
    live."""
    import torch

    tie = torch.zeros(b, dtype=torch.bool, device=trace[0]["gidx"].device)
    for level, t in enumerate(trace):
        live, m, d1 = t["live"], t["margin"], t["d1"]
        close = live & (m.abs() <= NEAR_TIE * d1.abs())
        if level + 1 < len(trace):
            surv = live & ~(m > 0)
            c = min(caps[level + 1], m.shape[0])
            if int(surv.sum()) > c:
                cut = torch.sort(torch.where(surv, m, float("inf")), stable=True).values[c - 1 : c + 1]
                for v in cut:
                    close |= surv & ((m - v).abs() <= NEAR_TIE * d1.abs())
        tie[t["gidx"][close]] = True
    return tie


def cascade_breakdown(casc, images, caps, report):
    """Per level, at the shapes the cascade runs: segment forward ms, match
    ms (host clock with a sync, each alone) and the single-min kernel's
    CUDA-event ms beside its bound."""
    import torch

    from fast_image_recognition_tpu_torch.kernels import build
    from fast_image_recognition_tpu_torch.ops import distance_kernel as dk
    from fast_image_recognition_tpu_torch.serving import _normalize

    net = casc.net
    carry = images
    rows = []
    with torch.no_grad():
        for level, (start, end) in enumerate(casc.segments):
            final = level == casc.num_levels - 1
            def seg(carry=carry, level=level, start=start, end=end):
                return net.run_blocks(net.stem(carry) if level == 0 else carry, start, end)
            seg_ms = host_ms(seg, 3)
            h = seg()
            emb = _normalize(net.head(h)) if final else casc._level_embedding(level, h)
            match_ms = host_ms(lambda: casc._level_match(level, emb), 3)
            if final:
                q, aug, d = (emb - casc._mu) @ casc._w, casc._gal_aug, casc.pca_dim
            else:
                a = casc._tap_assets[level]
                q, aug, d = emb, a["aug"], a["dim"]
            qa = dk._augment_queries(q, d, aug.shape[1])
            k_ms = cuda_ms(lambda: build.launch_tilemin_packed(qa, aug, casc._tile_g), reps=10)
            b = qa.shape[0]
            b_ms, b_by = bound(2.0 * b * aug.shape[0] * aug.shape[1],
                               aug.numel() * 2 + qa.numel() * 2 + b * (aug.shape[0] // casc._tile_g) * 4)
            rows.append(dict(level=level, batch=b, segment_ms=seg_ms, match_ms=match_ms,
                             kernel_ms=k_ms, bound_ms=b_ms, bound_by=b_by))
            if not final:
                carry = h[: min(caps[level + 1], h.shape[0])]
    report["per_level"] = rows
    return rows


# kernel vs plain tolerance of the fused MBConv block: both round to bf16 at
# the same places and differ only in fp32 summation order, which can flip
# a bf16 rounding; a flipped output rounding is one bf16 ulp, at most 2^-8
# of the largest output, and a flipped hidden value moves the project's
# sum by far less. 2^-6 of max |plain| leaves a factor of 4.
MB_TOL = 2.0**-6


def mbconv_bound(b, hw, cin, ce, cout, k, has_expand, param_bytes):
    """Least time of one stride-1 block: the expand and project products
    at the bf16 tensor-core peak, the depthwise taps at the fp32 CUDA-core
    peak, or one read of x and the weights and one write of y."""
    pix = b * hw * hw
    t_mm = 2.0 * pix * ((cin * ce if has_expand else 0) + ce * cout) / PEAK_BF16_FLOPS
    t_dw = 2.0 * pix * ce * k * k / PEAK_FP32_FLOPS
    t_bytes = (2.0 * pix * (cin + cout) + param_bytes) / PEAK_HBM_BYTES
    t_ops = max(t_mm, t_dw)
    return (t_ops * 1e3, "operations") if t_ops >= t_bytes else (t_bytes * 1e3, "bytes")


def run_mbconv_pair(x, q, cfg):
    """The fused block's kernel and plain version on the same input:
    (kernel out, plain out, relative max |difference| over max |plain|,
    share of bit-equal outputs, the two launchers)."""
    import torch

    from fast_image_recognition_tpu_torch.kernels import plain
    from fast_image_recognition_tpu_torch.ops import mbconv_kernel as mb

    k = cfg["kernel"]
    pads = tuple(mb._same_pads(n, k, 1)[1:] for n in x.shape[2:])
    run_k = lambda: mb.mbconv(x, q, cfg)  # noqa: E731
    run_p = lambda: plain.mbconv_plain(x, q, k, pads, cfg["activation"], cfg["residual"])  # noqa: E731
    yk, yp = run_k(), run_p()
    torch.cuda.synchronize()
    if not yk.is_contiguous(memory_format=torch.channels_last) or yk.shape != yp.shape:
        raise AssertionError("the mbconv kernel's output has the wrong shape or layout")
    rel = ((yk.float() - yp.float()).abs().max() / torch.clamp_min(yp.float().abs().max(), 1e-30)).item()
    eq = (yk == yp).float().mean().item()
    return yk, yp, rel, eq, run_k, run_p


def check_mbconv_blocks(net, net_f, images, report):
    """The fused MBConv kernel against its plain version at each stride-1
    block of the folded forward, fed the activation the per-op forward
    produces at that block's input, with the fused module's folded
    weights; timed beside its bound and the per-op block (cuDNN and
    elementwise ops; not one library call, so no ``library_ms``)."""
    import torch

    rows = []
    with torch.no_grad():
        h = net.stem(images)
        for i, (name, blk) in enumerate(zip(net.names, net.blocks)):
            if str(i) in net_f.fused_blocks:
                if not h.is_contiguous(memory_format=torch.channels_last):
                    raise AssertionError(f"the per-op input of {name} is not channels_last")
                fb = net_f.fused_blocks[str(i)]
                q = {n: getattr(fb, n) for n in fb.param_names}
                yk, yp, rel, eq, run_k, run_p = run_mbconv_pair(h, q, fb.cfg)
                err = (yk.float() - yp.float()).abs().max().item()
                del yk, yp
                ms = cuda_ms(run_k, reps=5)
                plain_ms = cuda_ms(run_p, reps=1)
                per_op_ms = cuda_ms(lambda blk=blk, h=h: blk(h), reps=5)
                b, cin, hw, _ = h.shape
                ce, cout = q["w_dw"].shape[1], q["w_proj"].shape[1]
                pbytes = sum(t.numel() * t.element_size() for t in q.values())
                b_ms, b_by = mbconv_bound(b, hw, cin, ce, cout, fb.cfg["kernel"], "w_exp" in q, pbytes)
                row = dict(block=name, b=b, hw=hw, cin=cin, ce=ce, cout=cout, k=fb.cfg["kernel"],
                           max_abs_err=err, rel_err=rel, bit_equal=eq, ms=ms, plain_ms=plain_ms,
                           per_op_ms=per_op_ms, bound_ms=b_ms, bound_by=b_by,
                           dw_round_trip_ms=4.0 * b * hw * hw * ce / PEAK_HBM_BYTES * 1e3)
                rows.append(row)
                print(f"  mbconv {name} B={b} {hw}x{hw} {cin}->{ce}->{cout} k{row['k']}: rel err {rel:.2e} "
                      f"(bit-equal {100 * eq:.2f}%), kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, per-op "
                      f"{per_op_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})", flush=True)
                if rel > MB_TOL:
                    raise AssertionError(f"mbconv kernel disagrees with its plain version at {name}: {rel:.3e}")
            h = blk(h)
    tot = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "per_op_ms", "bound_ms", "dw_round_trip_ms")}
    phase(f"mbconv blocks ({len(rows)} stride-1 blocks, B={images.shape[0]}): every kernel output within "
          f"{MB_TOL:.2e} of max |plain|; summed kernel {tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, "
          f"per-op {tot['per_op_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms (+ {tot['dw_round_trip_ms']:.3f} ms "
          f"of depthwise round trip at the memory rate)")
    report["blocks"] = rows
    report["total"] = tot
    return rows


def check_mbconv_edges(net_f, dev):
    """The fused MBConv kernel against its plain version off the main
    path's shapes, untimed: batches of 1 and 130, an odd plane (15),
    relu6, no SE, no expand, k=7 (random weights), and an expand bias
    inflated 50x, where any act(b_exp) leaking into the SAME border taps
    would dominate the edge rows and columns. Returns the cases."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(29)

    def params(i):
        fb = net_f.fused_blocks[str(i)]
        return {n: getattr(fb, n) for n in fb.param_names}, dict(fb.cfg)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(dtype)

    cases = []
    for name, i, b, hw, change in [
        ("block4b", 6, 130, 15, {}),
        ("block5b", 9, 1, 15, {}),
        ("block2b relu6", 2, 130, 15, {"activation": "relu6"}),
        ("block6b no SE", 12, 130, 7, {"has_se": False}),
        ("block1a no expand", 0, 1, 15, {}),
        ("block1a no expand", 0, 130, 15, {}),
        ("block2b b_exp x50", 2, 130, 15, {"b_exp": 50.0}),
    ]:
        q, cfg = params(i)
        if "b_exp" in change:
            q["b_exp"] = q["b_exp"] * change.pop("b_exp")
        cfg.update(change)
        if not cfg["has_se"]:
            q = {n: t for n, t in q.items() if not n.startswith(("w_se", "b_se"))}
        cases.append((f"{name} B={b} {hw}x{hw}", q, cfg, b, hw))
    cin, ce, cout = 32, 64, 32
    q7 = dict(w_exp=rnd(cin, ce, scale=0.2, dtype=torch.bfloat16), b_exp=rnd(ce, scale=0.1),
              w_dw=rnd(49, ce, scale=0.2), b_dw=rnd(ce, scale=0.1), w_se1=rnd(ce, 8, scale=0.2),
              b_se1=rnd(8, scale=0.1), w_se2=rnd(8, ce, scale=0.2), b_se2=rnd(ce, scale=0.1),
              w_proj=rnd(ce, cout, scale=0.2, dtype=torch.bfloat16), b_proj=rnd(cout, scale=0.1))
    cfg7 = dict(kernel=7, stride=1, has_expand=True, has_se=True, residual=True, activation="swish")
    cases.append(("k7 random weights B=130 15x15", q7, cfg7, 130, 15))
    out = []
    with torch.no_grad():
        for name, q, cfg, b, hw in cases:
            c_in = q["w_exp"].shape[0] if "w_exp" in q else q["w_dw"].shape[1]
            x = rnd(b, hw, hw, c_in, dtype=torch.bfloat16).permute(0, 3, 1, 2)
            yk, yp, rel, eq, _, _ = run_mbconv_pair(x, q, cfg)
            border = max(
                ((yk.float() - yp.float())[sl].abs().max() / torch.clamp_min(yp.float()[sl].abs().max(), 1e-30)).item()
                for sl in ((slice(None), slice(None), slice(None), [0, 1, -2, -1]),
                           (slice(None), slice(None), [0, 1, -2, -1], slice(None)))
            )
            print(f"  mbconv edge {name}: rel err {rel:.2e}, border rows/columns {border:.2e}, "
                  f"bit-equal {100 * eq:.2f}%", flush=True)
            if rel > MB_TOL or border > MB_TOL:
                raise AssertionError(f"mbconv kernel disagrees with its plain version ({name})")
            out.append(dict(case=name, rel_err=rel, border_rel_err=border, bit_equal=eq))
    return out


def device_trace(fn):
    """One call of ``fn`` (after a warm-up) under ``torch.profiler``
    (CUPTI): the device's busy time (kernels and copies on the one
    stream, which do not overlap), the window from the first device
    activity's start to the last one's end, the idle share of that window,
    and device time summed by kernel name. None where the trace holds no
    device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None
    start = min(e.time_range.start for e in dev)
    end = max(e.time_range.end for e in dev)
    busy = sum(e.time_range.elapsed_us() for e in dev)
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return dict(window_ms=(end - start) / 1e3, busy_ms=busy / 1e3, idle_share=1.0 - busy / max(end - start, 1e-9),
                events=len(dev), by_name=by_name)


def check_s2d_stem(np_vars, net, net_f, images, dev):
    """The space-to-depth stem against the plain stride-2 stem at fp32
    (TF32 off, ``device.py``), within the JAX package's 2e-5; then both
    stems' times in bf16, the serving type."""
    import torch

    from fast_image_recognition_tpu_torch.models.inference import make_infer_fn

    kw = dict(resolution=RES, dtype=torch.float32, device=dev)
    plain32, s2d32 = make_infer_fn(np_vars, "b0", **kw), make_infer_fn(np_vars, "b0", space_to_depth=True, **kw)
    if not s2d32.space_to_depth or plain32.space_to_depth:
        raise AssertionError("the space-to-depth fold is missing")
    with torch.no_grad():
        a, b = plain32.stem(images), s2d32.stem(images)
        err = (a - b).abs().max().item()
        ok = bool(torch.allclose(b, a, rtol=2e-5, atol=2e-5))
        scale = a.abs().max().item()
        del a, b
        ms_plain = cuda_ms(lambda: net.stem(images), reps=5)
        ms_s2d = cuda_ms(lambda: net_f.stem(images), reps=5)
    phase(f"s2d stem (fp32, TF32 off, B={images.shape[0]}): max |s2d - plain| {err:.3e} of max |plain| {scale:.3f}, "
          f"within rtol=atol=2e-5: {ok}; bf16 stem {ms_plain:.3f} ms plain, {ms_s2d:.3f} ms space-to-depth")
    if not ok:
        raise AssertionError("the space-to-depth stem disagrees with the plain stem")
    return dict(max_abs_err=err, max_abs=scale, plain_stem_ms=ms_plain, s2d_stem_ms=ms_s2d)


def check_fused_path(net, net_f, svc_u, info, gallery, labels, images, idx, idx_oracle, plain_sec, launches, dev):
    """bench.py's plain line (PCA-124 packed, rescore 48, escalate 0.05)
    on the fused module: ``RecognitionService(serving_fn=net_f)``, timed
    over TIMED_CALLS calls ending in a sync, one call under sync debug
    "error", launches counted; its embedding against the per-op module's
    (JAX's 0.05), its rows and labels against the per-op line's ``idx``
    and the fp32 oracle. A label that differs from the per-op line's must
    come from a near-tie that the embedding difference swapped: each
    line's pick is the nearer of the two picks to that line's own
    embedding, within 2^-7 of the distance (the scans round query and rows
    to bf16). Last, one call of
    each line (``svc_u`` is the per-op plain line) under the profiler:
    device idle share and the fused kernel's two launches' device time."""
    import numpy as np
    import torch

    from fast_image_recognition_tpu_torch.kernels import build
    from fast_image_recognition_tpu_torch.serving import RecognitionService

    n_fused = len(net_f.fused_blocks)
    if n_fused != 12:
        raise AssertionError(f"the fused module fuses {n_fused} blocks, B0 has 12 stride-1 blocks")
    svc = RecognitionService(None, info, gallery, labels=labels, n_valid=GALLERY, serving_fn=net_f,
                             pca_dim=124, pca_scan="packed", device=dev)
    build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out = svc.identify_device(images)
    torch.cuda.synchronize()
    t = time.time()
    for _ in range(TIMED_CALLS):
        out = svc.identify_device(images)
    torch.cuda.synchronize()
    sec = (time.time() - t) / TIMED_CALLS
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.set_sync_debug_mode("error")
    try:
        out2 = svc.identify_device(images)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    calls = TIMED_CALLS + 2
    check_launches("fused", launches, mbconv=2 * n_fused * calls, tilemin2_packed=calls, topk_l2=calls)
    if not bool((out2 == out).all()):
        raise AssertionError("the fused path's answers changed under sync debug mode")
    with torch.no_grad():
        embed_ms = host_ms(lambda: svc._embed(images), TIMED_CALLS)
        eu, ef = net(images)["embedding"], net_f(images)["embedding"]
        emb_rel = ((ef - eu).abs().max() / eu.abs().max()).item()
        nu, nf = _unit(eu), _unit(ef)
        idx_f = out.to(torch.int64)
        idx_u = torch.as_tensor(idx, device=dev)
        gf, gu = gallery[idx_f].to(torch.float32), gallery[idx_u].to(torch.float32)

        def dist(e, g):
            return ((e - g) ** 2).sum(1)

        d_ff, d_fu, d_uf, d_uu = dist(nf, gf), dist(nf, gu), dist(nu, gf), dist(nu, gu)
        swapped = ((d_ff <= d_fu + 2.0**-7 * torch.maximum(d_ff, d_fu))
                   & (d_uu <= d_uf + 2.0**-7 * torch.maximum(d_uf, d_uu))).cpu().numpy()
    idx_f = idx_f.cpu().numpy()
    truth = np.arange(len(idx_f))
    label_differs = labels[idx_f] != labels[idx]
    row = dict(img_s=len(idx_f) / sec, ms=1e3 * sec, embed_ms=embed_ms, speedup_over_plain_line=plain_sec / sec,
               error_pct=100.0 * float(np.mean(labels[idx_f] != truth)),
               row_agreement_plain_line_pct=100.0 * float(np.mean(idx_f == idx)),
               label_agreement_plain_line_pct=100.0 * float(np.mean(~label_differs)),
               row_agreement_oracle_pct=100.0 * float(np.mean(idx_f == idx_oracle)),
               label_agreement_oracle_pct=100.0 * float(np.mean(labels[idx_f] == labels[idx_oracle])),
               label_differs_not_near_tie=int(np.sum(label_differs & ~swapped)),
               embedding_rel_diff=emb_rel,
               escalated_pct=100.0 * svc.last_escalated.float().mean().item(), peak_gib=peak_gib,
               launches=launches["fused"])
    phase(
        f"fused path: {row['img_s']:.1f} img/s ({row['ms']:.1f} ms/batch of {len(idx_f)}, embed {embed_ms:.1f} ms, "
        f"{row['speedup_over_plain_line']:.3f}x the per-op plain line), identity error {row['error_pct']:.3f}%, "
        f"agreement with the per-op line {row['row_agreement_plain_line_pct']:.3f}% rows / "
        f"{row['label_agreement_plain_line_pct']:.3f}% labels ({row['label_differs_not_near_tie']} label differences "
        f"outside near-ties), with the fp32 oracle {row['row_agreement_oracle_pct']:.3f}% rows / "
        f"{row['label_agreement_oracle_pct']:.3f}% labels; embedding max |fused - per-op| {emb_rel:.4f} of max "
        f"|per-op|; escalated {row['escalated_pct']:.2f}%; peak device memory {peak_gib:.2f} GiB; no host sync "
        f"in identify_device; launches {launches['fused']}"
    )
    if emb_rel > 0.05:
        raise AssertionError(f"the fused embedding differs from the per-op one by {emb_rel:.4f} > 0.05")
    if row["label_differs_not_near_tie"]:
        raise AssertionError("the fused path's labels differ from the per-op line's beyond near-ties")
    for line, s_ in (("plain", svc_u), ("fused", svc)):
        try:  # a measurement, not a gate: say why it is missing
            tr = device_trace(lambda s_=s_: s_.identify_device(images))
        except Exception as e:  # noqa: BLE001
            print(f"  {line} line trace not measured: {type(e).__name__}: {str(e).splitlines()[0]}", flush=True)
            tr = None
        if tr is None:
            row[f"trace_{line}"] = None
            continue
        by = tr.pop("by_name")
        tr["mbconv_expand_dw_ms"] = sum(v for k, v in by.items() if "expand_dw_kernel" in k)
        tr["mbconv_se_project_ms"] = sum(v for k, v in by.items() if "se_project_kernel" in k)
        tr["top"] = sorted(by.items(), key=lambda kv: -kv[1])[:6]
        row[f"trace_{line}"] = tr
        print(f"  {line} line, one call traced: device busy {tr['busy_ms']:.2f} ms of a {tr['window_ms']:.2f} ms "
              f"window (idle share {100 * tr['idle_share']:.1f}%, {tr['events']} device activities); mbconv "
              f"expand+depthwise {tr['mbconv_expand_dw_ms']:.2f} ms, SE+project {tr['mbconv_se_project_ms']:.2f} ms; "
              f"top {[(k[:60], round(v, 3)) for k, v in tr['top']]}", flush=True)
    return row


# chi2 1-NN and the exact brute-force harness over feature files
CHI2_B, CHI2_N, CHI2_D = 1024, 102_400, 1536  # scripts/chi2_cost.py's defaults
CHI2_TOL = 2.0**-16  # rcp.approx.ftz: 1 ulp per term; fp32 sums in another order: < 2^-20 here
CHI2_SLOW_ITERS = 1  # chi2_cost --iters for its eager streamed chi2 and KL scans (~4 and ~8 s a call)
BF_CLASSES, BF_PER_CLASS = 1024, 100  # brute-force line: 102,400 gallery rows + 1 probe per class
# SFU reciprocals of one H100 SXM: 16 per clock per SM, 132 SMs, 1.98 GHz boost
PEAK_SFU_RCP = 16 * 132 * 1.98e9


def chi2_rescore(q, g, rows):
    """Exact fp32 sums ``sum (g - q)^2 / max(g + q, 1e-30)`` of each query
    against its row (the plain version's division)."""
    import torch

    r = g[rows.long()].to(torch.float32)
    return ((r - q).square() / (r + q).clamp_min(1e-30)).sum(dim=1)


def chi2_bound(b, n, d, g_bytes):
    """(bound ms, detail): the larger of one SFU reciprocal per triple, 6
    fp32 operations per triple (JAX's CostEstimate, chi2_kernel.py:159) at
    67 TFLOP/s, and one read of the operands plus the [B] outputs."""
    triples = float(b) * n * d
    t = dict(reciprocals=triples / PEAK_SFU_RCP * 1e3, fp32=6.0 * triples / PEAK_FP32_FLOPS * 1e3,
             bytes=(n * d * g_bytes + b * d * 4 + b * 8) / PEAK_HBM_BYTES * 1e3)
    return max(t.values()), t


def check_chi2(q, g, n_valid, tag, timed=False):
    """chi2 kernel vs its plain version (exact division) on the same
    tensors. Its minima must lie within CHI2_TOL relative of the plain
    ones; its rows may differ from the plain rows only at near-ties: each
    row, rescored exactly here, must lie within CHI2_TOL of the plain
    minimum. Returns (report dict, kernel min, kernel rows)."""
    import torch

    from fast_image_recognition_tpu_torch.kernels import build, plain

    kd, ki = build.launch_chi2(q, g, n_valid)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    pd, pi = plain.chi2_nn_plain(q, g, n_valid)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)  # one call: the plain version takes seconds here
    in_range = bool(((ki >= 0) & (ki < n_valid)).all())
    d_rows = chi2_rescore(q, g, ki)
    tol = CHI2_TOL * pd
    rel = ((kd - pd).abs() / pd.clamp_min(1e-30)).max().item()
    ok = in_range and bool(((kd - pd).abs() <= tol).all()) and bool(((d_rows - pd).abs() <= tol).all())
    idx_eq = (ki == pi).float().mean().item()
    b, d = q.shape
    row = dict(shape=f"B={b} N={g.shape[0]} n_valid={n_valid} D={d} gallery {str(g.dtype).split('.')[-1]}",
               max_abs_err=(kd - pd).abs().max().item(), max_rel_err=rel, indices_equal=idx_eq, plain_ms=plain_ms)
    if timed:
        row["ms"] = cuda_ms(lambda: build.launch_chi2(q, g, n_valid), reps=5)
        row["bound_ms"], terms = chi2_bound(b, n_valid, d, g.element_size())
        row.update(bound_by="operations", bound_detail="SFU reciprocals, one per (query, row, feature)",
                   bound_terms_ms=terms, library_ms=None)
    phase(f"chi2 {tag} {row['shape']}: max rel gap {rel:.2e}, indices equal {100 * idx_eq:.3f}%"
          + (f"; kernel {row['ms']:.3f} ms, plain {plain_ms:.1f} ms, bound {row['bound_ms']:.3f} ms "
             f"(reciprocals; fp32 {terms['fp32']:.3f}, bytes {terms['bytes']:.3f})" if timed else ""))
    if not ok:
        raise AssertionError(f"chi2 kernel disagrees with its plain version ({tag}, {row['shape']})")
    return row, kd, ki


def check_chi2_edges(dev):
    """The chi2 kernel at edge shapes, untimed: B = 1 and 130, D = 100 (no
    multiple of 32), N = 1000 with zero rows past n_valid = 900 (their
    score sum(q) undercuts every real row for the down-scaled queries, so
    the mask must hold), n_valid = 896 (a whole 64-row kernel tile and a
    ragged one past it), a bf16 gallery, and equal rows (lowest row)."""
    import torch

    from fast_image_recognition_tpu_torch.kernels import plain

    gen = torch.Generator(device=dev)
    gen.manual_seed(29)

    def rows(m, d):
        x = torch.rand((m, d), generator=gen, device=dev)
        return x / x.sum(dim=1, keepdim=True)

    n, nv, d = 1000, 900, 100
    g = rows(n, d)
    g[nv:] = 0.0
    out = []
    for b in (1, 130):
        q = rows(b, d)
        q[::2] *= 0.01  # sum(q) = 0.01: a zero row would beat every real row
        unmasked = plain.chi2_nn_plain(q, g, n)[1]
        if not bool((unmasked >= nv).any()):
            raise AssertionError("edge case does not exercise the row mask")
        for gal, nv_ in ((g, nv), (g.to(torch.bfloat16), nv), (g, 896)):
            out.append(check_chi2(q, gal, nv_, "edge")[0])
        dup = g.clone()
        dup[[300, 520, 777]] = dup[40].clone()  # four equal rows
        q2 = q.clone()
        q2[0] = dup[40]
        if b > 1:
            dup[[610, 611]] = q2[1]  # a query's exact match, twice
        row, kd, ki = check_chi2(q2, dup, nv, "ties")
        if ki[0].item() != 40 or kd[0].item() != 0.0 or (b > 1 and ki[1].item() != 610):
            raise AssertionError(f"chi2 kernel broke the lowest-row tie rule: {ki[:2].tolist()}")
        out.append(row)
    return out


class Recording:
    """A matcher that keeps its last ``SearchResult`` (evaluate_matcher
    returns only the metrics)."""

    def __init__(self, matcher):
        self.matcher, self.name = matcher, matcher.name

    def set_budget(self, n):
        self.matcher.set_budget(n)

    def search(self, queries):
        self.last = self.matcher.search(queries)
        return self.last


def run_chi2_slice(dev, launches, smi):
    """chi2 kernel checks, ``chi2_cost`` and the brute-force line. Returns
    (the kernels-line row of ``chi2``, the lines' JSON)."""
    import tempfile

    import numpy as np
    import torch

    from fast_image_recognition_tpu_torch.config import DistanceKind
    from fast_image_recognition_tpu_torch.data import (
        load_feature_file,
        make_gallery_and_probes,
        make_synthetic_gallery,
        normalize_features,
        write_feature_file,
    )
    from fast_image_recognition_tpu_torch.evaluation import evaluate_matcher
    from fast_image_recognition_tpu_torch.kernels import build
    from fast_image_recognition_tpu_torch.ops.chi2_kernel import chi2_nn
    from fast_image_recognition_tpu_torch.scripts import chi2_cost
    from fast_image_recognition_tpu_torch.search import BruteForceMatcher

    # 15. the kernel at chi2_cost's shape (its own data), fp32 and bf16 rows
    g, q = chi2_cost.make_data(CHI2_N, CHI2_B, CHI2_D, dev)
    shapes = [check_chi2(q, g, CHI2_N, "kernel vs plain", timed=True)[0],
              check_chi2(q, g.to(torch.bfloat16), CHI2_N, "kernel vs plain", timed=True)[0]]
    edges = check_chi2_edges(dev)
    phase(f"chi2 edge shapes: {len(edges)} cases within {CHI2_TOL:.2e} of the plain minima, rows past n_valid "
          f"never returned, equal rows to the lowest")
    del g, q

    # 16. chi2_cost at its defaults, every kind; the eager streamed chi2 and
    # KL scans timed over CHI2_SLOW_ITERS calls
    build.reset_launch_counts()
    cost = chi2_cost.main(["--kinds", "chi2,kl", "--iters", str(CHI2_SLOW_ITERS)])
    cost += chi2_cost.main(["--kinds", "l2,chi2_pallas,chi2_pallas_bf16"])
    iters = 5  # chi2_cost's default
    check_launches("chi2_cost", launches, chi2=2 * (iters + 2))  # warm-up, iters, probe: one launch each
    by_kind = {ln["metric"].split("(")[1].split()[0]: ln for ln in cost}
    for kind, ln in by_kind.items():
        floor = 0.9 if kind == "chi2_pallas_bf16" else 1.0  # tests/test_chi2_kernel.py:49-57
        if ln["probe_agreement"] < floor:
            raise AssertionError(f"chi2_cost {kind}: probe agreement {ln['probe_agreement']} < {floor}")
    phase("chi2_cost lines (" + smi + "): " + "; ".join(
        f"{k} {ln['value']} q/s ({1e3 * ln['sec_per_batch']:.1f} ms/batch), agreement {ln['probe_agreement']}"
        for k, ln in by_kind.items()) + f"; launches {launches['chi2_cost']}")

    # 17. the brute-force harness: a feature-file round trip, then 1-NN
    # over 102,400 rows, each matcher counted on its own
    t = time.time()
    feats, labels = make_synthetic_gallery(101, 10, CHI2_D, seed=5)
    names = [f"class_{c:03d}" for c in range(101)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "features.txt")
        write_feature_file(path, feats, labels, names)
        db = load_feature_file(path, CHI2_D)
    if not (np.array_equal(db.features, normalize_features(feats)) and np.array_equal(db.labels, labels)
            and db.class_names == names):
        raise AssertionError("feature file round trip changed the rows")
    gal, glab, probes, plab = make_gallery_and_probes(BF_CLASSES, BF_PER_CLASS, 1, CHI2_D, seed=7)
    gal_s, probes_s = normalize_features(gal, l2=False), normalize_features(probes, l2=False)
    phase(f"feature file round trip ({db.num_images} rows x {CHI2_D}) exact; gallery {gal.shape} and "
          f"{probes.shape[0]} probes made in {time.time() - t:.1f} s")
    with torch.no_grad():
        qt, gt = torch.from_numpy(probes).to(dev), torch.from_numpy(gal).to(dev)
        q64, g64 = qt.double(), gt.double()
        d64 = (q64 * q64).sum(1)[:, None] + (g64 * g64).sum(1)[None, :] - 2.0 * (q64 @ g64.T)
        oracle = d64.argmin(dim=1)
        del q64, g64

    def near_tie_ok(rows):
        rows = torch.as_tensor(rows, device=dev).long()
        d_pick, d_best = d64.gather(1, rows[:, None])[:, 0], d64.gather(1, oracle[:, None])[:, 0]
        return bool(((rows == oracle) | (d_pick - d_best <= CHI2_TOL * d_best)).all())

    bf_rows = []
    cases = [("l2", gal, probes, dict()), ("l2 max_features=256", gal, probes, dict(max_features=256)),
             ("int8", gal, probes, dict(precision="int8")),
             ("chi2", gal_s, probes_s, dict(kind=DistanceKind.CHI2)),
             ("kl", gal_s, probes_s, dict(kind=DistanceKind.KL))]
    for name, g_np, p_np, kw in cases:
        m = Recording(BruteForceMatcher(g_np, device=dev, **kw))
        build.reset_launch_counts()
        res = evaluate_matcher(m, glab, p_np, plab, verbose=False)  # a warm-up batch, then one of 1024
        check_launches(f"matcher {name}", launches, **({"tilemin_quant": 2} if name == "int8" else {}))
        idx = m.last.indices
        row = dict(matcher=name, summary=res.summary(), ms_per_image=res.ms_per_image, error_pct=res.error_rate)
        if name in ("l2", "int8"):  # full-D L2: reported, and gated for "l2" below
            row["l2_fp64_argmin_agreement_pct"] = 100.0 * float(np.mean(idx == oracle.cpu().numpy()))
        if name == "l2" and not near_tie_ok(idx):
            raise AssertionError("the L2 matcher's rows are not the fp64 argmin's beyond near-ties")
        if name == "chi2":
            build.reset_launch_counts()
            dn, inn = chi2_nn(torch.from_numpy(probes_s).to(dev), torch.from_numpy(gal_s).to(dev))
            check_launches("chi2_nn (brute-force data)", launches, chi2=1)
            dn, inn = dn.cpu().numpy(), inn.cpu().numpy()
            row["chi2_nn_rows_equal_pct"] = 100.0 * float(np.mean(idx == inn))
            # equal rows: both distances are the exact formula, summed in
            # another order; other rows: a near-tie of the refined distance
            if not (np.abs(m.last.distances - dn) <= CHI2_TOL * dn).all():
                raise AssertionError("the chi2 matcher's rows differ from chi2_nn's beyond near-ties")
        bf_rows.append(row)
        agree = (f", fp64 L2 argmin agreement {row['l2_fp64_argmin_agreement_pct']:.3f}%"
                 if "l2_fp64_argmin_agreement_pct" in row else "")
        if name == "chi2":
            agree = f", rows equal to chi2_nn's {row['chi2_nn_rows_equal_pct']:.3f}%"
        phase(f"brute-force {name}: {res.summary()} ({smi}){agree}; launches {launches[f'matcher {name}']}")
        del m
    del d64, qt, gt

    s_by = {k: by_kind[k]["sec_per_batch"] * 1e3 for k in by_kind}
    kernel_row = dict(
        name="chi2", route="cuda", source="fast_image_recognition_tpu_torch/kernels/chi2.cu",
        replaces="fast_image_recognition_tpu/ops/chi2_kernel.py:55",
        launches=launches["chi2_cost"]["chi2"], launches_by_path={p: c["chi2"] for p, c in launches.items()},
        **{k: shapes[0][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        bound_detail=shapes[0]["bound_detail"],
        yardstick_streamed_topk_chi2_ms=s_by["chi2"], yardstick_streamed_topk_l2_ms=s_by["l2"],
        shapes=shapes, edges=edges,
    )
    return kernel_row, {"chi2_cost": cost, "brute_force": bf_rows}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "fast_image_recognition_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    os.chdir(repo)
    sys.path.insert(0, repo)

    import numpy as np

    from fast_image_recognition_tpu_torch.data.synthetic_device import device_dataset
    from fast_image_recognition_tpu_torch.device import default_device
    from fast_image_recognition_tpu_torch.kernels import build
    from fast_image_recognition_tpu_torch.models.efficientnet import backbone_info
    from fast_image_recognition_tpu_torch.models.fold import make_serving_fn
    from fast_image_recognition_tpu_torch.models.inference import make_infer_fn
    from fast_image_recognition_tpu_torch.kernels import plain
    from fast_image_recognition_tpu_torch.ops import distance_kernel as dk
    from fast_image_recognition_tpu_torch.ops.quant import quantize_rows
    from fast_image_recognition_tpu_torch.serving import (
        CascadeRecognitionService,
        RecognitionService,
        make_tap_embed_fn,
    )
    from fast_image_recognition_tpu_torch.utils.checkpoint import load_variables

    # 1. environment
    dev = default_device()
    # default_device() turns TF32 off: the fp32 oracle and its plain check
    # (an fp32 matmul) must contract in true fp32
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is enabled")
    smi = nvidia_smi_line()
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True, text=True, check=True)
    phase(
        f"environment: {smi} | torch {torch.__version__} (CUDA {torch.version.cuda}) | "
        f"{nvcc.stdout.strip().splitlines()[-1]}"
    )

    # 2. build every kernel of the path, one nvcc per source, in parallel
    t = time.time()
    build.build()
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)
    phase(f"built {sorted(build.SOURCES)} with nvcc in {time.time() - t:.1f} s")
    pad_pairs = check_edge_shapes(dev)
    phase(f"edge shapes {EDGE_SHAPES}: every kernel agrees with its plain version; {pad_pairs} (query, "
          f"whole-pad tile) minima bit-equal to the plain ones (BIG_DIST with fp32 scores, inf with bf16)")

    # 3. workload: trained B0@224, unseen identities rendered on the card
    t = time.time()
    variables = load_variables(CKPT)
    info = backbone_info("b0")
    serve = make_serving_fn(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]},
        info, resolution=RES, device=dev,
    )
    phase(f"loaded and folded {CKPT} in {time.time() - t:.1f} s")
    t = time.time()
    pair_imgs, _ = device_dataset(IDENTITIES, 2, RES, seed=11000, class_seed=3000, device=dev)
    # one pass gives the final embeddings and the GAP taps of the cascade
    tap_embed = make_tap_embed_fn(None, info, RES, TAPS, serving_fn=serve, device=dev)
    chunks = [tap_embed(pair_imgs[s : s + BATCH]) for s in range(0, 2 * IDENTITIES, BATCH)]
    embs = torch.cat([e for _, e in chunks])
    tap_embs = [_unit(torch.cat([f[j] for f, _ in chunks])) for j in range(len(TAPS))]
    del chunks
    enroll, probe_emb = embs[0::2].contiguous(), embs[1::2].contiguous()
    sigma = float(torch.linalg.vector_norm(enroll - probe_emb, dim=1).median()) / math.sqrt(2.0)
    images = pair_imgs[1 : 2 * BATCH : 2].contiguous()  # instance 1 of identities 0..BATCH-1
    # held-out capacity calibration: instance 1 of identities BATCH..2*BATCH-1
    calib_imgs = pair_imgs[2 * BATCH + 1 : 4 * BATCH : 2].contiguous()
    del pair_imgs
    torch.cuda.synchronize()
    phase(f"rendered and embedded {2 * IDENTITIES} images at {RES} in {time.time() - t:.1f} s, sigma {sigma:.4f}")
    t = time.time()
    gallery, labels = class_structured_gallery(GALLERY, enroll, sigma)
    # bench.py's main path passes --pca-dim 124 --pca-scan packed; the
    # service's own defaults are the JAX package's (PCA-128, f32 scores)
    svc = RecognitionService(None, info, gallery, labels=labels, n_valid=GALLERY, serving_fn=serve,
                             pca_dim=124, pca_scan="packed", device=dev)
    exact = RecognitionService(None, info, gallery, labels=labels, n_valid=GALLERY, serving_fn=serve,
                               match="exact", device=dev)
    torch.cuda.synchronize()
    phase(f"gallery {tuple(gallery.shape)} bf16, PCA-{svc.pca_dim} fit and packed in {time.time() - t:.1f} s")

    # 4. each kernel against its plain version at the main path's shapes
    report = {}
    probe_batch = svc._embed(images)
    check_cert_scan(svc, probe_batch, report)
    check_topk(gallery, GALLERY, probe_batch, 1, report)
    check_topk(gallery, GALLERY, probe_batch[:256], 16)
    check_topk(gallery, GALLERY, probe_batch, 1, report, key="topk_l2_precise", precise=True)
    torch.cuda.synchronize()
    t = time.time()
    masked_empty_ms = cuda_ms(lambda: dk.topk_l2(probe_batch, gallery, 1, n_valid=GALLERY,
                                                 row_mask=torch.zeros(BATCH, dtype=torch.bool, device=dev)), reps=10)
    phase(f"topk_l2 with an empty escalation mask (B={BATCH}, N={GALLERY}): {masked_empty_ms:.4f} ms per launch")

    # 5. the main path: warm-up and timed calls, counted on their own; then
    # one call under sync debug "error" (it raises on any host sync)
    build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    idx = svc.identify_device(images)
    masks = [svc.last_escalated]
    torch.cuda.synchronize()
    t = time.time()
    for _ in range(TIMED_CALLS):
        idx = svc.identify_device(images)
        masks.append(svc.last_escalated)
    torch.cuda.synchronize()
    sec = (time.time() - t) / TIMED_CALLS
    launches = {}
    # one exact-scan launch per call, whatever the escalation mask holds
    check_launches("pca", launches, tilemin2_packed=len(masks) * -(-BATCH // 1024), topk_l2=len(masks))
    esc_calls = sum(bool(m.any()) for m in masks)
    esc_share = svc.last_escalated.float().mean().item()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.set_sync_debug_mode("error")
    try:
        idx_sync = svc.identify_device(images)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not bool((idx_sync == idx).all()):
        raise AssertionError("the main path's answers changed under sync debug mode")

    # 6. match='exact' on the same batch, counted on its own
    build.reset_launch_counts()
    idx_exact = exact.identify_device(images)
    torch.cuda.synchronize()
    check_launches("exact", launches, topk_l2=1)
    with torch.no_grad():
        emb = svc._embed(images)
        embed_ms = host_ms(lambda: svc._embed(images), TIMED_CALLS)
        match_ms = host_ms(lambda: svc._match_emb(emb), TIMED_CALLS)
        exact_ms = host_ms(lambda: exact._match_emb(emb), TIMED_CALLS)
        fast_agree_pct = check_certified_pick(svc, emb, idx_exact)

    # the fp32 oracle of every agreement_pct of bench.py (_exact_fp32_nn),
    # one precise launch per call, counted on its own
    build.reset_launch_counts()
    with torch.no_grad():
        idx_oracle = dk.topk_l2(emb, gallery, 1, n_valid=GALLERY, precise=True)[1][:, 0]
    torch.cuda.synchronize()
    check_launches("oracle", launches, topk_l2_precise=1)
    idx, idx_exact, idx_oracle = idx.cpu().numpy(), idx_exact.cpu().numpy(), idx_oracle.cpu().numpy()
    if idx.shape != (BATCH,) or not ((idx >= 0) & (idx < GALLERY)).all():
        raise AssertionError("main path returned rows outside the gallery")
    truth = np.arange(BATCH)
    err_pct = 100.0 * float(np.mean(labels[idx] != truth))
    agree_pct = 100.0 * float(np.mean(idx == idx_exact))
    label_agree_pct = 100.0 * float(np.mean(labels[idx] == labels[idx_exact]))
    oracle_pct = 100.0 * float(np.mean(idx == idx_oracle))
    exact_oracle_pct = 100.0 * float(np.mean(idx_exact == idx_oracle))
    exact_err_pct = 100.0 * float(np.mean(labels[idx_exact] != truth))
    phase(
        f"main path: {BATCH / sec:.1f} img/s ({1e3 * sec:.1f} ms/batch of {BATCH}, {smi}), "
        f"identity error {err_pct:.3f}% (exact match {exact_err_pct:.3f}%), top-1 agreement "
        f"with match='exact' {agree_pct:.3f}% rows / {label_agree_pct:.3f}% labels, with the fp32 "
        f"oracle {oracle_pct:.3f}% rows (match='exact' {exact_oracle_pct:.3f}%), "
        f"escalated {100 * esc_share:.2f}% of probes ({esc_calls} of {len(masks)} calls); "
        f"pick before escalation agrees {fast_agree_pct:.3f}%; no host sync in identify_device; "
        f"launches {launches['pca']}"
    )
    phase(
        f"breakdown per batch of {BATCH}: embed {embed_ms:.1f} ms, pca match "
        f"{match_ms:.1f} ms (match='exact' alone {exact_ms:.1f} ms); peak device "
        f"memory {peak_gib:.2f} GiB"
    )
    if agree_pct < 99.0:
        raise AssertionError(f"top-1 agreement with match='exact' is {agree_pct:.3f}% < 99%")
    esc_rows = check_partial_escalation(svc, emb, gallery, dev)

    # 6a. the fused MBConv path (make_infer_fn(fused=True, space_to_depth=True)):
    # its kernel at each stride-1 block and at edge shapes, the
    # space-to-depth stem, then the plain line's service on the fused module
    t = time.time()
    np_vars = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    serve_f = make_infer_fn(np_vars, "b0", resolution=RES, fused=True, space_to_depth=True, device=dev)
    torch.cuda.synchronize()
    phase(f"folded the fused module (fused=True, space_to_depth=True) in {time.time() - t:.1f} s")
    mb_report = {}
    check_mbconv_blocks(serve, serve_f, images, mb_report)
    mb_report["edges"] = check_mbconv_edges(serve_f, dev)
    phase(f"mbconv edge shapes: {len(mb_report['edges'])} cases, every kernel output within {MB_TOL:.2e} of "
          f"max |plain|, border rows and columns included")
    s2d_row = check_s2d_stem(np_vars, serve, serve_f, images, dev)
    fused_row = check_fused_path(serve, serve_f, svc, info, gallery, labels, images, idx, idx_oracle, sec, launches,
                                 dev)
    del serve_f, svc, exact

    # 6b. the JAX package's default service (PCA-128, fp32-score tile scan)
    # and its other scans on the same gallery and batch, each counted alone
    modes = [
        ("default", {}, "tilemin"),
        ("pca_scan='bf16'", dict(pca_scan="bf16"), "tilemin"),
        ("pca_scan='int8'", dict(pca_scan="int8"), "tilemin_quant"),
        ("match='int8'", dict(match="int8"), "tilemin_quant"),
    ]
    tile_report = {"tilemin": [], "tilemin_quant": []}
    mode_rows = []
    for name, kw, kernel in modes:
        t = time.time()
        ms_ = RecognitionService(None, info, gallery, labels=labels, n_valid=GALLERY, serving_fn=serve,
                                 device=dev, **kw)
        torch.cuda.synchronize()
        build_s = time.time() - t
        if name == "default":
            # the tile scan kernel at this path's shapes, both score modes
            with torch.no_grad():
                qp = ((emb - ms_._mu) @ ms_._w).to(torch.bfloat16).contiguous()
            for bf in (False, True):
                check_tile_scan(f"pca{ms_.pca_dim}-{'bf16' if bf else 'f32'}-scores", qp, ms_._gal_pca, ms_._gal_sq,
                                1024, tile_report["tilemin"], bf16_scores=bf)
        build.reset_launch_counts()
        out = ms_.identify_device(images)
        torch.cuda.synchronize()
        t = time.time()
        for _ in range(TIMED_CALLS):
            out = ms_.identify_device(images)
        torch.cuda.synchronize()
        m_sec = (time.time() - t) / TIMED_CALLS
        check_launches(f"service {name}", launches, **{kernel: TIMED_CALLS + 1})
        out = out.cpu().numpy()
        if out.dtype != np.int32 or not ((out >= 0) & (out < GALLERY)).all():
            raise AssertionError(f"service {name} returned rows outside the gallery")
        row = dict(mode=name, img_s=BATCH / m_sec, ms=1e3 * m_sec,
                   error_pct=100.0 * float(np.mean(labels[out] != truth)),
                   agreement_pct=100.0 * float(np.mean(out == idx_oracle)),
                   exact_agreement_pct=100.0 * float(np.mean(out == idx_exact)))
        mode_rows.append(row)
        phase(
            f"service {name} (PCA-{getattr(ms_, 'pca_dim', '-')}, built in {build_s:.1f} s): {row['img_s']:.1f} img/s "
            f"({row['ms']:.1f} ms/batch), identity error {row['error_pct']:.3f}%, agreement with the fp32 oracle "
            f"{row['agreement_pct']:.3f}% (with match='exact' {row['exact_agreement_pct']:.3f}%); "
            f"launches {launches[f'service {name}']}"
        )
        del ms_

    # 7. the early-exit cascade (bench.py's second e2e line): per-tap
    # galleries at each tap's own intra-class spread, row-aligned with the
    # final gallery (same draw seed, same labels)
    t = time.time()
    tap_gals, tap_sigmas = [], []
    for te in tap_embs:
        s_l = float(torch.linalg.vector_norm(te[0::2] - te[1::2], dim=1).median()) / math.sqrt(2.0)
        g_l, lab_l = class_structured_gallery(GALLERY, te[0::2].contiguous(), s_l)
        if not np.array_equal(lab_l, labels):
            raise AssertionError("tap gallery labels are not row-aligned with the final gallery")
        tap_gals.append(g_l)
        tap_sigmas.append(round(s_l, 4))
    del tap_embs
    casc = CascadeRecognitionService(
        None, info, gallery, labels=labels, n_valid=GALLERY, taps=TAPS, galleries=tap_gals,
        ratio=RATIO, d2_rule="class", serving_fn=serve, device=dev,
    )
    fracs = casc.calibrate(calib_imgs, slack=SLACK)
    caps = casc.capacities_for(BATCH)
    torch.cuda.synchronize()
    phase(
        f"cascade built: taps {TAPS} (dims {[a['dim'] for a in casc._tap_assets]}, sigmas "
        f"{tap_sigmas}), tile_g {casc._tile_g}, calibrated survivor fractions "
        f"{[round(f, 4) for f in fracs]} -> capacities {caps} in {time.time() - t:.1f} s"
    )

    # 8. the single-min scan kernel against its plain version at the
    # cascade's shapes: block3a tap and final PCA at B=1024, tile_g=128
    scan_report = {}
    with torch.no_grad():
        feats0, emb0 = tap_embed(images)
        q3 = _unit(feats0[0])
        a0 = casc._tap_assets[0]
        check_single_scan("block3a", dk._augment_queries(q3, a0["dim"], 128), a0["aug"], casc._tile_g, scan_report)
        qp = (emb0 - casc._mu) @ casc._w
        check_single_scan("final-pca", dk._augment_queries(qp, casc.pca_dim, 128), casc._gal_aug,
                          casc._tile_g, scan_report)
        slice_rows = 131072
        g128 = dk.pack_gallery_aug(a0["gal"][:slice_rows], slice_rows, tile_g=128)
        check_single_scan("block3a-131072-rows", dk._augment_queries(q3, a0["dim"], 128), g128, 128, scan_report)
        del g128, feats0

    # 9. the cascade path: warm-up, one call under sync debug "error" (it
    # raises on any host sync), then the timed calls, counted on their own
    build.reset_launch_counts()
    out = casc.identify_device(images)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = casc.identify_device(images)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    t = time.time()
    for _ in range(TIMED_CALLS):
        out = casc.identify_device(images)
    torch.cuda.synchronize()
    casc_sec = (time.time() - t) / TIMED_CALLS
    check_launches("cascade", launches, tilemin_packed=(TIMED_CALLS + 2) * casc.num_levels)
    packed = out.cpu().numpy()
    idx_c, exit_level, forced = packed[:BATCH].astype(np.int64), packed[BATCH : 2 * BATCH], int(packed[-1])
    if packed.shape != (2 * BATCH + 1,) or not ((idx_c >= 0) & (idx_c < GALLERY)).all():
        raise AssertionError("the cascade returned rows outside the gallery")
    exit_fr = (np.bincount(exit_level, minlength=casc.num_levels) / BATCH).tolist()
    casc_err = 100.0 * float(np.mean(labels[idx_c] != truth))
    casc_label_agree = 100.0 * float(np.mean(labels[idx_c] == labels[idx_exact]))
    casc_oracle_agree = 100.0 * float(np.mean(labels[idx_c] == labels[idx_oracle]))
    plain_ips = BATCH / sec
    casc_ips = BATCH / casc_sec
    phase(
        f"cascade path: {casc_ips:.1f} img/s ({1e3 * casc_sec:.1f} ms/batch of {BATCH}, {smi}), "
        f"identity error {casc_err:.3f}%, label agreement with the fp32 oracle {casc_oracle_agree:.3f}% "
        f"(with match='exact' {casc_label_agree:.3f}%), exit fractions {[round(f, 4) for f in exit_fr]}, survivor "
        f"fractions {[round(f, 4) for f in fracs]}, capacities {caps}, forced fraction "
        f"{forced / BATCH:.4f}, speed-up over the plain line {casc_ips / plain_ips:.3f}x "
        f"({plain_ips:.1f} img/s); no host sync in identify_device; launches {launches['cascade']}"
    )
    per_level = cascade_breakdown(casc, images, caps, scan_report)
    phase("cascade breakdown per level: " + "; ".join(
        f"L{r['level']} B={r['batch']}: segment {r['segment_ms']:.2f} ms, match {r['match_ms']:.2f} ms, "
        f"scan kernel {r['kernel_ms']:.3f} ms (bound {r['bound_ms']:.3f} ms, {r['bound_by']})"
        for r in per_level
    ))

    # 10. the same call with the single-min scan bound to its plain version
    # here (the package has no such switch): decisions must agree except
    # at near-ties of the exit rule
    with torch.no_grad():
        trace_k, trace_p = [], []
        out_k = casc._run(images, caps, trace_k)
        kernel_keys = dk.tilemin_keys
        dk.tilemin_keys = lambda q_aug, g_aug, tile_g: plain.tilemin_packed_plain(q_aug, g_aug, tile_g)
        try:
            out_p = casc._run(images, caps, trace_p)
        finally:
            dk.tilemin_keys = kernel_keys
    tie = (near_ties(trace_k, caps, BATCH) | near_ties(trace_p, caps, BATCH)).cpu().numpy()
    ok_k, ok_p = out_k.cpu().numpy(), out_p.cpu().numpy()
    differ = (ok_k[:BATCH] != ok_p[:BATCH]) | (ok_k[BATCH:-1] != ok_p[BATCH:-1])
    early = float(np.mean(ok_k[BATCH:-1] < casc.num_levels - 1))
    phase(
        f"cascade decisions, kernel vs plain scan: {int(differ.sum())} of {BATCH} probes differ "
        f"({100 * differ.mean():.3f}%), all at near-ties: {bool((tie | ~differ).all())}; forced "
        f"{int(ok_k[-1])} vs {int(ok_p[-1])}; near-tie probes {100 * tie.mean():.3f}%; "
        f"early exits {100 * early:.3f}%"
    )
    if not (tie | ~differ).all() or differ.mean() > 0.01 or abs(int(ok_k[-1]) - int(ok_p[-1])) > differ.sum():
        raise AssertionError("cascade decisions differ from the plain scan's beyond near-ties")
    if early == 0.0:
        raise AssertionError("no probe exited before the final level")
    del casc, tap_gals

    # 11. match='pca' with escalate=None: the uncertified single-min path
    svc_none = RecognitionService(None, info, gallery, labels=labels, n_valid=GALLERY, serving_fn=serve,
                                  pca_dim=124, pca_scan="packed", escalate=None, device=dev)
    build.reset_launch_counts()
    idx_none = svc_none.identify_device(images)
    torch.cuda.synchronize()
    check_launches("pca_escalate_none", launches, tilemin_packed=1)
    idx_none = idx_none.cpu().numpy()
    phase(
        f"match='pca' escalate=None: identity error {100 * float(np.mean(labels[idx_none] != truth)):.3f}%, "
        f"row agreement with match='exact' {100 * float(np.mean(idx_none == idx_exact)):.3f}%; "
        f"launches {launches['pca_escalate_none']}"
    )
    del svc_none
    del gallery

    # 12. the match on a layout where the certificate clears, counted on its own
    t = time.time()
    probes, gal_p, planted = planted_gallery(GALLERY, BATCH, enroll.shape[1], dev)
    svc_p = RecognitionService(None, info, gal_p, n_valid=GALLERY, serving_fn=serve, pca_dim=124,
                               pca_scan="packed", device=dev)
    build.reset_launch_counts()
    with torch.no_grad():
        idx_p = svc_p._match_emb(probes)
        torch.cuda.synchronize()
        # the certified layout too runs without a host sync
        torch.cuda.set_sync_debug_mode("error")
        try:
            idx_p2 = svc_p._match_emb(probes)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check_launches("pca_planted", launches, tilemin2_packed=2, topk_l2=2)
    esc_p = svc_p.last_escalated
    if not bool((idx_p2 == idx_p).all()):
        raise AssertionError("the planted layout's answers changed under sync debug mode")
    _, ei = build.launch_topk_l2(probes.to(torch.bfloat16), gal_p, 1, GALLERY)
    ei = ei[:, 0].to(torch.int64)
    with torch.no_grad():
        fast_agree_p = check_certified_pick(svc_p, probes, ei)
    cert = ~esc_p
    cert_share = cert.float().mean().item()
    cert_agree = (idx_p[cert] == ei[cert]).float().mean().item()
    planted_pct = 100.0 * (idx_p == planted).float().mean().item()
    phase(
        f"planted layout ({GALLERY} rows in a 96-d span, PCA-{svc_p.pca_dim}): certified "
        f"{100 * cert_share:.2f}% of {BATCH} probes, certified answers equal the exact "
        f"scan's {100 * cert_agree:.3f}%, planted row found {planted_pct:.3f}%, pick "
        f"before escalation agrees {fast_agree_p:.3f}%; launches "
        f"{launches['pca_planted']} in {time.time() - t:.1f} s"
    )
    if cert_share < 0.99 or cert_agree < 1.0 or planted_pct < 100.0:
        raise AssertionError("the certified answer on the planted layout is not the exact one")
    del svc_p, gal_p, probes

    # 13. bench.py --config bf: a 1M x 1536 bf16 gallery of random unit
    # rows, queries = normalize(row i + 1e-2 noise), so the truth of query
    # i is row i
    t = time.time()
    gal_bf = random_unit_gallery(GALLERY, BF_DIM, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    q_bf = _unit(gal_bf[:BATCH].to(torch.float32) + 1e-2 * torch.randn((BATCH, BF_DIM), generator=gen, device=dev))
    torch.cuda.synchronize()
    phase(f"bf gallery {tuple(gal_bf.shape)} bf16 built in {time.time() - t:.1f} s")
    check_topk(gal_bf, GALLERY, q_bf, 1, report)
    check_topk(gal_bf, GALLERY, q_bf, 1, report, key="topk_l2_precise", precise=True)
    check_topk(gal_bf, GALLERY, q_bf, 1, report, key="topk_l2_windowed", window=BF_WINDOW)
    build.reset_launch_counts()
    idx_oracle_bf = dk.topk_l2(q_bf, gal_bf, 1, n_valid=GALLERY, precise=True)[1][:, 0].cpu().numpy()
    check_launches("oracle_bf", launches, topk_l2_precise=1)

    bf_found = {}

    def bf_line(name, run, path, **counts):
        build.reset_launch_counts()
        out = run()
        torch.cuda.synchronize()
        t = time.time()
        for _ in range(TIMED_CALLS):
            out = run()
        torch.cuda.synchronize()
        b_sec = (time.time() - t) / TIMED_CALLS
        check_launches(path, launches, **{k: v * (TIMED_CALLS + 1) for k, v in counts.items()})
        found = bf_found[path] = out[1][:, 0].cpu().numpy()
        row = dict(line=name, queries_s=BATCH / b_sec, ms=1e3 * b_sec,
                   error_pct=100.0 * float(np.mean(found != truth)),
                   agreement_pct=100.0 * float(np.mean(found == idx_oracle_bf)),
                   bf16_scan_agreement_pct=100.0 * float(np.mean(found == bf_found.get("bf", found))))
        phase(
            f"bf line, {name}: {row['queries_s']:.1f} queries/s ({row['ms']:.2f} ms per batch of {BATCH}, "
            f"{smi}), error {row['error_pct']:.3f}%, agreement with the fp32 oracle {row['agreement_pct']:.3f}% "
            f"(with the bf16 scan {row['bf16_scan_agreement_pct']:.3f}%); launches {launches[path]}"
        )
        return row

    bf_rows = [bf_line("fused brute-force (topk_l2, k=1)",
                       lambda: dk.topk_l2(q_bf, gal_bf, 1, n_valid=GALLERY), "bf", topk_l2=1)]
    # the partial-range scan of the same gallery (feature window)
    bf_rows.append(bf_line(f"feature window {list(BF_WINDOW)}",
                           lambda: dk.topk_l2(q_bf, gal_bf, 1, n_valid=GALLERY, window=BF_WINDOW),
                           "bf_windowed", topk_l2_windowed=1))

    # 14. bench.py --config bf --quant: quantize once, then the int8 scan
    # with an exact rescore of the best row of each of the 16 nearest tiles
    t = time.time()
    gal_q, scales = quantize_rows(gal_bf)
    gsq_bf = dk.gallery_sq_norms(gal_bf, GALLERY)
    gsc_bf = dk.quant_gallery_scales(scales, GALLERY)
    del scales
    torch.cuda.synchronize()
    phase(f"bf gallery quantized to int8 with norms and scales in {time.time() - t:.1f} s")
    q_i8, q_sc = quantize_rows(q_bf)
    for compute in ("int8", "bf16"):
        check_tile_scan(f"bf-quant-{compute}", q_i8, gal_q, gsq_bf, 1024, tile_report["tilemin_quant"],
                        quant=(q_sc, gsc_bf, compute))
    for compute in ("int8", "bf16"):
        bf_rows.append(bf_line(
            f"int8-scan+rescore ({compute}, r=16)",
            lambda compute=compute: dk.topk_l2_quant(q_bf, gal_q, gsq_bf, gsc_bf, gal_bf, 1, r=16, compute=compute),
            f"bf_quant_{compute}", tilemin_quant=1,
        ))
    del gal_q, gsq_bf, gsc_bf, gal_bf

    # 15-17. chi2 1-NN: its kernel, scripts/chi2_cost.py, and the exact
    # brute-force harness over feature files
    chi2_row, chi2_lines = run_chi2_slice(dev, launches, smi)

    src = "fast_image_recognition_tpu_torch/kernels/"

    def first(entries):
        return {k: entries[0][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}

    def by_path(name):
        return {p: c[name] for p, c in launches.items()}

    rows = [
        dict(name="tilemin2_packed", route="cuda", source=src + "packed_scan.cu",
             replaces="fast_image_recognition_tpu/ops/distance_kernel.py:393",
             launches=launches["pca"]["tilemin2_packed"], launches_by_path=by_path("tilemin2_packed"),
             **report["tilemin2_packed"]),
        dict(name="topk_l2", route="cuda", source=src + "topk_l2.cu",
             replaces="fast_image_recognition_tpu/ops/distance_kernel.py:92",
             launches=launches["pca"]["topk_l2"], launches_by_path=by_path("topk_l2"),
             empty_mask_ms=masked_empty_ms, **first(report["topk_l2"]), shapes=report["topk_l2"]),
        dict(name="tilemin_packed", route="cuda", source=src + "packed_scan.cu",
             replaces="fast_image_recognition_tpu/ops/distance_kernel.py:350",
             launches=launches["cascade"]["tilemin_packed"], launches_by_path=by_path("tilemin_packed"),
             **{k: scan_report["shapes"][0][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
             library_ms=None, shapes=scan_report["shapes"], per_level=scan_report["per_level"]),
        dict(name="tilemin", route="cuda", source=src + "tile_scan.cu",
             replaces="fast_image_recognition_tpu/ops/distance_kernel.py:174",
             launches=launches["service default"]["tilemin"], launches_by_path=by_path("tilemin"),
             **first(tile_report["tilemin"]), shapes=tile_report["tilemin"]),
        dict(name="tilemin_quant", route="cuda", source=src + "tile_scan.cu",
             replaces="fast_image_recognition_tpu/ops/distance_kernel.py:671",
             launches=launches["bf_quant_int8"]["tilemin_quant"], launches_by_path=by_path("tilemin_quant"),
             **first(tile_report["tilemin_quant"]), shapes=tile_report["tilemin_quant"]),
        dict(name="topk_l2_precise", route="cuda", source=src + "topk_l2.cu",
             replaces="fast_image_recognition_tpu/ops/distance_kernel.py:92 (precise=True)",
             launches=launches["oracle"]["topk_l2_precise"], launches_by_path=by_path("topk_l2_precise"),
             **first(report["topk_l2_precise"]), shapes=report["topk_l2_precise"]),
        dict(name="topk_l2_windowed", route="cuda", source=src + "topk_l2.cu",
             replaces="fast_image_recognition_tpu/ops/distance_kernel.py:92 (window)",
             launches=launches["bf_windowed"]["topk_l2_windowed"], launches_by_path=by_path("topk_l2_windowed"),
             **first(report["topk_l2_windowed"]), shapes=report["topk_l2_windowed"]),
        dict(name="mbconv", route="cuda", source=src + "mbconv.cu",
             replaces="fast_image_recognition_tpu/ops/mbconv_kernel.py:82",
             launches=launches["fused"]["mbconv"], launches_by_path=by_path("mbconv"),
             shape=f"the 12 stride-1 blocks of B0@{RES} at B={BATCH}, summed (two launches per block)",
             max_abs_err=max(r["max_abs_err"] for r in mb_report["blocks"]),
             ms=mb_report["total"]["ms"], plain_ms=mb_report["total"]["plain_ms"],
             bound_ms=mb_report["total"]["bound_ms"],
             bound_by=max(("operations", "bytes"), key=lambda by: sum(
                 r["bound_ms"] for r in mb_report["blocks"] if r["bound_by"] == by)),
             library_ms=None, yardstick_per_op_ms=mb_report["total"]["per_op_ms"],
             blocks=mb_report["blocks"], edges=mb_report["edges"]),
        chi2_row,
    ]
    print(json.dumps({"lines": {"service_modes": mode_rows, "bf": bf_rows, "partial_escalation": esc_rows,
                                "fused_path": fused_row, "s2d_stem": s2d_row, **chi2_lines}}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi_line(), flush=True)
    phase(f"done: total command time {time.time() - T0:.1f} s")
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
