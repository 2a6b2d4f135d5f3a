#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from the
checkout with ``nvcc`` (in parallel), checks in their SASS that the scans
run on ``wgmma`` and none on WMMA, holds every kernel against its plain
PyTorch version at the paths' shapes and at edge shapes, checks the host's
mirrors of the kernels' sizes against the libraries, and drives every path
of the port at full width (bench.py's e2e, bf, dem, video and cascade
configs, the services' modes, sharded serving, the matchers, classifiers
and verification), each counting its own launches; README.md lists the
phases and what each gates.

One flushed line per phase, with the seconds since start. The line before
the card's name and power limit holds the kernels' JSON; the last line is
``{"ok": true, "device": ...}``. Any failure raises and the exit code is
not 0. It needs one card and imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

T0 = time.time()
BUDGET_S = 600.0  # half the 1200 s a run may take (runs took 227-298 s)
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


def kernel_names(mangled: list) -> dict:
    """Mangled kernel symbol -> its name with template arguments
    (``cu++filt``, beside ``nvcc``), without namespace and parameters."""
    from fast_image_recognition_tpu_torch.kernels import build

    if not mangled:
        return {}
    filt = os.path.join(os.path.dirname(build._nvcc()), "cu++filt")
    out = subprocess.run([filt, *mangled], capture_output=True, text=True, check=True, timeout=60)
    names = []
    for n in out.stdout.splitlines():
        # "void <unnamed>::name<(bool)0, (int)1024>(params)" -> "name<0, 1024>"
        n, depth = n.strip(), 0
        for i in range(len(n) - 1, -1, -1):  # cut the parameter list, the last (...) group
            depth += {")": 1, "(": -1}.get(n[i], 0)
            if depth == 0:
                n = n[:i]
                break
        n = re.sub(r"^void |\(anonymous namespace\)::|<unnamed>::|\((?:bool|int)\)", "", n)
        names.append(n)
    return dict(zip(mangled, names))


def sass_mma_counts(libs: dict) -> dict:
    """Per library and kernel, its HGMMA/IGMMA (``wgmma``) and HMMA/IMMA
    (WMMA) instructions in ``cuobjdump -sass``, one process a library."""
    from fast_image_recognition_tpu_torch.kernels import build

    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    procs = {n: subprocess.Popen([cuobjdump, "-sass", path], stdout=subprocess.PIPE, text=True)
             for n, path in libs.items()}
    by_lib = {}
    for n, proc in procs.items():
        text, _ = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"cuobjdump failed on {libs[n]}")
        counts, fn = {}, None
        for line in text.splitlines():
            if "Function : " in line:
                fn = re.search(r"Function : (\S+)", line).group(1)
                counts[fn] = dict(HGMMA=0, IGMMA=0, HMMA=0, IMMA=0)
            elif fn is not None and "MMA" in line:
                m = re.search(r"\b(HGMMA|IGMMA|HMMA|IMMA)\.", line)
                if m:
                    counts[fn][m.group(1)] += 1
        by_lib[n] = counts
    names = kernel_names([k for c in by_lib.values() for k in c])
    return {n: {names[k]: v for k, v in c.items()} for n, c in by_lib.items()}


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
    """``n`` rows (padded to 1024), ~n/K contiguous rows around each of ``K``
    identity embeddings: normalize(e_c + sigma/sqrt(D) noise), drawn on
    the card (bench.py's ``_class_structured_gallery_device``). Returns
    (bf16 [n_pad, D], labels [n_pad], pad rows -1)."""
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
    """A layout where the certificate clears: ``b`` probes and ``n`` rows in
    one 96-d span (PCA-124 keeps it), a planted row (noise 0.02) and 40
    distractors (noise 0.5) per probe. Returns (probes, bf16 rows, planted
    rows), on the card."""
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
    """The pick before escalation at the least plain fp32 rescore of its
    candidates (2^-12 relative + 1e-5). Returns its agreement with exact, %."""
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
    the service's augmented PCA gallery and the batch's projected probes.
    Appends the timed shape to ``report["tilemin2_packed"]``."""
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
    report.setdefault("tilemin2_packed", []).append(dict(
        shape=f"B={b} Np={np_} Da={da}", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, yardstick_matmul_min_ms=yard_ms,
    ))


def check_topk(gallery, n_valid, queries, k, report=None, key="topk_l2", window=None, precise=False,
               row_mask=None, chunk_rows=65536):
    """topk_l2 kernel (bf16, windowed or precise) vs its plain version: the
    kernel's rows, rescored here, sit at its distances and differ from the
    plain picks only at ties within 2^-12 relative + 1e-6 (bf16) or 2^-16
    absolute (fp32 oracle); rows outside ``row_mask`` come back empty.
    Timed beside its bound, plain version and yardstick with a ``report``."""
    import torch

    from fast_image_recognition_tpu_torch.kernels import build, plain
    from fast_image_recognition_tpu_torch.ops import distance_kernel as dk

    q = queries.to(torch.float32 if precise else torch.bfloat16).contiguous()
    lo, hi = window if window is not None else (0, q.shape[1])
    if k > build.TOPK_MAX_K:  # slabs of at most TOPK_MAX_K, each a launch above the last one's floor
        def launch():
            d_, i_ = dk.topk_l2(q, gallery, k, n_valid=n_valid, window=window, precise=precise, row_mask=row_mask)
            return d_ * (hi - lo), i_
    else:
        def launch():
            return build.launch_topk_l2(q, gallery, k, n_valid, window=window, precise=precise, row_mask=row_mask)
    kd, ki = launch()
    pd, pi = plain.topk_l2_plain(q, gallery, k, n_valid, window=window, precise=precise, row_mask=row_mask,
                                 chunk_rows=chunk_rows)
    torch.cuda.synchronize()
    b, dim = q.shape
    on = torch.ones(b, dtype=torch.bool, device=q.device) if row_mask is None else row_mask
    off_ok = bool((kd[~on] == pd[~on]).all()) and bool((ki[~on] == -1).all()) and bool((pi[~on] == -1).all())
    kd, ki, pd, pi = kd[on], ki[on], pd[on], pi[on]
    err = (kd - pd).abs().max().item() if kd.numel() else 0.0
    idx_eq = (ki == pi).float().mean().item() if ki.numel() else 1.0
    in_range = bool(((ki >= 0) & (ki < n_valid)).all())
    rows = gallery[ki.clamp(0, n_valid - 1).long()][:, :, lo:hi].to(torch.float32)  # [B, k, W]
    qf = q[on][:, lo:hi].to(torch.float32)
    d_rows = torch.clamp_min(
        (qf * qf).sum(1)[:, None] + (rows * rows).sum(2) - 2.0 * torch.einsum("bd,bkd->bk", qf, rows), 0.0
    )
    del rows
    tol = torch.full_like(pd, 2.0**-16) if precise else 2.0**-12 * pd.abs() + 1e-6
    ok = off_ok and in_range and bool(((ki == pi) | ((d_rows - pd).abs() <= tol)).all())
    ok = ok and bool(((kd - d_rows).abs() <= tol).all())
    variant = ("precise" + (", fp32 rows" if gallery.dtype == torch.float32 else "") if precise
               else f"window {window}" if window else "bf16")
    masked = "" if row_mask is None else f" mask {int(on.sum())}/{b}"
    if report is None:
        if not ok:
            raise AssertionError(f"topk_l2 kernel ({variant}, B={b}, N={n_valid}, D={dim}, k={k}{masked}) "
                                 f"disagrees with its plain version")
        return
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
    nbytes = n_valid * width * gallery.element_size() + b * width * q.element_size() + b * k * 8
    # precise: bf16 products of split terms on the tensor cores, three per
    # row element over bf16 rows, six over fp32 rows
    passes = (6.0 if gallery.dtype == torch.float32 else 3.0) if precise else 1.0
    b_ms, b_by = bound(passes * 2.0 * b * n_valid * width, nbytes)
    # the fp32 CUDA-core bound of the FFMA design it replaced: phase text only, not in the JSON line
    ffma_ms = bound(2.0 * b * n_valid * width, nbytes, PEAK_FP32_FLOPS)[0] if precise else None
    shape = f"B={b} N={n_valid} D={dim} k={k}" + (f" window={list(window)}" if window else "")
    if gallery.dtype == torch.float32:
        shape += " rows=fp32"  # the six-product pass (topk_pass1_split6_sm90)
    phase(
        f"topk_l2 ({variant}) B={b} N={n_valid} D={dim} k={k}: indices equal {100 * idx_eq:.3f}%, "
        f"max |d| gap {err:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"matmul+{'min' if window else 'topk'} yardstick {yard_ms:.3f} ms, "
        f"bound {b_ms:.3f} ms ({b_by})" + (f", FFMA bound {ffma_ms:.3f} ms" if precise else "")
    )
    if not ok:
        raise AssertionError(f"topk_l2 kernel ({variant}, k={k}) disagrees with its plain version")
    report.setdefault(key, []).append(dict(
        shape=shape, max_abs_err=err, indices_equal=idx_eq, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, **{f"yardstick_matmul_{'min' if window else 'topk'}_ms": yard_ms},
    ))


def check_tile_scan(name, q, g, gsq, tile_g, report, *, bf16_scores=False, quant=None, verbose=True):
    """bf16 (``quant=None``) or int8 (``quant=(qs, gsc, compute)``) tile scan
    kernel vs its plain version: minima within 2^-16 (fp32 scores), 2^-6
    (bf16 scores) or 2^-12 of the cross term (int8 data, bf16 products);
    its rows, rescored here, at its minima and different from the plain
    rows only at such ties (a row past n_valid is not rescored).
    ``report=None`` checks untimed. Returns (kernel minima, kernel rows,
    plain minima)."""
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
        if verbose:
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
    """The tile scans and the top-k variants vs their plain versions at
    :data:`EDGE_SHAPES`, untimed, tile_g 128-1024: whole-pad tiles' minima
    bit-equal to the plain ones (BIG_DIST, or inf with bf16 scores).
    Returns the number of such (query, tile) pairs."""
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
        check_topk(dk.pad_cols(g32, 8), nv, q8, 16, precise=True)  # fp32 rows: the six-product pass
        g8 = dk.pad_cols(g32.to(torch.bfloat16), 8)
        check_topk(g8, nv, q8, 3, window=(5, d - 3), precise=True)
        check_topk(g8, nv, q8, 5, window=(1, d - 1))
        check_topk(g8, nv, q8, 16)
    return pad_pairs


# the sm90 main loop's scans at the edges of their tiles: 128-query tiles,
# 256/128-row sub-tiles with n_valid inside one (rows past it hold copies
# of the queries), 64-lane and 128-byte chunks, windows on and off the
# 8-lane boundary, tile_g 128-1024, whole-pad tiles
SCAN_EDGE_B = (1, 127, 128, 129, 257)
TOPK_EDGES = [(600, 100, 8), (5000, 4321, 40), (3000, 2900, 1280)]  # (rows, n_valid, D)
TOPK_EDGE_K = (1, 2, 3, 16)
ROW_MASKS = ("empty", "first", "last", 64, 65, 128, 129)  # a prefix of that many queries
TOPK_LARGE_K = (17, 64, 256)  # k > 16: lists in the pass-1 scratch
TOPK_LARGE_K_EDGES = [(5000, 4321, 40), (3000, 2900, 1280), (20000, 17000, 40)]  # (rows, n_valid, D); 3 segments
TOPK_LARGE_K_B = (1, 129, 257)
TOPK_SLAB_K = (257, 600)  # past one launch's 256 columns: slabs above a floor
# Da above 640: the packed scans stream their queries through the ring
WIDE_PACKED = [(2100, 2000, 700, 768), (3600, 1800, 800, 832), (2100, 1000, 1500, 1536)]  # (rows, n_valid, d, Da)
MIN2_EDGES = [(3600, 1800, 40, 48), (2100, 2100, 124, 128)] + WIDE_PACKED
SINGLE_EDGES = [(3600, 1800, 40, 48), (2100, 1000, 124, 128)] + WIDE_PACKED
SINGLE_EDGE_B = SCAN_EDGE_B + (192, 320)  # + the cascade's survivor batches off the 128 grid
QUANT_EDGES = [(5000, 2100, 16), (2900, 1300, 144), (5000, 2100, 1536)]  # (rows, n_valid, D)
# the bf16 tile scan (resident queries up to D = 640, streamed above) and
# the int8 scan with bf16 compute (256-query tiles)
TILE_EDGES = [(3000, 2900, 16), (5000, 4321, 40), (2100, 1000, 128), (3000, 2050, 200), (2600, 1300, 1536)]
TILE_EDGE_B = (1, 64, 130)
QUANT_BF16_EDGES = [(5000, 2100, 16), (2900, 1300, 144), (2600, 1300, 1536)]  # (rows, n_valid, D)
QUANT_BF16_EDGE_B = (1, 64, 130, 257)


def check_min2(qa, ga, n_valid):
    """Min-2 packed scan kernel vs plain, untimed: distances within 2^-12
    relative + 1e-6, rows rescored at their keys' distances and equal to
    the plain rows but at near-ties, whole-pad tiles never winning."""
    import torch

    from fast_image_recognition_tpu_torch.kernels import build, plain
    from fast_image_recognition_tpu_torch.ops import distance_kernel as dk

    k1, k2 = build.launch_tilemin2_packed(qa, ga)
    p1, p2 = plain.tilemin2_packed_plain(qa, ga)
    torch.cuda.synchronize()
    qf = qa.to(torch.float32)
    ok = True
    for keys, ref in ((k1, p1), (k2, p2)):
        kd, pd = dk._key_to_dist(keys), dk._key_to_dist(ref)
        d_rows = [torch.clamp_min(torch.einsum("bd,btd->bt", qf, ga[dk._key_to_row(kk).long()].to(torch.float32)), 0.0)
                  for kk in (keys, ref)]
        tol = 2.0**-12 * pd.abs() + 1e-6
        ok = ok and bool(((kd - pd).abs() <= tol).all())
        ok = ok and bool(((d_rows[0] - kd).abs() <= tol).all()) and bool(((d_rows[0] - d_rows[1]).abs() <= tol).all())
    rows = dk._key_to_row(k1)
    whole_pad = torch.arange(k1.shape[1], device=k1.device) * 1024 >= n_valid
    ok = ok and bool((rows[:, ~whole_pad] < n_valid).all()) and bool((k1 != k2).all())
    ok = ok and bool((dk._key_to_dist(k1)[:, whole_pad] >= 1e37).all())
    if not ok:
        raise AssertionError(f"min-2 packed scan kernel disagrees with its plain version (B={qa.shape[0]}, "
                             f"Np={ga.shape[0]}, n_valid={n_valid}, Da={qa.shape[1]})")


def check_single(qa, ga, n_valid, tile_g):
    """Single-min packed scan kernel vs plain, untimed: keys equal, or at a
    near-tie within 2^-12 relative + 1e-6 with rows rescored at their
    keys' distances; whole-pad tiles only pad distances."""
    import torch

    from fast_image_recognition_tpu_torch.kernels import build, plain
    from fast_image_recognition_tpu_torch.ops import distance_kernel as dk

    keys = build.launch_tilemin_packed(qa, ga, tile_g)
    ref = plain.tilemin_packed_plain(qa, ga, tile_g)
    torch.cuda.synchronize()
    kd, pd = dk._key_to_dist(keys, tile_g), dk._key_to_dist(ref, tile_g)
    rows = dk._key_to_row(keys, tile_g)
    d_rows = [torch.clamp_min(torch.einsum("bd,btd->bt", qa.to(torch.float32), ga[r.long()].to(torch.float32)), 0.0)
              for r in (rows, dk._key_to_row(ref, tile_g))]
    tol = 2.0**-12 * pd.abs() + 1e-6
    near = ((kd - pd).abs() <= tol) & ((d_rows[0] - kd).abs() <= tol) & ((d_rows[0] - d_rows[1]).abs() <= tol)
    whole_pad = torch.arange(keys.shape[1], device=keys.device) * tile_g >= n_valid
    ok = bool(((keys == ref) | near).all()) and bool((rows[:, ~whole_pad] < n_valid).all())
    ok = ok and bool((kd[:, whole_pad] >= 1e37).all())
    if not ok:
        raise AssertionError(f"single-min packed scan kernel disagrees with its plain version (B={qa.shape[0]}, "
                             f"Np={ga.shape[0]}, n_valid={n_valid}, Da={qa.shape[1]}, tile_g={tile_g})")


def check_quant_edge(q, qs, g, gsq, gsc, n_valid, tile_g):
    """int8 tile scan kernel (int8 compute) vs its plain version, untimed:
    the exact int32 dot and the same four roundings give equal minima and
    rows; a whole-pad tile (every row >= n_valid) returns 3.4e38 at its
    first row."""
    import torch

    from fast_image_recognition_tpu_torch.kernels import build, plain

    kd, ki = build.launch_tilemin_quant(q, qs, g, gsq, gsc, tile_g, "int8")
    pd, pi = plain.tilemin_quant_plain(q, qs, g, gsq, gsc, tile_g, "int8")
    torch.cuda.synchronize()
    n_tiles = kd.shape[1]
    whole_pad = torch.arange(n_tiles, device=kd.device) * tile_g >= n_valid
    first = (torch.arange(n_tiles, device=kd.device, dtype=torch.int32) * tile_g)[None, whole_pad]
    big = torch.tensor(3.4e38, dtype=torch.float32).item()
    ok = bool((kd == pd).all()) and bool((ki == pi).all())
    ok = ok and bool((kd[:, whole_pad] == big).all()) and bool((ki[:, whole_pad] == first).all())
    if not ok:
        raise AssertionError(f"int8 tile scan kernel disagrees with its plain version (B={q.shape[0]}, "
                             f"Np={g.shape[0]}, n_valid={n_valid}, D={q.shape[1]}, tile_g={tile_g})")


def check_sm90_edges(dev):
    """The four ``sm90_scan.cuh`` kernels vs their plain versions at the
    ``*_EDGES`` shapes and batches, windows and row masks, untimed.
    Returns the number of cases of each kernel."""
    import torch

    from fast_image_recognition_tpu_torch.ops import distance_kernel as dk
    from fast_image_recognition_tpu_torch.ops.quant import quantize_rows

    from fast_image_recognition_tpu_torch.kernels import plain

    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    cases = dict(topk_l2=0, topk_l2_precise_split=0, topk_l2_precise_split6=0, topk_l2_large_k=0, tilemin2_packed=0,
                 tilemin_packed=0, tilemin_quant=0, tilemin=0, tilemin_quant_bf16=0)
    for n, nv, d in TOPK_EDGES:
        g32 = _unit(torch.randn((n, d), generator=gen, device=dev))
        q32 = _unit(g32[: max(SCAN_EDGE_B)] + 0.1 * torch.randn((max(SCAN_EDGE_B), d), generator=gen, device=dev))
        g32[nv : nv + max(SCAN_EDGE_B)] = q32[: n - nv]  # rows past n_valid that would win
        g16 = g32.to(torch.bfloat16)
        windows = [None, (1, d - 1)] + ([(5, d - 3)] if d > 8 else []) + ([(64, 192)] if d >= 192 else [])
        for b in SCAN_EDGE_B:
            for k in TOPK_EDGE_K:
                for w in windows:
                    check_topk(g16, nv, q32[:b], k, window=w)
                    cases["topk_l2"] += 1
                for w in windows[:2]:  # the split precise passes over the same rows in bf16 and in fp32
                    check_topk(g16, nv, q32[:b], k, window=w, precise=True)
                    check_topk(g32, nv, q32[:b], k, window=w, precise=True)
                    cases["topk_l2_precise_split"] += 1
                    cases["topk_l2_precise_split6"] += 1
        b = max(SCAN_EDGE_B)
        for m in ROW_MASKS:
            mask = torch.zeros(b, dtype=torch.bool, device=dev)
            if m == "first":
                mask[0] = True
            elif m == "last":
                mask[-1] = True
            elif m != "empty":
                mask[:m] = True
            for k in (1, 3):
                check_topk(g16, nv, q32[:b], k, row_mask=mask)
                cases["topk_l2"] += 1
    bmax = max(TOPK_LARGE_K_B)
    for n, nv, d in TOPK_LARGE_K_EDGES:
        g32 = _unit(torch.randn((n, d), generator=gen, device=dev))
        q32 = _unit(g32[:bmax] + 0.1 * torch.randn((bmax, d), generator=gen, device=dev))
        g32[nv : nv + bmax] = q32[: n - nv]  # rows past n_valid that would win
        g16 = g32.to(torch.bfloat16)
        for b in TOPK_LARGE_K_B:
            for k in TOPK_LARGE_K:
                check_topk(g16, nv, q32[:b], k)
                check_topk(g32, nv, q32[:b], k, precise=True)
                check_topk(g32, nv, q32[:b], k, window=(5, d - 3), precise=True)
                check_topk(g16, nv, q32[:b], k, window=(5, d - 3))
                check_topk(g16, nv, q32[:b], k, window=(1, d - 1), precise=True)
                check_topk(g16, nv, q32[:b], k, precise=True)
                cases["topk_l2_large_k"] += 6
        mask = torch.zeros(bmax, dtype=torch.bool, device=dev)
        mask[:129] = True
        check_topk(g16, nv, q32, 64, row_mask=mask)
        cases["topk_l2_large_k"] += 1
    for n, nv, d, da in MIN2_EDGES:
        g16 = _unit(torch.randn((n, d), generator=gen, device=dev)).to(torch.bfloat16)
        ga = dk.pack_gallery_aug(g16, nv)[:, :da].contiguous()  # pad rows keep their data, |g|^2 = 1e38
        for b in SCAN_EDGE_B:
            q = _unit(g16[:b].to(torch.float32) + 0.1 * torch.randn((b, d), generator=gen, device=dev))
            check_min2(dk._augment_queries(q, d, da), ga, nv)
            cases["tilemin2_packed"] += 1
    bmax = max(SINGLE_EDGE_B)
    for n, nv, d, da in SINGLE_EDGES:
        g32 = _unit(torch.randn((n, d), generator=gen, device=dev))
        q32 = _unit(g32[:bmax] + 0.1 * torch.randn((bmax, d), generator=gen, device=dev))
        g32[nv : nv + bmax] = q32[: n - nv]  # rows past n_valid that would win
        g16 = g32.to(torch.bfloat16)
        for tg in (128, 256, 512, 1024):
            ga = dk.pack_gallery_aug(g16, nv, tg)[:, :da].contiguous()  # pad rows keep their data, |g|^2 = 1e38
            for b in SINGLE_EDGE_B:
                check_single(dk._augment_queries(q32[:b], d, da), ga, nv, tg)
                cases["tilemin_packed"] += 1
    bmax = max(SCAN_EDGE_B)
    for n, nv, d in QUANT_EDGES:
        g32 = _unit(torch.randn((n, d), generator=gen, device=dev))
        q32 = _unit(g32[:bmax] + 0.1 * torch.randn((bmax, d), generator=gen, device=dev))
        g32[nv : nv + bmax] = q32  # rows past n_valid that would win
        g16 = g32.to(torch.bfloat16)
        for tg in (128, 1024):
            gq, gs = quantize_rows(dk.pad_gallery(g16, tg))
            gsq = dk.gallery_sq_norms(g16, nv, tg).reshape(-1)
            gsc = dk.quant_gallery_scales(gs, nv, tg).reshape(-1)
            for b in SCAN_EDGE_B:
                qq, qs = quantize_rows(q32[:b])
                check_quant_edge(qq, qs, gq, gsq, gsc, nv, tg)
                cases["tilemin_quant"] += 1
    big = torch.tensor(plain.BIG_DIST, dtype=torch.float32).item()

    def whole_pad_ok(kd, ki, pd, nv, tg, pad_value):
        """(query, whole-pad tile) minima bit-equal to the plain ones and
        to ``pad_value``, at the tile's first row"""
        whole_pad = torch.arange(kd.shape[1], device=dev) * tg >= nv
        first = (torch.arange(kd.shape[1], device=dev, dtype=torch.int32) * tg)[None, whole_pad]
        return (bool((kd[:, whole_pad] == pd[:, whole_pad]).all()) and bool((kd[:, whole_pad] == pad_value).all())
                and bool((ki[:, whole_pad] == first).all()))

    bmax = max(TILE_EDGE_B)
    for n, nv, d in TILE_EDGES:
        g32 = _unit(torch.randn((n, d), generator=gen, device=dev))
        q32 = _unit(g32[:bmax] + 0.1 * torch.randn((bmax, d), generator=gen, device=dev))
        g32[nv : nv + bmax] = q32[: n - nv]  # rows past n_valid that would win
        g16 = g32.to(torch.bfloat16)
        for tg in (128, 256, 512, 1024):
            gp = dk.pad_gallery(g16, tg)
            gsq = dk.gallery_sq_norms(gp, nv, tg)
            for b in TILE_EDGE_B:
                for bf in (False, True):
                    name = f"edge N={n} n_valid={nv} D={d} B={b} {'bf16' if bf else 'f32'}-scores"
                    kd, ki, pd = check_tile_scan(name, q32[:b].to(torch.bfloat16).contiguous(), gp, gsq, tg, None,
                                                 bf16_scores=bf, verbose=False)
                    if not whole_pad_ok(kd, ki, pd, nv, tg, float("inf") if bf else big):
                        raise AssertionError(f"whole-pad tiles disagree ({name}, tile_g={tg})")
                    cases["tilemin"] += 1
    bmax = max(QUANT_BF16_EDGE_B)
    for n, nv, d in QUANT_BF16_EDGES:
        g32 = _unit(torch.randn((n, d), generator=gen, device=dev))
        q32 = _unit(g32[:bmax] + 0.1 * torch.randn((bmax, d), generator=gen, device=dev))
        g32[nv : nv + bmax] = q32[: n - nv]  # rows past n_valid that would win
        g16 = g32.to(torch.bfloat16)
        for tg in (128, 1024):
            gq, gs = quantize_rows(dk.pad_gallery(g16, tg))
            gsq = dk.gallery_sq_norms(g16, nv, tg).reshape(-1)
            gsc = dk.quant_gallery_scales(gs, nv, tg).reshape(-1)
            for b in QUANT_BF16_EDGE_B:
                qq, qs = quantize_rows(q32[:b])
                name = f"edge N={n} n_valid={nv} D={d} B={b} int8-scan-bf16"
                kd, ki, pd = check_tile_scan(name, qq, gq, gsq, tg, None, quant=(qs, gsc, "bf16"), verbose=False)
                if not whole_pad_ok(kd, ki, pd, nv, tg, big):
                    raise AssertionError(f"whole-pad tiles disagree ({name}, tile_g={tg})")
                cases["tilemin_quant_bf16"] += 1
    return cases


def check_topk_slabs(dev):
    """``topk_l2`` at k of :data:`TOPK_SLAB_K` (slabs of list-kernel launches
    above the previous slab's last entry) vs the plain version in one
    pass, untimed: 300 x 100,000 rows (99,000 valid), D = 128; bf16,
    precise over bf16 and fp32 rows, a window, a row mask. Returns the
    number of cases."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(37)
    n, nv, d, b = 100_000, 99_000, 128, 300
    g32 = _unit(torch.randn((n, d), generator=gen, device=dev))
    q32 = _unit(g32[:b] + 0.1 * torch.randn((b, d), generator=gen, device=dev))
    g32[nv : nv + b] = q32[: n - nv]
    g16 = g32.to(torch.bfloat16)
    mask = torch.zeros(b, dtype=torch.bool, device=dev)
    mask[:129] = True
    cases = 0
    for k in TOPK_SLAB_K:
        check_topk(g16, nv, q32, k)
        check_topk(g16, nv, q32, k, precise=True)
        check_topk(g16, nv, q32, k, window=(5, d - 3))
        check_topk(g16, nv, q32, k, row_mask=mask)
        check_topk(g32, nv, q32, k, precise=True)
        cases += 5
    return cases


# |kernel - fp64| distance at the split probe's matches: the fp32 sums
# there are ~1e-6 off (the plain pass's 1,280-term matmul 1.3e-6 on the
# CPU); a pass without the lo term is ~7.3e-6 off, so the probe also asks
# that the two-term product miss by more than 1.5x this
SPLIT_PROBE_TOL = 2.0**-18


def check_split_precise(dev):
    """The split precise pass over bf16 rows beyond the 2^-16 gate: its
    query planes equal ``plain.split_bf16x3`` (a lo-zeroed control must
    differ); on queries = rows x (1 + 2^-9 + 2^-18) its distance lies within
    :data:`SPLIT_PROBE_TOL` of fp64, the hi + mid product's not within
    1.5x that. Returns the worst (kernel error, two-term error)."""
    import torch

    from fast_image_recognition_tpu_torch.kernels import build, plain

    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    n, d = 4096, 1280
    g = _unit(torch.randn((n, d), generator=gen, device=dev)).to(torch.bfloat16)
    worst = [0.0, float("inf")]
    for b, window in ((130, None), (257, (5, d - 3))):
        lo, hi = window if window is not None else (0, d)
        q = (g[:b].float() * (1.0 + 2.0**-9 + 2.0**-18)).contiguous()
        out = {}
        kd, ki = build.launch_topk_l2(q, g, 1, n, window=window, precise=True, split_out=out)
        torch.cuda.synchronize()
        qw = torch.zeros_like(q)
        qw[:, lo:hi] = q[:, lo:hi]
        want = torch.zeros_like(out["planes"])
        for p_, t in enumerate(plain.split_bf16x3(qw)):
            want[p_, :b] = t
        planes_eq = torch.equal(out["planes"].view(torch.int16), want.view(torch.int16))
        ctrl = out["planes"].clone()
        ctrl[2] = 0
        ctrl_eq = torch.equal(ctrl.view(torch.int16), want.view(torch.int16))
        qsq64 = (qw.double() ** 2).sum(1)
        qsq_err = ((out["qsq"].double() - qsq64).abs() / qsq64).max().item()
        gd = g[:b, lo:hi].double()
        exact = ((q[:, lo:hi].double() - gd) ** 2).sum(1)
        two = (want[0, :b, lo:hi].double() + want[1, :b, lo:hi].double())
        d_two = qsq64 + (gd * gd).sum(1) - 2.0 * (two * gd).sum(1)
        rows_ok = bool((ki[:, 0] == torch.arange(b, device=dev)).all())
        err_k = (kd[:, 0].double() - exact).abs().max().item()
        err_two = (d_two - exact).abs().min().item()
        print(f"  split precise B={b} window {window}: planes bit-equal {planes_eq} (lo zeroed: {ctrl_eq}), "
              f"|q|^2 rel err {qsq_err:.2e}, own rows {rows_ok}, max |kernel - fp64| {err_k:.3e}, "
              f"min |hi+mid - fp64| {err_two:.3e} (tolerance {SPLIT_PROBE_TOL:.3e})", flush=True)
        if not (planes_eq and not ctrl_eq and qsq_err <= 2.0**-20 and rows_ok):
            raise AssertionError(f"split_queries' planes or |q|^2 disagree with plain.split_bf16x3 (B={b})")
        if err_k > SPLIT_PROBE_TOL or err_two <= 1.5 * SPLIT_PROBE_TOL:
            raise AssertionError(f"the split precise pass does not compute the three-term product (B={b}): "
                                 f"{err_k:.3e} from fp64, the two-term product {err_two:.3e}")
        worst = [max(worst[0], err_k), min(worst[1], err_two)]
    return worst


def check_split6_precise(dev):
    """The six-product pass over fp32 rows beyond the 2^-16 gate: on rows =
    a bf16 row x (1 + 2^-9 + 2^-18), queries half a row, its distance lies
    within :data:`SPLIT_PROBE_TOL` of fp64, the bf16-row pass's three
    products' not within 1.5x that; query planes equal ``split_bf16x3``.
    Returns the worst (kernel error, three-product error)."""
    import torch

    from fast_image_recognition_tpu_torch.kernels import build, plain

    gen = torch.Generator(device=dev)
    gen.manual_seed(43)
    n, d = 4096, 1280
    h = _unit(torch.randn((n, d), generator=gen, device=dev)).to(torch.bfloat16).float()
    g = (h * (1.0 + 2.0**-9 + 2.0**-18)).contiguous()
    worst = [0.0, float("inf")]
    for b in (130, 257):
        for window in (None, (5, d - 3)):
            lo, hi = window if window is not None else (0, d)
            q = (0.5 * g[:b]).contiguous()
            out = {}
            kd, ki = build.launch_topk_l2(q, g, 1, n, window=window, precise=True, split_out=out)
            torch.cuda.synchronize()
            qw = torch.zeros_like(q)
            qw[:, lo:hi] = q[:, lo:hi]
            planes_eq = all(torch.equal(out["planes"][p_, :b].view(torch.int16), t.view(torch.int16))
                            for p_, t in enumerate(plain.split_bf16x3(qw)))
            qt = [t[:, lo:hi].double() for t in plain.split_bf16x3(q)]
            gt = [t[:b, lo:hi].double() for t in plain.split_bf16x3(g)]
            qd, gd = q[:, lo:hi].double(), g[:b, lo:hi].double()
            exact = ((qd - gd) ** 2).sum(1)
            cross3 = sum((qt[a] * gt[c]).sum(1) for a, c in ((0, 1), (1, 0), (0, 0)))
            d_three = (qd * qd).sum(1) + (gd * gd).sum(1) - 2.0 * cross3
            rows_ok = bool((ki[:, 0] == torch.arange(b, device=dev)).all())
            err_k = (kd[:, 0].double() - exact).abs().max().item()
            err_three = (d_three - exact).abs().min().item()
            print(f"  six-product pass B={b} window {window}: query planes bit-equal {planes_eq}, own rows {rows_ok}, "
                  f"max |kernel - fp64| {err_k:.3e}, min |three products - fp64| {err_three:.3e} (tolerance "
                  f"{SPLIT_PROBE_TOL:.3e})", flush=True)
            if not (planes_eq and rows_ok):
                raise AssertionError(f"the six-product pass's query planes or rows disagree (B={b}, window {window})")
            if err_k > SPLIT_PROBE_TOL or err_three <= 1.5 * SPLIT_PROBE_TOL:
                raise AssertionError(f"the six-product pass does not compute the six products (B={b}, window "
                                     f"{window}): {err_k:.3e} from fp64, the three products {err_three:.3e}")
            worst = [max(worst[0], err_k), min(worst[1], err_three)]
    return worst


def full_significand_rows(g, seed: int):
    """fp32 unit rows normalize(g + 2^-8 noise) near the bf16 rows ``g``,
    full 24-bit significands (the six-product pass's mid and lo row terms
    are not zero)."""
    import torch

    gen = torch.Generator(device=g.device)
    gen.manual_seed(seed)
    out = torch.empty(g.shape, dtype=torch.float32, device=g.device)
    for s in range(0, g.shape[0], 65536):
        rows = g[s : s + 65536].float()
        out[s : s + rows.shape[0]] = _unit(rows + 2.0**-8 * torch.randn(rows.shape, generator=gen, device=g.device))
    return out


def check_big_grids(dev):
    """Galleries past the 65,535-block caps vs the plain versions, untimed:
    the bf16 tile scan (8.4M rows, tile_g 128), the int8 scan (134M rows),
    ``topk_l2`` (537M rows; bf16 k = 1 and 17, precise over bf16 and fp32
    rows). Returns a description of each."""
    import torch

    from fast_image_recognition_tpu_torch.ops import distance_kernel as dk

    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    b = 130  # two 128-query tiles
    done = []
    n_tiles = 65_600
    g = _unit(torch.randn((n_tiles * 128, 16), generator=gen, device=dev)).to(torch.bfloat16)
    q = _unit(torch.randn((b, 16), generator=gen, device=dev)).to(torch.bfloat16)
    nv = n_tiles * 128 - 200  # the last tile holds only rows past n_valid
    check_tile_scan(f"big-grid {n_tiles} tiles", q, g, dk.gallery_sq_norms(g, nv, 128), 128, None)
    done.append(f"tilemin {n_tiles} tiles of 128 x 16")
    del g
    n_tiles = 131_073  # 65,537 segments of 2,048 rows at tile_g 1024
    n = n_tiles * 1024
    g8 = torch.randint(-127, 128, (n, 16), generator=gen, device=dev, dtype=torch.int8)
    gsq = torch.rand((n,), generator=gen, device=dev) + 0.5
    gsc = torch.rand((n,), generator=gen, device=dev) * 0.01 + 1e-3
    q8 = torch.randint(-127, 128, (b, 16), generator=gen, device=dev, dtype=torch.int8)
    qs = torch.rand((b,), generator=gen, device=dev) * 0.01 + 1e-3
    check_quant_edge(q8, qs, g8, gsq, gsc, n, 1024)
    check_tile_scan(f"big-grid {n_tiles} tiles int8-scan-bf16", q8, g8, gsq, 1024, None, quant=(qs, gsc, "bf16"))
    done.append(f"tilemin_quant int8 and bf16 over {n} x 16 ({-(-n // 2048)} segments)")
    del g8, gsq, gsc
    # 65,537 segments of 8,192 rows (precise and k > 16), 8.6 GB of bf16
    # rows; the bf16 register-list pass sees 262,148 segments of 2,048
    n = 65_537 * 8192
    g = torch.empty((n, 8), dtype=torch.bfloat16, device=dev)
    for r0 in range(0, n, 1 << 26):
        r1 = min(n, r0 + (1 << 26))
        g[r0:r1] = _unit(torch.randn((r1 - r0, 8), generator=gen, device=dev)).to(torch.bfloat16)
    q = _unit(torch.randn((65, 8), generator=gen, device=dev))  # two query blocks of 64
    chunk = 1 << 23  # the plain version's rows a step (default 65,536)
    check_topk(g, n, q, 1, chunk_rows=chunk)
    check_topk(g, n, q, 1, precise=True, chunk_rows=chunk)
    check_topk(g, n, q, 17, chunk_rows=chunk)
    del g
    g32 = torch.empty((n, 8), dtype=torch.float32, device=dev)  # 17.2 GB, full significands
    for r0 in range(0, n, 1 << 26):
        r1 = min(n, r0 + (1 << 26))
        g32[r0:r1] = _unit(torch.randn((r1 - r0, 8), generator=gen, device=dev))
    check_topk(g32, n, q, 1, precise=True, chunk_rows=chunk)
    done.append(f"topk_l2 over {n} x 8 (bf16 k=1: {n // 2048} segments; precise k=1 over bf16 rows (the split "
                f"pass) and over fp32 rows (the six-product pass), bf16 k=17: {n // 8192} segments)")
    del g32
    torch.cuda.empty_cache()
    return done


def check_packed_service(info, gallery, labels, emb, images, serve, dev, launches, report):
    """The PCA-700 packed service (Da = 768: both packed scans stream their
    queries) over 131,072 rows of the main gallery: its min-2 scan vs the
    plain version (:func:`check_cert_scan`), its pick before escalation
    (:func:`check_certified_pick`), its answers equal to ``match='exact'``
    on the slice but at ties within 2^-12 relative + 1e-6."""
    import numpy as np
    import torch

    from fast_image_recognition_tpu_torch.kernels import build
    from fast_image_recognition_tpu_torch.serving import RecognitionService

    n = 131_072
    t = time.time()
    kw = dict(labels=labels[:n], n_valid=n, serving_fn=serve, device=dev)
    svc = RecognitionService(None, info, gallery[:n], pca_dim=700, pca_scan="packed", **kw)
    exact = RecognitionService(None, info, gallery[:n], match="exact", **kw)
    da = svc.gal_aug.shape[1]
    if da != 768:
        raise AssertionError(f"the PCA-700 packed service has Da = {da}, not 768")
    build.reset_launch_counts()
    idx = svc.identify_device(images)
    torch.cuda.synchronize()
    check_launches("pca700", launches, tilemin2_packed=1, topk_l2=1)
    esc = svc.last_escalated.float().mean().item()
    with torch.no_grad():
        idx_e = exact._match_emb(emb)
        e16 = emb.to(torch.bfloat16).to(torch.float32)
        d = [((e16 - gallery[i.long()].to(torch.float32)) ** 2).sum(-1) for i in (idx, idx_e)]
        check_cert_scan(svc, emb, report)
        fast_agree = check_certified_pick(svc, emb, idx_e)
    differ = idx != idx_e
    tie = (d[0] - d[1]).abs() <= 2.0**-12 * d[1] + 1e-6
    phase(
        f"service pca_scan='packed' pca_dim=700 (Da={da}) over {n} rows, built in {time.time() - t:.1f} s: rows "
        f"equal to match='exact' {100 * (1 - differ.float().mean().item()):.3f}%, the rest near-ties: "
        f"{bool((tie | ~differ).all())}; escalated {100 * esc:.2f}%; pick before escalation at the least rescored "
        f"distance of its candidates, equal to match='exact' {fast_agree:.3f}%; identity error "
        f"{100 * float(np.mean(labels[idx.cpu().numpy()] != np.arange(len(idx)))):.3f}%; launches {launches['pca700']}"
    )
    if not bool((tie | ~differ).all()):
        raise AssertionError("the PCA-700 packed service disagrees with match='exact' beyond near-ties")


def check_single_scan(name, qa, ga, tile_g, report):
    """Single-min packed scan kernel vs plain on a path's tensors: keys equal
    or decoded within 2^-12 relative, rows rescored at their keys'
    distances, differing from the plain rows only at near-ties."""
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
    """The exact scan at ~``share`` escalation, three ways on one mask: the
    escalated probes moved to the front (the service), left in place, and
    gathered behind a host sync; the same rows from all three. Returns
    the timings (host clock between syncs)."""
    import torch

    from fast_image_recognition_tpu_torch.kernels import build
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
    # query tiles of the exact scan's kernel that hold an escalated probe
    qt = build.topk_l2_query_rows()
    front_blocks = -(-n_esc // qt)
    in_place_blocks = int(torch.nn.functional.pad(esc, (0, -esc.shape[0] % qt)).view(-1, qt).any(dim=1).sum())
    row = dict(escalated=n_esc, batch=emb.shape[0], query_tile=qt, scanned_blocks_front=front_blocks,
               scanned_blocks_in_place=in_place_blocks, **{f"{k}_ms": v for k, v in ms.items()})
    phase(
        f"partial escalation ({n_esc} of {emb.shape[0]} probes): exact step {ms['front']} ms with the escalated "
        f"probes in front ({front_blocks} query tiles of {qt} scan), {ms['in_place']} ms in place ({in_place_blocks} "
        f"tiles), {ms['gather_sync']} ms by gather behind a host sync; same rows all three"
    )
    return row


def random_unit_gallery(n: int, dim: int, dev, seed: int = 1):
    """``n`` (rounded up to 1024) bf16 rows normalize(N(0, I)), drawn on the
    card a chunk at a time (bench.py's bf gallery)."""
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
# (name, B0 block index, plane, plan (th, tw, group, bufs, ipb)): plans
# that B0@224's blocks never pick but other planes do (B1-B7 tile 15-38
# planes single-buffered; no supported plane splits its output channels,
# which the kernel takes all the same). Block 12 is block6b (192 -> 1152
# -> 192, k = 5, SE; three 64-channel output tiles), 2 block2b, 0 block1a
# (no expand).
FORCED_MB_PLANS = [
    ("block6b, 3 output groups, 2 images a block", 12, 7, (7, 7, 1, 3, 2)),
    ("block6b, output groups of 2 + 1, weights single-buffered", 12, 15, (15, 15, 2, 1, 1)),
    ("block6b, 3 output groups, tiled, input single-buffered", 12, 15, (8, 15, 1, 2, 1)),
    ("block6b, tiled, no double buffer", 12, 15, (8, 15, 3, 0, 1)),
    ("block2b, tiled, weights single-buffered", 2, 15, (8, 8, 1, 1, 1)),
    ("block1a no expand, tiled, no double buffer", 0, 15, (8, 8, 1, 0, 1)),
]


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


def run_mbconv_pair(x, q, cfg, plan=None):
    """The fused block's kernel and plain version on one input: (kernel out,
    plain out, max |difference| / max |plain|, bit-equal share, the two
    launchers), with ``plan`` or ``plane_plan``'s pick."""
    import torch

    from fast_image_recognition_tpu_torch.kernels import build, plain
    from fast_image_recognition_tpu_torch.ops import mbconv_kernel as mb

    k = cfg["kernel"]
    pads = tuple(mb._same_pads(n, k, 1)[1:] for n in x.shape[2:])
    if plan is None:
        run_k = lambda: mb.mbconv(x, q, cfg)  # noqa: E731
    else:
        run_k = lambda: build.launch_mbconv(x, q, k, (pads[0][0], pads[1][0]), plan,  # noqa: E731
                                            cfg["activation"] == "relu6", cfg["residual"])
    run_p = lambda: plain.mbconv_plain(x, q, k, pads, cfg["activation"], cfg["residual"])  # noqa: E731
    yk, yp = run_k(), run_p()
    torch.cuda.synchronize()
    if not yk.is_contiguous(memory_format=torch.channels_last) or yk.shape != yp.shape:
        raise AssertionError("the mbconv kernel's output has the wrong shape or layout")
    rel = ((yk.float() - yp.float()).abs().max() / torch.clamp_min(yp.float().abs().max(), 1e-30)).item()
    eq = (yk == yp).float().mean().item()
    return yk, yp, rel, eq, run_k, run_p


def check_mbconv_blocks(net, net_f, images, report):
    """The fused MBConv kernel vs its plain version at each stride-1 block on
    the per-op forward's activations, timed beside its bound and the
    per-op block; its shared memory equal to ``plane_smem``'s."""
    import torch

    from fast_image_recognition_tpu_torch.kernels import build
    from fast_image_recognition_tpu_torch.ops import mbconv_kernel as mb

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
                cout, ce = q["w_proj_t"].shape
                s_ = q["w_se1"].shape[1] if "w_se1" in q else 0
                plan = mb.plane_plan(hw, hw, fb.cfg["kernel"], cin, ce, cout, s_, "w_exp_t" in q)
                smem = mb.plane_smem(hw, hw, fb.cfg["kernel"], cin, ce, cout, s_, "w_exp_t" in q, *plan)
                if build._lib("mbconv").mbconv_smem(hw, hw, fb.cfg["kernel"], cin, ce, cout, s_, int("w_exp_t" in q),
                                                    *plan) != smem:
                    raise AssertionError(f"kernels/mbconv.cu and ops.mbconv_kernel.plane_smem disagree at {name}")
                pbytes = sum(t.numel() * t.element_size() for t in q.values())  # the weights the kernel reads
                b_ms, b_by = mbconv_bound(b, hw, cin, ce, cout, fb.cfg["kernel"], "w_exp_t" in q, pbytes)
                row = dict(block=name, b=b, hw=hw, cin=cin, ce=ce, cout=cout, k=fb.cfg["kernel"],
                           plan=dict(zip(("th", "tw", "group", "bufs", "ipb"), plan)), smem=smem,
                           max_abs_err=err, rel_err=rel, bit_equal=eq, ms=ms, plain_ms=plain_ms,
                           per_op_ms=per_op_ms, bound_ms=b_ms, bound_by=b_by)
                rows.append(row)
                print(f"  mbconv {name} B={b} {hw}x{hw} {cin}->{ce}->{cout} k{row['k']} plan {plan} ({smem} B): "
                      f"rel err {rel:.2e} (bit-equal {100 * eq:.2f}%), kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                      f"per-op {per_op_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})", flush=True)
                if rel > MB_TOL:
                    raise AssertionError(f"mbconv kernel disagrees with its plain version at {name}: {rel:.3e}")
            h = blk(h)
    tot = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "per_op_ms", "bound_ms")}
    slower = [r["block"] for r in rows if r["ms"] > r["per_op_ms"]]
    phase(f"mbconv blocks ({len(rows)} stride-1 blocks, B={images.shape[0]}): every kernel output within "
          f"{MB_TOL:.2e} of max |plain|; summed kernel {tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, "
          f"per-op {tot['per_op_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms; blocks slower than per-op: {slower}")
    report["blocks"] = rows
    report["total"] = tot
    return rows


def check_mbconv_edges(net_f, dev):
    """The fused MBConv kernel vs its plain version off the path's shapes,
    untimed: B 1 and 130, a 15 plane, relu6, no SE, no expand, k=7, an
    inflated expand bias (border taps) and :data:`FORCED_MB_PLANS`, each
    against the shared-memory mirror. Returns the cases."""
    import torch

    from fast_image_recognition_tpu_torch.kernels import build
    from fast_image_recognition_tpu_torch.ops import mbconv_kernel as mb

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
        if "b_exp" in change:  # the last row of each slab of dw_aux
            q["dw_aux"] = q["dw_aux"].clone()
            q["dw_aux"][:, -1] *= change.pop("b_exp")
        cfg.update(change)
        if not cfg["has_se"]:
            q = {n: t for n, t in q.items() if not n.startswith(("w_se", "b_se"))}
        cases.append((f"{name} B={b} {hw}x{hw}", q, cfg, b, hw, None))
    cin, ce, cout = 32, 64, 32
    p7 = dict(w_exp=rnd(1, 1, cin, ce, scale=0.2), b_exp=rnd(ce, scale=0.1), w_dw=rnd(7, 7, 1, ce, scale=0.2),
              b_dw=rnd(ce, scale=0.1), w_se1=rnd(ce, 8, scale=0.2), b_se1=rnd(8, scale=0.1),
              w_se2=rnd(8, ce, scale=0.2), b_se2=rnd(ce, scale=0.1), w_proj=rnd(1, 1, ce, cout, scale=0.2),
              b_proj=rnd(cout, scale=0.1))
    cfg7 = dict(kernel=7, stride=1, has_expand=True, has_se=True, residual=True, activation="swish")
    cases.append(("k7 random weights B=130 15x15", mb.prepare_params(p7, cfg7), cfg7, 130, 15, None))
    for name, i, hw, plan in FORCED_MB_PLANS:
        q, cfg = params(i)
        cases.append((f"{name} B=130 {hw}x{hw} plan {plan}", q, cfg, 130, hw, plan))
    out = []
    with torch.no_grad():
        for name, q, cfg, b, hw, plan in cases:
            cout_, ce_ = q["w_proj_t"].shape
            c_in = q["w_exp_t"].shape[1] if "w_exp_t" in q else ce_
            if plan is not None:
                s_ = q["w_se1"].shape[1] if "w_se1" in q else 0
                geo = (hw, hw, cfg["kernel"], c_in, ce_, cout_, s_)
                smem = mb.plane_smem(*geo, "w_exp_t" in q, *plan)
                if smem < 0 or build._lib("mbconv").mbconv_smem(*geo, int("w_exp_t" in q), *plan) != smem:
                    raise AssertionError(f"mbconv plan {plan} ({name}): the kernel refuses it or its shared "
                                         f"memory differs from ops.mbconv_kernel.plane_smem ({smem})")
            x = rnd(b, hw, hw, c_in, dtype=torch.bfloat16).permute(0, 3, 1, 2)
            yk, yp, rel, eq, _, _ = run_mbconv_pair(x, q, cfg, plan)
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
    """One call of ``fn`` (after a warm-up) under ``torch.profiler``: device
    busy time, the window from first to last activity, its idle share,
    time by kernel name; None without device activity."""
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
    """The plain line on the fused module: timed, one call under sync debug
    "error", launches counted; its embedding vs the per-op one (JAX's
    0.05), labels vs the per-op line's but at swapped near-ties (each
    line's pick the nearer to its own embedding within 2^-7); one traced
    call of each line (idle share, the fused kernel's device time)."""
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
    check_launches("fused", launches, mbconv=n_fused * calls, tilemin2_packed=calls, topk_l2=calls)
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
        tr["mbconv_ms"] = sum(v for k, v in by.items() if "mbconv_sm90" in k)
        tr["top"] = sorted(by.items(), key=lambda kv: -kv[1])[:6]
        row[f"trace_{line}"] = tr
        print(f"  {line} line, one call traced: device busy {tr['busy_ms']:.2f} ms of a {tr['window_ms']:.2f} ms "
              f"window (idle share {100 * tr['idle_share']:.1f}%, {tr['events']} device activities); mbconv "
              f"{tr['mbconv_ms']:.2f} ms; top {[(k[:60], round(v, 3)) for k, v in tr['top']]}", flush=True)
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
    """chi2 kernel vs its plain version: minima within CHI2_TOL relative, rows
    rescored exactly within CHI2_TOL of the plain minimum. Returns (report
    dict, kernel min, kernel rows)."""
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
    """The chi2 kernel at edge shapes, untimed: B 1 and 130, D = 100, zero
    rows past n_valid 900, n_valid 896, bf16 rows, equal rows."""
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
    # KL scans timed over CHI2_SLOW_ITERS calls with no warm-up (they compile nothing)
    build.reset_launch_counts()
    cost = chi2_cost.main(["--kinds", "chi2,kl", "--iters", str(CHI2_SLOW_ITERS), "--warmup", "0"])
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
        # a warm-up batch, then one of 1024; the eager chi2/KL scans compile nothing: no warm-up
        res = evaluate_matcher(m, glab, p_np, plab, verbose=False, warmup=name not in ("chi2", "kl"))
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
    # 17'. the classifiers and verification over the brute-force line's rows
    cls_rows = run_classifiers(gal, glab, probes, plab, dev, smi)

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
    return kernel_row, {"chi2_cost": cost, "brute_force": bf_rows, "classifiers": cls_rows}


# bench.py --config dem / video / cascade at their defaults, and the TWD
# classifiers over the dem gallery
DEM_CLASSES, DEM_PER, DEM_DIM, DEM_BATCH = 1000, 100, 1536, 128  # bench_dem: 100k x 1536, batch 128
DEM_BUDGET = 0.01
DEM_ORACLE_PROBES = 32
VIDEO_CLASSES, VIDEO_FRAMES = 100, 20  # bench_video: 20 gallery and 20 probe frames per class
VIDEO_TIE = 2.0**-10  # summed log-posteriors of a video's two best classes this close: a near-tie
CASCADE_CLASSES, CASCADE_CALIB = 100, 256  # bench_cascade: 100-class SVC heads, calibrated on 256 images
CASCADE_TIE = 2.0**-8  # a score margin (top-2, or to the threshold) this close to 0: a near-tie (scores ~0.1)
BIND_BATCH = 64
KNN_IDS, KNN_PER = 100, 4
TWD_PROBES, TWD_ORACLE_PROBES = 1024, 16
FEATURE_REPS, TWD_REPS = 50, 4  # device-timed calls of the ms-scale dem/video lines and of each TWD classifier
FULL_DEM_BUDGET, FULL_DEM_PROBES = 60, 32  # FullMatrixDEM on the video gallery at JAX's test budget
SVC_CHECK_STEPS = 20  # svc_descent steps run on the card and the CPU from the same weights
VIDEO_IO_VIDEOS = 10  # videos written and read back through the text format


def fusion_fp64(probes, gallery, gl, fv, num_classes, num_videos, w=100.0):
    """The video fusion in fp64 NumPy: [num_videos, num_classes] summed
    log-posteriors."""
    import numpy as np
    p64, g64 = probes.astype(np.float64), gallery.astype(np.float64)
    d = ((p64 * p64).sum(1)[:, None] + (g64 * g64).sum(1)[None, :] - 2.0 * p64 @ g64.T) / p64.shape[1]
    cmin = np.full((len(p64), num_classes), 1e30)
    for c in range(num_classes):
        if (gl == c).any():
            cmin[:, c] = d[:, gl == c].min(1)
    logits = -w * cmin
    logp = logits - logits.max(1, keepdims=True)
    logp -= np.log(np.exp(logp).sum(1, keepdims=True))
    out = np.zeros((num_videos, num_classes))
    np.add.at(out, fv, logp)
    return out


def cascade_margins(pipe, x):
    """Per level and image, from one pass of the whole batch through every
    level: the gap between the exit head's two best scores ([L, B]) and the
    distance of the best score to the level's threshold ([L, B], inf at the
    last level)."""
    import torch

    gaps, dists = [], []
    for level, scores in enumerate(pipe.level_scores(x)):
        top2 = torch.topk(scores, 2, dim=1).values
        gaps.append(top2[:, 0] - top2[:, 1])
        last = level == pipe.num_levels - 1
        dists.append(torch.full_like(top2[:, 0], math.inf) if last else (top2[:, 0] - pipe.thresholds[level]).abs())
    return torch.stack(gaps).cpu().numpy(), torch.stack(dists).cpu().numpy()


def check_cascade_decisions(what, got, want, margins):
    """``got`` equals ``want`` but on <= 1 % of images, each at a near-tie
    (a best score within CASCADE_TIE of the threshold or of the runner-up)."""
    import numpy as np

    gaps, dists = margins
    levels = np.arange(gaps.shape[0])[:, None]
    reached = levels <= np.maximum(got.exit_level, want.exit_level)[None, :]
    exited = (levels == got.exit_level[None, :]) | (levels == want.exit_level[None, :])
    tie = ((reached & (dists <= CASCADE_TIE)) | (exited & (gaps <= CASCADE_TIE))).any(axis=0)
    differ = (got.predictions != want.predictions) | (got.exit_level != want.exit_level)
    if differ.mean() > 0.01 or not (tie | ~differ).all():
        raise AssertionError(f"{what}: {int(differ.sum())} images differ from predict(), "
                             f"{int((differ & ~tie).sum())} of them off near-ties")
    return 100.0 * float(np.mean(~differ)), int(differ.sum()), int(tie.sum())


def check_feature_entry_points(dev, smi, g, gl, p, pl):
    """The feature-level entry points no bench line times, at the video
    line's data. Returns the line's JSON."""
    import importlib.util
    import tempfile

    import numpy as np
    import torch

    from fast_image_recognition_tpu_torch.cascade import exits
    from fast_image_recognition_tpu_torch.data.feature_io import normalize_features
    from fast_image_recognition_tpu_torch.data.video_io import VideoDB, load_videos, write_videos
    from fast_image_recognition_tpu_torch.evaluation.video import evaluate_video_recognition, sample_probe_frames
    from fast_image_recognition_tpu_torch.search.dem import (DirectedEnumerationMatcher, FullMatrixDEM,
                                                             dem_full_oracle_search)

    t = time.time()
    cpu = torch.device("cpu")
    row = dict(line="feature entry points", sklearn=importlib.util.find_spec("sklearn") is not None)

    # exit levels: unit-row prefixes of 256, 768 and 1536 features
    def levels(x):
        return [(x[:, :w] / np.linalg.norm(x[:, :w], axis=1, keepdims=True)).astype(np.float32)
                for w in (256, 768, x.shape[1])]

    x_tr, x_va = levels(g), levels(p)

    # svc_descent from one set of weights on the card and on the CPU
    w0 = (torch.randn((VIDEO_CLASSES, g.shape[1]), generator=torch.Generator().manual_seed(0)) * 0.01).numpy()
    b0 = np.zeros(VIDEO_CLASSES, np.float32)
    w_d, b_d = exits.svc_descent(x_tr[-1], gl, VIDEO_CLASSES, w0, b0, steps=SVC_CHECK_STEPS, device=dev)
    w_c, b_c = exits.svc_descent(x_tr[-1], gl, VIDEO_CLASSES, w0, b0, steps=SVC_CHECK_STEPS, device=cpu)
    row["svc_descent_max_rel_err"] = svc_err = float(max(np.abs(w_d - w_c).max() / np.abs(w_c).max(),
                                                        np.abs(b_d - b_c).max() / max(np.abs(b_c).max(), 1e-30)))

    # LinearExitCascade: trained on the card (train_linear_svc takes the
    # descent where scikit-learn is missing), evaluated there, and its
    # decisions held against fp64 NumPy scores of the same weights
    casc = exits.LinearExitCascade.train(x_tr, gl, VIDEO_CLASSES, device=dev)
    res = casc.evaluate(x_va, device=dev)
    ties = np.zeros(len(p), bool)
    want_pred = np.zeros(len(p), np.int64)
    want_level = np.full(len(p), len(x_va) - 1, np.int64)
    decided = np.zeros(len(p), bool)
    probs = []
    for level, x in enumerate(x_va):
        sc = x.astype(np.float64) @ casc.coefs[level].astype(np.float64).T + casc.intercepts[level]
        top2 = np.sort(sc, axis=1)[:, -2:]
        last = level == len(x_va) - 1
        fire = np.ones(len(p), bool) if last else top2[:, 1] > casc.thresholds[level]
        ties |= ~decided & (top2[:, 1] - top2[:, 0] <= 2.0**-16 * np.abs(top2[:, 1]).clip(1.0))
        if not last:
            ties |= ~decided & (np.abs(top2[:, 1] - casc.thresholds[level]) <= 2.0**-16 * max(1.0, abs(casc.thresholds[level])))
        new = fire & ~decided
        want_pred[new], want_level[new] = sc.argmax(1)[new], level
        decided |= fire
        e = np.exp(sc - sc.max(1, keepdims=True))
        probs.append(e / e.sum(1, keepdims=True))
    differ = (res.predictions != want_pred) | (res.exit_level != want_level)
    row["linear_exits_equal_fp64_pct"] = 100.0 * float(np.mean(~differ))
    row["linear_exits_breaks"] = [float(v) for v in res.break_counts]
    row["linear_exits_error_pct"] = 100.0 * float(np.mean(res.predictions != pl))
    entropy = exits.entropy_exit_cascade(probs, threshold=0.5)
    row["entropy_exits_breaks"] = [float(v) for v in entropy.break_counts]

    # the kNN exits, alone and with a final SVC, on the card and on the CPU
    knn_d = exits.sequential_knn_cascade(x_tr, gl, x_va, device=dev)
    knn_c = exits.sequential_knn_cascade(x_tr, gl, x_va, device=cpu)
    hyb_d = exits.knn_exits_with_final_classifier(x_tr, gl, x_va, VIDEO_CLASSES, device=dev)
    hyb_c = exits.knn_exits_with_final_classifier(x_tr, gl, x_va, VIDEO_CLASSES, device=cpu)

    def same(a, b):
        return 100.0 * float(np.mean((a.predictions == b.predictions) & (a.exit_level == b.exit_level)))

    row["knn_exits_card_vs_cpu_equal_pct"], row["knn_svc_exits_card_vs_cpu_equal_pct"] = same(knn_d, knn_c), same(hyb_d, hyb_c)

    # FullMatrixDEM at JAX's test budget against the sequential oracle
    full = FullMatrixDEM(g, gl, seed=3, device=dev)
    full.set_budget(FULL_DEM_BUDGET)
    fr = full.search(p[:FULL_DEM_PROBES])
    p_full, starts = full._p_full.cpu().numpy(), full._start_idx.cpu().numpy()
    full_rows = full_close = 0
    for i in range(FULL_DEM_PROBES):
        oi, _, oc = dem_full_oracle_search(p[i], g, p_full, starts, full.threshold, FULL_DEM_BUDGET)
        full_rows += int(fr.indices[i] == oi)
        full_close += int(abs(int(round(fr.checked_fraction[i] * g.shape[0])) - oc) <= 2)
    row["full_dem_oracle_rows_equal_pct"] = 100.0 * full_rows / FULL_DEM_PROBES
    row["full_dem_oracle_checked_within_2_pct"] = 100.0 * full_close / FULL_DEM_PROBES
    del full, p_full

    # the video text format: write the first videos, read them back (the
    # loader zeroes tiny entries and normalizes, as the reference does)
    sub = pl < VIDEO_IO_VIDEOS
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "videos.txt")
        write_videos(path, p[sub], pl[sub], np.arange(VIDEO_IO_VIDEOS), [f"person{i}" for i in range(VIDEO_IO_VIDEOS)])
        back = load_videos(path, p.shape[1])
    io_ok = (np.array_equal(back.frame_video, pl[sub]) and np.array_equal(back.video_person, np.arange(VIDEO_IO_VIDEOS))
             and back.person_names == [f"person{i}" for i in range(VIDEO_IO_VIDEOS)]
             and np.abs(back.frames - normalize_features(p[sub])).max() <= 1e-6)
    row["video_io_round_trip"] = bool(io_ok)

    # evaluate_video_recognition through a gather DEM matcher (budget 10 %),
    # on the card and on the CPU
    videos = VideoDB(frames=p, frame_video=pl.astype(np.int64), video_person=np.arange(VIDEO_CLASSES),
                     person_names=[str(i) for i in range(VIDEO_CLASSES)])
    idx = sample_probe_frames(videos, step=2)
    ev = {}
    for name, d in (("card", dev), ("cpu", cpu)):
        m = DirectedEnumerationMatcher(g, gl, probe_mode="gather", image_count_to_check=g.shape[0] // 10, seed=0,
                                       device=d)
        ev[name] = evaluate_video_recognition(m, gl, videos, np.arange(VIDEO_CLASSES), idx, VIDEO_CLASSES)
        del m
    row["video_eval"] = {k: dict(frame_error_pct=v.frame_error, video_error_pct=v.video_error) for k, v in ev.items()}
    frame_gap = abs(ev["card"].frame_error - ev["cpu"].frame_error) * len(idx) / 100.0
    video_gap = abs(ev["card"].video_error - ev["cpu"].video_error) * VIDEO_CLASSES / 100.0
    row["seconds"] = time.time() - t
    phase(
        f"feature entry points ({len(p)} x {p.shape[1]} video-line rows, {VIDEO_CLASSES} classes, {smi}; "
        f"scikit-learn {'present' if row['sklearn'] else 'absent: the SVC descent'}): svc_descent card vs CPU over "
        f"{SVC_CHECK_STEPS} steps max rel err {svc_err:.3e}; LinearExitCascade (levels 256/768/1536) equal to fp64 "
        f"on {row['linear_exits_equal_fp64_pct']:.2f}% ({int((differ & ties).sum())} near-ties differ), breaks "
        f"{[round(v, 3) for v in row['linear_exits_breaks']]}, error {row['linear_exits_error_pct']:.2f}%; entropy "
        f"exits breaks {[round(v, 3) for v in row['entropy_exits_breaks']]}; kNN exits card = CPU "
        f"{row['knn_exits_card_vs_cpu_equal_pct']:.2f}%, kNN + SVC {row['knn_svc_exits_card_vs_cpu_equal_pct']:.2f}%; "
        f"FullMatrixDEM (budget {FULL_DEM_BUDGET}) vs dem_full_oracle_search on {FULL_DEM_PROBES} probes: rows "
        f"{row['full_dem_oracle_rows_equal_pct']:.1f}%, checked within 2 {row['full_dem_oracle_checked_within_2_pct']:.1f}%; "
        f"video text round trip {io_ok}; evaluate_video_recognition via DEM gather ({len(idx)} frames) card "
        f"{ev['card'].frame_error:.3f}% / {ev['card'].video_error:.1f}% vs CPU {ev['cpu'].frame_error:.3f}% / "
        f"{ev['cpu'].video_error:.1f}% (frame / video error); {row['seconds']:.1f} s"
    )
    if svc_err > 1e-4:
        raise AssertionError("svc_descent on the card drifts from its CPU run")
    if (differ & ~ties).any():
        raise AssertionError("LinearExitCascade's decisions differ from fp64 beyond near-ties")
    if row["knn_exits_card_vs_cpu_equal_pct"] < 99.0 or row["knn_svc_exits_card_vs_cpu_equal_pct"] < 99.0:
        raise AssertionError("the kNN exit cascades differ between the card and the CPU")
    if full_rows < int(0.9 * FULL_DEM_PROBES) or full_close < int(0.85 * FULL_DEM_PROBES):
        raise AssertionError("FullMatrixDEM disagrees with dem_full_oracle_search (tests/test_dem.py:232-251 bounds)")
    if not io_ok:
        raise AssertionError("the video text format does not round-trip")
    if frame_gap > 0.01 * len(idx) or video_gap > 1:
        raise AssertionError("evaluate_video_recognition differs between the card and the CPU")
    return row


def run_feature_configs(dev, launches, smi):
    """bench.py's dem, video and cascade configs and the TWD classifiers.
    Returns their lines' JSON."""
    import numpy as np
    import torch

    from fast_image_recognition_tpu_torch.cascade import ConventionalTWD, ProposedTWD, TWDType
    from fast_image_recognition_tpu_torch.cascade.engine import SequentialInferencePipeline
    from fast_image_recognition_tpu_torch.cascade.twd import proposed_twd_oracle
    from fast_image_recognition_tpu_torch.data import make_gallery_and_probes
    from fast_image_recognition_tpu_torch.evaluation.video import make_video_fusion_fn
    from fast_image_recognition_tpu_torch.kernels import build
    from fast_image_recognition_tpu_torch.models import backbone_info, create_efficientnet, default_taps
    from fast_image_recognition_tpu_torch.models.fold import make_serving_fn
    from fast_image_recognition_tpu_torch.search.dem import DirectedEnumerationMatcher, dem_oracle_search

    lines = {}

    # 18. bench.py --config dem: the gather probe mode at budget 1 %, host build
    t = time.time()
    g, gl, p, pl = make_gallery_and_probes(DEM_CLASSES, DEM_PER, 1, DEM_DIM, seed=0)
    data_s = time.time() - t
    t = time.time()
    dem = DirectedEnumerationMatcher(g, gl, probe_mode="gather", seed=0, device=dev)
    budget = int(DEM_BUDGET * g.shape[0])
    dem.set_budget(budget)
    torch.cuda.synchronize()
    build_s = time.time() - t
    probes = torch.from_numpy(p[:DEM_BATCH]).to(dev)
    b = probes.shape[0]
    build.reset_launch_counts()
    idx, _, checked = (x.cpu().numpy() for x in dem.search_device(probes))
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = dem.search_device(probes)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not np.array_equal(out[0].cpu().numpy(), idx):
        raise AssertionError("dem search_device answers changed under sync debug mode")
    dem_ms = cuda_ms(lambda: dem.search_device(probes), FEATURE_REPS)
    qps = b / dem_ms * 1e3
    check_launches("dem", launches)
    n = g.shape[0]
    oracle_rows = oracle_close = 0
    for i in range(DEM_ORACLE_PROBES):
        oi, _, oc = dem_oracle_search(p[i], g, dem.index, budget)
        oracle_rows += int(idx[i] == oi)
        oracle_close += int(abs(int(checked[i]) - oc) <= 2)
    dem_dev = DirectedEnumerationMatcher.from_device(torch.from_numpy(g).to(dev), gl, probe_mode="exact", seed=0,
                                                     device=dev)
    dem_dev16 = DirectedEnumerationMatcher.from_device(torch.from_numpy(g).to(dev), gl, seed=0, device=dev)
    same_pivots = np.array_equal(dem_dev.index.pivot_indices, dem.index.pivot_indices)
    pivots16 = 100.0 * float(np.mean(dem_dev16.index.pivot_indices == dem.index.pivot_indices))
    # the default device build (bf16 rows, gather) answers as the host build
    # does: labels on >= 97 % of the probes (tests/test_dem.py:57-79)
    dem_dev16.set_budget(budget)
    idx_d16 = dem_dev16.search_device(probes)[0].cpu().numpy()
    dev16_labels = 100.0 * float(np.mean(gl[idx_d16] == gl[idx]))
    del dem_dev, dem_dev16
    exact = DirectedEnumerationMatcher(g, gl, probe_mode="exact", seed=0, device=dev)
    exact.set_budget(budget)
    idx_e = exact.search_device(probes)[0].cpu().numpy()
    del exact
    row = dict(line="dem gather", queries_s=qps, error_pct=100.0 * float(np.mean(gl[idx] != pl[:b])),
               checked_pct=100.0 * float(checked.mean()) / n, budget=budget, pivots=len(dem.index.pivot_indices),
               oracle_rows_equal_pct=100.0 * oracle_rows / DEM_ORACLE_PROBES,
               oracle_checked_within_2_pct=100.0 * oracle_close / DEM_ORACLE_PROBES,
               exact_mode_label_agreement_pct=100.0 * float(np.mean(gl[idx] == gl[idx_e])),
               exact_mode_row_agreement_pct=100.0 * float(np.mean(idx == idx_e)),
               from_device_fp32_same_pivots=same_pivots, from_device_bf16_pivots_equal_pct=pivots16,
               from_device_bf16_label_agreement_pct=dev16_labels, ms=dem_ms, timed_calls=FEATURE_REPS)
    lines["dem"] = row
    phase(
        f"dem gather ({n} x {DEM_DIM} gallery, budget {budget} of {n} (1 %), {row['pivots']} pivots, batch {b}; data "
        f"{data_s:.1f} s, host build {build_s:.1f} s): {qps} queries/s ({dem_ms} ms a call, CUDA events over "
        f"{FEATURE_REPS} calls, {smi}), error {row['error_pct']:.3f}%, "
        f"checked {row['checked_pct']:.4f}%; against dem_oracle_search on {DEM_ORACLE_PROBES} probes rows equal "
        f"{row['oracle_rows_equal_pct']:.1f}%, checked within 2 {row['oracle_checked_within_2_pct']:.1f}%; labels "
        f"equal probe_mode='exact' {row['exact_mode_label_agreement_pct']:.3f}% (rows "
        f"{row['exact_mode_row_agreement_pct']:.3f}%); from_device picks the host build's pivots: fp32 rows "
        f"{same_pivots}, bf16 rows {pivots16:.1f}%; the bf16 device build's labels equal the host build's on "
        f"{dev16_labels:.3f}%; no host sync in search_device; launches {launches['dem']}"
    )
    if (oracle_rows < 0.92 * DEM_ORACLE_PROBES or oracle_close < 0.9 * DEM_ORACLE_PROBES
            or row["exact_mode_label_agreement_pct"] < 97.0 or not same_pivots or dev16_labels < 97.0):
        raise AssertionError("dem gather disagrees with its oracle, its exact mode or its device build")
    del dem

    # 19. the TWD classifiers over the same gallery: 1024 probes, the dem
    # line's 1000 and its first 24 again
    tq = np.resize(p, (TWD_PROBES, p.shape[1]))
    twd_rows = []
    classifiers = [ProposedTWD(g, gl, DEM_CLASSES, chunk_features=32, theta=0.7, device=dev)] + [
        ConventionalTWD(g, gl, DEM_CLASSES, kind, thr, device=dev)
        for kind, thr in ((TWDType.POSTERIORS, 0.24), (TWDType.DIST_DIFF, 0.003), (TWDType.DIST_RATIO, 0.7))
    ]
    build.reset_launch_counts()
    for clf in classifiers:
        clf.reset_counters()
        preds = clf.predict(tq)
        unreliable = clf.unreliable_count
        ms = cuda_ms(lambda: clf.predict(tq), TWD_REPS)
        twd_rows.append(dict(line=clf.name, ms_per_probe=ms / len(tq), ms=ms, timed_calls=TWD_REPS,
                             unreliable_pct=100.0 * unreliable / len(tq),
                             error_pct=100.0 * float(np.mean(preds[: len(p)] != pl))))
    check_launches("twd", launches)
    proposed = classifiers[0].predict(tq[:TWD_ORACLE_PROBES])
    want = np.asarray([proposed_twd_oracle(tq[i], g, gl, 32, 0.7)[0] for i in range(TWD_ORACLE_PROBES)])
    twd_equal = int((proposed == want).sum())
    lines["twd"] = dict(rows=twd_rows, oracle_equal=twd_equal, oracle_probes=TWD_ORACLE_PROBES)
    phase(f"twd over the dem gallery ({len(tq)} probes, CUDA events over {TWD_REPS} calls each, {smi}): " + "; ".join(
        f"{r['line']}: {r['ms_per_probe']} ms/probe, unreliable {r['unreliable_pct']:.2f}%, error "
        f"{r['error_pct']:.2f}%" for r in twd_rows)
        + f"; Proposed TWD equals proposed_twd_oracle on {twd_equal} of {TWD_ORACLE_PROBES} probes; launches "
          f"{launches['twd']}")
    if twd_equal != TWD_ORACLE_PROBES:
        raise AssertionError("Proposed TWD disagrees with proposed_twd_oracle")
    del classifiers, tq
    # 19'. the small-world, projection and kd-forest matchers over the same gallery
    lines["ann"] = run_ann_matchers(g, gl, p, pl, dev, launches, smi)
    del g, gl, p, pl

    # 20. bench.py --config video: 100 classes x 20 gallery frames, 20 probe
    # frames per class, one video each, log-posterior fusion
    g, gl, p, pl = make_gallery_and_probes(VIDEO_CLASSES, VIDEO_FRAMES, VIDEO_FRAMES, 1536, seed=0)
    fuse = make_video_fusion_fn(g, gl, VIDEO_CLASSES, VIDEO_CLASSES, device=dev)
    pv, fv = torch.from_numpy(p).to(dev), torch.from_numpy(pl.astype(np.int64)).to(dev)
    build.reset_launch_counts()
    preds = fuse(pv, fv).cpu().numpy()
    video_ms = cuda_ms(lambda: fuse(pv, fv), FEATURE_REPS)
    fps = len(p) / video_ms * 1e3
    check_launches("video", launches)
    ref = fusion_fp64(p, g, gl, pl, VIDEO_CLASSES, VIDEO_CLASSES)
    top2 = np.sort(ref, axis=1)[:, -2:]
    tie = top2[:, 1] - top2[:, 0] <= VIDEO_TIE * np.maximum(1.0, np.abs(top2[:, 1]))
    equal = preds == ref.argmax(1)
    lines["video"] = dict(line="video fusion", frames_s=fps, ms=video_ms, timed_calls=FEATURE_REPS,
                          error_pct=100.0 * float(np.mean(preds != np.arange(VIDEO_CLASSES))),
                          fp64_equal_pct=100.0 * float(equal.mean()), near_ties=int(tie.sum()))
    phase(f"video fusion ({g.shape[0]} gallery rows, {len(p)} frames, {VIDEO_CLASSES} videos): {fps} frames/s "
          f"({video_ms} ms a call, CUDA events over {FEATURE_REPS} calls, {smi}), error {lines['video']['error_pct']:.3f}%, per-video predictions equal to fp64 NumPy "
          f"{lines['video']['fp64_equal_pct']:.1f}% ({int(tie.sum())} near-ties); launches {launches['video']}")
    if not (equal | tie).all():
        raise AssertionError("the video fusion disagrees with fp64 beyond near-ties")
    del pv, fv, fuse
    lines["entry_points"] = check_feature_entry_points(dev, smi, g, gl, p, pl)
    del g, gl, p, pl

    # 21. bench.py --config cascade: B0@224, the port's own init (seed 0),
    # deep taps, 100-class random SVC heads, the folded engine, batch 1024
    t = time.time()
    model, variables = create_efficientnet("b0", 0, seed=0, resolution=RES, device=dev)
    taps = default_taps("b0", preset="deep")
    with torch.no_grad():
        probe = model(torch.zeros((1, RES, RES, 3), device=dev), taps=taps)
    dims = [int(probe["taps"][tap].shape[-1]) for tap in taps] + [int(probe["embedding"].shape[-1])]
    rng = np.random.default_rng(0)
    coefs = [rng.normal(0, 0.1, (CASCADE_CLASSES, d)).astype(np.float32) for d in dims]
    intercepts = [np.zeros(CASCADE_CLASSES, np.float32) for _ in dims]
    pipe = SequentialInferencePipeline(model, variables, taps, coefs, intercepts, thresholds=[0.0] * (len(dims) - 1),
                                       engine="folded", device=dev)
    x = torch.from_numpy(rng.normal(size=(BATCH, RES, RES, 3)).astype(np.float32)).to(dev)
    pipe.calibrate(x[:CASCADE_CALIB])
    caps = pipe.capacities_for(BATCH, slack=SLACK)
    torch.cuda.synchronize()
    phase(f"cascade engine built: B0@{RES} own init, taps {taps}, dims {dims}, thresholds "
          f"{[round(v, 4) for v in pipe.thresholds]}, survivor fractions "
          f"{[round(v, 4) for v in pipe.survivor_fractions]} -> capacities {caps} in {time.time() - t:.1f} s")
    build.reset_launch_counts()
    fused = pipe.fused_fn(BATCH, slack=SLACK)
    res = pipe.predict_fused(x, slack=SLACK)  # warm-up and the answers
    torch.cuda.set_sync_debug_mode("error")
    try:
        packed = fused(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not np.array_equal(packed.cpu().numpy()[:BATCH], res.predictions):
        raise AssertionError("predict_fused's answers changed under sync debug mode")
    ms_fused = host_ms(lambda: fused(x), TIMED_CALLS)
    check_launches("cascade engine", launches)
    want = pipe.predict(x)
    margins = cascade_margins(pipe, x)
    full = pipe.predict_fused(x, capacities=[BATCH] * pipe.num_levels)
    full_eq, full_diff, full_ties = check_cascade_decisions("predict_fused at full capacities", full, want, margins)
    pooled = pipe.predict_pooled(x, bucket=BATCH, warmup=True)
    ms_pooled = host_ms(lambda: pipe.predict_pooled(x, bucket=BATCH), TIMED_CALLS)
    pooled_eq, pooled_diff, _ = check_cascade_decisions("predict_pooled", pooled, want, margins)
    info = backbone_info("b0")
    serve = make_serving_fn(variables, info, resolution=RES, device=dev)
    with torch.no_grad():
        ms_plain = host_ms(lambda: serve(x)["embedding"][0, :8], TIMED_CALLS)
    pipe_b = SequentialInferencePipeline(model, None, taps, coefs, intercepts, thresholds=pipe.thresholds,
                                         engine="bind", device=dev)
    bind_agree = 100.0 * float(np.mean(pipe_b.predict(x[:BIND_BATCH]).predictions
                                       == pipe.predict(x[:BIND_BATCH]).predictions))
    per_level, cumulative = pipe.measure_segment_latency(x, iters=3)
    if not (np.isfinite(per_level).all() and (per_level > 0).all() and len(per_level) == pipe.num_levels):
        raise AssertionError(f"measure_segment_latency gave {per_level}")
    seg0_ms = float(per_level[0]) * BATCH
    with torch.no_grad():
        # the same images in batches of 1024 and 256 (cuDNN may pick other algorithms)
        noise = (pipe.level_scores(x, levels=1)[0][:CASCADE_CALIB]
                 - pipe.level_scores(x[:CASCADE_CALIB], levels=1)[0]).abs().max().item()
    row = dict(line="cascade engine", img_s=BATCH / ms_fused * 1e3, ms=ms_fused, plain_img_s=BATCH / ms_plain * 1e3,
               plain_ms=ms_plain, speedup_vs_plain=ms_plain / ms_fused,
               break_counts=[float(v) for v in res.break_counts], forced_pct=100.0 * res.forced_fraction,
               agreement_pct=100.0 * float(np.mean(res.predictions == want.predictions)), capacities=list(caps),
               full_capacity_equal_pct=full_eq, pooled_img_s=BATCH / ms_pooled * 1e3, pooled_ms=ms_pooled,
               pooled_equal_pct=pooled_eq, bind_vs_folded_label_agreement_pct=bind_agree,
               near_tie_images=full_ties, level0_segment_ms=seg0_ms, level0_score_batch_noise=noise,
               segment_ms_per_image=[float(v) for v in per_level],
               cumulative_ms_per_image=[float(v) for v in cumulative])
    phase(
        f"cascade engine (folded, SVC exits, {len(dims)} levels, batch {BATCH}, {smi}): fused {row['img_s']:.1f} img/s "
        f"({ms_fused:.1f} ms), plain folded forward {row['plain_img_s']:.1f} img/s ({ms_plain:.1f} ms), "
        f"speedup_vs_plain {row['speedup_vs_plain']:.3f}, breaks {[round(v, 3) for v in row['break_counts']]}, forced "
        f"{row['forced_pct']:.2f}%, agreement with predict() {row['agreement_pct']:.2f}%; measure_segment_latency "
        f"per level {[round(float(v), 5) for v in per_level]} ms/image (level 0 {seg0_ms:.1f} ms a batch); at full capacities equal {full_eq:.2f}% ({full_diff} images differ, each at a near-tie); "
        f"pooled (bucket {BATCH}) {row['pooled_img_s']:.1f} img/s ({ms_pooled:.1f} ms), equal {pooled_eq:.2f}% "
        f"({pooled_diff} differ); bind engine vs folded at batch {BIND_BATCH}: labels {bind_agree:.1f}%; "
        f"{full_ties} images at near-ties (margin <= {CASCADE_TIE:.2e}), level-0 scores of the same images in "
        f"batches of {BATCH} and {CASCADE_CALIB} differ by {noise:.2e} at most; no host sync in the fused cascade; "
        f"launches {launches['cascade engine']}"
    )
    if bind_agree < 90.0:
        raise AssertionError("the bind engine agrees with the folded one on < 90 % of labels")
    del pipe_b, serve

    # the kNN head, one call: 100 identities x 4 images enrolled through the
    # same segments
    gal_images = rng.normal(size=(KNN_IDS * KNN_PER, RES, RES, 3)).astype(np.float32)
    gal_labels = np.repeat(np.arange(KNN_IDS, dtype=np.int32), KNN_PER)
    gal_images += gal_labels[:, None, None, None].astype(np.float32) * 0.05
    galleries = pipe.level_embeddings(gal_images)
    knn = SequentialInferencePipeline(model, variables, taps, head_mode="knn", galleries=galleries,
                                      gallery_labels=gal_labels, ratio=0.8, engine="folded", device=dev)
    knn.calibrate(x[:CASCADE_CALIB], tune=True)
    knn.predict_fused(x, slack=SLACK)  # warm-up
    r = knn.predict_fused(x, slack=SLACK)
    row["knn"] = dict(img_s=1e3 / r.ms_per_image, break_counts=[float(v) for v in r.break_counts],
                      forced_pct=100.0 * r.forced_fraction)
    lines["cascade_engine"] = row
    phase(f"cascade engine, kNN exits (ratio 0.8, {KNN_IDS} x {KNN_PER} enrolled, tuned): one call "
          f"{row['knn']['img_s']:.1f} img/s, breaks {[round(v, 3) for v in row['knn']['break_counts']]}, forced "
          f"{row['knn']['forced_pct']:.2f}%")
    del knn, pipe, model, x
    return lines


# the sharded slice: sharded serving and matcher, the small-world,
# projection and kd-forest matchers, the classifiers and verification
SHARDS = 4  # gallery shards, all on the one card
ANN_PROBES, ANN_TIE = 128, 2.0**-12
CLS_CPU_PROBES = 64  # probes the classifiers' CPU runs take
VERIF_DIM, VERIF_CLASSES = 256, 64  # verification_test's window (ImageTesting.cpp:715); classes in its [N, N]


def rows_tie_ok(q, gallery, got, want, rel=2.0**-12, abs_=0.0, precise=False):
    """Rows ``got`` equal ``want`` or tie with it within ``rel`` + ``abs_``
    (fp64, the query as the scan sees it)."""
    import torch

    got, want = torch.as_tensor(got, device=q.device).long(), torch.as_tensor(want, device=q.device).long()
    qf = (q if precise else q.to(torch.bfloat16)).to(torch.float64)
    d_got, d_want = (((gallery[r].to(torch.float64) - qf) ** 2).sum(1) for r in (got, want))
    return bool(((got == want) | ((d_got - d_want).abs() <= rel * d_want + abs_)).all())


def run_sharded_service(info, gallery, labels, emb, images, serve, idx_exact, dev, launches, smi):
    """``match='sharded'``, both scans, over ``SHARDS`` shards and one; the
    packed scan at a shard's shape. Returns (rows, the scan's report)."""
    import numpy as np
    import torch

    from fast_image_recognition_tpu_torch.kernels import build
    from fast_image_recognition_tpu_torch.ops import distance_kernel as dk
    from fast_image_recognition_tpu_torch.parallel import gallery_mesh
    from fast_image_recognition_tpu_torch.serving import RecognitionService

    rows, scan_report, exact_rows = [], {}, None
    for scan, s in (("exact", SHARDS), ("exact", 1), ("packed", SHARDS), ("packed", 1)):
        t = time.time()
        svc = RecognitionService(None, info, gallery, labels=labels, n_valid=GALLERY, serving_fn=serve, match="sharded",
                                 sharded_scan=scan, pca_dim=124, mesh=gallery_mesh(devices=[dev] * s), device=dev)
        torch.cuda.synchronize()
        build_s = time.time() - t
        if scan == "packed" and s > 1:  # the single-min scan at a shard's shape, tile_g 512
            with torch.no_grad():
                qa = dk._augment_queries((emb - svc._mu) @ svc._w, svc.pca_dim, svc._gal_aug[0].shape[1])
            check_single_scan("shard", qa, svc._gal_aug[0], 512, scan_report)
        build.reset_launch_counts()
        out = svc.identify_device(images).cpu().numpy()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out_sync = svc.identify_device(images)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ms = host_ms(lambda: svc.identify_device(images), TIMED_CALLS)
        path = f"sharded {scan} x{s}"
        check_launches(path, launches, **{"topk_l2" if scan == "exact" else "tilemin_packed": s * (TIMED_CALLS + 2)})
        if not np.array_equal(out, out_sync.cpu().numpy()) or not ((out >= 0) & (out < GALLERY)).all():
            raise AssertionError(f"{path}: rows outside the gallery or changed under sync debug mode")
        if scan == "exact" and not rows_tie_ok(emb, gallery, out, idx_exact):
            raise AssertionError(f"{path} differs from match='exact' beyond near-ties")
        exact_rows = out if exact_rows is None else exact_rows
        row = dict(line=path, img_s=BATCH / ms * 1e3, ms=ms, build_s=build_s, shard_rows=int(svc.gallery[0].shape[0]),
                   error_pct=100.0 * float(np.mean(labels[out] != np.arange(BATCH))),
                   exact_rows_equal_pct=100.0 * float(np.mean(out == idx_exact)),
                   sharded_exact_rows_equal_pct=100.0 * float(np.mean(out == exact_rows)))
        rows.append(row)
        phase(f"{path} (shards of {row['shard_rows']} rows, built in {build_s:.1f} s): {row['img_s']:.1f} img/s "
              f"({ms:.2f} ms a batch of {BATCH}, {smi}), error {row['error_pct']:.3f}%, rows equal to match='exact' "
              f"{row['exact_rows_equal_pct']:.3f}% (sharded exact {row['sharded_exact_rows_equal_pct']:.3f}%); no host "
              f"sync in identify_device; launches {launches[path]}")
        del svc
    return rows, scan_report


def run_sharded_matcher(gal_bf, q_bf, idx_bf, idx_oracle_bf, launches, smi):
    """``ShardedGalleryMatcher``, bf16 and precise, vs the unsharded scans."""
    import numpy as np

    from fast_image_recognition_tpu_torch.kernels import build
    from fast_image_recognition_tpu_torch.parallel import ShardedGalleryMatcher, gallery_mesh

    rows = []
    for precise, want, kernel in ((False, idx_bf, "topk_l2"), (True, idx_oracle_bf, "topk_l2_precise_f32")):
        m = ShardedGalleryMatcher(gal_bf[:GALLERY], gallery_mesh(devices=[q_bf.device] * SHARDS), precise=precise)
        build.reset_launch_counts()
        idx = m.search_device(q_bf)[1][:, 0]
        ms = cuda_ms(lambda: m.search_device(q_bf), 3)
        path = "sharded matcher" + (" precise" if precise else "")
        check_launches(path, launches, **{kernel: SHARDS * 5})
        ok = rows_tie_ok(q_bf, gal_bf, idx, want, rel=0.0 if precise else 2.0**-12, abs_=2.0**-16 * precise,
                         precise=precise)
        idx = idx.cpu().numpy()
        row = dict(line=path, queries_s=BATCH / ms * 1e3, ms=ms, shard_gib=sum(g.nbytes for g in m.gallery) / 2**30,
                   rows_equal_pct=100.0 * float(np.mean(idx == np.asarray(want))),
                   error_pct=100.0 * float(np.mean(idx != np.arange(BATCH))))
        rows.append(row)
        phase(f"{path} ({SHARDS} shards, {row['shard_gib']:.2f} GiB, {BATCH} x {GALLERY} x {q_bf.shape[1]}): "
              f"{row['queries_s']:.1f} queries/s ({ms:.3f} ms, CUDA events, {smi}), rows equal to the unsharded scan "
              f"{row['rows_equal_pct']:.3f}%, error {row['error_pct']:.3f}%; launches {launches[path]}")
        if not ok:
            raise AssertionError(f"{path} differs from the unsharded scan beyond near-ties")
        del m
    return rows


def run_ann_matchers(g, gl, p, pl, dev, launches, smi):
    """sw, proj and the kd-forest at budget 1 % vs CPU runs of their
    searches; sw's graph vs a build on the plain ``topk_l2``."""
    import numpy as np
    import torch

    from fast_image_recognition_tpu_torch.config import MatcherConfig
    from fast_image_recognition_tpu_torch.evaluation import evaluate_matcher
    from fast_image_recognition_tpu_torch.factory import build_matcher
    from fast_image_recognition_tpu_torch.kernels import build, plain
    from fast_image_recognition_tpu_torch.search import small_world as sw

    cfg = MatcherConfig(image_count_to_check=int(DEM_BUDGET * g.shape[0]))
    q, rows = p[:ANN_PROBES], []
    for method in ("sw", "proj", "kdtree"):
        t = time.time()
        build.reset_launch_counts()
        m = Recording(build_matcher(method, g, gl, cfg, seed=0, device=dev))
        m.set_budget(cfg.image_count_to_check)  # the factory leaves the kd-forest unbudgeted, as JAX's
        torch.cuda.synchronize()
        build_s, n_build = time.time() - t, build.LAUNCHES["topk_l2"]
        res = evaluate_matcher(m, gl, q, pl[:ANN_PROBES], verbose=False)
        cpu_m, extra = m.matcher, ""  # the kd-forest is host code: its run is the CPU run
        if method == "sw":
            if n_build != -(-g.shape[0] // 1024):
                raise AssertionError(f"the neighbour table took {n_build} topk_l2 launches")
            real = sw.topk_l2
            sw.topk_l2 = lambda qq, gg, k, n_valid: plain.topk_l2_plain(qq.to(torch.bfloat16), gg, k, n_valid)
            try:
                table = sw.build_neighbor_table(m.matcher.gallery, k_nn=11, k_rand=4, seed=0).long()
            finally:
                sw.topk_l2 = real
            got = m.matcher.neighbors.long()
            r, c = (got != table).nonzero(as_tuple=True)
            g64 = m.matcher.gallery.to(torch.bfloat16).to(torch.float64)
            d_got, d_want = (((g64[x[r, c]] - g64[r]) ** 2).sum(1) for x in (got, table))
            if not bool(((d_got - d_want).abs() <= ANN_TIE * d_want + 1e-6).all()):
                raise AssertionError("the neighbour table differs from the plain build beyond near-ties")
            cpu_m = object.__new__(type(m.matcher))  # the same graph and walk, on the CPU
            cpu_m.__dict__.update({k: v.cpu() if isinstance(v, torch.Tensor) else v
                                   for k, v in m.matcher.__dict__.items()}, device=torch.device("cpu"))
            extra = (f"; neighbour table from {n_build} topk_l2 launches (k=12), entries equal to the plain build "
                     f"{100.0 * (1 - len(r) / got.numel()):.4f}% (the rest near-ties)")
        elif method == "proj":
            cpu_m = build_matcher(method, g, gl, cfg, seed=0, device="cpu")
        equal = 100.0 * float(np.mean(m.last.indices == cpu_m.search(q).indices))
        rows.append(dict(line=method, name=m.name, error_pct=res.error_rate, ms_per_probe=res.ms_per_image,
                         checked_pct=res.checked_percent, build_s=build_s, cpu_rows_equal_pct=equal))
        phase(f"build_matcher('{method}') ({g.shape[0]} x {g.shape[1]}, budget {cfg.image_count_to_check}, built in "
              f"{build_s:.1f} s): {res.summary()} ({smi}); rows equal to its CPU run {equal:.2f}%{extra}")
        if equal < 97.0:
            raise AssertionError(f"{method}: card rows equal the CPU run's on {equal:.2f}% < 97% of probes")
        del m, cpu_m
    return rows


def run_classifiers(gal, glab, probes, plab, dev, smi):
    """k-NN, PNN, FPNN and ``verification_test`` vs CPU runs."""
    import copy

    import numpy as np

    from fast_image_recognition_tpu_torch.classifiers import FPNNClassifier, KNNClassifier, PNNClassifier
    from fast_image_recognition_tpu_torch.evaluation.verification import verification_test

    c, sel = int(glab.max()) + 1, glab < VERIF_CLASSES

    def fitted(d):  # brute force and sequential on one fit
        out = []
        for clf in (KNNClassifier(1, c, device=d), KNNClassifier(3, c, device=d), PNNClassifier(c, device=d),
                    FPNNClassifier(c, device=d)):
            out.append(clf.fit(gal, glab))
            if hasattr(clf, "bruteforce"):
                seq = copy.copy(clf)
                seq.bruteforce, seq.name = False, clf.name + " (seq)"
                out.append(seq)
        return out

    rows = []
    for clf, cpu in zip(fitted(dev), fitted("cpu")):
        pred = clf.predict(probes)
        ms = host_ms(lambda: clf.predict(probes), 2)
        equal = pred[:CLS_CPU_PROBES] == cpu.predict(probes[:CLS_CPU_PROBES])
        rows.append(dict(line=clf.name, error_pct=100.0 * float(np.mean(pred != plab)), ms_per_probe=ms / len(probes),
                         cpu_equal_pct=100.0 * float(equal.mean())))
        phase(f"{clf.name} ({gal.shape[0]} x {gal.shape[1]}, {c} classes, {len(probes)} probes): error "
              f"{rows[-1]['error_pct']:.3f}%, {rows[-1]['ms_per_probe']:.5f} ms/probe (host clock, 2 calls, {smi}); "
              f"predictions equal to the CPU run's on {int(equal.sum())} of {CLS_CPU_PROBES}")
        if not equal.all():
            raise AssertionError(f"{clf.name}: card predictions differ from the CPU run's")
    t = time.time()
    r = verification_test(gal[sel], glab[sel], tests=10, end=VERIF_DIM, verbose=False, device=dev)
    sec = time.time() - t
    rc = verification_test(gal[sel], glab[sel], tests=10, end=VERIF_DIM, verbose=False, device="cpu")
    rows.append(dict(line=r.name, rows=int(sel.sum()), error_pct=r.error_rate, sigma=r.extras["sigma"], seconds=sec,
                     cpu_error_pct=rc.error_rate))
    phase(f"{r.name} over {int(sel.sum())} rows of {VERIF_CLASSES} classes (10 splits): error {r.error_rate:.4f}%, "
          f"sigma {r.extras['sigma']:.4f}, {sec:.1f} s ({smi}); the CPU run {rc.error_rate:.4f}%")
    if abs(r.error_rate - rc.error_rate) > 100.0 / int(sel.sum()):
        raise AssertionError("verification_test on the card differs from its CPU run beyond one probe")
    return rows

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
    libs = build.build()
    entries = {n: re.findall(r"Compiling entry function '(\S+)'", log) for n, log in build.BUILD_LOG.items()}
    names = kernel_names([e for v in entries.values() for e in v])
    for name, log in build.BUILD_LOG.items():
        kernel = spill = ""
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = names[m.group(1)]
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                print(f"  ptxas {name} {kernel}: {line.split(':', 1)[-1].strip()}; {spill}", flush=True)
    phase(f"built {sorted(build.SOURCES)} with nvcc in {time.time() - t:.1f} s (each source: "
          + ", ".join(f"{n} {sec:.1f} s" for n, sec in sorted(build.BUILD_SECONDS.items())) + ")")
    # the kernels on the Hopper main loop issue wgmma and no WMMA
    mma_by_lib = sass_mma_counts(libs)
    mma = {k: v for counts in mma_by_lib.values() for k, v in counts.items()}
    sm90 = {k: v for k, v in mma.items() if "_sm90" in k}
    families = ("topk_pass1_sm90", "topk_pass1_split_sm90", "topk_pass1_split6_sm90", "tilemin_packed_sm90",
                "tilemin_quant_sm90", "tilemin_sm90", "tilemin_quant_bf16_sm90", "mbconv_sm90")
    if not all(any(k.startswith(f) for k in sm90) for f in families) or not all(
            v["HGMMA"] + v["IGMMA"] > 0 and v["HMMA"] == v["IMMA"] == 0 for v in sm90.values()):
        raise AssertionError(f"a kernel of the sm90 main loop does not run on wgmma alone: {sm90}")
    topk_lib = build._lib("topk_l2")
    if topk_lib.topk_l2_max_k() != build.TOPK_MAX_K:
        raise AssertionError("kernels/topk_l2.cu and build.TOPK_MAX_K disagree on the largest k")
    if any(topk_lib.topk_l2_segment_rows(p, k) != build.topk_l2_segment_rows_for(bool(p), k)
           for p in (0, 1) for k in (1, 16, 17, build.TOPK_MAX_K)):
        raise AssertionError("kernels/topk_l2.cu and build.topk_l2_segment_rows_for disagree on segment rows")
    if topk_lib.topk_l2_query_rows() != build.TOPK_QUERY_ROWS or any(
            topk_lib.topk_l2_split_smem(k) != build.topk_l2_split_smem_for(k)
            or topk_lib.topk_l2_split6_smem(k) != build.topk_l2_split6_smem_for(k) for k in (1, 2, 16, 17, 256)):
        raise AssertionError("kernels/topk_l2.cu and build's split-pass mirrors disagree (query rows, ring sizes)")
    # no scan of the tile-scan library and no MBConv kernel is left on WMMA
    for lib in ("tile_scan", "mbconv"):
        if any(v["HMMA"] + v["IMMA"] for v in mma_by_lib[lib].values()):
            raise AssertionError(f"kernels/{build.SOURCES[lib]} still issues HMMA/IMMA: {mma_by_lib[lib]}")
    phase("SASS tensor-core instructions per kernel, HGMMA/IGMMA (wgmma) and HMMA/IMMA (WMMA's mma.sync): "
          + "; ".join(f"{k} {v['HGMMA']}/{v['IGMMA']}/{v['HMMA']}/{v['IMMA']}" for k, v in sorted(mma.items())
                      if any(v.values())))
    pad_pairs = check_edge_shapes(dev)
    phase(f"edge shapes {EDGE_SHAPES}: every kernel agrees with its plain version; {pad_pairs} (query, "
          f"whole-pad tile) minima bit-equal to the plain ones (BIG_DIST with fp32 scores, inf with bf16)")
    n_cases = check_sm90_edges(dev)
    phase(f"sm90 scan edges: {sum(n_cases.values())} cases {n_cases} at the *_EDGES shapes (topk_l2 bf16, split "
          f"and six-product precise passes, k {list(TOPK_LARGE_K)}, both packed scans, the int8 and bf16 tile "
          f"scans) agree with their plain versions; no row past n_valid returned, no whole-pad tile won, "
          f"whole-pad tile minima bit-equal to the plain ones")
    n_slab = check_topk_slabs(dev)
    phase(f"topk_l2 in slabs: {n_slab} cases at k {list(TOPK_SLAB_K)} (bf16, precise over bf16 and fp32 rows, a "
          f"window, a row mask; 300 x 100,000 x 128) agree with the plain version in one pass")
    err_k, err_two = check_split_precise(dev)
    phase(f"split precise pass: query planes and |q|^2 read back equal plain.split_bf16x3 (the lo-zeroed control "
          f"differs); on queries whose lo terms add up, the kernel's distance is {err_k:.3e} from fp64 (tolerance "
          f"{SPLIT_PROBE_TOL:.3e}), the hi + mid product's {err_two:.3e} or more")
    err6, err_three = check_split6_precise(dev)
    phase(f"six-product pass over fp32 rows: on rows whose mid and lo terms add up, the kernel's distance is "
          f"{err6:.3e} from fp64 (tolerance {SPLIT_PROBE_TOL:.3e}), the three products of the bf16-row pass "
          f"{err_three:.3e} or more; query planes equal plain.split_bf16x3")
    big_grids = check_big_grids(dev)
    phase("grids past 65,535 blocks agree with the plain versions: " + "; ".join(big_grids))

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
    check_topk(gallery, GALLERY, probe_batch[:256], 16, report)
    check_topk(gallery, GALLERY, probe_batch[:256], 32, report)
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
    # the same oracle over fp32-stored rows (ShardedGalleryMatcher(precise=True)
    # stores them so), full 24-bit significands: the six-product pass,
    # checked and timed at the main path's shape, then one launch per call,
    # counted on its own
    gal32 = full_significand_rows(gallery, seed=5)
    check_topk(gal32, GALLERY, emb, 1, report, key="topk_l2_precise_f32", precise=True)
    build.reset_launch_counts()
    with torch.no_grad():
        idx_oracle32 = dk.topk_l2(emb, gal32, 1, n_valid=GALLERY, precise=True)[1][:, 0]
    torch.cuda.synchronize()
    check_launches("oracle_f32", launches, topk_l2_precise_f32=1)
    if not bool(((idx_oracle32 >= 0) & (idx_oracle32 < GALLERY)).all()):
        raise AssertionError("the oracle over fp32 rows returned rows outside the gallery")
    del gal32, idx_oracle32
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
    check_packed_service(info, gallery, labels, emb, images, serve, dev, launches, report)
    # 6'. match='sharded', both scans, over four shards on the card and one
    sharded_rows, shard_scan = run_sharded_service(info, gallery, labels, emb, images, serve, idx_exact, dev,
                                                   launches, smi)

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
        f"scan kernel {r['kernel_ms']:.3f} ms (bound {r['bound_ms']:.3f} ms, {r['bound_by']})" for r in per_level))

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

    # 11a. select='approx' (JAX lax.approx_min_k): the exact selection on the
    # card, which turns the certificate off, so the single-min packed scan
    # and the rescore, equal row for row to escalate=None with select='exact'
    t = time.time()
    svc_apx = RecognitionService(None, info, gallery, labels=labels, n_valid=GALLERY, serving_fn=serve,
                                 pca_dim=124, pca_scan="packed", select="approx", device=dev)
    torch.cuda.synchronize()
    apx_build_s = time.time() - t
    build.reset_launch_counts()
    idx_apx = svc_apx.identify_device(images)
    torch.cuda.synchronize()
    t = time.time()
    for _ in range(TIMED_CALLS):
        idx_apx = svc_apx.identify_device(images)
    torch.cuda.synchronize()
    apx_sec = (time.time() - t) / TIMED_CALLS
    check_launches("pca_approx", launches, tilemin_packed=TIMED_CALLS + 1)
    idx_apx = idx_apx.cpu().numpy()
    apx_row = dict(line="service approx-select", img_s=BATCH / apx_sec, ms=1e3 * apx_sec,
                   error_pct=100.0 * float(np.mean(labels[idx_apx] != truth)),
                   agreement_pct=100.0 * float(np.mean(idx_apx == idx_oracle)),
                   rows_equal_exact_select_pct=100.0 * float(np.mean(idx_apx == idx_none)))
    phase(
        f"service approx-select (PCA-{svc_apx.pca_dim} packed, rescore {svc_apx.rescore}, select='approx', "
        f"built in {apx_build_s:.1f} s): {apx_row['img_s']:.1f} img/s ({apx_row['ms']:.1f} ms/batch, {smi}), "
        f"identity error {apx_row['error_pct']:.3f}%, agreement with the fp32 oracle {apx_row['agreement_pct']:.3f}%, "
        f"rows equal to select='exact' escalate=None {apx_row['rows_equal_exact_select_pct']:.3f}%; launches "
        f"{launches['pca_approx']}"
    )
    if svc_apx.escalate is not None or not np.array_equal(idx_apx, idx_none):
        raise AssertionError("select='approx' differs from the exact selection's uncertified service")
    del svc_none, svc_apx
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
    gal_bf32 = full_significand_rows(gal_bf, seed=6)  # the oracle over fp32 rows at x 1536
    check_topk(gal_bf32, GALLERY, q_bf, 1, report, key="topk_l2_precise_f32", precise=True)
    del gal_bf32
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

    # 13'. ShardedGalleryMatcher over the same rows, bf16 and precise
    sharded_matcher_rows = run_sharded_matcher(gal_bf, q_bf, bf_found["bf"], idx_oracle_bf, launches, smi)

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

    # 18-21. bench.py's dem, video and cascade configs, and TWD
    feature_lines = run_feature_configs(dev, launches, smi)

    src = "fast_image_recognition_tpu_torch/kernels/"

    def first(entries):
        return {k: entries[0][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}

    def by_path(name):
        return {p: c[name] for p, c in launches.items()}

    rows = [
        dict(name="tilemin2_packed", route="cuda", source=src + "packed_scan.cu",
             replaces="fast_image_recognition_tpu/ops/distance_kernel.py:393",
             launches=launches["pca"]["tilemin2_packed"], launches_by_path=by_path("tilemin2_packed"),
             **first(report["tilemin2_packed"]), shapes=report["tilemin2_packed"]),
        dict(name="topk_l2", route="cuda", source=src + "topk_l2.cu",
             replaces="fast_image_recognition_tpu/ops/distance_kernel.py:92",
             launches=launches["pca"]["topk_l2"], launches_by_path=by_path("topk_l2"),
             empty_mask_ms=masked_empty_ms, **first(report["topk_l2"]), shapes=report["topk_l2"]),
        dict(name="tilemin_packed", route="cuda", source=src + "packed_scan.cu",
             replaces="fast_image_recognition_tpu/ops/distance_kernel.py:350",
             launches=launches["cascade"]["tilemin_packed"], launches_by_path=by_path("tilemin_packed"),
             **{k: scan_report["shapes"][0][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
             library_ms=None, shapes=scan_report["shapes"] + shard_scan["shapes"], per_level=scan_report["per_level"]),
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
             kernel="split_queries + topk_pass1_split_sm90 (bf16 rows; three bf16 wgmma products)",
             launches=launches["oracle"]["topk_l2_precise"], launches_by_path=by_path("topk_l2_precise"),
             **first(report["topk_l2_precise"]), shapes=report["topk_l2_precise"]),
        dict(name="topk_l2_precise_f32", route="cuda", source=src + "topk_l2.cu",
             replaces="fast_image_recognition_tpu/ops/distance_kernel.py:92 (precise=True, fp32 rows)",
             kernel="split_queries + topk_pass1_split6_sm90 (fp32 rows split on the chip; six bf16 wgmma products)",
             launches=launches["oracle_f32"]["topk_l2_precise_f32"], launches_by_path=by_path("topk_l2_precise_f32"),
             **first(report["topk_l2_precise_f32"]), shapes=report["topk_l2_precise_f32"]),
        dict(name="topk_l2_windowed", route="cuda", source=src + "topk_l2.cu",
             replaces="fast_image_recognition_tpu/ops/distance_kernel.py:92 (window)",
             launches=launches["bf_windowed"]["topk_l2_windowed"], launches_by_path=by_path("topk_l2_windowed"),
             **first(report["topk_l2_windowed"]), shapes=report["topk_l2_windowed"]),
        dict(name="mbconv", route="cuda", source=src + "mbconv.cu",
             replaces="fast_image_recognition_tpu/ops/mbconv_kernel.py:82",
             launches=launches["fused"]["mbconv"], launches_by_path=by_path("mbconv"),
             kernel="mbconv_sm90 (one launch per block)",
             shape=f"the 12 stride-1 blocks of B0@{RES} at B={BATCH}, summed",
             max_abs_err=max(r["max_abs_err"] for r in mb_report["blocks"]),
             ms=mb_report["total"]["ms"], plain_ms=mb_report["total"]["plain_ms"],
             bound_ms=mb_report["total"]["bound_ms"],
             bound_by=max(("operations", "bytes"), key=lambda by: sum(
                 r["bound_ms"] for r in mb_report["blocks"] if r["bound_by"] == by)),
             library_ms=None, yardstick_per_op_ms=mb_report["total"]["per_op_ms"],
             blocks=mb_report["blocks"], edges=mb_report["edges"]),
        chi2_row,
    ]
    print(json.dumps({"lines": {"service_modes": mode_rows, "approx_select": apx_row, "bf": bf_rows,
                                "partial_escalation": esc_rows, "fused_path": fused_row, "s2d_stem": s2d_row,
                                "sharded_service": sharded_rows, "sharded_matcher": sharded_matcher_rows,
                                **chi2_lines, **feature_lines}}), flush=True)
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
