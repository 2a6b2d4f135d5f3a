#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from the
sources in the checkout with ``nvcc``, drives the main serving path at full
width (EfficientNet-B0 at 224 from the trained checkpoint, a 1M-row
class-structured gallery, PCA-124 certified packed scan, 48-row rescore,
exact escalation at slack 0.05, batch 1024), holds every kernel against its
plain PyTorch version on the main path's own tensors, and checks the
answers against the exact full-D match. The pick before escalation is held
against a plain rescore of its candidates, and a second 1M-row layout,
where the certificate clears, holds the certified answer itself against the
exact scan. Each path (the main path, ``match='exact'``, the planted layout)
counts its kernel launches on its own. One flushed line per phase, with
the seconds since start. The last line is ``{"ok": true, "device": ...}``;
any failure raises and the exit code is not 0. It needs one card and
imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

T0 = time.time()
BUDGET_S = 300.0  # a run takes well under a minute of command time
CKPT = os.path.join("benchmarks", "trained_b0_224_synthetic1024_s0.npz")
GALLERY = 1_000_000
IDENTITIES = 4096
BATCH = 1024
TIMED_CALLS = 5
# published dense peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
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
    """Host-clock mean of ``fn()`` ending in a device sync."""
    import torch

    t = time.time()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.time() - t) / reps * 1e3


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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


def check_topk(gallery, n_valid, queries, k, report=None):
    """topk_l2 kernel vs its plain version on the main path's gallery."""
    import torch

    from fast_image_recognition_tpu_torch.kernels import build, plain

    q = queries.to(torch.bfloat16).contiguous()
    kd, ki = build.launch_topk_l2(q, gallery, k, n_valid)
    pd, pi = plain.topk_l2_plain(q, gallery, k, n_valid)
    torch.cuda.synchronize()
    err = (kd - pd).abs().max().item()
    idx_eq = (ki == pi).float().mean().item()
    # the kernel's rows, rescored here: each must sit at the distance the
    # kernel reports, and a row may differ from the plain pick only where
    # the two tie within fp32 sum-order rounding (2^-12 relative)
    in_range = bool(((ki >= 0) & (ki < n_valid)).all())
    rows = gallery[ki.clamp(0, n_valid - 1).long()].to(torch.float32)  # [B, k, D]
    qf = q.to(torch.float32)
    d_rows = torch.clamp_min(
        (qf * qf).sum(1)[:, None] + (rows * rows).sum(2) - 2.0 * torch.einsum("bd,bkd->bk", qf, rows), 0.0
    )
    del rows
    tol = 2.0**-12 * pd.abs() + 1e-6
    ok = in_range and bool(((ki == pi) | ((d_rows - pd).abs() <= tol)).all())
    ok = ok and bool(((kd - d_rows).abs() <= tol).all())
    b, dim = q.shape
    ms = cuda_ms(lambda: build.launch_topk_l2(q, gallery, k, n_valid), reps=3)
    plain_ms = cuda_ms(lambda: plain.topk_l2_plain(q, gallery, k, n_valid), reps=1)
    g = gallery[:n_valid]
    yard_ms = cuda_ms(lambda: torch.topk(q @ g.T, k, dim=1), reps=1)
    b_ms, b_by = bound(2.0 * b * n_valid * dim, n_valid * dim * 2 + b * dim * 2 + b * k * 8)
    phase(
        f"topk_l2 B={b} N={n_valid} D={dim} k={k}: indices equal {100 * idx_eq:.3f}%, "
        f"max |d| gap {err:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"matmul+topk yardstick {yard_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})"
    )
    if not ok:
        raise AssertionError(f"topk_l2 kernel (k={k}) disagrees with its plain version")
    if report is not None:
        report["topk_l2"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None, yardstick_matmul_topk_ms=yard_ms,
        )


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
    from fast_image_recognition_tpu_torch.serving import RecognitionService
    from fast_image_recognition_tpu_torch.utils.checkpoint import load_variables

    # 1. environment
    dev = default_device()
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

    # 3. workload: trained B0@224, unseen identities rendered on the card
    t = time.time()
    variables = load_variables(CKPT)
    info = backbone_info("b0")
    serve = make_serving_fn(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]},
        info, device=dev,
    )
    phase(f"loaded and folded {CKPT} in {time.time() - t:.1f} s")
    t = time.time()
    pair_imgs, _ = device_dataset(IDENTITIES, 2, 224, seed=11000, class_seed=3000, device=dev)
    with torch.no_grad():
        embs = torch.cat([serve(pair_imgs[s : s + BATCH])["embedding"] for s in range(0, 2 * IDENTITIES, BATCH)])
    embs = embs / torch.clamp_min(torch.linalg.vector_norm(embs, dim=1, keepdim=True), 1e-30)
    enroll, probe_emb = embs[0::2].contiguous(), embs[1::2].contiguous()
    sigma = float(torch.linalg.vector_norm(enroll - probe_emb, dim=1).median()) / math.sqrt(2.0)
    images = pair_imgs[1 : 2 * BATCH : 2].contiguous()  # instance 1 of identities 0..BATCH-1
    del pair_imgs
    torch.cuda.synchronize()
    phase(f"rendered and embedded {2 * IDENTITIES} images at 224 in {time.time() - t:.1f} s, sigma {sigma:.4f}")
    t = time.time()
    gallery, labels = class_structured_gallery(GALLERY, enroll, sigma)
    svc = RecognitionService(None, info, gallery, labels=labels, n_valid=GALLERY, serving_fn=serve, device=dev)
    exact = RecognitionService(None, info, gallery, labels=labels, n_valid=GALLERY, serving_fn=serve,
                               match="exact", device=dev)
    torch.cuda.synchronize()
    phase(f"gallery {tuple(gallery.shape)} bf16, PCA-{svc.pca_dim} fit and packed in {time.time() - t:.1f} s")

    # 4. each kernel against its plain version at the main path's shapes
    report = {}
    probe_batch = svc.embed(images)
    check_cert_scan(svc, probe_batch, report)
    check_topk(gallery, GALLERY, probe_batch, 1, report)
    check_topk(gallery, GALLERY, probe_batch[:256], 16)

    # 5. the main path: warm-up and timed calls, counted on their own
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
    launches = {"pca": dict(build.LAUNCHES)}
    esc_calls = sum(bool(m.any()) for m in masks)
    esc_share = svc.last_escalated.float().mean().item()
    expect = {"tilemin2_packed": len(masks) * -(-BATCH // 1024), "topk_l2": esc_calls}
    if launches["pca"] != expect:
        raise AssertionError(f"main path launches {launches['pca']}, expected {expect}")
    for name, n in launches["pca"].items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # 6. match='exact' on the same batch, counted on its own
    build.reset_launch_counts()
    idx_exact = exact.identify_device(images)
    torch.cuda.synchronize()
    launches["exact"] = dict(build.LAUNCHES)
    if launches["exact"] != {"tilemin2_packed": 0, "topk_l2": 1}:
        raise AssertionError(f"match='exact' launches {launches['exact']}")
    with torch.no_grad():
        emb = svc.embed(images)
        embed_ms = host_ms(lambda: svc.embed(images), TIMED_CALLS)
        match_ms = host_ms(lambda: svc._match_emb(emb), TIMED_CALLS)
        exact_ms = host_ms(lambda: exact._match_emb(emb), TIMED_CALLS)
        fast_agree_pct = check_certified_pick(svc, emb, idx_exact)
    idx, idx_exact = idx.cpu().numpy(), idx_exact.cpu().numpy()
    if idx.shape != (BATCH,) or not ((idx >= 0) & (idx < GALLERY)).all():
        raise AssertionError("main path returned rows outside the gallery")
    truth = np.arange(BATCH)
    err_pct = 100.0 * float(np.mean(labels[idx] != truth))
    agree_pct = 100.0 * float(np.mean(idx == idx_exact))
    label_agree_pct = 100.0 * float(np.mean(labels[idx] == labels[idx_exact]))
    exact_err_pct = 100.0 * float(np.mean(labels[idx_exact] != truth))
    phase(
        f"main path: {BATCH / sec:.1f} img/s ({1e3 * sec:.1f} ms/batch of {BATCH}, {smi}), "
        f"identity error {err_pct:.3f}% (exact match {exact_err_pct:.3f}%), top-1 agreement "
        f"with match='exact' {agree_pct:.3f}% rows / {label_agree_pct:.3f}% labels, "
        f"escalated {100 * esc_share:.2f}% of probes ({esc_calls} of {len(masks)} calls); "
        f"pick before escalation agrees {fast_agree_pct:.3f}%; launches {launches}"
    )
    phase(
        f"breakdown per batch of {BATCH}: embed {embed_ms:.1f} ms, pca match "
        f"{match_ms:.1f} ms (match='exact' alone {exact_ms:.1f} ms); peak device "
        f"memory {peak_gib:.2f} GiB"
    )
    if agree_pct < 99.0:
        raise AssertionError(f"top-1 agreement with match='exact' is {agree_pct:.3f}% < 99%")
    del svc, exact, gallery

    # 7. the match on a layout where the certificate clears, counted on its own
    t = time.time()
    probes, gal_p, planted = planted_gallery(GALLERY, BATCH, enroll.shape[1], dev)
    svc_p = RecognitionService(None, info, gal_p, n_valid=GALLERY, serving_fn=serve, device=dev)
    build.reset_launch_counts()
    with torch.no_grad():
        idx_p = svc_p._match_emb(probes)
    torch.cuda.synchronize()
    launches["pca_planted"] = dict(build.LAUNCHES)
    esc_p = svc_p.last_escalated
    if launches["pca_planted"] != {"tilemin2_packed": 1, "topk_l2": int(bool(esc_p.any()))}:
        raise AssertionError(f"planted layout launches {launches['pca_planted']}")
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
    del svc_p, gal_p

    src = "fast_image_recognition_tpu_torch/kernels/"
    rows = [
        dict(name="tilemin2_packed", route="cuda", source=src + "packed_scan.cu",
             replaces="fast_image_recognition_tpu/ops/distance_kernel.py:393",
             launches=launches["pca"]["tilemin2_packed"],
             launches_by_path={p: c["tilemin2_packed"] for p, c in launches.items()},
             **report["tilemin2_packed"]),
        dict(name="topk_l2", route="cuda", source=src + "topk_l2.cu",
             replaces="fast_image_recognition_tpu/ops/distance_kernel.py:92",
             launches=launches["pca"]["topk_l2"],
             launches_by_path={p: c["topk_l2"] for p, c in launches.items()},
             **report["topk_l2"]),
    ]
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi_line(), flush=True)
    phase("done")
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
