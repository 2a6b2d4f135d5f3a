#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one H100, from a checkout's root:
builds the kernels, holds each to its plain version, drives every path at full
width counting launches; prints the kernels' JSON, the card, ``{"ok": true}``."""

from __future__ import annotations

import copy
import json
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
try:
    from fast_image_recognition_tpu_torch.cascade.engine import SequentialInferencePipeline
    from fast_image_recognition_tpu_torch.data.synthetic_device import device_dataset
    from fast_image_recognition_tpu_torch.evaluation import evaluate_matcher
    from fast_image_recognition_tpu_torch.kernels import build, plain
    from fast_image_recognition_tpu_torch.models import (InceptionResNetV2, backbone_info, create_backbone,
        create_efficientnet, default_taps, default_taps_inception_resnet, default_taps_mobilenet, default_taps_resnet)
    from fast_image_recognition_tpu_torch.models.efficientnet import MEAN_RGB, STDDEV_RGB, TF_MODE_MEAN, TF_MODE_STD
    from fast_image_recognition_tpu_torch.models.fold import make_serving_fn
    from fast_image_recognition_tpu_torch.models.inference import make_infer_fn
    from fast_image_recognition_tpu_torch.models.train import MultiExitTrainer, TrainConfig, class_weights
    from fast_image_recognition_tpu_torch.models import pruning as pr
    from fast_image_recognition_tpu_torch.ops import distance_kernel as dk
    from fast_image_recognition_tpu_torch.ops import mbconv_kernel as mb
    from fast_image_recognition_tpu_torch.ops.quant import quantize_rows
    from fast_image_recognition_tpu_torch.serving import RecognitionService, _normalize, build_cascade_service
    from fast_image_recognition_tpu_torch.utils.checkpoint import load_variables
    from fast_image_recognition_tpu_torch.utils.flops import fn_flops
    from fast_image_recognition_tpu_torch.utils.profiling import cuda_ms, time_jitted, timed as _timed, trace_call
except ImportError:
    sys.exit("chip_smoke: run it from the root of a checkout of the repository")

T0 = time.time()
F32, BF16 = torch.float32, torch.bfloat16
BUDGET_S = 600.0  # half the 1200 s a run may take
CKPT = os.path.join("benchmarks", "trained_b0_224_synthetic1024_s0.npz")
IRV2_CKPT = os.path.join("benchmarks", "trained_inception_resnet_v2_224_synthetic1024_s0.npz")  # the flagship line
FOLD_BATCH = 64
GALLERY = 1_000_000
IDENTITIES = 4096
BATCH = 1024
RES = 224
TIMED_CALLS = 5
TAPS = ["block3a", "block4a", "block5c"]  # bench.py's cascade exit taps
RATIO = 0.85  # bench.py --cascade-ratio
SLACK = 1.3  # bench.py --slack
NEAR_TIE = 2.0**-8  # exit-rule near-tie: margin within NEAR_TIE * d1
BF_DIM = 1536  # bench.py --config bf
BF_WINDOW = (256, 1024)  # a feature window of the bf gallery
# H100 SXM dense peaks at 700 W (data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_FP32_FLOPS = 67e12  # CUDA-core FMA, no tensor cores
PEAK_HBM_BYTES = 3.35e12


def fail(msg: str):
    raise AssertionError(msg)


sync = torch.cuda.synchronize


def gen_on(dev, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def kernel_times(launch, run_plain, flops, nbytes, reps, peak=None):
    """CUDA-event ms of a kernel and its plain version beside the bound (no library call computes them)."""
    b_ms, b_by = bound(flops, nbytes, peak or PEAK_BF16_FLOPS)
    return dict(ms=cuda_ms(launch, reps[0]), plain_ms=cuda_ms(run_plain, reps[1]), bound_ms=b_ms, bound_by=b_by,
            library_ms=None)


def times(t):
    return f"ms={t['ms']:.3f} plain={t['plain_ms']:.3f} bound={t['bound_ms']:.3f} ({t['bound_by']})"


def phase(msg: str) -> None:
    elapsed = time.time() - T0
    print(f"[{elapsed:7.1f}s] {msg}", flush=True)
    if elapsed > BUDGET_S:
        raise TimeoutError(f"smoke run over its {BUDGET_S:.0f} s budget")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed(fn, reps: int = TIMED_CALLS):
    return _timed(fn, reps)


def host_ms(fn, reps: int) -> float:
    return _timed(fn, reps)[1]


def no_sync(fn):
    """``fn()`` under sync debug "error": any host sync raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def counted(fn):
    """``fn()`` with the launch counts set to 0 just before it."""
    build.reset_launch_counts()
    return fn()


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_names(mangled: list) -> dict:
    """Mangled symbol -> name<template args> (``cu++filt``)."""
    if not mangled:
        return {}
    filt = os.path.join(os.path.dirname(build._nvcc()), "cu++filt")
    out = subprocess.run([filt, *mangled], capture_output=True, text=True, check=True, timeout=60)
    names = []
    for n in out.stdout.splitlines():
        # "void <unnamed>::name<(bool)0, (int)1024>(params)" -> "name<0, 1024>"
        n, depth = n.strip(), 0
        for i in range(len(n) - 1, -1, -1):  # cut the last (...) group
            depth += {")": 1, "(": -1}.get(n[i], 0)
            if depth == 0:
                n = n[:i]
                break
        n = re.sub(r"^void |\(anonymous namespace\)::|<unnamed>::|\((?:bool|int)\)", "", n)
        names.append(n)
    return dict(zip(mangled, names))


def sass_mma_counts(libs: dict) -> dict:
    """Per library and kernel, HGMMA/IGMMA and HMMA/IMMA counts in ``cuobjdump
    -sass``."""
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
    """Record ``path``'s launches since the reset: ``counts``, every other kernel 0."""
    launches[path] = dict(build.LAUNCHES)
    want = {k: counts.get(k, 0) for k in build.LAUNCHES}
    if launches[path] != want:
        fail(f"{path} launches {launches[path]}, expected {want}")


def since(t: float) -> str:
    return f"{time.time() - t:.1f} s"


def host(x) -> np.ndarray:
    return x.cpu().numpy()


def randn(gen, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device)


def pct(x) -> float:
    """100 x the mean of a bool array or tensor."""
    return 100.0 * float(x.float().mean() if torch.is_tensor(x) else np.mean(x))


def _unit(x):
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=1, keepdim=True), 1e-30)


def class_structured_gallery(n: int, class_embs, sigma: float, seed: int = 1):
    """bench.py's class-structured gallery: ~n/K rows normalize(e_c + sigma/sqrt(D) noise) an identity.
    (bf16 rows, labels, pads -1)."""
    k, dim = class_embs.shape
    dev = class_embs.device
    n_pad = -(-n // 1024) * 1024
    m = -(-n_pad // k)
    labels = np.repeat(np.arange(k, dtype=np.int64), m)[:n_pad]
    labels[n:] = -1
    lab = torch.as_tensor(np.maximum(labels, 0), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    gal = torch.empty((n_pad, dim), dtype=BF16, device=dev)
    chunk = 65536
    for s in range(0, n_pad, chunk):
        e = class_embs[lab[s : s + chunk]]
        rows = e + (sigma / math.sqrt(dim)) * torch.randn(e.shape, generator=gen, device=dev)
        inv = torch.rsqrt(torch.clamp_min((rows * rows).sum(dim=1), 1e-30))
        gal[s : s + chunk] = (rows * inv[:, None]).to(BF16)
    return gal, labels


def planted_gallery(n: int, b: int, dim: int, dev, seed: int = 2):
    """Probes and rows in a 96-d span: a planted row (noise 0.02), 40 distractors (0.5) a probe."""
    rank, distract = 96, 40
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    basis = torch.linalg.qr(randn(gen, dim, rank))[0].T  # [96, dim]

    def unit(x):
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)

    def in_span(m, scale):
        return (scale / math.sqrt(rank)) * randn(gen, m, rank) @ basis

    n_pad = -(-n // 1024) * 1024
    gal = torch.zeros((n_pad, dim), dtype=BF16, device=dev)
    for s in range(0, n, 65536):
        m = min(65536, n - s)
        gal[s : s + m] = unit(in_span(m, 1.0)).to(BF16)
    probes = unit(in_span(b, 1.0))
    perm = torch.randperm(n, generator=gen, device=dev)
    planted = perm[:b]
    gal[planted] = unit(probes + in_span(b, 0.02)).to(BF16)
    near = probes.repeat_interleave(distract, dim=0)
    gal[perm[b : b * (distract + 1)]] = unit(near + in_span(b * distract, 0.5)).to(BF16)
    return probes, gal, planted


def enroll_sigma(embs, pair_imgs):
    """Instance 0 enrolls, 1 probes: (enrolled, spread sigma, probe images)."""
    enroll = embs[0::2].contiguous()
    sigma = float(torch.linalg.vector_norm(enroll - embs[1::2], dim=1).median()) / math.sqrt(2.0)
    return enroll, sigma, pair_imgs[1 : 2 * BATCH : 2].contiguous()


def serve_line(tag, svc, exact, gallery, labels, images, launches, smi, flops):
    """A certified PCA line: timed calls, one with no host sync, ``match='exact'`` and the oracle counted;
    rows >= 99 % exact's; MFU."""
    names = (tag, "exact", "oracle") if tag == "pca" else (tag, f"{tag} exact", f"{tag} oracle")
    masks = []

    def call():
        out = svc.identify_device(images)
        masks.append(svc.last_escalated)
        return out

    torch.cuda.reset_peak_memory_stats()
    counted(call)
    idx, ms = timed(call)
    check_launches(names[0], launches, tilemin2_packed=len(masks) * -(-BATCH // 1024), topk_l2=len(masks))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if not bool((no_sync(lambda: svc.identify_device(images)) == idx).all()):
        fail(f"{tag}: the answers changed under sync debug mode")
    idx_exact = counted(lambda: exact.identify_device(images))
    sync()
    check_launches(names[1], launches, topk_l2=1)
    emb = svc._embed(images)
    embed_ms = host_ms(lambda: svc._embed(images), TIMED_CALLS)
    match_ms = host_ms(lambda: svc._match_emb(emb), TIMED_CALLS)
    exact_ms = host_ms(lambda: exact._match_emb(emb), TIMED_CALLS)
    pick_pct = check_certified_pick(svc, emb, idx_exact)
    idx_oracle = counted(lambda: dk.topk_l2(emb, gallery, 1, n_valid=svc.n_valid, precise=True)[1][:, 0])
    sync()
    check_launches(names[2], launches, topk_l2_precise=1)
    idx, idx_exact, idx_oracle = host(idx), host(idx_exact), host(idx_oracle)
    if idx.shape != (BATCH,) or not ((idx >= 0) & (idx < svc.n_valid)).all():
        fail(f"{tag} returned rows outside the gallery")
    truth = np.arange(BATCH)
    row = dict(img_s=BATCH / ms * 1e3, ms=ms, embed_ms=embed_ms, match_ms=match_ms, exact_match_ms=exact_ms,
            error_pct=pct(labels[idx] != truth), exact_error_pct=pct(labels[idx_exact] != truth),
            exact_rows_pct=pct(idx == idx_exact), exact_labels_pct=pct(labels[idx] == labels[idx_exact]),
            oracle_rows_pct=pct(idx == idx_oracle), exact_oracle_rows_pct=pct(idx_exact == idx_oracle),
            escalated_pct=pct(svc.last_escalated), escalated_calls=sum(bool(m.any()) for m in masks),
            calls=len(masks), pick_equal_exact_pct=pick_pct, peak_gib=peak_gib, launches=launches[names[0]],
            **mfu(flops + svc.match_flops(BATCH), ms))
    phase(f"{'main path' if tag == 'pca' else tag} (B={BATCH}, {smi}): " + kv(row, *row) + "; no host sync")
    if row["exact_rows_pct"] < 99.0:
        fail(f"{tag}: top-1 agreement with match='exact' is {row['exact_rows_pct']:.3f}% < 99%")
    return dict(row, idx=idx, idx_exact=idx_exact, idx_oracle=idx_oracle, emb=emb, sec=ms / 1e3)


def mfu(flops, ms):
    return dict(flops_per_iter=flops, mfu=flops / (ms / 1e3) / PEAK_BF16_FLOPS)


DRIFT_X = 5.0  # the served / folded=False bf16 drift from fp32: 0.94-1.82 on the card, up to 3.2 at 64 px (PERF.md)


def embed_flops(name, np_vars, info, res, serve, images, dev, gap=True, drift=None):
    """``fn_flops`` of the embed within 5 % of ``folded=False``'s (tests/test_flops.py:65-79); ``gap``: the
    embeddings within 0.02 of max |emb|, or, with a ``drift`` dict (a fine-tuned pruned B0's bf16 forwards drift
    past it), the fold within 1e-4 in fp32 and the served bf16 embedding within :data:`DRIFT_X` of the
    ``folded=False`` bf16 one's distance from the fp32 network (floor 0.02), which the fold's weights rounded
    through fp8 must miss. (flops, rel)."""
    unfolded = make_serving_fn(np_vars, info, resolution=res, device=dev, folded=False)
    ff, fu = fn_flops(serve, images), fn_flops(unfolded, images)
    if abs(ff - fu) > 0.05 * fu:
        fail(f"{name}: folded FLOPs {ff:.4e} off the unfolded {fu:.4e} by > 5 %")
    if not gap:
        return ff, None
    x = images[:FOLD_BATCH]
    ef, eu = serve(x)["embedding"], unfolded(x)["embedding"]
    rel = ((ef - eu).abs().max() / eu.abs().max()).item()
    if drift is not None:
        f32 = make_infer_fn(np_vars, info["variant"], resolution=res, dtype=F32, device=dev)(x)["embedding"]
        unfolded.net.dtype = F32  # the same module in fp32
        ref = unfolded(x)["embedding"]
        fp8 = copy.deepcopy(serve)
        for w in (*fp8.parameters(), *fp8.buffers()):
            if w.dtype == BF16:
                w.data = w.data.to(torch.float8_e4m3fn).to(BF16)
        drift.update(zip(("fp32_fold_rel", "folded_vs_fp32", "unfolded_vs_fp32", "fp8_control_vs_fp32"),
                (((a - ref).abs().max() / ref.abs().max()).item() for a in (f32, ef, eu, fp8(x)["embedding"]))))
        drift["limit"] = lim = max(0.02, DRIFT_X * drift["unfolded_vs_fp32"])
        if not drift["fp32_fold_rel"] <= 1e-4:
            fail(f"{name}: the fold misses the fp32 network by {drift['fp32_fold_rel']:.3e} > 1e-4")
        if not drift["folded_vs_fp32"] <= lim < drift["fp8_control_vs_fp32"]:
            fail(f"{name}: bf16 drifts from fp32 {drift} (the served one within the limit, the fp8 control past)")
    elif not rel <= 0.02:
        fail(f"{name}: folded and unfolded embeddings differ by {rel:.4f} > 0.02")
    return ff, rel


def line_services(name, info, emb, gallery, labels, serve, dev):
    """The certified service and ``match='exact'`` over finite embeddings."""
    if emb.shape[1:] != (info["embedding_dim"],) or not bool(torch.isfinite(emb).all()):
        fail(f"{name}: embeddings of shape {tuple(emb.shape)}, finite {bool(torch.isfinite(emb).all())}")
    kw = dict(labels=labels, n_valid=GALLERY, serving_fn=serve, device=dev)
    return (RecognitionService(None, info, gallery, pca_dim=124, pca_scan="packed", rescore=48, escalate=0.05, **kw),
            RecognitionService(None, info, gallery, match="exact", **kw))


def run_flagship(dev, report, launches, smi):
    """bench.py ``--variant inception_resnet_v2 --resolution 224``: the trained IRv2 over 1M rows, B = 1024."""
    t = time.time()
    raw = load_variables(IRV2_CKPT)
    np_vars = {"params": raw["params"], "batch_stats": raw["batch_stats"]}
    info = backbone_info("inception_resnet_v2")
    serve = make_serving_fn(np_vars, info, resolution=RES, device=dev)
    sync()
    load_s, t = time.time() - t, time.time()
    pair_imgs, _ = device_dataset(IDENTITIES, 2, RES, seed=11000, class_seed=3000, device=dev)
    flops, fold_rel = embed_flops("flagship", np_vars, info, RES, serve, pair_imgs[:BATCH], dev)
    embs = _unit(torch.cat([serve(pair_imgs[s : s + BATCH])["embedding"] for s in range(0, 2 * IDENTITIES, BATCH)]))
    enroll, sigma, images = enroll_sigma(embs, pair_imgs)
    gallery, labels = class_structured_gallery(GALLERY, enroll, sigma)
    svc, exact = line_services("flagship", info, embs, gallery, labels, serve, dev)
    del pair_imgs, embs
    sync()
    phase(f"flagship: {IRV2_CKPT} folded ({load_s:.1f} s); images={2 * IDENTITIES}@{RES} sigma={sigma:.4f} "
          f"gallery={tuple(gallery.shape)} PCA-{svc.pca_dim} ({since(t)}); fold_rel={fold_rel:.5f}")
    emb = svc._embed(images)
    check_cert_scan(svc, emb, report)
    check_topk(gallery, GALLERY, emb, 1, report)
    row = serve_line("flagship", svc, exact, gallery, labels, images, launches, smi, flops)
    for k in ("idx", "idx_exact", "idx_oracle", "emb", "sec"):
        row.pop(k)
    row["trace"] = trace_line("flagship", lambda: svc.identify_device(images), "fprop")
    del svc, exact, gallery, serve
    torch.cuda.empty_cache()

    model = InceptionResNetV2().load_variables(np_vars).to(dev).eval()
    row["engine"] = engine_line("irv2 cascade engine", model, None, default_taps_inception_resnet(), dev, launches,
        engine="bind")[0]
    del model
    torch.cuda.empty_cache()
    return dict(row, fold_rel=fold_rel, sigma=sigma, checkpoint=IRV2_CKPT)


def embedding_gallery(n: int, emb, seed: int = 1, noise_frac: float = 0.2):
    """bench.py's planted gallery: rows around the probes' mean at their spread, a row a probe moved by
    ``noise_frac`` of its nearest-probe distance. (rows, labels)."""
    b, dim = emb.shape
    dev = emb.device
    gen = gen_on(dev, seed)
    e = emb.double()
    d2 = ((e * e).sum(1)[:, None] + (e * e).sum(1)[None] - 2.0 * e @ e.T).fill_diagonal_(math.inf)
    r = d2.min(1).values.clamp_min(1e-40).sqrt().float()
    planted = _unit(emb + noise_frac * r[:, None] * _unit(torch.randn(emb.shape, generator=gen, device=dev)))
    c = emb.mean(0)
    spread = max(float(((emb - c) ** 2).sum(1).mean().sqrt()), 1e-20)
    n_pad = -(-n // 1024) * 1024
    gal = torch.empty((n_pad, dim), dtype=BF16, device=dev)
    for s_ in range(0, n_pad, 65536):
        m = min(65536, n_pad - s_)
        gal[s_ : s_ + m] = _unit(c + spread * randn(gen, m, dim)).to(BF16)
    rows = torch.randperm(n, generator=gen, device=dev)[:b]
    gal[rows] = planted.to(BF16)
    labels = np.full(n_pad, -1, np.int64)
    labels[host(rows)] = np.arange(b)
    return gal, labels


def untrained_line(name, dev, launches, smi, res=RES):
    """bench.py's untrained e2e line for NAME (:378-387): seed-0 init, random probes."""
    images = torch.randint(0, 256, (BATCH, res, res, 3), generator=gen_on(dev, 0), device=dev, dtype=torch.uint8)
    return own_line(name, create_backbone(name, seed=0, resolution=res, device=dev)[1], backbone_info(name), images,
            dev, launches, smi, res)


def own_line(name, np_vars, info, images, dev, launches, smi, res=None, drift=None):
    """The certified line of ``np_vars`` over :func:`embedding_gallery` of its embeddings."""
    t, res = time.time(), res or RES
    serve = make_serving_fn(np_vars, info, resolution=res, device=dev)
    flops, fold_rel = embed_flops(name, np_vars, info, res, serve, images, dev, drift=drift)
    emb = _unit(serve(images)["embedding"])
    gallery, labels = embedding_gallery(GALLERY, emb)
    svc, exact = line_services(name, info, emb, gallery, labels, serve, dev)
    sync()
    phase(f"{name}@{res}: folded, gallery {tuple(gallery.shape)} PCA-{svc.pca_dim} ({since(t)}); fold_rel="
          f"{fold_rel:.5f} at B={FOLD_BATCH}" + "".join(f" {k}={v:.3e}" for k, v in (drift or {}).items()))
    row = serve_line(f"{name} line", svc, exact, gallery, labels, images, launches, smi, flops)
    ctx = {k: row.pop(k) for k in ("idx", "idx_exact", "idx_oracle", "emb", "sec")}
    row.update(fold_rel=fold_rel, **(drift or {}))
    return row, dict(ctx, info=info, np_vars=np_vars, serve=serve, svc=svc, gallery=gallery, labels=labels,
            images=images)


def run_mobilenets(dev, launches, smi, mb_report):
    """MobileNetV2's line, fused twin (13 ``mbconv`` a call), cascade and engine; MobileNetV1's line."""
    lines = {}
    lines["mobilenetv2"], c = untrained_line("mobilenetv2", dev, launches, smi)
    tf = dict(resolution=RES, fused=True, mean=TF_MODE_MEAN, std=TF_MODE_STD, device=dev)
    serve_f = make_infer_fn(c["np_vars"], "mobilenetv2", **tf)
    check_mbconv_blocks(c["serve"], serve_f, c["images"], mb_report)
    net14 = make_infer_fn(create_backbone("mobilenetv2_1.4", seed=0, device=dev)[1], "mobilenetv2_1.4", **tf)
    # one L1 round: the widths 96, 144, 288, 432, 720 at blocks 2b, 3b, 4b, 5b, 6b
    pruned = make_infer_fn(pr.prune_backbone(create_backbone("mobilenetv2", device=dev)[0], c["np_vars"])[1],
            "mobilenetv2", **tf)
    extra = []
    for tag, net, cases in (("mobilenetv2", serve_f, [("block1a", 1, 15), ("block2b", 130, 15), ("block5a", 130, 15),
            ("block6b", 130, 15), ("block7a", 130, 7)]), ("mobilenetv2_1.4", net14, [("block1a", 130,
            56), ("block4b", 130, 14), ("block5a", 130, 14), ("block5b", 1, 15), ("block7a", 130, 7)]),
            ("mobilenetv2 pruned", pruned, [(f"block{n}b", 130, 7 if n == 6 else 15) for n in range(2, 7)])):
        for block, b, hw in cases:
            fb = net.fused_blocks[str(net.names.index(block))]
            ce = fb.w_proj_t.shape[1]
            if tag.endswith("pruned") and ce != (96, 144, 288, 432, 720)[int(block[5]) - 2]:
                fail(f"the pruned MobileNetV2's {block} is {ce} wide")
            extra.append((f"{tag} {block} (relu6, no SE, ce={ce}) B={b} {hw}x{hw}", {n: getattr(fb, n) for n in
                    fb.param_names}, dict(fb.cfg), b, hw, None))
    mb_report["edges"] = run_mbconv_cases(extra, gen_on(dev, 29))
    phase(f"mobilenetv2 mbconv edge shapes (and its pruned widths): {len(extra)} cases within {MB_TOL:.2e} of max "
          f"|plain|, borders too")
    del net14, pruned
    lines["mobilenetv2_fused"] = check_fused_path(c["serve"], serve_f, c["svc"], c["info"], c["gallery"], c["labels"],
          c["images"], c["idx"], c["idx_oracle"], c["sec"], launches, dev, smi, lines["mobilenetv2"]["flops_per_iter"],
          path="mobilenetv2 fused", n_fused=13)
    del serve_f, c["svc"]
    t = time.time()
    casc = build_cascade_service("mobilenetv2", c["gallery"], variables=c["np_vars"], n_valid=GALLERY, taps=TAPS,
            resolution=RES, calib_total=CASCADE_CALIB, calib_batch=CASCADE_CALIB, device=dev)
    gen = gen_on(dev, 1)
    fracs = casc.calibrate(torch.randint(0, 256, (BATCH, RES, RES, 3), generator=gen, device=dev, dtype=torch.uint8),
            slack=SLACK)
    phase(f"mobilenetv2 cascade built (readout, taps {TAPS}, calibrated on {CASCADE_CALIB} images): survivors="
          f"{[round(f, 4) for f in fracs]} capacities={casc.capacities_for(BATCH)} ({since(t)})")
    lines["mobilenetv2_cascade"], _ = run_cascade(casc, c["images"], "mobilenetv2 cascade", launches, smi, c["labels"],
          dict(exact=c["idx_exact"]), plain_sec=c["sec"], early=False)
    del casc, c
    torch.cuda.empty_cache()
    model, variables = create_backbone("mobilenetv2", seed=0, resolution=RES, device=dev)
    row, _ = engine_line("mobilenetv2 cascade engine", model, variables, default_taps_mobilenet(), dev, launches)
    phase(f"mobilenetv2 cascade engine (folded, SVC exits, batch {BATCH}, {smi}): " + kv(row)
          + f"; no host sync; launches={launches['mobilenetv2 cascade engine']}")
    lines["mobilenetv2_cascade_engine"] = row
    del model, variables
    lines["mobilenetv1"], c = untrained_line("mobilenetv1", dev, launches, smi)
    del c
    torch.cuda.empty_cache()
    return lines


def run_zoo(dev, report, launches, smi):
    """The ResNet50, ResNet152V2, InceptionV3@299 and VGG19 lines; the bind engine over ResNet152V2."""
    lines = {}
    for name in ("resnet50", "resnet152v2", "inception_v3", "vgg19"):
        lines[name], c = untrained_line(name, dev, launches, smi, 299 if name == "inception_v3" else RES)
        check_topk(c["gallery"], GALLERY, c["emb"], 1, report if name in ("resnet152v2", "vgg19") else None)
        del c
        torch.cuda.empty_cache()
    model, _ = create_backbone("resnet152v2", seed=0, resolution=RES, device=dev)
    lines["resnet152v2_engine"] = engine_line("resnet152v2 cascade engine", model, None,
          default_taps_resnet("resnet152v2"), dev, launches, engine="bind")[0]
    return lines


# scripts/prune_serving_r5.py: two L1 rounds at 25 % to x16, each fine-tuned one epoch (cosine head)
PRUNE_COUNTS = (4_007_548, 3_092_892, 2_394_940)  # B0's parameters before and after each round
PRUNE_CLASSES, PRUNE_PER, PRUNE_VAL, PRUNE_BATCH, PRUNE_LR = 128, 48, 12, 128, 5e-4
PRUNE_CALIB, PRUNE_CPU, PRUNE_BLOCK = 32, 16, 15  # calibration images (2 a class), of them card vs CPU; block7a


def run_pruning(dev, np_vars, info, images, launches, smi, base):
    """prune_serving_r5.py:117-205 on the trained B0@224: the data metrics on the card, fp32 card vs CPU; per
    L1 round the fine-tune, the certified line and its fused twin (each pruned block vs plain)."""
    t0 = time.time()
    mean, std = (torch.tensor(v, device=dev) for v in (MEAN_RGB, STDDEV_RGB))
    prep = lambda x: (x - mean) / std  # noqa: E731
    tr_x, tr_y = device_dataset(PRUNE_CLASSES, PRUNE_PER, RES, seed=0, device=dev)  # train_serving_backbone's sets
    va_x, va_y = device_dataset(PRUNE_CLASSES, PRUNE_VAL, RES, seed=7919, class_seed=0, device=dev)
    pick = (np.arange(PRUNE_CALIB) // 2) * PRUNE_PER + np.arange(PRUNE_CALIB) % 2
    cx, cy = prep(tr_x[torch.as_tensor(pick, device=dev)].float()), tr_y[pick]
    net = create_efficientnet("b0", resolution=RES, device=dev)[0].load_variables(np_vars)
    out, mb, metric_s, seen = {}, {}, {}, {}
    n_blocks = sum(c["expand"] != 1 for c in net.plan_configs())
    for metric, fn in (("apoz", "apoz_hidden_scores"), ("class_sep", "class_sep_hidden_scores"),
            ("taylor", "taylor_importance")):
        t, f0, got = time.time(), getattr(pr, fn), seen.setdefault(metric, [])

        def recording(*a, f0=f0, got=got, **k):  # the scores it prunes by
            got.append(f0(*a, **k))
            return got[-1]

        setattr(pr, fn, recording)
        try:
            n = pr.parameter_count(pr.prune_backbone(net, np_vars, 0.25, metric, images=cx, labels=cy,
                    num_classes=PRUNE_CLASSES)[1])
        finally:
            setattr(pr, fn, f0)
        metric_s[metric] = time.time() - t
        if n != PRUNE_COUNTS[1] or len(got) != n_blocks:
            fail(f"prune_backbone by {metric} leaves {n} parameters, scored {len(got)} blocks")
    t = time.time()
    seen["leave_one_out"] = [pr.leave_one_out_importance(net, None, cx, cy, PRUNE_CLASSES, PRUNE_BLOCK)]
    metric_s["leave_one_out"] = time.time() - t
    for metric, got in seen.items():  # finite, and not one value everywhere
        if not all(np.isfinite(a).all() for a in got) or np.ptp(np.concatenate(got)) <= 0:
            fail(f"prune metric {metric} on the card: scores finite {[bool(np.isfinite(a).all()) for a in got]}, "
                 f"range {np.ptp(np.concatenate(got))}")
    loo = seen["leave_one_out"][0]
    gaps, ties = {}, {}
    nets = [create_efficientnet("b0", resolution=RES, dtype=F32, device=d)[0].load_variables(np_vars) for d in
            (dev, "cpu")]
    x, y, n = cx[:PRUNE_CPU], cy[:PRUNE_CPU], pr.round_down_multiple(int(1152 * 0.75), 16)
    for name, fn, args in (("apoz", pr.apoz_hidden_scores, ()), ("class_sep", pr.class_sep_hidden_scores, (y,)),
            ("taylor", pr.taylor_importance, (y, PRUNE_CLASSES)),
            ("leave_one_out", pr.leave_one_out_importance, (y, PRUNE_CLASSES))):
        card, cpu = (fn(m, None, x.to(d), *args, PRUNE_BLOCK) for m, d in zip(nets, (dev, "cpu")))
        gaps[name] = float(np.abs(card - cpu).max() / np.abs(cpu).max())
        ok = gaps[name] <= 1e-4
        if name in ("apoz", "class_sep"):  # keep sets equal but where a CPU score is within 2x the gap of the cut
            diff = np.setxor1d(pr.keep_top(card, n), pr.keep_top(cpu, n))
            ties[name] = len(diff)
            ok = bool((np.abs(cpu[diff] - np.sort(cpu)[::-1][n - 1]) <= 2 * np.abs(card - cpu).max()).all())
        if not ok or not np.isfinite(card).all():
            fail(f"prune metric {name} at block {PRUNE_BLOCK}: card vs CPU {gaps[name]:.3e}, keep sets {ties}")
    del nets
    phase(f"prune metrics (trained B0@{RES}, {PRUNE_CALIB} images, bf16): " + kv(metric_s, *metric_s)
          + f" s; fp32 card vs CPU at block {PRUNE_BLOCK} ({PRUNE_CPU} images): rel gaps {gaps}, keep sets "
          f"differing at near-ties {ties}; leave_one_out max={np.abs(loo).max():.3e}")
    out["metrics"] = dict(seconds=metric_s, card_vs_cpu=gaps, keep_differ=ties)

    m, v = net, np_vars
    cfg = TrainConfig(num_classes=PRUNE_CLASSES, taps=tuple(default_taps("b0", "early")), resolution=RES,
            batch_size=PRUNE_BATCH, phase1_epochs=0, phase2_epochs=1, phase2_lr=PRUNE_LR, patience=4,
            head="cosine")
    step0, events = MultiExitTrainer._step, []

    def step(self, *a):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        return step0(self, *a)

    for r in (1, 2):
        tag, t = f"pruned x{r}", time.time()
        m, v = pr.prune_backbone(m, v, 0.25, "l1")
        if pr.parameter_count(v) != PRUNE_COUNTS[r]:
            fail(f"{tag}: {pr.parameter_count(v)} parameters")
        events.clear()
        trainer = MultiExitTrainer(m, v, cfg, preprocess=prep, device=dev)
        MultiExitTrainer._step = step
        try:
            with torch.enable_grad():
                hist = trainer.fit(tr_x, tr_y, va_x, va_y, verbose=False)
        finally:
            MultiExitTrainer._step = step0
        sync()
        step_ms = events[0].elapsed_time(events[-1]) / (len(events) - 1)
        if not np.isfinite(hist["loss"]).all():
            fail(f"{tag}: fine-tune losses {hist['loss']}")
        v = trainer.variables
        ft = dict(params=pr.parameter_count(v), hidden=dict(m.hidden_overrides), steps=len(events), step_ms=step_ms,
                loss=hist["loss"], val_acc=hist["val_acc"][-1], seconds=time.time() - t)
        phase(f"{tag} fine-tune (batch {PRUNE_BATCH}, {smi}, CUDA events from step 1 to {len(events)}): "
              + kv(ft, "params", "steps", "step_ms", "loss", "val_acc", "seconds"))
        row, c = own_line(tag, v, info, images, dev, launches, smi, drift={})
        serve_f = make_infer_fn(v, "b0", resolution=RES, fused=True, space_to_depth=True, device=dev)
        mb_rep = {}
        check_mbconv_blocks(c["serve"], serve_f, images, mb_rep)
        fused = check_fused_path(c["serve"], serve_f, c["svc"], info, c["gallery"], c["labels"], images, c["idx"],
                c["idx_oracle"], c["sec"], launches, dev, smi, row["flops_per_iter"],
                path=f"{tag} fused")
        phase(f"{tag} vs unpruned (img/s, embed ms, match ms): plain " + " / ".join(
              f"{a['img_s']:.1f} {a.get('embed_ms', 0):.3f} {a.get('match_ms', 0):.3f}" for a in (row, base[0]))
              + f"; fused {fused['img_s']:.1f} / {base[1]['img_s']:.1f}")
        out[f"x{r}"], mb[f"x{r}"] = dict(finetune=ft, line=row, fused=fused), mb_rep
        del c, serve_f, trainer
        torch.cuda.empty_cache()
    out["seconds"] = time.time() - t0
    return out, mb


def check_certified_pick(svc, emb, idx_exact):
    """The pick before escalation at its candidates' least fp32 rescore (2^-12 + 1e-5); its agreement with exact, %."""
    cand, idx_fast, _ = svc._certified(emb)
    e16 = emb.to(BF16).to(F32)
    d_cand = ((e16[:, None, :] - svc.gallery[cand].to(F32)) ** 2).sum(-1)
    d_fast = ((e16 - svc.gallery[idx_fast].to(F32)) ** 2).sum(-1)
    d_min = d_cand.min(dim=1).values
    in_cand = bool((cand == idx_fast[:, None]).any(dim=1).all())
    if not in_cand or not bool((d_fast <= d_min + 2.0**-12 * d_min + 1e-5).all()):
        fail("the rescored pick is not the nearest of its candidates")
    return pct(idx_fast == idx_exact)


def check_cert_scan(svc, emb, report):
    """Min-2 packed scan vs plain on the service's tensors (2^-12), timed."""
    qp = (emb - svc._mu) @ svc._w
    qa = dk._augment_queries(qp, svc.pca_dim, svc.gal_aug.shape[1])
    ga = svc.gal_aug
    k1, k2 = build.launch_tilemin2_packed(qa, ga)
    p1, p2 = plain.tilemin2_packed_plain(qa, ga)
    sync()
    kd1, ki, kd2 = dk.decode_tile_keys(k1, k2)
    pd1, pi, pd2 = dk.decode_tile_keys(p1, p2)
    scale = torch.clamp_min(pd1.abs().max(), 1e-30)
    err = max((kd1 - pd1).abs().max().item(), (kd2 - pd2).abs().max().item())
    key_eq = (k1 == p1).float().mean().item()
    rel = err / scale.item()
    rows_ok = True
    qf = qa.to(F32)
    for keys, kd, pd in ((k1, kd1, pd1), (k2, kd2, pd2)):
        d_rows = []
        for kk in (keys, p1 if keys is k1 else p2):
            rows = dk.decode_tile_keys(kk, kk)[1].long()
            d_rows.append(torch.clamp_min(torch.einsum("bd,btd->bt", qf, ga[rows].to(F32)), 0.0))
        tol = 2.0**-12 * d_rows[1].abs() + 1e-6
        rows_ok = rows_ok and bool(((d_rows[0] - kd).abs() <= tol).all())
        rows_ok = rows_ok and bool(((d_rows[0] - d_rows[1]).abs() <= tol).all())
    rows_ok = rows_ok and bool(((k1 & 1023) != (k2 & 1023)).all())
    kc, kb = dk.certify_tiles(kd1, ki, kd2, svc.rescore)
    pc, pb = dk.certify_tiles(pd1, pi, pd2, svc.rescore)
    same_set = (kc.sort(dim=1).values == pc.sort(dim=1).values).all(dim=1)
    bound_rel = ((kb - pb).abs() / torch.clamp_min(pb.abs(), 1e-30)).max().item()
    gap_ok = True  # sets differ only by a tile swapped at a near-tie
    if not bool(same_set.all()):
        bad = (~same_set).nonzero()[:, 0]
        r = min(svc.rescore, kd1.shape[1]) - 1
        kth_k = kd1.sort(dim=1).values[bad, r]
        kth_p = pd1.sort(dim=1).values[bad, r]
        gap_ok = bool(((kth_k - kth_p).abs() <= 2.0**-12 * kth_p.abs() + 1e-6).all())
    b, da = qa.shape
    np_ = ga.shape[0]
    n_tiles = k1.shape[1]
    t_ = kernel_times(lambda: build.launch_tilemin2_packed(qa, ga), lambda: plain.tilemin2_packed_plain(qa, ga),
            2.0 * b * np_ * da, np_ * da * 2 + b * da * 2 + 2 * b * n_tiles * 4, (10, 2))
    phase(f"packed scan B={b} Np={np_} Da={da}: keys_equal={100 * key_eq:.3f}% max_gap={err:.3e} rel={rel:.2e} "
          f"sets_equal={pct(same_set):.3f}% bound_gap={bound_rel:.2e} " + times(t_))
    if rel > 2.0**-12 or bound_rel > 2.0**-12 or not gap_ok or not rows_ok:
        fail("packed scan kernel disagrees with its plain version")
    report.setdefault("tilemin2_packed", []).append(dict(shape=f"B={b} Np={np_} Da={da}", max_abs_err=err, **t_))


def check_topk(gallery, n_valid, queries, k, report=None, key="topk_l2", window=None, precise=False,
        row_mask=None, chunk_rows=65536):
    """topk_l2 (bf16, window or precise; pass 3) vs plain: rows rescored at its distances, plain's but at ties
    within 2^-12 + 1e-6 (bf16) or 2^-16 (precise); masked rows empty; timed with a ``report``."""
    q = queries.to(F32 if precise else BF16).contiguous()
    lo, hi = window if window is not None else (0, q.shape[1])
    if k > build.TOPK_MAX_K:  # slabs
        def launch():
            d_, i_ = dk.topk_l2(q, gallery, k, n_valid=n_valid, window=window, precise=precise, row_mask=row_mask)
            return d_ * (hi - lo), i_
    else:
        def launch():
            d_, i_ = build.launch_topk_l2(q, gallery, k, n_valid, window=window, precise=precise, row_mask=row_mask)
            return build.launch_topk_rescore(q, gallery, d_, i_, window)

    def run_plain(rows=chunk_rows):
        d_, i_ = plain.topk_l2_plain(q, gallery, k, n_valid, window=window, precise=precise, row_mask=row_mask,
                chunk_rows=rows)
        return plain.topk_rescore_plain(q, gallery, d_, i_, window)
    kd, ki = launch()
    pd, pi = run_plain()
    sync()
    b, dim = q.shape
    on = torch.ones(b, dtype=torch.bool, device=q.device) if row_mask is None else row_mask
    off_ok = bool((kd[~on] == pd[~on]).all()) and bool((ki[~on] == -1).all()) and bool((pi[~on] == -1).all())
    kd, ki, pd, pi = kd[on], ki[on], pd[on], pi[on]
    err = (kd - pd).abs().max().item() if kd.numel() else 0.0
    idx_eq = (ki == pi).float().mean().item() if ki.numel() else 1.0
    in_range = bool(((ki >= 0) & (ki < n_valid)).all())
    rows = gallery[ki.clamp(0, n_valid - 1).long()][:, :, lo:hi].to(F32)  # [B, k, W]
    d_rows = rows.sub_(q[on][:, None, lo:hi].to(F32)).square_().sum(2)
    del rows
    tol = torch.full_like(pd, 2.0**-16) if precise else 2.0**-12 * pd.abs() + 1e-6
    ok = off_ok and in_range and bool(((ki == pi) | ((d_rows - pd).abs() <= tol)).all())
    ok = ok and bool(((kd - d_rows).abs() <= tol).all())
    variant = ("precise" + (", fp32 rows" if gallery.dtype == F32 else "") if precise
            else f"window {window}" if window else "bf16")
    what = f"topk_l2 ({variant}) B={b} N={n_valid} D={dim} k={k}"
    if not ok:
        fail(f"{what}{'' if row_mask is None else f' mask {int(on.sum())}/{b}'} disagrees with " f"its plain version")
    if report is None:
        return
    width = hi - lo
    nbytes = n_valid * width * gallery.element_size() + b * width * q.element_size() + b * k * 8
    # precise: three bf16 products over bf16 rows, six over fp32 rows
    passes = (6.0 if gallery.dtype == F32 else 3.0) if precise else 1.0
    t_ = kernel_times(launch, lambda: run_plain(65536), passes * 2.0 * b * n_valid * width, nbytes, (3, 1))
    shape = f"B={b} N={n_valid} D={dim} k={k}" + (f" window={list(window)}" if window else "")
    if gallery.dtype == F32:
        shape += " rows=fp32"
    phase(f"{what}: indices_equal={100 * idx_eq:.3f}% max_gap={err:.3e} " + times(t_))
    report.setdefault(key, []).append(dict(shape=shape, max_abs_err=err, indices_equal=idx_eq, **t_))


def check_tile_scan(name, q, g, gsq, tile_g, report, *, bf16_scores=False, quant=None, verbose=True):
    """bf16 or int8 (``quant``) tile scan vs plain: minima within 2^-16 (fp32 scores), 2^-6 (bf16) or 2^-12
    of the cross term, rows rescored; timed with a ``report``. (minima, rows, plain minima)."""
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
    sync()
    fin = torch.isfinite(pd)
    err = (kd - pd)[fin].abs().max().item()
    both_inf = bool((torch.isinf(kd) == torch.isinf(pd)).all())
    idx_eq = (ki == pi).float().mean().item()
    val_eq = (kd == pd).float().mean().item()

    def rescore(rows):  # fp32 sums; float64 for the exact int8 dot
        wide = torch.float64 if quant is not None and quant[2] == "int8" else F32
        cross = torch.einsum("bd,btd->bt", q.to(wide), g[rows.long()].to(wide)).to(F32)
        if quant is None:
            return gsq[rows.long()] - 2.0 * cross
        return gsq[rows.long()] - (2.0 * qs)[:, None] * (cross * gsc[rows.long()])

    scale = 1.0 if quant is None else (2.0 * qs.abs().max() * gsc.abs().max() * q.shape[1] * 127 * 127).item()
    atol = tol * scale + (2.0**-16 if quant is None or quant[2] != "int8" else 0.0)
    d_k, d_p = rescore(ki), rescore(pi)
    fin_k = torch.isfinite(kd) & (gsq[ki.long()] < 1e37)
    rows_ok = bool(((d_k - kd).abs() <= atol)[fin_k].all()) and bool(((ki == pi) | ((d_k - d_p).abs() <= atol)).all())
    ok = err <= atol and both_inf and rows_ok and bool((ki // tile_g == torch.arange(ki.shape[1], device=ki.device)).all())
    b, d = q.shape
    np_ = g.shape[0]
    n_tiles = ki.shape[1]
    what = (f"tile scan {name} B={b} Np={np_} D={d} tile_g={tile_g}: rows_equal={100 * idx_eq:.3f}% "
            f"minima_equal={100 * val_eq:.3f}% max_gap={err:.3e} (tol {atol:.3e}) rows_ok={rows_ok}")
    if not ok:
        fail(f"tile scan kernel disagrees with its plain version: {what}")
    if report is None:
        if verbose:
            phase(what)
        return kd, ki, pd
    if quant is None:
        nbytes, peak = np_ * d * 2 + np_ * 4 + b * d * 2 + b * n_tiles * 8, None
    else:
        nbytes = np_ * d + 2 * np_ * 4 + b * d + b * 4 + b * n_tiles * 8
        peak = PEAK_INT8_OPS if quant[2] == "int8" else None
    t_ = kernel_times(launch, run_plain, 2.0 * b * np_ * d, nbytes, (10 if d <= 128 else 3, 1), peak)
    phase(f"{what}; " + times(t_))
    report.append(dict(shape=name, b=b, np=np_, d=d, tile_g=tile_g, max_abs_err=err, rows_equal=idx_eq,
            minima_equal=val_eq, **t_))
    return kd, ki, pd

# (rows, n_valid, D, B): widths no multiple of 8, n_valid inside a tile
EDGE_SHAPES = [(5000, 4321, 124, 130), (9000, 9000, 40, 64), (3000, 2900, 120, 1)]


def check_edge_shapes(dev):
    """Tile scans and top-k vs plain at :data:`EDGE_SHAPES`; the whole-pad pairs, bit-equal."""
    gen = gen_on(dev, 23)
    big = torch.tensor(plain.BIG_DIST, dtype=F32).item()
    pad_pairs = 0
    for n, nv, d, b in EDGE_SHAPES:
        g32 = _unit(randn(gen, n, d))
        q32 = _unit(g32[:b] + 0.1 * randn(gen, b, d))
        q16 = dk.pad_cols(q32.to(BF16), 8)
        tag = f"edge N={n} n_valid={nv} D={d} B={b}"
        for tg in (128, 256, 512, 1024):
            g16 = dk.pad_cols(dk.pad_gallery(g32.to(BF16), tg), 8)
            gsq = dk.gallery_sq_norms(g16, nv, tg)
            scans = [(f"{tag} {'bf16' if bf else 'f32'}-scores", dict(q=q16, g=g16, bf16_scores=bf),
                    float("inf") if bf else big) for bf in (False, True)]
            if tg == 128:
                gq, gs = quantize_rows(g16)
                qq, qs = quantize_rows(q32)
                gsc = dk.quant_gallery_scales(gs, nv, tg)
                scans += [(f"{tag} int8-scan-{c}", dict(q=dk.pad_cols(qq), g=dk.pad_cols(gq), quant=(qs, gsc, c)), big)
                        for c in ("int8", "bf16")]
            for name, kw, pad_value in scans:
                kd, ki, pd = check_tile_scan(name, kw.pop("q"), kw.pop("g"), gsq, tg, None, **kw)
                if not whole_pad_ok(kd, ki, pd, nv, tg, pad_value):
                    fail(f"whole-pad tiles disagree ({name}, tile_g={tg})")
                pad_pairs += int((torch.arange(kd.shape[1]) * tg >= nv).sum()) * b
        q8 = dk.pad_cols(q32, 8)
        check_topk(dk.pad_cols(g32, 8), nv, q8, 16, precise=True)  # fp32 rows: the six-product pass
        g8 = dk.pad_cols(g32.to(BF16), 8)
        check_topk(g8, nv, q8, 3, window=(5, d - 3), precise=True)
        check_topk(g8, nv, q8, 5, window=(1, d - 1))
        check_topk(g8, nv, q8, 16)
    return pad_pairs


def whole_pad_ok(kd, ki, pd, nv, tg, pad_value):
    """Whole-pad tile minima bit-equal to plain's and ``pad_value`` at the first row."""
    whole_pad = torch.arange(kd.shape[1], device=kd.device) * tg >= nv
    first = (torch.arange(kd.shape[1], device=kd.device, dtype=torch.int32) * tg)[None, whole_pad]
    return (bool((kd[:, whole_pad] == pd[:, whole_pad]).all()) and bool((kd[:, whole_pad] == pad_value).all())
            and bool((ki[:, whole_pad] == first).all()))


def edge_data(gen, n, nv, d, b):
    """Unit rows, queries near the first ones, rows past ``nv`` query copies; + bf16."""
    g32 = _unit(torch.randn((n, d), generator=gen, device=gen.device))
    q32 = _unit(g32[:b] + 0.1 * torch.randn((b, d), generator=gen, device=gen.device))
    g32[nv : nv + b] = q32[: n - nv]
    return g32, q32, g32.to(BF16)

# the sm90 scans at their tiles' edges
SCAN_EDGE_B = (1, 127, 128, 129, 257)
TOPK_EDGES = [(600, 100, 8), (5000, 4321, 40), (3000, 2900, 1280)]  # (rows, n_valid, D)
TOPK_EDGE_K = (1, 2, 3, 16)
ROW_MASKS = ("empty", "first", "last", 64, 65, 128, 129)  # a prefix of that many queries
TOPK_LARGE_K = (17, 64, 256)  # k > 16: lists in the pass-1 scratch
TOPK_LARGE_K_EDGES = [(5000, 4321, 40), (3000, 2900, 1280), (20000, 17000, 40)]  # (rows, n_valid, D); 3 segments
TOPK_LARGE_K_B = (1, 129, 257)
TOPK_SLAB_K = (257, 600)  # past one launch's 256 columns: slabs above a floor
WIDE_PACKED = [(2100, 2000, 700, 768), (3600, 1800, 800, 832), (2100, 1000, 1500, 1536)]  # (rows, n_valid, d, Da)
MIN2_EDGES = [(3600, 1800, 40, 48), (2100, 2100, 124, 128)] + WIDE_PACKED
SINGLE_EDGES = [(3600, 1800, 40, 48), (2100, 1000, 124, 128)] + WIDE_PACKED
SINGLE_EDGE_B = SCAN_EDGE_B + (192, 320)
QUANT_EDGES = [(5000, 2100, 16), (2900, 1300, 144), (5000, 2100, 1536)]  # (rows, n_valid, D)
TILE_EDGES = [(3000, 2900, 16), (5000, 4321, 40), (2100, 1000, 128), (3000, 2050, 200), (2600, 1300, 1536)]
TILE_EDGE_B = (1, 64, 130)
QUANT_BF16_EDGES = [(5000, 2100, 16), (2900, 1300, 144), (2600, 1300, 1536)]  # (rows, n_valid, D)
QUANT_BF16_EDGE_B = (1, 64, 130, 257)


def check_packed(qa, ga, n_valid, tile_g=None):
    """A packed scan vs plain, untimed: :func:`keys_ok` (single-min: equal keys pass), no row past
    ``n_valid``, whole-pad tiles only pad; min-2 (no ``tile_g``): the two keys differ."""
    two, tg = tile_g is None, tile_g or 1024
    got = build.launch_tilemin2_packed(qa, ga) if two else (build.launch_tilemin_packed(qa, ga, tg),)
    ref = plain.tilemin2_packed_plain(qa, ga) if two else (plain.tilemin_packed_plain(qa, ga, tg),)
    sync()
    whole_pad = torch.arange(got[0].shape[1], device=qa.device) * tg >= n_valid
    ok = all(keys_ok(qa, ga, k, r, tg, equal_ok=not two) for k, r in zip(got, ref))
    ok = ok and bool((dk._key_to_row(got[0], tg)[:, ~whole_pad] < n_valid).all())
    ok = ok and bool((dk._key_to_dist(got[0], tg)[:, whole_pad] >= 1e37).all())
    if not ok or (two and bool((got[0] == got[1]).any())):
        fail(f"{'min-2' if two else 'single-min'} packed scan disagrees with its plain version (B={qa.shape[0]}, "
             f"Np={ga.shape[0]}, n_valid={n_valid}, Da={qa.shape[1]}, tile_g={tg})")


def keys_ok(qa, ga, keys, ref, tile_g, equal_ok=False):
    """Decoded distances 2^-12 + 1e-6 of plain's, rows rescored at them (``equal_ok``: equal keys pass)."""
    kd, pd = dk._key_to_dist(keys, tile_g), dk._key_to_dist(ref, tile_g)
    qf = qa.to(F32)
    d_rows = [torch.clamp_min(torch.einsum("bd,btd->bt", qf, ga[dk._key_to_row(kk, tile_g).long()].to(F32)),
            0.0) for kk in (keys, ref)]
    tol = 2.0**-12 * pd.abs() + 1e-6
    near = ((kd - pd).abs() <= tol) & ((d_rows[0] - kd).abs() <= tol) & ((d_rows[0] - d_rows[1]).abs() <= tol)
    return bool(((keys == ref) | near).all() if equal_ok else near.all())


def check_quant_edge(q, qs, g, gsq, gsc, n_valid, tile_g):
    """int8 scan vs plain: equal; a whole-pad tile 3.4e38 at its first row."""
    kd, ki = build.launch_tilemin_quant(q, qs, g, gsq, gsc, tile_g, "int8")
    pd, pi = plain.tilemin_quant_plain(q, qs, g, gsq, gsc, tile_g, "int8")
    sync()
    big = torch.tensor(3.4e38, dtype=F32).item()
    if not (bool((kd == pd).all()) and bool((ki == pi).all()) and whole_pad_ok(kd, ki, pd, n_valid, tile_g, big)):
        fail(f"int8 tile scan disagrees with its plain version (B={q.shape[0]}, "
             f"Np={g.shape[0]}, n_valid={n_valid}, D={q.shape[1]}, tile_g={tile_g})")


def check_sm90_edges(dev):
    """The ``sm90_scan.cuh`` kernels vs plain at the ``*_EDGES`` shapes; cases a kernel."""
    gen = gen_on(dev, 31)
    cases = dict.fromkeys(("topk_l2", "topk_l2_precise_split", "topk_l2_precise_split6", "topk_l2_large_k",
            "tilemin2_packed", "tilemin_packed", "tilemin_quant", "tilemin", "tilemin_quant_bf16"), 0)

    def mask_of(m, b):
        mask = torch.zeros(b, dtype=torch.bool, device=dev)
        mask[{"first": slice(0, 1), "last": slice(-1, None), "empty": slice(0, 0)}.get(m, slice(0, m))] = True
        return mask

    bmax = max(SCAN_EDGE_B)
    for n, nv, d in TOPK_EDGES:
        g32, q32, g16 = edge_data(gen, n, nv, d, bmax)
        windows = [None, (1, d - 1)] + ([(5, d - 3)] if d > 8 else []) + ([(64, 192)] if d >= 192 else [])
        for b, k in ((b, k) for b in SCAN_EDGE_B for k in TOPK_EDGE_K):
            for w in windows:
                check_topk(g16, nv, q32[:b], k, window=w)
            for w in windows[:2]:  # split passes over bf16 and fp32 rows
                check_topk(g16, nv, q32[:b], k, window=w, precise=True)
                check_topk(g32, nv, q32[:b], k, window=w, precise=True)
            cases["topk_l2"] += len(windows)
            cases["topk_l2_precise_split"] += 2
            cases["topk_l2_precise_split6"] += 2
        for m in ROW_MASKS:
            for k in (1, 3):
                check_topk(g16, nv, q32, k, row_mask=mask_of(m, bmax))
                cases["topk_l2"] += 1
    bmax = max(TOPK_LARGE_K_B)
    for n, nv, d in TOPK_LARGE_K_EDGES:
        g32, q32, g16 = edge_data(gen, n, nv, d, bmax)
        for b, k in ((b, k) for b in TOPK_LARGE_K_B for k in TOPK_LARGE_K):
            for g, kw in ((g16, {}), (g32, dict(precise=True)), (g32, dict(window=(5, d - 3), precise=True)),
                    (g16, dict(window=(5, d - 3))), (g16, dict(window=(1, d - 1), precise=True)),
                    (g16, dict(precise=True))):
                check_topk(g, nv, q32[:b], k, **kw)
            cases["topk_l2_large_k"] += 6
        check_topk(g16, nv, q32, 64, row_mask=mask_of(129, bmax))
        cases["topk_l2_large_k"] += 1
    for n, nv, d, da in MIN2_EDGES:
        g16 = _unit(randn(gen, n, d)).to(BF16)
        ga = dk.pack_gallery_aug(g16, nv)[:, :da].contiguous()  # pads: |g|^2 = 1e38
        for b in SCAN_EDGE_B:
            check_packed(dk._augment_queries(_unit(g16[:b].to(F32) + 0.1 * randn(gen, b, d)), d, da), ga, nv)
            cases["tilemin2_packed"] += 1
    for n, nv, d, da in SINGLE_EDGES:
        g32, q32, g16 = edge_data(gen, n, nv, d, max(SINGLE_EDGE_B))
        for tg in (128, 256, 512, 1024):
            ga = dk.pack_gallery_aug(g16, nv, tg)[:, :da].contiguous()
            for b in SINGLE_EDGE_B:
                check_packed(dk._augment_queries(q32[:b], d, da), ga, nv, tg)
                cases["tilemin_packed"] += 1
    big = torch.tensor(plain.BIG_DIST, dtype=F32).item()
    for edges, bs in ((QUANT_EDGES, SCAN_EDGE_B), (TILE_EDGES, TILE_EDGE_B), (QUANT_BF16_EDGES, QUANT_BF16_EDGE_B)):
        tile = edges is TILE_EDGES
        for n, nv, d in edges:
            g32, q32, g16 = edge_data(gen, n, nv, d, max(bs))
            for tg in (128, 256, 512, 1024) if tile else (128, 1024):
                if tile:
                    gp = dk.pad_gallery(g16, tg)
                    gsq = dk.gallery_sq_norms(gp, nv, tg)
                else:
                    gq, gs = quantize_rows(dk.pad_gallery(g16, tg))
                    gsq = dk.gallery_sq_norms(g16, nv, tg).reshape(-1)
                    gsc = dk.quant_gallery_scales(gs, nv, tg).reshape(-1)
                for b in bs:
                    name = f"edge N={n} n_valid={nv} D={d} B={b}"
                    if tile:
                        runs = [(f"{name} {'bf16' if bf else 'f32'}-scores", q32[:b].to(BF16).contiguous(), gp,
                                dict(bf16_scores=bf), float("inf") if bf else big) for bf in (False, True)]
                    else:
                        qq, qs = quantize_rows(q32[:b])
                        if edges is QUANT_EDGES:
                            check_quant_edge(qq, qs, gq, gsq, gsc, nv, tg)
                            cases["tilemin_quant"] += 1
                            continue
                        runs = [(f"{name} int8-scan-bf16", qq, gq, dict(quant=(qs, gsc, "bf16")), big)]
                    for name_, q_, g_, kw, pad_value in runs:
                        kd, ki, pd = check_tile_scan(name_, q_, g_, gsq, tg, None, verbose=False, **kw)
                        if not whole_pad_ok(kd, ki, pd, nv, tg, pad_value):
                            fail(f"whole-pad tiles disagree ({name_}, tile_g={tg})")
                        cases["tilemin" if tile else "tilemin_quant_bf16"] += 1
    return cases


def check_topk_slabs(dev):
    """``topk_l2`` at :data:`TOPK_SLAB_K` vs one plain pass (300 x 100,000 x 128)."""
    gen = gen_on(dev, 37)
    nv, b = 99_000, 300
    g32, q32, g16 = edge_data(gen, 100_000, nv, 128, b)
    mask = torch.zeros(b, dtype=torch.bool, device=dev)
    mask[:129] = True
    for k in TOPK_SLAB_K:
        check_topk(g16, nv, q32, k)
        check_topk(g16, nv, q32, k, precise=True)
        check_topk(g16, nv, q32, k, window=(5, 125))
        check_topk(g16, nv, q32, k, row_mask=mask)
        check_topk(g32, nv, q32, k, precise=True)
    return 5 * len(TOPK_SLAB_K)

# |kernel - fp64| at the split probes
SPLIT_PROBE_TOL = 2.0**-18


def check_split_probe(dev, six: bool):
    """A split precise pass within :data:`SPLIT_PROBE_TOL` of fp64 where its last terms matter, fewer
    products not: bf16 rows, queries = rows x (1 + 2^-9 + 2^-18) (three products; |q|^2 within 2^-20, a non-zero
    lo plane), or ``six``: rows = a bf16 row x that, queries half a row; planes = ``plain.split_bf16x3``, zero
    past B. (errors)."""
    gen = gen_on(dev, 43 if six else 41)
    n, d, f = 4096, 1280, 1.0 + 2.0**-9 + 2.0**-18
    h = _unit(randn(gen, n, d)).to(BF16)
    g = (h.float() * f).contiguous() if six else h
    worst = [0.0, float("inf")]
    cases = [(b, w) for b in (130, 257) for w in (None, (5, d - 3))] if six else [(130, None), (257, (5, d - 3))]
    for b, window in cases:
        lo, hi = window if window is not None else (0, d)
        q = (0.5 * g[:b] if six else g[:b].float() * f).contiguous()
        out = {}
        kd, ki = build.launch_topk_l2(q, g, 1, n, window=window, precise=True, split_out=out)
        sync()
        qw = torch.zeros_like(q)
        qw[:, lo:hi] = q[:, lo:hi]
        want = plain.split_bf16x3(qw)
        planes_eq = not bool(out["planes"][:, b:].any()) and all(
            torch.equal(out["planes"][p_, :b].view(torch.int16), t.view(torch.int16)) for p_, t in enumerate(want))
        qd, gd = q[:, lo:hi].double(), g[:b, lo:hi].double()
        exact = ((qd - gd) ** 2).sum(1)
        if six:
            qt, gt = ([t[:b, lo:hi].double() for t in plain.split_bf16x3(x)] for x in (q, g))
            cross = sum((qt[a] * gt[c]).sum(1) for a, c in ((0, 1), (1, 0), (0, 0)))
            probe_ok = True
        else:
            cross = ((want[0][:, lo:hi].double() + want[1][:, lo:hi].double()) * gd).sum(1)
            qsq_err = ((out["qsq"][:b].double() - (qd * qd).sum(1)).abs() / (qd * qd).sum(1)).max().item()
            probe_ok = qsq_err <= 2.0**-20 and bool(want[2].any())
        rows_ok = bool((ki[:, 0] == torch.arange(b, device=dev)).all())
        err_k = (kd[:, 0].double() - exact).abs().max().item()
        err_less = ((qd * qd).sum(1) + (gd * gd).sum(1) - 2.0 * cross - exact).abs().min().item()
        print(f"  {'six' if six else 'three'}-product pass B={b} window={window}: planes_equal={planes_eq} "
              f"probe_ok={probe_ok} own_rows={rows_ok} kernel_err={err_k:.3e} fewer_terms_err={err_less:.3e}",
              flush=True)
        if not (planes_eq and probe_ok and rows_ok):
            fail(f"split_queries' planes, |q|^2 or the rows disagree (B={b}, window {window}, six={six})")
        if err_k > SPLIT_PROBE_TOL or err_less <= 1.5 * SPLIT_PROBE_TOL:
            fail(f"the split pass does not compute its products (B={b}, window {window}, six={six})")
        worst = [max(worst[0], err_k), min(worst[1], err_less)]
    return worst


def full_significand_rows(g, seed: int):
    """fp32 unit rows near ``g`` with full 24-bit significands."""
    gen = torch.Generator(device=g.device).manual_seed(seed)
    out = torch.empty(g.shape, dtype=F32, device=g.device)
    for s in range(0, g.shape[0], 65536):
        rows = g[s : s + 65536].float()
        out[s : s + rows.shape[0]] = _unit(rows + 2.0**-8 * torch.randn(rows.shape, generator=gen, device=g.device))
    return out


def check_big_grids(dev):
    """Past the 65,535-block caps vs plain: tile scan 8.4M rows, int8 134M, ``topk_l2`` 537M."""
    gen = gen_on(dev, 41)
    b = 130  # two 128-query tiles
    n_tiles = 65_600
    g = _unit(randn(gen, n_tiles * 128, 16)).to(BF16)
    q = _unit(randn(gen, b, 16)).to(BF16)
    nv = n_tiles * 128 - 200  # the last tile holds only rows past n_valid
    check_tile_scan(f"big-grid {n_tiles} tiles", q, g, dk.gallery_sq_norms(g, nv, 128), 128, None)
    done = [f"tilemin {n_tiles} tiles of 128 x 16"]
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
    n = 65_537 * 8192  # 65,537 segments of 8,192 rows
    for dtype in (BF16, F32):  # 8.6 GB, then 17.2 GB of rows
        g = torch.empty((n, 8), dtype=dtype, device=dev)
        for r0 in range(0, n, 1 << 26):
            r1 = min(n, r0 + (1 << 26))
            g[r0:r1] = _unit(randn(gen, r1 - r0, 8)).to(dtype)
        if dtype == BF16:
            q = _unit(randn(gen, 65, 8))  # two query blocks of 64
        for k, precise in ((1, False), (1, True), (17, False)) if dtype == BF16 else ((1, True),):
            check_topk(g, n, q, k, precise=precise, chunk_rows=1 << 23)
        del g
    done.append(f"topk_l2 over {n} x 8 (bf16 k=1: {n // 2048} segments; precise k=1 over bf16 and fp32 rows, bf16 "
            f"k=17: {n // 8192} segments)")
    torch.cuda.empty_cache()
    return done


def check_packed_service(info, gallery, labels, emb, images, serve, dev, launches, report):
    """The PCA-700 packed service (Da 768) over 131,072 rows: scan vs plain, pick, rows = exact's but ties."""
    n = 131_072
    t = time.time()
    kw = dict(labels=labels[:n], n_valid=n, serving_fn=serve, device=dev)
    svc = RecognitionService(None, info, gallery[:n], pca_dim=700, pca_scan="packed", **kw)
    exact = RecognitionService(None, info, gallery[:n], match="exact", **kw)
    da = svc.gal_aug.shape[1]
    if da != 768:
        fail(f"the PCA-700 packed service has Da = {da}, not 768")
    idx = counted(lambda: svc.identify_device(images))
    sync()
    check_launches("pca700", launches, tilemin2_packed=1, topk_l2=1)
    esc = svc.last_escalated.float().mean().item()
    idx_e = exact._match_emb(emb)
    e16 = emb.to(BF16).to(F32)
    d = [((e16 - gallery[i.long()].to(F32)) ** 2).sum(-1) for i in (idx, idx_e)]
    check_cert_scan(svc, emb, report)
    fast_agree = check_certified_pick(svc, emb, idx_e)
    differ = idx != idx_e
    tie = (d[0] - d[1]).abs() <= 2.0**-12 * d[1] + 1e-6
    phase(f"service pca_dim=700 packed Da={da} rows={n} ({since(t)}): "
          f"rows_equal_exact={100 - pct(differ):.3f}% rest_near_ties="
          f"{bool((tie | ~differ).all())} escalated={100 * esc:.2f}% pick_equal_exact={fast_agree:.3f}% "
          f"error={100 * float(np.mean(labels[host(idx)] != np.arange(len(idx)))):.3f}% "
          f"launches={launches['pca700']}")
    if not bool((tie | ~differ).all()):
        fail("the PCA-700 packed service disagrees with match='exact' beyond near-ties")


def check_single_scan(name, qa, ga, tile_g, report):
    """Single-min scan vs plain on a path's tensors, timed (:func:`keys_ok`)."""
    keys = build.launch_tilemin_packed(qa, ga, tile_g)
    ref = plain.tilemin_packed_plain(qa, ga, tile_g)
    sync()
    kd, pd = dk._key_to_dist(keys, tile_g), dk._key_to_dist(ref, tile_g)
    err = (kd - pd).abs().max().item()
    rel = err / max(pd.abs().max().item(), 1e-30)
    key_eq = (keys == ref).float().mean().item()
    rows_ok = keys_ok(qa, ga, keys, ref, tile_g)
    row_eq = ((keys & (tile_g - 1)) == (ref & (tile_g - 1))).float().mean().item()
    b, da = qa.shape
    np_ = ga.shape[0]
    n_tiles = keys.shape[1]
    t_ = kernel_times(lambda: build.launch_tilemin_packed(qa, ga, tile_g), lambda: plain.tilemin_packed_plain(qa, ga,
            tile_g), 2.0 * b * np_ * da, np_ * da * 2 + b * da * 2 + b * n_tiles * 4, (10, 2))
    phase(f"single-min scan {name} B={b} Np={np_} Da={da} tile_g={tile_g}: keys_equal={100 * key_eq:.3f}% "
          f"rows_equal={100 * row_eq:.3f}% max_gap={err:.3e} rel={rel:.2e} rows_ok={rows_ok} " + times(t_))
    if rel > 2.0**-12 or not rows_ok:
        fail(f"single-min scan kernel disagrees with its plain version ({name})")
    report.setdefault("shapes", []).append(dict(shape=name, b=b, np=np_, da=da, tile_g=tile_g, max_abs_err=err,
            keys_equal=key_eq, **t_))


def check_partial_escalation(svc, emb, gallery, dev, share: float = 0.05):
    """The exact step at ~``share`` escalation three ways, same rows; timings."""
    gen = gen_on(dev, 5)
    esc = torch.rand(emb.shape[0], generator=gen, device=dev) < share
    pick = svc._certified(emb)[1].to(torch.int32)

    def in_place():
        _, ei = dk.topk_l2(emb, gallery, 1, n_valid=svc.n_valid, row_mask=esc)
        return torch.where(esc, ei[:, 0], pick)

    def gathered():
        rows = esc.nonzero()[:, 0]
        out = pick.clone()
        if rows.numel():
            out[rows] = dk.topk_l2(emb[rows], gallery, 1, n_valid=svc.n_valid)[1][:, 0]
        return out

    ways = {"front": lambda: svc._escalate(emb, pick, esc), "in_place": in_place, "gather_sync": gathered}
    outs = {k: f() for k, f in ways.items()}
    if not all(bool((o == outs["gather_sync"]).all()) for o in outs.values()):
        fail("the escalation ways disagree")
    ms = {k: [] for k in ways}
    for k in ("gather_sync", "front", "in_place", "in_place", "front", "gather_sync"):
        ms[k].append(host_ms(ways[k], TIMED_CALLS))
    n_esc = int(esc.sum())
    qt = build.topk_l2_query_rows()
    front_blocks = -(-n_esc // qt)
    in_place_blocks = int(torch.nn.functional.pad(esc, (0, -esc.shape[0] % qt)).view(-1, qt).any(dim=1).sum())
    phase(f"partial escalation ({n_esc} of {emb.shape[0]}): ms front={ms['front']} ({front_blocks} tiles of {qt}) "
          f"in_place={ms['in_place']} ({in_place_blocks} tiles) gather_sync={ms['gather_sync']}; same rows")
    return dict(escalated=n_esc, batch=emb.shape[0], query_tile=qt, scanned_blocks_front=front_blocks,
            scanned_blocks_in_place=in_place_blocks, **{f"{k}_ms": v for k, v in ms.items()})


def random_unit_gallery(n: int, dim: int, dev, seed: int = 1):
    """bench.py's bf gallery: ``n`` (to 1024) bf16 rows normalize(N(0, I))."""
    n_pad = -(-n // 1024) * 1024
    gen = gen_on(dev, seed)
    gal = torch.empty((n_pad, dim), dtype=BF16, device=dev)
    for s in range(0, n_pad, 65536):
        rows = torch.randn((min(65536, n_pad - s), dim), generator=gen, device=dev)
        gal[s : s + rows.shape[0]] = (rows * torch.rsqrt(torch.clamp_min((rows * rows).sum(1), 1e-30))[:,
            None]).to(BF16)
    return gal


def near_ties(trace, caps, b):
    """[b] bool: an exit-rule margin within NEAR_TIE * d1 of 0 or of a capacity cut's."""
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
    """Per level: segment and match ms (host clock), the scan's ms beside its bound."""
    net = casc.net
    carry = images
    rows = []
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
        rows.append(dict(level=level, batch=b, segment_ms=seg_ms, match_ms=match_ms, kernel_ms=k_ms, bound_ms=b_ms,
                bound_by=b_by))
        if not final:
            carry = h[: min(caps[level + 1], h.shape[0])]
    report["per_level"] = rows
    return rows

def run_cascade(casc, images, path, launches, smi, labels, refs, plain_sec=None, breakdown=None, early=True):
    """A cascade line: timed, one call with no host sync, the breakdown; the plain scan decides the same but
    near-ties, <= 1 % (``early``: >= 1 exit). (row, rows)."""
    counted(lambda: casc.identify_device(images))
    no_sync(lambda: casc.identify_device(images))
    out, ms = timed(lambda: casc.identify_device(images))
    check_launches(path, launches, tilemin_packed=(TIMED_CALLS + 2) * casc.num_levels)
    packed = host(out)
    b = images.shape[0]
    idx, exit_level, forced = packed[:b].astype(np.int64), packed[b : 2 * b], int(packed[-1])
    if packed.shape != (2 * b + 1,) or not ((idx >= 0) & (idx < casc.n_valid)).all():
        fail(f"{path} returned rows outside the gallery")
    row = dict(img_s=b / ms * 1e3, ms=ms, error_pct=pct(labels[idx] != np.arange(b)), exits=[round(float(f),
            4) for f in np.bincount(exit_level, minlength=casc.num_levels) / b], forced=forced / b,
            **{f"{k}_label_agreement_pct": pct(labels[idx] == labels[r]) for k, r in refs.items()})
    if plain_sec:
        row["speedup_over_plain"] = plain_sec / (ms / 1e3)
    phase(f"{path} path ({smi}): " + kv(row, *row) + f"; no host sync; launches={launches[path]}")
    if breakdown:
        per_level = cascade_breakdown(casc, images, *breakdown)
        phase(f"{path} breakdown per level: " + "; ".join(f"L{r['level']} " + kv(r, "batch", "segment_ms", "match_ms",
              "kernel_ms", "bound_ms", "bound_by") for r in per_level))
    caps = casc.capacities_for(b)
    trace_k, trace_p = [], []
    out_k = casc._run(images, caps, trace_k)
    kernel_keys = dk.tilemin_keys
    dk.tilemin_keys = lambda q_aug, g_aug, tile_g: plain.tilemin_packed_plain(q_aug, g_aug, tile_g)
    try:
        out_p = casc._run(images, caps, trace_p)
    finally:
        dk.tilemin_keys = kernel_keys
    tie = (near_ties(trace_k, caps, b) | near_ties(trace_p, caps, b)).cpu().numpy()
    ok_k, ok_p = host(out_k), host(out_p)
    differ = (ok_k[:b] != ok_p[:b]) | (ok_k[b:-1] != ok_p[b:-1])
    row["early_exits_pct"] = pct(ok_k[b:-1] < casc.num_levels - 1)
    phase(f"{path} decisions, kernel vs plain scan: differ={int(differ.sum())}/{b} all_near_ties="
          f"{bool((tie | ~differ).all())} forced={int(ok_k[-1])}/{int(ok_p[-1])} near_tie={100 * tie.mean():.3f}% "
          f"early_exits={row['early_exits_pct']:.3f}%")
    if not (tie | ~differ).all() or differ.mean() > 0.01 or abs(int(ok_k[-1]) - int(ok_p[-1])) > differ.sum():
        fail(f"{path} decisions differ from the plain scan's beyond near-ties")
    if early and row["early_exits_pct"] == 0.0:
        fail(f"{path}: no probe exited before the final level")
    return row, idx


# fused MBConv vs plain: same bf16 roundings, fp32 sums in another order
MB_TOL = 2.0**-6
# (name, B0 block, plane, plan (th, tw, group, bufs, ipb)): plans B0@224 never picks
FORCED_MB_PLANS = [("block6b, 3 output groups, 2 images a block", 12, 7, (7, 7, 1, 3, 2)),
    ("block6b, output groups of 2 + 1, weights single-buffered", 12, 15, (15, 15, 2, 1, 1)),
    ("block6b, 3 output groups, tiled, input single-buffered", 12, 15, (8, 15, 1, 2, 1)),
    ("block6b, tiled, no double buffer", 12, 15, (8, 15, 3, 0, 1)),
    ("block2b, tiled, weights single-buffered", 2, 15, (8, 8, 1, 1, 1)),
    ("block1a no expand, tiled, no double buffer", 0, 15, (8, 8, 1, 0, 1))]


def mbconv_bound(b, hw, cin, ce, cout, k, has_expand, param_bytes):
    """A block's least time: products at the bf16 peak, taps at fp32's, or bytes."""
    pix = b * hw * hw
    t_mm = 2.0 * pix * ((cin * ce if has_expand else 0) + ce * cout) / PEAK_BF16_FLOPS
    t_dw = 2.0 * pix * ce * k * k / PEAK_FP32_FLOPS
    t_bytes = (2.0 * pix * (cin + cout) + param_bytes) / PEAK_HBM_BYTES
    t_ops = max(t_mm, t_dw)
    return (t_ops * 1e3, "operations") if t_ops >= t_bytes else (t_bytes * 1e3, "bytes")


def run_mbconv_pair(x, q, cfg, plan=None):
    """Kernel and plain on one input: (outputs, (relative errors, on the borders), bit-equal share, runs)."""
    k = cfg["kernel"]
    pads = tuple(mb._same_pads(n, k, 1)[1:] for n in x.shape[2:])
    if plan is None:
        run_k = lambda: mb.mbconv(x, q, cfg)  # noqa: E731
    else:
        run_k = lambda: build.launch_mbconv(x, q, k, (pads[0][0], pads[1][0]), plan,  # noqa: E731
                cfg["activation"] == "relu6", cfg["residual"])
    run_p = lambda: plain.mbconv_plain(x, q, k, pads, cfg["activation"], cfg["residual"])  # noqa: E731
    yk, yp = run_k(), run_p()
    sync()
    if not yk.is_contiguous(memory_format=torch.channels_last) or yk.shape != yp.shape:
        fail("the mbconv kernel's output has the wrong shape or layout")
    def rel(sl):
        return ((yk.float() - yp.float())[sl].abs().max() / torch.clamp_min(yp.float()[sl].abs().max(), 1e-30)).item()

    edge = [0, 1, -2, -1]
    border = max(rel((slice(None), slice(None), slice(None), edge)), rel((slice(None), slice(None), edge)))
    return yk, yp, (rel(slice(None)), border), (yk == yp).float().mean().item(), run_k, run_p


def check_mbconv_blocks(net, net_f, images, report):
    """The MBConv kernel vs plain at each stride-1 block, timed; shared memory = ``plane_smem``."""
    rows = []
    h = net.stem(images)
    for i, (name, blk) in enumerate(zip(net.names, net.blocks)):
        if str(i) in net_f.fused_blocks:
            if not h.is_contiguous(memory_format=torch.channels_last):
                fail(f"the per-op input of {name} is not channels_last")
            fb = net_f.fused_blocks[str(i)]
            q = {n: getattr(fb, n) for n in fb.param_names}
            yk, yp, (rel, border), eq, run_k, run_p = run_mbconv_pair(h, q, fb.cfg)
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
                fail(f"kernels/mbconv.cu and ops.mbconv_kernel.plane_smem disagree at {name}")
            pbytes = sum(t.numel() * t.element_size() for t in q.values())  # the weights the kernel reads
            b_ms, b_by = mbconv_bound(b, hw, cin, ce, cout, fb.cfg["kernel"], "w_exp_t" in q, pbytes)
            row = dict(block=name, b=b, hw=hw, cin=cin, ce=ce, cout=cout, k=fb.cfg["kernel"], plan=dict(zip(("th", "tw",
                    "group", "bufs", "ipb"), plan)), smem=smem, max_abs_err=err, rel_err=rel, border_rel_err=border,
                    bit_equal=eq, ms=ms, plain_ms=plain_ms, per_op_ms=per_op_ms, bound_ms=b_ms, bound_by=b_by)
            rows.append(row)
            print(f"  mbconv {name} B={b} {hw}x{hw} {cin}->{ce}->{cout} k{row['k']} plan {plan} ({smem} B): "
                  f"rel={rel:.2e} border={border:.2e} bit_equal={100 * eq:.2f}% ms={ms:.3f} plain={plain_ms:.3f} "
                  f"per_op={per_op_ms:.3f} bound={b_ms:.3f} ({b_by})", flush=True)
            if max(rel, border) > MB_TOL:
                fail(f"mbconv kernel disagrees with its plain version at {name}: {rel:.3e}")
        h = blk(h)
    tot = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "per_op_ms", "bound_ms")}
    slower = [r["block"] for r in rows if r["ms"] > r["per_op_ms"]]
    phase(f"mbconv blocks={len(rows)} B={images.shape[0]} tol={MB_TOL:.2e} (borders too) summed: " + kv(
        tot, "ms", "plain_ms", "per_op_ms", "bound_ms") + f" slower_than_per_op={slower}")
    report["blocks"] = rows
    report["total"] = tot
    return rows


def check_mbconv_edges(net_f, dev):
    """The MBConv kernel off the path's shapes: B 1 and 130, a 15 plane, relu6, no SE, no expand, k 7, a
    big expand bias, :data:`FORCED_MB_PLANS`."""
    gen = gen_on(dev, 29)

    def params(i):
        fb = net_f.fused_blocks[str(i)]
        return {n: getattr(fb, n) for n in fb.param_names}, dict(fb.cfg)

    def rnd(*shape, scale=1.0, dtype=F32):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(dtype)

    cases = []
    for name, i, b, hw, change in [("block4b", 6, 130, 15, {}), ("block5b", 9, 1, 15, {}),
        ("block2b relu6", 2, 130, 15, {"activation": "relu6"}), ("block6b no SE", 12, 130, 7, {"has_se": False}),
        ("block1a no expand", 0, 1, 15, {}), ("block1a no expand", 0, 130, 15, {}),
        ("block2b b_exp x50", 2, 130, 15, {"b_exp": 50.0})]:
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
            b_dw=rnd(ce, scale=0.1), w_se1=rnd(ce, 8, scale=0.2), b_se1=rnd(8, scale=0.1), w_se2=rnd(8, ce,
            scale=0.2), b_se2=rnd(ce, scale=0.1), w_proj=rnd(1, 1, ce, cout, scale=0.2), b_proj=rnd(cout, scale=0.1))
    cfg7 = dict(kernel=7, stride=1, has_expand=True, has_se=True, residual=True, activation="swish")
    cases.append(("k7 random weights B=130 15x15", mb.prepare_params(p7, cfg7), cfg7, 130, 15, None))
    for name, i, hw, plan in FORCED_MB_PLANS:
        q, cfg = params(i)
        cases.append((f"{name} B=130 {hw}x{hw} plan {plan}", q, cfg, 130, hw, plan))
    return run_mbconv_cases(cases, gen)


def run_mbconv_cases(cases, gen):
    """Cases on N(0, 1) input: within MB_TOL, borders too; shared memory = ``plane_smem``."""
    out = []
    for name, q, cfg, b, hw, plan in cases:
        cout_, ce_ = q["w_proj_t"].shape
        c_in = q["w_exp_t"].shape[1] if "w_exp_t" in q else ce_
        s_ = q["w_se1"].shape[1] if "w_se1" in q else 0
        geo = (hw, hw, cfg["kernel"], c_in, ce_, cout_, s_)
        pl = plan or mb.plane_plan(*geo, "w_exp_t" in q)
        smem = mb.plane_smem(*geo, "w_exp_t" in q, *pl)
        if smem < 0 or build._lib("mbconv").mbconv_smem(*geo, int("w_exp_t" in q), *pl) != smem:
            fail(f"mbconv plan {pl} ({name}): the kernel refuses it or its shared "
                 f"memory differs from ops.mbconv_kernel.plane_smem ({smem})")
        x = torch.randn((b, hw, hw, c_in), generator=gen, device=gen.device).to(BF16).permute(0, 3, 1, 2)
        _, _, (rel, border), eq, _, _ = run_mbconv_pair(x, q, cfg, plan)
        print(f"  mbconv edge {name}: rel={rel:.2e} border={border:.2e} bit_equal={100 * eq:.2f}%", flush=True)
        if rel > MB_TOL or border > MB_TOL:
            fail(f"mbconv kernel disagrees with its plain version ({name})")
        out.append(dict(case=name, rel_err=rel, border_rel_err=border, bit_equal=eq))
    return out


def check_s2d_stem(np_vars, net, net_f, images, dev):
    """The s2d stem vs the stride-2 one at fp32 (2e-5); both timed in bf16."""
    kw = dict(resolution=RES, dtype=F32, device=dev)
    plain32, s2d32 = make_infer_fn(np_vars, "b0", **kw), make_infer_fn(np_vars, "b0", space_to_depth=True, **kw)
    if not s2d32.space_to_depth or plain32.space_to_depth:
        fail("the space-to-depth fold is missing")
    a, b = plain32.stem(images), s2d32.stem(images)
    err = (a - b).abs().max().item()
    ok = bool(torch.allclose(b, a, rtol=2e-5, atol=2e-5))
    scale = a.abs().max().item()
    del a, b
    ms_plain = cuda_ms(lambda: net.stem(images), reps=5)
    ms_s2d = cuda_ms(lambda: net_f.stem(images), reps=5)
    phase(f"s2d stem (fp32, B={images.shape[0]}): max_gap={err:.3e} of {scale:.3f} within_2e-5={ok}; bf16 "
          f"ms plain={ms_plain:.3f} s2d={ms_s2d:.3f}")
    if not ok:
        fail("the space-to-depth stem disagrees with the plain stem")
    return dict(max_abs_err=err, max_abs=scale, plain_stem_ms=ms_plain, s2d_stem_ms=ms_s2d)


def check_fused_path(net, net_f, svc_u, info, gallery, labels, images, idx, idx_oracle, plain_sec, launches, dev,
        smi, flops, path="fused", n_fused=12):
    """The plain line on the fused module: timed, no host sync; embedding within 0.05 of per-op; labels but
    at swapped near-ties (2^-7); traced."""
    if len(net_f.fused_blocks) != n_fused:
        fail(f"{path}: the module fuses {len(net_f.fused_blocks)} blocks, not {n_fused}")
    svc = RecognitionService(None, info, gallery, labels=labels, n_valid=GALLERY, serving_fn=net_f,
            pca_dim=124, pca_scan="packed", device=dev)
    torch.cuda.reset_peak_memory_stats()
    counted(lambda: svc.identify_device(images))
    out, ms = timed(lambda: svc.identify_device(images))
    sec = ms / 1e3
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    out2 = no_sync(lambda: svc.identify_device(images))
    sync()
    calls = TIMED_CALLS + 2
    check_launches(path, launches, mbconv=n_fused * calls, tilemin2_packed=calls, topk_l2=calls)
    if not bool((out2 == out).all()):
        fail(f"{path}: the answers changed under sync debug mode")
    embed_ms = host_ms(lambda: svc._embed(images), TIMED_CALLS)
    eu, ef = net(images)["embedding"], net_f(images)["embedding"]
    emb_rel = ((ef - eu).abs().max() / eu.abs().max()).item()
    nu, nf = _unit(eu), _unit(ef)
    idx_f = out.to(torch.int64)
    gf, gu = gallery[idx_f].to(F32), gallery[torch.as_tensor(idx, device=dev)].to(F32)
    d_ff, d_fu, d_uf, d_uu = (((e - g) ** 2).sum(1) for e, g in ((nf, gf), (nf, gu), (nu, gf), (nu, gu)))
    swapped = ((d_ff <= d_fu + 2.0**-7 * torch.maximum(d_ff, d_fu))
            & (d_uu <= d_uf + 2.0**-7 * torch.maximum(d_uf, d_uu))).cpu().numpy()
    idx_f = host(idx_f)
    label_differs = labels[idx_f] != labels[idx]
    row = dict(img_s=len(idx_f) / sec, ms=1e3 * sec, embed_ms=embed_ms, speedup_over_plain_line=plain_sec / sec,
            error_pct=pct(labels[idx_f] != np.arange(len(idx_f))), row_agreement_plain_line_pct=pct(idx_f == idx),
            label_agreement_plain_line_pct=pct(~label_differs), row_agreement_oracle_pct=pct(idx_f == idx_oracle),
            label_agreement_oracle_pct=pct(labels[idx_f] == labels[idx_oracle]),
            label_differs_not_near_tie=int(np.sum(label_differs & ~swapped)), embedding_rel_diff=emb_rel,
            escalated_pct=pct(svc.last_escalated), peak_gib=peak_gib, launches=launches[path],
            **mfu(flops, 1e3 * sec))
    phase(f"{path} path ({smi}): " + kv(row, *row) + "; no host sync")
    if emb_rel > 0.05:
        fail(f"{path}: the embedding differs from the per-op one by {emb_rel:.4f} > 0.05")
    if row["label_differs_not_near_tie"]:
        fail(f"{path}: labels differ from the per-op line's beyond near-ties")
    for line, s_ in (("plain", svc_u), (path, svc)):
        row[f"trace_{line}"] = trace_line(line, lambda s_=s_: s_.identify_device(images), "mbconv_sm90")
    return row


def kv(row, *keys):
    """``key=value`` of ``keys`` (default all but the first)."""
    return " ".join(f"{k}={round(row[k], 4) if isinstance(row[k], float) else row[k]}" for k in keys or list(row)[1:])


def trace_line(line, fn, kernel):
    """``trace_call`` of one call with ``kernel``'s ms; None where not measured."""
    try:
        tr = trace_call(fn)
    except Exception as e:  # noqa: BLE001  (a measurement, not a gate)
        print(f"  {line} line trace not measured: {type(e).__name__}: {str(e).splitlines()[0]}", flush=True)
        return None
    if tr is None:
        return None
    by = tr.pop("by_name")
    tr["kernel_ms"] = sum(v for k, v in by.items() if kernel in k)
    tr["top"] = sorted(by.items(), key=lambda kv_: -kv_[1])[:6]
    print(f"  {line} line, one call traced: busy={tr['busy_ms']:.2f} ms window={tr['window_ms']:.2f} ms "
          f"idle={100 * tr['idle_share']:.1f}% events={tr['events']} {kernel}={tr['kernel_ms']:.2f} ms "
          f"top={[(k[:60], round(v, 3)) for k, v in tr['top']]}", flush=True)
    return tr

# chi2 1-NN and the exact brute-force harness over feature files
CHI2_B, CHI2_N, CHI2_D = 1024, 102_400, 1536  # scripts/chi2_cost.py's defaults
CHI2_TOL = 2.0**-16  # rcp.approx.ftz: 1 ulp a term
CHI2_SLOW_ITERS = 1  # chi2_cost --iters of the eager chi2/KL scans
BF_CLASSES, BF_PER_CLASS = 1024, 100
PEAK_SFU_RCP = 16 * 132 * 1.98e9


def chi2_rescore(q, g, rows):
    """fp32 ``sum (g - q)^2 / max(g + q, 1e-30)`` of each query and its row."""
    r = g[rows.long()].to(F32)
    return ((r - q).square() / (r + q).clamp_min(1e-30)).sum(dim=1)


def chi2_bound(b, n, d, g_bytes):
    """(bound ms, terms): an SFU reciprocal (16/clock/SM) or 6 fp32 operations a triple, or the bytes."""
    triples = float(b) * n * d
    t = dict(reciprocals=triples / PEAK_SFU_RCP * 1e3, fp32=6.0 * triples / PEAK_FP32_FLOPS * 1e3,
            bytes=(n * d * g_bytes + b * d * 4 + b * 8) / PEAK_HBM_BYTES * 1e3)
    return max(t.values()), t


def check_chi2(q, g, n_valid, tag, timed=False):
    """chi2 kernel vs plain: minima and rescored rows within CHI2_TOL. (row, min, rows)."""
    kd, ki = build.launch_chi2(q, g, n_valid)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    pd, pi = plain.chi2_nn_plain(q, g, n_valid)
    end.record()
    sync()
    plain_ms = start.elapsed_time(end)  # one call: it takes seconds
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
    phase(f"chi2 {tag} {row['shape']}: max_rel_gap={rel:.2e} indices_equal={100 * idx_eq:.3f}%"
          + (f"; ms={row['ms']:.3f} plain={plain_ms:.1f} bound={row['bound_ms']:.3f} (reciprocals; fp32 "
            f"{terms['fp32']:.3f}, bytes {terms['bytes']:.3f})" if timed else ""))
    if not ok:
        fail(f"chi2 kernel disagrees with its plain version ({tag}, {row['shape']})")
    return row, kd, ki


def check_chi2_edges(dev):
    """chi2 at edge shapes: B 1 and 130, D 100, zeros past n_valid, bf16 and equal rows."""
    gen = gen_on(dev, 29)

    def rows(m, d):
        x = torch.rand((m, d), generator=gen, device=dev)
        return x / x.sum(dim=1, keepdim=True)

    n, nv, d = 1000, 900, 100
    g = rows(n, d)
    g[nv:] = 0.0
    out = []
    for b in (1, 130):
        q = rows(b, d)
        q[::2] *= 0.01
        unmasked = plain.chi2_nn_plain(q, g, n)[1]
        if not bool((unmasked >= nv).any()):
            fail("edge case does not exercise the row mask")
        for gal, nv_ in ((g, nv), (g.to(BF16), nv), (g, 896)):
            out.append(check_chi2(q, gal, nv_, "edge")[0])
        dup = g.clone()
        dup[[300, 520, 777]] = dup[40].clone()  # four equal rows
        q2 = q.clone()
        q2[0] = dup[40]
        if b > 1:
            dup[[610, 611]] = q2[1]  # a query's exact match, twice
        row, kd, ki = check_chi2(q2, dup, nv, "ties")
        if ki[0].item() != 40 or kd[0].item() != 0.0 or (b > 1 and ki[1].item() != 610):
            fail(f"chi2 kernel broke the lowest-row tie rule: {ki[:2].tolist()}")
        out.append(row)
    return out


class Recording:
    """A matcher that keeps its last ``SearchResult``."""
    def __init__(self, matcher):
        self.matcher, self.name, self.set_budget = matcher, matcher.name, matcher.set_budget

    def search(self, queries):
        self.last = self.matcher.search(queries)
        return self.last


def run_chi2_slice(dev, launches, smi):
    """chi2 checks, ``chi2_cost`` and the brute-force line: (kernel row, lines)."""
    import tempfile

    from fast_image_recognition_tpu_torch.config import DistanceKind
    from fast_image_recognition_tpu_torch.data import (load_feature_file, make_gallery_and_probes,
        make_synthetic_gallery, normalize_features, write_feature_file)
    from fast_image_recognition_tpu_torch.ops.chi2_kernel import chi2_nn
    from fast_image_recognition_tpu_torch.scripts import chi2_cost
    from fast_image_recognition_tpu_torch.search import BruteForceMatcher

    # 15. the kernel at chi2_cost's shape
    g, q = chi2_cost.make_data(CHI2_N, CHI2_B, CHI2_D, dev)
    shapes = [check_chi2(q, g, CHI2_N, "kernel vs plain", timed=True)[0],
            check_chi2(q, g.to(BF16), CHI2_N, "kernel vs plain", timed=True)[0]]
    edges = check_chi2_edges(dev)
    phase(f"chi2 edge shapes: {len(edges)} cases within {CHI2_TOL:.2e}, no row past n_valid, ties to the lowest")
    del g, q

    # 16. chi2_cost, every kind
    build.reset_launch_counts()
    cost = chi2_cost.main(["--kinds", "chi2,kl", "--iters", str(CHI2_SLOW_ITERS), "--warmup", "0"])
    cost += chi2_cost.main(["--kinds", "l2,chi2_pallas,chi2_pallas_bf16"])
    iters = 5  # chi2_cost's default
    check_launches("chi2_cost", launches, chi2=2 * (iters + 2))
    by_kind = {ln["metric"].split("(")[1].split()[0]: ln for ln in cost}
    for kind, ln in by_kind.items():
        floor = 0.9 if kind == "chi2_pallas_bf16" else 1.0  # tests/test_chi2_kernel.py:49-57
        if ln["probe_agreement"] < floor:
            fail(f"chi2_cost {kind}: probe agreement {ln['probe_agreement']} < {floor}")
    phase("chi2_cost lines (" + smi + "): " + "; ".join(
        f"{k} {ln['value']} q/s ({1e3 * ln['sec_per_batch']:.1f} ms) agreement={ln['probe_agreement']}"
        for k, ln in by_kind.items()) + f"; launches={launches['chi2_cost']}")

    # 17. the brute-force harness
    t = time.time()
    feats, labels = make_synthetic_gallery(101, 10, CHI2_D, seed=5)
    names = [f"class_{c:03d}" for c in range(101)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "features.txt")
        write_feature_file(path, feats, labels, names)
        db = load_feature_file(path, CHI2_D)
    if not (np.array_equal(db.features, normalize_features(feats)) and np.array_equal(db.labels, labels)
            and db.class_names == names):
        fail("feature file round trip changed the rows")
    gal, glab, probes, plab = make_gallery_and_probes(BF_CLASSES, BF_PER_CLASS, 1, CHI2_D, seed=7)
    gal_s, probes_s = normalize_features(gal, l2=False), normalize_features(probes, l2=False)
    phase(f"feature file round trip ({db.num_images} x {CHI2_D}) exact; gallery {gal.shape}, {probes.shape[0]} "
          f"probes ({since(t)})")
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
    cases = [("l2", gal, probes, dict()), ("l2 max_features=256", gal, probes, dict(max_features=256)), ("int8", gal,
            probes, dict(precision="int8")), ("chi2", gal_s, probes_s, dict(kind=DistanceKind.CHI2)), ("kl", gal_s,
            probes_s, dict(kind=DistanceKind.KL))]
    for name, g_np, p_np, kw in cases:
        m = Recording(BruteForceMatcher(g_np, device=dev, **kw))
        res = counted(lambda: evaluate_matcher(m, glab, p_np, plab, verbose=False, warmup=name not in ("chi2", "kl")))
        check_launches(f"matcher {name}", launches, **({"tilemin_quant": 2} if name == "int8" else {}))
        idx = m.last.indices
        row = dict(matcher=name, summary=res.summary(), ms_per_image=res.ms_per_image, error_pct=res.error_rate)
        if name in ("l2", "int8"):
            row["l2_fp64_argmin_agreement_pct"] = pct(idx == host(oracle))
        if name == "l2" and not near_tie_ok(idx):
            fail("the L2 matcher's rows are not the fp64 argmin's beyond near-ties")
        if name == "chi2":
            dn, inn = counted(lambda: chi2_nn(torch.from_numpy(probes_s).to(dev), torch.from_numpy(gal_s).to(dev)))
            check_launches("chi2_nn (brute-force data)", launches, chi2=1)
            dn, inn = host(dn), host(inn)
            row["chi2_nn_rows_equal_pct"] = pct(idx == inn)
            if not (np.abs(m.last.distances - dn) <= CHI2_TOL * dn).all():
                fail("the chi2 matcher's rows differ from chi2_nn's beyond near-ties")
        bf_rows.append(row)
        extra = kv(row, *[k for k in ("l2_fp64_argmin_agreement_pct", "chi2_nn_rows_equal_pct") if k in row])
        phase(f"brute-force {name}: {res.summary()} ({smi}) {extra} launches={launches[f'matcher {name}']}")
        del m
    del d64, qt, gt
    # 17'. classifiers and verification
    cls_rows = run_classifiers(gal, glab, probes, plab, dev, smi)

    s_by = {k: by_kind[k]["sec_per_batch"] * 1e3 for k in by_kind}
    kernel_row = dict(name="chi2", route="cuda", source="fast_image_recognition_tpu_torch/kernels/chi2.cu",
        replaces="fast_image_recognition_tpu/ops/chi2_kernel.py:55",
        launches=launches["chi2_cost"]["chi2"], launches_by_path={p: c["chi2"] for p, c in launches.items()},
        **{k: shapes[0][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        bound_detail=shapes[0]["bound_detail"],
        yardstick_streamed_topk_chi2_ms=s_by["chi2"], yardstick_streamed_topk_l2_ms=s_by["l2"],
        shapes=shapes, edges=edges)
    return kernel_row, {"chi2_cost": cost, "brute_force": bf_rows, "classifiers": cls_rows}

# bench.py --config dem / video / cascade; TWD
DEM_CLASSES, DEM_PER, DEM_DIM, DEM_BATCH = 1000, 100, 1536, 128
DEM_BUDGET = 0.01
DEM_ORACLE_PROBES = 32
VIDEO_CLASSES, VIDEO_FRAMES = 100, 20
VIDEO_TIE = 2.0**-10  # a near-tie of a video's two best sums
CASCADE_CLASSES, CASCADE_CALIB = 100, 256
CASCADE_TIE = 2.0**-8  # a near-tie of a score margin
BIND_BATCH = 64
KNN_IDS, KNN_PER = 100, 4
TWD_PROBES, TWD_ORACLE_PROBES = 1024, 16
FEATURE_REPS, TWD_REPS = 50, 4
FULL_DEM_BUDGET, FULL_DEM_PROBES = 60, 32  # FullMatrixDEM at JAX's test budget
SVC_CHECK_STEPS = 20
VIDEO_IO_VIDEOS = 10


def fusion_fp64(probes, gallery, gl, fv, num_classes, num_videos, w=100.0):
    """The video fusion in fp64 NumPy: [videos, classes] summed log-posteriors."""
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
    """[L, B] gaps of each head's two best scores and [L, B] distances to the threshold."""
    gaps, dists = [], []
    for level, scores in enumerate(pipe.level_scores(x)):
        top2 = torch.topk(scores, 2, dim=1).values
        gaps.append(top2[:, 0] - top2[:, 1])
        last = level == pipe.num_levels - 1
        dists.append(torch.full_like(top2[:, 0], math.inf) if last else (top2[:, 0] - pipe.thresholds[level]).abs())
    return torch.stack(gaps).cpu().numpy(), torch.stack(dists).cpu().numpy()


def check_cascade_decisions(what, got, want, margins):
    """``got`` equals ``want`` but on <= 1 % of images, each at a near-tie."""
    gaps, dists = margins
    levels = np.arange(gaps.shape[0])[:, None]
    reached = levels <= np.maximum(got.exit_level, want.exit_level)[None, :]
    exited = (levels == got.exit_level[None, :]) | (levels == want.exit_level[None, :])
    tie = ((reached & (dists <= CASCADE_TIE)) | (exited & (gaps <= CASCADE_TIE))).any(axis=0)
    differ = (got.predictions != want.predictions) | (got.exit_level != want.exit_level)
    if differ.mean() > 0.01 or not (tie | ~differ).all():
        fail(f"{what}: {int(differ.sum())} images differ from predict(), "
             f"{int((differ & ~tie).sum())} of them off near-ties")
    return pct(~differ), int(differ.sum()), int(tie.sum())


def check_feature_entry_points(dev, smi, g, gl, p, pl):
    """Feature-level entry points no bench line times, on the video data."""
    import importlib.util
    import tempfile

    from fast_image_recognition_tpu_torch.cascade import exits
    from fast_image_recognition_tpu_torch.data.feature_io import normalize_features
    from fast_image_recognition_tpu_torch.data.video_io import VideoDB, load_videos, write_videos
    from fast_image_recognition_tpu_torch.evaluation.video import evaluate_video_recognition, sample_probe_frames
    from fast_image_recognition_tpu_torch.search.dem import (DirectedEnumerationMatcher, FullMatrixDEM,
        dem_full_oracle_search)

    t = time.time()
    cpu = torch.device("cpu")
    row = dict(line="feature entry points", sklearn=importlib.util.find_spec("sklearn") is not None)

    # levels: unit prefixes of 256, 768, 1536
    def levels(x):
        return [(x[:, :w] / np.linalg.norm(x[:, :w], axis=1, keepdims=True)).astype(np.float32)
                for w in (256, 768, x.shape[1])]

    x_tr, x_va = levels(g), levels(p)

    w0 = (torch.randn((VIDEO_CLASSES, g.shape[1]), generator=torch.Generator().manual_seed(0)) * 0.01).numpy()
    b0 = np.zeros(VIDEO_CLASSES, np.float32)
    w_d, b_d = exits.svc_descent(x_tr[-1], gl, VIDEO_CLASSES, w0, b0, steps=SVC_CHECK_STEPS, device=dev)
    w_c, b_c = exits.svc_descent(x_tr[-1], gl, VIDEO_CLASSES, w0, b0, steps=SVC_CHECK_STEPS, device=cpu)
    row["svc_descent_max_rel_err"] = svc_err = float(max(np.abs(w_d - w_c).max() / np.abs(w_c).max(),
        np.abs(b_d - b_c).max() / max(np.abs(b_c).max(), 1e-30)))

    # LinearExitCascade on the card vs fp64 decisions of its weights
    casc = exits.LinearExitCascade.train(x_tr, gl, VIDEO_CLASSES, device=dev)
    res = casc.evaluate(x_va, device=dev)
    ties, decided = np.zeros(len(p), bool), np.zeros(len(p), bool)
    want_pred, want_level = np.zeros(len(p), np.int64), np.full(len(p), len(x_va) - 1, np.int64)
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
    row["linear_exits_equal_fp64_pct"] = pct(~differ)
    row["linear_exits_breaks"] = [float(v) for v in res.break_counts]
    row["linear_exits_error_pct"] = pct(res.predictions != pl)
    entropy = exits.entropy_exit_cascade(probs, threshold=0.5)
    row["entropy_exits_breaks"] = [float(v) for v in entropy.break_counts]

    knn_d = exits.sequential_knn_cascade(x_tr, gl, x_va, device=dev)
    knn_c = exits.sequential_knn_cascade(x_tr, gl, x_va, device=cpu)
    hyb_d = exits.knn_exits_with_final_classifier(x_tr, gl, x_va, VIDEO_CLASSES, device=dev)
    hyb_c = exits.knn_exits_with_final_classifier(x_tr, gl, x_va, VIDEO_CLASSES, device=cpu)

    def same(a, b):
        return pct((a.predictions == b.predictions) & (a.exit_level == b.exit_level))

    row["knn_exits_card_vs_cpu_equal_pct"], row["knn_svc_exits_card_vs_cpu_equal_pct"] = same(knn_d, knn_c), same(hyb_d, hyb_c)

    full = FullMatrixDEM(g, gl, seed=3, device=dev)
    full.set_budget(FULL_DEM_BUDGET)
    fr = full.search(p[:FULL_DEM_PROBES])
    p_full, starts = host(full._p_full), host(full._start_idx)
    full_rows = full_close = 0
    for i in range(FULL_DEM_PROBES):
        oi, _, oc = dem_full_oracle_search(p[i], g, p_full, starts, full.threshold, FULL_DEM_BUDGET)
        full_rows += int(fr.indices[i] == oi)
        full_close += int(abs(int(round(fr.checked_fraction[i] * g.shape[0])) - oc) <= 2)
    row["full_dem_oracle_rows_equal_pct"] = 100.0 * full_rows / FULL_DEM_PROBES
    row["full_dem_oracle_checked_within_2_pct"] = 100.0 * full_close / FULL_DEM_PROBES
    del full, p_full

    sub = pl < VIDEO_IO_VIDEOS
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "videos.txt")
        write_videos(path, p[sub], pl[sub], np.arange(VIDEO_IO_VIDEOS), [f"person{i}" for i in range(VIDEO_IO_VIDEOS)])
        back = load_videos(path, p.shape[1])
    io_ok = (np.array_equal(back.frame_video, pl[sub]) and np.array_equal(back.video_person, np.arange(VIDEO_IO_VIDEOS))
            and back.person_names == [f"person{i}" for i in range(VIDEO_IO_VIDEOS)]
            and np.abs(back.frames - normalize_features(p[sub])).max() <= 1e-6)
    row["video_io_round_trip"] = bool(io_ok)

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
    phase(f"feature entry points ({len(p)} x {p.shape[1]}, {VIDEO_CLASSES} classes, {smi}): " + kv(
        row, *[k for k in row if k != "video_eval"]) + f" near_ties_differ={int((differ & ties).sum())} frames="
        f"{len(idx)} video_eval=" + json.dumps(row["video_eval"]))
    if svc_err > 1e-4:
        fail("svc_descent on the card drifts from its CPU run")
    if (differ & ~ties).any():
        fail("LinearExitCascade's decisions differ from fp64 beyond near-ties")
    if row["knn_exits_card_vs_cpu_equal_pct"] < 99.0 or row["knn_svc_exits_card_vs_cpu_equal_pct"] < 99.0:
        fail("the kNN exit cascades differ between the card and the CPU")
    if full_rows < int(0.9 * FULL_DEM_PROBES) or full_close < int(0.85 * FULL_DEM_PROBES):
        fail("FullMatrixDEM disagrees with dem_full_oracle_search (tests/test_dem.py:232-251 bounds)")
    if not io_ok:
        fail("the video text format does not round-trip")
    if frame_gap > 0.01 * len(idx) or video_gap > 1:
        fail("evaluate_video_recognition differs between the card and the CPU")
    return row


def engine_line(path, model, variables, taps, dev, launches, engine="folded"):
    """bench.py ``--config cascade`` over ``model``: ``predict_fused`` timed, no host sync, ``predict()``'s
    decisions but near-ties; a bind line times the plain forward."""
    t = time.time()
    probe = model(torch.zeros((1, RES, RES, 3), device=dev), taps=taps)
    dims = [int(probe["taps"][tap].shape[-1]) for tap in taps] + [int(probe["embedding"].shape[-1])]
    rng = np.random.default_rng(0)
    coefs = [rng.normal(0, 0.1, (CASCADE_CLASSES, d)).astype(np.float32) for d in dims]
    intercepts = [np.zeros(CASCADE_CLASSES, np.float32) for _ in dims]
    pipe = SequentialInferencePipeline(model, variables, taps, coefs, intercepts, thresholds=[0.0] * (len(dims) - 1),
            engine=engine, device=dev)
    x = torch.from_numpy(rng.normal(size=(BATCH, RES, RES, 3)).astype(np.float32)).to(dev)
    pipe.calibrate(x[:CASCADE_CALIB])
    caps = pipe.capacities_for(BATCH, slack=SLACK)
    sync()
    phase(f"{path} built: taps={list(taps)} dims={dims} thresholds={[round(v, 4) for v in pipe.thresholds]} "
          f"survivors={[round(v, 4) for v in pipe.survivor_fractions]} capacities={caps} ({since(t)})")
    build.reset_launch_counts()
    fused = pipe.fused_fn(BATCH, slack=SLACK)
    res = pipe.predict_fused(x, slack=SLACK)  # warm-up and the answers
    if not np.array_equal(no_sync(lambda: fused(x)).cpu().numpy()[:BATCH], res.predictions):
        fail(f"{path}: predict_fused's answers changed under sync debug mode")
    ms = host_ms(lambda: fused(x), TIMED_CALLS)
    check_launches(path, launches)
    want = pipe.predict(x)
    margins = cascade_margins(pipe, x)
    full = pipe.predict_fused(x, capacities=[BATCH] * pipe.num_levels)
    full_eq, full_diff, full_ties = check_cascade_decisions(f"{path}: predict_fused at full capacities", full, want,
            margins)
    row = dict(line=path, img_s=BATCH / ms * 1e3, ms=ms, break_counts=[float(v) for v in res.break_counts],
            forced_pct=100.0 * res.forced_fraction,
            agreement_pct=pct(res.predictions == want.predictions), capacities=list(caps),
            full_capacity_equal_pct=full_eq, full_capacity_differ=full_diff, near_tie_images=full_ties)
    if engine == "bind":
        row["plain_ms"] = host_ms(lambda: model(x)["embedding"][0, :8], TIMED_CALLS)
        row["speedup_vs_plain"] = row["plain_ms"] / ms
        phase(f"{path} (bind, SVC exits, B={BATCH}): " + kv(row) + f"; no host sync; " f"launches={launches[path]}")
    return row, dict(pipe=pipe, x=x, rng=rng, want=want, margins=margins, coefs=coefs, intercepts=intercepts)


def run_feature_configs(dev, launches, smi):
    """bench.py's dem, video and cascade configs and the TWD classifiers."""
    from fast_image_recognition_tpu_torch.cascade import ConventionalTWD, ProposedTWD, TWDType
    from fast_image_recognition_tpu_torch.cascade.twd import proposed_twd_oracle
    from fast_image_recognition_tpu_torch.data import make_gallery_and_probes
    from fast_image_recognition_tpu_torch.evaluation.video import make_video_fusion_fn
    from fast_image_recognition_tpu_torch.search.dem import DirectedEnumerationMatcher, dem_oracle_search

    lines = {}

    # 18. bench.py --config dem: gather at budget 1 %
    t = time.time()
    g, gl, p, pl = make_gallery_and_probes(DEM_CLASSES, DEM_PER, 1, DEM_DIM, seed=0)
    data_s = time.time() - t
    t = time.time()
    dem = DirectedEnumerationMatcher(g, gl, probe_mode="gather", seed=0, device=dev)
    budget = int(DEM_BUDGET * g.shape[0])
    dem.set_budget(budget)
    sync()
    build_s = time.time() - t
    probes = torch.from_numpy(p[:DEM_BATCH]).to(dev)
    b = probes.shape[0]
    idx, _, checked = (host(x) for x in counted(lambda: dem.search_device(probes)))
    out = no_sync(lambda: dem.search_device(probes))
    if not np.array_equal(out[0].cpu().numpy(), idx):
        fail("dem search_device answers changed under sync debug mode")
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
    pivots16 = pct(dem_dev16.index.pivot_indices == dem.index.pivot_indices)
    # the bf16 device build answers as the host build: labels >= 97 %
    dem_dev16.set_budget(budget)
    idx_d16 = dem_dev16.search_device(probes)[0].cpu().numpy()
    dev16_labels = pct(gl[idx_d16] == gl[idx])
    del dem_dev, dem_dev16
    exact = DirectedEnumerationMatcher(g, gl, probe_mode="exact", seed=0, device=dev)
    exact.set_budget(budget)
    idx_e = exact.search_device(probes)[0].cpu().numpy()
    del exact
    row = dict(line="dem gather", queries_s=qps, error_pct=pct(gl[idx] != pl[:b]),
            checked_pct=100.0 * float(checked.mean()) / n, budget=budget, pivots=len(dem.index.pivot_indices),
            oracle_rows_equal_pct=100.0 * oracle_rows / DEM_ORACLE_PROBES,
            oracle_checked_within_2_pct=100.0 * oracle_close / DEM_ORACLE_PROBES,
            exact_mode_label_agreement_pct=pct(gl[idx] == gl[idx_e]), exact_mode_row_agreement_pct=pct(idx == idx_e),
            from_device_fp32_same_pivots=same_pivots, from_device_bf16_pivots_equal_pct=pivots16,
            from_device_bf16_label_agreement_pct=dev16_labels, ms=dem_ms, timed_calls=FEATURE_REPS)
    lines["dem"] = row
    phase(f"dem gather ({n} x {DEM_DIM}, batch {b}, data {data_s:.1f} s, host build {build_s:.1f} s, {smi}, "
          f"CUDA events): " + kv(row) + f"; no host sync; launches={launches['dem']}")
    if (oracle_rows < 0.92 * DEM_ORACLE_PROBES or oracle_close < 0.9 * DEM_ORACLE_PROBES
            or row["exact_mode_label_agreement_pct"] < 97.0 or not same_pivots or dev16_labels < 97.0):
        fail("dem gather disagrees with its oracle, its exact mode or its device build")
    del dem

    # 19. the TWD classifiers over the same gallery
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
                unreliable_pct=100.0 * unreliable / len(tq), error_pct=pct(preds[: len(p)] != pl)))
    check_launches("twd", launches)
    proposed = classifiers[0].predict(tq[:TWD_ORACLE_PROBES])
    want = np.asarray([proposed_twd_oracle(tq[i], g, gl, 32, 0.7)[0] for i in range(TWD_ORACLE_PROBES)])
    twd_equal = int((proposed == want).sum())
    lines["twd"] = dict(rows=twd_rows, oracle_equal=twd_equal, oracle_probes=TWD_ORACLE_PROBES)
    phase(f"twd over the dem gallery ({len(tq)} probes, CUDA events, {smi}): " + "; ".join(
        f"{r['line']}: " + kv(r, "ms_per_probe", "unreliable_pct", "error_pct") for r in twd_rows)
        + f"; Proposed = oracle on {twd_equal}/{TWD_ORACLE_PROBES}; launches={launches['twd']}")
    if twd_equal != TWD_ORACLE_PROBES:
        fail("Proposed TWD disagrees with proposed_twd_oracle")
    del classifiers, tq
    # 19'. sw, proj, kd-forest
    lines["ann"] = run_ann_matchers(g, gl, p, pl, dev, launches, smi)
    del g, gl, p, pl

    # 20. bench.py --config video
    g, gl, p, pl = make_gallery_and_probes(VIDEO_CLASSES, VIDEO_FRAMES, VIDEO_FRAMES, 1536, seed=0)
    fuse = make_video_fusion_fn(g, gl, VIDEO_CLASSES, VIDEO_CLASSES, device=dev)
    pv, fv = torch.from_numpy(p).to(dev), torch.from_numpy(pl.astype(np.int64)).to(dev)
    preds = counted(lambda: fuse(pv, fv)).cpu().numpy()
    video_ms = cuda_ms(lambda: fuse(pv, fv), FEATURE_REPS)
    fps = len(p) / video_ms * 1e3
    check_launches("video", launches)
    ref = fusion_fp64(p, g, gl, pl, VIDEO_CLASSES, VIDEO_CLASSES)
    top2 = np.sort(ref, axis=1)[:, -2:]
    tie = top2[:, 1] - top2[:, 0] <= VIDEO_TIE * np.maximum(1.0, np.abs(top2[:, 1]))
    equal = preds == ref.argmax(1)
    lines["video"] = dict(line="video fusion", frames_s=fps, ms=video_ms, timed_calls=FEATURE_REPS,
          error_pct=pct(preds != np.arange(VIDEO_CLASSES)), fp64_equal_pct=100.0 * float(equal.mean()),
          near_ties=int(tie.sum()))
    phase(f"video fusion ({g.shape[0]} rows, {len(p)} frames, {VIDEO_CLASSES} videos, CUDA events, {smi}): "
          + kv(lines["video"], "frames_s", "ms", "error_pct", "fp64_equal_pct", "near_ties")
          + f" launches={launches['video']}")
    if not (equal | tie).all():
        fail("the video fusion disagrees with fp64 beyond near-ties")
    del pv, fv, fuse
    lines["entry_points"] = check_feature_entry_points(dev, smi, g, gl, p, pl)
    del g, gl, p, pl

    # 21. bench.py --config cascade: B0@224 own init, deep taps, SVC heads
    model, variables = create_efficientnet("b0", 0, seed=0, resolution=RES, device=dev)
    taps = default_taps("b0", "deep")
    row, ctx = engine_line("cascade engine", model, variables, taps, dev, launches)
    pipe, x, rng, want, margins, coefs, intercepts = (ctx[k] for k in ("pipe", "x", "rng", "want", "margins", "coefs",
            "intercepts"))
    pooled = pipe.predict_pooled(x, bucket=BATCH, warmup=True)
    ms_pooled = host_ms(lambda: pipe.predict_pooled(x, bucket=BATCH), TIMED_CALLS)
    pooled_eq, pooled_diff, _ = check_cascade_decisions("predict_pooled", pooled, want, margins)
    info = backbone_info("b0")
    serve = make_serving_fn(variables, info, resolution=RES, device=dev)
    ms_plain = host_ms(lambda: serve(x)["embedding"][0, :8], TIMED_CALLS)
    pipe_b = SequentialInferencePipeline(model, None, taps, coefs, intercepts, thresholds=pipe.thresholds,
            engine="bind", device=dev)
    bind_agree = pct(pipe_b.predict(x[:BIND_BATCH]).predictions == pipe.predict(x[:BIND_BATCH]).predictions)
    per_level, cumulative = pipe.measure_segment_latency(x, iters=3)
    if not (np.isfinite(per_level).all() and (per_level > 0).all() and len(per_level) == pipe.num_levels):
        fail(f"measure_segment_latency gave {per_level}")
    seg0_ms = float(per_level[0]) * BATCH
    noise = (pipe.level_scores(x, levels=1)[0][:CASCADE_CALIB]
            - pipe.level_scores(x[:CASCADE_CALIB], levels=1)[0]).abs().max().item()
    row.update(plain_img_s=BATCH / ms_plain * 1e3, plain_ms=ms_plain, speedup_vs_plain=ms_plain / row["ms"],
            pooled_img_s=BATCH / ms_pooled * 1e3, pooled_ms=ms_pooled, pooled_equal_pct=pooled_eq,
            pooled_differ=pooled_diff, bind_vs_folded_label_agreement_pct=bind_agree, level0_segment_ms=seg0_ms,
            level0_score_batch_noise=noise, segment_ms_per_image=[float(v) for v in per_level],
            cumulative_ms_per_image=[float(v) for v in cumulative])
    phase(f"cascade engine (folded, SVC exits, batch {BATCH}, {smi}): " + kv(row, *[k for k in row if k not in ("line",
          "cumulative_ms_per_image")]) + f"; no host sync; launches={launches['cascade engine']}")
    if bind_agree < 90.0:
        fail("the bind engine agrees with the folded one on < 90 % of labels")
    del pipe_b, serve

    # the kNN head, one call
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
    phase(f"cascade engine, kNN exits (ratio 0.8, {KNN_IDS} x {KNN_PER} enrolled): " + kv(row["knn"], *row["knn"]))
    del knn, pipe, model, x
    return lines


def png_bytes(a: np.ndarray) -> bytes:
    """An 8-bit RGB PNG, no filter, written with zlib."""
    h, w, _ = a.shape
    chunk = lambda k, d: struct.pack(">I", len(d)) + k + d + struct.pack(">I", zlib.crc32(k + d))  # noqa: E731
    raw = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, -1)], 1).tobytes()
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def bmp_bytes(a: np.ndarray) -> bytes:
    """A 24-bit BMP, rows bottom-up (width x 3 a multiple of 4)."""
    h, w, _ = a.shape
    return (b"BM" + struct.pack("<IHHI", 54 + a.size, 0, 0, 54)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, a.size, 2835, 2835, 0, 0) + a[::-1, :, ::-1].tobytes())


TRAIN_STEPS = 48  # one epoch at the script's defaults: 128 classes x 48 / 128
P1_CLASSES, P1_BATCH = 128, 128  # phase 1: 4 images a class, 4 steps
EXTRACT_CLASSES, IRV2_IMAGES = 64, 1024


def run_training(dev, launches, smi, tmp):
    """``train_serving_backbone.main`` for one epoch under sync debug "error"; a bf16 step card vs CPU;
    phase 1 over the trained B0."""
    from fast_image_recognition_tpu_torch.scripts import train_serving_backbone
    from fast_image_recognition_tpu_torch.utils import checkpoint as ckpt_mod

    events, losses, saved, trainers = [], [], [], []
    step0, save0 = MultiExitTrainer._step, ckpt_mod.save_variables

    def step(self, *a):
        trainers[:] = [self]
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        losses.append(no_sync(lambda: step0(self, *a)))
        return losses[-1]

    MultiExitTrainer._step = step
    ckpt_mod.save_variables = lambda path, v: (saved.append(v), save0(path, v))
    out = os.path.join(tmp, "b0.msgpack")
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    try:
        res = train_serving_backbone.main(["--epochs", "1", "--out", out], device=dev)
    finally:
        MultiExitTrainer._step, ckpt_mod.save_variables = step0, save0
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    sync()
    check_launches("train", launches)
    trainer, n = trainers[0], len(losses)
    step_ms = events[1].elapsed_time(end) / (n - 1)  # steps 2..n
    loss = torch.stack(losses).float().cpu().numpy()
    got = load_variables(out, template=saved[-1])
    same = all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(_leaves(got), _leaves(saved[-1])))
    info = backbone_info("b0")
    imgs, labels = device_dataset(64, 1, RES, seed=12000, device=dev)
    with torch.no_grad():
        own = trainer.model(trainer._prep(imgs))["embedding"]
        emb = make_serving_fn(saved[-1], info, resolution=RES, device=dev)(imgs)["embedding"]
        f32 = create_efficientnet("b0", 0, resolution=RES, dtype=F32, device=dev)[0].load_variables(saved[-1])
        ref = f32(trainer._prep(imgs))["embedding"]
    fold_rel, serve_rel, own_rel = (((a - b).abs().max() / b.abs().max()).item() for a, b in
            ((emb, own), (emb, ref), (own, ref)))
    del f32
    row = dict(line="train b0@224", steps=n, step_ms=step_ms, img_s=128 / step_ms * 1e3, first_loss=float(loss[0]),
            last8_loss=float(loss[-8:].mean()), val_acc=res["last_val_acc"],
            peak_gib=torch.cuda.max_memory_allocated() / 2**30, checkpoint_bytes=os.path.getsize(out),
            readback_equal=same, serving_vs_trainer=fold_rel, serving_vs_fp32=serve_rel, trainer_vs_fp32=own_rel,
            seconds=res["train_seconds"])
    phase(f"train b0@224 (train_serving_backbone --epochs 1, {smi}, CUDA events over steps 2-{n}): " + kv(row)
          + "; no host sync in a step")
    if n != TRAIN_STEPS or not np.isfinite(loss).all() or not row["last8_loss"] < row["first_loss"] or not same \
            or not serve_rel <= max(0.02, 1.25 * own_rel):  # bf16 alone misses fp32 by > 0.02 here
        fail("training: a loss is not finite or did not fall, or the checkpoint does not read back and serve")

    # a bf16 phase-2 step of 8, card and CPU
    state, heads, cfg = trainer.variables, trainer.head_arrays(), trainer.config
    x8, y8 = imgs[:8], torch.as_tensor(np.arange(8) % 4)
    cls_w = torch.tensor(class_weights(y8.numpy(), cfg.num_classes))

    def one_step(d, masks=None):
        net = create_efficientnet("b0", 0, resolution=RES, device=d)[0]
        t = MultiExitTrainer(net, state, cfg, preprocess=lambda x: (x - mean.to(d)) / std.to(d), device=d)
        for h, a in zip(t.heads, heads):
            for k in h:
                h[k].data.copy_(torch.from_numpy(a[k]))
        net.drop_masks = None if masks is None else (lambda i, b: masks[i].to(d))
        opt = t._optimizer(True, cfg.phase2_lr)
        loss = t._step(opt, x8.to(d), torch.arange(8, device=d), y8.to(d), cls_w.to(d)).float().item()
        grads = [p.grad.float().cpu() for p in net.parameters()]
        return loss, grads, t.variables["batch_stats"], {i: m.cpu() for i, m in net.last_masks.items()}

    mean, std = (torch.tensor(v) for v in (MEAN_RGB, STDDEV_RGB))
    t0 = time.time()
    lc, gc, bc, masks = one_step(dev)
    lp, gp, bp, _ = one_step(torch.device("cpu"), masks)
    norms = torch.stack([g.norm() for g in gp])
    cos = torch.stack([(a * b).sum() / (a.norm() * b.norm()).clamp_min(1e-30) for a, b in zip(gc, gp)])
    big = norms >= 1e-3 * norms.max()
    fc, fp = (torch.cat([g.flatten() for g in x]) for x in (gc, gp))
    whole = float(fc @ fp / (fc.norm() * fp.norm()))
    stat_err = max(np.abs(a - b).max() / np.abs(b).max() for a, b in zip(_leaves(bc), _leaves(bp)))
    step_row = dict(line="train step card vs cpu", loss_card=lc, loss_cpu=lp, loss_rel=abs(lc - lp) / abs(lp),
            grad_cos_whole=whole, grad_cos_min=float(cos[big].min()), leaves=len(gp),
            leaves_at_1e3_of_max=int(big.sum()), leaves_below_099=int((cos < 0.99).sum()),
            stat_rel=float(stat_err), masks=len(masks), seconds=time.time() - t0)
    phase(f"train step card vs cpu (bf16, batch 8, {smi}): " + kv(step_row))
    if not (step_row["loss_rel"] <= 2e-2 and whole >= 0.99 and step_row["grad_cos_min"] >= 0.99 and stat_err <= 1e-2):
        fail("the training step on the card disagrees with the CPU's")

    # phase 1 over the trained checkpoint
    raw = load_variables(CKPT)
    net = create_efficientnet("b0", 0, resolution=RES, device=dev)[0]
    cfg1 = TrainConfig(num_classes=P1_CLASSES, taps=cfg.taps, resolution=RES, batch_size=P1_BATCH, phase1_epochs=1,
            phase2_epochs=0)
    t1 = MultiExitTrainer(net, {k: raw[k] for k in ("params", "batch_stats")}, cfg1, preprocess=trainer.preprocess,
            device=dev)
    p0, h0, s0 = _leaves(t1.variables["params"]), _leaves(t1.head_arrays()), _leaves(t1.variables["batch_stats"])
    imgs1, labels1 = device_dataset(P1_CLASSES, 4, RES, seed=13000, device=dev)
    hist = t1.fit(imgs1, labels1, verbose=False)
    logits = t1.head_logits(imgs1[:16])
    p1_row = dict(line="train phase 1", loss=hist["loss"][0], acc=t1.evaluate(imgs1, labels1),
            backbone_equal=all(np.array_equal(a, b) for a, b in zip(_leaves(t1.variables["params"]), p0)),
            heads_moved=all(not np.array_equal(a, b) for a, b in zip(_leaves(t1.head_arrays()), h0)),
            stats_moved=not all(np.array_equal(a, b) for a, b in zip(_leaves(t1.variables["batch_stats"]), s0)),
            logits=[list(x.shape) for x in logits])
    phase(f"train phase 1 (trained B0@224, {4 * P1_CLASSES} images, batch {P1_BATCH}): " + kv(p1_row))
    if not (p1_row["backbone_equal"] and p1_row["heads_moved"] and p1_row["stats_moved"]
            and len(logits) == len(cfg.taps) + 1 and all(np.isfinite(x).all() for x in logits)):
        fail("phase 1 moved the backbone, or left the heads or the statistics")
    return dict(train=row, train_step=step_row, train_phase1=p1_row)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def run_extraction(dev, launches, smi, tmp):
    """``extract_features.main`` over PNG and BMP files; the IRv2 extractor vs ``make_serving_fn``."""
    from fast_image_recognition_tpu_torch.data.feature_io import load_feature_file
    from fast_image_recognition_tpu_torch.models.extractor import FeatureExtractor, list_image_dataset, load_images
    from fast_image_recognition_tpu_torch.scripts import extract_features
    from fast_image_recognition_tpu_torch.search import BruteForceMatcher

    imgs_d, labels = device_dataset(EXTRACT_CLASSES, 4, RES, seed=14000, device=dev)
    arrays = host(imgs_d)
    root, out = os.path.join(tmp, "images"), os.path.join(tmp, "features.txt")
    for i, a in enumerate(arrays):
        os.makedirs(os.path.join(root, f"c{labels[i]:02d}"), exist_ok=True)
        name = f"{i % 4}.bmp" if i % 4 == 3 else f"{i % 4}.png"
        with open(os.path.join(root, f"c{labels[i]:02d}", name), "wb") as fh:
            fh.write(bmp_bytes(a) if name.endswith(".bmp") else png_bytes(a))
    paths = list_image_dataset(root)[0]
    t = time.time()
    decoded, kept = load_images(paths, RES)
    decode_s = time.time() - t
    build.reset_launch_counts()
    t = time.time()
    n = extract_features.main([root, out, "--checkpoint", CKPT], device=dev)
    files_s = time.time() - t
    check_launches("extract", launches)
    raw = load_variables(CKPT)
    fx = FeatureExtractor("b0", variables=raw, device=dev)
    want = fx.extract_normalized(arrays, batch_size=64)
    lines = open(out).read().split("\n")
    rows = np.array([[float(v) for v in lines[3 * i + 2].split()] for i in range(n)], np.float32)
    names_ok = lines[0::3][:n] == [os.path.basename(p) for p in paths] and \
        lines[1::3][:n] == [f"c{c:02d}" for c in labels]
    fx.extract(imgs_d, batch_size=256)
    _, ext_ms = timed(lambda: fx.extract(imgs_d, batch_size=256), 3)
    db = load_feature_file(out, fx.embedding_dim)
    g, p = np.arange(n) % 4 < 2, np.arange(n) % 4 >= 2
    r = evaluate_matcher(BruteForceMatcher(db.features[g], device=dev), db.labels[g], db.features[p], db.labels[p],
            verbose=False)
    row = dict(line="extract files", images=n, decoded_equal=bool(kept == list(range(n)) and np.array_equal(decoded,
            arrays)), rows_bit_equal=bool(np.array_equal(rows, want)), names_labels_classes_equal=bool(names_ok),
            error_pct=100.0 * r.error_rate, files_img_s=n / files_s, decode_img_s=n / decode_s,
            extract_img_s=n / ext_ms * 1e3)
    phase(f"extract files ({n} PNG/BMP at {RES}, trained B0, {smi}): " + kv(row) + f"; launches={launches['extract']}")
    if not (n == 4 * EXTRACT_CLASSES and row["decoded_equal"] and row["rows_bit_equal"] and names_ok):
        fail("the extracted file differs from the images or from extract_normalized")

    raw = load_variables(IRV2_CKPT)
    info = backbone_info("inception_resnet_v2")
    x, _ = device_dataset(IRV2_IMAGES // 4, 4, RES, seed=15000, device=dev)
    fx = FeatureExtractor("inception_resnet_v2", variables=raw, resolution=RES, device=dev)
    got = fx.extract_normalized(x)
    with torch.no_grad():
        serve = make_serving_fn(raw, info, resolution=RES, device=dev)  # in the extractor's batches of 256
        ref = _unit(torch.cat([serve(x[s : s + 256])["embedding"].float() for s in range(0, len(x), 256)])).cpu().numpy()
    _, irv2_ms = timed(lambda: fx.extract(x), 1)
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    irv2 = dict(line="extract irv2", images=len(got), rel_err=err, img_s=len(got) / irv2_ms * 1e3)
    phase(f"extract irv2 (trained IRv2@{RES}, {smi}): " + kv(irv2))
    if not err <= 2.0**-10:
        fail("the IRv2 extractor's rows differ from make_serving_fn's")
    return dict(extract_files=row, extract_irv2=irv2)

def run_trained_cascade(dev, smi, tmp):
    """``run_trained_cascade.main`` on synthetic128 at 112 px: streams 2 = 1, pooled = ``predict()`` but
    near-ties, no host sync in the fused cascade, finite losses."""
    from fast_image_recognition_tpu_torch.scripts import run_trained_cascade as rtc

    seen, pooled0 = {}, SequentialInferencePipeline.predict_pooled

    def pooled(self, images, bucket=1024, warmup=False, streams=1):
        seen[(streams, tuple(self.thresholds))] = r = pooled0(self, images, bucket, warmup, streams)
        seen["last"] = (self, images)
        return r

    SequentialInferencePipeline.predict_pooled = pooled
    t = time.time()
    try:
        recs = rtc.main(["--dataset", "synthetic", "--resolution", "112", "--streams", "1,2", "--out",
                os.path.join(tmp, "cascade.jsonl")], device=dev)
    finally:
        SequentialInferencePipeline.predict_pooled = pooled0
    pipe, x = seen.pop("last")
    base, fused = recs[0], recs[-1]
    key = tuple(pipe.thresholds)  # the fused FAR's, which streams 2 ran at
    r1, r2 = seen[(1, key)], seen[(2, key)]
    same = np.array_equal(r1.predictions, r2.predictions) and np.array_equal(r1.exit_level, r2.exit_level)
    eq, diff, ties = check_cascade_decisions("trained cascade: predict_pooled", r1, pipe.predict(x),
            cascade_margins(pipe, x))
    no_sync(lambda: pipe.fused_fn(x.shape[0])(x))
    s12 = [r["img_per_s"] for r in recs if r["config"] == "cascade_trained_pooled" and r["far"] == fused["far"]]
    phase(f"trained cascade b0@112 synthetic128 ({smi}): " + "; ".join(kv(r, *[k for k in r if k not in ("dataset",
          "variant", "resolution")]) for r in recs) + f"; streams 2/1 at far {fused['far']}: {s12[-1] / s12[0]:.3f}; "
          f"pooled = predict() on {eq:.2f}% ({diff} differ, near-ties {ties}); streams 2 = 1: {same}; no host sync "
          f"in the fused cascade ({since(t)})")
    if not same:
        fail("trained cascade: predict_pooled(streams=2) decides otherwise than streams=1")
    if not base["loss"] or not np.isfinite(base["loss"]).all():
        fail(f"trained cascade: training losses {base['loss']}")
    return dict(records=recs, pooled_equal_predict_pct=eq, streams_equal=same, seconds=time.time() - t)


def check_tools(dev):
    """``project_device`` within 1e-5 of max |``project``|; ``time_jitted`` within 10 % of ``cuda_ms``."""
    from fast_image_recognition_tpu_torch.ops.pca import fit_pca

    x = np.random.default_rng(3).standard_normal((4096, 1280)).astype(np.float32)
    pca = fit_pca(x[:2048], 124)
    want = pca.project(x)
    err = float(np.abs(host(pca.project_device(torch.from_numpy(x).to(dev))) - want).max() / np.abs(want).max())
    a = torch.ones(1 << 28, device=dev)  # bytes-bound: steadier than a power-capped matmul
    ms_c, ms_t = cuda_ms(lambda: a + 1.0, 20), time_jitted(lambda: a + 1.0, iters=20)["steady_s"] * 1e3
    phase(f"PCAModel.project_device vs project: rel={err:.2e}; 2^28 fp32 adds: cuda_ms={ms_c:.4f} time_jitted="
          f"{ms_t:.4f} ms")
    if not (err <= 1e-5 and abs(ms_t - ms_c) <= 0.1 * ms_c):
        fail("project_device misses project by > 1e-5, or time_jitted misses cuda_ms by > 10 %")
    return dict(pca_rel_err=err, cuda_ms=ms_c, time_jitted_ms=ms_t)


SHARDS = 4
ANN_PROBES, ANN_TIE = 128, 2.0**-12
CLS_CPU_PROBES = 64
VERIF_DIM, VERIF_CLASSES = 256, 64  # ImageTesting.cpp:715


def rows_tie_ok(q, gallery, got, want, rel=2.0**-12, abs_=0.0, precise=False):
    """Rows ``got`` equal ``want`` or tie within ``rel`` + ``abs_`` (fp64)."""
    got, want = torch.as_tensor(got, device=q.device).long(), torch.as_tensor(want, device=q.device).long()
    qf = (q if precise else q.to(BF16)).to(torch.float64)
    d_got, d_want = (((gallery[r].to(torch.float64) - qf) ** 2).sum(1) for r in (got, want))
    return bool(((got == want) | ((d_got - d_want).abs() <= rel * d_want + abs_)).all())


def run_sharded_service(info, gallery, labels, emb, images, serve, idx_exact, dev, launches, smi):
    """``match='sharded'``, both scans, ``SHARDS`` shards and one. (rows, scan report)."""
    from fast_image_recognition_tpu_torch.parallel import gallery_mesh

    rows, scan_report, exact_rows = [], {}, None
    for scan, s in (("exact", SHARDS), ("exact", 1), ("packed", SHARDS), ("packed", 1)):
        t = time.time()
        svc = RecognitionService(None, info, gallery, labels=labels, n_valid=GALLERY, serving_fn=serve, match="sharded",
                sharded_scan=scan, pca_dim=124, mesh=gallery_mesh(devices=[dev] * s), device=dev)
        sync()
        build_s = time.time() - t
        if scan == "packed" and s > 1:
            qa = dk._augment_queries((emb - svc._mu) @ svc._w, svc.pca_dim, svc._gal_aug[0].shape[1])
            check_single_scan("shard", qa, svc._gal_aug[0], 512, scan_report)
        out = counted(lambda: svc.identify_device(images)).cpu().numpy()
        out_sync = no_sync(lambda: svc.identify_device(images))
        ms = host_ms(lambda: svc.identify_device(images), TIMED_CALLS)
        path = f"sharded {scan} x{s}"
        check_launches(path, launches, **{"topk_l2" if scan == "exact" else "tilemin_packed": s * (TIMED_CALLS + 2)})
        if not np.array_equal(out, host(out_sync)) or not ((out >= 0) & (out < GALLERY)).all():
            fail(f"{path}: rows outside the gallery or changed under sync debug mode")
        if scan == "exact" and not rows_tie_ok(emb, gallery, out, idx_exact):
            fail(f"{path} differs from match='exact' beyond near-ties")
        exact_rows = out if exact_rows is None else exact_rows
        row = dict(line=path, img_s=BATCH / ms * 1e3, ms=ms, build_s=build_s, shard_rows=int(svc.gallery[0].shape[0]),
                error_pct=pct(labels[out] != np.arange(BATCH)), exact_rows_equal_pct=pct(out == idx_exact),
                sharded_exact_rows_equal_pct=pct(out == exact_rows))
        rows.append(row)
        phase(f"{path} ({smi}): " + kv(row) + f"; no host sync; launches={launches[path]}")
        del svc
    return rows, scan_report


def run_sharded_matcher(gal_bf, q_bf, idx_bf, idx_oracle_bf, launches, smi):
    """``ShardedGalleryMatcher``, bf16 and precise, vs the unsharded scans."""
    from fast_image_recognition_tpu_torch.parallel import ShardedGalleryMatcher, gallery_mesh

    rows = []
    for precise, want, kernel in ((False, idx_bf, "topk_l2"), (True, idx_oracle_bf, "topk_l2_precise_f32")):
        m = ShardedGalleryMatcher(gal_bf[:GALLERY], gallery_mesh(devices=[q_bf.device] * SHARDS), precise=precise)
        idx = counted(lambda: m.search_device(q_bf))[1][:, 0]
        ms = cuda_ms(lambda: m.search_device(q_bf), 3)
        path = "sharded matcher" + (" precise" if precise else "")
        check_launches(path, launches, **{kernel: SHARDS * 5})
        ok = rows_tie_ok(q_bf, gal_bf, idx, want, rel=0.0 if precise else 2.0**-12, abs_=2.0**-16 * precise,
                precise=precise)
        idx = host(idx)
        row = dict(line=path, queries_s=BATCH / ms * 1e3, ms=ms, shard_gib=sum(g.nbytes for g in m.gallery) / 2**30,
                rows_equal_pct=pct(idx == np.asarray(want)), error_pct=pct(idx != np.arange(BATCH)))
        rows.append(row)
        phase(f"{path} ({SHARDS} shards, {BATCH} x {GALLERY} x {q_bf.shape[1]}, CUDA events, {smi}): "
              + kv(row) + f" launches={launches[path]}")
        if not ok:
            fail(f"{path} differs from the unsharded scan beyond near-ties")
        del m
    return rows


def run_ann_matchers(g, gl, p, pl, dev, launches, smi):
    """sw, proj, kd-forest at budget 1 % vs CPU runs; sw's graph vs plain ``topk_l2``'s."""
    from fast_image_recognition_tpu_torch.config import MatcherConfig
    from fast_image_recognition_tpu_torch.factory import build_matcher
    from fast_image_recognition_tpu_torch.search import small_world as sw

    cfg = MatcherConfig(image_count_to_check=int(DEM_BUDGET * g.shape[0]))
    q, rows = p[:ANN_PROBES], []
    for method in ("sw", "proj", "kdtree"):
        t = time.time()
        build.reset_launch_counts()
        m = Recording(build_matcher(method, g, gl, cfg, seed=0, device=dev))
        m.set_budget(cfg.image_count_to_check)  # unbudgeted by the factory, as JAX's
        sync()
        build_s, n_build = time.time() - t, build.LAUNCHES["topk_l2"]
        res = evaluate_matcher(m, gl, q, pl[:ANN_PROBES], verbose=False)
        cpu_m, extra = m.matcher, ""  # host code
        if method == "sw":
            if n_build != -(-g.shape[0] // 1024):
                fail(f"the neighbour table took {n_build} topk_l2 launches")
            real = sw.topk_l2
            sw.topk_l2 = lambda qq, gg, k, n_valid: plain.topk_l2_plain(qq.to(BF16), gg, k, n_valid)
            try:
                table = sw.build_neighbor_table(m.matcher.gallery, k_nn=11, k_rand=4, seed=0).long()
            finally:
                sw.topk_l2 = real
            got = m.matcher.neighbors.long()
            r, c = (got != table).nonzero(as_tuple=True)
            g64 = m.matcher.gallery.to(BF16).to(torch.float64)
            d_got, d_want = (((g64[x[r, c]] - g64[r]) ** 2).sum(1) for x in (got, table))
            if not bool(((d_got - d_want).abs() <= ANN_TIE * d_want + 1e-6).all()):
                fail("the neighbour table differs from the plain build beyond near-ties")
            cpu_m = object.__new__(type(m.matcher))
            cpu_m.__dict__.update({k: v.cpu() if isinstance(v, torch.Tensor) else v for k,
                    v in m.matcher.__dict__.items()}, device=torch.device("cpu"))
            extra = f" table_launches={n_build} table_equal_plain={100.0 * (1 - len(r) / got.numel()):.4f}%"
        elif method == "proj":
            cpu_m = build_matcher(method, g, gl, cfg, seed=0, device="cpu")
        equal = pct(m.last.indices == cpu_m.search(q).indices)
        rows.append(dict(line=method, name=m.name, error_pct=res.error_rate, ms_per_probe=res.ms_per_image,
                checked_pct=res.checked_percent, build_s=build_s, cpu_rows_equal_pct=equal))
        phase(f"build_matcher('{method}') ({g.shape[0]} x {g.shape[1]}, budget {cfg.image_count_to_check}, "
              f"{build_s:.1f} s): {res.summary()} ({smi}) cpu_rows_equal={equal:.2f}%{extra}")
        if equal < 97.0:
            fail(f"{method}: card rows equal the CPU run's on {equal:.2f}% < 97% of probes")
        del m, cpu_m
    return rows


def run_classifiers(gal, glab, probes, plab, dev, smi):
    """k-NN, PNN, FPNN and ``verification_test`` vs CPU runs."""
    import copy

    from fast_image_recognition_tpu_torch.classifiers import FPNNClassifier, KNNClassifier, PNNClassifier
    from fast_image_recognition_tpu_torch.evaluation.verification import verification_test

    c, sel = int(glab.max()) + 1, glab < VERIF_CLASSES

    def fitted(d):
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
        rows.append(dict(line=clf.name, error_pct=pct(pred != plab), ms_per_probe=ms / len(probes),
                cpu_equal_pct=100.0 * float(equal.mean())))
        phase(f"{clf.name} ({gal.shape[0]} x {gal.shape[1]}, {c} classes, {len(probes)} probes, {smi}): "
              + kv(rows[-1], "error_pct", "ms_per_probe", "cpu_equal_pct"))
        if not equal.all():
            fail(f"{clf.name}: card predictions differ from the CPU run's")
    t = time.time()
    r = verification_test(gal[sel], glab[sel], tests=10, end=VERIF_DIM, verbose=False, device=dev)
    sec = time.time() - t
    rc = verification_test(gal[sel], glab[sel], tests=10, end=VERIF_DIM, verbose=False, device="cpu")
    rows.append(dict(line=r.name, rows=int(sel.sum()), error_pct=r.error_rate, sigma=r.extras["sigma"], seconds=sec,
            cpu_error_pct=rc.error_rate))
    phase(f"{r.name} ({VERIF_CLASSES} classes, 10 splits, {smi}): " + kv(rows[-1], *list(rows[-1])[1:]))
    if abs(r.error_rate - rc.error_rate) > 100.0 / int(sel.sum()):
        fail("verification_test on the card differs from its CPU run beyond one probe")
    return rows


@torch.no_grad()
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card", file=sys.stderr)
        return 2
    os.chdir(os.path.dirname(os.path.abspath(__file__)))

    from fast_image_recognition_tpu_torch.device import default_device
    from fast_image_recognition_tpu_torch.serving import CascadeRecognitionService, make_tap_embed_fn

    # 1. environment (default_device() turns TF32 off)
    dev = default_device()
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is enabled")
    smi = nvidia_smi_line()
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True, text=True, check=True)
    phase(f"environment: {smi} | torch {torch.__version__} (CUDA {torch.version.cuda}) | "
          f"{nvcc.stdout.strip().splitlines()[-1]}")

    # 2. build every kernel in parallel
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
    phase(f"built {sorted(build.SOURCES)} in {since(t)} ("
          + ", ".join(f"{n} {sec:.1f} s" for n, sec in sorted(build.BUILD_SECONDS.items())) + ")")
    # the main loop's kernels issue wgmma, no WMMA
    mma_by_lib = sass_mma_counts(libs)
    mma = {k: v for counts in mma_by_lib.values() for k, v in counts.items()}
    sm90 = {k: v for k, v in mma.items() if "_sm90" in k}
    families = ("topk_pass1_sm90", "topk_pass1_split_sm90", "topk_pass1_split6_sm90", "tilemin_packed_sm90",
            "tilemin_quant_sm90", "tilemin_sm90", "tilemin_quant_bf16_sm90", "mbconv_sm90")
    if not all(any(k.startswith(f) for k in sm90) for f in families) or not all(
            v["HGMMA"] + v["IGMMA"] > 0 and v["HMMA"] == v["IMMA"] == 0 for v in sm90.values()):
        fail(f"a kernel of the sm90 main loop does not run on wgmma alone: {sm90}")
    topk_lib = build._lib("topk_l2")
    if topk_lib.topk_l2_max_k() != build.TOPK_MAX_K:
        fail("kernels/topk_l2.cu and build.TOPK_MAX_K disagree on the largest k")
    if any(topk_lib.topk_l2_segment_rows(p, k) != build.topk_l2_segment_rows_for(bool(p), k)
           for p in (0, 1) for k in (1, 16, 17, build.TOPK_MAX_K)):
        fail("kernels/topk_l2.cu and build.topk_l2_segment_rows_for disagree on segment rows")
    if topk_lib.topk_l2_query_rows() != build.TOPK_QUERY_ROWS or any(
            topk_lib.topk_l2_split_smem(k) != build.topk_l2_split_smem_for(k)
            or topk_lib.topk_l2_split6_smem(k) != build.topk_l2_split6_smem_for(k) for k in (1, 2, 16, 17, 256)):
        fail("kernels/topk_l2.cu and build's split-pass mirrors disagree (query rows, ring sizes)")
    for lib in ("tile_scan", "mbconv"):
        if any(v["HMMA"] + v["IMMA"] for v in mma_by_lib[lib].values()):
            fail(f"kernels/{build.SOURCES[lib]} still issues HMMA/IMMA: {mma_by_lib[lib]}")
    phase("SASS HGMMA/IGMMA/HMMA/IMMA per kernel: "
          + "; ".join(f"{k} {v['HGMMA']}/{v['IGMMA']}/{v['HMMA']}/{v['IMMA']}" for k, v in sorted(mma.items())
            if any(v.values())))
    pad_pairs = check_edge_shapes(dev)
    phase(f"edge shapes {EDGE_SHAPES}: every kernel = plain; {pad_pairs} whole-pad (query, tile) minima bit-equal")
    n_cases = check_sm90_edges(dev)
    phase(f"sm90 scan edges: {sum(n_cases.values())} cases {n_cases} = plain; no row past n_valid, no whole-pad "
          f"tile won, their minima bit-equal")
    n_slab = check_topk_slabs(dev)
    phase(f"topk_l2 in slabs: {n_slab} cases at k {list(TOPK_SLAB_K)} = plain in one pass")
    err_k, err_two = check_split_probe(dev, False)
    phase(f"split precise pass: planes = plain.split_bf16x3; kernel_err={err_k:.3e} hi+mid_err>={err_two:.3e} "
          f"(tol {SPLIT_PROBE_TOL:.3e})")
    err6, err_three = check_split_probe(dev, True)
    phase(f"six-product pass over fp32 rows: kernel_err={err6:.3e} three_products_err>={err_three:.3e} "
          f"(tol {SPLIT_PROBE_TOL:.3e}); planes = plain.split_bf16x3")
    phase("grids past 65,535 blocks = plain: " + "; ".join(check_big_grids(dev)))
    tools_row = check_tools(dev)

    # 3. trained B0@224, unseen identities rendered on the card
    t = time.time()
    variables = load_variables(CKPT)
    np_vars = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    info = backbone_info("b0")
    serve = make_serving_fn(np_vars, info, resolution=RES, device=dev)
    phase(f"loaded and folded {CKPT} in {since(t)}")
    t = time.time()
    pair_imgs, _ = device_dataset(IDENTITIES, 2, RES, seed=11000, class_seed=3000, device=dev)
    # one pass: final embeddings and the cascade's taps
    tap_embed = make_tap_embed_fn(None, info, RES, TAPS, serving_fn=serve, device=dev)
    chunks = [tap_embed(pair_imgs[s : s + BATCH]) for s in range(0, 2 * IDENTITIES, BATCH)]
    embs = torch.cat([e for _, e in chunks])
    tap_embs = [_unit(torch.cat([f[j] for f, _ in chunks])) for j in range(len(TAPS))]
    del chunks
    enroll, sigma, images = enroll_sigma(embs, pair_imgs)
    # held-out calibration images
    calib_imgs = pair_imgs[2 * BATCH + 1 : 4 * BATCH : 2].contiguous()
    del pair_imgs
    sync()
    phase(f"rendered and embedded {2 * IDENTITIES} images at {RES} in {since(t)}, sigma {sigma:.4f}")
    t = time.time()
    gallery, labels = class_structured_gallery(GALLERY, enroll, sigma)
    # bench.py's main path: PCA-124 packed
    skw = dict(labels=labels, n_valid=GALLERY, serving_fn=serve, device=dev)
    svc = RecognitionService(None, info, gallery, pca_dim=124, pca_scan="packed", **skw)
    exact = RecognitionService(None, info, gallery, match="exact", **skw)
    sync()
    phase(f"gallery {tuple(gallery.shape)} bf16, PCA-{svc.pca_dim} fit and packed in {since(t)}")

    # 4. the kernels vs plain at the main path's shapes
    report = {}
    probe_batch = svc._embed(images)
    check_cert_scan(svc, probe_batch, report)
    check_topk(gallery, GALLERY, probe_batch, 1, report)
    check_topk(gallery, GALLERY, probe_batch[:256], 16, report)
    check_topk(gallery, GALLERY, probe_batch[:256], 32, report)
    check_topk(gallery, GALLERY, probe_batch, 1, report, key="topk_l2_precise", precise=True)
    masked_empty_ms = cuda_ms(lambda: dk.topk_l2(probe_batch, gallery, 1, n_valid=GALLERY, row_mask=torch.zeros(BATCH,
            dtype=torch.bool, device=dev)), reps=10)
    phase(f"topk_l2 with an empty escalation mask (B={BATCH}, N={GALLERY}): {masked_empty_ms:.4f} ms a launch")

    # 5-6. the main path, match='exact' and the oracle, each counted
    launches = {}
    b0_flops = embed_flops("b0", np_vars, info, RES, serve, images, dev, gap=False)[0]
    line = serve_line("pca", svc, exact, gallery, labels, images, launches, smi, b0_flops)
    idx, idx_exact, idx_oracle, emb, sec = (line.pop(k) for k in ("idx", "idx_exact", "idx_oracle", "emb", "sec"))
    # the oracle over fp32 rows: the six-product pass
    gal32 = full_significand_rows(gallery, seed=5)
    check_topk(gal32, GALLERY, emb, 1, report, key="topk_l2_precise_f32", precise=True)
    idx_oracle32 = counted(lambda: dk.topk_l2(emb, gal32, 1, n_valid=GALLERY, precise=True)[1][:, 0])
    sync()
    check_launches("oracle_f32", launches, topk_l2_precise_f32=1)
    if not bool(((idx_oracle32 >= 0) & (idx_oracle32 < GALLERY)).all()):
        fail("the oracle over fp32 rows returned rows outside the gallery")
    del gal32, idx_oracle32
    truth = np.arange(BATCH)
    esc_rows = check_partial_escalation(svc, emb, gallery, dev)
    check_packed_service(info, gallery, labels, emb, images, serve, dev, launches, report)
    # 6'. match='sharded', both scans
    sharded_rows, shard_scan = run_sharded_service(info, gallery, labels, emb, images, serve, idx_exact, dev,
            launches, smi)

    # 6a. the fused MBConv path
    t = time.time()
    serve_f = make_infer_fn(np_vars, "b0", resolution=RES, fused=True, space_to_depth=True, device=dev)
    sync()
    phase(f"folded the fused module (fused=True, space_to_depth=True) in {since(t)}")
    mb_report = {}
    check_mbconv_blocks(serve, serve_f, images, mb_report)
    mb_report["edges"] = check_mbconv_edges(serve_f, dev)
    phase(f"mbconv edge shapes: {len(mb_report['edges'])} cases within {MB_TOL:.2e} of max |plain|, borders too")
    s2d_row = check_s2d_stem(np_vars, serve, serve_f, images, dev)
    fused_row = check_fused_path(serve, serve_f, svc, info, gallery, labels, images, idx, idx_oracle, sec, launches,
            dev, smi, line["flops_per_iter"])
    del serve_f, svc, exact

    # 6b. JAX's default service (PCA-128, f32 tile scan) and its other scans
    tile_report = {"tilemin": [], "tilemin_quant": []}
    mode_rows = []
    for name, kw, kernel in (("default", {}, "tilemin"), ("pca_scan='bf16'", dict(pca_scan="bf16"), "tilemin"),
            ("pca_scan='int8'", dict(pca_scan="int8"), "tilemin_quant"),
            ("match='int8'", dict(match="int8"), "tilemin_quant")):
        t = time.time()
        ms_ = RecognitionService(None, info, gallery, **skw, **kw)
        sync()
        build_s = time.time() - t
        if name == "default":
            qp = ((emb - ms_._mu) @ ms_._w).to(BF16).contiguous()
            for bf in (False, True):
                check_tile_scan(f"pca{ms_.pca_dim}-{'bf16' if bf else 'f32'}-scores", qp, ms_._gal_pca, ms_._gal_sq,
                        1024, tile_report["tilemin"], bf16_scores=bf)
        counted(lambda: ms_.identify_device(images))
        out, m_ms = timed(lambda: ms_.identify_device(images))
        check_launches(f"service {name}", launches, **{kernel: TIMED_CALLS + 1})
        out = host(out)
        if out.dtype != np.int32 or not ((out >= 0) & (out < GALLERY)).all():
            fail(f"service {name} returned rows outside the gallery")
        row = dict(mode=name, img_s=BATCH / m_ms * 1e3, ms=m_ms, build_s=build_s, error_pct=pct(labels[out] != truth),
                agreement_pct=pct(out == idx_oracle), exact_agreement_pct=pct(out == idx_exact))
        mode_rows.append(row)
        phase(f"service {name} (PCA-{getattr(ms_, 'pca_dim', '-')}, {smi}): " + kv(row)
              + f" launches={launches[f'service {name}']}")
        del ms_

    # 7. the early-exit cascade over row-aligned tap galleries
    t = time.time()
    tap_gals, tap_sigmas = [], []
    for te in tap_embs:
        s_l = float(torch.linalg.vector_norm(te[0::2] - te[1::2], dim=1).median()) / math.sqrt(2.0)
        g_l, lab_l = class_structured_gallery(GALLERY, te[0::2].contiguous(), s_l)
        if not np.array_equal(lab_l, labels):
            fail("tap gallery labels are not row-aligned with the final gallery")
        tap_gals.append(g_l)
        tap_sigmas.append(round(s_l, 4))
    del tap_embs
    casc = CascadeRecognitionService(None, info, gallery, labels=labels, n_valid=GALLERY, taps=TAPS, galleries=tap_gals,
        ratio=RATIO, d2_rule="class", serving_fn=serve, device=dev)
    fracs = casc.calibrate(calib_imgs, slack=SLACK)
    caps = casc.capacities_for(BATCH)
    sync()
    phase(f"cascade built: taps {TAPS} dims {[a['dim'] for a in casc._tap_assets]} sigmas {tap_sigmas} tile_g "
          f"{casc._tile_g} survivors {[round(f, 4) for f in fracs]} capacities {caps} ({since(t)})")

    # 8. the single-min scan vs plain at the cascade's shapes
    scan_report = {}
    feats0, emb0 = tap_embed(images)
    q3 = _unit(feats0[0])
    a0 = casc._tap_assets[0]
    check_single_scan("block3a", dk._augment_queries(q3, a0["dim"], 128), a0["aug"], casc._tile_g, scan_report)
    qp = (emb0 - casc._mu) @ casc._w
    check_single_scan("final-pca", dk._augment_queries(qp, casc.pca_dim, 128), casc._gal_aug, casc._tile_g, scan_report)
    g128 = dk.pack_gallery_aug(a0["gal"][:131072], 131072, tile_g=128)
    check_single_scan("block3a-131072-rows", dk._augment_queries(q3, a0["dim"], 128), g128, 128, scan_report)
    del g128, feats0

    # 9-10. the cascade path; its decisions on the plain scan
    casc_row, idx_c = run_cascade(casc, images, "cascade", launches, smi, labels, dict(oracle=idx_oracle,
            exact=idx_exact), plain_sec=sec, breakdown=(caps, scan_report))
    casc_row.update(survivors=[round(f, 4) for f in fracs], capacities=caps)
    del casc, tap_gals

    # 11. escalate=None and select='approx'
    svc_none = RecognitionService(None, info, gallery, pca_dim=124, pca_scan="packed", escalate=None, **skw)
    idx_none = counted(lambda: svc_none.identify_device(images))
    sync()
    check_launches("pca_escalate_none", launches, tilemin_packed=1)
    idx_none = host(idx_none)
    phase(f"match='pca' escalate=None: error={100 * float(np.mean(labels[idx_none] != truth)):.3f}% "
          f"rows_equal_exact={100 * float(np.mean(idx_none == idx_exact)):.3f}% "
          f"launches={launches['pca_escalate_none']}")
    t = time.time()
    svc_apx = RecognitionService(None, info, gallery, pca_dim=124, pca_scan="packed", select="approx", **skw)
    sync()
    apx_build_s = time.time() - t
    counted(lambda: svc_apx.identify_device(images))
    idx_apx, apx_ms = timed(lambda: svc_apx.identify_device(images))
    check_launches("pca_approx", launches, tilemin_packed=TIMED_CALLS + 1)
    idx_apx = host(idx_apx)
    apx_row = dict(line="service approx-select", img_s=BATCH / apx_ms * 1e3, ms=apx_ms, build_s=apx_build_s,
            error_pct=pct(labels[idx_apx] != truth), agreement_pct=pct(idx_apx == idx_oracle),
            rows_equal_exact_select_pct=pct(idx_apx == idx_none))
    phase(f"service approx-select (PCA-{svc_apx.pca_dim} packed, rescore {svc_apx.rescore}, {smi}): "
          + kv(apx_row) + f" launches={launches['pca_approx']}")
    if svc_apx.escalate is not None or not np.array_equal(idx_apx, idx_none):
        fail("select='approx' differs from the exact selection's uncertified service")
    del svc_none, svc_apx, gallery

    # 12. a layout where the certificate clears
    t = time.time()
    probes, gal_p, planted = planted_gallery(GALLERY, BATCH, enroll.shape[1], dev)
    svc_p = RecognitionService(None, info, gal_p, n_valid=GALLERY, serving_fn=serve, pca_dim=124,
            pca_scan="packed", device=dev)
    idx_p = counted(lambda: svc_p._match_emb(probes))
    sync()
    idx_p2 = no_sync(lambda: svc_p._match_emb(probes))
    sync()
    check_launches("pca_planted", launches, tilemin2_packed=2, topk_l2=2)
    esc_p = svc_p.last_escalated
    if not bool((idx_p2 == idx_p).all()):
        fail("the planted layout's answers changed under sync debug mode")
    ei = build.launch_topk_l2(probes.to(BF16), gal_p, 1, GALLERY)[1][:, 0].to(torch.int64)
    fast_agree_p = check_certified_pick(svc_p, probes, ei)
    cert = ~esc_p
    cert_share = cert.float().mean().item()
    cert_agree = (idx_p[cert] == ei[cert]).float().mean().item()
    planted_pct = pct(idx_p == planted)
    phase(f"planted layout ({GALLERY} rows, 96-d span, PCA-{svc_p.pca_dim}): certified={100 * cert_share:.2f}% "
          f"certified_equal_exact={100 * cert_agree:.3f}% planted_found={planted_pct:.3f}% "
          f"pick_equal_exact={fast_agree_p:.3f}% launches={launches['pca_planted']} ({since(t)})")
    if cert_share < 0.99 or cert_agree < 1.0 or planted_pct < 100.0:
        fail("the certified answer on the planted layout is not the exact one")
    del svc_p, gal_p, probes

    # 12'. the flagship line
    flagship_row = run_flagship(dev, report, launches, smi)
    # 12''. the MobileNet lines
    mobilenet_lines = run_mobilenets(dev, launches, smi, mb_v2 := {})
    # 12c. the rest of the zoo
    zoo_lines = run_zoo(dev, report, launches, smi)
    # 12d. the pruned B0s
    prune_lines, prune_mb = run_pruning(dev, np_vars, info, images, launches, smi, (line, fused_row))
    phase(f"prune b0@{RES}: {prune_lines['seconds']:.1f} s")

    # 13. bench.py --config bf: 1M x 1536 unit rows, queries row i + 1e-2 noise
    t = time.time()
    gal_bf = random_unit_gallery(GALLERY, BF_DIM, dev)
    gen = gen_on(dev, 7)
    q_bf = _unit(gal_bf[:BATCH].to(F32) + 1e-2 * randn(gen, BATCH, BF_DIM))
    sync()
    phase(f"bf gallery {tuple(gal_bf.shape)} bf16 built in {since(t)}")
    check_topk(gal_bf, GALLERY, q_bf, 1, report)
    check_topk(gal_bf, GALLERY, q_bf, 1, report, key="topk_l2_precise", precise=True)
    gal_bf32 = full_significand_rows(gal_bf, seed=6)  # the oracle over fp32 rows at x 1536
    check_topk(gal_bf32, GALLERY, q_bf, 1, report, key="topk_l2_precise_f32", precise=True)
    del gal_bf32
    check_topk(gal_bf, GALLERY, q_bf, 1, report, key="topk_l2_windowed", window=BF_WINDOW)
    idx_oracle_bf = counted(lambda: dk.topk_l2(q_bf, gal_bf, 1, n_valid=GALLERY, precise=True))[1][:, 0].cpu().numpy()
    check_launches("oracle_bf", launches, topk_l2_precise=1)
    bf_found = {}

    def bf_line(name, run, path, **counts):
        counted(run)
        out, b_ms = timed(run)
        check_launches(path, launches, **{k: v * (TIMED_CALLS + 1) for k, v in counts.items()})
        found = bf_found[path] = out[1][:, 0].cpu().numpy()
        row = dict(line=name, queries_s=BATCH / b_ms * 1e3, ms=b_ms, error_pct=pct(found != truth),
                agreement_pct=pct(found == idx_oracle_bf),
                bf16_scan_agreement_pct=pct(found == bf_found.get("bf", found)))
        phase(f"bf line, {name} ({smi}): " + kv(row) + f" launches={launches[path]}")
        return row

    bf_rows = [bf_line("fused brute-force (topk_l2, k=1)", lambda: dk.topk_l2(q_bf, gal_bf, 1, n_valid=GALLERY), "bf",
            topk_l2=1), bf_line(f"feature window {list(BF_WINDOW)}", lambda: dk.topk_l2(q_bf, gal_bf, 1,
            n_valid=GALLERY, window=BF_WINDOW), "bf_windowed", topk_l2_windowed=1)]
    # 13'. ShardedGalleryMatcher
    sharded_matcher_rows = run_sharded_matcher(gal_bf, q_bf, bf_found["bf"], idx_oracle_bf, launches, smi)

    # 14. bench.py --config bf --quant
    t = time.time()
    gal_q, scales = quantize_rows(gal_bf)
    gsq_bf = dk.gallery_sq_norms(gal_bf, GALLERY)
    gsc_bf = dk.quant_gallery_scales(scales, GALLERY)
    del scales
    sync()
    phase(f"bf gallery quantized to int8 with norms and scales in {since(t)}")
    q_i8, q_sc = quantize_rows(q_bf)
    for compute in ("int8", "bf16"):
        check_tile_scan(f"bf-quant-{compute}", q_i8, gal_q, gsq_bf, 1024, tile_report["tilemin_quant"],
                quant=(q_sc, gsc_bf, compute))
    for compute in ("int8", "bf16"):
        bf_rows.append(bf_line(f"int8-scan+rescore ({compute}, r=16)",
            lambda compute=compute: dk.topk_l2_quant(q_bf, gal_q, gsq_bf, gsc_bf, gal_bf, 1, r=16, compute=compute),
            f"bf_quant_{compute}", tilemin_quant=1))
    del gal_q, gsq_bf, gsc_bf, gal_bf

    # 15-17. chi2, chi2_cost and the brute-force harness
    chi2_row, chi2_lines = run_chi2_slice(dev, launches, smi)
    # 18-21. dem, TWD, video, cascade configs
    feature_lines = run_feature_configs(dev, launches, smi)
    # 22-23. training and feature extraction
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")  # outside the checkout: $TMPDIR
    try:
        with torch.enable_grad():  # main runs under no_grad
            feature_lines.update(run_training(dev, launches, smi, tmp))
        feature_lines.update(run_extraction(dev, launches, smi, tmp))
        feature_lines["trained_cascade"] = run_trained_cascade(dev, smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    src = "fast_image_recognition_tpu_torch/kernels/"
    jax_dk = "fast_image_recognition_tpu/ops/distance_kernel.py:"

    def kernel_row(name, source, replaces, path, entries, **extra):
        first = {k: entries[0].get(k) for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        return dict(name=name, route="cuda", source=src + source, replaces=replaces, launches=launches[path][name],
                launches_by_path={p: c[name] for p, c in launches.items()}, **first, **extra, shapes=entries)

    mb_tot = mb_report["total"]
    rows = [
        kernel_row("tilemin2_packed", "packed_scan.cu", jax_dk + "393", "pca", report["tilemin2_packed"]),
        kernel_row("topk_l2", "topk_l2.cu", jax_dk + "92", "pca", report["topk_l2"], empty_mask_ms=masked_empty_ms),
        kernel_row("tilemin_packed", "packed_scan.cu", jax_dk + "350", "cascade",
                scan_report["shapes"] + shard_scan["shapes"], per_level=scan_report["per_level"]),
        kernel_row("tilemin", "tile_scan.cu", jax_dk + "174", "service default", tile_report["tilemin"]),
        kernel_row("tilemin_quant", "tile_scan.cu", jax_dk + "671", "bf_quant_int8", tile_report["tilemin_quant"]),
        kernel_row("topk_l2_precise", "topk_l2.cu", jax_dk + "92 (precise=True)", "oracle", report["topk_l2_precise"],
                kernel="split_queries + topk_pass1_split_sm90 (bf16 rows; three bf16 wgmma products)"),
        kernel_row("topk_l2_precise_f32", "topk_l2.cu", jax_dk + "92 (precise=True, fp32 rows)", "oracle_f32",
                report["topk_l2_precise_f32"],
                kernel="split_queries + topk_pass1_split6_sm90 (fp32 rows split on the chip; six bf16 wgmma products)"),
        kernel_row("topk_l2_windowed", "topk_l2.cu", jax_dk + "92 (window)", "bf_windowed", report["topk_l2_windowed"]),
        dict(kernel_row("mbconv", "mbconv.cu", "fast_image_recognition_tpu/ops/mbconv_kernel.py:82", "fused",
                mb_report["blocks"], kernel="mbconv_sm90 (one launch per block)",
                shape=f"the 12 stride-1 blocks of B0@{RES} at B={BATCH}, summed",
                yardstick_per_op_ms=mb_tot["per_op_ms"], edges=mb_report["edges"] + mb_v2["edges"],
                mobilenetv2=dict(blocks=mb_v2["blocks"], total=mb_v2["total"]), pruned=prune_mb),
            max_abs_err=max(r["max_abs_err"] for r in mb_report["blocks"]), ms=mb_tot["ms"],
            plain_ms=mb_tot["plain_ms"], bound_ms=mb_tot["bound_ms"], library_ms=None,
            bound_by=max(("operations", "bytes"),
                key=lambda by: sum(r["bound_ms"] for r in mb_report["blocks"] if r["bound_by"] == by))),
        chi2_row,
    ]
    print(json.dumps({"lines": {"main": line, "service_modes": mode_rows, "cascade": casc_row, "approx_select": apx_row,
          "bf": bf_rows, "partial_escalation": esc_rows, "fused_path": fused_row, "s2d_stem": s2d_row,
          "flagship": flagship_row, "tools": tools_row, "sharded_service": sharded_rows,
          "sharded_matcher": sharded_matcher_rows, "prune": prune_lines,
          **mobilenet_lines, **zoo_lines, **chi2_lines, **feature_lines}}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi_line(), flush=True)
    phase(f"done: total command time {time.time() - T0:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
