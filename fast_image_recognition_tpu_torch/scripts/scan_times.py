"""Kernel times on the card at the paths' shapes: CUDA-event means over ``--reps``
after a warm-up and a second idle, then ``nvidia-smi`` samples (SM clock,
power, temperature). ``tilemin``, both packed scans, ``tilemin_quant``,
``topk_l2`` bf16 and precise; ``--mbconv``: the fused block vs per-op at
B0@224. ``--root``: another checkout (run A, B, B, A). Usage: python
fast_image_recognition_tpu_torch/scripts/scan_times.py [--root CHECKOUT]
[--mbconv] [--reps 10] [--seed 0] [--out FILE]"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


SETTLE_S = 1.0  # idle before each shape: each starts from the same power state


def _ms(torch, fn, reps: int) -> float:
    time.sleep(SETTLE_S)
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _clocks(torch, fn, seconds: float = 0.5):
    """Median SM clock, power and temperature of 20-ms ``nvidia-smi`` samples
    while ``fn`` runs for ``seconds``; None without a reading."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                            "--format=csv,noheader,nounits", "-lms", "20"], stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    try:
        proc.stdout.readline()  # the first sample: nvidia-smi is up, the card still idle
        t0 = time.time()
        while time.time() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out = proc.communicate()[0]
    samples = []
    for line in out.splitlines():
        try:
            sm, power, temp = (float(v) for v in line.split(","))
        except ValueError:  # "[N/A]" or a line cut by terminate()
            continue
        samples.append((sm, power, temp))
    if not samples:
        return None
    mid = len(samples) // 2
    sm, power, temp = (sorted(col)[mid] for col in zip(*samples))
    return {"sm_mhz": sm, "power_w": power, "temp_c": temp, "samples": len(samples)}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)), help="checkout to import the port from")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="", help="also write the JSON object to this file")
    p.add_argument("--mbconv", action="store_true", help="time the fused MBConv blocks instead of the scans")
    args = p.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("scan_times: no CUDA device", file=sys.stderr)
        return 2
    from fast_image_recognition_tpu_torch.kernels import build
    from fast_image_recognition_tpu_torch.ops import distance_kernel as dk

    build.build(["mbconv"] if args.mbconv else ["tile_scan", "packed_scan", "topk_l2"])  # one nvcc each, in parallel
    for name, log in build.BUILD_LOG.items():  # registers per kernel, when this call compiled it
        kernel = ""
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = m.group(1)
            elif "registers" in line:
                print(f"ptxas {name} {kernel}: {line.split(':', 1)[-1].strip()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def unit(x):
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)

    def rows(n, d):
        return unit(torch.randn((n, d), generator=gen, device=dev))

    def probes(g, b):
        return unit(g[:b].float() + 0.05 * torch.randn((b, g.shape[1]), generator=gen, device=dev))

    ms, clocks = {}, {}

    def timed(name, fn, reps=args.reps):
        try:
            ms[name] = _ms(torch, fn, reps)
            clocks[name] = _clocks(torch, fn)
        except (ValueError, RuntimeError) as e:  # a shape this checkout refuses
            print(f"{name}: {type(e).__name__}: {str(e).splitlines()[0]}", file=sys.stderr)
            ms[name] = clocks[name] = None

    if args.mbconv:
        _mbconv_times(torch, dev, gen, timed, HERE)
    else:
        _scan_times(torch, build, dk, rows, probes, timed, args.reps)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = {"root": root, "card": card, "ms": ms, "clocks": clocks}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return 0


def _scan_times(torch, build, dk, rows, probes, timed, reps):
    from fast_image_recognition_tpu_torch.ops.quant import quantize_rows

    np_ = 977 * 1024  # 1,000,448 rows: 1,000,000 padded to whole tiles
    for d in (128, 768):
        g = rows(np_ if d == 128 else 131_072, d).to(torch.bfloat16)
        gsq = (g.float() ** 2).sum(1)
        q = probes(g, 1024).to(torch.bfloat16)
        for bf16s in ((False, True) if d == 128 else (False,)):
            timed(f"tilemin {'bf16' if bf16s else 'f32'}-scores B=1024 Np={g.shape[0]} D={d} tile_g=1024",
                  lambda: build.launch_tilemin(q, g, gsq, 1024, bf16s))
        dp = d - 4  # PCA-124 and PCA-700: Da = 128 and 768
        ga = dk.pack_gallery_aug(g[:, :dp].contiguous(), tile_g=1024)
        qa = dk._augment_queries(q[:, :dp], dp, ga.shape[1])
        if d == 128:
            timed(f"tilemin_packed B=1024 Np={np_} Da={ga.shape[1]} tile_g=1024",
                  lambda: build.launch_tilemin_packed(qa, ga, 1024))
            ga128 = ga[:131_072]
            timed(f"tilemin_packed B=1024 Np=131072 Da={ga.shape[1]} tile_g=128",
                  lambda: build.launch_tilemin_packed(qa, ga128, 128))
        timed(f"tilemin2_packed B=1024 Np={ga.shape[0]} Da={ga.shape[1]}", lambda: build.launch_tilemin2_packed(qa, ga))
        del g, gsq, ga, qa
    n = 1_000_000
    for d in (1280, 1536):
        g32 = rows(n, d)
        g = g32.to(torch.bfloat16)
        q = probes(g, 1024)
        q16 = q.to(torch.bfloat16)
        # bf16 before and after the precise pass (it may change the clock)
        for after in ((False, None, True) if d == 1280 else (None,)):
            if after is None:
                timed(f"topk_l2 precise B=1024 N={n} D={d} k=1",
                      lambda: build.launch_topk_l2(q, g, 1, n, precise=True), reps=max(1, reps // 3))
                timed(f"topk_l2 precise rows=fp32 B=1024 N={n} D={d} k=1",
                      lambda: build.launch_topk_l2(q, g32, 1, n, precise=True), reps=max(1, reps // 3))
                continue
            tag = " after precise" if after else ""
            timed(f"topk_l2 bf16 B=1024 N={n} D={d} k=1{tag}", lambda: build.launch_topk_l2(q16, g, 1, n))
            timed(f"topk_l2 bf16 B=256 N={n} D={d} k=32{tag}", lambda: build.launch_topk_l2(q16[:256], g, 32, n))
        if d == 1536:
            gq, gs = quantize_rows(dk.pad_gallery(g, 1024))
            gsq = dk.gallery_sq_norms(g, n).reshape(-1)
            gsc = dk.quant_gallery_scales(gs, n).reshape(-1)
            qq, qs = quantize_rows(q)
            for compute in ("int8", "bf16"):
                timed(f"tilemin_quant {compute} B=1024 Np={gq.shape[0]} D={d} tile_g=1024",
                      lambda compute=compute: build.launch_tilemin_quant(qq, qs, gq, gsq, gsc, 1024, compute))
            del gq, gs, gsq, gsc
        del g, g32, q


def _mbconv_times(torch, dev, gen, timed, here):
    """The fused MBConv kernel and the per-op block at each stride-1 block of B0@224, B = 1024."""
    from fast_image_recognition_tpu_torch.models.inference import make_infer_fn
    from fast_image_recognition_tpu_torch.ops import mbconv_kernel as mb
    from fast_image_recognition_tpu_torch.utils.checkpoint import load_variables

    ckpt = os.path.join(os.path.dirname(os.path.dirname(here)), "benchmarks", "trained_b0_224_synthetic1024_s0.npz")
    v = load_variables(ckpt)
    np_vars = {"params": v["params"], "batch_stats": v["batch_stats"]}
    net = make_infer_fn(np_vars, "b0", resolution=224, device=dev)
    net_f = make_infer_fn(np_vars, "b0", resolution=224, fused=True, device=dev)
    with torch.no_grad():
        h = net.stem(torch.zeros((1, 224, 224, 3), dtype=torch.uint8, device=dev))
        for i, (name, blk) in enumerate(zip(net.names, net.blocks)):
            if str(i) in net_f.fused_blocks:
                fb = net_f.fused_blocks[str(i)]
                q = {n: getattr(fb, n) for n in fb.param_names}
                x = torch.randn((1024, *h.shape[1:]), generator=gen, device=dev).to(torch.bfloat16)
                x = x.contiguous(memory_format=torch.channels_last)
                tag = (f"{name} B=1024 {h.shape[2]}x{h.shape[3]} "
                       f"{h.shape[1]}->{q['w_proj_t'].shape[1]}->{q['w_proj_t'].shape[0]}")
                timed(f"mbconv {tag}", lambda x=x, q=q, cfg=fb.cfg: mb.mbconv(x, q, cfg))
                timed(f"per-op {tag}", lambda x=x, blk=blk: blk(x))
                del x
            h = blk(h)


if __name__ == "__main__":
    sys.exit(main())
