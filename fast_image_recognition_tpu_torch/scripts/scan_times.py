"""Time the port's scan kernels on the card at the shapes its paths give them.

Each kernel runs on inputs made from ``--seed`` (unit rows of a normal
gallery; queries are rows of it plus noise) and is timed with CUDA events:
the mean over ``--reps`` calls after one warm-up call (a third as many for
the fp32 ``precise`` scan). Shapes:

- ``tilemin``: 1024 queries x 1,000,448 rows, D = 128, tile_g = 1024, fp32
  and bf16 scores (the JAX-default service's PCA scan and
  ``pca_scan='bf16'``); D = 768 (queries streamed through the ring);
- ``tilemin_packed``: Da = 128 over 1,000,448 rows at tile_g 1024 (the
  cascade's block3a level) and over 131,072 rows at tile_g 128;
- ``tilemin2_packed``: Da = 128 over 1,000,448 rows (the plain line) and
  Da = 768 over 131,072 rows (``pca_dim=700``, streamed queries);
- ``topk_l2``: fp32 ``precise`` at 1024 x 1,000,000 x 1280, k = 1 (the
  oracle), and bf16 at 256 x 1,000,000 x 1280, k = 32 (lists past 16).

A shape the checkout's kernels refuse reads null. ``--root`` imports the
port from another checkout, so one command can compare two trees on one
card: run the script once per tree, in the order A, B, B, A. Prints the
card's name and power limit, then one JSON object ``{"root", "card",
"ms": {shape: ms}}``.

Usage: python fast_image_recognition_tpu_torch/scripts/scan_times.py
       [--root CHECKOUT] [--reps 10] [--seed 0] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _ms(torch, fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)), help="checkout to import the port from")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="", help="also write the JSON object to this file")
    args = p.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("scan_times: no CUDA device", file=sys.stderr)
        return 2
    from fast_image_recognition_tpu_torch.kernels import build
    from fast_image_recognition_tpu_torch.ops import distance_kernel as dk

    build.build(["tile_scan", "packed_scan", "topk_l2"])  # one nvcc each, in parallel
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

    ms = {}

    def timed(name, fn, reps=args.reps):
        try:
            ms[name] = _ms(torch, fn, reps)
        except (ValueError, RuntimeError) as e:  # a shape this checkout refuses
            print(f"{name}: {type(e).__name__}: {str(e).splitlines()[0]}", file=sys.stderr)
            ms[name] = None

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
    n, d = 1_000_000, 1280
    g = rows(n, d).to(torch.bfloat16)
    q = probes(g, 1024)
    timed(f"topk_l2 precise B=1024 N={n} D={d} k=1",
          lambda: build.launch_topk_l2(q, g, 1, n, precise=True), reps=max(1, args.reps // 3))
    q16 = q[:256].to(torch.bfloat16)
    timed(f"topk_l2 bf16 B=256 N={n} D={d} k=32", lambda: build.launch_topk_l2(q16, g, 32, n),
          reps=max(1, args.reps // 3))

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = {"root": root, "card": card, "ms": ms}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
