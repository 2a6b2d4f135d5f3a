"""Measure the chi2/KL streamed-scan cost at production scale, beside the
chi2 kernel and the L2 scan (the port's counterpart of
``scripts/chi2_cost.py``, with the same flags, defaults, kinds and JSON
fields).

Kinds: ``chi2``, ``l2``, ``kl`` run ``ops/distances.py::streamed_topk``
(a loop over gallery tiles with the [B, tile, D] elementwise distance,
or an fp32 matmul for L2, fused into a running top-1); ``chi2_pallas``
and ``chi2_pallas_bf16`` run ``ops/chi2_kernel.py::chi2_nn``, which on the
card is the hand-written CUDA kernel ``kernels/chi2.cu`` over an fp32 or
bf16 gallery. The names are the JAX script's, so one command line reads
the same against both packages.

Data is made on the device from a seeded ``torch.Generator``: uniform
rows, L1-normalized; queries are the first B rows plus 0.05 U / D,
renormalized. Each kind is timed on the host clock between device syncs
over ``--iters`` calls after ``--warmup`` untimed ones, and its top-1 is checked
against the fp64 oracle on 8 probes x 4096 rows (``probe_agreement``).

Usage: python -m fast_image_recognition_tpu_torch.scripts.chi2_cost
       [--gallery 102400] [--batch 1024] [--dim 1536] [--iters 5] [--warmup 1]
       [--kinds chi2,l2] [--out -] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional, Sequence

KINDS = ("chi2", "l2", "kl", "chi2_pallas", "chi2_pallas_bf16")


def make_data(n: int, b: int, d: int, device, seed: int = 0):
    """(gallery [n, d], queries [b, d]) fp32 on ``device``: uniform rows,
    L1-normalized; queries = rows[:b] + 0.05 * U / d, renormalized."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    g = torch.rand((n, d), generator=gen, device=device)
    g /= g.sum(dim=1, keepdim=True)
    q = g[:b] + 0.05 * torch.rand((b, d), generator=gen, device=device) / d
    q /= q.sum(dim=1, keepdim=True)
    return g, q


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    p = argparse.ArgumentParser()
    p.add_argument("--gallery", type=int, default=102_400)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--dim", type=int, default=1536)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--kinds", default="chi2,l2")
    p.add_argument("--out", default="-", help="'-' = stdout, else append path")
    p.add_argument("--device", default=None, help="default: the card")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from fast_image_recognition_tpu_torch.config import DistanceKind
    from fast_image_recognition_tpu_torch.device import resolve_device
    from fast_image_recognition_tpu_torch.ops.chi2_kernel import chi2_nn
    from fast_image_recognition_tpu_torch.ops.distances import oracle_pairwise, streamed_topk

    kinds = args.kinds.split(",")
    unknown = [k for k in kinds if k not in KINDS]
    if unknown:
        raise ValueError(f"unknown kinds {unknown}; choose from {KINDS}")
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    unit = "queries/sec/chip" if dev.type == "cuda" else "queries/sec/cpu"  # a CPU run is no chip number
    n, b, d = args.gallery, args.batch, args.dim
    gallery, queries = make_data(n, b, d, dev)

    lines = []
    for kind_name in kinds:
        if kind_name.startswith("chi2_pallas"):
            kind = DistanceKind.CHI2
            gal = gallery.to(torch.bfloat16) if kind_name.endswith("bf16") else gallery

            def fn(q, g):
                return chi2_nn(q, g, n_valid=n)
        else:
            kind = DistanceKind(kind_name)
            gal = gallery

            def fn(q, g, k=kind):
                dist, idx = streamed_topk(q, g, k=1, kind=k)
                return dist[:, 0], idx[:, 0]

        with torch.no_grad():
            for _ in range(args.warmup):
                fn(queries, gal)
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                fn(queries, gal)
            _sync(dev)
            sec = (time.perf_counter() - t0) / args.iters
            # top-1 on 8 probes vs the float64 oracle over a 4096-row
            # slice (the oracle materializes the [B, N, D] broadcast)
            nprobe = 8
            oracle = oracle_pairwise(
                queries[:nprobe].cpu().numpy(), gallery[:4096].cpu().numpy(), kind=kind
            )
            fast = fn(queries[:nprobe], gal[:4096])[1].cpu().numpy()
        agree = float(np.mean(fast == oracle.argmin(axis=1)))
        qps = b / sec
        triples = float(b) * n * d
        line = {
            "metric": f"{unit} ({kind_name} streamed scan, D={d}, {n} gallery, B={b})",
            "value": round(qps, 1),
            "unit": unit,
            "sec_per_batch": round(sec, 4),
            "elem_triples_per_sec": f"{triples / sec:.3e}",
            "probe_agreement": agree,
            "device": name,
        }
        lines.append(line)
        print(json.dumps(line))
        sys.stdout.flush()

    if args.out != "-":
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return lines


if __name__ == "__main__":
    main()
