"""chi2/KL streamed-scan cost beside the chi2 kernel and the L2 scan (JAX's
``scripts/chi2_cost.py``): host clock between syncs, top-1 vs fp64. ``python -m
fast_image_recognition_tpu_torch.scripts.chi2_cost``."""

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence

KINDS = ("chi2", "l2", "kl", "chi2_pallas", "chi2_pallas_bf16")


def make_data(n: int, b: int, d: int, device, seed: int = 0):
    """(gallery [n, d], queries [b, d]) fp32: L1-normalized uniform rows; queries rows[:b] + 0.05 U / d."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    g = torch.rand((n, d), generator=gen, device=device)
    g /= g.sum(dim=1, keepdim=True)
    q = g[:b] + 0.05 * torch.rand((b, d), generator=gen, device=device) / d
    q /= q.sum(dim=1, keepdim=True)
    return g, q


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    p = argparse.ArgumentParser()
    for name, default in (("gallery", 102_400), ("batch", 1024), ("dim", 1536), ("iters", 5), ("warmup", 1),
            ("kinds", "chi2,l2")):
        p.add_argument("--" + name, type=type(default), default=default)
    p.add_argument("--out", default="-", help="'-' = stdout, else append path")
    p.add_argument("--device", default=None, help="default: the card")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from ..config import DistanceKind
    from ..device import resolve_device
    from ..ops.chi2_kernel import chi2_nn
    from ..ops.distances import oracle_pairwise, streamed_topk
    from ..utils.profiling import host_sync, timed

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
                host_sync(fn(queries, gal))
            sec = timed(lambda: fn(queries, gal), args.iters)[1] / 1e3
            # top-1 on 8 probes vs the float64 oracle over a 4096-row
            # slice (the oracle materializes the [B, N, D] broadcast)
            nprobe = 8
            oracle = oracle_pairwise(queries[:nprobe].cpu().numpy(), gallery[:4096].cpu().numpy(), kind=kind)
            fast = fn(queries[:nprobe], gal[:4096])[1].cpu().numpy()
        agree = float(np.mean(fast == oracle.argmin(axis=1)))
        qps = b / sec
        triples = float(b) * n * d
        line = {"metric": f"{unit} ({kind_name} streamed scan, D={d}, {n} gallery, B={b})", "value": round(qps, 1),
            "unit": unit, "sec_per_batch": round(sec, 4), "elem_triples_per_sec": f"{triples / sec:.3e}",
            "probe_agreement": agree, "device": name}
        lines.append(line)
        print(json.dumps(line))
        sys.stdout.flush()

    if args.out != "-":
        with open(args.out, "a") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    return lines


if __name__ == "__main__":
    main()
