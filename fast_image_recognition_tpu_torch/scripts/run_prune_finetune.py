"""Prune / fine-tune driver (JAX ``cli/run_prune_finetune.py``): fine-tune,
prune by a metric, fine-tune again; a params / val_acc / latency line a model.
``main(argv)`` returns the lines."""

import argparse
from typing import List, Optional, Sequence

import numpy as np


def synth_images(spec: str, seed: int):
    """``C,PER_CLASS,RES`` noise images, class c brightened by 0.8 c (JAX's)."""
    c, per, res = (int(x) for x in spec.split(","))
    rng = np.random.default_rng(seed)
    labels = np.repeat(np.arange(c), per)
    images = rng.normal(size=(c * per, res, res, 3)).astype(np.float32) + labels[:, None, None, None] * 0.8
    perm = rng.permutation(len(labels))
    return images[perm], labels[perm].astype(np.int64), c, res


def main(argv: Optional[Sequence[str]] = None, device=None) -> List[str]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--synthetic", default="4,24,32", metavar="C,PER,RES")
    p.add_argument("--variant", default="b0", help="b0..b7 | mobilenetv2[_W]")
    p.add_argument("--metric", default="l1", help="l1|apoz|taylor|leave_one_out|class_sep|random")
    for name, default in (("fraction", 0.25), ("epochs", 1), ("seed", 13)):
        p.add_argument("--" + name, type=type(default), default=default)
    p.add_argument("--device", default=device, help="default the card; 'cpu' runs the plain path")
    args = p.parse_args(argv)

    import torch

    from ..models import create_backbone, default_taps_for
    from ..models.pruning import parameter_count, prune_backbone
    from ..models.train import MultiExitTrainer, TrainConfig
    from ..utils.profiling import time_jitted

    images, labels, c, res = synth_images(args.synthetic, args.seed)
    n = int(len(labels) * 0.8)
    model, variables = create_backbone(args.variant, 0, resolution=res, device=args.device)
    cfg = TrainConfig(c, tuple(default_taps_for(args.variant)), res, batch_size=16, phase1_epochs=args.epochs,
            phase2_epochs=args.epochs)
    lines = []

    def measure(name, m, v):
        trainer = MultiExitTrainer(m, v, cfg, device=args.device)
        trainer.fit(images[:n], labels[:n], images[n:], labels[n:], verbose=False)
        x = torch.as_tensor(images[n : n + 16], device=trainer.device)
        with torch.no_grad():
            ms = time_jitted(lambda: trainer.model(x)["embedding"], iters=5)["steady_s"] * 1e3 / len(x)
        v, acc = trainer.variables, trainer.evaluate(images[n:], labels[n:])
        lines.append(f"{name}: params={parameter_count(v) / 1e6:.2f}M val_acc={acc:.3f} latency={ms:.3f} ms/image")
        print(lines[-1], flush=True)
        return v

    print(f"== baseline {args.variant} ==")
    trained = measure("baseline", model, variables)
    print(f"== pruned {args.fraction:.0%} by {args.metric} ==")
    measure(f"pruned-{args.metric}", *prune_backbone(model, trained, args.fraction, args.metric, images=images[:32],
            labels=labels[:32], num_classes=c, seed=args.seed))
    return lines


if __name__ == "__main__":
    main()
