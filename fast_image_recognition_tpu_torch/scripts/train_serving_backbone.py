"""Train the serving backbone (JAX ``cli/train_serving_backbone.py``) on
card-rendered synthetic classes; ``main(argv)`` returns the JSON line's dict."""

import argparse
import json
import time
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None, device=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    for name, default in (("variant", "b0"), ("resolution", 224), ("classes", 128), ("per-class", 60),
            ("train-per-class", 48), ("batch-size", 128), ("epochs", 30), ("lr", 2e-3), ("patience", 6),
            ("taps", "early"), ("seed", 0)):
        p.add_argument("--" + name, type=type(default), default=default)
    p.add_argument("--head", default="linear", choices=["linear", "cosine"])
    p.add_argument("--out", default="benchmarks/trained_{variant}_{res}_synthetic{classes}_s{seed}.npz")
    p.add_argument("--device", default=device, help="default the card; 'cpu' runs the plain path")
    args = p.parse_args(argv)

    import torch

    from ..data.synthetic_device import device_dataset
    from ..device import resolve_device
    from ..models import backbone_info, create_backbone, default_taps, default_taps_for
    from ..models.efficientnet import MEAN_RGB, STDDEV_RGB
    from ..models.train import MultiExitTrainer, TrainConfig

    dev, res = resolve_device(args.device), args.resolution
    t0 = time.perf_counter()
    # train and validation rendered apart: other instance seeds, the same classes
    tr_imgs, tr_labels = device_dataset(args.classes, args.train_per_class, res, seed=args.seed, device=dev)
    va_imgs, va_labels = device_dataset(args.classes, args.per_class - args.train_per_class, res,
            seed=args.seed + 7919, class_seed=args.seed, device=dev)
    print(f"device dataset {tuple(tr_imgs.shape)}+{tuple(va_imgs.shape)} rendered in "
          f"{time.perf_counter() - t0:.0f}s", flush=True)
    info = backbone_info(args.variant)  # the preprocess the serving fold bakes into the stem
    if info.get("preprocess") == "tf":
        preprocess = lambda x: x / 127.5 - 1.0  # noqa: E731
    else:
        mean, std = (torch.tensor(v, device=dev) for v in (MEAN_RGB, STDDEV_RGB))
        preprocess = lambda x: (x - mean) / std  # noqa: E731
    model, variables = create_backbone(args.variant, 0, seed=0, resolution=res, device=dev)
    taps = tuple(default_taps(args.variant, args.taps) if info["family"] == "efficientnet"
            else default_taps_for(args.variant))
    cfg = TrainConfig(num_classes=args.classes, taps=taps, resolution=res, batch_size=args.batch_size,
            phase1_epochs=0, phase2_epochs=args.epochs, phase2_lr=args.lr, patience=args.patience,
            head=args.head, seed=args.seed)
    out = args.out.format(variant=args.variant, res=res, classes=args.classes, seed=args.seed)
    trainer = MultiExitTrainer(model, variables, cfg, checkpoint_path=out, preprocess=preprocess, device=dev)
    print(f"taps: {list(taps)}", flush=True)
    t0 = time.perf_counter()
    history = trainer.fit(tr_imgs, tr_labels, va_imgs, va_labels, verbose=True)
    train_s = time.perf_counter() - t0
    best = max(history["val_acc"]) if history["val_acc"] else float("nan")
    line = {"checkpoint": out, "variant": args.variant, "resolution": res, "classes": args.classes,
            "taps": list(taps), "best_val_acc": round(best, 4),
            "last_val_acc": round(trainer.evaluate(va_imgs, va_labels), 4), "train_seconds": round(train_s, 1)}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
