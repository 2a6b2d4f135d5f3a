"""The trained cascade's operating curve (JAX ``cli/run_trained_cascade.py``):
fine-tune, FAR-tuned linear exits, macro recall against img/s of the pooled
FAR sweep, ``--streams`` and a fused point beside the no-exit forward.
``main(argv, device=None)`` returns the records."""

import argparse
import json
import time
from typing import List, Optional, Sequence

import numpy as np


def load_dataset(name: str, res: int, classes: int = 128, per_class: int = 60, seed: int = 0):
    """(images in [-1, 1], labels, tag); ``digits`` needs scikit-learn."""
    if name == "digits":
        try:
            from sklearn.datasets import load_digits
        except ImportError as e:
            raise RuntimeError("--dataset digits needs scikit-learn, which is not installed") from e
        d = load_digits()
        x = np.repeat(np.repeat(d.images.astype(np.float32) / 16.0, res // 8, axis=1), res // 8, axis=2)
        return (x[..., None] * 2.0 - 1.0).repeat(3, axis=-1), d.target.astype(np.int64), "digits"
    if name == "synthetic":
        from ..data.synthetic_images import make_synthetic_image_dataset

        x, y = make_synthetic_image_dataset(classes, per_class, res, seed=seed)
        return x.astype(np.float32) / 255.0 * 2.0 - 1.0, y, f"synthetic{classes}"
    raise ValueError(f"unknown dataset {name!r}")


def stratified_split(labels: np.ndarray, train_frac: float, seed: int):
    rng = np.random.default_rng(seed)
    tr, va = [], []
    for c in np.unique(labels):
        idx = rng.permutation(np.nonzero(labels == c)[0])
        k = int(round(train_frac * len(idx)))
        tr.append(idx[:k])
        va.append(idx[k:])
    return np.concatenate(tr), np.concatenate(va)


def main(argv: Optional[Sequence[str]] = None, device=None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__)
    for name, default in (("variant", "b0"), ("resolution", 32), ("train-frac", 0.7), ("phase1-epochs", 4),
            ("phase2-epochs", 4), ("batch-size", 64), ("phase1-lr", 1e-3), ("phase2-lr", 1e-4),
            ("pool", 4096), ("bucket", 1024), ("iters", 5), ("far-sweep", "0.1,0.05,0.02,0.01,0.005"),
            ("fused-far", 0.01), ("seed", 0), ("classes", 128), ("per-class", 60)):
        p.add_argument("--" + name, type=type(default), default=default)
    p.add_argument("--streams", default="1", help="comma list: the first runs the sweep, the rest --fused-far")
    p.add_argument("--out", default=None, help="append the records here (JSON lines)")
    p.add_argument("--dataset", default="digits", choices=["digits", "synthetic"])
    p.add_argument("--device", default=device, help="default the card; 'cpu' runs the plain path")
    args = p.parse_args(argv)
    streams = [int(s) for s in str(args.streams).split(",")]

    import torch

    from ..cascade.engine import SequentialInferencePipeline
    from ..cascade.exits import LinearExitCascade
    from ..device import resolve_device
    from ..evaluation.harness import macro_recall_percent
    from ..models import create_backbone, default_taps_for
    from ..models.train import MultiExitTrainer, TrainConfig
    from ..utils.profiling import time_jitted

    dev, res = resolve_device(args.device), args.resolution
    images, labels, dtag = load_dataset(args.dataset, res, args.classes, args.per_class, args.seed)
    num_classes = int(labels.max()) + 1
    tr_idx, va_idx = stratified_split(labels, args.train_frac, args.seed)
    tr_imgs, va_imgs = (torch.from_numpy(images[i]).to(dev) for i in (tr_idx, va_idx))
    tr_y, va_y = labels[tr_idx], labels[va_idx]
    model, variables = create_backbone(args.variant, 0, resolution=res, device=dev)
    taps = tuple(default_taps_for(args.variant))
    cfg = TrainConfig(num_classes=num_classes, taps=taps, resolution=res, batch_size=args.batch_size,
            phase1_lr=args.phase1_lr, phase2_lr=args.phase2_lr, phase1_epochs=args.phase1_epochs,
            phase2_epochs=args.phase2_epochs, seed=args.seed)
    trainer = MultiExitTrainer(model, variables, cfg, device=dev)
    t0 = time.perf_counter()
    with torch.enable_grad():
        history = trainer.fit(tr_imgs, tr_y, va_imgs, va_y, verbose=True)
    train_s = time.perf_counter() - t0
    final_acc = trainer.evaluate(va_imgs, va_y)

    zeros = [np.zeros((num_classes, 1), np.float32)] * (len(taps) + 1)
    pipe = SequentialInferencePipeline(model, trainer.variables, taps, coefs=zeros,
            intercepts=[np.zeros(num_classes, np.float32)] * (len(taps) + 1),
            engine="folded", device=dev)
    x_train = pipe.level_embeddings(tr_imgs)
    fars = [float(f) for f in args.far_sweep.split(",")]
    cascades = {far: LinearExitCascade.train(x_train, tr_y, num_classes, far=far, seed=args.seed, device=dev)
            for far in dict.fromkeys(fars + [args.fused_far])}

    def use(c):
        pipe.coefs, pipe.intercepts = ([torch.as_tensor(np.asarray(a, np.float32)).to(dev, torch.float64) for a in v]
                for v in (c.coefs, c.intercepts))
        pipe.thresholds = [float(t) for t in c.thresholds[:-1]]

    # the no-exit baseline: iters queued, one fetch
    pool_idx = np.resize(np.arange(len(va_y)), args.pool)
    pool_imgs, pool_y = va_imgs[torch.as_tensor(pool_idx).to(dev)], va_y[pool_idx]
    net, c_last = pipe._net, cascades[fars[0]]
    coef, icpt = (torch.as_tensor(np.asarray(a, np.float32)).to(dev) for a in (c_last.coefs[-1], c_last.intercepts[-1]))

    @torch.no_grad()
    def no_exit(x):
        emb = net.head(net.run_blocks(net.raw_stem(x), 0, pipe.segments[-1][1])).to(torch.float32)
        emb = emb / torch.clamp_min(torch.linalg.vector_norm(emb, dim=1, keepdim=True), 1e-12)
        return torch.argmax(emb @ coef.T + icpt, dim=1)

    base_ips = args.pool / time_jitted(no_exit, pool_imgs, iters=args.iters)["steady_s"]
    base_recall = macro_recall_percent(pool_y, no_exit(pool_imgs).cpu().numpy(), num_classes)
    results = []
    head = dict(dataset=dtag, variant=args.variant, resolution=res)

    def emit(rec):
        rec["vs_noexit"] = rec["img_per_s"] / base_ips
        results.append(rec)
        print(json.dumps(rec), flush=True)

    emit(dict(config="cascade_trained_noexit", **head, val_acc_final_head=round(final_acc, 4),
            macro_recall_pct=round(base_recall, 2), img_per_s=round(base_ips, 1), train_seconds=round(train_s, 1),
            loss=history["loss"]))

    def pooled(far, s):
        use(cascades[far])
        pipe.predict_pooled(pool_imgs, bucket=args.bucket, warmup=True, streams=s)
        best = min((pipe.predict_pooled(pool_imgs, bucket=args.bucket, streams=s) for _ in range(args.iters)),
                key=lambda r: r.ms_per_image)
        emit(dict(config="cascade_trained_pooled", streams=s, **head, far=far,
                macro_recall_pct=round(macro_recall_percent(pool_y, best.predictions, num_classes), 2),
                img_per_s=round(1000.0 / best.ms_per_image, 1),
                break_counts=[round(float(b), 4) for b in best.break_counts]))

    for far in fars:
        pooled(far, streams[0])
    for s in streams[1:]:  # the streams comparison at the fused FAR
        pooled(args.fused_far, s)

    # one fused point, timed as the baseline
    use(cascades[args.fused_far])
    pipe.calibrate(tr_imgs[: min(len(tr_imgs), 512)], tune=False)
    rr = pipe.predict_fused(pool_imgs)
    fused_fn = pipe.fused_fn(args.pool)
    fused_ms = time_jitted(fused_fn, pool_imgs, iters=args.iters)["steady_s"] * 1e3
    preds_f = fused_fn(pool_imgs)[: args.pool].cpu().numpy()
    emit(dict(config="cascade_trained_fused", **head, far=args.fused_far,
            macro_recall_pct=round(macro_recall_percent(pool_y, preds_f, num_classes), 2),
            img_per_s=round(args.pool / fused_ms * 1e3, 1),
            break_counts=[round(float(x), 4) for x in rr.break_counts],
            forced_fraction=round(rr.forced_fraction, 4)))
    if args.out:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(r) + "\n" for r in results)
    return results


if __name__ == "__main__":
    main()
