"""Multi-exit fine-tuning (JAX ``models/train.py``): softmax or cosine heads on
each tap and the embedding; phase 1 the heads, phase 2 everything, Adam; no
host sync in a step."""

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from .zoo import _BatchNorm
from ..utils.checkpoint import BestCheckpoint, EarlyStopping


def init_heads(model, variables, taps: Sequence[str], num_classes: int, resolution: int,
        seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """A head a tap and the embedding: ``w`` N(0, 1/d) from a seeded ``torch.Generator``, ``b`` 0; numpy."""
    dev = next(model.parameters()).device
    with torch.no_grad():
        out = model(torch.zeros((1, resolution, resolution, 3), device=dev), taps=taps)
    gen = torch.Generator().manual_seed(int(seed))
    return [{"w": (torch.randn((d, num_classes), generator=gen) / math.sqrt(d)).numpy(), "b": np.zeros((num_classes,),
            np.float32)} for d in [int(out["taps"][t].shape[-1]) for t in taps] + [int(out["embedding"].shape[-1])]]


def class_weights(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """Balanced: n_samples / (n_classes * class_count)."""
    counts = np.maximum(np.bincount(labels, minlength=num_classes).astype(np.float64), 1.0)
    return (len(labels) / (num_classes * counts)).astype(np.float32)


@dataclasses.dataclass
class TrainConfig:
    num_classes: int
    taps: Tuple[str, ...]
    resolution: int
    batch_size: int = 32
    phase1_lr: float = 1e-3
    phase2_lr: float = 1e-4
    phase1_epochs: int = 3
    phase2_epochs: int = 3
    weight_decay: float = 0.0  # unused, as in JAX
    patience: int = 3
    loss_head_weights: bool = True
    head: str = "linear"  # or 'cosine': normalized embedding x normalized weights at a fixed scale
    cosine_scale: float = 16.0
    seed: int = 0


class MultiExitTrainer:
    """Two-phase fine-tuning of a zoo module on ``device`` (default the card) from ``variables``."""

    def __init__(self, model, variables, config: TrainConfig, checkpoint_path: Optional[str] = None,
            preprocess=None, device: DeviceLike = None):
        self.device, self.config, self.preprocess = resolve_device(device), config, preprocess
        self.model = model.to(self.device).load_variables(variables)
        heads = init_heads(self.model, variables, config.taps, config.num_classes, config.resolution, config.seed)
        self.heads = [{k: torch.tensor(v, device=self.device, requires_grad=True) for k, v in h.items()} for h in heads]
        self.ckpt = BestCheckpoint(checkpoint_path) if checkpoint_path else None
        self.rng = torch.Generator(device=self.device).manual_seed(config.seed)

    def _prep(self, images) -> torch.Tensor:
        x = torch.as_tensor(images).to(self.device, torch.float32)
        return self.preprocess(x) if self.preprocess is not None else x

    def _batch(self, images, idx: torch.Tensor) -> torch.Tensor:
        return self._prep(images[idx] if torch.is_tensor(images) else images[idx.cpu().numpy()])

    def _logits(self, e: torch.Tensor, h) -> torch.Tensor:
        if self.config.head == "cosine":
            en = e / torch.clamp(torch.linalg.vector_norm(e, dim=1, keepdim=True), min=1e-12)
            wn = h["w"] / torch.clamp(torch.linalg.vector_norm(h["w"], dim=0, keepdim=True), min=1e-12)
            return self.config.cosine_scale * (en @ wn)
        return e @ h["w"] + h["b"]

    def _loss(self, images: torch.Tensor, labels: torch.Tensor, cls_w: torch.Tensor) -> torch.Tensor:
        """JAX :162-183: sum of ``w_i * mean(ce * cls_w[labels])`` over sum ``w_i``, in train mode."""
        out = self.model(images, train=True, taps=self.config.taps, rng=self.rng)
        embs = [out["taps"][t] for t in self.config.taps] + [out["embedding"]]
        per_example_w, total, weight_sum = cls_w[labels], 0.0, 0.0
        for i, (e, h) in enumerate(zip(embs, self.heads)):
            ce = F.cross_entropy(self._logits(e, h), labels, reduction="none")
            w = float(len(embs) - i) if self.config.loss_head_weights else 1.0
            total, weight_sum = total + w * torch.mean(ce * per_example_w), weight_sum + w
        return total / weight_sum

    def _optimizer(self, train_backbone: bool, lr: float) -> torch.optim.Adam:
        """Phase 1: Adam over the heads (optax's ``set_to_zero`` on the backbone); phase 2: everything."""
        self.model.requires_grad_(train_backbone)
        params = [p for h in self.heads for p in h.values()] + (list(self.model.parameters()) if train_backbone else [])
        return torch.optim.Adam(params, lr=lr, capturable=self.device.type == "cuda")

    def _step(self, opt, images, idx: torch.Tensor, labels: torch.Tensor, cls_w: torch.Tensor) -> torch.Tensor:
        loss = self._loss(self._batch(images, idx), labels[idx], cls_w)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    def calibrate_batch_stats(self, images) -> None:
        """One train-mode pass's batch statistics as the running ones: ``(new - m * old) / (1 - m)``."""
        bns = [m for m in self.model.modules() if isinstance(m, _BatchNorm)]
        old = [(bn.mean.clone(), bn.var.clone()) for bn in bns]
        with torch.no_grad():
            self.model(self._prep(images), train=True, rng=torch.Generator(device=self.device).manual_seed(0))
            for bn, (mean, var) in zip(bns, old):
                bn.mean.copy_((bn.mean - bn.momentum * mean) / (1.0 - bn.momentum))
                bn.var.copy_((bn.var - bn.momentum * var) / (1.0 - bn.momentum))

    @torch.no_grad()
    def evaluate(self, images, labels: np.ndarray) -> float:
        """The final head's accuracy in eval mode."""
        lab = torch.as_tensor(np.asarray(labels), device=self.device)
        correct, bs = torch.zeros((), dtype=torch.int64, device=self.device), self.config.batch_size
        for s in range(0, len(images), bs):
            e = self.model(self._prep(images[s : s + bs]))["embedding"]
            correct += (self._logits(e, self.heads[-1]).argmax(1) == lab[s : s + bs]).sum()
        return int(correct) / len(images)

    @torch.no_grad()
    def head_logits(self, images) -> List[np.ndarray]:
        """Per-exit logits, eval mode."""
        out = self.model(self._prep(images), taps=self.config.taps)
        embs = [out["taps"][t] for t in self.config.taps] + [out["embedding"]]
        return [self._logits(e, h).cpu().numpy() for e, h in zip(embs, self.heads)]

    def fit(self, train_images, train_labels: np.ndarray, val_images=None, val_labels: Optional[np.ndarray] = None,
            verbose: bool = True) -> Dict[str, list]:
        """JAX :288-361; batches in ``np.random.default_rng(seed)``'s order."""
        cfg, dev, bs = self.config, self.device, self.config.batch_size
        train_labels = np.asarray(train_labels)
        cls_w = torch.tensor(class_weights(train_labels, cfg.num_classes), device=dev)
        labels = torch.as_tensor(train_labels, dtype=torch.int64, device=dev)
        history = {"loss": [], "val_acc": []}
        rng = np.random.default_rng(cfg.seed)
        self.calibrate_batch_stats(train_images[: bs * 2])
        for phase, (train_backbone, lr, epochs) in enumerate(
                [(False, cfg.phase1_lr, cfg.phase1_epochs), (True, cfg.phase2_lr, cfg.phase2_epochs)]):
            if epochs == 0:
                continue
            opt, stopper = self._optimizer(train_backbone, lr), EarlyStopping(patience=cfg.patience)
            for epoch in range(epochs):
                order = torch.as_tensor(rng.permutation(len(train_images)), device=dev)  # one upload an epoch
                losses = [self._step(opt, train_images, order[b * bs : (b + 1) * bs], labels, cls_w)
                        for b in range(len(order) // bs)]
                history["loss"].append(float(torch.stack(losses).mean()))
                msg = f"phase{phase + 1} epoch {epoch}: loss={history['loss'][-1]:.4f}"
                if val_images is not None:
                    acc = self.evaluate(val_images, val_labels)
                    history["val_acc"].append(acc)
                    msg += f" val_acc={acc:.4f}"
                    if self.ckpt:
                        self.ckpt.update(acc, {**self.variables, "heads": self.head_arrays()})
                    if stopper.update(acc):
                        if verbose:
                            print(msg + " (early stop)")
                        break
                if verbose:
                    print(msg)
        self.model.requires_grad_(True)
        return history

    def head_arrays(self) -> List[Dict[str, np.ndarray]]:
        return [{k: np.array(v.detach().cpu()) for k, v in h.items()} for h in self.heads]  # copies

    @property
    def variables(self):
        v = self.model.export_variables()
        return {"params": v["params"], "batch_stats": v.get("batch_stats", {})}
