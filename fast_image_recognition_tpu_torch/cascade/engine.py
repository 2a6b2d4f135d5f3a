"""Early-exit inference over backbone segments (JAX ``cascade/engine.py``):
``predict``, ``predict_fused``, ``predict_pooled``; ``engine`` 'bind' (any zoo
module) or 'folded' (MBConv); heads 'linear' or 'knn', summed in fp64."""

import contextlib
import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.efficientnet import _pool
from ..models.inference import FoldedEfficientNet, fold_backbone


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=1, keepdim=True), 1e-12)


@dataclasses.dataclass
class PipelineResult:
    predictions: np.ndarray
    exit_level: np.ndarray
    break_counts: np.ndarray
    ms_per_image: float
    forced_fraction: float = 0.0  # capacity-overflow forced exits (fused)


class SequentialInferencePipeline:
    """Segments, exit heads and compaction over a zoo module."""

    def __init__(
        self,
        model,
        variables: Optional[Dict[str, Any]],
        taps: Sequence[str],
        coefs: Optional[Sequence[np.ndarray]] = None,  # per level [C, F_l]
        intercepts: Optional[Sequence[np.ndarray]] = None,
        thresholds: Optional[Sequence[float]] = None,  # per non-final level
        buckets: Sequence[int] = (32, 128, 512),
        l2_normalize: bool = True,
        engine: str = "bind",
        head_mode: str = "linear",
        galleries: Optional[Sequence[np.ndarray]] = None,  # knn: [N, F_l]
        gallery_labels: Optional[np.ndarray] = None,  # knn: [N]
        ratio: float = 0.8,
        device: DeviceLike = None,
    ):
        if engine not in ("bind", "folded"):
            raise ValueError(f"unknown engine {engine!r}")
        if head_mode not in ("linear", "knn"):
            raise ValueError(f"unknown head_mode {head_mode!r}")
        self.device = dev = resolve_device(device)
        plan = model.plan_configs()
        name_to_idx = {b["name"]: i for i, b in enumerate(plan)}
        tap_idx = [name_to_idx[t] for t in taps]
        if tap_idx != sorted(tap_idx):
            raise ValueError("taps must be in network order")
        # segments [0, t0+1), [t0+1, t1+1), ..., [t_last+1, n_blocks)
        bounds = [0] + [i + 1 for i in tap_idx] + [len(plan)]
        self.segments = list(zip(bounds[:-1], bounds[1:]))
        self.num_levels = len(self.segments)
        self.head_mode = head_mode
        self.ratio = float(ratio)
        if head_mode == "knn":
            if galleries is None or gallery_labels is None or len(galleries) != self.num_levels:
                raise ValueError("head_mode='knn' needs one gallery per level and gallery_labels")
            # unit rows once (cosine distance, sequential_inference.py:469)
            self.galleries = [_unit_rows(torch.as_tensor(np.asarray(g, np.float32)).to(dev)).to(torch.float64)
                    for g in galleries]
            self.gallery_labels = torch.as_tensor(np.asarray(gallery_labels), dtype=torch.int64).to(dev)
            self.coefs = self.intercepts = None
        else:
            if coefs is None or len(coefs) != self.num_levels:
                raise ValueError("head_mode='linear' needs one coef matrix per level")
            self.coefs = [torch.as_tensor(np.asarray(c, np.float32)).to(dev, torch.float64) for c in coefs]
            self.intercepts = [torch.as_tensor(np.asarray(b, np.float32)).to(dev, torch.float64) for b in intercepts]
        self.thresholds = list(thresholds) if thresholds is not None else [0.0] * (self.num_levels - 1)
        self.buckets = sorted(buckets)
        self.l2_normalize = l2_normalize
        self.engine = engine
        if engine == "folded":
            if variables is None:
                variables = model.export_variables()
            folded, configs = fold_backbone(variables, model.plan_configs())
            # the raw stem reads images of any size: the resolution is unused
            self._net = FoldedEfficientNet(folded, configs, model.resolution).to(dev).eval()
        else:
            if variables is not None:
                model.load_variables(variables)
            self._net = model.to(dev).eval()
        self.survivor_fractions: Optional[List[float]] = None
        self._fused_fns: Dict[Any, Any] = {}

    # segments

    def _linear_scores(self, emb: torch.Tensor, level: int) -> torch.Tensor:
        """[B, C] fp32 decision values, summed in fp64 and rounded once: a
        threshold tie exits alike in every batch and mode."""
        emb = (_unit_rows(emb) if self.l2_normalize else emb).to(torch.float64)
        return (emb @ self.coefs[level].T + self.intercepts[level]).to(torch.float32)

    def _head(self, emb: torch.Tensor, level: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(prediction [B], confidence [B] fp32) of a level; it fires when confidence > thresholds[level]."""
        if self.head_mode == "knn":
            emb = (_unit_rows(emb) if self.l2_normalize else emb).to(torch.float64)
            d = (2.0 - 2.0 * emb @ self.galleries[level].T).to(torch.float32)
            best = torch.argmin(d, dim=1)
            d_min = d.gather(1, best[:, None])[:, 0]
            y_best = self.gallery_labels[best]
            same = self.gallery_labels[None, :] == y_best[:, None]
            d_other = torch.where(same, math.inf, d).amin(dim=1)
            return y_best, self.ratio * d_other - d_min
        scores = self._linear_scores(emb, level)
        return torch.argmax(scores, dim=1), scores.amax(dim=1)

    @torch.no_grad()
    def level_scores(self, images, levels: Optional[int] = None) -> List[torch.Tensor]:
        """The linear heads' decision values at the first ``levels`` levels, no exits."""
        if self.head_mode != "linear":
            raise ValueError("level_scores needs linear exit heads")
        carry, out = self._images(images), []
        for level in range(self.num_levels if levels is None else levels):
            carry, emb = self._trunk(level, carry)
            out.append(self._linear_scores(emb, level))
        return out

    @torch.no_grad()
    def _trunk(self, level: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One segment and its exit embedding: (h, emb [B, F] fp32); level 0 takes NHWC images."""
        start, end = self.segments[level]
        final = level == self.num_levels - 1
        net = self._net
        if self.engine == "folded":
            h = net.raw_stem(x) if start == 0 else x
            h = net.run_blocks(h, start, end)
            emb = net.head(h) if final else h.to(torch.float32).mean(dim=(2, 3))
            return h, emb
        h = net.stem(x) if start == 0 else x
        h = net.run_blocks(h, start, end)
        return h, net.head_pool(h) if final else _pool(h)

    def _segment(self, level: int, x: torch.Tensor):
        """(h, prediction, confidence) of one segment and its head."""
        h, emb = self._trunk(level, x)
        return (h,) + self._head(emb, level)

    def _images(self, images) -> torch.Tensor:
        if isinstance(images, torch.Tensor):
            return images.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(images, np.float32)).to(self.device)

    def level_embeddings(self, images) -> List[np.ndarray]:
        """Per-level pooled embeddings of the whole batch, no exits (sequential_inference.py:823-886)."""
        carry = self._images(images)
        out: List[np.ndarray] = []
        for level in range(self.num_levels):
            carry, emb = self._trunk(level, carry)
            emb = _unit_rows(emb) if self.l2_normalize else emb.to(torch.float32)
            out.append(emb.cpu().numpy())
        return out

    # calibration

    @torch.no_grad()
    def calibrate(self, images, quantile: float = 0.5, tune: Optional[bool] = None) -> List[float]:
        """Survivor fractions and (linear, or ``tune``) thresholds at the ``quantile`` of live confidences
        (sequential_inference.py:609-631)."""
        if tune is None:
            tune = self.head_mode == "linear"
        carry = self._images(images)
        alive = np.ones(carry.shape[0], dtype=bool)
        thresholds: List[float] = []
        fractions: List[float] = []
        for level in range(self.num_levels - 1):
            carry, _, conf = self._segment(level, carry)
            conf = conf.cpu().numpy()
            if tune:
                t = float(np.quantile(conf[alive], quantile)) if alive.any() else 0.0
            else:
                t = float(self.thresholds[level])
            alive = alive & ~(conf > t)
            thresholds.append(t)
            fractions.append(float(alive.mean()))
        self.thresholds = thresholds
        self.survivor_fractions = fractions
        return thresholds

    def capacities_for(self, batch: int, slack: float = 1.3, multiple: int = 64) -> Tuple[int, ...]:
        """Per-level capacities ``roundup(batch * frac * slack)``; level 0 the whole batch."""
        if self.survivor_fractions is None:
            raise RuntimeError("call calibrate() first")
        caps = [batch]
        for frac in self.survivor_fractions:
            c = _round_up(max(1, math.ceil(batch * frac * slack)), min(multiple, batch))
            caps.append(min(batch, c))
        return tuple(caps)

    # fused cascade: no host sync until the one fetch

    def _build_fused(self, batch: int, caps: Tuple[int, ...]):
        thresholds = [float(t) for t in self.thresholds]
        num_levels = self.num_levels
        dev = self.device

        @torch.no_grad()
        def fused(images: torch.Tensor) -> torch.Tensor:
            preds = torch.zeros(batch, dtype=torch.int64, device=dev)
            exit_level = torch.zeros(batch, dtype=torch.int64, device=dev)
            done = torch.zeros(batch, dtype=torch.bool, device=dev)
            gidx = torch.arange(batch, device=dev)
            forced = torch.zeros((), dtype=torch.int64, device=dev)
            carry = images
            for level in range(num_levels):
                h, lp, conf = self._segment(level, carry)
                live = ~done[gidx]  # rows of images already out never write
                last = level == num_levels - 1
                fire = live if last else (conf > thresholds[level]) & live
                # a provisional answer for every live row; survivors are
                # overwritten at the level they leave
                preds.index_copy_(0, gidx, torch.where(live, lp, preds[gidx]))
                exit_level.index_copy_(0, gidx, torch.where(live, level, exit_level[gidx]))
                done.index_copy_(0, gidx, done[gidx] | fire)
                if last:
                    break
                surv = live & ~fire
                c_next = min(caps[level + 1], int(gidx.shape[0]))
                # least confident survivors first; the overflow (nearest its
                # threshold) force-exits at this level
                order = torch.argsort(torch.where(surv, conf, math.inf), stable=True)[:c_next]
                forced = forced + torch.clamp_min(surv.sum() - c_next, 0)
                gidx = gidx[order]
                carry = h.index_select(0, order)
            # one fetch per batch: [preds | exit_level | forced]
            return torch.cat([preds, exit_level, forced[None]])

        return fused

    def fused_fn(self, batch: int, capacities: Optional[Sequence[int]] = None, slack: float = 1.3):
        """The cached fused cascade ``fn(images) -> [preds | levels | forced]``, thresholds baked in."""
        caps = tuple(capacities) if capacities is not None else self.capacities_for(batch, slack=slack)
        key = (batch, caps, tuple(float(t) for t in self.thresholds))
        if key not in self._fused_fns:
            self._fused_fns[key] = self._build_fused(batch, caps)
        return self._fused_fns[key]

    def predict_fused(self, images, capacities: Optional[Sequence[int]] = None, slack: float = 1.3) -> PipelineResult:
        """The whole cascade, no host sync before its one fetch."""
        x = self._images(images)
        b = int(x.shape[0])
        fn = self.fused_fn(b, capacities, slack)
        t0 = time.perf_counter()
        packed = fn(x).cpu().numpy()  # the one fetch
        elapsed = time.perf_counter() - t0
        preds, exit_level = packed[:b], packed[b : 2 * b]
        return PipelineResult(predictions=preds.astype(np.int64), exit_level=exit_level.astype(np.int64),
            break_counts=np.bincount(exit_level, minlength=self.num_levels) / b, ms_per_image=1000.0 * elapsed / b,
            forced_fraction=int(packed[2 * b]) / b)

    # level-major pooled cascade

    @torch.no_grad()
    def predict_pooled(self, images, bucket: int = 1024, warmup: bool = False, streams: int = 1) -> PipelineResult:
        """Level-major over a pool in ``bucket`` slices, ``predict``'s decisions, one fetch a level. ``streams``:
        sub-pools as an event loop, each on its own CUDA stream, fetching to pinned memory behind an event."""
        x = self._images(images)
        n = int(x.shape[0])
        preds = np.zeros(n, dtype=np.int64)
        exit_level = np.full(n, self.num_levels - 1, dtype=np.int64)
        if warmup:
            self.predict_pooled(x, bucket=bucket, streams=streams)
        streams = max(1, min(int(streams), max(1, n // bucket)))
        bounds = [n * s // streams for s in range(streams + 1)]
        side = x.device.type == "cuda" and streams > 1
        states = [dict(alive=np.arange(bounds[s], bounds[s + 1]), carry=x[bounds[s] : bounds[s + 1]], level=0,
                stream=torch.cuda.Stream(x.device) if side else None) for s in range(streams)]
        for st in states if side else []:  # x was made on the current stream
            st["stream"].wait_stream(torch.cuda.current_stream(x.device))

        def on(st):
            return torch.cuda.stream(st["stream"]) if side else contextlib.nullcontext()

        def dispatch(st):
            with on(st):
                carry = st["carry"]
                n_pad = _round_up(max(len(st["alive"]), 1), bucket)
                if carry.shape[0] != n_pad:
                    carry = torch.cat([carry, carry.new_zeros((n_pad - carry.shape[0],) + tuple(carry.shape[1:]))])
                hs, rows = [], []
                for s in range(0, n_pad, bucket):
                    h, lp, cf = self._segment(st["level"], carry[s : s + bucket])
                    hs.append(h)
                    rows.append(torch.stack([lp.to(torch.float32), cf]))
                st["hs"], packed = hs, torch.cat(rows, dim=1)
                if side:
                    st["packed"] = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
                    st["packed"].copy_(packed, non_blocking=True)
                    st["fetched"] = torch.cuda.Event()
                    st["fetched"].record(st["stream"])
                else:
                    st["packed"] = packed

        t0 = time.perf_counter()
        active = [st for st in states if len(st["alive"])]
        for st in active:
            dispatch(st)
        while active:
            for st in list(active):
                if side:
                    st.pop("fetched").synchronize()
                packed = st.pop("packed").cpu().numpy()
                alive, level, hs = st["alive"], st["level"], st.pop("hs")
                final = level == self.num_levels - 1
                fire = np.ones(len(alive), dtype=bool) if final else packed[1, : len(alive)] > self.thresholds[level]
                preds[alive[fire]] = packed[0, : len(alive)].astype(np.int64)[fire]
                exit_level[alive[fire]] = level
                keep = np.nonzero(~fire)[0]
                st["alive"] = alive[keep]
                if final or not len(keep):
                    active.remove(st)
                    continue
                with on(st):
                    h_all = hs[0] if len(hs) == 1 else torch.cat(hs)
                    st["carry"] = h_all.index_select(0, torch.as_tensor(keep).to(h_all.device))
                st["level"] = level + 1
                dispatch(st)  # queued before the next stream's fetch
        elapsed = time.perf_counter() - t0
        return PipelineResult(predictions=preds, exit_level=exit_level,
            break_counts=np.bincount(exit_level, minlength=self.num_levels) / n, ms_per_image=1000.0 * elapsed / n)

    # host-compaction cascade

    @torch.no_grad()
    def predict(self, images, warmup: bool = False) -> PipelineResult:
        """The host decides the exits after each segment; survivors gathered on the device."""
        x = self._images(images)
        if warmup:
            self.predict(x)
        b = int(x.shape[0])
        preds = np.zeros(b, dtype=np.int64)
        exit_level = np.full(b, self.num_levels - 1, dtype=np.int64)
        t0 = time.perf_counter()
        max_b = self.buckets[-1]
        for s in range(0, b, max_b):
            gidx = np.arange(s, min(s + max_b, b))
            carry = x[s : s + max_b]
            bucket = _bucket(len(gidx), self.buckets)
            if carry.shape[0] < bucket:
                pad = torch.zeros((bucket - carry.shape[0],) + tuple(carry.shape[1:]), dtype=carry.dtype,
                        device=carry.device)
                carry = torch.cat([carry, pad])
            for level in range(self.num_levels):
                h, lp, cf = self._segment(level, carry)
                level_pred = lp.cpu().numpy()[: len(gidx)]
                conf = cf.cpu().numpy()[: len(gidx)]
                last = level == self.num_levels - 1
                fire = np.ones(len(gidx), dtype=bool) if last else conf > self.thresholds[level]
                preds[gidx[fire]] = level_pred[fire]
                exit_level[gidx[fire]] = level
                keep = ~fire
                if last or not keep.any():
                    break
                keep_idx = np.nonzero(keep)[0]
                gidx = gidx[keep]
                take = np.zeros(_bucket(len(keep_idx), self.buckets), np.int64)
                take[: len(keep_idx)] = keep_idx
                carry = h.index_select(0, torch.from_numpy(take).to(h.device))
        elapsed = time.perf_counter() - t0
        return PipelineResult(predictions=preds, exit_level=exit_level,
            break_counts=np.bincount(exit_level, minlength=self.num_levels) / b, ms_per_image=1000.0 * elapsed / b)

    @torch.no_grad()
    def measure_segment_latency(self, images, iters: int = 5) -> Tuple[np.ndarray, np.ndarray]:
        """Per-level and cumulative ms an image of the chained segments."""
        x = self._images(images)
        n = int(x.shape[0])
        bucket = _bucket(n, self.buckets)
        if n < bucket:
            x = torch.cat([x, torch.zeros((bucket - n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)])
        per_level = []
        carry = x
        for level in range(self.num_levels):
            h, pred, _ = self._segment(level, carry)  # warm
            pred.cpu()
            t0 = time.perf_counter()
            for _ in range(iters):
                out = self._segment(level, carry)
            out[1].cpu()
            per_level.append(1000.0 * (time.perf_counter() - t0) / (iters * n))
            carry = h
        per_level = np.asarray(per_level)
        return per_level, np.cumsum(per_level)
