"""Spans, counters and device timing (JAX ``utils/profiling.py``): CUDA events
and ``torch.profiler`` in place of ``jax.profiler``."""

import contextlib
import dataclasses
import os
import time
import types
from collections import defaultdict

import numpy as np
import torch


@dataclasses.dataclass
class Counters:
    """The ann.h:29-30 counters, batched."""

    distance_calcs: int = 0
    probes: int = 0
    gallery_size: int = 0
    unreliable: int = 0

    def add_checked(self, checked_counts) -> None:
        self.distance_calcs += int(np.sum(checked_counts))
        self.probes += len(checked_counts)

    @property
    def avg_checked_percent(self) -> float:
        if not self.probes or not self.gallery_size:
            return -1.0
        return 100.0 * self.distance_calcs / (self.probes * self.gallery_size)


def _device_of(out):
    if isinstance(out, torch.Tensor):
        return out.device
    items = list(out.values()) if isinstance(out, dict) else list(out) if isinstance(out, (list, tuple)) else []
    return next((d for d in map(_device_of, reversed(items)) if d is not None), None)


def host_sync(out=None) -> None:
    """Waits for the card ``out`` lives on (no ``out``: the current card, if CUDA is in use)."""
    dev = _device_of(out)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elif dev is None and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Named host-clock spans, fenced at their end by ``host_sync(span.result)``."""

    def __init__(self):
        self.totals, self.counts = defaultdict(float), defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = True):
        holder, t0 = types.SimpleNamespace(result=None), time.perf_counter()
        yield holder
        if sync:
            host_sync(holder.result)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        return "\n".join(f"{k}: total={self.totals[k] * 1e3:.2f}ms n={self.counts[k]} "
                f"avg={self.totals[k] * 1e3 / self.counts[k]:.3f}ms" for k in sorted(self.totals))


def timed(fn, reps: int = 5):
    """(last output, host ms a call) of ``reps`` calls between two syncs."""
    host_sync()
    t = time.perf_counter()
    for _ in range(reps):
        out = fn()
    host_sync(out)
    return out, (time.perf_counter() - t) / reps * 1e3


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls after a warm-up, between two CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_jitted(fn, *args, iters: int = 10) -> dict:
    """``compile_s``: the first call (build, warm-up), fenced; ``steady_s``: a
    call of ``iters`` queued between two syncs (CUDA events on the card)."""
    t0 = time.perf_counter()
    out = fn(*args)
    host_sync(out)
    compile_s, dev = time.perf_counter() - t0, _device_of(out)
    if dev is not None and dev.type == "cuda":
        with torch.cuda.device(dev):
            return {"compile_s": compile_s, "steady_s": cuda_ms(lambda: fn(*args), iters) / 1e3}
    return {"compile_s": compile_s, "steady_s": timed(lambda: fn(*args), iters)[1] / 1e3}


@contextlib.contextmanager
def device_trace(log_dir=None):
    """``torch.profiler`` (CUDA too) over the block, fenced; a Chrome trace in ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * torch.cuda.is_available()) as prof:
        yield prof
        host_sync()
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def trace_call(fn):
    """One call after a warm-up, traced: busy and window ms, idle share, ms by
    kernel; None without device activity."""
    host_sync(fn())
    with device_trace() as prof:
        fn()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None
    start, end = min(e.time_range.start for e in dev), max(e.time_range.end for e in dev)
    by_name = defaultdict(float)
    for e in dev:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    return dict(window_ms=(end - start) / 1e3, busy_ms=busy, idle_share=1.0 - busy * 1e3 / max(end - start, 1e-9),
            events=len(dev), by_name=dict(by_name))
