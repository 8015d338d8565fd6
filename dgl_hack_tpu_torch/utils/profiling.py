"""Profiling and timing helpers, as ``dgl_hack_tpu.utils.profiling``:
a timing context that waits for the card, the chained-iteration timer
that cancels launch and readback latency, and a ``torch.profiler``
trace context.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


def _cuda_devices(result):
    """The CUDA devices of the tensors in a nested result."""
    if isinstance(result, torch.Tensor):
        return {result.device} if result.is_cuda else set()
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        return set().union(*(_cuda_devices(r) for r in result))
    return set()


class Timer:
    """Accumulating wall timer; waits for the card where ``result`` holds
    CUDA tensors."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    @contextlib.contextmanager
    def time(self, result=None):
        t0 = time.perf_counter()
        yield
        for dev in _cuda_devices(result):
            torch.cuda.synchronize(dev)
        self.total += time.perf_counter() - t0
        self.count += 1

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


def timed_loop(fn: Callable, example: torch.Tensor, k_lo: int = 2,
               k_hi: int = 6, repeats: int = 2) -> float:
    """Seconds per iteration of ``fn``, from the chain ``h = fn(h) *
    0.9999`` run at two lengths: launch and readback latency cancel in the
    difference.  On the card each run is timed by CUDA events; on the CPU
    by the host clock, ending in a read of one element."""
    cuda = example.is_cuda

    def loop(iters):
        h = example
        for _ in range(iters):
            h = fn(h) * 0.9999
        return h

    def once(k) -> float:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loop(k)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        float(loop(k).reshape(-1)[0])
        return time.perf_counter() - t0

    def measure(k):
        once(k)                                   # warm-up
        return min(once(k) for _ in range(repeats))

    return (measure(k_hi) - measure(k_lo)) / (k_hi - k_lo)


@contextlib.contextmanager
def trace(dirname: str = "torch-trace"):
    """torch.profiler over the block (the card's kernels too where there
    is one); writes a Chrome trace, ``trace.json``, into ``dirname`` and
    yields the profiler (``key_averages()`` ...)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(dirname, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(dirname, "trace.json"))
