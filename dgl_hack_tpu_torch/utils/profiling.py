"""Profiling and timing helpers, as ``dgl_hack_tpu.utils.profiling``:
a timing context that waits for the card, the chained-iteration timer
that cancels launch and readback latency, and a ``torch.profiler``
trace context; and the port's own spans.

``span(name)`` marks where the program's work happens: the trainer's
phases, the nn layers, gspmm and the GAT edge phase, each call of K1, K2,
K3 and the hybrid's dense product, and the set-up (graph build,
``prepare_spmm``, plan builds, the kernel library's load).  ``SPANS``
names every span with its layer.  While a ``torch.profiler`` runs
(``trace()`` among others) a span is a ``record_function`` of that name,
so a trace shows the program's spans around its ops and kernels;
otherwise it is one shared no-op.  Cold spans (set-up, once per graph)
also add their host seconds and calls to ``TOTALS`` whether or not a
profiler runs.
"""
from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from typing import Callable, Dict, NamedTuple

import torch
from torch.autograd import profiler as _profiler


class Span(NamedTuple):
    """A span's layer, whether it is cold (set-up, once per graph: its
    host seconds go to ``TOTALS``) and what it covers."""
    layer: str
    cold: bool
    meaning: str


SPANS: Dict[str, Span] = {
    "trainer.forward": Span("trainer", False, "the model's forward in "
                            "node_classifier_step's train_step"),
    "trainer.loss": Span("trainer", False, "the masked cross-entropy"),
    "trainer.backward": Span("trainer", False, "loss.backward(), on the "
                             "calling thread"),
    "trainer.optimizer": Span("trainer", False, "zero_grad, and the "
                              "AdamW step"),
    "nn.GATConv": Span("nn layers", False, "GATConv.forward"),
    "nn.SAGEConv": Span("nn layers", False, "SAGEConv.forward"),
    "nn.dropout": Span("nn layers", False, "a feature dropout: the "
                       "uniform draw, the compare, the scale, the select"),
    "nn.GATConv.attn_drop": Span("nn layers", False, "GAT's (E, H) "
                                 "attention-dropout multiplier"),
    "ops.gspmm": Span("gspmm", False, "gspmm on any route"),
    "ops.gspmm.bwd": Span("gspmm", False, "the backward of GspmmSum and "
                          "GspmmHybrid"),
    "kernel.hybrid_mm": Span("gspmm", False, "the dense-hub hybrid's "
                             "count-matrix product, forward or backward"),
    "kernel.k1": Span("gspmm", False, "one K1 call (segment_sum; its "
                      "plain version on the CPU)"),
    "ops.gat_attention": Span("GAT edge phase", False, "gat_attention on "
                              "either route"),
    "ops.gat_attention.bwd": Span("GAT edge phase", False,
                                  "GatFused.backward: K3 and K1's der sum"),
    "kernel.k2": Span("GAT edge phase", False, "one K2 call (gat_fwd)"),
    "kernel.k3": Span("GAT edge phase", False, "one K3 call (gat_bwd)"),
    "graph.build": Span("graph build", True, "core/graph.py _build"),
    "graph.build.sort": Span("graph build", True, "one of _build's stable "
                             "argsorts"),
    "ops.prepare": Span("prepare", True, "prepare_spmm"),
    "ops.plans": Span("prepare", True, "a build of K1's row plans, the "
                      "CSR gather index, a real-edge view, a batch's row "
                      "segments, the hybrid's windows or K3's dst cuts, on "
                      "a cache miss in prepare_spmm or at first use"),
    "kernels.load": Span("kernels", True, "the kernel library's nvcc build "
                         "(a checkout's first run) and load"),
}


class Totals:
    """Host seconds and calls of each cold span, by name, since the
    process started or the last ``reset()``.  A cold span inside another
    of its own name counts once."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._open = threading.local()

    def reset(self) -> None:
        with self._lock:
            self.seconds.clear()
            self.calls.clear()

    @contextlib.contextmanager
    def timed(self, name: str):
        depth = getattr(self._open, name, 0)
        setattr(self._open, name, depth + 1)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            setattr(self._open, name, depth)
            if depth == 0:
                dt = time.perf_counter() - t0
                with self._lock:
                    self.seconds[name] = self.seconds.get(name, 0.0) + dt
                    self.calls[name] = self.calls.get(name, 0) + 1


TOTALS = Totals()

# what span() returns outside a trace: no state, reusable, re-entrant
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def _cold(name: str):
    traced = _profiler.record_function(name) \
        if _profiler._is_profiler_enabled else _OFF
    with TOTALS.timed(name), traced:
        yield


def span(name: str):
    """The span ``name`` of ``SPANS``, as a context manager: a
    ``record_function`` while a profiler runs, else one shared no-op (one
    read of the profiler's flag: no tensor, no sync, no allocation).  A
    cold span also times itself into ``TOTALS``.  A name not in
    ``SPANS`` raises ValueError."""
    s = SPANS.get(name)
    if s is None:
        raise ValueError(f"span {name!r} is not in utils.profiling.SPANS")
    if s.cold:
        return _cold(name)
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: run the function inside ``span(name)``."""
    span(name)                      # a name not in SPANS raises here

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


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
    yields the profiler (``key_averages()`` ...).  The trace holds the
    program's spans (``SPANS``) around the ops and kernels they launch;
    the set-up's host seconds are in ``TOTALS`` whether traced or not."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(dirname, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(dirname, "trace.json"))
