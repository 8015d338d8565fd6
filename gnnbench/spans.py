"""Device time by the program's own spans.

The port opens spans (``dgl_hack_tpu_torch/utils/profiling.py``,
``SPANS``) as ``record_function`` ranges while a profiler runs.  This
reading charges each device operation of the traced window to the spans
around the op that launched it:

* the launch is the host's CUDA API call (``cudaLaunchKernel``,
  ``cudaMemcpyAsync`` ...) whose id is the device operation's own: both
  are CUPTI's correlation id, and torch puts the call inside the op that
  was innermost when it ran (a span itself, where a span launches a
  kernel through ``ctypes``);
* its path is the program spans around that call, outermost first;
* in the backward (the op runs inside an
  ``autograd::engine::evaluate_function`` event) the path is that of the
  forward op that made the autograd node, then the spans inside the
  event.  The forward op has the event's ``sequence_nr`` on its
  ``fwd_thread``; of several, the last to start (an op that makes no node
  records the number it peeks).  Where none has, the spans around the
  event stand in;
* times are clipped to the window as ``trace.Trace`` clips its kernels,
  over the same device operations, so the charges and what is left
  unattributed (no launch found, or no span around it) add up to the
  window's device time.

Idle gaps are put down the same way: to the path of the innermost host
op, on any thread, that runs at the gap's midpoint.

    python3 gnnbench/spans.py --workload gat.reddit --seed 7

runs a cell once with ``--trace 1`` as ``run.py`` does and prints one JSON
line: the result's per-layer metrics and device, the device ms a step by
innermost span (forward and backward apart), the readings of
``SpanBooks.readings`` and the idle gaps by span.  The CLI stands in
until the harness keeps a traced window's events for the metrics to
read; then ``SpanBooks`` takes its device-op filter, clipping and idle
attribution from ``trace.Trace`` instead of the copies here, and the CLI
and its ``harness.Trace`` swap go.
"""
from __future__ import annotations

import bisect
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import (Callable, Dict, Iterable,  # noqa: E402
                    NamedTuple, Optional, Tuple)

if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parents[1]
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

from gnnbench.trace import (STEP, WINDOW, Trace, _merge,  # noqa: E402
                            family_of)

BACKWARD = "autograd::engine::evaluate_function"


class Charge(NamedTuple):
    """Where device time went: the program spans around the launching op
    (outermost first; empty: unattributed), whether it ran in the
    backward, and the kernel's family (``trace.family_of``)."""
    path: Tuple[str, ...]
    backward: bool
    family: str


def program_spans() -> frozenset:
    """The names of the port's spans, or none where the port has no
    ``SPANS`` (then every charge is unattributed)."""
    try:
        from dgl_hack_tpu_torch.utils.profiling import SPANS
    except ImportError:
        return frozenset()
    return frozenset(SPANS)


class SpanBooks:
    """Device milliseconds of the ``WINDOW`` span by ``Charge``, and idle
    seconds by (path, backward) of the host op at each gap's midpoint."""

    def __init__(self, events, names: Optional[Iterable[str]] = None):
        from torch.autograd import DeviceType
        self.names = program_spans() if names is None else frozenset(names)
        cpu = [e for e in events if e.device_type == DeviceType.CPU
               and not e.is_async]
        host = {e.name for e in events if e.device_type == DeviceType.CPU}
        # the device operations of trace.Trace: kernels, copies and sets,
        # without the spans' copies on the device timeline
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not (e.name in host and e.name.startswith("gnnbench."))]
        win = [e for e in cpu if e.name == WINDOW]
        if not win:
            raise RuntimeError(f"the trace holds no {WINDOW!r} span")
        w0, w1 = win[0].time_range.start, win[0].time_range.end
        self.window = (w0, w1)
        # CUDA API calls (cudaLaunchKernel, cuLaunchKernel ...) by
        # CUPTI's correlation id
        launches = {e.id: e for e in cpu if e.name.startswith("cu")}
        self._memo: Dict[int, Tuple[Tuple[str, ...], bool]] = {}
        self._forward = self._forward_ops(cpu)
        self.charges: Dict[Charge, float] = defaultdict(float)
        busy = []
        for d in dev:
            s, e = max(d.time_range.start, w0), min(d.time_range.end, w1)
            if e <= s:
                continue
            busy.append((s, e))
            call = launches.get(d.id)
            path, bwd = self.path_of(call) if call is not None \
                else ((), False)
            self.charges[Charge(path, bwd, family_of(d.name))] += \
                (e - s) * 1e-3
        self.window_ms = sum(self.charges.values())
        self.idle = self._idle(busy, cpu)

    def _under_backward(self, op) -> bool:
        up = op
        while up is not None:
            if up.name.startswith(BACKWARD):
                return True
            up = up.cpu_parent
        return False

    def _forward_ops(self, cpu) -> dict:
        """(sequence_nr, thread) -> the last forward op to start with it."""
        out = {}
        for e in sorted(cpu, key=lambda e: e.time_range.start):
            if getattr(e, "sequence_nr", -1) >= 0 \
                    and not e.name.startswith("autograd::") \
                    and not self._under_backward(e):
                out[(e.sequence_nr, e.thread)] = e
        return out

    def path_of(self, op) -> Tuple[Tuple[str, ...], bool]:
        """(path, backward) of the host op ``op``: the program spans
        around it, outermost first, with the backward mapped to the
        forward op that made its autograd node."""
        key = id(op)
        if key in self._memo:
            return self._memo[key]
        inner = []
        up, out = op, None
        while up is not None:
            if up.name.startswith(BACKWARD):
                fwd = self._forward.get((getattr(up, "sequence_nr", -1),
                                         getattr(up, "fwd_thread", None)))
                prefix = self.path_of(fwd)[0] if fwd is not None \
                    else self.path_of(up.cpu_parent)[0] \
                    if up.cpu_parent is not None else ()
                out = (prefix + tuple(reversed(inner)), True)
                break
            if up.name in self.names:
                inner.append(up.name)
            up = up.cpu_parent
        if out is None:
            out = (tuple(reversed(inner)), False)
        self._memo[key] = out
        return out

    def _idle(self, busy, cpu) -> Dict[Tuple[Tuple[str, ...], bool], float]:
        ops = sorted(((e.time_range.start, e.time_range.end, e)
                      for e in cpu if e.name not in (WINDOW, STEP)),
                     key=lambda t: t[0])
        starts = [o[0] for o in ops]
        edges = [self.window[0]] + [t for s, e in _merge(busy)
                                    for t in (s, e)] \
            + [self.window[1]]
        idle: Dict[Tuple[Tuple[str, ...], bool], float] = defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            where = ((), False)
            i = bisect.bisect_right(starts, mid) - 1
            # the innermost op covering mid starts last among those that do
            for j in range(i, max(i - 4096, -1), -1):
                if ops[j][1] >= mid:
                    where = self.path_of(ops[j][2])
                    break
            idle[where] += (b - a) * 1e-6
        return dict(idle)

    def ms(self, where: Optional[Callable[[Charge], bool]] = None) -> float:
        """Device ms of the charges ``where`` takes (all without it)."""
        return sum(v for c, v in self.charges.items()
                   if where is None or where(c))

    def by_innermost(self, families: bool = False) -> Dict[str, float]:
        """Device ms by innermost span, ``<name> bwd`` for the backward's,
        ``(unattributed)`` for none; with ``families``, by span and
        kernel family, ``<name>[ bwd] <family>``."""
        out: Dict[str, float] = defaultdict(float)
        for c, v in self.charges.items():
            name = c.path[-1] if c.path else "(unattributed)"
            name += " bwd" if c.backward and c.path else ""
            out[name + (f" {c.family}" if families else "")] += v
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def idle_by_innermost(self) -> Dict[str, float]:
        """Idle seconds by innermost span, named as ``by_innermost``."""
        out: Dict[str, float] = defaultdict(float)
        for (path, bwd), v in self.idle.items():
            name = path[-1] if path else "(no span)"
            out[name + (" bwd" if bwd and path else "")] += v
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def readings(self, steps: int) -> Dict[str, float]:
        """Device ms a step: ``nn.elementwise_ms`` (innermost span an nn
        layer's, not a dense product: dropout, el/er, the attention
        multiplier, activations), ``nn.gemm_ms`` (the dense products
        there), ``trainer.optimizer_ms``, ``kernel.gat_op_ms`` and
        ``kernel.gspmm_op_ms`` (under the op's span or its backward's,
        kernels and glue), ``step.unattributed_ms``, and ``window_ms``."""
        def nn(c):
            return bool(c.path) and c.path[-1].startswith("nn.")

        def under(*names):
            return lambda c: any(s in names for s in c.path)
        out = {
            "nn.elementwise_ms": self.ms(lambda c: nn(c)
                                         and c.family != "gemm"),
            "nn.gemm_ms": self.ms(lambda c: nn(c) and c.family == "gemm"),
            "trainer.optimizer_ms": self.ms(under("trainer.optimizer")),
            "kernel.gat_op_ms": self.ms(under("ops.gat_attention",
                                              "ops.gat_attention.bwd")),
            "kernel.gspmm_op_ms": self.ms(under("ops.gspmm",
                                                "ops.gspmm.bwd")),
            "step.unattributed_ms": self.ms(lambda c: not c.path),
            "window_ms": self.window_ms}
        return {k: v / steps for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch
    # run.py points torch's and triton's caches into the checkout
    from gnnbench import harness, plugins, run  # noqa: F401
    if not torch.cuda.is_available():
        print("no CUDA device: this reading runs on the card only",
              file=sys.stderr)
        return 2
    kept = {}

    class Keeping(Trace):
        def __init__(self, events):
            super().__init__(events)
            kept["books"] = SpanBooks(events)

    # traced_window builds its Trace by this name: keep the events' books
    harness.Trace = Keeping
    cell = plugins.cell(args.workload)
    result, _ = harness.run_cell(cell, args.seed, args.seconds, True,
                                 "cuda", T0)
    books, steps = kept["books"], result["attempted"]
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "correct": result["correct"], "steps": steps,
        "device": result["device"], "metrics": result["metrics"],
        "breakdown": result["breakdown"], "trace": result["trace"],
        "readings": books.readings(steps),
        "device_ms_by_span": {k: v / steps for k, v in
                              books.by_innermost(families=True).items()},
        "idle_s_by_span": books.idle_by_innermost(),
        "setup": result["setup"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
