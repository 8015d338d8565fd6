"""Read a ``torch.profiler`` trace of the timed window: device operations
by family, the window's busy and idle time, and what the host ran in
each idle gap.

The harness wraps the window in a span named ``WINDOW`` (its own,
``torch.profiler.record_function``); the trace's window is that span.
Kernel families are matched by name (``kernels.json``: the first family
with a pattern inside the lower-cased kernel name).  A dense product
(family ``gemm``) belongs to the dense-hub hybrid's count-matrix product
(``prepare_spmm``'s, part of gspmm) where the op that launched it runs
inside that product's backward (an autograd node whose name holds
``GspmmHybrid``) or, in the forward, outside any ``aten::linear`` and any
autograd node; every other dense product is an nn layer's.
"""
from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

WINDOW = "gnnbench.window"
STEP = "gnnbench.train_step"
FAMILIES = json.loads((Path(__file__).resolve().parent
                       / "kernels.json").read_text())["families"]


def family_of(name: str) -> str:
    low = name.lower()
    for fam, pats in FAMILIES.items():
        if any(p in low for p in pats):
            return fam
    return "other"


def short_name(name: str) -> str:
    """A kernel's name without ``void``, namespaces that say nothing,
    template arguments and parameters, at most 96 characters."""
    s = name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    base, _, args = s.split("(", 1)[0].partition("<")
    if base.endswith(("::Kernel", "::Kernel2")) and args:
        # cutlass's kernels are named by their first template argument
        base += "<" + re.split(r"[,>]", args, maxsplit=1)[0] + ">"
    return (base.strip() or name)[:96]


def gemm_role(ancestry: List[str]) -> str:
    """'hybrid' or 'nn' for a dense product launched under the ops
    ``ancestry`` (innermost first)."""
    if any("GspmmHybrid" in a for a in ancestry):
        return "hybrid"
    if any(a == "aten::linear" or a.startswith("autograd::")
           for a in ancestry):
        return "nn"
    return "hybrid" if ancestry else "nn"


@dataclass
class Kernel:
    name: str
    start: float          # microseconds, the trace's clock
    end: float
    family: str


def _merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class Trace:
    """The device operations of the window and the host ops around them.

    ``kernels``: each device operation (kernels, copies, sets) inside the
    window; ``busy_s``: the union of their times; ``window_s``: the
    window span's length; ``idle``: total idle seconds by the innermost
    host op that ran at each gap's midpoint."""

    def __init__(self, events):
        from torch.autograd import DeviceType
        cpu = [e for e in events if e.device_type == DeviceType.CPU
               and not e.is_async]
        # device operations; a span's copy on the device timeline (a user
        # annotation) covers its kernels and the gaps between them
        spans = {e.name for e in events if e.device_type == DeviceType.CPU}
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not (e.name in spans and e.name.startswith("gnnbench."))]
        win = [e for e in cpu if e.name == WINDOW]
        if not win:
            raise RuntimeError(f"the trace holds no {WINDOW!r} span")
        w0, w1 = win[0].time_range.start, win[0].time_range.end
        self.window = (w0, w1)
        self.window_s = (w1 - w0) * 1e-6
        self.kernels: List[Kernel] = []
        for d in dev:
            s, e = max(d.time_range.start, w0), min(d.time_range.end, w1)
            if e > s:
                self.kernels.append(Kernel(d.name, s, e, family_of(d.name)))
        # dense products by role, from the kernels each op launched
        self.role_ms: Dict[str, float] = defaultdict(float)
        for op in cpu:
            if not (w0 <= op.time_range.start < w1):
                continue
            gemms = [k for k in op.kernels if family_of(k.name) == "gemm"]
            if not gemms:
                continue
            anc, up = [], op
            while up is not None:
                anc.append(up.name)
                up = up.cpu_parent
            for k in gemms:
                self.role_ms[gemm_role(anc)] += k.duration * 1e-3
        busy = _merge([(k.start, k.end) for k in self.kernels])
        self.busy_s = sum(e - s for s, e in busy) * 1e-6
        self.idle = self._idle(busy, cpu)

    def _idle(self, busy, cpu) -> Dict[str, float]:
        ops = sorted(((e.time_range.start, e.time_range.end, e.name)
                      for e in cpu if e.name != WINDOW),
                     key=lambda t: t[0])
        starts = [o[0] for o in ops]
        edges = [self.window[0]] + [t for s, e in busy for t in (s, e)] \
            + [self.window[1]]
        idle: Dict[str, float] = defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            name = "(no host op)"
            i = bisect.bisect_right(starts, mid) - 1
            # the innermost op covering mid starts last among those that do
            for j in range(i, max(i - 4096, -1), -1):
                if ops[j][1] >= mid:
                    name = ops[j][2]
                    break
            idle[name] += (b - a) * 1e-6
        return dict(idle)

    def ms(self, family: str, role: Optional[str] = None) -> float:
        """Device milliseconds of a family in the window; of a dense
        product's ``role`` ('nn' or 'hybrid'), those that ops launched."""
        if role is not None:
            if family != "gemm":
                raise ValueError("only dense products have roles")
            return self.role_ms.get(role, 0.0)
        return sum(k.end - k.start for k in self.kernels
                   if k.family == family) * 1e-3

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (seconds in the
        window, by short name) and the idle time by host op."""
        ops: Dict[str, float] = defaultdict(float)
        for k in self.kernels:
            ops[short_name(k.name)] += (k.end - k.start) * 1e-6
        rank = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in rank],
                "idle_gaps": [[n, s] for n, s in gaps]}

    def summary(self) -> dict:
        """Device ms by family, and the dense products' by role (those
        that no op launched are in neither role), for the log."""
        fams: Dict[str, float] = defaultdict(float)
        for k in self.kernels:
            fams[k.family] += (k.end - k.start) * 1e-3
        return {"ms_by_family": dict(fams),
                "gemm_ms_by_role": dict(self.role_ms)}
