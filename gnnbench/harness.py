"""Run one cell once: set-up, the timed (or traced) window, the check
against the plain reference, the metrics.

Set-up (``prepare``) loads the port's kernel library (building it with
nvcc in a checkout's first run, timed apart as ``kernels_s``), generates
the cell's graph, features, labels and training mask on the device from
the seed, builds the graph through the
port's ``graph`` and ``prepare_spmm``, builds the configuration's model
and takes ``node_classifier_step``'s ``train_step``, loads the weights
drawn from the seed, and drives that same step object through its first
``CHECK_STEPS`` steps, which warm up every shape the window runs and are
what the check compares: step 1's logits (a forward hook, removed
after), each loss, step 1's gradients and the parameters after the last.
The window then calls ``train_step()`` back to back for the given
seconds with no synchronisation inside, and one at the end.  After the
window the program is freed and the reference follows the same steps.
"""
from __future__ import annotations

import gc
import math
import statistics
import subprocess
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from gnnbench import compare, inputs, plugins, reference
from gnnbench.trace import STEP, WINDOW, Trace

CHECK_STEPS = 3
# steps of the traced run's host probe, each from an idle card
PROBE_STEPS = 8
# the traced window: at most these seconds and steps
TRACE_SECONDS = 3.0
TRACE_MAX_STEPS = 400
PEAKS = plugins.load_json(".", "peaks")


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclass
class Prepared:
    """A cell after set-up: its inputs, the program's step object and
    what its first steps gave."""
    cell: plugins.Cell
    dev: torch.device
    data: inputs.GraphData
    params0: Dict[str, torch.Tensor]
    dropout_seed: int
    prog: reference.Run
    step_s: float                       # host time of the last check step
    setup: Dict[str, float] = field(default_factory=dict)
    program: Dict[str, Any] = field(default_factory=dict)

    @property
    def shape(self) -> dict:
        d = self.data
        return {"num_nodes": d.num_nodes, "num_edges": d.num_edges,
                "in_feats": d.in_feats, "num_classes": d.num_classes}


def load_weights(model: torch.nn.Module,
                 weights: Dict[str, torch.Tensor]) -> None:
    named = dict(model.named_parameters())
    shapes = {k: tuple(v.shape) for k, v in named.items()}
    want = {k: tuple(v.shape) for k, v in weights.items()}
    if shapes != want:
        raise ValueError(f"the model's parameters {shapes} are not the "
                         f"reference's {want}")
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(weights[k])


def prepare(cell: plugins.Cell, seed: int, dev: torch.device,
            t0: float) -> Prepared:
    import dgl_hack_tpu_torch as dt
    from dgl_hack_tpu_torch.models.training import node_classifier_step
    from dgl_hack_tpu_torch.ops.cuda import build
    cfg = cell.config
    setup: Dict[str, float] = {"imports_s": time.perf_counter() - t0}
    if dev.type == "cuda":
        # the kernel library: built by nvcc in a checkout's first run
        # (into build/ inside the checkout), loaded from there after
        t = time.perf_counter()
        build.library()
        setup["kernels_s"] = time.perf_counter() - t
        setup["kernels_built"] = float("ptxas" in build.BUILD_INFO)
    t = time.perf_counter()
    gen = plugins.load_module("graphs", cell.traffic["generator"])
    data = gen.generate(cell.traffic, seed, dev)
    src = data.src.to("cpu", torch.int32).numpy()
    dst = data.dst.to("cpu", torch.int32).numpy()
    setup["generate_s"] = time.perf_counter() - t
    t = time.perf_counter()
    g = dt.graph((src, dst), num_nodes=data.num_nodes)
    setup["graph_build_s"] = time.perf_counter() - t
    del src, dst
    t = time.perf_counter()
    g = dt.prepare_spmm(g, device=dev)
    sync(dev)
    setup["prepare_s"] = time.perf_counter() - t

    t = time.perf_counter()
    ref = plugins.load_module("configs", cell.config_name)
    params0 = inputs.make_weights(
        ref.param_specs(cfg, data.in_feats, data.num_classes), seed, dev)
    model = plugins.load_module("models", cell.config_name).build(
        cfg, data.num_classes)
    dropout_seed = inputs.subseed(seed, "dropout")
    train_step, _ = node_classifier_step(
        model, g, data.x, data.labels, data.train_mask, lr=cfg["lr"],
        weight_decay=cfg["weight_decay"], seed=dropout_seed, device=dev)
    load_weights(model, params0)
    sync(dev)
    setup["model_s"] = time.perf_counter() - t
    t = time.perf_counter()

    captured: List[torch.Tensor] = []
    hook = model.register_forward_hook(
        lambda m, args, out: captured.append(out.detach().clone()))
    losses = [train_step()]
    hook.remove()
    grads1 = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    sync(dev)
    setup["first_step_s"] = time.perf_counter() - t
    step_s = 0.0
    for _ in range(CHECK_STEPS - 1):
        t = time.perf_counter()
        losses.append(train_step())
        sync(dev)
        step_s = time.perf_counter() - t
    prog = reference.Run(
        logits1=captured[0], losses=[float(v) for v in losses],
        grads1=grads1,
        params={k: p.detach().clone() for k, p in model.named_parameters()})
    sync(dev)
    setup["setup_s"] = time.perf_counter() - t0
    if dev.type == "cuda":
        setup["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return Prepared(cell, dev, data, params0, dropout_seed, prog, step_s,
                    setup, {"train_step": train_step, "model": model,
                            "graph": g})


@dataclass
class Window:
    steps: int
    wall_s: float
    step_ms: List[float]                # each step's duration
    failed: int                         # steps whose loss is not finite
    host_ms: List[float] = field(default_factory=list)   # between returns


def timed_window(p: Prepared, seconds: float) -> Window:
    """``train_step()`` back to back for ``seconds``, a CUDA event
    recorded between steps, one synchronize at the end."""
    train_step, dev = p.program["train_step"], p.dev
    cuda = dev.type == "cuda"
    n_ev = int(2 * seconds / max(p.step_s, 1e-4)) + 64
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(n_ev)] if cuda else []
    losses = []
    gc_before = [g["collections"] for g in gc.get_stats()]
    sync(dev)
    start = time.perf_counter()
    if cuda:
        events[0].record()
    marks = [start]                     # each call's return, host clock
    n = 0
    while True:
        losses.append(train_step())
        n += 1
        if cuda:
            if n >= len(events):
                events.append(torch.cuda.Event(enable_timing=True))
            events[n].record()
        marks.append(time.perf_counter())
        if marks[-1] - start >= seconds:
            break
    sync(dev)
    wall = time.perf_counter() - start
    host_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(n)] \
        if cuda else host_ms
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    p.setup["window_gc"] = [g["collections"] - b for g, b in
                            zip(gc.get_stats(), gc_before)]
    return Window(n, wall, step_ms, failed, host_ms)


def traced_window(p: Prepared, seconds: float):
    """The host probe, then ``train_step()`` back to back under
    torch.profiler for at most ``TRACE_SECONDS`` and ``TRACE_MAX_STEPS``,
    inside the ``WINDOW`` span.  Returns (Window, Trace, host probe
    seconds)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    train_step, dev = p.program["train_step"], p.dev
    probe = []
    for _ in range(PROBE_STEPS):
        sync(dev)
        t = time.perf_counter()
        train_step()
        probe.append(time.perf_counter() - t)
    sync(dev)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    limit = min(seconds, TRACE_SECONDS)
    losses = []
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            start = time.perf_counter()
            n = 0
            while True:
                with record_function(STEP):
                    losses.append(train_step())
                n += 1
                if (time.perf_counter() - start >= limit
                        or n >= TRACE_MAX_STEPS):
                    break
            sync(dev)
            wall = time.perf_counter() - start
    tr = Trace(prof.events())
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    return Window(n, wall, [], failed), tr, probe


def free_program(p: Prepared) -> None:
    p.program.clear()
    gc.collect()
    if p.dev.type == "cuda":
        torch.cuda.empty_cache()


def reference_run(p: Prepared, precision: str = "float32",
                  fault: Optional[str] = None) -> reference.Run:
    """The reference's first steps from the cell's inputs and weights, in
    float32 (TF32 off) or, for the control, TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = plugins.load_module("configs", p.cell.config_name)
    return reference.train(ref.forward, p.cell.config, p.params0, p.data,
                           p.dropout_seed, steps=CHECK_STEPS,
                           matmul=reference.Matmul(precision), fault=fault)


@dataclass
class Context:
    """What a metric's reader reads (``metrics/<name>.py``)."""
    cell: plugins.Cell
    shape: dict
    setup: Dict[str, float]
    window: Window
    peak_bytes: int
    trace: Optional[Trace] = None
    host_issue_s: List[float] = field(default_factory=list)

    @property
    def steps(self) -> int:
        return self.window.steps

    def least_ms(self, part: str) -> Optional[float]:
        """The least time in ms of a step's ``part`` by the count
        (``counts/<config>.py``): each call's bytes at the HBM rate or its
        operations at the float32 rate, whichever binds, summed."""
        counts = plugins.load_module("counts", self.cell.config_name).step(
            self.cell.config, self.shape)
        if part not in counts:
            return None
        return 1e3 * sum(max(b / PEAKS["hbm_bytes_per_s"],
                             o / PEAKS["fp32_ops_per_s"])
                         for o, b in counts[part])


def read_metrics(entries: List[dict], ctx: Context) -> Dict[str, dict]:
    out = {}
    for m in entries:
        value = plugins.load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def power_limit() -> Optional[str]:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 \
        and res.stdout.strip() else None


def run_cell(cell: plugins.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t0: Optional[float] = None):
    """One run of ``cell``; returns (result line as a dict, check lines).
    The result's ``checks`` come last."""
    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    settings = {
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision()}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    p = prepare(cell, seed, dev, t0)
    probe: List[float] = []
    tr = None
    if trace:
        win, tr, probe = traced_window(p, seconds)
    else:
        win = timed_window(p, seconds)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    alloc = {}
    if dev.type == "cuda":               # the allocator over set-up and window
        st = torch.cuda.memory_stats(dev)
        alloc = {k: st.get(k) for k in ("num_alloc_retries",
                                        "num_device_alloc",
                                        "reserved_bytes.all.peak")}
    free_program(p)
    ctx = Context(cell, p.shape, p.setup, win, peak, tr, probe)
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, ctx)
    ref = reference_run(p)
    numbers = compare.readings(p.prog, ref, p.params0)
    correct, checks = compare.judge(numbers, cell.limits)
    device_info: Dict[str, Any] = {"platform": "cpu", "kind": "cpu",
                                   "count": 1, "memory_peak_bytes": peak}
    if dev.type == "cuda":
        device_info.update(platform="gpu",
                           kind=torch.cuda.get_device_name(dev),
                           count=cell.chips, power=power_limit())
    if tr is not None:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
    if alloc:
        device_info["allocator"] = alloc
    result: Dict[str, Any] = {
        "correct": bool(correct and win.failed == 0),
        "attempted": win.steps, "failed": win.failed,
        "metrics": metrics, "device": device_info}
    if tr is not None:
        result["breakdown"] = tr.breakdown()
        result["trace"] = tr.summary()
    else:
        result["window"] = window_summary(win)
    result["settings"] = settings
    result["setup"] = p.setup
    result["shape"] = p.shape
    result["checks"] = checks
    lines = [f"check {k} {_num(v['value'])} limit {_num(v['limit'])}"
             for k, v in checks.items()]
    return result, lines


def window_summary(win: Window) -> dict:
    """The window's wall time against its steps' durations, and its
    slowest steps (index, ms): where a step stalls."""
    def slowest(d):
        return [[i, d[i]] for i in sorted(range(len(d)),
                                          key=lambda i: -d[i])[:5]]
    d = win.step_ms
    return {"wall_s": win.wall_s, "steps_ms_sum": sum(d),
            "median_ms": statistics.median(d) if d else None,
            "slowest": slowest(d), "host_slowest": slowest(win.host_ms)}


def _num(v) -> str:
    return "none" if v is None else repr(float(v))


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]
