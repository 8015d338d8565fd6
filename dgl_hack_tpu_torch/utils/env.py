"""Environment configuration of the port.

  DGL_TPU_GAT_SOFTMAX  fused-GAT shift strategy: shift | exact.  'shift'
      (default) subtracts the upper bound leaky(max_u el[u] + er[v]);
      softmax is shift-invariant, so the result is exact unless the
      per-dst logit spread exceeds ~80 (exp underflow).  'exact' subtracts
      the exact per-dst max, taken in a first pass over the in-edges.
  DGL_TPU_GAT_PACKED  "1": the fused GAT reads its features rounded to bf16
      (round to nearest even) where H*D is even, with float32 logits; the
      backward differentiates that function straight through (dWh in
      float32).  Anything else: off.
  DGL_TPU_DEBUG_DISPATCH  "1": gspmm, gsddmm and gat_attention print which
      route a call took, ``[dgl-tpu dispatch] {op}: {path} ({detail})``,
      once per distinct line per process (``dispatch_log``).  The JAX
      package prints once per trace; eager torch dispatches every call,
      so a line already printed is not printed again.

The variables are the JAX package's own, so one setting drives both
packages in the parity tests.  The port has no switch that turns a kernel
off: a CUDA tensor reaches the kernel or an error.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

GAT_SOFTMAX_MODES = ("shift", "exact")


@dataclass
class Config:
    gat_softmax: str = "shift"
    gat_packed: bool = False
    debug_dispatch: bool = False


def _debug_dispatch() -> bool:
    return os.environ.get("DGL_TPU_DEBUG_DISPATCH", "0") == "1"


def get_config() -> Config:
    mode = os.environ.get("DGL_TPU_GAT_SOFTMAX", "shift")
    if mode not in GAT_SOFTMAX_MODES:
        raise ValueError(f"DGL_TPU_GAT_SOFTMAX={mode!r}; expected one of "
                         f"{GAT_SOFTMAX_MODES}")
    return Config(gat_softmax=mode,
                  gat_packed=os.environ.get("DGL_TPU_GAT_PACKED", "0") == "1",
                  debug_dispatch=_debug_dispatch())


# the dispatch lines this process has printed
_PRINTED: set = set()


def dispatch_log(op: str, path: str, detail: str = "") -> None:
    """Print ``[dgl-tpu dispatch] {op}: {path} ({detail})`` where
    ``DGL_TPU_DEBUG_DISPATCH=1`` and this process has not printed that line
    yet.  The variable is read at each call; unset, nothing is printed.
    It reports the route; it chooses none."""
    if not _debug_dispatch():
        return
    msg = f"[dgl-tpu dispatch] {op}: {path}"
    if detail:
        msg += f" ({detail})"
    if msg not in _PRINTED:
        _PRINTED.add(msg)
        print(msg, flush=True)
