"""Build, load and count the port's CUDA kernels.

The kernels are CUDA C++ for Hopper (``sm_90a``) under ``csrc/``, with a
plain C interface.  At first use, one ``nvcc`` per source compiles them
all at once into objects, which are linked into one shared library under
``build/`` at the repository root, keyed by a hash of the sources (a stale
library is never loaded); ``ctypes`` loads it.
Every C entry point takes raw device pointers and a stream and returns
``cudaGetLastError()``; ``check()`` raises if that is not 0.

Nothing here runs at import: the CPU tests import every module of the
port, and this machine may have no ``nvcc``.

``LAUNCHES`` counts kernel launches by name (``counted``: bf16 launches
under ``<name>_bf16``; K2's and K3's staged route under
``<name>_bf16.staged``, K4's and K5's packed walk under
``segment_max_bf16.fwd.packed`` and ``segment_max_bf16.bwd.packed``).  A
wrapper adds one where it launches its kernel and nowhere else; a plain
version that runs on a CUDA tensor adds one under ``plain.<name>``, so a
run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Collection, Dict, Optional, Union

import torch

from ...utils.profiling import span

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "dgl_hack_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# a row plan (spmm_kernel.py:plan_args): T, long_rows, piece_ptr, pieces,
# piece_row, num_long, num_pieces, partial
_PLAN = [_I, _P, _P, _P, _P, _I, _I, _P]
# K1's packed route (spmm_kernel.py:pack_args): short_limit, singles,
# num_singles
_PACKS = [_I, _P, _I]
# C signatures of the entry points in csrc/*.cu
SIGNATURES = {
    # indptr, gidx, eid, x, w, w_kind, out, num_rows, F, vec, slice, plan,
    # packed route, stream
    "segment_sum_f32": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                        *_PLAN, *_PACKS, _P],
    # as segment_sum_f32, with out_f32 after out
    "segment_sum_bf16": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                         *_PLAN, *_PACKS, _P],
    # indptr, gidx, x, w, w_kind, raw, num_rows, F, vec, slice, plan, stream
    "segment_max_f32": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, *_PLAN, _P],
    "segment_max_bf16": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, *_PLAN,
                         _P],
    # csr_indptr, dst_csr, csr_eids, x, w, w_kind, raw, g, dx, dw,
    # num_src, F, Fx, vec, vec_x, slice, plan, stream
    "segment_max_bwd_f32": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, *_PLAN, _P],
    "segment_max_bwd_bf16": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, *_PLAN, _P],
    # the packed walk over bf16 rows without a weight
    # (csrc/segment_max_packed.cu): indptr, gidx, x, raw, num_rows, F, vec,
    # slice, plan, stream
    "segment_max_bf16_packed": [_P, _P, _P, _P, _I, _I, _I, _I, *_PLAN, _P],
    # csr_indptr, dst_csr, x, raw, g, dx, num_src, F, Fx, vec, vec_x,
    # slice, plan, stream
    "segment_max_bwd_bf16_packed": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _I, *_PLAN, _P],
    # indptr, src, wh, el, er, w, shift, rst, den,
    # num_dst, H, D, slope, vec, lane_floats, plan, stream
    "gat_fwd_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                    _I, _I, _I, _F, _I, _I, *_PLAN, _P],
    # as gat_fwd_f32, with a bf16 wh
    "gat_fwd_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _F, _I, _I, *_PLAN, _P],
    # as gat_fwd_bf16, with Dp after D and stages, chunk, el_gran, w_gran
    # after lane_floats: the staged route (csrc/stage.cuh)
    "gat_fwd_bf16_staged": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I,
                            *_PLAN, _P],
    # csr_indptr, csr_eids, dst_csr, wh, el, dst_packed, dout, w, dwh,
    # del, draw, dw, num_src, H, D, slope, vec, lane_floats, plan, stream
    "gat_bwd_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                    _P, _P, _P, _I, _I, _I, _F, _I, _I, *_PLAN, _P],
    # as gat_bwd_f32, with a bf16 wh
    "gat_bwd_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _P, _P, _P, _I, _I, _I, _F, _I, _I, *_PLAN, _P],
    # as gat_bwd_bf16, with Dp after D and stages, chunk, dout_bf16,
    # w_gran, cuts, pass, passes after lane_floats
    "gat_bwd_bf16_staged": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I,
                            _I, _I, _P, _I, _I, *_PLAN, _P],
    # src, dst, lhs, rhs, out, op, E, F, D, vec, lanes, stream
    "sddmm_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # as sddmm_f32, with bf16 lhs, rhs and out
    "sddmm_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}


class Launches:
    """Kernel launch counts by name; plain ints, reset by the caller."""

    def __init__(self):
        self.counts: Dict[str, int] = {}

    def add(self, name: str) -> None:
        self.counts[name] = self.counts.get(name, 0) + 1

    def reset(self) -> None:
        self.counts.clear()


LAUNCHES = Launches()


def counted(name: str, dtype: torch.dtype) -> str:
    """A kernel's name in ``LAUNCHES``: bf16 launches count apart from
    float32 ones, as ``<name>_bf16`` (K2 and K3: where Wh is bf16)."""
    return f"{name}_bf16" if dtype == torch.bfloat16 else name


_LIB: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ at first use and need the CUDA toolkit")


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with span("kernels.load"):
        _LIB = _build_and_load()
    return _LIB


def _build_and_load() -> ctypes.CDLL:
    srcs = _sources()
    digest = hashlib.sha256()
    for p in srcs:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(ARCH_FLAGS).encode())
    so = BUILD_DIR / f"libdgl_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        nvcc = _nvcc()
        objs, procs = [], []
        for src in (p for p in srcs if p.suffix == ".cu"):
            obj = BUILD_DIR / f"{src.stem}.{tag}.o"
            objs.append(obj)
            procs.append((src.name, subprocess.Popen(
                [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c", "-Xcompiler",
                 "-fPIC", "-Xptxas", "-v", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        logs, failed = [], []
        try:
            for name, proc in procs:
                out, err = proc.communicate()
                logs.append(f"{name}:\n{err}")
                if proc.returncode != 0:
                    failed.append(
                        f"{name} ({proc.returncode}):\n{out}\n{err}")
            if failed:
                raise RuntimeError("nvcc failed: " + "\n".join(failed))
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            res = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o",
                                  str(tmp), *map(str, objs)],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                                   f"{res.stdout}\n{res.stderr}")
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
        BUILD_INFO["ptxas"] = "\n".join(logs)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    BUILD_INFO["path"] = str(so)
    return lib


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def run(name: str, entry, device: torch.device, *args) -> None:
    """Call the C entry point ``entry`` with ``args`` and the current
    stream of ``device``, and ``check`` its status.  The entry points
    launch on the current device, so ``device`` (the tensors' own) is made
    current for the call: every launch of K1-K6 goes through here."""
    with torch.cuda.device(device):
        check(name, entry(*args, stream_ptr(device)))


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def require(t: torch.Tensor, name: str,
            dtypes: Union[torch.dtype, Collection[torch.dtype]],
            device: torch.device, numel: Optional[int] = None) -> None:
    """Wrapper-side argument check: the kernels take contiguous tensors of
    the given dtype (or one of the given dtypes) on the launch device, and
    raise on anything else."""
    if isinstance(dtypes, torch.dtype):
        dtypes = (dtypes,)
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes "
                        f"{' or '.join(map(str, dtypes))}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name} has {t.numel()} elements, expected {numel}")
