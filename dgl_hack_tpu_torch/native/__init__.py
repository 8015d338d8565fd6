"""ctypes loader for the host libraries, as ``dgl_hack_tpu.native``: the
sampler (``get_lib``) and the TCP transport (``get_net_lib``).

``fastgraph.cpp`` beside this file is the port's own copy of the JAX
package's C++/OpenMP host kernels: row-wise neighbor sampling with and
without replacement (a counter-based RNG per seed row, so a sample is a
function of the graph, the seeds and one 64-bit seed alone, whatever the
thread count), block compaction and Fennel partitioning.

At first use ``g++ -O3 -shared -fPIC -std=c++17 -fopenmp`` compiles it
into ``build/dgl_hack_tpu_torch/`` at the repository root (the CUDA
kernels' ``BUILD_DIR``), keyed by a hash of the source and the flags, so
that a stale library is never loaded; where OpenMP does not build it is
retried without ``-fopenmp``, and
``BUILD_INFO`` records which library was loaded.  The library is written
under a temporary name and renamed into place, so that processes building
at once never load a half-written file.  If neither build succeeds,
``get_lib`` raises with the compiler's messages: the samplers have no
other path.

``netcomm.cpp`` is the port's copy of the JAX package's TCP message
transport (one connection per receiver, a reader thread per connection,
length-framed messages into a blocking queue), which
``distributed/kvstore.py``'s ``NativeTransport`` drives.  ``get_net_lib``
builds it the same way (``-lpthread``, no OpenMP) into
``libnetcomm_<hash>.so``; a failed build raises with the compiler's
messages, where the JAX loader returns None and its key-value store falls
back to an in-process loopback.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from ..ops.cuda.build import BUILD_DIR

SRC = Path(__file__).resolve().with_name("fastgraph.cpp")
NET_SRC = SRC.with_name("netcomm.cpp")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I64, _I32, _U64, _F64 = (ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64,
                          ctypes.c_double)
# (restype, argtypes) of the C entry points in fastgraph.cpp
SIGNATURES = {
    # indptr, src, seeds, num_seeds, fanout, seed, out_pos, out_counts
    "rowwise_sample": (_I64, [_I32P, _I32P, _I32P, _I64, _I32, _U64, _I64P,
                              _I32P]),
    # indptr, seeds, num_seeds, fanout, seed, out_pos, out_counts
    "rowwise_sample_replace": (_I64, [_I32P, _I32P, _I64, _I32, _U64, _I64P,
                                      _I32P]),
    # src, dst, E, dst_nodes, n_dst, mapping, out_src, out_dst, out_src_ids
    "compact_block": (_I64, [_I32P, _I32P, _I64, _I32P, _I64, _I64P, _I32P,
                             _I32P, _I32P]),
    # indptr_in, src, indptr_out, dst, order, n, E, k, gamma, slack,
    # num_passes, parts
    "fennel_partition": (None, [_I32P, _I32P, _I32P, _I32P, _I32P, _I64,
                                _I64, _I32, _F64, _F64, _I32, _I32P]),
    # as fennel_partition, with the node weights after order
    "fennel_partition_w": (None, [_I32P, _I32P, _I32P, _I32P, _I32P, _I32P,
                                  _I64, _I64, _I32, _F64, _F64, _I32,
                                  _I32P]),
}

_C = ctypes
# (restype, argtypes) of the C entry points in netcomm.cpp
NET_SIGNATURES = {
    # port, num_senders -> receiver handle or -1
    "nc_receiver_create": (_C.c_int64, [_C.c_int, _C.c_int]),
    "nc_receiver_wait_connected": (_C.c_int, [_C.c_int64, _C.c_int]),
    # void* out-pointer: c_char_p would stop at the first NUL byte
    "nc_recv": (_C.c_int64, [_C.c_int64, _C.POINTER(_C.c_void_p),
                             _C.POINTER(_C.c_int)]),
    "nc_free": (None, [_C.c_void_p]),
    "nc_receiver_destroy": (None, [_C.c_int64]),
    # ips, ports, n, my_id, timeout_ms -> sender handle or -1
    "nc_sender_create": (_C.c_int64, [_C.POINTER(_C.c_char_p),
                                      _C.POINTER(_C.c_int), _C.c_int,
                                      _C.c_int, _C.c_int]),
    "nc_send": (_C.c_int, [_C.c_int64, _C.c_int, _C.c_char_p, _C.c_int64]),
    "nc_sender_destroy": (None, [_C.c_int64]),
}

_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_NET_LIB: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}
NET_BUILD_INFO: Dict[str, object] = {}


def _compile(so: Path, openmp: bool, src: Path = SRC,
             libs: Tuple[str, ...] = ()) -> Optional[str]:
    """Compile ``src`` into ``so`` through a temporary file; None on
    success, else the compiler's messages."""
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}"
                       ".tmp")
    cmd = ["g++", *FLAGS, *(["-fopenmp"] if openmp else []), str(src),
           "-o", str(tmp), *libs]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"{' '.join(cmd)} ({res.returncode}):\n{res.stderr}"
    os.replace(tmp, so)
    return None


def build_library(build_dir: Path = BUILD_DIR) -> Tuple[Path, bool]:
    """The library built from SRC in ``build_dir`` (built there if missing)
    and whether it has OpenMP.  Raises RuntimeError with the compiler's
    messages if neither build succeeds."""
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    stem = f"libfastgraph_{digest.hexdigest()[:16]}"
    builds = [(build_dir / f"{stem}_omp.so", True),
              (build_dir / f"{stem}.so", False)]
    for so, openmp in builds:
        if so.exists():
            return so, openmp
    build_dir.mkdir(parents=True, exist_ok=True)
    errors = []
    for so, openmp in builds:
        err = _compile(so, openmp)
        if err is None:
            return so, openmp
        errors.append(err)
    raise RuntimeError("the host sampler (fastgraph.cpp) did not build:\n"
                       + "\n".join(errors))


NET_LIBS = ("-lpthread",)


def build_net_library(build_dir: Path = BUILD_DIR) -> Path:
    """The transport library built from NET_SRC in ``build_dir`` (built
    there if missing).  Raises RuntimeError with the compiler's messages
    if the build fails."""
    digest = hashlib.sha256(NET_SRC.read_bytes())
    digest.update(" ".join(FLAGS + list(NET_LIBS)).encode())
    so = build_dir / f"libnetcomm_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    build_dir.mkdir(parents=True, exist_ok=True)
    err = _compile(so, False, NET_SRC, NET_LIBS)
    if err is not None:
        raise RuntimeError("the TCP transport (netcomm.cpp) did not build:\n"
                           + err)
    return so


def _load(so: Path, signatures) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def get_lib() -> ctypes.CDLL:
    """Build (once per source hash) and load the host sampler library."""
    global _LIB
    with _lock:
        if _LIB is None:
            t0 = time.perf_counter()
            so, openmp = build_library()
            _LIB = _load(so, SIGNATURES)
            BUILD_INFO.update(path=str(so), openmp=openmp,
                              seconds=time.perf_counter() - t0)
        return _LIB


def get_net_lib() -> ctypes.CDLL:
    """Build (once per source hash) and load the TCP transport library."""
    global _NET_LIB
    with _lock:
        if _NET_LIB is None:
            t0 = time.perf_counter()
            so = build_net_library()
            _NET_LIB = _load(so, NET_SIGNATURES)
            NET_BUILD_INFO.update(path=str(so),
                                  seconds=time.perf_counter() - t0)
        return _NET_LIB


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(typ)


def rowwise_sample_native(indptr, src, seeds, fanout: int, replace: bool,
                          seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Up to ``fanout`` in-edges of each seed (exactly ``fanout`` with
    replacement, none for a seed without in-edges), as CSC positions.

    ``indptr``/``src`` are a graph's CSC arrays.  Returns (positions
    (total,) int64, counts (num_seeds,) int32): seed i's picks are the
    i-th run of ``counts[i]`` positions."""
    seeds = np.ascontiguousarray(seeds, np.int32)
    indptr = np.ascontiguousarray(indptr, np.int32)
    if fanout < 0:
        raise ValueError(f"fanout must be >= 0, got {fanout}")
    if len(seeds) and (int(seeds.min()) < 0
                       or int(seeds.max()) >= len(indptr) - 1):
        raise ValueError("seed ids out of range of the graph's dst nodes")
    lib = get_lib()
    n = len(seeds)
    out_pos = np.empty(n * fanout, np.int64)
    out_counts = np.empty(n, np.int32)
    if replace:
        lib.rowwise_sample_replace(
            _ptr(indptr, _I32P), _ptr(seeds, _I32P), n, fanout, seed,
            _ptr(out_pos, _I64P), _ptr(out_counts, _I32P))
    else:
        src = np.ascontiguousarray(src, np.int32)
        lib.rowwise_sample(
            _ptr(indptr, _I32P), _ptr(src, _I32P), _ptr(seeds, _I32P), n,
            fanout, seed, _ptr(out_pos, _I64P), _ptr(out_counts, _I32P))
    keep = (np.arange(fanout)[None, :] < out_counts[:, None]).reshape(-1)
    return out_pos[keep], out_counts


def fennel_native(indptr_in, src, indptr_out, dst_by_src, order, E: int,
                  k: int, gamma: float, slack: float, num_passes: int,
                  node_weights=None) -> np.ndarray:
    """Fennel partition of the graph into ``k`` parts, nodes visited in
    ``order``; returns each node's part (int32).  ``node_weights`` (int32)
    switches to the vertex-weighted objective and weighted cap
    (``fennel_partition_w`` in fastgraph.cpp)."""
    lib = get_lib()
    n = len(order)
    arrs = [np.ascontiguousarray(a, np.int32)
            for a in (indptr_in, src, indptr_out, dst_by_src, order)]
    parts = np.full(n, -1, np.int32)
    if node_weights is not None:
        vw = np.ascontiguousarray(node_weights, np.int32)
        lib.fennel_partition_w(*(_ptr(a, _I32P) for a in arrs),
                               _ptr(vw, _I32P), n, E, k, gamma, slack,
                               num_passes, _ptr(parts, _I32P))
    else:
        lib.fennel_partition(*(_ptr(a, _I32P) for a in arrs), n, E, k,
                             gamma, slack, num_passes, _ptr(parts, _I32P))
    return parts
