"""Local ranks: spawned processes in one ``torch.distributed`` group.

``RankPool(n, backend, device)`` starts n processes (the ``spawn`` start
method), each of which joins a group over ``tcp://127.0.0.1`` and then
runs the calls it is sent: ``pool.run(fn, *args)`` calls ``fn(device,
*args)`` on every rank and returns the results in rank order.  ``fn``
must be importable by name (a module-level function), and its arguments
and results pickle.  Every wait is time-limited: a rank that fails sends
its traceback back, and a call that does not end in ``timeout`` seconds
stops the pool and raises.  The group's own collectives time out after
``timeout`` seconds too (``init_process_group(timeout=...)``).

``device`` is "cpu", or "cuda" for ranks on the cards: rank r takes card
``r % device_count``, so ranks may share one card (over gloo; NCCL
refuses two ranks on one card).  The pool never builds anything: a
kernel library the ranks load must be built before it starts
(``ops.cuda.build.library``), so that no two ranks run the compiler at
once.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import pickle
import queue
import socket
import traceback
from typing import Any, Callable, List, Optional


def free_port() -> int:
    """A TCP port that is free on the loopback now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device: str, rank: int):
    """Rank ``rank``'s device: card ``rank % device_count`` for "cuda"
    (made current), else ``device`` itself."""
    import torch
    if device == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        return dev
    return torch.device(device)


def _worker(rank: int, world: int, port: int, backend: str, device: str,
            timeout: float, tasks, results) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)          # ranks share the host's cores
    try:
        dev = rank_device(device, rank)
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        results.put((rank, "ready", None))
    except Exception:                      # reported, then the rank ends
        results.put((rank, "error", traceback.format_exc()))
        return
    try:
        while True:
            try:
                task = tasks.get()
                if task is None:
                    break
                fn, args = task
                results.put((rank, "ok", fn(dev, *args)))
            except Exception:              # reported to the caller
                results.put((rank, "error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``n`` local ranks in one group (see the module's docstring)."""

    def __init__(self, n: int, backend: str = "gloo", device: str = "cpu",
                 timeout: float = 120.0):
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"unknown backend {backend!r}")
        self.n, self.timeout = n, timeout
        ctx = mp.get_context("spawn")
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(n)]
        port = free_port()
        self.procs = [ctx.Process(
            target=_worker, daemon=True,
            args=(r, n, port, backend, device, timeout, self.tasks[r],
                  self.results)) for r in range(n)]
        for p in self.procs:
            p.start()
        self._collect("ready", timeout)

    def _collect(self, what: str, timeout: float) -> List[Any]:
        out: List[Any] = [None] * self.n
        errors = []
        for _ in range(self.n):
            try:
                rank, status, value = self.results.get(timeout=timeout)
            except queue.Empty:
                self.close()
                raise TimeoutError(f"ranks did not answer ({what}) within "
                                   f"{timeout} s") from None
            if status == "error":
                errors.append(f"rank {rank}:\n{value}")
            out[rank] = value
        if errors:
            self.close()
            raise RuntimeError("\n".join(errors))
        return out

    def run(self, fn: Callable, *args, timeout: Optional[float] = None
            ) -> List[Any]:
        """``fn(device, *args)`` on every rank; the results in rank
        order."""
        pickle.dumps(fn)          # a function the ranks cannot import
        for q in self.tasks:
            q.put((fn, args))
        return self._collect(getattr(fn, "__name__", "call"),
                             timeout or self.timeout)

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def run_ranks(n: int, fn: Callable, *args, backend: str = "gloo",
              device: str = "cpu", timeout: float = 600.0) -> List[Any]:
    """``fn(device, *args)`` on ``n`` fresh local ranks; the results in
    rank order."""
    with RankPool(n, backend, device, timeout) as pool:
        return pool.run(fn, *args)
