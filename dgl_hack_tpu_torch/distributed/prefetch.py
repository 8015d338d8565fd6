"""Sampler -> device prefetch pipeline, as
``dgl_hack_tpu.distributed.prefetch`` (DGL: the prefetching sampler
wrappers of python/dgl/contrib/sampling/sampler.py and the sampler pool
of contrib/sampling/dis_sampler.py).

Worker threads sample the next minibatches on the host while the card
trains on the current one, and copy each sample to ``device`` before it
is queued: every tuple, list, dict, numpy array, tensor and ``Graph`` of
the sample tree (``to_device``).  On the card a worker copies from pinned
host memory on a CUDA stream of its own and synchronises that stream
before it queues the sample, so the consumer never reads a tensor whose
copy is still in flight; each copied tensor is recorded on the
consumer's stream, so that its memory is not reused before the
consumer's work on it ends.  The native sampler and numpy release the
interpreter lock, so the workers overlap with the training loop.

Closing the iterator (or leaving a ``for`` loop early) stops the workers
after the sample each is on.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, List, Optional

import numpy as np
import torch

from ..core.graph import _STRUCT, Graph
from .dis_sampler import SamplerPool

_JOIN_S = 60.0


def to_device(item, device, non_blocking: bool = False):
    """``item`` with every numeric numpy array, tensor and ``Graph`` in its
    tuples, lists and dicts copied to ``device`` (numpy arrays become
    tensors); other leaves are kept.  ``non_blocking`` copies through
    pinned memory without waiting (``Graph.to``)."""
    if isinstance(item, Graph):
        return item.to(device, non_blocking=non_blocking)
    if isinstance(item, np.ndarray) and item.dtype.kind in "biuf":
        item = torch.from_numpy(np.ascontiguousarray(item))
    if isinstance(item, torch.Tensor):
        if non_blocking and item.device.type == "cpu":
            item = item.pin_memory()
        return item.to(device, non_blocking=non_blocking)
    if isinstance(item, (tuple, list)):
        return type(item)(to_device(v, device, non_blocking) for v in item)
    if isinstance(item, dict):
        return {k: to_device(v, device, non_blocking)
                for k, v in item.items()}
    return item


def _device_tensors(item) -> Iterator[torch.Tensor]:
    """Every tensor of a sample tree, a Graph's structure and frames
    included."""
    if isinstance(item, Graph):
        for name in _STRUCT:
            yield from _device_tensors(getattr(item, name))
        for frame in (*item._node_frames, item._edge_frame):
            yield from _device_tensors(frame)
    elif isinstance(item, torch.Tensor):
        yield item
    elif isinstance(item, (tuple, list)):
        for v in item:
            yield from _device_tensors(v)
    elif isinstance(item, dict):
        for v in item.values():
            yield from _device_tensors(v)


class _Shipper:
    """One worker thread's copier to ``device``: on the card through
    pinned memory on a stream of its own, synchronised before the sample
    is handed over, each tensor recorded on the ``consumer`` stream."""

    def __init__(self, device, consumer: Optional[torch.cuda.Stream]):
        self.device = torch.device(device)
        self.consumer = consumer
        self.stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None

    def __call__(self, item):
        if self.stream is None:
            return to_device(item, self.device)
        with torch.cuda.stream(self.stream):
            item = to_device(item, self.device, non_blocking=True)
        self.stream.synchronize()
        for t in _device_tensors(item):
            if t.is_cuda:
                t.record_stream(self.consumer)
        return item


def _consumer_stream(device) -> Optional[torch.cuda.Stream]:
    device = torch.device(device)
    return torch.cuda.current_stream(device) if device.type == "cuda" \
        else None


def _put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Queue ``item`` unless ``stop`` is set first; True if queued."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


class _Worker:
    """The body of one prefetch thread: iterate ``iterable``, ship each
    item and queue it, then queue ``done``; an exception is kept in
    ``errors`` for the consumer."""

    def __init__(self, iterable: Iterable, q: queue.Queue, done,
                 stop: threading.Event, errors: List[BaseException],
                 device, consumer):
        self.iterable, self.q, self.done = iterable, q, done
        self.stop, self.errors = stop, errors
        self.device = None if device is None else torch.device(device)
        self.consumer = consumer

    def __call__(self, *_):
        try:
            ship = None if self.device is None else \
                _Shipper(self.device, self.consumer)
            for item in self.iterable:
                if self.stop.is_set():
                    return
                if ship is not None:
                    item = ship(item)
                if not _put(self.q, item, self.stop):
                    return
        except Exception as e:       # handed to the consumer, raised there
            self.errors.append(e)
        finally:
            _put(self.q, self.done, self.stop)


class ThreadedPrefetcher:
    """Wrap any iterable: a worker thread keeps up to ``capacity`` items
    ready, copied to ``device`` when ``device_put`` is set.  Items come
    in the iterable's order; an exception in the worker is raised in the
    consumer after the items before it."""

    _SENTINEL = object()

    def __init__(self, iterable: Iterable, capacity: int = 2,
                 device_put: bool = True, device="cuda"):
        self._iterable = iterable
        self._capacity = capacity
        self._device = torch.device(device) if device_put else None

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self._capacity)
        stop, errors = threading.Event(), []
        consumer = None if self._device is None else \
            _consumer_stream(self._device)
        t = threading.Thread(
            target=_Worker(self._iterable, q, self._SENTINEL, stop, errors,
                           self._device, consumer), daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._SENTINEL:
                    if errors:
                        raise errors[0]
                    return
                yield item
        finally:
            stop.set()
            t.join(_JOIN_S)


def prefetch_to_device(loader: Iterable, capacity: int = 2, device="cuda"):
    """``loader``'s items, each copied to ``device`` ahead of use by a
    worker thread."""
    return ThreadedPrefetcher(loader, capacity=capacity, device_put=True,
                              device=device)


class PooledPrefetcher:
    """``num_workers`` sampling threads, each iterating its own loader
    (``make_loader(worker_id)``: give each its own seed shard and its own
    sampler, since an ``np.random.Generator`` is not thread-safe) into one
    bounded queue, each item copied to ``device`` when ``device_put`` is
    set; the consumer gets the merged stream in arrival order.  An
    exception in a worker is raised once every worker has ended."""

    _SENTINEL = object()

    def __init__(self, make_loader: Callable[[int], Iterable],
                 num_workers: int = 2, capacity: int = 4,
                 device_put: bool = True, device="cuda"):
        self._make = make_loader
        self._num_workers = num_workers
        self._capacity = capacity
        self._device = torch.device(device) if device_put else None

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self._capacity)
        stop, errors = threading.Event(), []
        consumer = None if self._device is None else \
            _consumer_stream(self._device)

        def worker(i):
            try:
                loader = self._make(i)
            except Exception as e:   # handed to the consumer, raised there
                errors.append(e)
                _put(q, self._SENTINEL, stop)
                return
            _Worker(loader, q, self._SENTINEL, stop, errors, self._device,
                    consumer)()

        pool = SamplerPool(self._num_workers, worker)
        pool.start()
        try:
            done = 0
            while done < self._num_workers:
                item = q.get()
                if item is self._SENTINEL:
                    done += 1
                    continue
                yield item
            if errors:
                raise errors[0]
        finally:
            stop.set()
            pool.join(_JOIN_S)
