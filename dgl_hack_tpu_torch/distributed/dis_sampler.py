"""Distributed sampler service: sampler processes produce minibatch
block lists, trainers consume them as an iterator, as
``dgl_hack_tpu.distributed.dis_sampler`` (reference: python/dgl/contrib/
sampling/dis_sampler.py: SamplerSender:63, which serialises NodeFlows over
TCP through _CAPI_SenderSendNodeFlow, src/graph/network.cc:275;
SamplerReceiver:146, a blocking iterator; SamplerPool, forked sampling
workers; and the end-signal protocol, _CAPI_SenderSendSamplerEndSignal,
network.cc:359).

A sample is the sampler's (blocks, input_nodes, seeds), serialised as the
key-value store's length-framed message (``kvstore._pack``): the blocks'
user-order edges as int32 arrays and their edge masks, the same bytes as
the JAX package's for the same blocks.  The blocks arrive on the CPU;
the trainer copies them to the card (``Graph.to``, the prefetchers).

``SamplerPool`` runs workers as threads (the native sampler and numpy
release the interpreter lock; ``PooledPrefetcher`` runs on it) or as
spawned processes.  A process worker never creates a CUDA context on the
card: it hides the card (``CUDA_VISIBLE_DEVICES=""``) before the worker
runs, which holds because torch creates no context at import.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.graph import Graph, _build
from .kvstore import _pack, _unpack

MSG_SAMPLE, MSG_END = 20, 21

Sample = Tuple[List[Graph], np.ndarray, np.ndarray]


def serialize_sample(blocks: Sequence[Graph], input_nodes, seeds) -> bytes:
    """Flatten a (blocks, input_nodes, seeds) sample into one message."""
    meta = []
    arrays: List[np.ndarray] = [np.asarray(input_nodes, np.int32),
                                np.asarray(seeds, np.int32)]
    for b in blocks:
        s, d = b.host_edges()
        has_mask = b.edge_mask is not None
        meta.append({"ns": b.num_src_nodes, "nd": b.num_dst_nodes,
                     "mask": has_mask})
        arrays.append(np.asarray(s, np.int32))
        arrays.append(np.asarray(d, np.int32))
        if has_mask:
            # the mask in USER edge order, to pair with (s, d)
            em = b.host("edge_mask")
            if b.int2user is not None:
                em = em[b.host("user2int")]
            arrays.append(em.astype(np.bool_))
    return _pack(MSG_SAMPLE, json.dumps(meta), arrays)


def deserialize_sample(buf: bytes) -> Sample:
    msg_type, meta_s, arrays, _ = _unpack(buf)
    if msg_type != MSG_SAMPLE:
        raise ValueError(f"not a sample message (type {msg_type})")
    meta = json.loads(meta_s)
    input_nodes, seeds = arrays[0], arrays[1]
    blocks: List[Graph] = []
    i = 2
    for m in meta:
        s, d = arrays[i], arrays[i + 1]
        i += 2
        em = None
        if m["mask"]:
            em = arrays[i]
            i += 1
        blocks.append(_build(s, d, m["ns"], m["nd"], is_block=True,
                             edge_mask=em))
    return blocks, input_nodes, seeds


class SamplerSender:
    """Sampler-side endpoint (reference: dis_sampler.py SamplerSender)."""

    def __init__(self, transport):
        self.net = transport

    def send(self, blocks: Sequence[Graph], input_nodes, seeds,
             recv_idx: int = 0) -> None:
        self.net.send(recv_idx, serialize_sample(blocks, input_nodes, seeds))

    def signal_end(self, recv_idx: int = 0) -> None:
        """End-of-epoch signal (reference: network.cc:359)."""
        self.net.send(recv_idx, _pack(MSG_END, ""))

    def close(self) -> None:
        self.net.close()


class SamplerReceiver:
    """Trainer-side blocking iterator over incoming samples; one epoch
    ends when every sender has signalled (reference: dis_sampler.py
    SamplerReceiver.__iter__/__next__:146-188)."""

    def __init__(self, transport, num_senders: int):
        self.net = transport
        self.num_senders = num_senders

    def __iter__(self) -> Iterator[Sample]:
        ended = 0
        while ended < self.num_senders:
            _, buf = self.net.recv()
            if buf[0] == MSG_END:
                ended += 1
                continue
            yield deserialize_sample(buf)

    def close(self) -> None:
        self.net.close()


def _process_worker_bootstrap(worker_fn, i):
    """Module-level spawn target: hide the card from the child before the
    worker runs (one process owns the card), then run the worker."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import torch
    if torch.cuda.is_initialized():
        raise RuntimeError("a sampler process initialised CUDA before its "
                           "worker ran")
    worker_fn(i)


class SamplerPool:
    """Run ``num_workers`` sampling workers, each executing
    ``worker_fn(worker_id)`` to completion (reference: dis_sampler.py
    SamplerPool, forked processes there).

    mode='thread' (default): daemon threads, for samplers that release the
    interpreter lock.  mode='process': spawned processes like the
    reference's; ``worker_fn`` must be picklable (module-level) and build
    its own transport and graph, and the card is hidden from the
    children."""

    def __init__(self, num_workers: int, worker_fn: Callable[[int], None],
                 mode: str = "thread"):
        if mode == "thread":
            self.workers = [threading.Thread(target=worker_fn, args=(i,),
                                             daemon=True)
                            for i in range(num_workers)]
        elif mode == "process":
            import multiprocessing as mp
            ctx = mp.get_context("spawn")
            self.workers = [
                ctx.Process(target=_process_worker_bootstrap,
                            args=(worker_fn, i), daemon=True)
                for i in range(num_workers)]
        else:
            raise ValueError(f"mode must be 'thread' or 'process', got "
                             f"{mode!r}")

    def start(self) -> None:
        for t in self.workers:
            t.start()

    def join(self, timeout: Optional[float] = None) -> None:
        for t in self.workers:
            t.join(timeout)
