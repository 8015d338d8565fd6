"""Distributed key-value store for partitioned embeddings and features,
as ``dgl_hack_tpu.distributed.kvstore`` (reference: python/dgl/contrib/
dis_kvstore.py: KVServer:103, KVClient:670, push:956, pull:1021,
barrier, shut_down:1147; the C++ fast path src/graph/network.cc:705
_CAPI_FastPull), carried over the native TCP transport of
``native/netcomm.cpp`` (reference: src/graph/network/
socket_communicator.cc and msg_queue.cc).

The store serves the host-resident path: embedding tables larger than the
card (DGL-KE's --mix_cpu_gpu and multi-machine KVServer deployments),
features for sampler workers, and barriers between processes.  Shards
are numpy arrays on the host; a trainer copies what it pulls to the card
itself.

Semantics matched to the reference:
* a tensor ``name`` is row-partitioned across servers by a per-name
  ``partition_book`` (global row -> server id); each server holds the
  local shard plus ``global2local`` (global row -> local row) or a range
  offset;
* ``push`` routes (ids, rows) by the partition book and ADDS into the
  shard (the default handler; a subclass overrides it, as DGL-KE's
  KGEServer injects its sparse Adagrad);
* ``pull`` gathers rows, with the FastPull shortcut: rows owned by a
  co-located server are read from its shard directly, without the
  network;
* ``barrier`` blocks until every client reached it (server-counted).

The wire format (``_pack``/``_unpack``) is the JAX package's byte for
byte.  ``make_transports(base_port=0)`` gives the in-process
``LoopbackTransport`` by choice; with a port it gives ``NativeTransport``,
which builds ``netcomm.cpp`` at first use and raises with the compiler's
messages if that fails (the JAX package falls back to loopback there).
"""
from __future__ import annotations

import queue as _queue
import struct
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..native import get_net_lib

# message types (reference: dis_kvstore.py KVMsgType)
MSG_PUSH, MSG_PULL, MSG_PULL_BACK, MSG_BARRIER, MSG_BARRIER_BACK, \
    MSG_FINAL, MSG_INIT = range(7)

_DTYPES = [np.float32, np.float64, np.int32, np.int64, np.float16, np.bool_]
_DTYPE_CODE = {np.dtype(d): i for i, d in enumerate(_DTYPES)}


def _pack(msg_type: int, name: str, arrays: Sequence[np.ndarray] = (),
          meta: int = 0) -> bytes:
    """Length-framed binary message (the ArrayMeta role,
    reference: src/graph/network.cc:67-110)."""
    nb = name.encode()
    parts = [struct.pack("<BiH", msg_type, meta, len(nb)), nb,
             struct.pack("<B", len(arrays))]
    for a in arrays:
        a = np.ascontiguousarray(a)
        parts.append(struct.pack("<BB", _DTYPE_CODE[a.dtype], a.ndim))
        parts.append(struct.pack(f"<{a.ndim}q", *a.shape))
        parts.append(a.tobytes())
    return b"".join(parts)


def _unpack(buf: bytes):
    msg_type, meta, nlen = struct.unpack_from("<BiH", buf, 0)
    off = 7
    name = buf[off:off + nlen].decode()
    off += nlen
    (n_arr,) = struct.unpack_from("<B", buf, off)
    off += 1
    arrays = []
    for _ in range(n_arr):
        code, ndim = struct.unpack_from("<BB", buf, off)
        off += 2
        shape = struct.unpack_from(f"<{ndim}q", buf, off)
        off += 8 * ndim
        dt = np.dtype(_DTYPES[code])
        size = int(np.prod(shape)) * dt.itemsize if ndim else dt.itemsize
        arrays.append(np.frombuffer(buf, dt, count=int(np.prod(shape)),
                                    offset=off).reshape(shape).copy())
        off += size
    return msg_type, name, arrays, meta


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------
class NativeTransport:
    """TCP transport over native/netcomm.cpp."""

    def __init__(self, my_id: int, listen_port: int,
                 peers: List[Tuple[str, int]], num_inbound: int,
                 timeout_ms: int = 30_000):
        import ctypes
        self._c = ctypes
        self.lib = get_net_lib()
        self.rh = self.lib.nc_receiver_create(listen_port, num_inbound)
        if self.rh < 0:
            raise RuntimeError(f"cannot listen on :{listen_port}")
        ips = (ctypes.c_char_p * len(peers))(
            *[p[0].encode() for p in peers])
        ports = (ctypes.c_int * len(peers))(*[p[1] for p in peers])
        self.sh = self.lib.nc_sender_create(ips, ports, len(peers), my_id,
                                            timeout_ms)
        if self.sh < 0:
            raise RuntimeError("cannot connect to peers")
        self.lib.nc_receiver_wait_connected(self.rh, timeout_ms)

    def send(self, dest_idx: int, payload: bytes) -> None:
        rc = self.lib.nc_send(self.sh, dest_idx, payload, len(payload))
        if rc != 0:
            raise RuntimeError("send failed")

    def recv(self) -> Tuple[int, bytes]:
        buf = self._c.c_void_p()
        sid = self._c.c_int()
        size = self.lib.nc_recv(self.rh, self._c.byref(buf),
                                self._c.byref(sid))
        if size < 0:
            raise RuntimeError("receiver closed")
        data = self._c.string_at(buf, size)
        self.lib.nc_free(buf)
        return sid.value, data

    def close(self) -> None:
        self.lib.nc_sender_destroy(self.sh)
        self.lib.nc_receiver_destroy(self.rh)


class LoopbackTransport:
    """In-process transport (threads of one process): the msg_queue role
    without sockets."""
    _registry: Dict[str, "_queue.Queue"] = {}
    _lock = threading.Lock()

    def __init__(self, my_id: int, my_key: str, peer_keys: List[str]):
        self.my_id = my_id
        self.peer_keys = peer_keys
        with LoopbackTransport._lock:
            self.q = LoopbackTransport._registry.setdefault(
                my_key, _queue.Queue())

    def send(self, dest_idx: int, payload: bytes) -> None:
        with LoopbackTransport._lock:
            q = LoopbackTransport._registry.setdefault(
                self.peer_keys[dest_idx], _queue.Queue())
        q.put((self.my_id, payload))

    def recv(self) -> Tuple[int, bytes]:
        return self.q.get()

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------
class KVServer:
    """Holds row shards; serves push/pull/barrier until all clients
    shut down (reference: dis_kvstore.py KVServer.start:376-528)."""

    def __init__(self, server_id: int, num_clients: int,
                 transport=None):
        self.server_id = server_id
        self.num_clients = num_clients
        self.net = transport
        self._data: Dict[str, np.ndarray] = {}
        self._g2l: Dict[str, Optional[np.ndarray]] = {}
        self._offset: Dict[str, int] = {}
        self._barrier_count = 0

    # -- shard management ---------------------------------------------------
    def init_data(self, name: str, data: np.ndarray,
                  global2local: Optional[np.ndarray] = None,
                  offset: int = 0) -> None:
        """Register the local shard.  Rows are addressed either through
        ``global2local`` (arbitrary partition) or ``global_id - offset``
        (range partition)."""
        self._data[name] = np.asarray(data)
        self._g2l[name] = None if global2local is None \
            else np.asarray(global2local)
        self._offset[name] = offset

    def get_data(self, name: str) -> np.ndarray:
        return self._data[name]

    def _local_ids(self, name: str, ids: np.ndarray) -> np.ndarray:
        g2l = self._g2l.get(name)
        if g2l is not None:
            return g2l[ids]
        return ids - self._offset[name]

    # -- overridable handlers (KGEServer pattern) ----------------------------
    def _push_handler(self, name: str, local_ids: np.ndarray,
                      data: np.ndarray) -> None:
        np.add.at(self._data[name], local_ids, data)

    def _pull_handler(self, name: str, local_ids: np.ndarray) -> np.ndarray:
        return self._data[name][local_ids]

    # -- serve loop -----------------------------------------------------------
    def start(self) -> None:
        finals = 0
        while finals < self.num_clients:
            sender, buf = self.net.recv()
            msg_type, name, arrays, meta = _unpack(buf)
            if msg_type == MSG_FINAL:
                finals += 1
            elif msg_type == MSG_PUSH:
                ids, data = arrays
                self._push_handler(name, self._local_ids(name, ids), data)
            elif msg_type == MSG_PULL:
                ids, = arrays
                rows = self._pull_handler(name, self._local_ids(name, ids))
                self.net.send(sender,
                              _pack(MSG_PULL_BACK, name, [ids, rows],
                                    meta=meta))
            elif msg_type == MSG_BARRIER:
                self._barrier_count += 1
                if self._barrier_count == self.num_clients:
                    self._barrier_count = 0
                    for c in range(self.num_clients):
                        self.net.send(c, _pack(MSG_BARRIER_BACK, ""))
        self.net.close()


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------
class KVClient:
    """Routes push/pull by partition book
    (reference: dis_kvstore.py KVClient push:956 / pull:1021)."""

    def __init__(self, client_id: int, num_servers: int, transport=None):
        self.client_id = client_id
        self.num_servers = num_servers
        self.net = transport
        self._book: Dict[str, np.ndarray] = {}
        self._local: Dict[str, Tuple[int, np.ndarray, Optional[np.ndarray],
                                     int]] = {}
        self._seq = 0

    def set_partition_book(self, name: str, book: np.ndarray) -> None:
        """(num_global_rows,) int -> owning server id."""
        self._book[name] = np.asarray(book)

    def set_local_shard(self, name: str, server_id: int, data: np.ndarray,
                        global2local: Optional[np.ndarray] = None,
                        offset: int = 0) -> None:
        """FastPull shortcut (reference: network.cc:705): the co-located
        server's shard, shared-memory mapped — local rows are read
        directly, only remote rows travel."""
        self._local[name] = (server_id, data, global2local, offset)

    def _route(self, name: str, ids: np.ndarray) -> np.ndarray:
        return self._book[name][ids]

    def push(self, name: str, ids, data) -> None:
        ids = np.asarray(ids, np.int64)
        data = np.asarray(data)
        owner = self._route(name, ids)
        for s in np.unique(owner):
            m = owner == s
            self.net.send(int(s), _pack(MSG_PUSH, name,
                                        [ids[m], data[m]]))

    def pull(self, name: str, ids) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        owner = self._route(name, ids)
        out: Optional[np.ndarray] = None
        pending = 0
        local = self._local.get(name)
        self._seq += 1
        for s in np.unique(owner):
            m = owner == s
            if local is not None and int(s) == local[0]:
                _, shard, g2l, off = local
                lids = g2l[ids[m]] if g2l is not None else ids[m] - off
                rows = shard[lids]
                if out is None:
                    out = np.empty((ids.shape[0],) + rows.shape[1:],
                                   rows.dtype)
                out[m] = rows
            else:
                self.net.send(int(s), _pack(MSG_PULL, name, [ids[m]],
                                            meta=self._seq))
                pending += 1
        while pending:
            sender, buf = self.net.recv()
            msg_type, rname, arrays, meta = _unpack(buf)
            assert msg_type == MSG_PULL_BACK and meta == self._seq, \
                "out-of-order kvstore reply"
            rids, rows = arrays
            if out is None:
                out = np.empty((ids.shape[0],) + rows.shape[1:], rows.dtype)
            # rids is the exact subset we sent (ids[m]); place back by mask
            m = self._route(name, ids) == self._book[rname][rids[0]]
            out[m] = rows
            pending -= 1
        return out

    def barrier(self) -> None:
        for s in range(self.num_servers):
            self.net.send(s, _pack(MSG_BARRIER, ""))
        acks = 0
        while acks < self.num_servers:
            _, buf = self.net.recv()
            msg_type, *_ = _unpack(buf)
            assert msg_type == MSG_BARRIER_BACK
            acks += 1

    def shutdown(self) -> None:
        """Reference: dis_kvstore.py shut_down:1147."""
        for s in range(self.num_servers):
            self.net.send(s, _pack(MSG_FINAL, ""))
        self.net.close()


# ---------------------------------------------------------------------------
# wiring helpers
# ---------------------------------------------------------------------------
def make_transports(num_servers: int, num_clients: int,
                    base_port: int = 0, host: str = "127.0.0.1"):
    """Build the all-to-all transport pairs for an in-machine deployment
    (tests, single-host multi-process).  Returns (server_t, client_t)
    factories keyed by id: TCP on ``base_port + i`` (servers) and
    ``base_port + 100 + i`` (clients) when a port is given; the in-process
    loopback with ``base_port=0``."""
    if base_port:
        sv_ports = [base_port + i for i in range(num_servers)]
        cl_ports = [base_port + 100 + i for i in range(num_clients)]

        def server_t(i):
            return NativeTransport(
                i, sv_ports[i], [(host, p) for p in cl_ports],
                num_inbound=num_clients)

        def client_t(i):
            return NativeTransport(
                i, cl_ports[i], [(host, p) for p in sv_ports],
                num_inbound=num_servers)
        return server_t, client_t

    def server_t(i):
        return LoopbackTransport(i, f"srv{i}",
                                 [f"cli{c}" for c in range(num_clients)])

    def client_t(i):
        return LoopbackTransport(i, f"cli{i}",
                                 [f"srv{s}" for s in range(num_servers)])
    return server_t, client_t
