"""Multi-GPU SPMD training over a ('node', 'tp') mesh, as
``dgl_hack_tpu.parallel.spmd``, with one process per rank.

The JAX module annotates shardings and lets GSPMD insert the collectives.
The port keeps the same storage layouts and writes the collectives out:

* **node axis ('node')** — row sharding of node-level arrays (features,
  labels, masks: ``shard_rows``) and of the edge arrays (``shard_graph``);
* **tp axis ('tp')** — column sharding of 2-D weights (``shard_params``);
* ``make_spmd_train_step`` gathers what the model needs (the graph, the
  features, the weights), runs the forward on every rank, takes the loss
  over the rank's own rows, all-reduces the gradients over 'node' and
  reduce-scatters each column-sharded gradient to its owners over 'tp'.
  The forward is repeated on each rank: a departure in cost, not in
  function (ROADMAP Queue 2 has row-sharded execution);
* ``make_sampled_dp_step``: each rank trains on its own sampled blocks,
  and the gradients are averaged (the reference's multi-GPU sampled
  GraphSAGE: one DataLoader per process, DDP's all_reduce).

A sharded array is a ``Sharded``: the rank's block and what it takes to
gather the whole.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.graph import Graph
from . import collectives as coll

Tensor = torch.Tensor

_EDGE_FIELDS = ("src", "dst", "csr_eids", "int2user", "user2int",
                "edge_mask")


def make_mesh(n_devices: Optional[int] = None, tp: int = 1,
              devices=None, device_type: Optional[str] = None):
    """A ``DeviceMesh`` over ('node', 'tp') of all ranks of the default
    group, ``(n / tp, tp)``; with tp=1 pure spatial/data parallelism.
    ``n_devices`` must be the group's size (one rank a device); ``devices``
    is the JAX signature's and unused.  ``device_type`` defaults to
    "cuda" under NCCL and "cpu" under gloo (ranks that share a card)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh of {n_devices} devices needs as many "
                         f"ranks; the group has {n}")
    if n % tp:
        raise ValueError(f"tp={tp} does not divide {n} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // tp, tp),
                            mesh_dim_names=("node", "tp"))


class Sharded(NamedTuple):
    """This rank's block of an array split along ``dim`` over ``group``:
    blocks of ``ceil(size / P)``, the last padded with zeros."""
    local: Tensor
    size: int
    dim: int
    group: Any

    def full(self) -> Tensor:
        """The whole array, gathered from every rank (not
        differentiable)."""
        t = self.local.detach().movedim(self.dim, 0)
        out = coll.all_gather(t, self.group)[:self.size]
        return out.movedim(0, self.dim)


def _block(x: Tensor, dim: int, group) -> Sharded:
    P, r = coll.world(group), coll.rank(group)
    size = x.shape[dim]
    B = max(1, math.ceil(size / P))
    blk = x.narrow(dim, min(r * B, size), max(0, min(B, size - r * B)))
    if blk.shape[dim] < B:
        pad = list(blk.shape)
        pad[dim] = B - blk.shape[dim]
        blk = torch.cat([blk, blk.new_zeros(pad)], dim)
    return Sharded(blk.contiguous(), size, dim, group)


def replicate(mesh, tree):
    """Every rank takes rank 0's copy of each tensor of ``tree`` (a tensor,
    or a dict or list of them), broadcast over the default group."""
    if isinstance(tree, Tensor):
        out = tree.detach().clone().contiguous()
        dist.broadcast(out, 0)
        return out.requires_grad_(tree.requires_grad)
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(mesh, v) for v in tree)
    return tree


def shard_rows(mesh, x, axis: str = "node") -> Sharded:
    """x (N, ...) -> this rank's row block over ``axis``."""
    return _block(torch.as_tensor(x), 0, coll.group_of(mesh, axis))


class ShardedGraph(NamedTuple):
    """A graph whose edge arrays are split over 'node' (edges are
    dst-sorted, so an even edge split approximates a dst-contiguous
    partition) and whose indptrs are replicated.  ``full()`` gathers the
    graph once and caches it (its structure never changes)."""
    num_src: int
    num_dst: int
    is_block: bool
    csc_indptr: Tensor
    csr_indptr: Optional[Tensor]
    edges: Dict[str, Sharded]
    cache: Dict[str, Graph]

    def full(self) -> Graph:
        g = self.cache.get("full")
        if g is None:
            kw = {k: s.full() for k, s in self.edges.items()}
            if "edge_mask" in kw:
                kw["edge_mask"] = kw["edge_mask"].bool()
            g = Graph(num_src=self.num_src, num_dst=self.num_dst,
                      csc_indptr=self.csc_indptr,
                      csr_indptr=self.csr_indptr, is_block=self.is_block,
                      **kw)
            self.cache["full"] = g
        return g


def shard_graph(mesh, g: Graph) -> ShardedGraph:
    """The graph's edge arrays split over 'node', its indptrs replicated
    (the JAX function's layout; the graph's frames are not carried)."""
    group = coll.group_of(mesh, "node")
    edges = {}
    for name in _EDGE_FIELDS:
        v = getattr(g, name)
        if v is not None:
            v = v.to(torch.int32) if name == "edge_mask" else v
            edges[name] = _block(v, 0, group)
    return ShardedGraph(g.num_src_nodes, g.num_dst_nodes, g.is_block,
                        g.csc_indptr, g.csr_indptr, edges, {})


def _tp_sharded(shape, tp: int) -> bool:
    return tp > 1 and len(shape) == 2 and shape[1] % tp == 0


def shard_params(mesh, params: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """2-D weights whose columns divide by the mesh's 'tp' size: this
    rank's column block over 'tp'; everything else replicated.  Returns
    leaf tensors that require grad, for the optimizer."""
    tp = mesh.size(1) if mesh is not None and hasattr(mesh, "size") else 1
    r = coll.rank(coll.group_of(mesh, "tp")) if tp > 1 else 0
    out = {}
    for k, v in params.items():
        v = v.detach()
        if _tp_sharded(v.shape, tp):
            B = v.shape[1] // tp
            v = v[:, r * B:(r + 1) * B]
        out[k] = v.contiguous().clone().requires_grad_(True)
    return out


def stack_shards(trees: Sequence):
    """Stack per-rank trees (identical structure and shapes) along a new
    leading rank axis: tensors and arrays stacked, dicts, lists and tuples
    walked."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_shards([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_shards(list(xs)) for xs in zip(*trees))
    return torch.stack([torch.as_tensor(np.asarray(t)) if not
                        isinstance(t, Tensor) else t for t in trees])


def sample_sharded_batch(g: Graph, sampler, seed_shards, features, labels,
                         rank: Optional[int] = None, device="cuda"):
    """Host-side sampling of one padded block stack per rank.

    ``seed_shards`` is a (P, B) array of seed ids, one row per rank.  With
    ``rank`` (default: this process's rank) it returns that rank's
    (blocks, x, labels) on ``device``.  The sampler draws the rows in
    order, as the JAX function draws them on one host, so rank r first
    draws rows 0..r-1 and drops them: every rank gets the blocks that
    the JAX function stacks at its row."""
    if rank is None:
        rank = dist.get_rank()
    features, labels = np.asarray(features), np.asarray(labels)
    for seeds in seed_shards[:rank]:
        sampler.sample_blocks(g, seeds)
    blocks, input_nodes, seeds_out = sampler.sample_blocks(
        g, seed_shards[rank])
    blocks = [b.to(device) for b in blocks]
    x = torch.from_numpy(features[input_nodes]).to(device)
    y = torch.from_numpy(labels[seeds_out]).to(device)
    return blocks, x, y


def _nll(logits: Tensor, labels: Tensor) -> Tensor:
    logp = F.log_softmax(logits, -1)
    return -logp.gather(-1, labels[:, None].long())[:, 0]


def make_sampled_dp_step(model, tx, mesh=None, axis: str = "node"):
    """Data-parallel sampled training: ``step(blocks, x, labels) -> loss``
    on this rank's blocks; the gradients are averaged over the ranks (one
    all_reduce) and ``tx`` (a ``torch.optim`` optimizer over the model's
    parameters, equal on every rank) steps.  Returns the mean of the
    ranks' losses."""
    group = coll.group_of(mesh, axis)

    def step(blocks: List[Graph], x: Tensor, labels: Tensor) -> Tensor:
        tx.zero_grad(set_to_none=True)
        loss = _nll(model(blocks, x), labels).mean()
        loss.backward()
        coll.all_reduce_grads(model.parameters(), group, mean=True)
        tx.step()
        return coll.all_reduce_sum(loss, group) / coll.world(group)

    return step


def make_spmd_train_step(model, tx, mesh, model_args: tuple = ()):
    """The full-graph training step over the mesh: ``step(params, g,
    feats, labels, mask, generator=None) -> loss``.

    ``params`` come from ``shard_params`` (``tx`` a ``torch.optim``
    optimizer over their values), ``g`` from ``shard_graph``, ``feats``,
    ``labels`` and ``mask`` from ``shard_rows``.  The step gathers the
    graph (once), the rows and the column-sharded weights, runs the
    model's forward (``torch.func.functional_call``, with
    ``deterministic=False`` and ``generator`` for dropout) and takes the
    masked cross-entropy's share of this rank's rows: the 'node' block
    of the rank, split over its 'tp' ranks, so the shares of all ranks sum
    to the JAX step's loss.  Gradients are all-reduced over 'node'; a
    column-sharded weight's are reduce-scattered to their owners over
    'tp', a replicated one's all-reduced there.  Returns the loss summed
    over the ranks."""
    from torch.func import functional_call
    node_g = coll.group_of(mesh, "node")
    tp_g = coll.group_of(mesh, "tp")
    P_node, P_tp = coll.world(node_g), coll.world(tp_g)
    r_node, r_tp = coll.rank(node_g), coll.rank(tp_g)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}

    def step(params: Dict[str, Tensor], g: ShardedGraph, feats: Sharded,
             labels: Sharded, mask: Sharded,
             generator: Optional[torch.Generator] = None) -> Tensor:
        tx.zero_grad(set_to_none=True)
        full = {}
        for k, p in params.items():
            v = p.detach()
            if _tp_sharded(shapes[k], P_tp):
                v = coll.all_gather(v.t().contiguous(), tp_g).t()
            full[k] = v.contiguous().requires_grad_(True)
        x, y, m = feats.full(), labels.full(), mask.full()
        logits = functional_call(model, full, (g.full(), *model_args, x),
                                 {"deterministic": False,
                                  "generator": generator})
        N = logits.shape[0]
        Bn = math.ceil(N / P_node)
        n0, n1 = min(r_node * Bn, N), min((r_node + 1) * Bn, N)
        Bt = math.ceil((n1 - n0) / P_tp)
        lo, hi = min(n0 + r_tp * Bt, n1), min(n0 + (r_tp + 1) * Bt, n1)
        mf = m.to(logits.dtype)
        share = (_nll(logits[lo:hi], y[lo:hi]) * mf[lo:hi]).sum() \
            / mf.sum().clamp(min=1.0)
        grads = torch.autograd.grad(share, list(full.values()),
                                    allow_unused=True)
        for (k, p), gk in zip(params.items(), grads):
            gk = torch.zeros_like(full[k]) if gk is None else gk
            dist.all_reduce(gk, group=node_g)
            if _tp_sharded(shapes[k], P_tp):
                gk = coll.reduce_scatter(gk.t().contiguous(), tp_g).t()
            else:
                dist.all_reduce(gk, group=tp_g)
            p.grad = gk.contiguous()
        tx.step()
        total = share.detach().clone()
        dist.all_reduce(total)
        return total

    return step
