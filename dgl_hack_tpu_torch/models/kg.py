"""Knowledge-graph embeddings (DGL-KE), as ``dgl_hack_tpu.models.kg``
(reference: apps/kg: KEModel, apps/kg/models/general_models.py:52; score
functions apps/kg/models/pytorch/score_fun.py; chunked negative sampling
apps/kg/dataloader/sampler.py:383,422).

Scores are computed in DGL-KE's chunked layout: positives (B,), negatives
(num_chunks, chunk_size, neg_sample_size) as batched products and
distances (``torch.matmul``/``einsum``, as the JAX package computes them
outside any Pallas kernel).  The tables are plain tensors in a dict
(``{"entity", "relation"}``), on the card unless the caller asks for the
CPU; ``KEModel`` draws them from an explicit ``torch.Generator``.

Two trainers, as in the JAX package:

* ``make_train_step`` with ``adagrad(lr)``: dense gradients of both
  tables under optax's Adagrad rule (accumulators start at 0.1; the
  update is ``g * rsqrt(sum + 1e-7)`` where the sum is positive, else 0),
  which is not ``torch.optim.Adagrad``'s;
* ``make_sparse_train_step``: the gradients of the gathered rows only,
  coalesced (duplicate rows summed before squaring) and applied by the
  reference's sparse-row Adagrad (``ExternalEmbedding.update``: one
  accumulator a row, ``(g*g).mean(-1)``, ``g / (sqrt(sum) + 1e-10)``),
  optionally one step stale (``async_update``).

Every step updates the tables and the optimizer state in place and
returns them, with the loss as a 0-d tensor: nothing in a step waits for
the card.  ``neg_is_head`` is a Python bool (the JAX package's is a
traced one, computed over both branches and selected).

``predict_all_tails`` scores every entity against the unbroadcast table
(one ``(B, D) @ (D, N)`` product for l2 and the dot-product scores, chunks
of entities for l1, RotatE and TransR), where the JAX function
broadcasts the table to ``(B, N, D)`` and lets XLA fuse the copy away.

``KEModel.shard(mesh)`` row-shards the entity table over the ranks of the
mesh's first dimension (the JAX package's ``P(axis, None)``), the
relation table replicated: each rank keeps its block of rows, and both
trainers all-gather the table (23.9 MB at FB15k's 14,951 x 400), run the
step on it, and update their own rows only, so the shards hold what the
unsharded step gives.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# elements of one (B, chunk, D) difference in ``predict_all_tails``
_ALL_TAILS_ELEMS = 1 << 25


# ---------------------------------------------------------------------------
# score functions: positive (per-edge), chunked-negative and all-entity forms
# (reference: score_fun.py edge_func / create_neg per class)
# ---------------------------------------------------------------------------
def batched_l2_dist(a: Tensor, b: Tensor) -> Tensor:
    """(C, m, D) x (C, n, D) -> (C, m, n) pairwise l2 (reference:
    score_fun.py:26's baddbmm form: one batched product)."""
    a2 = (a * a).sum(-1)
    b2 = (b * b).sum(-1)
    sq = a2[..., :, None] - 2 * torch.matmul(a, b.transpose(-1, -2)) \
        + b2[..., None, :]
    return torch.sqrt(sq.clamp_min(1e-30))


def batched_l1_dist(a: Tensor, b: Tensor) -> Tensor:
    return (a[..., :, None, :] - b[..., None, :, :]).abs().sum(-1)


def _l2_all(q: Tensor, ent: Tensor) -> Tensor:
    """(B, D) x (N, D) -> (B, N) l2 distances, one product."""
    sq = (q * q).sum(-1)[:, None] - 2 * q @ ent.T + (ent * ent).sum(-1)
    return torch.sqrt(sq.clamp_min(1e-30))


def _by_entity_chunks(fn: Callable[[Tensor], Tensor], ent: Tensor,
                      per_entity: int) -> Tensor:
    """``fn(ent[chunk]) -> (B, chunk)`` over chunks of the entity table
    whose intermediate holds about ``_ALL_TAILS_ELEMS`` elements
    (``per_entity`` of them an entity), concatenated to (B, N)."""
    step = max(1, _ALL_TAILS_ELEMS // max(per_entity, 1))
    return torch.cat([fn(ent[i:i + step])
                      for i in range(0, ent.shape[0], step)], dim=1)


def _split(x: Tensor):
    d = x.shape[-1] // 2
    return x[..., :d], x[..., d:]


class ScoreFunction(NamedTuple):
    """pos(head, rel, tail) -> (B,); neg_head/neg_tail score chunked
    negatives: (pos ents (C, S, D), rels (C, S, Dr), neg ents (C, N, D))
    -> (C, S, N); all_tails(heads (B, D), rels (B, Dr), entity table
    (N, D)) -> (B, N), the same function as neg_tail with every entity a
    negative of every row."""
    pos: Callable
    neg_head: Callable
    neg_tail: Callable
    all_tails: Callable
    relation_dim_mult: int = 1


def transe_score(gamma: float, dist: str = "l2") -> ScoreFunction:
    ndist = batched_l2_dist if dist == "l2" else batched_l1_dist
    order = 2 if dist == "l2" else 1

    def pos(h, r, t):
        return gamma - torch.linalg.vector_norm(h + r - t, ord=order, dim=-1)

    def neg_tail(h, r, t_neg):
        return gamma - ndist(h + r, t_neg)

    def neg_head(t, r, h_neg):
        return gamma - ndist(t - r, h_neg)

    def all_tails(h, r, ent):
        q = h + r
        if dist == "l2":
            return gamma - _l2_all(q, ent)
        return gamma - _by_entity_chunks(
            lambda e: (q[:, None, :] - e[None]).abs().sum(-1), ent,
            q.shape[0] * q.shape[1])

    return ScoreFunction(pos, neg_head, neg_tail, all_tails)


def distmult_score() -> ScoreFunction:
    def pos(h, r, t):
        return (h * r * t).sum(-1)

    def neg_tail(h, r, t_neg):
        return torch.matmul(h * r, t_neg.transpose(-1, -2))

    def neg_head(t, r, h_neg):
        return torch.matmul(t * r, h_neg.transpose(-1, -2))

    def all_tails(h, r, ent):
        return (h * r) @ ent.T

    return ScoreFunction(pos, neg_head, neg_tail, all_tails)


def complex_score() -> ScoreFunction:
    """ComplEx (reference: score_fun.py ComplExScore): emb = [re || im]."""
    def pos(h, r, t):
        hr, hi = _split(h)
        rr, ri = _split(r)
        tr, ti = _split(t)
        return ((hr * rr - hi * ri) * tr + (hr * ri + hi * rr) * ti).sum(-1)

    def rotated(h, r):
        hr, hi = _split(h)
        rr, ri = _split(r)
        return torch.cat([hr * rr - hi * ri, hr * ri + hi * rr], -1)

    def neg_tail(h, r, t_neg):
        return torch.matmul(rotated(h, r), t_neg.transpose(-1, -2))

    def neg_head(t, r, h_neg):
        tr, ti = _split(t)
        rr, ri = _split(r)
        q = torch.cat([tr * rr + ti * ri, ti * rr - tr * ri], -1)
        return torch.matmul(q, h_neg.transpose(-1, -2))

    def all_tails(h, r, ent):
        return rotated(h, r) @ ent.T

    return ScoreFunction(pos, neg_head, neg_tail, all_tails)


def rescal_score(entity_dim: int, relation_dim: int) -> ScoreFunction:
    """RESCAL (reference: score_fun.py RESCALScore): r is a (D, D) matrix
    flattened in the relation table."""
    def mat(r):
        return r.reshape(r.shape[:-1] + (entity_dim, entity_dim))

    def pos(h, r, t):
        return (h * torch.einsum("...ij,...j->...i", mat(r), t)).sum(-1)

    def neg_tail(h, r, t_neg):
        hr = torch.einsum("csi,csij->csj", h, mat(r))
        return torch.matmul(hr, t_neg.transpose(-1, -2))

    def neg_head(t, r, h_neg):
        tr = torch.einsum("csij,csj->csi", mat(r), t)
        return torch.matmul(tr, h_neg.transpose(-1, -2))

    def all_tails(h, r, ent):
        return torch.einsum("bi,bij->bj", h, mat(r)) @ ent.T

    return ScoreFunction(pos, neg_head, neg_tail, all_tails,
                         relation_dim_mult=entity_dim)


def rotate_score(gamma: float, emb_init: float) -> ScoreFunction:
    """RotatE (reference: score_fun.py RotatEScore): entity = [re || im],
    relation = phase."""
    def rot(h, r, sign=1.0):
        hr, hi = _split(h)
        phase = r / (emb_init / np.pi)
        rr, ri = torch.cos(phase), sign * torch.sin(phase)
        return hr * rr - hi * ri, hr * ri + hi * rr

    def dist(q, e):
        re, im = _split(q[..., :, None, :] - e[..., None, :, :])
        return torch.sqrt((re ** 2 + im ** 2).clamp_min(1e-30)).sum(-1)

    def pos(h, r, t):
        rr, ri = rot(h, r)
        tr, ti = _split(t)
        d = torch.sqrt(((rr - tr) ** 2 + (ri - ti) ** 2).clamp_min(1e-30))
        return gamma - d.sum(-1)

    def neg_tail(h, r, t_neg):
        return gamma - dist(torch.cat(rot(h, r), -1), t_neg)

    def neg_head(t, r, h_neg):
        # h ~ rot^{-1}(t): rotate t backwards by r
        return gamma - dist(torch.cat(rot(t, r, -1.0), -1), h_neg)

    def all_tails(h, r, ent):
        q = torch.cat(rot(h, r), -1)
        return gamma - _by_entity_chunks(lambda e: dist(q, e), ent,
                                         q.shape[0] * q.shape[1])

    return ScoreFunction(pos, neg_head, neg_tail, all_tails)


def transr_score(gamma: float, entity_dim: int,
                 relation_dim: int) -> ScoreFunction:
    """TransR (reference: score_fun.py TransRScore): entities projected
    into the relation space by a per-relation matrix before the TransE
    distance.  A relation row is ``[r (dr,) || projection (de * dr,)]``,
    so that the signature stays that of the other scores."""
    dr, de = relation_dim, entity_dim

    def split_r(r):
        return r[..., :dr], r[..., dr:].reshape(r.shape[:-1] + (de, dr))

    def pos(h, r, t):
        rv, pr = split_r(r)
        hp = torch.einsum("...e,...ed->...d", h, pr)
        tp = torch.einsum("...e,...ed->...d", t, pr)
        return gamma - (hp + rv - tp).abs().sum(-1)

    def neg_tail(h, r, t_neg):
        rv, pr = split_r(r)                          # (C,S,dr),(C,S,de,dr)
        hp = torch.einsum("cse,csed->csd", h, pr) + rv
        tp = torch.einsum("cne,csed->csnd", t_neg, pr)
        return gamma - (hp[:, :, None, :] - tp).abs().sum(-1)

    def neg_head(t, r, h_neg):
        rv, pr = split_r(r)
        tp = torch.einsum("cse,csed->csd", t, pr) - rv
        hp = torch.einsum("cne,csed->csnd", h_neg, pr)
        return gamma - (tp[:, :, None, :] - hp).abs().sum(-1)

    def all_tails(h, r, ent):
        rv, pr = split_r(r)                          # (B, dr), (B, de, dr)
        hp = torch.einsum("be,bed->bd", h, pr) + rv

        def chunk(e):
            tp = torch.einsum("ne,bed->bnd", e, pr)
            return (hp[:, None, :] - tp).abs().sum(-1)
        return gamma - _by_entity_chunks(chunk, ent, h.shape[0] * dr)

    return ScoreFunction(pos, neg_head, neg_tail, all_tails)


SCORE_FUNCS = {
    "TransE": lambda args: transe_score(args["gamma"], "l2"),
    "TransE_l1": lambda args: transe_score(args["gamma"], "l1"),
    "TransE_l2": lambda args: transe_score(args["gamma"], "l2"),
    "DistMult": lambda args: distmult_score(),
    "ComplEx": lambda args: complex_score(),
    "RESCAL": lambda args: rescal_score(args["hidden_dim"],
                                        args["hidden_dim"] ** 2),
    "RotatE": lambda args: rotate_score(args["gamma"], args["emb_init"]),
    "TransR": lambda args: transr_score(args["gamma"], args["hidden_dim"],
                                        args["hidden_dim"]),
}


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the "
                           "CPU")
    return device


# ---------------------------------------------------------------------------
# KEModel
# ---------------------------------------------------------------------------
def gather_entity(model: "KEModel", ent: Tensor) -> Tensor:
    """The whole entity table: ``ent`` itself, or, once the model is
    sharded, every rank's block of it gathered (not differentiable)."""
    sh = model.entity_shard
    return ent if sh is None else sh._replace(local=ent).full()


def _own_rows(sh, rows: Tensor, grads: Tensor):
    """(rows, grads) in this rank's block's row ids: rows it does not hold
    become row 0 with a zero gradient (no-ops)."""
    from ..parallel.collectives import rank
    B = sh.local.shape[0]
    lo = rows - rank(sh.group) * B
    mine = (lo >= 0) & (lo < B)
    return (torch.where(mine, lo, torch.zeros_like(lo)),
            grads * mine[:, None].to(grads.dtype))


class KEModel:
    """KEModel (reference: general_models.py:52): the score function and
    its tables.  ``params`` is ``{"entity": (num_entities, ent_dim),
    "relation": (num_relations, rel_dim)}`` on ``device``, drawn uniform
    in ``[-emb_init, emb_init)`` from ``torch.Generator().manual_seed(
    seed)`` on the CPU, so that one seed gives the same tables on either
    device.  Training uses DGL-KE's loss: the logsigmoid pairwise loss with
    optional self-adversarial negative weighting
    (general_models.py:371-399)."""

    def __init__(self, num_entities: int, num_relations: int,
                 hidden_dim: int, score_func: str = "TransE_l2",
                 gamma: float = 12.0, seed: int = 0, device="cuda"):
        self.device = _device(device)
        self.num_entities = num_entities
        self.num_relations = num_relations
        args = {"gamma": gamma, "hidden_dim": hidden_dim,
                "emb_init": (gamma + 2.0) / hidden_dim}
        self.score = SCORE_FUNCS[score_func](args)
        self.score_name = score_func
        ent_dim = hidden_dim * (2 if score_func in ("ComplEx", "RotatE")
                                else 1)
        rel_dim = hidden_dim * (2 if score_func == "ComplEx" else 1)
        if score_func == "RESCAL":
            rel_dim = hidden_dim * hidden_dim
        if score_func == "TransR":
            # relation vector + flattened per-relation projection matrix
            rel_dim = hidden_dim + ent_dim * hidden_dim
        self.emb_init = args["emb_init"]
        self.entity_shard = None
        gen = torch.Generator().manual_seed(seed)
        self.params = {
            name: torch.empty(shape).uniform_(
                -self.emb_init, self.emb_init, generator=gen).to(self.device)
            for name, shape in (("entity", (num_entities, ent_dim)),
                                ("relation", (num_relations, rel_dim)))}

    def shard(self, mesh) -> None:
        """Row-shard the entity table over the ranks of ``mesh``'s first
        dimension (a ``DeviceMesh``; a process group, or None for the
        default group, is taken as it is): this rank keeps its row block
        of ``parallel.spmd.shard_rows``, the last block padded with zero
        rows; ``relation`` stays replicated (model parallelism for the
        embedding table, reference: KVStore partition_book)."""
        from ..parallel.spmd import shard_rows
        names = getattr(mesh, "mesh_dim_names", None)
        self.entity_shard = shard_rows(mesh, self.params["entity"],
                                       names[0] if names else "node")
        self.params = {"entity": self.entity_shard.local,
                       "relation": self.params["relation"]}

    # -- loss ---------------------------------------------------------------
    def loss_fn(self, params, heads, rels, tails, neg_ents,
                neg_is_head: bool, chunk_size: int,
                neg_adversarial_sampling: bool = False,
                adversarial_temperature: float = 1.0,
                regularization_coef: float = 0.0) -> Tensor:
        """heads/rels/tails (B,); neg_ents (C, N); B = C * chunk_size."""
        ent, rel = params["entity"], params["relation"]
        return self.loss_from_rows(
            ent[heads.long()], rel[rels.long()], ent[tails.long()],
            ent[neg_ents.long()], neg_is_head, chunk_size,
            neg_adversarial_sampling, adversarial_temperature,
            regularization_coef)

    def loss_from_rows(self, h, r, t, nc, neg_is_head: bool,
                       chunk_size: int,
                       neg_adversarial_sampling: bool = False,
                       adversarial_temperature: float = 1.0,
                       regularization_coef: float = 0.0) -> Tensor:
        """The loss on gathered embedding rows: its gradients with respect
        to the rows are the sparse per-row gradients that the reference's
        ``ExternalEmbedding.update`` consumes."""
        pos_score = self.score.pos(h, r, t)                        # (B,)
        C, S = nc.shape[0], chunk_size
        hc, rc, tc = (x.reshape(C, S, -1) for x in (h, r, t))
        neg_score = self.score.neg_head(tc, rc, nc) if bool(neg_is_head) \
            else self.score.neg_tail(hc, rc, nc)                   # (C, S, N)
        pos_l = F.logsigmoid(pos_score)
        if neg_adversarial_sampling:
            w = torch.softmax(neg_score * adversarial_temperature,
                              dim=-1).detach()
            neg_l = (w * F.logsigmoid(-neg_score)).sum(-1)
        else:
            neg_l = F.logsigmoid(-neg_score).mean(-1)
        loss = -(pos_l.mean() + neg_l.mean()) / 2
        if regularization_coef > 0:
            reg = (h.abs() ** 3).mean() + (t.abs() ** 3).mean() \
                + (r.abs() ** 3).mean()
            loss = loss + regularization_coef * reg
        return loss

    # -- evaluation ---------------------------------------------------------
    def predict_all_tails(self, params, heads, rels) -> Tensor:
        """(B, num_entities) scores against every entity: eval ranking."""
        ent, rel = params["entity"], params["relation"]
        return self.score.all_tails(ent[heads.long()], rel[rels.long()], ent)


@torch.no_grad()
def eval_ranks(model: KEModel, params, heads, rels, tails,
               filter_dict=None, batch: int = 512) -> Dict[str, float]:
    """MRR / MR / HITS@k for tail prediction (reference: apps/kg eval.py
    protocol; 'raw' setting unless ``filter_dict`` is given).  The triples
    are numpy arrays; the scores are computed on the tables' device."""
    dev = params["entity"].device
    ranks = []
    n = len(heads)
    for i in range(0, n, batch):
        hb = torch.as_tensor(np.asarray(heads[i:i + batch]), device=dev)
        rb = torch.as_tensor(np.asarray(rels[i:i + batch]), device=dev)
        tb = np.asarray(tails[i:i + batch])
        scores = model.predict_all_tails(params, hb, rb).cpu().numpy()
        if filter_dict is not None:
            for j in range(len(tb)):
                known = filter_dict.get((int(heads[i + j]),
                                         int(rels[i + j])), ())
                mask = [k for k in known if k != tb[j]]
                scores[j, mask] = -np.inf
        target = scores[np.arange(len(tb)), tb]
        ranks.append((scores > target[:, None]).sum(1) + 1)
    ranks = np.concatenate(ranks).astype(np.float64)
    return {"MRR": float((1.0 / ranks).mean()),
            "MR": float(ranks.mean()),
            "HITS@1": float((ranks <= 1).mean()),
            "HITS@3": float((ranks <= 3).mean()),
            "HITS@10": float((ranks <= 10).mean())}


# ---------------------------------------------------------------------------
# dense training under optax's Adagrad rule
# ---------------------------------------------------------------------------
class Adagrad(NamedTuple):
    """``optax.adagrad(lr)``: accumulators start at
    ``initial_accumulator_value``; a step adds g², then moves each
    parameter by ``-lr * g * rsqrt(sum + eps)`` where the sum is positive
    (0 elsewhere)."""
    lr: float
    initial_accumulator_value: float = 0.1
    eps: float = 1e-7

    def init(self, params) -> Dict[str, Tensor]:
        return {k: torch.full_like(v, self.initial_accumulator_value)
                for k, v in params.items()}

    @torch.no_grad()
    def update(self, params, grads, state) -> None:
        """Apply one step to ``params`` and ``state`` in place."""
        for k, g in grads.items():
            acc = state[k].addcmul_(g, g)
            inv = torch.where(acc > 0, torch.rsqrt(acc + self.eps),
                              torch.zeros((), device=acc.device))
            params[k].add_((inv * g) * (-self.lr))


def adagrad(lr: float, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> Adagrad:
    return Adagrad(lr, initial_accumulator_value, eps)


def make_train_step(model: KEModel, tx: Adagrad, chunk_size: int,
                    neg_adversarial_sampling: bool = False,
                    adversarial_temperature: float = 1.0,
                    regularization_coef: float = 0.0):
    """``step(params, opt_state, heads, rels, tails, neg_ents,
    neg_is_head) -> (params, opt_state, loss)``: dense gradients of both
    tables, ``tx`` applied in place."""
    def step(params, opt_state, heads, rels, tails, neg_ents, neg_is_head):
        sh = model.entity_shard
        p = {k: (gather_entity(model, v) if k == "entity" else v)
             .detach().requires_grad_(True) for k, v in params.items()}
        loss = model.loss_fn(p, heads, rels, tails, neg_ents, neg_is_head,
                             chunk_size, neg_adversarial_sampling,
                             adversarial_temperature, regularization_coef)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        if sh is not None:         # this rank's block of the gradient
            from ..parallel.spmd import shard_rows
            grads["entity"] = shard_rows(sh.group, grads["entity"]).local
        tx.update(params, grads, opt_state)
        return params, opt_state, loss.detach()
    return step


# ---------------------------------------------------------------------------
# Sparse-row Adagrad (reference: ExternalEmbedding,
# apps/kg/models/pytorch/tensor_models.py: grad_sum = (g*g).mean(1),
# emb[idx] -= lr * g / (sqrt(state[idx]) + 1e-10)) with the fork's
# --async_update semantics (one-step-stale application overlapped with
# the next batch, general_models.py:474-479 async_update processes)
# ---------------------------------------------------------------------------
def init_sparse_state(model: KEModel) -> Dict[str, Tensor]:
    """Per-row Adagrad accumulators for both embedding tables."""
    ent = model.params["entity"]
    return {"ent_sum": torch.zeros(ent.shape[0], device=ent.device),
            "rel_sum": torch.zeros(model.num_relations, device=ent.device)}


def _coalesce(rows: Tensor, grads: Tensor):
    """Sum gradient rows with duplicate indices (the analogue of torch
    sparse-tensor coalescing the reference relies on), at a static length
    and without a host sync: returns (rows, grads) of ``rows``' length,
    the unique rows in increasing order first, then (row 0, zero
    gradient) no-ops."""
    from ..ops.segment import segment_max, segment_sum
    K = rows.shape[0]
    rs, order = torch.sort(rows.long(), stable=True)
    gs = grads[order]
    new = torch.ones(K, dtype=torch.bool, device=rows.device)
    new[1:] = rs[1:] != rs[:-1]
    sid = torch.cumsum(new, 0) - 1
    gco = segment_sum(gs, sid, K)
    rco = segment_max(rs, sid, K)        # empty slots: the int64 minimum
    return rco.clamp_min(0), gco


@torch.no_grad()
def _adagrad_rows(table: Tensor, state_sum: Tensor, rows: Tensor,
                  grads: Tensor, lr: float) -> None:
    rows, grads = _coalesce(rows, grads)
    state_sum.index_add_(0, rows, (grads * grads).mean(-1))
    std = torch.sqrt(state_sum[rows]) + 1e-10
    table.index_add_(0, rows, -lr * grads / std[:, None])


def make_sparse_train_step(model: KEModel, lr: float, chunk_size: int,
                           neg_adversarial_sampling: bool = False,
                           adversarial_temperature: float = 1.0,
                           regularization_coef: float = 0.0,
                           async_update: bool = False):
    """DGL-KE-style sparse-row Adagrad train step.

    Gradients exist only for the rows a batch touches; the update
    scatters them into the tables like the reference's
    ``ExternalEmbedding.update``.  With ``async_update=True`` the step
    returns this batch's row updates as ``pending`` and applies the
    PREVIOUS call's ``pending`` first: one step of staleness, the reading
    of the fork's asynchronous updater processes.

    Returns ``step(params, state, heads, rels, tails, neg_ents,
    neg_is_head[, pending]) -> (params, state, loss[, pending])`` and,
    for the async form, ``empty_pending(batch_size, neg_shape, ent_dim,
    rel_dim)``, whose zero rows are no-ops.
    """
    def compute(params, heads, rels, tails, neg_ents, neg_is_head):
        ent, rel = gather_entity(model, params["entity"]), params["relation"]
        heads, rels, tails, neg_ents = (x.long() for x in
                                        (heads, rels, tails, neg_ents))
        rows = [ent[heads], rel[rels], ent[tails], ent[neg_ents]]
        rows = [x.detach().requires_grad_(True) for x in rows]
        loss = model.loss_from_rows(
            *rows, neg_is_head, chunk_size, neg_adversarial_sampling,
            adversarial_temperature, regularization_coef)
        gh, gr, gt, gn = torch.autograd.grad(loss, rows)
        ent_rows = torch.cat([heads, tails, neg_ents.reshape(-1)])
        ent_grads = torch.cat([gh, gt, gn.reshape(-1, gn.shape[-1])])
        return loss.detach(), (ent_rows, ent_grads, rels, gr)

    def apply(params, state, upd):
        ent_rows, ent_grads, rel_rows, rel_grads = upd
        if model.entity_shard is not None:
            ent_rows, ent_grads = _own_rows(model.entity_shard, ent_rows,
                                            ent_grads)
        _adagrad_rows(params["entity"], state["ent_sum"], ent_rows,
                      ent_grads, lr)
        _adagrad_rows(params["relation"], state["rel_sum"], rel_rows,
                      rel_grads, lr)

    if not async_update:
        def step(params, state, heads, rels, tails, neg_ents, neg_is_head):
            loss, upd = compute(params, heads, rels, tails, neg_ents,
                                neg_is_head)
            apply(params, state, upd)
            return params, state, loss
        return step

    def step_async(params, state, heads, rels, tails, neg_ents,
                   neg_is_head, pending):
        apply(params, state, pending)
        loss, upd = compute(params, heads, rels, tails, neg_ents,
                            neg_is_head)
        return params, state, loss, upd

    def empty_pending(batch_size: int, neg_shape, ent_dim: int,
                      rel_dim: int):
        dev = model.params["entity"].device
        k = batch_size * 2 + math.prod(neg_shape)
        return (torch.zeros(k, dtype=torch.long, device=dev),
                torch.zeros((k, ent_dim), device=dev),
                torch.zeros(batch_size, dtype=torch.long, device=dev),
                torch.zeros((batch_size, rel_dim), device=dev))

    return step_async, empty_pending


def save_emb(path_prefix: str, params) -> None:
    """numpy files (reference: general_models.py:150 save_emb), the JAX
    package's names: ``<prefix>.entity.npy``, ``<prefix>.relation.npy``."""
    for name in ("entity", "relation"):
        np.save(f"{path_prefix}.{name}.npy",
                params[name].detach().cpu().numpy())


def load_emb(path_prefix: str, device="cuda") -> Dict[str, Tensor]:
    dev = _device(device)
    return {name: torch.from_numpy(np.load(f"{path_prefix}.{name}.npy"))
            .to(dev) for name in ("entity", "relation")}

