"""Distributed knowledge-graph embedding training over the key-value store
on the PyTorch port (twin of train_kg_dist.py; reference: apps/kg/
kvserver.py start_server:123, the KGEServer with a sparse-Adagrad push
handler; apps/kg/kvclient.py start_worker:189; models/general_models.py
pull_model:485 and push_gradient:502).

Servers hold range partitions of the entity table (the relations on
server 0) as numpy shards; each trainer client pulls a batch's rows on
the host, computes the loss and the gradients of the pulled rows on the
card (``KEModel.loss_from_rows``), and pushes the row gradients back to
the servers' Adagrad handler.  Servers and clients are threads of one
process over the in-process loopback transport, as in the JAX example;
the wire protocol is the same over TCP (``make_transports(base_port=
...)``).

Usage: python examples/train_kg_dist_torch.py --num_servers 2 --num_clients 2
Runs on the GPU; ``--device cpu`` runs on the CPU instead.  With no card
and no ``--device cpu`` it exits with an error.  No hand-written kernel
is on this path.  ``train`` is the loop, for callers that drive it
themselves (``chip_smoke.py``, the tests).
"""
import argparse
import json
import sys
import threading
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dgl_hack_tpu_torch.distributed import KVClient, KVServer  # noqa: E402


class KGEServer(KVServer):
    """Sparse-Adagrad push handler (reference: kvserver.py:35).  Its rule
    is the JAX example's own, ``g / sqrt(state + 1e-10)``, which differs
    from ``models.kg``'s ``g / (sqrt(state) + 1e-10)``."""

    def __init__(self, server_id, num_clients, transport, lr):
        super().__init__(server_id, num_clients, transport=transport)
        self.lr = lr

    def _local_ids(self, name, ids):
        # *_grad pushes address the base table's partition
        base = name[:-5] if name.endswith("_grad") else name
        return super()._local_ids(base, ids)

    def _push_handler(self, name, local_ids, data):
        if name.endswith("_grad"):
            base = name[:-5]
            state = self._data[base + "_state"]
            np.add.at(state, local_ids, (data ** 2).mean(-1))
            scale = 1.0 / np.sqrt(state[local_ids] + 1e-10)
            np.add.at(self._data[base], local_ids,
                      -self.lr * data * scale[:, None])
        else:
            np.add.at(self._data[name], local_ids, data)


def train(ds, model_name="TransE_l2", hidden=64, gamma=12.0, lr=0.1,
          batch=512, neg=64, chunk=64, steps=200, num_servers=2,
          num_clients=2, params=None, device="cuda"):
    """The example's servers and clients on ``ds``.  ``params`` (numpy
    ``{"entity", "relation"}``) replaces the model's own draw.  Returns the
    model, the final tables (pulled by client 0, on ``device``), each
    client's per-step losses and train_time_s."""
    from dgl_hack_tpu_torch.distributed.kvstore import make_transports
    from dgl_hack_tpu_torch.models.kg import KEModel
    device = torch.device(device)
    model = KEModel(ds.num_entities, ds.num_relations, hidden,
                    score_func=model_name, gamma=gamma, device=device)
    if params is None:
        params = {k: v.cpu().numpy() for k, v in model.params.items()}
    ent0 = np.asarray(params["entity"], np.float32)
    rel0 = np.asarray(params["relation"], np.float32)
    NE = ds.num_entities
    S, C = num_servers, num_clients
    # range partition books (the reference builds them from a METIS
    # partition, kvclient.py:195-202; the synthetic ids carry no locality)
    bounds = np.linspace(0, NE, S + 1).astype(np.int64)
    ent_book = np.searchsorted(bounds[1:], np.arange(NE), side="right")
    rel_book = np.zeros(ds.num_relations, np.int64)   # relations on srv 0
    server_t, client_t = make_transports(S, C, base_port=0)

    def serve(i):
        sv = KGEServer(i, C, server_t(i), lr)
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        sv.init_data("entity", ent0[lo:hi].copy(), offset=lo)
        sv.init_data("entity_state", np.zeros(hi - lo, np.float32),
                     offset=lo)
        if i == 0:
            sv.init_data("relation", rel0.copy())
            sv.init_data("relation_state",
                         np.zeros(ds.num_relations, np.float32))
        sv.start()

    servers = [threading.Thread(target=serve, args=(i,), daemon=True)
               for i in range(S)]
    for t in servers:
        t.start()
    h_all, r_all, t_all = (np.asarray(x) for x in ds.train)

    def row_grads(rows, neg_is_head):
        """The loss and the gradients of the pulled rows, on ``device``."""
        rows = [torch.from_numpy(x).to(device).requires_grad_(True)
                for x in rows]
        loss = model.loss_from_rows(*rows, neg_is_head, chunk)
        grads = torch.autograd.grad(loss, rows)
        return float(loss.detach()), [g.cpu().numpy() for g in grads]

    results, errors = {}, []

    def work(cid):
        try:
            rng = np.random.default_rng(100 + cid)
            client = KVClient(cid, S, transport=client_t(cid))
            for name, book in (("entity", ent_book), ("relation", rel_book)):
                client.set_partition_book(name, book)
                client.set_partition_book(name + "_grad", book)
            losses = []
            n_chunks = batch // chunk
            for step in range(steps):
                idx = rng.integers(0, len(h_all), batch)
                hb, rb, tb = h_all[idx], r_all[idx], t_all[idx]
                negs = rng.integers(0, NE, (n_chunks, neg)).astype(np.int64)
                rows = (client.pull("entity", hb), client.pull("relation", rb),
                        client.pull("entity", tb),
                        client.pull("entity", negs.reshape(-1))
                        .reshape(n_chunks, neg, -1))
                val, (gh, gr, gt, gn) = row_grads(rows, bool(step % 2))
                losses.append(val)
                client.push("entity_grad", hb, gh)
                client.push("entity_grad", tb, gt)
                client.push("entity_grad", negs.reshape(-1),
                            gn.reshape(n_chunks * neg, -1))
                client.push("relation_grad", rb, gr)
            results[cid] = losses
            client.barrier()
            if cid == 0:
                results["tables"] = {
                    "entity": client.pull("entity", np.arange(NE)),
                    "relation": client.pull("relation",
                                            np.arange(ds.num_relations))}
            client.shutdown()
        except Exception as e:       # raised after the threads end
            errors.append(e)

    t0 = time.perf_counter()
    clients = [threading.Thread(target=work, args=(i,)) for i in range(C)]
    for t in clients:
        t.start()
    for t in clients:
        t.join()
    train_time = time.perf_counter() - t0
    for t in servers:
        t.join(timeout=10)
    if errors:
        raise errors[0]
    tables = {k: torch.from_numpy(v).to(device)
              for k, v in results["tables"].items()}
    return {"model": model, "params": tables,
            "losses": [results[c] for c in range(C)],
            "train_time_s": train_time}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="FB15k")
    p.add_argument("--scale", type=float, default=0.05)
    p.add_argument("--model", default="TransE_l2")
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--gamma", type=float, default=12.0)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--neg", type=int, default=64)
    p.add_argument("--chunk", type=int, default=64)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--num_servers", type=int, default=2)
    p.add_argument("--num_clients", type=int, default=2)
    p.add_argument("--eval_triples", type=int, default=500)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")

    from dgl_hack_tpu_torch.data import synthetic_kg
    from dgl_hack_tpu_torch.models.kg import eval_ranks

    ds = synthetic_kg(args.dataset, scale=args.scale, seed=0)
    res = train(ds, args.model, args.hidden, args.gamma, args.lr, args.batch,
                args.neg, args.chunk, args.steps, args.num_servers,
                args.num_clients, device=args.device)
    losses = res["losses"][0]
    te = ds.test
    k = min(args.eval_triples, len(te[0]))
    metrics = eval_ranks(res["model"], res["params"], te[0][:k], te[1][:k],
                         te[2][:k])
    print(json.dumps({
        "dataset": ds.name, "model": args.model, "steps": args.steps,
        "num_servers": args.num_servers, "num_clients": args.num_clients,
        "loss_first10": round(float(np.mean(losses[:10])), 4),
        "loss_last10": round(float(np.mean(losses[-10:])), 4),
        "mrr": round(metrics["MRR"], 4),
        "hits10": round(metrics["HITS@10"], 4),
        "train_time_s": round(res["train_time_s"], 2)}))


if __name__ == "__main__":
    main()
