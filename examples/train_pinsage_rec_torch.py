"""PinSAGE item recommendation on the PyTorch port (twin of
train_pinsage_rec.py; DGL: examples/pytorch/recommendation, PinSage over
MovieLens with a BPR loss and sampled negatives).

``PinSAGESampler`` builds an item-item graph on the host from user-
mediated random walks, with the visit counts as edge weights; two
weighted-mean PinSAGE layers aggregate over it with gspmm (u_mul_e sum
and copy_rhs sum, the segment-sum kernel on the card); a user is the mean
of its items' embeddings; BPR loss over uniform negatives; evaluation
ranks each held-out item among ``--eval-negs`` sampled ones (HITS@10,
MRR).  The dataset is the JAX example's latent-factor MovieLens stand-in
(``synth_movielens``).

Usage: python examples/train_pinsage_rec_torch.py --epochs 60
       (MovieLens-1M's counts: --users 6040 --items 3706)
Runs on the GPU; ``--device cpu`` runs the kernels' plain versions on the
CPU instead.  With no card and no ``--device cpu`` it exits with an
error.  ``synth_movielens``, ``build``, ``init_params`` and ``train`` are
the steps, for callers that drive them themselves (``chip_smoke.py``).
"""
import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402


def synth_movielens(num_users=600, num_items=500, rank=8, per_user=12,
                    seed=0):
    """Latent-factor interactions, the JAX example's: each user 'watches'
    its top-scored items (plus noise), one held out per user.  Returns
    (train users, train items, test users, test items, users, items)."""
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(num_users, rank)) / rank ** 0.25
    V = rng.normal(size=(num_items, rank)) / rank ** 0.25
    scores = U @ V.T + 0.3 * rng.normal(size=(num_users, num_items))
    top = np.argsort(-scores, axis=1)[:, :per_user]
    users = np.repeat(np.arange(num_users), per_user)
    items = top.reshape(-1)
    test_sel = np.arange(num_users) * per_user + rng.integers(
        0, per_user, num_users)
    mask = np.zeros(len(users), bool)
    mask[test_sel] = True
    return (users[~mask].astype(np.int32), items[~mask].astype(np.int32),
            users[mask].astype(np.int32), items[mask].astype(np.int32),
            num_users, num_items)


def build(data, num_walks, num_neighbors):
    """The item-item PinSAGE graph and the users' item lists, on the host.
    Returns a dict: ``gi`` (Graph), ``wn`` (its edge weights scaled to mean
    1, as gspmm takes them: the sampler's graph is already in dst order),
    ``u_items``/``u_mask`` (each user's items, padded), the train pairs
    and the sampler's seconds."""
    import dgl_hack_tpu_torch as dt
    from dgl_hack_tpu_torch.sampling import PinSAGESampler
    tr_u, tr_i, _, _, NU, NI = data
    G = dt.heterograph({
        ("user", "watched", "item"): (tr_u, tr_i),
        ("item", "watched-by", "user"): (tr_i, tr_u),
    }, num_nodes_dict={"user": NU, "item": NI})
    t0 = time.perf_counter()
    sampler = PinSAGESampler(G, "item", "user", random_walk_length=2,
                             random_walk_restart_prob=0.2,
                             num_random_walks=num_walks,
                             num_neighbors=num_neighbors, seed=0)
    gi = sampler(np.arange(NI, dtype=np.int64))
    sample_s = time.perf_counter() - t0
    w = gi.edata["weights"].numpy().astype(np.float32)
    wn = w / np.maximum(w.sum(), 1.0) * len(w)
    deg = np.bincount(tr_u, minlength=NU)
    cap = int(deg.max())
    u_items = np.zeros((NU, cap), np.int32)
    u_mask = np.zeros((NU, cap), np.float32)
    pos = np.zeros(NU, np.int64)
    for u, i in zip(tr_u, tr_i):
        u_items[u, pos[u]] = i
        u_mask[u, pos[u]] = 1.0
        pos[u] += 1
    return {"gi": gi, "wn": wn, "u_items": u_items, "u_mask": u_mask,
            "tr_u": tr_u, "tr_i": tr_i, "num_items": NI,
            "sample_s": sample_s}


def init_params(num_items, hidden, seed=1):
    """The JAX example's initial parameters (numpy): item embeddings and
    the two layers' (2 * hidden, hidden) kernels."""
    rng0 = np.random.default_rng(seed)
    D = hidden
    return {
        "emb": rng0.normal(0, 0.1, (num_items, D)).astype(np.float32),
        "W1": (rng0.normal(size=(2 * D, D))
               * (2.0 / (3 * D)) ** 0.5).astype(np.float32),
        "W2": (rng0.normal(size=(2 * D, D))
               * (2.0 / (3 * D)) ** 0.5).astype(np.float32),
    }


def item_embs(gi, wn, params):
    """Two PinSAGE layers: weighted-mean aggregate, dense, relu, unit norm."""
    import dgl_hack_tpu_torch as dt
    h = params["emb"]
    for k in ("W1", "W2"):
        agg = dt.gspmm(gi, "mul", "sum", h, wn[:, None], "u", "e")
        norm = dt.gspmm(gi, "copy_rhs", "sum", None, wn[:, None], "u", "e")
        agg = agg / norm.clamp(min=1e-6)
        h = torch.relu(torch.cat([h, agg], 1) @ params[k])
        h = h / h.norm(dim=1, keepdim=True).clamp(min=1e-6)
    return h


def user_embs(items_h, u_items, u_mask):
    ue = (items_h[u_items] * u_mask[..., None]).sum(1)
    return ue / u_mask.sum(1, keepdim=True).clamp(min=1.0)


def train(built, params, *, epochs, lr, num_negs, device="cuda", seed=0,
          negatives=None, log=print):
    """BPR training of the PinSAGE item tower with Adam.  Each epoch draws
    ``num_negs`` negative items per train pair, from a torch generator
    seeded with ``seed``, or from ``negatives(epoch)`` where given.
    Returns the losses, per-epoch ms (each ended by a device sync) and the
    trained parameters (on ``device``)."""
    import dgl_hack_tpu_torch as dt
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device; pass device='cpu' to "
                           "train on the CPU")
    gi = dt.prepare_spmm(built["gi"].to(device))
    wn = torch.from_numpy(built["wn"]).to(device)
    u_items = torch.from_numpy(built["u_items"]).to(device).long()
    u_mask = torch.from_numpy(built["u_mask"]).to(device)
    tr_u = torch.from_numpy(built["tr_u"]).to(device).long()
    tr_i = torch.from_numpy(built["tr_i"]).to(device).long()
    prm = {k: torch.nn.Parameter(torch.as_tensor(v, device=device).clone())
           for k, v in params.items()}
    opt = torch.optim.Adam(prm.values(), lr=lr, eps=1e-8)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    NI = built["num_items"]
    losses, epoch_ms = [], []
    for ep in range(epochs):
        t0 = time.perf_counter()
        if negatives is None:
            negs = torch.randint(0, NI, (len(tr_u), num_negs),
                                 generator=gen, device=device)
        else:
            negs = torch.as_tensor(negatives(ep), device=device).long()
        h = item_embs(gi, wn, prm)
        ue = user_embs(h, u_items, u_mask)
        pos_s = (ue[tr_u] * h[tr_i]).sum(-1, keepdim=True)
        neg_s = torch.einsum("ud,und->un", ue[tr_u], h[negs])
        loss = -F.logsigmoid(pos_s - neg_s).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        epoch_ms.append(1e3 * (time.perf_counter() - t0))
        if log is not None and (ep + 1) % 20 == 0:
            log(f"epoch {ep+1:4d} loss {losses[-1]:.4f}")
    return {"losses": losses, "epoch_ms": epoch_ms, "params": prm, "gi": gi,
            "wn": wn}


def evaluate(built, res, te_u, te_i, eval_negs):
    """HITS@10 and MRR of each held-out item among ``eval_negs`` sampled
    negatives (the JAX example's generator, seed 2)."""
    dev = res["wn"].device
    with torch.no_grad():
        h = item_embs(res["gi"], res["wn"], res["params"])
        ue = user_embs(h, torch.from_numpy(built["u_items"]).to(dev).long(),
                       torch.from_numpy(built["u_mask"]).to(dev))
        te_u = torch.from_numpy(te_u).to(dev).long()
        te_i = torch.from_numpy(te_i).to(dev).long()
        negs = np.random.default_rng(2).integers(
            0, built["num_items"], (len(te_u), eval_negs))
        pos_s = (ue[te_u] * h[te_i]).sum(-1).cpu().numpy()
        neg_s = torch.einsum("ud,und->un", ue[te_u], h[torch.from_numpy(
            negs).to(dev)]).cpu().numpy()
    rank = 1 + (neg_s >= pos_s[:, None]).sum(1)
    return float((rank <= 10).mean()), float((1.0 / rank).mean())


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--num-neighbors", type=int, default=8)
    p.add_argument("--num-walks", type=int, default=20)
    p.add_argument("--lr", type=float, default=3e-2)
    p.add_argument("--num-negs", type=int, default=4)
    p.add_argument("--eval-negs", type=int, default=100)
    p.add_argument("--users", type=int, default=600)
    p.add_argument("--items", type=int, default=500)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")

    data = synth_movielens(args.users, args.items)
    built = build(data, args.num_walks, args.num_neighbors)
    t0 = time.perf_counter()
    res = train(built, init_params(built["num_items"], args.hidden),
                epochs=args.epochs, lr=args.lr, num_negs=args.num_negs,
                device=args.device,
                log=lambda s: print(s, flush=True))
    train_s = time.perf_counter() - t0
    hits10, mrr = evaluate(built, res, data[2], data[3], args.eval_negs)
    print(json.dumps({"dataset": "movielens-synth", "model": "pinsage",
                      "hits10": round(hits10, 4), "mrr": round(mrr, 4),
                      "train_time_s": round(train_s, 2)}))


if __name__ == "__main__":
    main()
