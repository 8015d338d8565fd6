"""metapath2vec on the PyTorch port (twin of train_metapath2vec.py):
skip-gram with negative sampling over metapath random walks on a
user-item heterograph (DGL: examples/pytorch/metapath2vec).

The walks run on the host (``sampling.metapath_random_walk``, the JAX
package's draws); the skip-gram step is two embedding gathers, a loss and
Adam on the device.  The graph, the walks, the batch order and the
negatives come from one numpy generator seeded as in the JAX example, so
both draw the same pairs; the embeddings start from their own seed.

Usage: python examples/train_metapath2vec_torch.py --epochs 5
Runs on the GPU; ``--device cpu`` runs on the CPU instead.  With no card
and no ``--device cpu`` it exits with an error.  ``make_data``,
``walk_pairs``, ``init_params`` and ``train`` are the steps, for callers
that drive them themselves.
"""
import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402


def make_data(num_users, num_items, rng, num_areas=3):
    """The JAX example's user-item heterograph: users interact mostly with
    items of their own area.  Returns (heterograph, user areas)."""
    import dgl_hack_tpu_torch as dt
    area_u = rng.integers(0, num_areas, num_users)
    area_i = rng.integers(0, num_areas, num_items)
    src, dst = [], []
    for u in range(num_users):
        pool = np.nonzero(area_i == area_u[u])[0]
        k = min(5, len(pool))
        for it in rng.choice(pool, size=k, replace=False):
            src.append(u)
            dst.append(int(it))
        if rng.random() < 0.3:
            src.append(u)
            dst.append(int(rng.integers(0, num_items)))
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    hg = dt.heterograph({
        ("user", "ui", "item"): (src, dst),
        ("item", "iu", "user"): (dst, src),
    }, num_nodes_dict={"user": num_users, "item": num_items})
    return hg, area_u


def walk_pairs(hg, num_users, walk_length, walks_per_node, window, rng):
    """(center, context) pairs of the skip-gram windows over metapath
    walks (user-item-user ...) from every user, in one id space: users,
    then items."""
    from dgl_hack_tpu_torch.sampling import metapath_random_walk
    traces, types = metapath_random_walk(
        hg, ["ui", "iu"] * walk_length,
        np.tile(np.arange(num_users), walks_per_node), rng=rng)
    it_type = list(hg.ntypes).index("item")
    glob = traces + np.where(types == it_type, num_users, 0)[None, :]
    glob = np.where(traces < 0, -1, glob)
    pairs = []
    for row in glob:
        valid = row[row >= 0]
        for i in range(len(valid)):
            for j in range(max(0, i - window),
                           min(len(valid), i + window + 1)):
                if i != j:
                    pairs.append((valid[i], valid[j]))
    return np.asarray(pairs, np.int32)


def init_params(num_vocab, dim, seed=0):
    """Center and context embeddings, normal with std 0.1 (numpy)."""
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=(num_vocab, dim)) * 0.1).astype(np.float32)
            for k in ("center", "context")}


def train(pairs, params, num_vocab, *, epochs, lr, negatives, rng,
          batch_size=1024, device="cuda", max_steps=None):
    """Skip-gram with negative sampling over ``pairs``: each epoch a
    permutation from ``rng``, batches of ``batch_size`` (the last partial
    one dropped), ``negatives`` uniform context ids per pair from ``rng``,
    Adam.  Returns the per-step losses and the trained embeddings (numpy)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device; pass device='cpu' to "
                           "train on the CPU")
    emb = {k: torch.nn.Parameter(torch.as_tensor(v, device=device).clone())
           for k, v in params.items()}
    opt = torch.optim.Adam(emb.values(), lr=lr, eps=1e-8)
    losses = []
    for _ in range(epochs):
        perm = rng.permutation(len(pairs))
        for i in range(0, len(pairs) - batch_size + 1, batch_size):
            if max_steps is not None and len(losses) >= max_steps:
                break
            batch = torch.from_numpy(pairs[perm[i:i + batch_size]]).to(
                device).long()
            neg = torch.from_numpy(rng.integers(
                0, num_vocab, (batch_size, negatives)).astype(np.int64)).to(
                device)
            zc = emb["center"][batch[:, 0]]
            zp = emb["context"][batch[:, 1]]
            zn = emb["context"][neg]
            pos = F.logsigmoid((zc * zp).sum(-1))
            negl = F.logsigmoid(-(zc[:, None, :] * zn).sum(-1)).sum(-1)
            loss = -(pos + negl).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
    return {"losses": losses,
            "params": {k: v.detach().cpu().numpy() for k, v in emb.items()}}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--users", type=int, default=60)
    p.add_argument("--items", type=int, default=40)
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--walk_length", type=int, default=4)
    p.add_argument("--walks_per_node", type=int, default=10)
    p.add_argument("--window", type=int, default=2)
    p.add_argument("--negatives", type=int, default=5)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")

    rng = np.random.default_rng(0)
    hg, area_u = make_data(args.users, args.items, rng)
    pairs = walk_pairs(hg, args.users, args.walk_length,
                       args.walks_per_node, args.window, rng)
    num_vocab = args.users + args.items
    t0 = time.perf_counter()
    res = train(pairs, init_params(num_vocab, args.dim), num_vocab,
                epochs=args.epochs, lr=args.lr, negatives=args.negatives,
                rng=rng, device=args.device)
    train_time = time.perf_counter() - t0

    # do same-area users sit closer than cross-area users?
    z = res["params"]["center"][:args.users]
    z = z / (np.linalg.norm(z, axis=1, keepdims=True) + 1e-9)
    sims = z @ z.T
    same = area_u[:, None] == area_u[None, :]
    np.fill_diagonal(sims, np.nan)
    intra = np.nanmean(np.where(same, sims, np.nan))
    inter = np.nanmean(np.where(~same, sims, np.nan))
    print(json.dumps({"model": "metapath2vec", "epochs": args.epochs,
                      "intra_sim": round(float(intra), 4),
                      "inter_sim": round(float(inter), 4),
                      "separation": round(float(intra - inter), 4),
                      "train_time_s": round(train_time, 2)}))


if __name__ == "__main__":
    main()
