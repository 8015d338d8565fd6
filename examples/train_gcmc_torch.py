"""GCMC-style rating prediction on the PyTorch port (twin of
train_gcmc.py; reference: examples/pytorch/gcmc): one relation per rating
level in both directions of a bipartite user-item heterograph, a
HeteroGraphConv encoder of GraphConv('right') layers and a bilinear decoder
over the rating classes.  The synthetic MovieLens-like world (latent
factors generating ratings, 25% observed) is the JAX example's, drawn from
the same numpy seed.  Each relation's GraphConv runs K1 on the card.

Usage: python examples/train_gcmc_torch.py --epochs 60
Runs on the GPU; ``--device cpu`` runs the kernels' plain versions on the
CPU instead.  With no card and no ``--device cpu`` it exits with an error.
``make_data``, ``GCMC`` and ``train`` are the pieces, for callers that
drive them themselves (``chip_smoke.py``, the tests); ``train`` starts from
parameters given as arrays (``interop.flax_to_state_dict`` of the JAX
example's) or from the layers' own initialisation under a seed.
"""
import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch import nn  # noqa: E402


def make_data(users=120, items=80, ratings=3):
    """The JAX example's world: the training heterograph (on the CPU) and
    the (user, item, rating) arrays of the training and test edges."""
    import dgl_hack_tpu_torch as dt
    rng = np.random.default_rng(0)
    NU, NI, R = users, items, ratings
    zu = rng.normal(size=(NU, 4))
    zi = rng.normal(size=(NI, 4))
    score = zu @ zi.T
    qs = np.quantile(score, np.linspace(0, 1, R + 1)[1:-1])
    rating = np.digitize(score, qs)           # (NU, NI) in [0, R)
    obs = rng.random((NU, NI)) < 0.25
    u_obs, i_obs = np.nonzero(obs)
    r_obs = rating[u_obs, i_obs]
    n = len(u_obs)
    perm = rng.permutation(n)
    tr, te = perm[:int(0.8 * n)], perm[int(0.8 * n):]
    data = {}
    for r in range(R):
        m = r_obs[tr] == r
        data[("user", f"rate{r}", "item")] = (u_obs[tr][m], i_obs[tr][m])
        data[("item", f"rev{r}", "user")] = (i_obs[tr][m], u_obs[tr][m])
    hg = dt.heterograph(data, num_nodes_dict={"user": NU, "item": NI})
    return (hg, (u_obs[tr], i_obs[tr], r_obs[tr]),
            (u_obs[te], i_obs[te], r_obs[te]))


class Encoder(nn.Module):
    """HeteroGraphConv('sum') over a GraphConv per relation.  The JAX
    example builds the GraphConvs in the encoder's scope before handing
    them to HeteroGraphConv, so flax names them ``GraphConv_0`` ... (rate0,
    rate1, ..., rev0, ...) under the encoder: the encoder holds them under
    those names, and the HeteroGraphConv that calls them is not a
    sub-module of its own (it has no parameters)."""

    def __init__(self, hidden, ratings):
        super().__init__()
        from dgl_hack_tpu_torch.nn import GraphConv, HeteroGraphConv
        names = [f"rate{r}" for r in range(ratings)] + \
            [f"rev{r}" for r in range(ratings)]
        mods = {}
        for i, et in enumerate(names):
            mods[et] = GraphConv(hidden, norm="right")
            self.add_module(f"GraphConv_{i}", mods[et])
        object.__setattr__(self, "hetero",
                           HeteroGraphConv(mods, aggregate="sum"))

    def forward(self, hg, feats):
        return {k: F.relu(v) for k, v in self.hetero(hg, feats).items()}


class Decoder(nn.Module):
    """Bilinear per rating class: ``Q`` (R, hidden, hidden),
    glorot-uniform with flax's fans."""

    def __init__(self, hidden, ratings):
        super().__init__()
        from dgl_hack_tpu_torch.nn.init import fans, glorot_uniform_
        shape = (ratings, hidden, hidden)
        self.Q = nn.Parameter(torch.empty(shape))
        glorot_uniform_(self.Q, *fans(shape))

    def forward(self, hu, hi, u, i):
        return torch.einsum("bh,rhk,bk->br", hu[u], self.Q, hi[i])


class GCMC(nn.Module):
    def __init__(self, hidden, ratings):
        super().__init__()
        self.Encoder_0 = Encoder(hidden, ratings)
        self.Decoder_0 = Decoder(hidden, ratings)

    def forward(self, hg, feats, u, i):
        h = self.Encoder_0(hg, feats)
        return self.Decoder_0(h["user"], h["item"], u, i)


def train(data, *, hidden=32, ratings=3, epochs=60, lr=1e-2, params=None,
          seed=0, device="cuda"):
    """Full-batch Adam on the rating cross-entropy over the training edges,
    one-hot node identities as features.  ``params``: a state dict (arrays)
    to start from, else the layers' initialisation under ``seed``.  Returns
    the per-epoch losses and ms, the test accuracy and RMSE of the expected
    rating, and the model."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device; pass device='cpu' to "
                           "train on the CPU")
    hg, trn, tst = data
    hg = hg.to(device)
    feats = {t: torch.eye(hg.num_nodes(t), device=device)
             for t in ("user", "item")}
    ut, it, rt = (torch.as_tensor(a, dtype=torch.int64, device=device)
                  for a in trn)
    torch.manual_seed(seed)
    model = GCMC(hidden, ratings).to(device)
    with torch.no_grad():
        model(hg, feats, ut, it)              # materialise the lazy layers
    if params is not None:
        model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                               for k, v in params.items()})
    opt = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)
    losses, epoch_ms = [], []
    for _ in range(epochs):
        t0 = time.perf_counter()
        loss = F.cross_entropy(model(hg, feats, ut, it), rt)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        epoch_ms.append(1e3 * (time.perf_counter() - t0))
    u_te, i_te, r_te = tst
    with torch.no_grad():
        logits = model(hg, feats, torch.as_tensor(u_te, device=device),
                       torch.as_tensor(i_te, device=device)).cpu()
    probs = torch.softmax(logits, -1).numpy()
    exp_rating = (probs * np.arange(ratings)).sum(-1)
    return {"losses": losses, "epoch_ms": epoch_ms,
            "test_acc": float((logits.argmax(-1).numpy() == r_te).mean()),
            "test_rmse": float(np.sqrt(((exp_rating - r_te) ** 2).mean())),
            "model": model}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--users", type=int, default=120)
    p.add_argument("--items", type=int, default=80)
    p.add_argument("--ratings", type=int, default=3)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")
    data = make_data(args.users, args.items, args.ratings)
    t0 = time.perf_counter()
    res = train(data, hidden=args.hidden, ratings=args.ratings,
                epochs=args.epochs, lr=args.lr, device=args.device)
    train_time = time.perf_counter() - t0
    print(json.dumps({"model": "GCMC", "epochs": args.epochs,
                      "test_acc": round(res["test_acc"], 4),
                      "test_rmse": round(res["test_rmse"], 4),
                      "train_time_s": round(train_time, 2)}))


if __name__ == "__main__":
    main()
