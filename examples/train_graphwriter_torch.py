"""GraphWriter-lite on the PyTorch port (twin of train_graphwriter.py; DGL:
examples/pytorch/graphwriter): a multi-head graph-transformer encoder over
small knowledge graphs feeding a GRU decoder with cross-attention, trained
to verbalise each graph's triples.

The synthetic KGs, the model and the loss are the JAX example's: per
encoder layer the attention logits are a u_dot_v gsddmm (on the card K6's
dot, D = dim / heads) plus a per-relation bias, normalised by edge_softmax
and aggregated by a u_mul_e gspmm with an (E, H, 1) weight (on the card
K1).  As in the JAX example, the relation ids are in user edge order while
the logits are in internal order, so each logit gets the bias of the edge
at its internal position in user order; the twin keeps that function.

Usage: python examples/train_graphwriter_torch.py --epochs 400
Runs on the GPU; ``--device cpu`` runs the kernels' plain versions on the
CPU instead.  With no card and no ``--device cpu`` it exits with an error.
``init_params`` draws the JAX example's shapes and scales from a numpy
seed (the JAX example draws from jax.random); ``train`` takes any
parameters as a flat dict of numpy arrays ("gru.Wz", "enc0.Wq", ...: what
``interop.flax_to_state_dict`` makes of the JAX example's tree), so the
tests start it from the JAX example's own.  ``make_kgs``, ``batch_graph``,
``edge_rels`` and ``train`` are the pieces ``chip_smoke.py`` drives.
"""
import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402

NE = 8          # entities per KG (tree-shaped: NE-1 triples)
NT = 20         # entity type vocab
NR = 6          # relation vocab
VOCAB = NT + NR + 2


def make_kgs(n, seed=0):
    """n synthetic KGs, drawn as the JAX example draws them: a random tree
    over NE entities, random types and relations; the target is BOS +
    [type_h, REL_r, type_t] per triple + EOS."""
    rng = np.random.default_rng(seed)
    BOS, EOS = NT + NR, NT + NR + 1
    srcs, dsts, rels, types, targets = [], [], [], [], []
    for _ in range(n):
        parent = np.array([rng.integers(0, max(k, 1)) for k in range(NE)])
        src = parent[1:].astype(np.int32)
        dst = np.arange(1, NE, dtype=np.int32)
        rel = rng.integers(0, NR, NE - 1).astype(np.int32)
        typ = rng.integers(0, NT, NE).astype(np.int32)
        seq = [BOS]
        for e in range(NE - 1):
            seq += [typ[src[e]], NT + rel[e], typ[dst[e]]]
        seq.append(EOS)
        srcs.append(src)
        dsts.append(dst)
        rels.append(rel)
        types.append(typ)
        targets.append(seq)
    return (np.stack(srcs), np.stack(dsts), np.stack(rels),
            np.stack(types), np.asarray(targets, np.int32))


def batch_graph(src, dst):
    """(B, NE-1) edges -> one batched bidirected graph with self-loops."""
    import dgl_hack_tpu_torch as dt
    B = src.shape[0]
    off = (np.arange(B, dtype=np.int32) * NE)[:, None]
    s = (src + off).reshape(-1)
    d = (dst + off).reshape(-1)
    loops = np.arange(B * NE, dtype=np.int32)
    return dt.graph((np.concatenate([s, d, loops]),
                     np.concatenate([d, s, loops])), num_nodes=B * NE)


def edge_rels(rel):
    """Per-edge relation ids in user order: forward relations, reversed
    ones (their own ids), the self-loop marker."""
    B = rel.shape[0]
    fwd = rel.reshape(-1)
    return np.concatenate([fwd, fwd + NR, np.full(B * NE, 2 * NR, np.int32)])


def init_params(dim=64, heads=4, seed=0):
    """The JAX example's parameters by name and shape: embeddings normal
    times 0.1, the relation bias 0, matrices glorot-uniform."""
    rng = np.random.default_rng(seed)
    D = dim

    def glorot(shape):
        lim = np.sqrt(6.0 / (shape[0] + shape[1]))
        return rng.uniform(-lim, lim, shape)

    prm = {"emb_type": 0.1 * rng.normal(size=(NT, D)),
           "emb_pos": 0.1 * rng.normal(size=(NE, D)),
           "emb_tok": 0.1 * rng.normal(size=(VOCAB, D)),
           "emb_step": 0.1 * rng.normal(size=(3 * (NE - 1) + 2, D)),
           "rel_bias": np.zeros((2 * NR + 1, heads)),
           "gru.Wz": glorot((2 * D, D)), "gru.Wr": glorot((2 * D, D)),
           "gru.Wh": glorot((2 * D, D)), "out": glorot((2 * D, VOCAB))}
    for li in range(2):
        for k, shape in (("Wq", (D, D)), ("Wk", (D, D)), ("Wv", (D, D)),
                         ("Wo", (D, D)), ("Wf", (D, 2 * D)),
                         ("Wf2", (2 * D, D))):
            prm[f"enc{li}.{k}"] = glorot(shape)
    return {k: v.astype(np.float32) for k, v in prm.items()}


def encode(prm, g, rel, types, heads):
    """Two graph-transformer layers over the batched KGs; (B * NE, D)."""
    import dgl_hack_tpu_torch as dt
    D = prm["emb_type"].shape[1]
    Dh = D // heads
    B = types.shape[0] // NE
    h = prm["emb_type"][types] + prm["emb_pos"].repeat(B, 1)
    for li in range(2):
        q = (h @ prm[f"enc{li}.Wq"]).reshape(-1, heads, Dh)
        k = (h @ prm[f"enc{li}.Wk"]).reshape(-1, heads, Dh)
        v = (h @ prm[f"enc{li}.Wv"]).reshape(-1, heads, Dh)
        logits = dt.gsddmm(g, "dot", k, q, "u", "v") / np.sqrt(Dh)
        logits = logits + prm["rel_bias"][rel][:, :, None]
        a = dt.edge_softmax(g, logits)                           # (E, H, 1)
        agg = dt.gspmm(g, "mul", "sum", v, a, "u", "e")          # (N, H, Dh)
        h = h + agg.reshape(-1, D) @ prm[f"enc{li}.Wo"]
        h = h + torch.relu(h @ prm[f"enc{li}.Wf"]) @ prm[f"enc{li}.Wf2"]
    return h


def decode(prm, enc_states, tokens):
    """Teacher-forced GRU with dense cross-attention over each sample's NE
    entity states; logits (B, L-1, VOCAB)."""
    B, L = tokens.shape
    D = enc_states.shape[-1]
    emb = prm["emb_tok"][tokens] + prm["emb_step"][None, :L]
    state = torch.zeros((B, D), dtype=emb.dtype, device=emb.device)
    outs = []
    for t in range(L - 1):
        x = emb[:, t]
        cat = torch.cat([state, x], -1)
        z = torch.sigmoid(cat @ prm["gru.Wz"])
        r = torch.sigmoid(cat @ prm["gru.Wr"])
        hh = torch.tanh(torch.cat([r * state, x], -1) @ prm["gru.Wh"])
        state = (1 - z) * state + z * hh
        att = torch.einsum("bd,bnd->bn", state, enc_states)
        att = torch.softmax(att / np.sqrt(D), dim=-1)
        ctx = torch.einsum("bn,bnd->bd", att, enc_states)
        outs.append(torch.cat([state, ctx], -1) @ prm["out"])
    return torch.stack(outs, 1)


def loss_fn(prm, g, rel, types, tokens, heads):
    """Mean token NLL and teacher-forced next-token accuracy."""
    D = prm["emb_type"].shape[1]
    enc = encode(prm, g, rel, types.reshape(-1), heads).reshape(-1, NE, D)
    logits = decode(prm, enc, tokens)
    tgt = tokens[:, 1:]
    logp = torch.log_softmax(logits, -1)
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    return nll.mean(), (logits.argmax(-1) == tgt).float().mean()


def train(params, train_kgs, *, heads=4, epochs=400, lr=3e-3,
          device="cuda", test_kgs=None):
    """Full-batch Adam from ``params`` (numpy arrays by flat name:
    ``init_params`` or the JAX example's).  ``train_kgs`` and ``test_kgs``
    are ``make_kgs`` results.  Returns the per-epoch losses, token
    accuracies and ms (each ended by a sync), the test loss and accuracy
    where a test set is given, and the trained parameters."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device; pass device='cpu' to "
                           "train on the CPU")
    prm = {k: torch.nn.Parameter(torch.tensor(np.asarray(v, np.float32),
                                              device=device))
           for k, v in params.items()}
    opt = torch.optim.Adam(prm.values(), lr=lr, eps=1e-8)

    def tensors(kgs):
        src, dst, rel, typ, tok = kgs
        return (batch_graph(src, dst).to(device),
                torch.as_tensor(edge_rels(rel), dtype=torch.int64,
                                device=device),
                torch.as_tensor(typ, dtype=torch.int64, device=device),
                torch.as_tensor(tok, dtype=torch.int64, device=device))
    batch = tensors(train_kgs)
    losses, accs, epoch_ms = [], [], []
    for _ in range(epochs):
        t0 = time.perf_counter()
        loss, acc = loss_fn(prm, *batch, heads)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        accs.append(float(acc))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        epoch_ms.append(1e3 * (time.perf_counter() - t0))
    res = {"losses": losses, "token_acc": accs, "epoch_ms": epoch_ms,
           "params": {k: v.detach().cpu().numpy() for k, v in prm.items()}}
    if test_kgs is not None:
        with torch.no_grad():
            tl, ta = loss_fn(prm, *tensors(test_kgs), heads)
        res.update(test_loss=float(tl), test_token_acc=float(ta))
    return res


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--train", type=int, default=512)
    p.add_argument("--test", type=int, default=128)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")
    t0 = time.time()
    res = train(init_params(args.dim, args.heads, args.seed),
                make_kgs(args.train, seed=args.seed), heads=args.heads,
                epochs=args.epochs, lr=args.lr, device=args.device,
                test_kgs=make_kgs(args.test, seed=args.seed + 1))
    print(json.dumps({
        "example": "graphwriter", "epochs": args.epochs,
        "train_loss": round(res["losses"][-1], 4),
        "train_token_acc": round(res["token_acc"][-1], 4),
        "test_token_acc": round(res["test_token_acc"], 4),
        "train_s": round(time.time() - t0, 1)}))


if __name__ == "__main__":
    main()
