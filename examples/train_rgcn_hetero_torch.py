"""Heterograph R-GCN entity classification on the PyTorch port (twin of
train_rgcn_hetero.py): per-relation basis-projected copy_u-mean messages
through ``HeteroGraph.multi_update_all``, a cross-type sum, self-loop,
bias and activation, over learned per-ntype embeddings, predicting the
class of the ``paper`` nodes.

Usage: python examples/train_rgcn_hetero_torch.py --epochs 60
Runs on the GPU (each relation's mean through the segment-sum kernel);
``--device cpu`` runs the kernels' plain versions on the CPU instead.
With no card and no ``--device cpu`` it exits with an error.  The graph
is the JAX example's synthetic academic heterograph (paper, author and
subject nodes; relations carry the class signal), the same arrays for
the same seed.  ``synthetic_academic``, ``EntityClassify`` and ``train``
are importable for callers that drive the loop themselves
(``chip_smoke.py``).

Prints one JSON line: {"dataset", "test_acc", "epochs", "loss",
"train_time_s"}.
"""
import argparse
import json
import sys
import time
from typing import Dict, Sequence

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch import nn  # noqa: E402


def synthetic_academic(num_papers=400, num_authors=200, num_subjects=12,
                       num_classes=4, seed=0):
    """Papers have classes; authors specialise; subjects align with
    classes; citations are homophilous.  Returns (heterograph on the CPU,
    paper labels, train paper ids, test paper ids)."""
    import dgl_hack_tpu_torch as dt
    rng = np.random.default_rng(seed)
    pc = rng.integers(0, num_classes, num_papers)       # paper class
    ac = rng.integers(0, num_classes, num_authors)      # author specialty
    sc = np.arange(num_subjects) % num_classes          # subject class

    # author writes papers of their specialty 85% of the time
    w_src, w_dst = [], []
    for a in range(num_authors):
        for _ in range(4):
            if rng.random() < 0.85:
                cand = np.nonzero(pc == ac[a])[0]
            else:
                cand = np.arange(num_papers)
            w_src.append(a)
            w_dst.append(int(cand[rng.integers(0, len(cand))]))
    # paper cites same-class papers 80% of the time
    c_src, c_dst = [], []
    for p in range(num_papers):
        for _ in range(3):
            if rng.random() < 0.8:
                cand = np.nonzero(pc == pc[p])[0]
            else:
                cand = np.arange(num_papers)
            c_src.append(p)
            c_dst.append(int(cand[rng.integers(0, len(cand))]))
    # paper has_topic subject of its class 90% of the time
    t_src, t_dst = [], []
    for p in range(num_papers):
        if rng.random() < 0.9:
            cand = np.nonzero(sc == pc[p])[0]
        else:
            cand = np.arange(num_subjects)
        t_src.append(p)
        t_dst.append(int(cand[rng.integers(0, len(cand))]))

    hg = dt.heterograph({
        ("author", "writes", "paper"): (w_src, w_dst),
        ("paper", "written_by", "author"): (w_dst, w_src),
        ("paper", "cites", "paper"): (c_src, c_dst),
        ("paper", "cited_by", "paper"): (c_dst, c_src),
        ("paper", "has_topic", "subject"): (t_src, t_dst),
        ("subject", "topic_of", "paper"): (t_dst, t_src),
    }, num_nodes_dict={"paper": num_papers, "author": num_authors,
                       "subject": num_subjects})
    order = rng.permutation(num_papers)
    n_train = int(0.6 * num_papers)
    n_test = int(0.3 * num_papers)
    return hg, pc.astype(np.int32), order[:n_train], order[-n_test:]


def _glorot(shape) -> nn.Parameter:
    from dgl_hack_tpu_torch.nn.init import fans, glorot_uniform_
    return nn.Parameter(glorot_uniform_(torch.empty(shape), *fans(shape)))


class RelGraphConvLayer(nn.Module):
    """Per-relation projected copy_u-mean messages through
    multi_update_all, cross-type sum, self-loop, bias and activation.  The
    relation weights are basis-decomposed (``WeightBasis_0``) where
    ``num_bases`` is below the relation count, else one ``weight`` (R,
    in, out); ``loop_<ntype>`` (in, out) and ``h_bias``, the flax
    layer's names."""

    def __init__(self, in_feats: int, out_feats: int, ntypes: Sequence[str],
                 num_rels: int, num_bases: int, use_basis: bool = True,
                 activation: bool = False):
        super().__init__()
        from dgl_hack_tpu_torch.nn import WeightBasis
        self.out_feats = out_feats
        self.activation = activation
        if use_basis and num_bases < num_rels:
            self.WeightBasis_0 = WeightBasis((in_feats, out_feats),
                                             num_bases, num_rels)
        else:
            self.weight = _glorot((num_rels, in_feats, out_feats))
        for nt in ntypes:
            self.register_parameter(f"loop_{nt}",
                                    _glorot((in_feats, out_feats)))
        self.h_bias = nn.Parameter(torch.zeros(out_feats))

    def forward(self, hg, inputs: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        from dgl_hack_tpu_torch import fn
        W = self.WeightBasis_0() if hasattr(self, "WeightBasis_0") \
            else self.weight
        local = hg.local_var()
        etype_dict = {}
        for i, c in enumerate(local.canonical_etypes):
            st = c[0]
            if st not in inputs:
                continue
            local.nodes_data(st)[f"h{i}"] = inputs[st] @ W[i]
            etype_dict[c] = (fn.copy_u(f"h{i}", f"m{i}"),
                             fn.mean(f"m{i}", "agg"))
        local.multi_update_all(etype_dict, "sum")
        out = {}
        for nt, x in inputs.items():
            frame = local.nodes_data(nt)
            h = frame["agg"] if "agg" in frame else x.new_zeros(
                (local.num_nodes(nt), self.out_feats))
            h = h + x @ getattr(self, f"loop_{nt}") + self.h_bias
            out[nt] = F.relu(h) if self.activation else h
        return out


class EntityClassify(nn.Module):
    """Learned per-ntype inputs (``embed_<ntype>``, glorot-uniform) and two
    RelGraphConvLayers; returns the ``paper`` logits."""

    def __init__(self, hg, num_classes: int, embed: int = 16,
                 hidden: int = 24, num_bases: int = 4):
        super().__init__()
        self.ntypes = hg.ntypes
        for nt in self.ntypes:
            self.register_parameter(f"embed_{nt}",
                                    _glorot((hg.num_nodes(nt), embed)))
        R = len(hg.canonical_etypes)
        self.RelGraphConvLayer_0 = RelGraphConvLayer(
            embed, hidden, self.ntypes, R, num_bases, activation=True)
        self.RelGraphConvLayer_1 = RelGraphConvLayer(
            hidden, num_classes, self.ntypes, R, num_bases)

    def forward(self, hg) -> torch.Tensor:
        inputs = {nt: getattr(self, f"embed_{nt}") for nt in self.ntypes}
        h = self.RelGraphConvLayer_0(hg, inputs)
        return self.RelGraphConvLayer_1(hg, h)["paper"]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(hg, labels, train_idx, test_idx, *, epochs=60, lr=1e-2, embed=16,
          hidden=24, num_bases=4, seed=0, device="cuda"):
    """Build ``EntityClassify`` on the CPU from ``seed`` (the same weights
    on every device), move it and the graph to ``device`` and take
    ``epochs`` Adam steps on the train papers' cross-entropy.  Returns the
    per-step losses, the test accuracy, the model and the seconds of the
    steps (the first included, ended by a sync)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device; pass device='cpu' to "
                           "train on the CPU")
    torch.manual_seed(seed)
    num_classes = int(labels.max()) + 1
    model = EntityClassify(hg, num_classes, embed, hidden,
                           num_bases).to(device)
    hg = hg.to(device)
    y = torch.from_numpy(labels).long().to(device)
    tr = torch.from_numpy(np.asarray(train_idx)).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)
    losses = []
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(epochs):
        opt.zero_grad(set_to_none=True)
        logp = F.log_softmax(model(hg), -1)
        loss = -logp[tr].gather(-1, y[tr][:, None]).mean()
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    _sync(device)
    train_time = time.perf_counter() - t0
    with torch.no_grad():
        pred = model(hg).argmax(-1).cpu().numpy()
    return {"losses": [float(v) for v in losses], "model": model,
            "test_acc": float((pred[test_idx] == labels[test_idx]).mean()),
            "train_time_s": train_time}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--hidden", type=int, default=24)
    p.add_argument("--embed", type=int, default=16)
    p.add_argument("--num-bases", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--papers", type=int, default=400)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")

    hg, labels, train_idx, test_idx = synthetic_academic(
        num_papers=args.papers, seed=args.seed)
    res = train(hg, labels, train_idx, test_idx, epochs=args.epochs,
                lr=args.lr, embed=args.embed, hidden=args.hidden,
                num_bases=args.num_bases, seed=args.seed, device=args.device)
    print(json.dumps({"dataset": "academic-synth",
                      "test_acc": res["test_acc"], "epochs": args.epochs,
                      "loss": res["losses"][-1],
                      "train_time_s": res["train_time_s"]}))


if __name__ == "__main__":
    main()
