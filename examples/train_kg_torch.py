"""Knowledge-graph embedding training on the PyTorch port (twin of
train_kg.py; reference: apps/kg/train.py): the same flags, the same
batches from the same numpy seed (alternating head and tail corruption)
and the same final JSON line.

python examples/train_kg_torch.py --model_name TransE_l2 --dataset FB15k \
    --batch_size 1024 --neg_sample_size 256 --hidden_dim 400 \
    --gamma 19.9 --lr 0.25 --max_step 2000

Runs on the GPU; ``--device cpu`` runs on the CPU instead.  With no card
and no ``--device cpu`` it exits with an error.  Dense training applies
optax's Adagrad rule to both tables (``models.kg.adagrad``);
``--sparse_emb`` the sparse-row Adagrad of DGL-KE and ``--async_update``
its one-step-stale form.  Scores and gradients are torch products and
gathers: no hand-written kernel is on this path.  ``train`` is the loop,
for callers that drive it themselves (``chip_smoke.py``, the tests).
"""
import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402


def train(ds, model_name="TransE_l2", hidden_dim=200, gamma=19.9, lr=0.25,
          batch_size=1024, neg_sample_size=256, neg_chunk_size=64,
          max_step=2000, sparse_emb=False, async_update=False,
          neg_adversarial_sampling=False, adversarial_temperature=1.0,
          regularization_coef=0.0, params=None, device="cuda",
          on_step=None, log=print):
    """The example's loop on ``ds`` (a ``KGDataset``).  ``params`` (numpy
    ``{"entity", "relation"}``, e.g. the JAX example's tables) replaces the
    model's own draw.  ``on_step(it)`` runs after each step is queued.
    Returns the model, its tables, the per-step losses (read once, after
    the last step) and train_time_s (ending in a synchronise)."""
    from dgl_hack_tpu_torch.interop import kg_params_from_jax
    from dgl_hack_tpu_torch.models import kg
    device = torch.device(device)
    model = kg.KEModel(ds.num_entities, ds.num_relations, hidden_dim,
                       model_name, gamma=gamma, device=device)
    if params is not None:
        model.params, _ = kg_params_from_jax(params, device=device)
    prm = model.params
    opt = (neg_adversarial_sampling, adversarial_temperature,
           regularization_coef)
    sparse = sparse_emb or async_update
    if sparse:
        state = kg.init_sparse_state(model)
        if async_update:
            step, empty_pending = kg.make_sparse_train_step(
                model, lr, neg_chunk_size, *opt, async_update=True)
        else:
            step = kg.make_sparse_train_step(model, lr, neg_chunk_size, *opt)
    else:
        tx = kg.adagrad(lr)
        state = tx.init(prm)
        step = kg.make_train_step(model, tx, neg_chunk_size, *opt)
    h, r, t = (torch.from_numpy(np.asarray(x)).to(device) for x in ds.train)
    rng = np.random.default_rng(0)
    C = batch_size // neg_chunk_size
    pending = None
    if async_update:
        pending = empty_pending(batch_size, (C, neg_sample_size),
                                prm["entity"].shape[1],
                                prm["relation"].shape[1])
    losses = []
    t0 = time.perf_counter()
    for it in range(max_step):
        sel = torch.from_numpy(rng.integers(0, len(ds.train[0]),
                                            batch_size)).to(device)
        neg = torch.from_numpy(rng.integers(
            0, ds.num_entities, (C, neg_sample_size)).astype(np.int32)
        ).to(device)
        batch = (h[sel], r[sel], t[sel], neg, bool(it % 2))
        if async_update:
            prm, state, loss, pending = step(prm, state, *batch, pending)
        else:
            prm, state, loss = step(prm, state, *batch)
        losses.append(loss)
        if on_step is not None:
            on_step(it)
        if log is not None and (it + 1) % 500 == 0:
            log(f"step {it+1}: loss {float(loss):.4f} "
                f"({(it+1)/(time.perf_counter()-t0):.1f} steps/s)")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_time = time.perf_counter() - t0
    losses = torch.stack(losses).tolist() if losses else []
    return {"model": model, "params": prm, "losses": losses,
            "train_time_s": train_time}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--model_name", default="TransE_l2",
                   choices=["TransE_l1", "TransE_l2", "DistMult", "ComplEx",
                            "RESCAL", "RotatE", "TransR"])
    p.add_argument("--sparse_emb", action="store_true",
                   help="sparse-row Adagrad on the embedding tables "
                        "(reference: ExternalEmbedding)")
    p.add_argument("--async_update", action="store_true",
                   help="one-step-stale row updates (reference: "
                        "--async_update); implies --sparse_emb")
    p.add_argument("--dataset", default="FB15k")
    p.add_argument("--kg-scale", type=float, default=0.1)
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--neg_sample_size", type=int, default=256)
    p.add_argument("--neg_chunk_size", type=int, default=64)
    p.add_argument("--hidden_dim", type=int, default=200)
    p.add_argument("--gamma", type=float, default=19.9)
    p.add_argument("--lr", type=float, default=0.25)
    p.add_argument("--max_step", type=int, default=2000)
    p.add_argument("--neg_adversarial_sampling", action="store_true")
    p.add_argument("--adversarial_temperature", type=float, default=1.0)
    p.add_argument("--regularization_coef", type=float, default=0.0)
    p.add_argument("--eval_size", type=int, default=2000)
    p.add_argument("--save_path", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")

    from dgl_hack_tpu_torch.data.kg import load_kg_dataset
    from dgl_hack_tpu_torch.models.kg import eval_ranks, save_emb

    ds = load_kg_dataset(args.dataset, scale=args.kg_scale)
    print(f"{ds.name}: {ds.num_entities} entities, {ds.num_relations} "
          f"relations, {len(ds.train[0])} train triples")
    res = train(ds, args.model_name, args.hidden_dim, args.gamma, args.lr,
                args.batch_size, args.neg_sample_size, args.neg_chunk_size,
                args.max_step, args.sparse_emb, args.async_update,
                args.neg_adversarial_sampling, args.adversarial_temperature,
                args.regularization_coef, device=args.device)
    th, tr_, tt = ds.test
    k = min(args.eval_size, len(th))
    metrics = eval_ranks(res["model"], res["params"], th[:k], tr_[:k],
                         tt[:k])
    if args.save_path:
        save_emb(args.save_path, res["params"])
    print(json.dumps({"dataset": ds.name, "model": args.model_name,
                      "train_time_s": res["train_time_s"], **metrics}))


if __name__ == "__main__":
    main()
