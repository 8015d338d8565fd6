"""The Cluster-GCN twin (examples/train_cluster_gcn_torch.py) against the
JAX example's loop (examples/train_cluster_gcn.py), rewritten here with
the JAX package's modules as the other twin tests do: the same parts of
synthetic Cora (``metis_partition`` at ``--parts 4``; the part graphs,
features, labels and masks are compared), the JAX example's initial
parameters (carried over by ``interop.flax_to_state_dict``) and Adam with
its defaults: the first five losses, one part a step, agree to 1e-5 of
the run's largest loss.  On the CPU: K1's plain version against the JAX
composed path.  The same at ``extra_cached_hops=1`` (parts with their
in-edges and halo), and the full-graph evaluation of the trained model
against the JAX model's with the twin's parameters.  The CLI is held in
test_torch_examples.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl
from dgl_hack_tpu.data import synthetic_cora
from dgl_hack_tpu.models import GCN
from dgl_hack_tpu.partition import metis_partition

from dgl_hack_tpu_torch.interop import state_dict_to_flax

from test_torch_attention_twins import _twin
from test_torch_chem_twins import STEPS, _adam, _state, assert_losses_close

torch.set_num_threads(2)

PARTS = 4


def _jax_batches(ds, hops):
    """examples/train_cluster_gcn.py's batches."""
    X, y = np.asarray(ds.features), np.asarray(ds.labels)
    train_mask = np.asarray(ds.train_mask)
    out = []
    for part in metis_partition(ds.graph, PARTS, extra_cached_hops=hops):
        nid = np.asarray(part.node_map)
        out.append((dgl.add_self_loop(part.graph), jnp.asarray(X[nid]),
                    jnp.asarray(y[nid]), jnp.asarray(train_mask[nid])))
    return out


@pytest.mark.parametrize("hops", [0, 1])
def test_cluster_gcn_twin_matches_jax(hops):
    twin = _twin("train_cluster_gcn_torch")
    ds = synthetic_cora(seed=0)
    from dgl_hack_tpu_torch.data import synthetic_cora as tcora
    dst = tcora(seed=0)
    jb, tb = _jax_batches(ds, hops), twin.make_batches(dst, PARTS, hops)
    assert len(jb) == len(tb) == PARTS
    for (gj, xj, yj, mj), (gt, xt, yt, mt) in zip(jb, tb):
        for a, b in zip(gj.host_edges(), gt.host_edges()):
            np.testing.assert_array_equal(a, b)
        for a, b in ((xj, xt), (yj, yt), (mj, mt)):
            np.testing.assert_array_equal(np.asarray(a), b)
    if hops == 0:           # the JAX example's parts: self loops only
        assert all(g.num_edges() == g.num_nodes() for g, *_ in tb)

    model = GCN(hidden_feats=32, out_feats=ds.num_classes)
    params = jax.jit(lambda k: model.init(k, jb[0][0], jb[0][1]))(
        jax.random.PRNGKey(0))

    def loss_fn(p, sub, x, yy, m):
        logp = jax.nn.log_softmax(model.apply(p, sub, x))
        nll = -jnp.take_along_axis(logp, yy[:, None], axis=1)[:, 0]
        return jnp.where(m, nll, 0.0).sum() / jnp.maximum(m.sum(), 1)
    ref = _adam(loss_fn, params, 1e-2,
                [jb[i % PARTS] for i in range(STEPS)])
    res = twin.train(dst, tb, hidden=32, lr=1e-2, params=_state(params),
                     max_steps=STEPS, device="cpu")
    assert len(res["step_ms"]) == STEPS
    assert_losses_close(res["losses"], ref)

    # the full-graph evaluation, on the twin's trained parameters
    acc = twin.evaluate(res["model"], twin.full_graph(dst, "cpu"), dst)
    tp = state_dict_to_flax({k: v.detach() for k, v in
                             res["model"].state_dict().items()})
    logits = model.apply(jax.tree_util.tree_map(jnp.asarray, tp),
                         dgl.add_self_loop(ds.graph),
                         jnp.asarray(ds.features))
    pred = np.asarray(logits.argmax(-1))
    want = float((pred == np.asarray(ds.labels))[np.asarray(ds.test_mask)]
                 .mean())
    assert abs(acc - want) <= 1.0 / int(np.asarray(ds.test_mask).sum())


def test_cluster_gcn_twin_refuses_cuda_without_card():
    twin = _twin("train_cluster_gcn_torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from dgl_hack_tpu_torch.data import synthetic_cora as tcora
    with pytest.raises(RuntimeError, match="device='cpu'"):
        twin.train(tcora(seed=0), [], device="cuda")
