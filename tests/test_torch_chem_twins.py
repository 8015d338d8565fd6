"""The chemistry, MoNet and DiffPool example twins of the PyTorch port
against their JAX examples' loops, rewritten here with the JAX package's
modules as ``tests/test_torch_attention_twins.py`` rewrites the attention
ones: from the same data (each side draws it from the same numpy seed; the
arrays are compared) and the JAX example's initial parameters (carried
over by ``interop.flax_to_state_dict``), the first five Adam losses agree
to 1e-5 relative to the run's largest loss (``assert_losses_close``).
On the CPU: the port's kernel plain versions against
the JAX composed paths on bare graphs.  The chem twin runs one batch five
times, so that the JAX step compiles once.  The CLIs are held in
test_torch_examples.py."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dgl_hack_tpu as dgl
from dgl_hack_tpu.data import chem as jdata
from dgl_hack_tpu.models import chem as jchem

from dgl_hack_tpu_torch.interop import flax_to_state_dict

from test_torch_attention_twins import TWIN_LOSS_RTOL, _twin

torch.set_num_threads(2)

pytestmark = pytest.mark.filterwarnings("ignore:raw .* files not found")
STEPS = 5


def _adam(loss_fn, params, lr, batches):
    """optax.adam, one step per entry of ``batches`` (arguments of
    loss_fn after the parameters), jitted: the losses."""
    tx = optax.adam(lr)
    opt = tx.init(params)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    losses = []
    for args in batches:
        loss, grads = grad_fn(params, *args)
        up, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, up)
        losses.append(float(loss))
    return losses


def assert_losses_close(out, ref, rtol=TWIN_LOSS_RTOL):
    """Each loss within rtol of the largest of the reference run.  A loss
    that starts in the hundreds (MoNet's logits over 1,433 noisy features,
    SchNet's sums over each molecule's atoms) is a difference of terms that
    large, so float32 rounding follows their size, not the loss's once the
    loss falls."""
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    scale = float(np.abs(ref).max())
    err = np.abs(out - ref)
    assert (err <= rtol * scale).all(), (out, ref)


def _state(params):
    return flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))


# the JAX example's models at its widths (examples/train_chem.py)
JAX_CHEM = {
    "gcn": lambda t: jchem.GCNClassifier(n_tasks=t, gcn_hidden_feats=(32, 32)),
    "schnet": lambda t: jchem.SchNet(dim=32, n_conv=2, output_dim=t),
    "weave": lambda t: jchem.WeavePredictor(n_tasks=t, num_layers=2,
                                            hidden_feats=32),
}


@pytest.mark.parametrize("name", sorted(JAX_CHEM))
def test_chem_twin_matches_jax(name):
    """examples/train_chem.py's data, model, inputs and masked loss for
    three models (one per input kind: node features, atomic numbers and
    distances, user-order edge features), 5 Adam steps on a batch of 16
    molecules."""
    twin = _twin("train_chem_torch")
    graphs, labels, mask = twin.load_data(name, n_mols=16)
    if name in twin.REGRESSION:
        ds = jdata.TencentAlchemyDataset(n_mols=16, seed=0)
        jl, jm = (ds.labels - ds.mean) / ds.std, np.ones_like(ds.labels)
    else:
        ds = jdata.Tox21(n_mols=16, seed=0)
        jl, jm = ds.labels, ds.mask
    np.testing.assert_array_equal(jl, labels)
    np.testing.assert_array_equal(jm, mask)
    bg = dgl.batch(ds.graphs)
    model = JAX_CHEM[name](labels.shape[1])

    def inputs(bg):
        if name == "schnet":
            return (bg, bg.ndata["atomic_number"],
                    bg.edata_internal["distance"])
        if name == "weave":
            return (bg, bg.ndata["h"], bg.edata["e"])
        return (bg, bg.ndata["h"])
    params = jax.jit(lambda k: model.init(k, *inputs(bg)))(
        jax.random.PRNGKey(0))
    y, w = jnp.asarray(jl), jnp.asarray(jm)

    def loss_fn(p):
        pred = model.apply(p, *inputs(bg))
        if name in twin.REGRESSION:
            ls = (pred - y) ** 2
        else:
            ls = optax.sigmoid_binary_cross_entropy(pred, y)
        return (ls * w).sum() / jnp.maximum(w.sum(), 1.0)
    ref = _adam(loss_fn, params, 3e-3, [()] * STEPS)
    batches = twin.make_batches(graphs, labels, mask, 0, 16, 16)
    assert len(batches) == 1
    res = twin.train(name, batches, epochs=STEPS, lr=3e-3,
                     params=_state(params), device="cpu")
    assert_losses_close(res["losses"], ref)


def test_monet_twin_matches_jax():
    """examples/train_monet.py's pseudo-coordinates and two GMMConv layers
    on synthetic Cora with self-loops, 5 Adam steps."""
    from dgl_hack_tpu.data import synthetic_cora
    from dgl_hack_tpu.nn import GMMConv
    twin = _twin("train_monet_torch")
    data = twin.make_data()
    ds = synthetic_cora(seed=0)
    g = dgl.add_self_loop(ds.graph)
    s, d = g.host_edges()
    deg = np.asarray(g.in_degrees()).astype(np.float64)
    pseudo = np.stack([1.0 / np.sqrt(np.maximum(deg[s], 1)),
                       1.0 / np.sqrt(np.maximum(deg[d], 1))],
                      axis=1).astype(np.float32)
    np.testing.assert_array_equal(pseudo, data[6])
    np.testing.assert_array_equal(np.asarray(ds.features), data[1])

    class MoNet(fnn.Module):
        @fnn.compact
        def __call__(self, g, x, pseudo):
            h = fnn.relu(GMMConv(16, dim=2, n_kernels=3)(g, x, pseudo))
            return GMMConv(ds.num_classes, dim=2, n_kernels=3)(g, h, pseudo)
    model = MoNet()
    X, ps = jnp.asarray(ds.features), jnp.asarray(pseudo)
    y, tr = jnp.asarray(ds.labels), jnp.asarray(np.asarray(ds.train_mask))
    params = jax.jit(lambda k: model.init(k, g, X, ps))(
        jax.random.PRNGKey(0))

    def loss_fn(p):
        logp = jax.nn.log_softmax(model.apply(p, g, X, ps))
        nll = -jnp.take_along_axis(logp, y[:, None], 1)[:, 0]
        return jnp.where(tr, nll, 0.0).sum() / tr.sum()
    ref = _adam(loss_fn, params, 1e-2, [()] * STEPS)
    res = twin.train(data, epochs=STEPS, params=_state(params), device="cpu")
    assert_losses_close(res["losses"], ref)


def test_diffpool_twin_matches_jax():
    """examples/train_diffpool.py's densified SBM batches and model (dense
    SAGE, soft assignment, coarsening, the auxiliaries), 5 Adam steps (the
    4 training batches, then the first again)."""
    from dgl_hack_tpu.data import sbm_mixture
    from dgl_hack_tpu.nn import DenseSAGEConv
    from dgl_hack_tpu_torch.data import sbm_mixture as port_sbm
    twin = _twin("train_diffpool_torch")
    batches, classes = twin.make_batches()
    kw = dict(num_graphs=120, nodes_per_graph=24, communities=(1, 4),
              p_in=0.6, p_out=0.05, seed=0)
    ds, pds = sbm_mixture(**kw), port_sbm(**kw)
    for gj, gt in zip(ds.graphs, pds.graphs):
        for a, b in zip(gj.host_edges(), gt.host_edges()):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.concatenate([y for _, y in batches]),
                                  np.asarray(ds.labels))

    class DiffPool(fnn.Module):
        @fnn.compact
        def __call__(self, X, A, M):
            Z = fnn.relu(DenseSAGEConv(32)(A, X))
            S = fnn.Dense(6)(Z)
            S = jax.nn.softmax(jnp.where(M[:, :, None] > 0, S, -1e9),
                               axis=-1)
            Xp = jnp.einsum("bnk,bnf->bkf", S, Z)
            Ap = jnp.einsum("bnk,bnm,bml->bkl", S, A, S)
            lp = ((A - jnp.einsum("bnk,bmk->bnm", S, S)) ** 2).mean()
            ent = (-S * jnp.log(S + 1e-9)).sum(-1)
            ent = (ent * M).sum() / jnp.maximum(M.sum(), 1.0)
            Z2 = fnn.relu(DenseSAGEConv(32)(Ap, Xp))
            return fnn.Dense(classes)(Z2.mean(1)), lp, ent
    model = DiffPool()
    jb = [tuple(jnp.asarray(a) for a in (*xam, y)) for xam, y in batches]
    params = jax.jit(lambda k: model.init(k, *jb[0][:3]))(
        jax.random.PRNGKey(0))

    def loss_fn(p, X, A, M, y):
        logits, lp, ent = model.apply(p, X, A, M)
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(logp, y[:, None], 1).mean()
        return nll + 0.01 * lp + 0.01 * ent
    ref = _adam(loss_fn, params, 5e-3, (jb[:4] * 2)[:STEPS])
    res = twin.train(batches, classes, epochs=2, n_train=4,
                     params=_state(params), device="cpu")
    assert_losses_close(res["losses"][:STEPS], ref)
