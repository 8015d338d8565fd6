"""GIN graph classification and MLPPredictor of the PyTorch port against
the JAX package, from the same parameters (``interop``) and inputs.

* GIN forward on a batch of ``sbm_mixture`` graphs with random features:
  within 1e-5 of max|ref|; the gradient of every parameter within 1e-4
  of that parameter's max|ref| (float32; LayerNorm's variance is computed
  in another order by flax).  The dataset's features are all ones, under
  which the first layer's eps gradient is a sum that cancels to ~1e-6 of
  its terms, so this test draws its own.
* Three Adam steps of ``train_graph_classifier``'s step against the step
  of ``examples/train_gin.py`` (optax.adam, cross-entropy of the
  log-softmax): losses within 1e-4 relative.
* MLPPredictor: forward within 1e-5, gradients within 1e-4.
* Parameter names: GIN's MLP Denses sit at the top of the tree
  (``Dense_{2i}``, ``Dense_{2i+1}``), LayerNorm's ``scale`` is
  ``weight``, and the port's fresh model has the JAX tree's keys.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dgl_hack_tpu.core import batch as jbatch
from dgl_hack_tpu.data import sbm_mixture as jax_sbm
from dgl_hack_tpu.models import GIN as JGIN
from dgl_hack_tpu.models import MLPPredictor as JMLP

from dgl_hack_tpu_torch.core import batch as tbatch
from dgl_hack_tpu_torch.data import sbm_mixture
from dgl_hack_tpu_torch.interop import flax_to_state_dict
from dgl_hack_tpu_torch.models import GIN, MLPPredictor
from dgl_hack_tpu_torch.models.training import (graph_batches,
                                                graph_classifier_step)

torch.set_num_threads(2)

KW = dict(num_graphs=48, nodes_per_graph=12, communities=(1, 4), p_in=0.6,
          p_out=0.05, seed=0)


def assert_close(out, ref, tol, what=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def data():
    dj, dtt = jax_sbm(**KW), sbm_mixture(**KW)
    jb = [(jbatch.batch(dj.graphs[i:i + 16]),
           jnp.asarray(np.concatenate(dj.features[i:i + 16])),
           jnp.asarray(dj.labels[i:i + 16])) for i in range(0, 48, 16)]
    tb = graph_batches(dtt, 0, 48, 16, device="cpu")
    return jb, tb


def _gin_pair(jb, num_layers=3):
    jm = JGIN(hidden_feats=32, out_feats=2, num_layers=num_layers)
    params = jm.init(jax.random.PRNGKey(0), *jb[0][:2])
    tm = GIN(hidden_feats=32, out_feats=2, num_layers=num_layers)
    tm.load_state_dict(flax_to_state_dict(_np_tree(params)))
    return jm, params, tm


def test_gin_parameter_tree(data):
    jb, tb = data
    jm, params, _ = _gin_pair(jb)
    fresh = GIN(hidden_feats=32, out_feats=2, num_layers=3)
    with torch.no_grad():
        fresh(*tb[0][:2])
    ref = flax_to_state_dict(_np_tree(params))
    assert set(fresh.state_dict()) == set(ref)
    for k, v in fresh.state_dict().items():
        assert tuple(v.shape) == tuple(ref[k].shape), k
    assert "Dense_5.weight" in ref and "ln2.weight" in ref \
        and "gin1.eps" in ref


@pytest.mark.parametrize("num_layers", [2, 3])
def test_gin_forward_and_gradients_match_jax(data, num_layers):
    jb, tb = data
    jm, params, tm = _gin_pair(jb, num_layers)
    jg, tg = jb[1][0], tb[1][0]
    rng = np.random.default_rng(num_layers)
    x = rng.normal(size=tuple(tb[1][1].shape)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    cot = rng.normal(size=(16, 2)).astype(np.float32)

    def loss(p):
        return (jm.apply(p, jg, jx) * cot).sum()
    jout = np.asarray(jm.apply(params, jg, jx))
    jgrads = flax_to_state_dict(_np_tree(jax.grad(loss)(params)))
    tout = tm(tg, tx)
    (tout * torch.from_numpy(cot)).sum().backward()
    assert_close(tout.detach().numpy(), jout, 1e-5, "forward")
    for name, p in tm.named_parameters():
        assert_close(p.grad.numpy(), jgrads[name].numpy(), 1e-4, name)


def test_gin_adam_steps_match_train_gin(data):
    """Three steps over three batches: the port's step and the step of
    examples/train_gin.py from the same parameters."""
    jb, tb = data
    jm, params, tm = _gin_pair(jb)
    tx = optax.adam(5e-3)
    opt = tx.init(params)

    @jax.jit
    def step(p, o, bg, x, y):
        def loss_fn(p):
            logp = jax.nn.log_softmax(jm.apply(p, bg, x))
            return -jnp.take_along_axis(logp, y[:, None], axis=-1).mean()
        loss, grads = jax.value_and_grad(loss_fn)(p)
        upd, o = tx.update(grads, o, p)
        return optax.apply_updates(p, upd), o, loss

    ref = []
    for b in jb:
        params, opt, loss = step(params, opt, *b)
        ref.append(float(loss))
    train_step, accuracy = graph_classifier_step(tm, tb[0], lr=5e-3,
                                                 device="cpu")
    losses = [float(train_step(*b)) for b in tb]
    np.testing.assert_allclose(losses, ref, rtol=1e-4)
    assert 0.0 <= accuracy(*tb[0]) <= 1.0


def test_mlp_predictor_matches_jax():
    rng = np.random.default_rng(4)
    hs = rng.normal(size=(30, 6)).astype(np.float32)
    hd = rng.normal(size=(30, 6)).astype(np.float32)
    jm = JMLP(hidden_feats=16, out_feats=3)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(hs), jnp.asarray(hd))
    tm = MLPPredictor(hidden_feats=16, out_feats=3)
    tm.load_state_dict(flax_to_state_dict(_np_tree(params)))
    cot = rng.normal(size=(30, 3)).astype(np.float32)
    jgrads = flax_to_state_dict(_np_tree(jax.grad(
        lambda p: (jm.apply(p, jnp.asarray(hs), jnp.asarray(hd)) * cot)
        .sum())(params)))
    out = tm(torch.from_numpy(hs), torch.from_numpy(hd))
    (out * torch.from_numpy(cot)).sum().backward()
    assert_close(out.detach().numpy(),
                 np.asarray(jm.apply(params, jnp.asarray(hs),
                                     jnp.asarray(hd))), 1e-5)
    for name, p in tm.named_parameters():
        assert_close(p.grad.numpy(), jgrads[name].numpy(), 1e-4, name)


def test_batches_follow_train_gin():
    """graph_batches drops a last partial batch, as make_batches does."""
    dtt = sbm_mixture(**KW)
    b = graph_batches(dtt, 0, 40, 16, device="cpu")
    assert len(b) == 2 and b[1][0].batch_num_nodes == (12,) * 16
    assert tbatch.num_graphs(b[0][0]) == 16
    np.testing.assert_array_equal(b[1][2].numpy(), dtt.labels[16:32])
