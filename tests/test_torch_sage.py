"""SAGEConv, GINConv and GraphSAGE of the PyTorch port against the JAX
package's, from the same parameters (converted with ``interop``) and the
same inputs made from a seed.

The JAX side runs on a ``prepare_spmm``'d graph, so its pool and max
aggregations go through its Pallas max kernel in interpret mode; the port
runs on the CPU (K1's and K4/K5's plain versions).  Tolerance: 1e-4 of
max|ref| for outputs and parameter gradients (the Pallas sum path carries
the f32x2 split's ~2^-16 relative error; dense products run in another
order).
"""
import inspect

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dgl_hack_tpu as dgl
from dgl_hack_tpu.models import GraphSAGE as JGraphSAGE
from dgl_hack_tpu.models.training import masked_cross_entropy as jax_mce
from dgl_hack_tpu.nn import GINConv as JGINConv
from dgl_hack_tpu.nn import SAGEConv as JSAGEConv

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch.data import planted_partition
from dgl_hack_tpu_torch.interop import flax_to_state_dict
from dgl_hack_tpu_torch.models import GraphSAGE
from dgl_hack_tpu_torch.models.training import (masked_cross_entropy,
                                                train_node_classifier)
from dgl_hack_tpu_torch.nn import GINConv, SAGEConv

torch.set_num_threads(2)

TOL = 1e-4


def assert_close(out, ref, tol, what=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _graphs(rng, n=200, e=1500, empty_from=185):
    src, dst = rng.integers(0, n, e), rng.integers(0, empty_from, e)
    gj = dgl.prepare_spmm(dgl.graph((src, dst), num_nodes=n), te=256, bc=8,
                          wc=2)
    return gj, dt.graph((src, dst), num_nodes=n)


def _compare(jmodule, pmodule, gj, gt, x):
    """Output and parameter gradients of sum(out * t) in both packages."""
    params = jmodule.init(jax.random.PRNGKey(0), gj, jnp.asarray(x))
    ref = jmodule.apply(params, gj, jnp.asarray(x))
    t = np.random.default_rng(9).normal(size=ref.shape).astype(np.float32)
    jgrads = jax.grad(lambda p: (jmodule.apply(p, gj, jnp.asarray(x)) * t)
                      .sum())(params)
    pmodule.load_state_dict(flax_to_state_dict(_np_tree(params)))
    out = pmodule(gt, torch.from_numpy(x))
    (out * torch.from_numpy(t)).sum().backward()
    assert_close(out.detach().numpy(), ref, TOL, "forward")
    want = flax_to_state_dict(_np_tree(jgrads))
    got = {n: p.grad for n, p in pmodule.named_parameters()}
    assert set(got) == set(want)
    for name, grad in got.items():
        assert_close(grad.numpy(), want[name].numpy(), TOL, name)


@pytest.mark.parametrize("aggregator", ["mean", "gcn", "pool"])
def test_sageconv_from_jax_params(aggregator):
    rng = np.random.default_rng(1)
    gj, gt = _graphs(rng)
    x = rng.normal(size=(200, 12)).astype(np.float32)
    _compare(JSAGEConv(7, aggregator), SAGEConv(7, aggregator), gj, gt, x)


@pytest.mark.parametrize("aggregator", ["sum", "max"])
def test_ginconv_from_jax_params(aggregator):
    rng = np.random.default_rng(2)
    gj, gt = _graphs(rng)
    x = rng.normal(size=(200, 6)).astype(np.float32)
    _compare(JGINConv(fnn.Dense(5), aggregator, init_eps=0.1,
                      learn_eps=True),
             GINConv(torch.nn.LazyLinear(5), aggregator, init_eps=0.1,
                     learn_eps=True), gj, gt, x)


def test_graphsage_pool_forward_and_step():
    """GraphSAGE-pool forward, loss, gradients and one AdamW step."""
    rng = np.random.default_rng(3)
    gj, gt = _graphs(rng)
    x = rng.normal(size=(200, 10)).astype(np.float32)
    labels = rng.integers(0, 4, 200)
    mask = rng.random(200) < 0.5
    jm = JGraphSAGE(16, 4, num_layers=2, aggregator_type="pool", dropout=0.5)
    pm = GraphSAGE(16, 4, num_layers=2, aggregator_type="pool", dropout=0.5)
    params = jm.init(jax.random.PRNGKey(4), gj, jnp.asarray(x))

    def loss_j(p):
        return jax_mce(jm.apply(p, gj, jnp.asarray(x)), jnp.asarray(labels),
                       jnp.asarray(mask))
    loss_ref, grads = jax.value_and_grad(loss_j)(params)
    tx = optax.adamw(1e-2, weight_decay=5e-4)
    upd, _ = tx.update(grads, tx.init(params), params)
    stepped = optax.apply_updates(params, upd)

    pm.load_state_dict(flax_to_state_dict(_np_tree(params)))
    pm.eval()                                # dropout off, as JAX apply
    opt = torch.optim.AdamW(pm.parameters(), lr=1e-2, weight_decay=5e-4,
                            eps=1e-8)
    out = pm(gt, torch.from_numpy(x))
    assert_close(out.detach().numpy(), jm.apply(params, gj, jnp.asarray(x)),
                 TOL, "forward")
    loss = masked_cross_entropy(out, torch.from_numpy(labels),
                                torch.from_numpy(mask))
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref),
                               rtol=TOL)
    loss.backward()
    want = flax_to_state_dict(_np_tree(grads))
    for name, p in pm.named_parameters():
        assert_close(p.grad.numpy(), want[name].numpy(), TOL, name)
    opt.step()
    after = flax_to_state_dict(_np_tree(stepped))
    for name, p in pm.named_parameters():
        assert_close(p.detach().numpy(), after[name].numpy(), TOL, name)


@pytest.mark.parametrize("case", ["lstm"])
def test_unported_sage_paths_raise(case):
    """The lstm aggregator, which raised until the mailbox was ported: its
    output and parameter gradients against the JAX layer's from the same
    parameters, with nonzero gate biases (so that the rows without
    in-edges, whose carry flax takes after the last step over zero
    inputs, count).  Over sampled blocks: test_torch_sampling.py."""
    rng = np.random.default_rng(4)
    gj, gt = _graphs(rng)
    x = rng.normal(size=(200, 6)).astype(np.float32)
    jm = JSAGEConv(5, case)
    params = jm.init(jax.random.PRNGKey(0), gj, jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(rng.normal(size=a.shape), a.dtype),
        params)
    jm_fixed = _Fixed(jm, params)
    _compare(jm_fixed, SAGEConv(5, case), gj, gt, x)


class _Fixed:
    """A flax module whose ``init`` returns the given parameters."""

    def __init__(self, module, params):
        self.module, self.params = module, params

    def init(self, *args):
        return self.params

    def apply(self, *args):
        return self.module.apply(*args)


def test_train_graphsage_pool_on_cpu():
    ds = planted_partition(200, 4, 16, avg_degree=6.0, seed=1,
                           train_per_class=15, num_val=40, num_test=80)
    res = train_node_classifier(
        GraphSAGE(16, 4, num_layers=2, aggregator_type="pool"), ds.graph,
        ds.features, ds.labels, ds.train_mask, ds.val_mask, ds.test_mask,
        num_epochs=10, lr=1e-2, seed=2, device="cpu")
    assert len(res["losses"]) == 10 and np.isfinite(res["losses"]).all()
    assert res["losses"][-1] < res["losses"][0]


def test_trainer_defaults_to_the_card(monkeypatch):
    """train_node_classifier runs on cuda unless given the CPU; with no
    card it raises instead of falling back."""
    default = inspect.signature(train_node_classifier).parameters["device"]
    assert default.default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = planted_partition(40, 2, 4, seed=0, train_per_class=5, num_val=10,
                           num_test=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_node_classifier(GraphSAGE(8, 2), ds.graph, ds.features,
                              ds.labels, ds.train_mask, ds.val_mask,
                              ds.test_mask, num_epochs=2)
