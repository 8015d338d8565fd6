"""Training and packaging of the PyTorch port.

* Per-step losses of train_node_classifier against a JAX loop of
  model.apply + optax.adamw from the same parameters, dropout 0: 1e-4
  relative (five AdamW steps compound the f32 rounding).
* The port, chip_smoke.py, the twins and the port's tools
  (tools/*_torch.py) import neither jax, flax, optax nor dgl_hack_tpu.
"""
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dgl_hack_tpu.data import planted_partition as jax_planted
from dgl_hack_tpu.data.rdf import synthetic_rdf as jax_synthetic_rdf
from dgl_hack_tpu.models import GAT as JGAT
from dgl_hack_tpu.models import GCN as JGCN
from dgl_hack_tpu.models import RGCN as JRGCN
from dgl_hack_tpu.models.training import masked_cross_entropy as jax_mce

from dgl_hack_tpu_torch import prepare_rgcn
from dgl_hack_tpu_torch.data import planted_partition
from dgl_hack_tpu_torch.data.rdf import synthetic_rdf
from dgl_hack_tpu_torch.interop import flax_to_state_dict
from dgl_hack_tpu_torch.models import GAT, GCN, RGCN
from dgl_hack_tpu_torch.models.training import train_node_classifier

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_losses(model, params, g, ds, lr, wd, steps, model_args=()):
    feats = None if model_args else jnp.asarray(ds.features)
    labels = jnp.asarray(ds.labels)
    mask = jnp.asarray(ds.train_mask)
    tx = optax.adamw(lr, weight_decay=wd)
    opt = tx.init(params)

    @jax.jit
    def step(p, o):
        def loss_fn(pp):
            return jax_mce(model.apply(pp, g, *model_args, feats), labels,
                           mask)
        loss, grads = jax.value_and_grad(loss_fn)(p)
        upd, o = tx.update(grads, o, p)
        return optax.apply_updates(p, upd), o, loss

    losses = []
    for _ in range(steps):
        params, opt, loss = step(params, opt)
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("kind", ["gcn", "gat", "rgcn"])
def test_training_losses_match_jax(kind):
    """Five steps with dropout 0: the port's train_node_classifier and a
    JAX loop of model.apply + optax.adamw, from the same parameters.  The
    port's RGCN trains through the pair plan, as its example does; the
    JAX side composes, as the JAX example does off the TPU."""
    if kind == "rgcn":
        _rgcn_losses_match_jax()
        return
    ds = planted_partition(150, 4, 12, avg_degree=5.0, seed=4,
                           train_per_class=10, num_val=30, num_test=60)
    dsj = jax_planted(150, 4, 12, avg_degree=5.0, seed=4,
                      train_per_class=10, num_val=30, num_test=60)
    if kind == "gcn":
        jm, pm, lr = JGCN(16, 4, dropout=0.0), GCN(16, 4, dropout=0.0), 1e-2
    else:
        jm = JGAT(8, 4, heads=(4, 1), feat_drop=0.0, attn_drop=0.0)
        pm = GAT(8, 4, heads=(4, 1), feat_drop=0.0, attn_drop=0.0)
        lr = 5e-3
    params = jm.init(jax.random.PRNGKey(0), dsj.graph,
                     jnp.asarray(dsj.features))
    ref = _jax_losses(jm, params, dsj.graph, dsj, lr, 5e-4, 5)
    pm.load_state_dict(flax_to_state_dict(_np_tree(params)))
    res = train_node_classifier(pm, ds.graph, ds.features, ds.labels,
                                ds.train_mask, ds.val_mask, ds.test_mask,
                                num_epochs=5, lr=lr, weight_decay=5e-4,
                                device="cpu")
    np.testing.assert_allclose(res["losses"], ref, rtol=1e-4)
    assert res["losses"][-1] < res["losses"][0]


def _rgcn_losses_match_jax():
    from test_torch_rgcn import jax_params
    ds = synthetic_rdf("small", scale=0.04)
    dsj = jax_synthetic_rdf("small", scale=0.04)
    jm = JRGCN(num_nodes=ds.graph.num_nodes(), hidden_feats=16,
               out_feats=ds.num_classes, num_rels=ds.num_rels, num_bases=4)
    et = jnp.asarray(dsj.etypes)
    params = jax_params(jm, dsj.graph, et, seed=3)
    ref = _jax_losses(jm, params, dsj.graph, dsj, 1e-2, 5e-4, 5,
                      model_args=(et,))
    pm = RGCN(num_nodes=ds.graph.num_nodes(), hidden_feats=16,
              out_feats=ds.num_classes, num_rels=ds.num_rels, num_bases=4)
    pm.load_state_dict(flax_to_state_dict(_np_tree(params)))
    plan = prepare_rgcn(ds.graph, ds.etypes, ds.num_rels)
    res = train_node_classifier(pm, ds.graph, None, ds.labels,
                                ds.train_mask, ds.test_mask, ds.test_mask,
                                num_epochs=5, lr=1e-2, weight_decay=5e-4,
                                model_args=(torch.from_numpy(ds.etypes),),
                                model_kwargs={"plan": plan}, device="cpu")
    np.testing.assert_allclose(res["losses"], ref, rtol=1e-4)
    assert res["losses"][-1] < res["losses"][0]


def test_training_with_dropout_runs_and_learns():
    ds = planted_partition(200, 4, 16, avg_degree=6.0, seed=1,
                           train_per_class=15, num_val=40, num_test=80)
    res = train_node_classifier(GAT(8, 4, heads=(4, 1)), ds.graph,
                                ds.features, ds.labels, ds.train_mask,
                                ds.val_mask, ds.test_mask, num_epochs=20,
                                lr=5e-3, seed=3, device="cpu")
    assert len(res["losses"]) == 20 and np.isfinite(res["losses"]).all()
    assert res["losses"][-1] < res["losses"][0]
    assert 0.0 <= res["test_acc"] <= 1.0


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|optax|dgl_hack_tpu)(\.|\s|$)", re.M)


def test_port_never_imports_jax_source():
    files = sorted((ROOT / "dgl_hack_tpu_torch").rglob("*.py"))
    tools = sorted((ROOT / "tools").glob("*_torch.py"))
    assert {f.name for f in tools} >= {
        "partition_torch.py", "regression_torch.py", "tune_hybrid_torch.py",
        "scaling_torch.py", "validate_real_torch.py"}
    files += [ROOT / "chip_smoke.py",
              *sorted((ROOT / "examples").glob("*_torch.py")), *tools]
    assert len(files) > 15
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'flax', 'optax', 'dgl_hack_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import dgl_hack_tpu_torch as dt\n"
        "names = [m.name for m in pkgutil.walk_packages(dt.__path__,"
        " 'dgl_hack_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import glob, importlib.util\n"
        "for path in sorted(glob.glob('tools/*_torch.py')):\n"
        "    spec = importlib.util.spec_from_file_location('t', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "    assert not any(k.split('.')[0] == 'dgl_hack_tpu'\n"
        "                   for k in sys.modules if sys.modules[k])\n"
        "assert not any(k.split('.')[0] in ('jax', 'flax', 'optax')\n"
        "               for k in sys.modules if sys.modules[k] is not None)\n"
        "print(' '.join(names))\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 15
    names = set(res.stdout.split())
    for mod in ("core.batch", "core.transform", "ops.readout",
                "data.graph_classification", "nn.glob", "nn.utils",
                "nn.init", "data.rdf", "ops.rgcn", "core.heterograph",
                "nn.hetero", "data.chem", "nn.conv_extra", "models.chem",
                "data.citation", "data.karate", "data.io", "data.extra",
                "utils.checkpoint", "utils.profiling", "partition",
                "partition.partition", "core.biggraph", "data.kg",
                "models.kg", "models.dgmg", "distributed.bootstrap",
                "distributed.kvstore", "distributed.feature_store",
                "distributed.dis_sampler", "native", "parallel",
                "parallel.halo", "parallel.spmd", "parallel.collectives",
                "parallel.launch", "parallel.dryrun"):
        assert f"dgl_hack_tpu_torch.{mod}" in names, mod
