"""The port's chemistry model zoo (``dgl_hack_tpu_torch.models.chem``)
against the JAX package's: every model from the same numpy inputs and the
same JAX parameters (carried over by ``interop.flax_to_state_dict``), its
output and the gradients of every parameter, on the CPU (the kernels'
plain versions against the JAX composed paths on bare graphs).  Outputs
agree to rtol 1e-5, atol 1e-6 element-wise, gradients to atol 1e-6 plus
rtol 1e-5 of each gradient's own largest magnitude
(``assert_grads_close``), and MPNN and AttentiveFP, whose recurrent steps
compound the rounding, to 1e-4.  The molecules are batched synthetic
ones of 8-24 atoms (at most 16 a batch), whose internal and user edge
orders differ.  A round trip through ``interop`` returns the JAX
parameters."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl
from dgl_hack_tpu.data import chem as jdata
from dgl_hack_tpu.models import chem as jchem

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch.data import chem as tdata
from dgl_hack_tpu_torch.interop import (dense_module_names,
                                        embed_module_names,
                                        flax_to_state_dict,
                                        norm_module_names,
                                        state_dict_to_flax)
from dgl_hack_tpu_torch.models import chem as tchem

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)
RECURRENT_TOL = dict(rtol=1e-4, atol=1e-4)
N_TASKS = 3


def _molecules(n, seed):
    """n synthetic molecules drawn by each package from one seed."""
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    mj = [jdata._synthetic_molecule(rj) for _ in range(n)]
    mt = [tdata._synthetic_molecule(rt) for _ in range(n)]
    return ([jdata._mol_to_graph(m) for m in mj],
            [tdata._mol_to_graph(m) for m in mt])


@pytest.fixture(scope="module")
def batch():
    gj, gt = _molecules(8, seed=5)
    bj, bt = dgl.batch(gj), dt.batch(gt)
    assert bt.int2user is not None            # internal != user order
    return bj, bt


# name -> (JAX model, port model, inputs of the bare graph (JAX, port)
# by name)
MODELS = {
    "schnet": (lambda: jchem.SchNet(dim=16, n_conv=2, output_dim=N_TASKS),
               lambda: tchem.SchNet(dim=16, n_conv=2, output_dim=N_TASKS),
               ("atomic_number", "distance_internal")),
    "schnet_norm": (
        lambda: jchem.SchNet(dim=8, n_conv=1, output_dim=N_TASKS, norm=True,
                             mean=0.5, std=2.0, cutoff=3.0, width=0.5),
        lambda: tchem.SchNet(dim=8, n_conv=1, output_dim=N_TASKS, norm=True,
                             mean=0.5, std=2.0, cutoff=3.0, width=0.5),
        ("atomic_number", "distance_internal")),
    "mgcn": (lambda: jchem.MGCN(dim=16, edge_dim=8, n_conv=2,
                                output_dim=N_TASKS),
             lambda: tchem.MGCN(dim=16, edge_dim=8, n_conv=2,
                                output_dim=N_TASKS),
             ("atomic_number", "distance_internal")),
    "mpnn": (lambda: jchem.MPNN(output_dim=N_TASKS, node_hidden_dim=8,
                                edge_hidden_dim=16,
                                num_step_message_passing=3,
                                num_step_set2set=3),
             lambda: tchem.MPNN(output_dim=N_TASKS, node_hidden_dim=8,
                                edge_hidden_dim=16,
                                num_step_message_passing=3,
                                num_step_set2set=3),
             ("h", "e_internal")),
    "attentivefp": (lambda: jchem.AttentiveFP(num_layers=3, num_timesteps=2,
                                              graph_feat_size=16,
                                              output_size=N_TASKS),
                    lambda: tchem.AttentiveFP(num_layers=3, num_timesteps=2,
                                              graph_feat_size=16,
                                              output_size=N_TASKS),
                    ("h", "e_internal")),
    "gcn": (lambda: jchem.GCNClassifier(n_tasks=N_TASKS,
                                        gcn_hidden_feats=(16, 8),
                                        classifier_hidden_feats=16),
            lambda: tchem.GCNClassifier(n_tasks=N_TASKS,
                                        gcn_hidden_feats=(16, 8),
                                        classifier_hidden_feats=16),
            ("h",)),
    "gat": (lambda: jchem.GATClassifier(n_tasks=N_TASKS,
                                        gat_hidden_feats=(8, 8),
                                        num_heads=(3, 2),
                                        classifier_hidden_feats=16),
            lambda: tchem.GATClassifier(n_tasks=N_TASKS,
                                        gat_hidden_feats=(8, 8),
                                        num_heads=(3, 2),
                                        classifier_hidden_feats=16),
            ("h",)),
    "weave": (lambda: jchem.WeavePredictor(n_tasks=N_TASKS, num_layers=3,
                                           hidden_feats=8,
                                           classifier_hidden_feats=16),
              lambda: tchem.WeavePredictor(n_tasks=N_TASKS, num_layers=3,
                                           hidden_feats=8,
                                           classifier_hidden_feats=16),
              ("h", "e")),
    "wln": (lambda: jchem.WLNPredictor(n_tasks=N_TASKS, node_out_feats=8,
                                       n_layers=2,
                                       classifier_hidden_feats=16),
            lambda: tchem.WLNPredictor(n_tasks=N_TASKS, node_out_feats=8,
                                       n_layers=2,
                                       classifier_hidden_feats=16),
            ("h", "e")),
}


def _inputs(g, names, jax_side):
    out = []
    for name in names:
        if name.endswith("_internal"):
            v = g.edata_internal[name[:-len("_internal")]]
        elif name in ("e",):
            v = g.edata[name]
        else:
            v = g.ndata[name]
        out.append(jnp.asarray(np.asarray(v)) if jax_side else v)
    return out


def _leaves(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_grads(model):
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    return _leaves(_to_flax(grads, model))


def _to_flax(state, model):
    return state_dict_to_flax(state, dense_module_names(model),
                              embed_module_names(model),
                              norm_module_names(model))


# leaves fixed by a layer's options (AtomicConv's radial parameters): the
# port's initial values, which the options alone set
FIXED = ("interaction_cutoffs", "rbf_kernel_means", "rbf_kernel_scaling")


def jax_params(jmodel, j_args, seed, port_state=None):
    """Parameters of the JAX model's shapes (traced, not compiled) drawn
    from numpy: kernels normal with variance 1/fan_in, LayerNorm scales
    near 1, other vectors small, and the ``FIXED`` leaves taken from the
    port's state dict."""
    abstract = jax.eval_shape(lambda k: jmodel.init(k, *j_args),
                              jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        names = [str(k.key) for k in path]
        if names[-1] in FIXED:
            key = ".".join(names[1:])
            return port_state[key].numpy().copy()
        if leaf.ndim >= 2:
            std = 1.0 / np.sqrt(leaf.shape[-2])
        else:
            std = 0.1
        x = rng.normal(0.0, std, leaf.shape)
        if names[-1] == "scale":
            x = 1.0 + x
        return x.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, abstract)


def check_against_jax(jmodel, tmodel, j_args, t_args, tol, seed=0,
                      out_scale=None, term_grads=None):
    """Draw the JAX model's parameters, load them into the port's, and
    hold the output and every parameter's gradient of sum(out * cot) to
    the JAX ones.  ``out_scale(tmodel)``, where given, is the size of the
    terms whose difference the output is: the output is then held within
    atol + rtol * that, element-wise.  ``term_grads(tmodel, cot)``, where
    given, is the port's gradients of the largest such term, which then
    scale the gradients as well.  Returns the JAX parameters."""
    with torch.no_grad():
        tmodel(*t_args)                          # materialise lazy layers
    params = jax_params(jmodel, j_args, seed, tmodel.state_dict())
    shape = jax.eval_shape(lambda p: jmodel.apply(p, *j_args), params).shape
    cot = np.random.default_rng(seed).normal(size=shape).astype(np.float32)

    def loss(p):
        out = jmodel.apply(p, *j_args)
        return (out * cot).sum(), out
    (_, out_j), grads_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    state = flax_to_state_dict(params)
    tmodel.load_state_dict(state)
    out_t = tmodel(*t_args)
    if out_scale is None:
        np.testing.assert_allclose(out_t.detach().numpy(),
                                   np.asarray(out_j), **tol)
    else:
        err = float(np.abs(out_t.detach().numpy() - np.asarray(out_j)).max())
        assert err <= tol["atol"] + tol["rtol"] * out_scale(tmodel), err
    terms = None
    if term_grads is not None:
        terms = term_grads(tmodel, torch.from_numpy(cot))
        tmodel.zero_grad(set_to_none=True)
    (out_t * torch.from_numpy(cot)).sum().backward()
    gj, gt = _leaves(grads_j), _port_grads(tmodel)
    assert set(gj) == set(gt)
    assert_grads_close(gt, gj, tol, terms)
    return params


def assert_grads_close(out, ref, tol, terms=None, floor=1e-3):
    """Every parameter's gradient within atol + rtol * its own max|ref| of
    the JAX one, element-wise, the scale taken at least ``floor`` of the
    model's largest gradient, and at least the size of the same leaf's
    gradient in ``terms`` (where a model's output is a difference of
    terms).  A gradient sums over every atom or edge of the batch, so
    float32 rounding follows the size of the terms, not of the sum: ACNN's
    output bias gets a 0 up to rounding, the complex's sum less its
    fragments'."""
    top = max(float(np.abs(v).max()) for v in ref.values() if v.size)
    for k in ref:
        if not ref[k].size:
            continue
        scale = max(float(np.abs(ref[k]).max()), floor * top,
                    float(np.abs(terms[k]).max()) if terms else 0.0)
        err = float(np.abs(out[k] - ref[k]).max())
        assert err <= tol["atol"] + tol["rtol"] * scale, \
            f"{k}: max abs err {err:.3g}, scale {scale:.3g}"


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_jax(batch, name):
    bj, bt = batch
    jm, tm, names = MODELS[name]
    tol = RECURRENT_TOL if name in ("mpnn", "attentivefp") else TOL
    check_against_jax(jm(), tm(), [bj, *_inputs(bj, names, True)],
                      [bt, *_inputs(bt, names, False)], tol)


@pytest.mark.parametrize("name", ["gcn", "mpnn", "attentivefp", "weave",
                                  "schnet", "mgcn"])
def test_interop_round_trip(batch, name):
    """flax_to_state_dict then state_dict_to_flax gives the JAX parameters
    back, leaf for leaf."""
    bj, bt = batch
    jm, tm, names = MODELS[name]
    j_args = [bj, *_inputs(bj, names, True)]
    model = tm()
    with torch.no_grad():
        model(bt, *_inputs(bt, names, False))
    params = jax_params(jm(), j_args, 1)
    state = flax_to_state_dict(params)
    model.load_state_dict(state)
    back = _to_flax(model.state_dict(), model)
    a, b = _leaves(params), _leaves(back)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def _complex_pairs(n_pairs, seed):
    """ACNN inputs: ligand and protein molecules, and each pair's complex
    (both molecules plus contacts between them), in both packages, with
    the complex's ligand mask."""
    rng = np.random.default_rng(seed)
    lig, prot, comp, masks = ([], []), ([], []), ([], []), []
    for _ in range(n_pairs):
        a = jdata._synthetic_molecule(rng)
        b = jdata._synthetic_molecule(rng)
        na, nb = len(a.atomic_nums), len(b.atomic_nums)
        ca = rng.integers(0, na, 6)
        cb = rng.integers(0, nb, 6) + na
        src = np.concatenate([a.src, b.src + na, ca, cb]).astype(np.int32)
        dst = np.concatenate([a.dst, b.dst + na, cb, ca]).astype(np.int32)
        coords = np.concatenate([a.coords, b.coords + 2.0])
        atomic = np.concatenate([a.atomic_nums, b.atomic_nums])
        for pkg, out in ((jdata, 0), (tdata, 1)):
            lig[out].append(pkg._mol_to_graph(a))
            prot[out].append(pkg._mol_to_graph(b))
            m = pkg._Mol(atomic, src, dst, np.ones(len(src), np.int32),
                         coords, 0)
            comp[out].append(pkg._mol_to_graph(m))
        masks.append(np.arange(na + nb) < na)
    mask = np.concatenate(masks)
    return ([dgl.batch(lig[0]), dgl.batch(prot[0]), dgl.batch(comp[0]),
             jnp.asarray(mask)],
            [dt.batch(lig[1]), dt.batch(prot[1]), dt.batch(comp[1]),
             torch.from_numpy(mask)])


@pytest.mark.parametrize("features", [None, (6.0, 7.0, 8.0)])
def test_acnn_matches_jax(features):
    """ACNN's three AtomicConv towers (the complex one called twice) and the
    shared energy head, on 4 ligand/protein pairs.  The output is the
    complex's energy less its fragments', a difference of float32 sums, so
    it is held to the size of the complex's energy, and the gradients to
    the size of its gradients."""
    j_args, t_args = _complex_pairs(4, seed=2)
    kw = dict(hidden_sizes=(16, 8), features_to_use=features,
              rbf_kernel_means=(0.0, 1.5, 3.0), num_tasks=2)

    def complex_energy(model):
        g = t_args[2]
        with torch.no_grad():
            feats = model.complex_conv(g, g.ndata["atomic_number"],
                                       g.edata_internal["distance"])
            e = dt.readout.sum_nodes(g, model.ACNNPredictor_0(feats, True))
        return float(e.abs().max())

    def complex_grads(model, cot):
        g = t_args[2]
        feats = model.complex_conv(g, g.ndata["atomic_number"],
                                   g.edata_internal["distance"])
        e = dt.readout.sum_nodes(g, model.ACNNPredictor_0(feats, True))
        (e * cot).sum().backward()
        return _port_grads(model)
    check_against_jax(jchem.ACNN(**kw), tchem.ACNN(**kw), j_args, t_args,
                      TOL, out_scale=complex_energy,
                      term_grads=complex_grads)


def test_edge_types_and_rbf_match_jax(batch):
    """pair_edge_types (internal order) and the RBF expansion equal the JAX
    functions' on the same inputs."""
    bj, bt = batch
    z = np.array(bj.ndata["atomic_number"])
    np.testing.assert_array_equal(
        tchem.pair_edge_types(bt, torch.from_numpy(z)).numpy(),
        np.asarray(jchem.pair_edge_types(bj, jnp.asarray(z))))
    d = np.array(bj.edata_internal["distance"])
    ref = jchem.RBFExpansion(0.0, 5.0, 0.7).apply({}, jnp.asarray(d))
    out = tchem.RBFExpansion(0.0, 5.0, 0.7)(torch.from_numpy(d))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
