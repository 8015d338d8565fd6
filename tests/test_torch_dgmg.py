"""The port's DGMG against the JAX package's ``models/dgmg`` from the JAX
model's own parameters (``interop.flax_to_state_dict``): the action traces
equal, the teacher-forced NLL of a batch of traces and the gradient of
every parameter within 1e-5 of the largest (the NLL to 1e-5 relative),
including traces that fill ``max_nodes`` and ``max_edges`` exactly (the
steps after a full graph write one past the end, which both packages
drop), and the sampler's structure (``generate``, the port's own draws)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgl_hack_tpu.models import dgmg as jdgmg
from dgl_hack_tpu_torch.interop import flax_to_state_dict
from dgl_hack_tpu_torch.models import dgmg as tdgmg

torch.set_num_threads(2)

NT, NB, H, V, E = 3, 2, 8, 5, 6
MAX_STEPS = 2 * V + 2 * E + 2


def _molecules():
    """(node_types, src, dst, bonds): a triangle, a path, a single atom,
    and two graphs that fill V nodes and E bonds exactly."""
    full_src = np.array([0, 1, 0, 2, 1, 3])
    full_dst = np.array([1, 2, 2, 3, 3, 4])
    return [
        (np.array([0, 1, 0]), np.array([0, 1, 0]), np.array([1, 2, 2]),
         np.array([0, 1, 0])),
        (np.array([2, 0, 1, 1]), np.array([0, 1, 2]), np.array([1, 2, 3]),
         np.array([1, 0, 1])),
        (np.array([1]), np.zeros(0), np.zeros(0), np.zeros(0)),
        (np.array([0, 1, 2, 0, 1]), full_src, full_dst,
         np.array([0, 1, 1, 0, 1, 0])),
        (np.array([2, 2, 1, 0, 0]), full_dst, full_src,     # dst < src
         np.array([1, 1, 0, 0, 1, 1])),
    ]


def _traces(steps=MAX_STEPS):
    return [tdgmg.build_action_trace(*m, steps) for m in _molecules()]


def test_action_trace_matches_jax():
    for m in _molecules():
        for steps in (MAX_STEPS, 40):
            a = tdgmg.build_action_trace(*m, steps)
            b = jdgmg.build_action_trace(*m, steps)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype == np.int32
                np.testing.assert_array_equal(x, y)
    st, lb = _traces()[3]
    live = st[st != tdgmg.PAD]
    assert (live == tdgmg.ADD_NODE).sum() == V + 1
    assert (live == tdgmg.CHOOSE_DEST).sum() == E
    with pytest.raises(ValueError):
        tdgmg.build_action_trace(np.zeros(9, np.int64), np.zeros(0),
                                 np.zeros(0), np.zeros(0), max_steps=4)


@pytest.fixture(scope="module")
def models():
    st, lb = _traces()[0]
    jm = jdgmg.DGMG(n_node_types=NT, n_bond_types=NB, node_hidden_size=H,
                    num_prop_rounds=2, max_nodes=V, max_edges=E)
    # the JAX model's parameter shapes (no init compiles), drawn from
    # numpy; nonzero biases, so that a wrong bias path shows
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(st), jnp.asarray(lb)))
    leaves, tree = jax.tree_util.tree_flatten(shapes)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_unflatten(tree, [
        (rng.standard_normal(x.shape) / np.sqrt(x.shape[0])).astype(
            np.float32) for x in leaves])
    tm = tdgmg.DGMG(NT, NB, node_hidden_size=H, num_prop_rounds=2,
                    max_nodes=V, max_edges=E)
    tm.load_state_dict(flax_to_state_dict(params))
    return jm, params, tm


def test_port_modules_named_as_flax(models):
    """The port's own draw has the JAX model's parameter names and
    shapes (so the state dicts load both ways)."""
    _, params, _ = models
    fresh = tdgmg.DGMG(NT, NB, node_hidden_size=H, num_prop_rounds=2,
                       max_nodes=V, max_edges=E)
    want = {k: tuple(v.shape) for k, v in flax_to_state_dict(params).items()}
    assert {k: tuple(v.shape) for k, v in fresh.state_dict().items()} == want


def test_nll_and_grads_match_jax(models):
    """Every trace at once, the two that fill both capacities included:
    each NLL, and each parameter's gradient of their sum within 1e-5 of
    the largest gradient (choose_dest_mlp_1's bias shifts every dest logit
    alike, so its exact gradient is 0: JAX gives 0, the port rounding)."""
    jm, params, tm = models
    traces = _traces()
    sts = np.stack([t[0] for t in traces])
    lbs = np.stack([t[1] for t in traces])

    @jax.jit
    def value_and_grad(p):
        def loss(p):
            nll = jax.vmap(lambda a, b: jm.apply(p, a, b))(
                jnp.asarray(sts), jnp.asarray(lbs))
            return nll.sum(), nll
        return jax.value_and_grad(loss, has_aux=True)(p)
    (_, jnll), jgrads = value_and_grad(params)
    tm.zero_grad()
    tnll = tm(torch.from_numpy(sts), torch.from_numpy(lbs))
    tnll.sum().backward()
    np.testing.assert_allclose(tnll.detach().numpy(), np.asarray(jnll),
                               rtol=1e-5)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    got = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    assert set(got) == set(want)
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for k in want:
        err = float(np.abs(got[k] - want[k].numpy()).max())
        assert err <= 1e-5 * scale, (k, err, scale)


def test_nll_padding_invariant_and_single_trace(models):
    _, _, tm = models
    st, lb = _traces()[3]
    st2, lb2 = _traces(40)[3]
    with torch.no_grad():
        a = tm(torch.from_numpy(st), torch.from_numpy(lb))
        b = tm(torch.from_numpy(st2), torch.from_numpy(lb2))
        c = tm(torch.from_numpy(np.stack([st, _traces()[0][0]])),
               torch.from_numpy(np.stack([lb, _traces()[0][1]])))
    assert a.dim() == 0 and bool(torch.isfinite(a))
    assert abs(float(a) - float(b)) < 1e-4
    assert abs(float(a) - float(c[0])) < 1e-5


def test_generate_structurally_valid(models):
    """tests/test_dgmg.py's checks on a batch of the port's samples."""
    _, _, tm = models
    out = tm.generate(torch.Generator().manual_seed(0), num_samples=16)
    again = tm.generate(torch.Generator().manual_seed(0), num_samples=16)
    for k in out:
        assert torch.equal(out[k], again[k]), k
    assert out["src"].shape == (16, 2 * E)
    sizes = set()
    for i in range(16):
        n, e = int(out["num_nodes"][i]), int(out["num_edges"][i])
        sizes.add((n, e))
        assert 0 <= n <= V and 0 <= e <= 2 * E and e % 2 == 0
        assert int(out["edge_mask"][i].sum()) == e
        src = out["src"][i, :e].numpy()
        dst = out["dst"][i, :e].numpy()
        if e:
            assert src.max() < n and dst.max() < n
            assert np.all(src != dst)
            np.testing.assert_array_equal(src[0::2], dst[1::2])
        if n:
            assert int(out["node_types"][i, :n].max()) < NT
    assert len(sizes) > 1          # the draws differ between samples


def test_float64_model_matches_float32(models):
    """The state and one-hots follow the parameters' dtype: a float64
    copy runs, and agrees with float32 on traces this short."""
    import copy
    _, _, tm = models
    traces = _traces()
    sts = torch.from_numpy(np.stack([t[0] for t in traces]))
    lbs = torch.from_numpy(np.stack([t[1] for t in traces]))
    with torch.no_grad():
        a = tm(sts, lbs)
        b = copy.deepcopy(tm).double()(sts, lbs)
    assert b.dtype == torch.float64
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)
