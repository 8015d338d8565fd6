"""The traffic mixes' generators: deterministic from the seed, at the
stated sizes."""
import pytest
import torch

from gnnbench import inputs, plugins

BIG_SEED = 2 ** 31 + 12345


def _gen(mix, params, seed):
    return plugins.load_module("graphs", plugins.load_json(
        "traffic", mix)["generator"]).generate(params, seed, "cpu")


def _params(mix, **kw):
    p = plugins.load_json("traffic", mix)
    p.update(kw)
    return p


@pytest.mark.parametrize("mix,kw", [
    ("reddit", dict(num_nodes=500, feat_dim=12, train_per_class=4)),
    ("powerlaw", dict(num_nodes=3000, feat_dim=8))])
def test_same_seed_same_inputs(mix, kw):
    a = _gen(mix, _params(mix, **kw), BIG_SEED)
    b = _gen(mix, _params(mix, **kw), BIG_SEED)
    c = _gen(mix, _params(mix, **kw), BIG_SEED + 1)
    for f in ("src", "dst", "x", "labels", "train_mask"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert not torch.equal(a.x, c.x)


def test_planted_partition_sizes():
    N, C, F, deg, tpc = 600, 7, 10, 6.0, 5
    d = _gen("reddit", _params("reddit", num_nodes=N, num_classes=C,
                               feat_dim=F, avg_degree=deg,
                               train_per_class=tpc), 3)
    E = int(N * deg)
    loops = int((d.src == d.dst).sum())
    assert loops == N                      # self pairs dropped, one loop each
    assert (d.num_edges - N) % 2 == 0 and d.num_edges <= 2 * E + N
    assert d.num_edges >= 2 * E * 0.97 + N
    assert d.x.shape == (N, F) and d.x.dtype == torch.float32
    assert int(d.labels.max()) < C and d.num_classes == C
    per_class = torch.bincount(d.labels[d.train_mask], minlength=C)
    sizes = torch.bincount(d.labels, minlength=C)
    assert torch.equal(per_class, torch.clamp(sizes, max=tpc))
    # the first tpc of each class in id order
    for c in range(C):
        ids = torch.nonzero(d.labels == c)[:, 0]
        assert bool(d.train_mask[ids[:tpc]].all())
    # symmetric: (u, v) and (v, u) both present
    fwd = set(zip(d.src.tolist(), d.dst.tolist()))
    assert all((v, u) in fwd for u, v in fwd)


def test_power_law_sizes():
    N = 5000
    d = _gen("powerlaw", _params("powerlaw", num_nodes=N, feat_dim=8), 9)
    assert d.num_edges == int(N * 16.0)
    assert int(d.train_mask.sum()) == round(0.1 * N)
    assert d.x.shape == (N, 8) and int(d.labels.max()) < 40
    deg = torch.bincount(d.dst, minlength=N)
    # zipf on the ids: the head holds the hubs, many nodes have no in-edge
    assert int(deg[:N // 10].sum()) > 0.5 * d.num_edges
    assert int(deg.argmax()) < 50
    assert int((deg == 0).sum()) > N // 4


def test_subseeds_differ_and_fit():
    s = {inputs.subseed(BIG_SEED, t) for t in ("graph", "weights",
                                                 "dropout")}
    assert len(s) == 3 and all(0 <= v < 2 ** 63 for v in s)


def test_weights_from_specs():
    specs = [("a", (3, 4), 0.5), ("b", (4,), 0.0), ("c", (1, 2, 2), 1.0)]
    w = inputs.make_weights(specs, 5, "cpu")
    assert {k: tuple(v.shape) for k, v in w.items()} == {
        "a": (3, 4), "b": (4,), "c": (1, 2, 2)}
    assert float(w["b"].abs().sum()) == 0.0
    assert torch.equal(w["a"], inputs.make_weights(specs, 5, "cpu")["a"])
