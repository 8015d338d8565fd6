"""The operation and byte counts, against hand counts on small graphs."""
from gnnbench import harness, plugins

K1 = plugins.load_module("counts", "k1")
EDGE = plugins.load_module("counts", "gat_edge")
DENSE = plugins.load_module("counts", "dense")


def test_gspmm_sum_by_hand():
    # 3 sources, 2 destinations, 4 edges, 5 features: x 60 B read, the
    # edge ids 16 B and 3 offsets 12 B, out 40 B written; 20 adds
    assert K1.gspmm_sum(3, 2, 4, 5) == (20, 60 + 16 + 12 + 40)


def test_gat_edge_by_hand():
    # 2 nodes, 3 edges, 2 heads of 4, in floats: Wh 16, el 4, er 4,
    # out 16; ids 3 + offsets 3; the keep mask 6 bits
    ops, nbytes = EDGE.forward(2, 3, 2, 4)
    assert ops == 2 * 3 * 8
    assert nbytes == 4 * (16 + 4 + 4 + 16) + 6 / 8 + 4 * (3 + 3)
    ops, nbytes = EDGE.backward(2, 3, 2, 4)
    assert ops == 4 * 3 * 8
    # dout, Wh, el, er, the mask read; dWh, del, der written
    assert nbytes == 4 * (16 + 16 + 4 + 4 + 16 + 4 + 4) + 6 / 8 \
        + 4 * (3 + 3)


def test_dense_by_hand():
    assert DENSE.linear(10, 3, 2, input_grad=False) == (120, 120)
    assert DENSE.linear(10, 3, 2, input_grad=True) == (120, 240)
    assert DENSE.adamw_bytes(5) == 140


def _shape(N=4, E=6, F=3, C=2):
    return {"num_nodes": N, "num_edges": E, "in_feats": F, "num_classes": C}


def test_sage_step_counts():
    cfg = plugins.load_json("configs", "graphsage-mean")
    got = plugins.load_module("counts", "graphsage-mean").step(cfg, _shape())
    H = cfg["num_hidden"]
    # layer 0 forward at F = 3; layer 1 forward and dx at the hidden width
    assert got["k1"] == [K1.gspmm_sum(4, 4, 6, 3), K1.gspmm_sum(4, 4, 6, H),
                         K1.gspmm_sum(4, 4, 6, H)]
    dense = 2 * (2 * 2 * 4 * 3 * H) + 2 * (3 * 2 * 4 * H * 2)
    adds = 6 * 3 + 2 * 6 * H
    params = 2 * (3 * H + H) + 2 * (H * 2 + 2)
    (ops, nbytes), = got["step"]
    assert ops == dense + adds
    assert nbytes == 4 * 3 * 4 + 6 * 4 + 5 * 4 + 4 * 8 + 4 + 28 * params


def test_gat_step_counts():
    cfg = plugins.load_json("configs", "gat")
    got = plugins.load_module("counts", "gat").step(cfg, _shape())
    assert got["gat"] == [EDGE.forward(4, 6, 8, 8), EDGE.backward(4, 6, 8, 8),
                          EDGE.forward(4, 6, 1, 2), EDGE.backward(4, 6, 1, 2)]
    # one fc product a layer (the published function), el and er
    dense = (2 * 4 * 3 * 64 + 2 * 4 * 3 * 64) \
        + (2 * 4 * 64 * 2 + 2 * (2 * 4 * 64 * 2))
    scores = 2 * 2 * 4 * 64 * 2 + 2 * 2 * 4 * 2 * 2
    (ops, _), = got["step"]
    assert ops == dense + scores + sum(o for o, _ in got["gat"])


def test_least_time_takes_the_binding_side():
    cell = plugins.cell("graphsage-mean.reddit")
    ctx = harness.Context(cell, _shape(N=1000, E=10 ** 6, F=600, C=41),
                          {}, harness.Window(1, 1.0, [1.0], 0), 0)
    peaks = harness.PEAKS
    want = 1e3 * sum(max(b / peaks["hbm_bytes_per_s"],
                         o / peaks["fp32_ops_per_s"])
                     for o, b in plugins.load_module(
                         "counts", "graphsage-mean").step(
                             cell.config, ctx.shape)["k1"])
    assert abs(ctx.least_ms("k1") - want) < 1e-12
    assert ctx.least_ms("gat") is None
