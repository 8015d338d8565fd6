"""The port's host sampler loader (``dgl_hack_tpu_torch.native``) against
the JAX package's (``dgl_hack_tpu.native``).

The port builds its own copy of ``fastgraph.cpp`` into
``build/dgl_hack_tpu_torch/`` and leaves ``dgl_hack_tpu/native/`` as it
is.  Both libraries come from the same source, so for the same seed
``rowwise_sample_native`` (with and without replacement, on seeds without
in-edges, with the fanout above and below the degree) and
``fennel_native`` must agree bit for bit.  The JAX library must have
loaded (its loader gives None when g++ fails): these tests compare two
native paths, never a fallback.
"""
import pathlib

import numpy as np
import pytest

import dgl_hack_tpu as dgl
import dgl_hack_tpu.native as jnative

from dgl_hack_tpu_torch import native as tnative

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_NATIVE = ROOT / "dgl_hack_tpu" / "native"


def _snapshot(d):
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns)
            for p in sorted(d.iterdir())}


def test_loader_builds_under_build_only(tmp_path):
    """get_lib loads a library from build/dgl_hack_tpu_torch/, built from
    the port's own copy of the JAX source; a fresh build writes only into
    the directory it is given, through a temporary name."""
    before = _snapshot(JAX_NATIVE)
    lib = tnative.get_lib()
    assert lib is tnative.get_lib()
    path = pathlib.Path(tnative.BUILD_INFO["path"])
    assert path.parent == ROOT / "build" / "dgl_hack_tpu_torch"
    assert path.name.startswith("libfastgraph_")
    assert path.name.endswith("_omp.so") == tnative.BUILD_INFO["openmp"]
    assert tnative.SRC.parent == ROOT / "dgl_hack_tpu_torch" / "native"
    assert tnative.SRC.read_bytes() == (JAX_NATIVE / "fastgraph.cpp"
                                        ).read_bytes()
    so, openmp = tnative.build_library(tmp_path)
    assert so.parent == tmp_path and so.exists()
    assert [p.name for p in tmp_path.iterdir()] == [so.name]
    assert tnative.build_library(tmp_path) == (so, openmp)
    assert _snapshot(JAX_NATIVE) == before


def _csc_graph(seed=0, n=400, e=3000):
    """A graph with in-degrees from 0 to about 20; nodes 380.. have no
    in-edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n - 20, e)
    g = dgl.graph((src, dst), num_nodes=n)
    return (np.asarray(g.host("csc_indptr")), np.asarray(g.host("src")),
            np.asarray(g.host("csr_indptr")),
            np.asarray(g.host("dst"))[np.asarray(g.host("csr_eids"))], n, e)


@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("fanout", [0, 3, 40])
def test_rowwise_sample_matches_jax(replace, fanout):
    """Same positions and counts as the JAX library for the same seed;
    each pick is an in-edge of its seed; counts are min(fanout, degree)
    without replacement (no repeats) and fanout with it, 0 for seeds
    without in-edges; a second call with the seed repeats the picks."""
    assert jnative.get_lib() is not None, "the JAX library did not load"
    indptr, src, _, _, n, _ = _csc_graph()
    seeds = np.concatenate([np.arange(0, n, 3), [n - 1, n - 5, 7, 7]])
    seed = 0x1234_5678_9ABC
    pos, counts = tnative.rowwise_sample_native(indptr, src, seeds, fanout,
                                                replace, seed)
    jpos, jcounts = jnative.rowwise_sample_native(indptr, src, seeds,
                                                  fanout, replace, seed)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(counts, jcounts)
    assert pos.dtype == np.int64 and counts.dtype == np.int32
    deg = indptr[seeds + 1] - indptr[seeds]
    want = np.where(deg > 0, fanout, 0) if replace else np.minimum(deg,
                                                                   fanout)
    np.testing.assert_array_equal(counts, want)
    off = np.concatenate([[0], np.cumsum(counts)])
    for i, v in enumerate(seeds):
        picks = pos[off[i]:off[i + 1]]
        assert ((picks >= indptr[v]) & (picks < indptr[v + 1])).all()
        if not replace:
            assert len(np.unique(picks)) == len(picks)
    again = tnative.rowwise_sample_native(indptr, src, seeds, fanout,
                                          replace, seed)
    np.testing.assert_array_equal(again[0], pos)


def test_rowwise_sample_rejects_bad_input():
    indptr, src, _, _, n, _ = _csc_graph()
    with pytest.raises(ValueError, match="out of range"):
        tnative.rowwise_sample_native(indptr, src, [0, n], 3, True, 1)
    with pytest.raises(ValueError, match="fanout"):
        tnative.rowwise_sample_native(indptr, src, [0], -1, True, 1)


@pytest.mark.parametrize("weighted", [False, True])
def test_fennel_matches_jax(weighted):
    """The Fennel partition, unweighted and with 1 + in-degree node
    weights, equals the JAX library's from the same visit order."""
    assert jnative.get_lib() is not None, "the JAX library did not load"
    indptr_in, src, indptr_out, dst_by_src, n, e = _csc_graph(1)
    order = np.random.default_rng(2).permutation(n).astype(np.int32)
    vw = (1 + np.diff(indptr_in)).astype(np.int32) if weighted else None
    args = (indptr_in, src, indptr_out, dst_by_src, order, e, 4, 1.5, 1.1,
            2)
    parts = tnative.fennel_native(*args, node_weights=vw)
    np.testing.assert_array_equal(parts, jnative.fennel_native(
        *args, node_weights=vw))
    assert parts.shape == (n,) and parts.min() >= 0 and parts.max() < 4
