"""The port's knowledge-graph embeddings against the JAX package's
``models/kg``, on the CPU, from the JAX model's own tables
(``interop.kg_params_from_jax``):

* every score function's ``pos``, ``neg_head`` and ``neg_tail`` (1e-5 of
  the largest score), and ``predict_all_tails``/``eval_ranks`` (the port
  scores against the unbroadcast table);
* the loss and its row gradients, with and without self-adversarial
  weighting and regularisation, negatives on either side (1e-5 of the
  largest gradient);
* 20 dense steps under optax's Adagrad, 20 sparse-row Adagrad steps and
  20 one-step-stale (async) steps from the same tables and batches: the
  losses to 1e-5 and the tables and accumulators to 1e-5 of their
  largest entry;
* ``_coalesce`` with duplicate rows; ``save_emb`` files loaded by the
  other package both ways; ``shard`` over a one-rank gloo group (the
  8-rank case is in tests/test_torch_parallel.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dgl_hack_tpu.models import kg as jkg
from dgl_hack_tpu_torch.interop import kg_params_from_jax
from dgl_hack_tpu_torch.models import kg as tkg

torch.set_num_threads(2)

NAMES = ["TransE_l2", "TransE_l1", "DistMult", "ComplEx", "RotatE",
         "TransR", "RESCAL"]
NE, NR, HID = 50, 7, 8
C, S, N = 2, 4, 5


def _models(name, seed=0, gamma=10.0):
    jm = jkg.KEModel(NE, NR, HID, score_func=name, gamma=gamma, seed=seed)
    tm = tkg.KEModel(NE, NR, HID, score_func=name, gamma=gamma, seed=seed,
                     device="cpu")
    tm.params, _ = kg_params_from_jax(jm.params)
    return jm, tm


def _close(out, ref, rel=1e-5):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(out - ref).max()) / scale
    assert err <= rel, err


def _batch(rng, B=C * S):
    return (rng.integers(0, NE, B).astype(np.int32),
            rng.integers(0, NR, B).astype(np.int32),
            rng.integers(0, NE, B).astype(np.int32),
            rng.integers(0, NE, (B // S, N)).astype(np.int32))


def test_port_draws_its_own_tables():
    """One seed gives the same tables on every call (shapes as the JAX
    model's, values in [-emb_init, emb_init))."""
    jm = jkg.KEModel(NE, NR, HID, score_func="TransR", seed=3)
    a = tkg.KEModel(NE, NR, HID, score_func="TransR", seed=3, device="cpu")
    b = tkg.KEModel(NE, NR, HID, score_func="TransR", seed=3, device="cpu")
    for k in ("entity", "relation"):
        assert tuple(a.params[k].shape) == jm.params[k].shape
        assert torch.equal(a.params[k], b.params[k])
        assert float(a.params[k].abs().max()) <= a.emb_init


@pytest.mark.parametrize("name", NAMES)
def test_scores_match_jax(name):
    jm, tm = _models(name)
    h, r, t, neg = _batch(np.random.default_rng(1))
    je, jr = jm.params["entity"], jm.params["relation"]
    te, tr = tm.params["entity"], tm.params["relation"]

    def rows(e, rl, idx):
        hh, rr, tt, nn = idx
        return e[hh], rl[rr], e[tt], e[nn]
    jh, jrr, jt, jn = rows(je, jr, tuple(jnp.asarray(x) for x in
                                         (h, r, t, neg)))
    th, trr, tt, tn = rows(te, tr, tuple(torch.from_numpy(x).long()
                                         for x in (h, r, t, neg)))
    _close(tm.score.pos(th, trr, tt).numpy(), jm.score.pos(jh, jrr, jt))

    def chunked(x):
        return x.reshape(C, S, -1)
    _close(tm.score.neg_tail(chunked(th), chunked(trr), tn).numpy(),
           jm.score.neg_tail(chunked(jh), chunked(jrr), jn))
    _close(tm.score.neg_head(chunked(tt), chunked(trr), tn).numpy(),
           jm.score.neg_head(chunked(jt), chunked(jrr), jn))


@pytest.mark.parametrize("name", NAMES)
def test_predict_all_tails_and_eval_ranks_match_jax(name, monkeypatch):
    """Against the JAX broadcast form, with the port's entity chunks made
    small so that several run."""
    monkeypatch.setattr(tkg, "_ALL_TAILS_ELEMS", 3 * 6 * 2 * HID)
    jm, tm = _models(name)
    rng = np.random.default_rng(2)
    h, r, t, _ = _batch(rng, 6)
    out = tm.predict_all_tails(tm.params, torch.from_numpy(h),
                               torch.from_numpy(r))
    ref = jm.predict_all_tails(jm.params, jnp.asarray(h), jnp.asarray(r))
    _close(out.numpy(), ref)
    h, r, t, _ = _batch(rng, 23)
    got = tkg.eval_ranks(tm, tm.params, h, r, t, batch=10)
    want = jkg.eval_ranks(jm, jm.params, h, r, t, batch=10)
    assert got == pytest.approx(want, rel=1e-12), (got, want)


def _filtered_ranks(jm, h, r, t, fd):
    """The filtered protocol over the JAX scores.  The JAX ``eval_ranks``
    raises with a filter (it writes into the read-only numpy view of a JAX
    array), so the test filters a copy itself."""
    scores = np.array(jm.predict_all_tails(jm.params, jnp.asarray(h),
                                           jnp.asarray(r)))
    for j in range(len(t)):
        mask = [k for k in fd.get((int(h[j]), int(r[j])), ()) if k != t[j]]
        scores[j, mask] = -np.inf
    ranks = (scores > scores[np.arange(len(t)), t][:, None]).sum(1) + 1.0
    return {"MRR": float((1.0 / ranks).mean()), "MR": float(ranks.mean()),
            **{f"HITS@{k}": float((ranks <= k).mean()) for k in (1, 3, 10)}}


@pytest.mark.parametrize("name", ["TransE_l2", "RotatE"])
def test_eval_ranks_filtered(name):
    jm, tm = _models(name)
    rng = np.random.default_rng(4)
    h, r, t, _ = _batch(rng, 23)
    fd = {(int(a), int(b)): rng.integers(0, NE, 6) for a, b in zip(h, r)}
    with pytest.raises(ValueError, match="read-only"):
        jkg.eval_ranks(jm, jm.params, h, r, t, fd)
    got = tkg.eval_ranks(tm, tm.params, h, r, t, fd, batch=10)
    assert got == pytest.approx(_filtered_ranks(jm, h, r, t, fd), rel=1e-12)
    assert got["MRR"] >= tkg.eval_ranks(tm, tm.params, h, r, t)["MRR"]


@pytest.mark.parametrize("adv,reg,neg_is_head", [
    (False, 0.0, False), (True, 0.0, True), (False, 1e-3, True),
    (True, 1e-3, False)])
@pytest.mark.parametrize("name", ["TransE_l2", "RotatE", "TransR"])
def test_loss_and_row_grads_match_jax(name, adv, reg, neg_is_head):
    jm, tm = _models(name)
    h, r, t, neg = _batch(np.random.default_rng(3))
    kw = dict(chunk_size=S, neg_adversarial_sampling=adv,
              adversarial_temperature=0.5, regularization_coef=reg)
    je, jr = jm.params["entity"], jm.params["relation"]
    jrows = (je[h], jr[r], je[t], je[neg])
    jloss, jgrads = jax.value_and_grad(
        lambda *x: jm.loss_from_rows(*x, jnp.asarray(neg_is_head), **kw),
        argnums=(0, 1, 2, 3))(*jrows)
    trows = [torch.tensor(np.asarray(x), requires_grad=True) for x in jrows]
    tloss = tm.loss_from_rows(*trows, neg_is_head, **kw)
    tgrads = torch.autograd.grad(tloss, trows)
    _close(float(tloss.detach()), float(jloss))
    for a, b in zip(tgrads, jgrads):
        _close(a.numpy(), b)
    # loss_fn gathers the same rows
    lf = tm.loss_fn(tm.params, *(torch.from_numpy(x) for x in
                                 (h, r, t, neg)), neg_is_head, **kw)
    _close(float(lf), float(jloss))


def _jax_batches(rng, steps, B=C * S):
    return [_batch(rng, B) for _ in range(steps)]


@pytest.mark.parametrize("name,adv,reg", [("TransE_l2", False, 0.0),
                                          ("ComplEx", True, 1e-4)])
def test_dense_adagrad_20_steps_match_optax(name, adv, reg):
    jm, tm = _models(name, seed=5)
    tx = optax.adagrad(0.1)
    jstate = tx.init(jm.params)
    jstep = jkg.make_train_step(jm, tx, S, adv, 0.5, reg)
    params, tstate = kg_params_from_jax(jm.params, jstate)
    assert float(tstate["entity"].min()) == np.float32(0.1)
    tstep = tkg.make_train_step(tm, tkg.adagrad(0.1), S, adv, 0.5, reg)
    jp = jm.params
    jl, tl = [], []
    for it, (h, r, t, neg) in enumerate(
            _jax_batches(np.random.default_rng(6), 20)):
        nih = bool(it % 2)
        jp, jstate, loss = jstep(jp, jstate, *(jnp.asarray(x) for x in
                                               (h, r, t, neg)),
                                 jnp.asarray(nih))
        jl.append(float(loss))
        params, tstate, loss = tstep(params, tstate, *(
            torch.from_numpy(x) for x in (h, r, t, neg)), nih)
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for k in ("entity", "relation"):
        _close(params[k].numpy(), jp[k])
        _close(tstate[k].numpy(), jstate[0].sum_of_squares[k])


@pytest.mark.parametrize("async_update", [False, True])
def test_sparse_adagrad_20_steps_match_jax(async_update):
    jm, tm = _models("TransE_l2", seed=7, gamma=6.0)
    jp = dict(jm.params)
    jstate = jkg.init_sparse_state(jm)
    params, tstate = kg_params_from_jax(jp, jstate)
    made_j = jkg.make_sparse_train_step(jm, 0.5, S,
                                        async_update=async_update)
    made_t = tkg.make_sparse_train_step(tm, 0.5, S,
                                        async_update=async_update)
    if async_update:
        (jstep, jempty), (tstep, tempty) = made_j, made_t
        jpend = jempty(C * S, (C, N), HID, HID)
        tpend = tempty(C * S, (C, N), HID, HID)
        assert all(not bool(x.any()) for x in tpend)
    else:
        jstep, tstep = made_j, made_t
    jl, tl = [], []
    rng = np.random.default_rng(8)
    for it in range(20):
        h, r, t, neg = _batch(rng)
        # many repeats: a batch holds duplicate rows of both tables
        h[:3] = h[0]
        neg[0, :2] = h[0]
        nih = it % 2 == 0
        jb = tuple(jnp.asarray(x) for x in (h, r, t, neg))
        tb = tuple(torch.from_numpy(x) for x in (h, r, t, neg))
        if async_update:
            jp, jstate, loss, jpend = jstep(jp, jstate, *jb, nih, jpend)
            jl.append(float(loss))
            params, tstate, loss, tpend = tstep(params, tstate, *tb, nih,
                                                tpend)
        else:
            jp, jstate, loss = jstep(jp, jstate, *jb, nih)
            jl.append(float(loss))
            params, tstate, loss = tstep(params, tstate, *tb, nih)
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _close(params["entity"].numpy(), jp["entity"])
    _close(params["relation"].numpy(), jp["relation"])
    _close(tstate["ent_sum"].numpy(), jstate["ent_sum"])
    _close(tstate["rel_sum"].numpy(), jstate["rel_sum"])
    if async_update:
        for a, b in zip(tpend, jpend):
            _close(a.numpy(), b)


def test_coalesce_with_duplicates_matches_jax():
    rows = np.array([5, 2, 5, 0, 2, 9, 5, 7], np.int32)
    grads = np.random.default_rng(9).normal(size=(8, 3)).astype(np.float32)
    jr, jg = jkg._coalesce(jnp.asarray(rows), jnp.asarray(grads))
    tr, tg = tkg._coalesce(torch.from_numpy(rows), torch.from_numpy(grads))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    _close(tg.numpy(), jg)
    # the unique rows first, then (row 0, zero) no-ops
    np.testing.assert_array_equal(tr.numpy()[:5], [0, 2, 5, 7, 9])
    assert not tr.numpy()[5:].any() and not tg.numpy()[5:].any()


def test_save_emb_files_cross_packages(tmp_path):
    jm, tm = _models("DistMult")
    tkg.save_emb(str(tmp_path / "port"), tm.params)
    got = jkg.load_emb(str(tmp_path / "port"))
    for k in ("entity", "relation"):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      tm.params[k].numpy())
    jkg.save_emb(str(tmp_path / "jax"), jm.params)
    got = tkg.load_emb(str(tmp_path / "jax"), device="cpu")
    for k in ("entity", "relation"):
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(jm.params[k]))


def test_shard_raises_multi_gpu():
    """Named when ``shard`` raised ``'multi-gpu'``: over a one-rank gloo
    group it now shards, and a dense step from the sharded table equals
    the JAX model's unsharded step."""
    import socket
    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        jm, tm = _models("DistMult")
        tm.shard(None)
        assert tm.entity_shard.local.shape[0] == NE
        rng = np.random.default_rng(5)
        h, r, t = (rng.integers(0, n, C * S).astype(np.int32)
                   for n in (NE, NR, NE))
        neg = rng.integers(0, NE, (C, N)).astype(np.int32)
        tx = tkg.adagrad(0.1)
        tstate = tx.init(tm.params)
        step = tkg.make_train_step(tm, tx, chunk_size=S)
        _, _, tloss = step(tm.params, tstate, *map(torch.from_numpy,
                                                   (h, r, t, neg)), False)
        jtx = optax.adagrad(0.1)
        jstep = jkg.make_train_step(jm, jtx, chunk_size=S)
        jp, _, jloss = jstep(jm.params, jtx.init(jm.params),
                             *map(jnp.asarray, (h, r, t, neg)),
                             jnp.asarray(False))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        for k in ("entity", "relation"):
            _close(tm.params[k].numpy(), jp[k])
    finally:
        dist.destroy_process_group()
