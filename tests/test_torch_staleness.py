"""The port's async commit math (fedml_tpu_torch/async_/staleness.py)
against the JAX package's, on the CPU.

* λ(s) of all three families within 2 ulp (torch.pow and XLA's pow may
  differ in the last bit);
* the flat rows and RowLayout exactly (the port's row is the dict's order,
  padded to 512; the layout's paths are the port codec's, and a frame
  decoded into a row is the row);
* the drain commit, arrival fold, sparse fold, drain twin, streaming
  commit and bucketed commit (mean, trimmed_mean, median; DP given JAX's
  noise) at rtol 1e-6, the field fold bitwise;
* port-side pins: arrival folds equal the drain twin bitwise (every
  staleness mode, full and deadline-partial buffers), zero-weight pad
  lanes are exact, the B = 1 bucket commit is the streaming commit;
* AsyncBuffer's drain, streaming, sparse and bucket modes, with their
  states equal to the JAX buffer's and round-tripping (the bucket
  assignment stream included), and concurrent adds from threads.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.async_ import staleness as jst
from fedml_tpu_torch.async_ import staleness as tst
from fedml_tpu_torch.async_.staleness import (AsyncBuffer, RowLayout,
                                              flat_dim, flatten_vars_row)
from fedml_tpu_torch.comm.message import Message, MessageCodec

torch.set_num_threads(2)
MODES = ("constant", "polynomial", "hinge")
RTOL = 1e-6


def _rows(seed, k, p):
    rs = np.random.RandomState(seed)
    return (rs.randn(k, p).astype(np.float32),
            rs.randint(1, 40, k).astype(np.float32),
            rs.randint(0, 6, k).astype(np.float32))


def _templates(seed=99):
    """The same variables as a JAX pytree and as the port's dict, the
    dict in JAX's leaf order so that the two flat rows agree."""
    rs = np.random.RandomState(seed)
    a = rs.randn(5, 7).astype(np.float32)
    b = rs.randn(2).astype(np.float32)
    jtree = {"params": {"a": jnp.asarray(a), "b": jnp.asarray(b)}}
    ttree = {"a": torch.tensor(a), "b": torch.tensor(b)}
    return jtree, ttree


def _padded(rows: np.ndarray, p: int) -> torch.Tensor:
    out = torch.zeros(rows.shape[0], p)
    out[:, :rows.shape[1]] = torch.from_numpy(rows)
    return out


def _close(got, want, err_msg=""):
    """rtol 1e-6, with an absolute floor of 1e-6 of the largest |want| (an
    accumulator sums rows of either sign: one rounding of a large partial
    sum can land on an element near zero)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()),
                               err_msg=err_msg)


def _assert_tree_close(jtree, ttree):
    for k, v in ttree.items():
        _close(v.numpy(), jtree["params"][k], err_msg=k)


def _assert_dicts_equal(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# -- λ and the rows ----------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_staleness_weight_matches_jax_within_2_ulp(mode):
    s = np.asarray([0, 1, 2, 3, 4, 5, 7, 10, 33], np.float32)
    want = np.asarray(jst.staleness_weight(mode, jnp.asarray(s), a=0.5,
                                           b=4.0))
    got = tst.staleness_weight(mode, torch.tensor(s), a=0.5, b=4.0).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=2)
    assert got.dtype == np.float32
    with pytest.raises(ValueError, match="unknown staleness mode"):
        tst.staleness_weight("linear", torch.tensor(s))


def test_flat_rows_and_row_layout_match_jax():
    """The port's row is JAX's flat row padded to 512 (for a dict in JAX's
    leaf order), RowLayout's offsets are JAX's, its paths the port codec's,
    and decode_into fills a row bitwise equal to flatten_vars_row."""
    jtree, ttree = _templates()
    n = jst.flat_dim(jtree)
    assert flat_dim(ttree) == n + (-n) % 512
    row = flatten_vars_row(ttree)
    np.testing.assert_array_equal(row[:n].numpy(), jst.flatten_vars_row(jtree))
    assert not row[n:].any()
    lay, jlay = RowLayout(ttree, "model_params"), jst.RowLayout(
        jtree, "model_params")
    assert lay.p == jlay.p == n and lay.padded == flat_dim(ttree)
    assert ({k.replace("/params/", "/"): v for k, v in jlay.offsets.items()}
            == lay.offsets)
    msg = Message(12, 1, 0)
    msg.add_params("model_params", ttree)
    msg.add_params("num_samples", 3.0)
    out = torch.full((lay.padded,), -1.0)
    got = MessageCodec.decode_into(MessageCodec.encode(msg), out[:lay.p], lay)
    assert got.get("num_samples") == 3.0
    assert torch.equal(out[:n], row[:n])
    back = tst.unflatten_row(row, ttree)
    _assert_dicts_equal(back, ttree)


# -- the commit programs ------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_drain_commit_matches_jax(mode):
    jtree, ttree = _templates()
    n, P = jst.flat_dim(jtree), flat_dim(ttree)
    rows, w, s = _rows(3, 5, n)
    want, wst = jst.make_commit_fn(jtree, mode, a=0.5, donate=False)(
        jtree, jnp.asarray(rows), jnp.asarray(w), jnp.asarray(s),
        jnp.float32(0.7))
    got, st = tst.make_commit_fn(ttree, mode, a=0.5)(
        ttree, _padded(rows, P), w, s, 0.7)
    _assert_tree_close(want, got)
    np.testing.assert_allclose(float(st["discount_mass"]),
                               float(wst["discount_mass"]), rtol=RTOL)


def test_drain_commit_zero_weight_pad_lanes_are_exact():
    _, ttree = _templates()
    P = flat_dim(ttree)
    rows, w, s = _rows(1, 5, P)
    w[3:] = 0.0
    commit = tst.make_commit_fn(ttree, "polynomial", a=0.5)
    bare, _ = commit(ttree, torch.from_numpy(rows[:3]), w[:3], s[:3], 0.7)
    padded, _ = commit(ttree, torch.from_numpy(rows), w, s, 0.7)
    _assert_dicts_equal(bare, padded)


def _arrivals(fold, rows, w, s, P):
    acc, wsum = torch.zeros(P), torch.zeros(())
    for i in range(rows.shape[0]):
        acc, wsum = fold(acc, wsum, rows[i], w[i], s[i])
    return acc, wsum


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_real", [6, 3])
def test_arrival_folds_equal_the_drain_twin_bitwise(mode, n_real):
    """THE streaming pin: per-arrival folds, the drain twin over the
    capacity-padded matrix (zero-weight pad lanes), and the streaming
    buffer are one accumulator, bit for bit, and commit to one model."""
    K, P = 6, 512
    _, ttree = _templates()
    rows, w, s = _rows(11 + n_real, n_real, P)
    facc, fwsum = _arrivals(tst.make_fold_fn(mode, a=0.5), rows, w, s, P)
    padded = np.zeros((K, P), np.float32)
    padded[:n_real] = rows
    pw, ps = np.zeros(K, np.float32), np.zeros(K, np.float32)
    pw[:n_real], ps[:n_real] = w, s
    dacc, dwsum = tst.make_drain_fold_fn(mode, a=0.5)(
        torch.from_numpy(padded), pw, ps)
    assert torch.equal(facc, dacc) and torch.equal(fwsum, dwsum)
    buf = AsyncBuffer(K, P, streaming=True, staleness_mode=mode,
                      staleness_a=0.5, device="cpu")
    for i in range(n_real):
        buf.add(rows[i], float(w[i]), float(s[i]))
    acc, wsum, bw, bs, n, raw = buf.take_stream()
    assert n == n_real and raw == float(np.sum(w))
    np.testing.assert_array_equal(bw[:n_real], w)
    assert torch.equal(acc, dacc) and torch.equal(wsum, dwsum)
    variables = {"x": torch.randn(P)}
    commit = tst.make_stream_commit_fn(variables)
    _assert_dicts_equal(commit(variables, acc, wsum, 0.7)[0],
                        commit(variables, dacc, dwsum, 0.7)[0])


@pytest.mark.parametrize("mode", MODES)
def test_fold_drain_and_stream_commit_match_jax(mode):
    jtree, ttree = _templates()
    n, P = jst.flat_dim(jtree), flat_dim(ttree)
    rows, w, s = _rows(5, 4, n)
    jacc, jw = jnp.zeros((n,), jnp.float32), jnp.zeros((), jnp.float32)
    jfold = jst.make_fold_fn(mode, a=0.5)
    for i in range(4):
        jacc, jw = jfold(jacc, jw, rows[i], jnp.float32(w[i]),
                         jnp.float32(s[i]))
    prow = _padded(rows, P).numpy()
    acc, wsum = _arrivals(tst.make_fold_fn(mode, a=0.5), prow, w, s, P)
    _close(acc[:n].numpy(), jacc)
    np.testing.assert_allclose(float(wsum), float(jw), rtol=RTOL)
    dacc, dw = jst.make_drain_fold_fn(mode, a=0.5)(
        jnp.asarray(rows), jnp.asarray(w), jnp.asarray(s))
    _close(acc[:n].numpy(), dacc)
    want, _ = jst.make_stream_commit_fn(jtree, donate=False)(
        jtree, dacc, dw, jnp.float32(0.7))
    got, st = tst.make_stream_commit_fn(ttree)(ttree, acc, wsum, 0.7)
    _assert_tree_close(want, got)
    assert torch.equal(st["discount_wsum"], wsum)


def test_sparse_fold_matches_jax_and_the_dense_fold_bitwise():
    K, P, k = 5, 64, 4
    rs = np.random.RandomState(2)
    dense = AsyncBuffer(K, P, streaming=True, staleness_mode="polynomial",
                        staleness_a=0.5, device="cpu")
    sparse = AsyncBuffer(K, P, streaming=True, staleness_mode="polynomial",
                         staleness_a=0.5, device="cpu")
    jsparse = jst.AsyncBuffer(K, P, streaming=True,
                              staleness_mode="polynomial", staleness_a=0.5)
    for i in range(K):
        idx = np.sort(rs.choice(P, k, replace=False)).astype(np.int64)
        vals = rs.randn(k).astype(np.float32)
        row = np.zeros(P, np.float32)
        row[idx] = vals
        assert (dense.add(row, 1.0 + i, float(i))
                == sparse.add_sparse(idx, vals, 1.0 + i, float(i))
                == jsparse.add_sparse(idx, vals, 1.0 + i, float(i)))
    da, dw = dense.take_stream()[:2]
    sa, sw = sparse.take_stream()[:2]
    assert torch.equal(da, sa) and torch.equal(dw, sw)
    ja, jw = jsparse.take_stream()[:2]
    _close(sa.numpy(), ja)
    np.testing.assert_allclose(float(sw), float(jw), rtol=RTOL)
    with pytest.raises(RuntimeError, match="drain-mode"):
        AsyncBuffer(2, P, device="cpu").add_sparse(np.zeros(1, np.int64),
                                     np.zeros(1, np.float32), 1.0, 0.0)
    with pytest.raises(RuntimeError, match="bucket"):
        AsyncBuffer(4, P, streaming=True, buckets=2, device="cpu").add_sparse(
            np.zeros(1, np.int64), np.zeros(1, np.float32), 1.0, 0.0)


def test_field_fold_is_bitwise_jax():
    p = 2_147_483_647
    rs = np.random.RandomState(4)
    acc = rs.randint(0, p, 257).astype(np.uint32)
    rows = [rs.randint(0, p, 257).astype(np.uint32) for _ in range(5)]
    rows.append(np.full(257, p - 1, np.uint32))
    jfold = jst.make_field_fold_fn(p)
    tfold = tst.make_field_fold_fn(p)
    jacc = jnp.asarray(acc)
    tacc = torch.from_numpy(acc.astype(np.int64))
    for r in rows:
        jacc = jfold(jacc, jnp.asarray(r))
        tacc = tfold(tacc, torch.from_numpy(r.astype(np.int64)))
    np.testing.assert_array_equal(tacc.numpy().astype(np.uint32),
                                  np.asarray(jacc))


# -- the bucketed robust commit -----------------------------------------------

@pytest.mark.parametrize("combine,trim", [("mean", 0), ("trimmed_mean", 1),
                                          ("median", 0)])
def test_bucket_commit_matches_jax(combine, trim):
    jtree, ttree = _templates()
    n, P = jst.flat_dim(jtree), flat_dim(ttree)
    rs = np.random.RandomState(7)
    accs = rs.randn(5, n).astype(np.float32)
    accs[2] *= 40.0                          # an outlier bucket
    wsums = np.asarray([3.0, 5.0, 0.0, 2.0, 4.0], np.float32)   # one empty
    accs[2] = 0.0
    want, wst = jst.make_bucket_commit_fn(jtree, combine, trim_k=trim,
                                          donate=False)(
        jtree, jnp.asarray(accs), jnp.asarray(wsums), jnp.float32(0.6))
    got, st = tst.make_bucket_commit_fn(ttree, combine, trim_k=trim)(
        ttree, _padded(accs, P), wsums, 0.6)
    _assert_tree_close(want, got)
    assert float(st["n_buckets"]) == float(wst["n_buckets"]) == 4.0
    _close(st["bucket_means"][:, :n].numpy(), wst["bucket_means"])


def test_bucket_commit_b1_is_the_stream_commit_bitwise():
    _, ttree = _templates()
    P = flat_dim(ttree)
    rows, w, s = _rows(8, 4, P)
    acc, wsum = _arrivals(tst.make_fold_fn("hinge", a=1.0), rows, w, s, P)
    for combine in ("trimmed_mean", "mean"):
        a, _ = tst.make_bucket_commit_fn(ttree, combine)(
            ttree, acc[None].clone(), wsum[None], 0.8)
        b, _ = tst.make_stream_commit_fn(ttree)(ttree, acc, wsum, 0.8)
        _assert_dicts_equal(a, b)


def test_dp_bucket_commit_matches_jax_given_its_noise():
    jtree, ttree = _templates()
    n, P = jst.flat_dim(jtree), flat_dim(ttree)
    rs = np.random.RandomState(9)
    accs = rs.randn(2, n).astype(np.float32)
    wsums = np.asarray([2.0, 3.0], np.float32)
    key = jax.random.PRNGKey(5)
    want, _ = jst.make_bucket_commit_fn(
        jtree, "mean", dp_noise=1.3, dp_clip=0.5, donate=False)(
        jtree, jnp.asarray(accs), jnp.asarray(wsums), jnp.float32(1.0),
        jnp.float32(3), key)
    noise = torch.zeros(P)
    noise[:n] = torch.tensor(np.asarray(
        jax.random.normal(key, (n,), jnp.float32)))
    commit = tst.make_bucket_commit_fn(ttree, "mean", dp_noise=1.3,
                                       dp_clip=0.5)
    got, _ = commit(ttree, _padded(accs, P), wsums, 1.0, 3, noise)
    _assert_tree_close(want, got)
    g = torch.Generator().manual_seed(0)
    a, _ = commit(ttree, _padded(accs, P), wsums, 1.0, 3, g)
    b, _ = commit(ttree, _padded(accs, P), wsums, 1.0, 3,
                  torch.Generator().manual_seed(0))
    _assert_dicts_equal(a, b)
    with pytest.raises(ValueError, match="n_contrib and rng"):
        commit(ttree, _padded(accs, P), wsums, 1.0)


# -- AsyncBuffer --------------------------------------------------------------

def _state_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def test_drain_buffer_hygiene_and_state_match_jax():
    buf, jbuf = AsyncBuffer(2, 4, device="cpu"), jst.AsyncBuffer(2, 4)
    for b in (buf, jbuf):
        assert not b.add(np.ones(4, np.float32), 1.0, 0.0)
        assert b.add(np.full(4, 2.0, np.float32), 2.0, 1.0)   # full
        with pytest.raises(RuntimeError, match="overflow"):
            b.add(np.ones(4, np.float32), 1.0, 0.0)
    _state_equal(buf.state(), jbuf.state())
    fresh = AsyncBuffer(2, 4, device="cpu")
    fresh.load_state(jbuf.state())
    _state_equal(fresh.state(), jbuf.state())
    rows, w, s, n = buf.drain()
    assert n == 2 and buf.count == 0
    np.testing.assert_array_equal(w, [1.0, 2.0])
    np.testing.assert_array_equal(s, [0.0, 1.0])
    assert rows[1].tolist() == [2.0] * 4
    assert not buf.rows.any()
    with pytest.raises(ValueError, match="shape mismatch"):
        buf.load_state({"rows": np.zeros((3, 4), np.float32),
                        "weights": np.zeros(3), "staleness": np.zeros(3),
                        "count": 0})


def test_streaming_state_round_trips_and_replays_a_drain_state():
    K, P = 4, 512
    rows, w, s = _rows(21, 3, P)
    buf = AsyncBuffer(K, P, streaming=True, staleness_mode="polynomial",
                      staleness_a=0.5, device="cpu")
    jbuf = jst.AsyncBuffer(K, P, streaming=True,
                           staleness_mode="polynomial", staleness_a=0.5)
    for i in range(3):
        buf.add(rows[i], float(w[i]), float(s[i]))
        jbuf.add(rows[i], float(w[i]), float(s[i]))
    state, jstate = buf.state(), jbuf.state()
    assert set(state) == set(jstate) and state["acc"].shape == (P,)
    _close(state["acc"], jstate["acc"])
    for k in ("weights", "staleness", "count", "raw_wsum"):
        np.testing.assert_array_equal(state[k], jstate[k])
    fresh = AsyncBuffer(K, P, streaming=True, staleness_mode="polynomial",
                        staleness_a=0.5, device="cpu")
    fresh.load_state(state)
    a0, w0, bw0, bs0, n0, raw0 = buf.take_stream()
    a1, w1, bw1, bs1, n1, raw1 = fresh.take_stream()
    assert torch.equal(a0, a1) and torch.equal(w0, w1)
    np.testing.assert_array_equal(bw0, bw1)
    assert n0 == n1 == 3 and raw0 == raw1
    # a drain-mode state replays into a streaming buffer: the live folds
    dbuf = AsyncBuffer(K, P, device="cpu")
    for i in range(3):
        dbuf.add(rows[i], float(w[i]), float(s[i]))
    sbuf = AsyncBuffer(K, P, streaming=True, staleness_mode="polynomial",
                       staleness_a=0.5, device="cpu")
    sbuf.load_state(dbuf.state())
    a2, w2, *_ = sbuf.take_stream()
    assert torch.equal(a0, a2) and torch.equal(w0, w2)
    buf2 = AsyncBuffer(K, P, streaming=True, device="cpu")
    buf2.add(rows[0], 1.0, 0.0)
    with pytest.raises(ValueError, match="not reconstructible"):
        AsyncBuffer(K, P, device="cpu").load_state(buf2.state())


def test_bucket_assignment_is_jax_bitwise_across_state_round_trips():
    """Bucketed buffers draw the same seeded bucket per insert as JAX's
    (default_rng([seed, 5])), also for a buffer restored mid-permutation."""
    K, P, B = 12, 512, 4
    rows, w, s = _rows(31, K, P)
    buf = AsyncBuffer(K, P, streaming=True, buckets=B, bucket_seed=3,
                      device="cpu")
    jbuf = jst.AsyncBuffer(K, P, streaming=True, buckets=B, bucket_seed=3)
    for i in range(6):
        buf.add(rows[i], float(w[i]), float(s[i]))
        jbuf.add(rows[i], float(w[i]), float(s[i]))
    resumed = AsyncBuffer(K, P, streaming=True, buckets=B, bucket_seed=3,
                          device="cpu")
    resumed.load_state(buf.state())
    assert int(buf.state()["bucket_draws"]) == int(
        jbuf.state()["bucket_draws"]) == 6
    for i in range(6, K):
        for b in (buf, jbuf, resumed):
            b.add(rows[i], float(w[i]), float(s[i]))
    accs, wsums, *_ = buf.take_stream_buckets()
    raccs, rwsums, *_ = resumed.take_stream_buckets()
    jaccs, jwsums, *_ = jbuf.take_stream_buckets()
    assert torch.equal(accs, raccs) and torch.equal(wsums, rwsums)
    np.testing.assert_array_equal(wsums.numpy(), np.asarray(jwsums))
    _close(accs.numpy(), jaccs)
    with pytest.raises(ValueError, match="streaming=True"):
        AsyncBuffer(4, P, buckets=2, device="cpu")
    with pytest.raises(ValueError, match="cannot exceed"):
        AsyncBuffer(2, P, streaming=True, buckets=3, device="cpu")


@pytest.mark.parametrize("streaming", [False, True])
def test_buffer_thread_safe_adds_and_snapshots(streaming):
    K, P = 64, 16
    buf = AsyncBuffer(K, P, streaming=streaming, device="cpu")
    rows = np.random.RandomState(3).randn(K, P).astype(np.float32)
    torn = []

    def snapshotter(stop):
        while not stop.is_set():
            st = buf.state()
            n = int(st["count"])
            if n > K or np.count_nonzero(st["weights"]) > n:
                torn.append(st)

    stop = threading.Event()
    snap = threading.Thread(target=snapshotter, args=(stop,))
    snap.start()
    threads = [threading.Thread(
        target=lambda lo: [buf.add(rows[i], 1.0 + i, float(i % 3))
                           for i in range(lo, lo + 8)], args=(lo,))
        for lo in range(0, K, 8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    snap.join()
    assert not torn and buf.count == K
    if streaming:
        acc, wsum, w, s, n, raw = buf.take_stream()
        expect = (rows * (1.0 + np.arange(K, dtype=np.float32))[:, None]
                  ).sum(0)
        np.testing.assert_allclose(acc.numpy(), expect, rtol=2e-4, atol=2e-4)
        assert float(wsum) == pytest.approx(float(np.sum(w)))
    else:
        got, w, s, n = buf.drain()
        assert n == K
        np.testing.assert_array_equal(got.numpy()[np.argsort(w)], rows)
