"""The port's host-sharded serving (fedml_tpu_torch/scale/serve.py with
`partition`) and fused serving cluster (fedml_tpu_torch/scale/cluster.py)
against the JAX package's.

* run_serve_sim at partition=(r, 2) over a HostChannel: each rank's
  trace (dispatches, returns, staleness, crashes and rejoins, registry
  counters) is bitwise the JAX rank's, the committed row within 1e-6,
  and both port ranks commit one digest.
* The elastic re-adoption (tests/test_scale.py's case): rank 2 of 3
  closes its channel after 3 commits, a survivor re-adopts its range;
  every survivor's trace, lanes and adoptions are the JAX survivor's.
* The serving cluster: at world 1 the socket-fed lane commits the
  synthetic serve simulation's digest for the same row sequence (the
  frames are all sent before the first window can close: the windows
  fill by count, never by a deadline); two thread ranks with live
  ingest agree; the reactor's overload gate reads lane saturation; and
  one spawned two-rank serve_cluster cluster of the port's mh_worker
  reports equal digests.

Ranks are threads over real sockets on ports above the ephemeral range
(tests/test_torch_transports.py::free_base_port).
"""
import json
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import fedml_tpu.async_.staleness as jax_staleness
from fedml_tpu.parallel import multihost as jmh
from fedml_tpu.scale import run_serve_sim as jax_serve
from fedml_tpu.scale.arrivals import ArrivalConfig as JaxArrivalConfig
from fedml_tpu_torch.parallel import multihost as tmh
from fedml_tpu_torch.scale import ArrivalConfig, run_serve_sim
from fedml_tpu_torch.scale.cluster import (ClusterServeManager,
                                           make_uplink_frame,
                                           run_cluster_serve, send_uplinks)
from tests.test_torch_scale import TRACE_FIELDS
from tests.test_torch_transports import free_base_port

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _ranks(world, fn, timeout=180):
    """fn(rank) on a thread per rank; their results, the first error
    re-raised, each join bounded."""
    out, errs = {}, []

    def run(r):
        try:
            out[r] = fn(r)
        except BaseException as e:          # noqa: BLE001 - re-raised
            errs.append((r, e))

    ts = [threading.Thread(target=run, args=(r,), daemon=True)
          for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    assert not any(t.is_alive() for t in ts), "a rank hung"
    if errs:
        raise errs[0][1]
    return out


@pytest.fixture
def jax_committed(monkeypatch):
    """The JAX commit's last row per thread (the JAX report has no
    variables)."""
    rows = {}
    make = jax_staleness.make_stream_commit_fn

    def recording(template, donate=False):
        fn = make(template, donate=donate)

        def commit(*a):
            out = fn(*a)
            rows[threading.current_thread().name] = np.asarray(out[0]["w"])
            return out
        return commit

    monkeypatch.setattr(jax_staleness, "make_stream_commit_fn", recording)
    return rows


SERVE_KW = dict(warmup_commits=1, buffer_k=8, row_dim=64, seed=0,
                dropout_prob=0.15, banned_frac=0.01)


def _serve_ranks(mod, world, pop, commits, *, elastic, crash=None,
                 port=None):
    """run_serve_sim of `mod` at partition=(r, world) on thread ranks."""
    port = port or free_base_port(1)
    serve = jax_serve if mod is jmh else run_serve_sim
    arrival = (JaxArrivalConfig if mod is jmh else ArrivalConfig)(
        mode="constant", rate=500.0, seed=0)
    extra = {} if mod is jmh else {"device": "cpu", "keep_variables": True}

    def rank(r):
        threading.current_thread().name = f"{mod.__name__}-{r}"
        ctx = mod.MultihostContext(rank=r, world=world,
                                   coordinator=f"localhost:{port}")
        ch = (mod.ElasticChannel(ctx, n_items=world, config_digest="serve",
                                 timeout_s=60, connect_timeout_s=30,
                                 hb_interval_s=0.1, hb_timeout_s=5.0)
              if elastic else mod.HostChannel(ctx, timeout_s=60,
                                              connect_timeout_s=30))
        try:
            return serve(pop, commits=commits, arrival=arrival,
                         partition=(r, world), channel=ch, elastic=elastic,
                         crash_at_commit=crash.get(r) if crash else None,
                         **SERVE_KW, **extra)
        finally:
            ch.close()

    return _ranks(world, rank)


def test_host_sharded_serve_is_jax_bitwise(jax_committed):
    want = _serve_ranks(jmh, 2, 4096, 4, elastic=False)
    got = _serve_ranks(tmh, 2, 4096, 4, elastic=False)
    for r in (0, 1):
        for f in TRACE_FIELDS:
            assert got[r][f] == want[r][f], (r, f)
        assert got[r]["local_population"] == 2048
        assert got[r]["carry_allreduce_bytes"] > 0
        np.testing.assert_allclose(got[r]["variables"]["w"].numpy(),
                                   jax_committed[f"{jmh.__name__}-{r}"],
                                   rtol=1e-6, atol=1e-7)
    assert got[0]["crashed"] > 0 and got[1]["crashed"] > 0
    assert got[0]["committed_digest"] == got[1]["committed_digest"]
    assert got[0]["trace_digest"] != got[1]["trace_digest"]
    with pytest.raises(ValueError, match="HostChannel"):
        run_serve_sim(100, commits=2, warmup_commits=1, partition=(0, 2),
                      device="cpu")
    with pytest.raises(ValueError, match="ElasticChannel"):
        run_serve_sim(100, commits=2, warmup_commits=1, partition=(0, 2),
                      channel=object(), elastic=True, device="cpu")


def test_elastic_serve_readoption_is_jax_bitwise(jax_committed):
    crash = {2: 3}
    want = _serve_ranks(jmh, 3, 3072, 8, elastic=True, crash=crash)
    got = _serve_ranks(tmh, 3, 3072, 8, elastic=True, crash=crash)
    for r in range(3):
        for f in TRACE_FIELDS:
            assert got[r][f] == want[r][f], (r, f)
        for k in ("lanes", "adopted_items", "retired_items",
                  "crashed_at_commit"):
            assert got[r]["elastic"][k] == want[r]["elastic"][k], (r, k)
    a, b, c = got[0], got[1], got[2]
    assert a["committed_digest"] == b["committed_digest"]
    for r in (0, 1):
        np.testing.assert_allclose(got[r]["variables"]["w"].numpy(),
                                   jax_committed[f"{jmh.__name__}-{r}"],
                                   rtol=1e-6, atol=1e-7)
    assert a["commits"] == b["commits"] == 8 and c["commits"] == 3
    assert sorted(a["elastic"]["lanes"] + b["elastic"]["lanes"]) == [0, 1, 2]
    assert 2 in a["elastic"]["adopted_items"] + b["elastic"]["adopted_items"]
    assert a["elastic"]["view_changes"] >= 1 and a["elastic"]["epoch"] >= 1


# ---------------------------------------------------------------------------
# the fused serving cluster
# ---------------------------------------------------------------------------

def _feed(port, frames, hold, deadline_s=120.0):
    """Dial an endpoint that may not listen yet (retrying until the
    deadline) and stream the frames down one connection, held open."""
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            send_uplinks("127.0.0.1", port, frames, hold_open=hold)
            return
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def test_world1_socket_path_matches_the_synthetic_digest():
    commits, k, dim, seed, pop = 4, 4, 32, 7, 64
    sim = run_serve_sim(pop, commits=commits, warmup_commits=1, buffer_k=k,
                        row_dim=dim, seed=seed, device="cpu",
                        arrival=ArrivalConfig(mode="constant", rate=1000.0,
                                              seed=seed))
    # the lane's row stream at banned_frac 0: the 64-row pool is the first
    # draw of rng([seed, 2]), admitted in order at weight 1
    pool = np.random.default_rng([seed, 2]).standard_normal(
        (64, dim)).astype(np.float32)
    frames = [make_uplink_frame(pool[i % 64], sender=1, weight=1.0)
              for i in range(commits * k)]
    port = free_base_port(1)
    hold = threading.Event()
    th = threading.Thread(target=_feed, args=(port, frames, hold),
                          daemon=True)
    th.start()
    try:
        # every window fills by count: no deadline can close one early
        rep = run_cluster_serve(pop, commits=commits, warmup_commits=1,
                                buffer_k=k, row_dim=dim, port=port,
                                n_connections=4, ingest_pool=1,
                                window_deadline_s=300.0, timeout_s=600.0,
                                backlog_cap=commits * k, device="cpu")
    finally:
        hold.set()
    th.join(10)
    assert rep["committed_digest"] == sim["committed_digest"]
    assert rep["commits"] == commits
    assert rep["committed_updates"] == commits * k
    assert rep["deadline_windows"] == 0 and rep["misrouted"] == 0
    assert rep["lane_overflow_dropped"] == 0


def test_two_rank_live_ingest_digests_agree():
    commits, k, dim, pop, world = 3, 4, 32, 64, 2
    coord, ports = free_base_port(1), [free_base_port(1) for _ in range(2)]
    pool = np.random.default_rng([5, 9]).standard_normal(
        (64, dim)).astype(np.float32)
    hold = threading.Event()
    feeders = [threading.Thread(target=_feed, daemon=True, args=(
        ports[r], [make_uplink_frame(pool[(r * 16 + i) % 64], sender=1)
                   for i in range(commits * k)], hold)) for r in range(2)]
    for t in feeders:
        t.start()

    def rank(r):
        ctx = tmh.MultihostContext(rank=r, world=world,
                                   coordinator=f"localhost:{coord}")
        ch = tmh.ElasticChannel(ctx, n_items=world, config_digest="t2",
                                timeout_s=60.0, connect_timeout_s=30.0,
                                hb_interval_s=0.1, hb_timeout_s=5.0)
        try:
            return run_cluster_serve(
                pop, commits=commits, warmup_commits=1, buffer_k=k,
                row_dim=dim, port=ports[r], partition=(r, world),
                channel=ch, elastic=True, n_connections=4, ingest_pool=1,
                window_deadline_s=60.0, timeout_s=120.0,
                backlog_cap=commits * k, device="cpu")
        finally:
            ch.close()

    try:
        reps = _ranks(world, rank)
    finally:
        hold.set()
    assert reps[0]["committed_digest"] == reps[1]["committed_digest"]
    assert all(r["commits"] == commits and r["elastic"]["epoch"] == 0
               for r in reps.values())
    assert all(r["committed_updates"] == commits * k for r in reps.values())


def test_overload_gate_reads_lane_saturation():
    mgr = ClusterServeManager(8, population=16, buffer_k=2,
                              port=free_base_port(1), n_connections=4,
                              ingest_pool=1, backlog_cap=2, device="cpu")
    try:
        rg = getattr(mgr.com_manager, "_rg", None)
        assert rg is not None and rg._overload_gate is not None
        assert mgr.lane_pressure() is False
        row = np.ones((8,), np.float32)
        for i in range(4):                   # the window, then the backlog
            mgr._ingest_row(i, row, 1.0, 0)
        lane = mgr._lanes[0]
        assert lane.full() and len(lane.backlog) == 2
        assert lane.saturated() and mgr.lane_pressure() is True
        assert rg._overload_reason(time.monotonic()) == "gate"
        mgr._ingest_row(4, row, 1.0, 0)       # past saturation: dropped
        assert lane.overflow_dropped == 1
        parts = mgr.take_partials()
        assert parts[0][2] == 2 and float(parts[0][1]) == 2.0
        assert torch.equal(parts[0][0], torch.full((8,), 2.0))
        assert mgr.lane_pressure() is False   # the backlog refilled it
    finally:
        mgr.finish()


def test_spawned_two_rank_serve_cluster_smoke(tmp_path):
    world, commits, k, dim = 2, 3, 4, 32
    ports = [free_base_port(1) for _ in range(world)]
    cfg = {"serve_cluster": {
        "population": 256, "commits": commits, "warmup_commits": 1,
        "buffer_k": k, "row_dim": dim, "connections": 8, "ingest_pool": 1,
        "window_deadline_s": 60.0, "timeout_s": 180.0, "ports": ports},
        "channel_timeout_s": 120.0, "hb_timeout_s": 5.0,
        "hb_interval_s": 0.25, "device": "cpu"}
    path = tmp_path / "serve.json"
    path.write_text(json.dumps(cfg))
    pool = np.random.default_rng(3).standard_normal(
        (64, dim)).astype(np.float32)
    hold = threading.Event()
    feeders = [threading.Thread(target=_feed, daemon=True, args=(
        ports[r], [make_uplink_frame(pool[i % 64], sender=1)
                   for i in range(commits * k)], hold)) for r in range(2)]
    for t in feeders:
        t.start()
    env = {"OMP_NUM_THREADS": "2",
           "PYTHONPATH": str(REPO) + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    try:
        outs, rep = tmh.spawn_cluster_report(
            [sys.executable, "-m", "fedml_tpu_torch.parallel.mh_worker",
             str(path)], world, env=env, timeout_s=240.0, elastic=True,
            coordinator_port=free_base_port(1))
    finally:
        hold.set()
    assert all(r["rc"] == 0 for r in rep["ranks"].values()), rep
    docs = {r: json.loads(o.strip().splitlines()[-1])["serve_cluster"]
            for r, o in enumerate(outs)}
    assert docs[0]["committed_digest"] == docs[1]["committed_digest"]
    for d in docs.values():
        assert d["commits"] == commits and d["recv_thread_deaths"] == 0
        assert d["committed_updates"] == commits * k
        assert d["launches"]["wsum"] == 0     # CPU tensors take the twin
