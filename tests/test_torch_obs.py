"""The PyTorch port's observability core (fedml_tpu_torch/obs: span
tracer, metrics registry, flight recorder, HTTP endpoint and the facade),
mirroring tests/test_obs.py's host-only cases, plus the port's spans:
obs on and off give bitwise the same rounds (MeshFedAvgEngine, FedNAS),
and the exported trace holds ``round``, ``eval``, ``h2d.upload_cohort``
and ``trace.local_train``.

Every test that configures the facade uses ``clean_obs``: it clears the
FEDML_OBS_* environment variables (monkeypatch), resets the facade
before and after, shuts any HTTP endpoint, and restores SIGUSR1's
disposition, so no handler, thread, server or export at exit outlives a
test (the JAX package's tests/test_obs.py may run next in the same
process).
"""
import glob
import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from fedml_tpu_torch import obs
from fedml_tpu_torch.algorithms.fedavg import FedAvgEngine
from fedml_tpu_torch.algorithms.fednas import FedNASSearchEngine
from fedml_tpu_torch.core.trainer import ClientTrainer
from fedml_tpu_torch.data import federated as tfed
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.obs.metrics import (MetricsRegistry,
                                         quantile_from_cumulative)
from fedml_tpu_torch.obs.tracer import SpanTracer
from fedml_tpu_torch.parallel.engine import MeshFedAvgEngine
from fedml_tpu_torch.utils.config import FedConfig

torch.set_num_threads(2)


@pytest.fixture
def clean_obs(monkeypatch):
    """A fresh, disabled facade around the test; restores SIGUSR1's
    disposition (configure() installs a dump handler) and shuts down any
    endpoint and tracer spill."""
    for var in (obs.ENV_VAR, obs.ENV_HTTP, obs.ENV_SPILL):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(obs, "_prev_sigusr1", None)
    prev = signal.getsignal(signal.SIGUSR1)
    obs.reset()
    yield
    obs.reset()
    signal.signal(signal.SIGUSR1, prev)
    assert not any(t.name == "obs-http" for t in threading.enumerate())


# -- metrics registry --------------------------------------------------------

def test_registry_concurrent_increments_lose_nothing():
    reg = MetricsRegistry()
    c = reg.counter("hits_total", backend="test")
    h = reg.histogram("lat_seconds", buckets=(0.5, 1.0))
    g = reg.gauge("peak")
    n_threads, n_ops = 8, 2000

    def work(i):
        for k in range(n_ops):
            c.inc()
            h.observe(0.25 if k % 2 else 2.0)
            g.set_max(i * n_ops + k)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert c.value == n_threads * n_ops
    assert h.count == n_threads * n_ops
    cum = dict(h.cumulative())
    assert cum[0.5] == n_threads * n_ops // 2
    assert cum[float("inf")] == n_threads * n_ops
    assert g.value == n_threads * n_ops - 1


def test_registry_identity_and_kind_conflicts():
    reg = MetricsRegistry()
    a = reg.counter("x_total", backend="tcp")
    assert reg.counter("x_total", backend="tcp") is a
    assert reg.counter("x_total", backend="grpc") is not a
    with pytest.raises(TypeError):
        reg.gauge("x_total", backend="tcp")
    with pytest.raises(TypeError):
        reg.gauge("x_total", backend="mqtt")
    with pytest.raises(ValueError):
        a.inc(-1)
    h = reg.histogram("h_seconds", buckets=(1.0, 2.0))
    assert reg.histogram("h_seconds") is h
    with pytest.raises(ValueError):
        reg.histogram("h_seconds", buckets=(5.0,))


def test_prometheus_text_and_json_snapshot():
    reg = MetricsRegistry()
    reg.counter("bytes_total", backend="inproc").inc(42)
    reg.histogram("wall_seconds", buckets=(1.0, 5.0)).observe(3.0)
    text = reg.to_prometheus()
    assert "# TYPE bytes_total counter" in text
    assert 'bytes_total{backend="inproc"} 42' in text
    assert 'wall_seconds_bucket{le="1.0"} 0' in text
    assert 'wall_seconds_bucket{le="+Inf"} 1' in text
    assert "wall_seconds_sum 3.0" in text
    snap = reg.snapshot()
    assert snap['bytes_total{backend="inproc"}'] == 42
    assert snap["wall_seconds"]["count"] == 1
    json.loads(reg.to_json())


def _toy_registry(c, g, obs_vals):
    reg = MetricsRegistry()
    reg.counter("t_total", backend="x").inc(c)
    reg.gauge("t_peak").set(g)
    h = reg.histogram("t_seconds", buckets=(0.5, 1.0, 2.0))
    for v in obs_vals:
        h.observe(v)
    return reg


def _merged(*deltas):
    reg = MetricsRegistry()
    for d in deltas:
        reg.merge_delta(d, origin="remote")
    return reg.snapshot()


def test_registry_merge_laws():
    """Counters add, gauges take the max, histograms add bucket-wise: the
    fold is commutative and associative, and the empty delta is the
    identity."""
    da, _ = _toy_registry(3, 5.0, (0.25, 1.5)).delta_snapshot()
    db, _ = _toy_registry(4, 2.0, (0.75,)).delta_snapshot()
    dc, _ = _toy_registry(1, 9.0, (3.0,)).delta_snapshot()
    assert _merged(da, db) == _merged(db, da)
    ab_reg, bc_reg = MetricsRegistry(), MetricsRegistry()
    for reg, ds in ((ab_reg, (da, db)), (bc_reg, (db, dc))):
        for d in ds:
            reg.merge_delta(d, origin="remote")
    ab, _ = ab_reg.delta_snapshot(include_merged=True)
    bc, _ = bc_reg.delta_snapshot(include_merged=True)
    assert _merged(ab, dc) == _merged(da, bc) == _merged(da, db, dc)
    echo, _ = ab_reg.delta_snapshot()
    assert echo["metrics"] == []
    empty, _ = MetricsRegistry().delta_snapshot()
    assert empty["metrics"] == [] and _merged(da, empty) == _merged(da)
    snap = _merged(da, db, dc)
    assert snap['t_total{backend="x",origin="remote"}'] == 8.0
    assert snap['t_peak{origin="remote"}'] == 9.0
    assert snap['t_seconds{origin="remote"}']["count"] == 4


def test_registry_delta_is_compact_and_windowed():
    reg = MetricsRegistry()
    c = reg.counter("moves_total")
    h = reg.histogram("h_seconds", buckets=(1.0,))
    c.inc(2)
    h.observe(0.5)
    d1, state = reg.delta_snapshot()
    assert {e["name"] for e in d1["metrics"]} == {"moves_total", "h_seconds"}
    d2, state = reg.delta_snapshot(state)
    assert d2["metrics"] == []
    c.inc(5)
    d3, state = reg.delta_snapshot(state)
    assert d3["metrics"] == [{"name": "moves_total", "labels": {},
                              "kind": "counter", "value": 5.0}]
    h.observe(3.0)
    d4, _ = reg.delta_snapshot(state)
    (entry,) = d4["metrics"]
    assert entry["count"] == 1 and entry["sum"] == 3.0


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 0.99, 1.0])
def test_histogram_quantile_interpolates_within_buckets(q):
    reg = MetricsRegistry()
    h = reg.histogram("q_seconds", buckets=(0.001, 0.01, 0.1, 1.0))
    before = h.cumulative()
    for v in np.random.RandomState(7).lognormal(-4.0, 2.0, size=500):
        h.observe(float(v))
    after = h.cumulative()
    got = quantile_from_cumulative(before, after, q)
    assert h.quantile(q, since=before) == got == h.quantile(q)
    assert 0.0 <= got <= 1.0
    assert h.quantile(q, since=after) == 0.0          # an empty window


def test_quantile_merge_law_and_ladder_mismatch():
    buckets = (0.001, 0.01, 0.1, 1.0)
    reg = MetricsRegistry()
    ha = reg.histogram("m_seconds", side="a", buckets=buckets)
    hb = reg.histogram("m_seconds", side="b", buckets=buckets)
    hu = reg.histogram("m_seconds", side="union", buckets=buckets)
    for i, v in enumerate(np.random.RandomState(3).lognormal(-3.0, 1.5, 400)):
        (ha if i % 2 else hb).observe(float(v))
        hu.observe(float(v))
    ha.merge_counts(*hb.raw_state())
    for q in (0.0, 0.5, 0.95, 1.0):
        assert ha.quantile(q) == hu.quantile(q)
    with pytest.raises(ValueError):
        ha.merge_counts([0, 0], 0.0, 0)


# -- span tracer -------------------------------------------------------------

def test_chrome_trace_export_shape_and_nesting(tmp_path):
    tr = SpanTracer()
    with tr.span("outer", round=1):
        with tr.span("inner", phase="aggregate"):
            time.sleep(0.005)
    tr.instant("marker", note="x")
    doc = json.load(open(tr.export_chrome(str(tmp_path / "trace.json"))))
    by_name = {e["name"]: e for e in doc["traceEvents"]
               if e.get("ph") in ("X", "i")}
    assert {"outer", "inner", "marker"} <= set(by_name)
    o, i = by_name["outer"], by_name["inner"]
    for e in (o, i):
        assert e["ph"] == "X"
        assert all(isinstance(e[k], (int, float)) for k in ("ts", "dur",
                                                             "pid", "tid"))
    assert o["tid"] == i["tid"] and o["ts"] <= i["ts"]
    assert i["ts"] + i["dur"] <= o["ts"] + o["dur"] + 1e-3
    assert i["args"] == {"phase": "aggregate"}
    lines = [json.loads(ln) for ln in open(tr.export_jsonl(
        str(tmp_path / "trace.jsonl")))]
    assert len(lines) == 4
    meta = lines[0]["__meta__"]
    assert meta["pid"] == os.getpid() and meta["dropped_events"] == 0
    assert abs(meta["epoch_unix"] - time.time()) < 60


def test_tracer_background_thread_lands_on_same_timeline():
    tr = SpanTracer()

    def work():
        with tr.span("bg.upload"):
            time.sleep(0.002)

    with tr.span("fg.round"):
        t = threading.Thread(target=work, name="h2d-test")
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    ev = {e["name"]: e for e in tr.events()}
    fg, bg = ev["fg.round"], ev["bg.upload"]
    assert bg["tid"] != fg["tid"]
    assert fg["ts"] <= bg["ts"] <= fg["ts"] + fg["dur"]


def test_tracer_ring_bound_counts_drops():
    tr = SpanTracer(max_events=10)
    for i in range(25):
        with tr.span(f"s{i}"):
            pass
    assert len(tr.events()) == 10 and tr.dropped == 15
    assert tr.events()[-1]["name"] == "s24"


def test_tracer_spill_keeps_head_ring_keeps_tail(tmp_path):
    spill = str(tmp_path / "spill.jsonl")
    tr = SpanTracer(max_events=5, spill_path=spill)
    try:
        for i in range(20):
            with tr.span(f"s{i}"):
                pass
        assert tr.dropped == 15 and tr.spilled == 20
        names = [json.loads(ln)["name"] for ln in open(spill)]
        assert names[:5] == ["s0", "s1", "s2", "s3", "s4"] and len(names) == 20
        meta = json.loads(open(tr.export_jsonl(
            str(tmp_path / "t.jsonl"))).readline())["__meta__"]
        assert meta["dropped_events"] == 15 and meta["spilled_events"] == 20
    finally:
        tr.close()


def test_tracer_spill_cap_counts_truncation(tmp_path):
    tr = SpanTracer(max_events=100, spill_path=str(tmp_path / "s.jsonl"),
                    spill_limit_bytes=300)
    try:
        for i in range(50):
            tr.instant(f"e{i}")
        assert tr.spill_truncated > 0
        assert tr.spilled + tr.spill_truncated == 50
        assert os.path.getsize(tmp_path / "s.jsonl") <= 300 + 200
    finally:
        tr.close()


def test_tracer_digest_aggregates_without_walking_the_ring():
    tr = SpanTracer(max_events=4)
    for _ in range(10):
        with tr.span("hot"):
            pass
    with tr.span("cold"):
        time.sleep(0.002)
    d = tr.digest(top=8)
    assert d["hot"][0] == 10 and d["cold"][0] == 1 and d["cold"][1] >= 1000
    assert list(d) == sorted(d, key=lambda k: -d[k][1])


def test_span_disabled_is_noop_singleton(clean_obs):
    s1, s2 = obs.span("a", x=1), obs.span("b")
    assert s1 is s2
    with s1:
        with s2:
            pass
    assert obs.tracer() is None and not obs.enabled()
    assert obs.export() == {} and obs.dump_flight("x") is None


# -- flight recorder ---------------------------------------------------------

def test_flight_dump_on_deadline_overrun(clean_obs, tmp_path):
    obs.configure(str(tmp_path), install_signal=False, export_at_exit=False)
    with obs.span("round", round=3):
        with obs.deadline("round3", 0.05):
            time.sleep(0.4)
    dumps = glob.glob(str(tmp_path / "flight-*.json"))
    assert len(dumps) == 1
    doc = json.load(open(dumps[0]))
    assert doc["reason"] == "deadline_overrun:round3"
    assert doc["thread_stacks"] and "metrics" in doc


def test_flight_deadline_cancelled_when_round_finishes(clean_obs, tmp_path):
    obs.configure(str(tmp_path), install_signal=False, export_at_exit=False)
    with obs.deadline("fast", 5.0):
        pass
    time.sleep(0.05)
    assert not glob.glob(str(tmp_path / "flight-*.json"))
    assert not any(t.name.startswith("obs-watchdog")
                   for t in threading.enumerate())


def test_flight_dump_on_sigusr1(clean_obs, tmp_path):
    obs.configure(str(tmp_path), export_at_exit=False)   # installs it
    with obs.span("round", round=7):
        pass
    os.kill(os.getpid(), signal.SIGUSR1)
    deadline = time.monotonic() + 5.0
    dumps = []
    while time.monotonic() < deadline and not dumps:
        dumps = glob.glob(str(tmp_path / "flight-*.json"))
        time.sleep(0.01)
    assert dumps, "SIGUSR1 produced no flight dump"
    doc = json.load(open(dumps[0]))
    assert doc["reason"] == "SIGUSR1"
    assert any(e.get("name") == "round" for e in doc["events"])


def test_configure_again_does_not_chain_to_itself(clean_obs, tmp_path):
    before = signal.getsignal(signal.SIGUSR1)
    obs.configure(str(tmp_path), export_at_exit=False)
    obs.configure(str(tmp_path), export_at_exit=False)
    assert obs._prev_sigusr1 is before
    assert getattr(signal.getsignal(signal.SIGUSR1), "_fedml_torch_obs")


# -- the facade: rollup, export, http ----------------------------------------

def test_rollup_surfaces_drops(clean_obs, tmp_path):
    obs.configure(str(tmp_path), install_signal=False, export_at_exit=False,
                  max_events=3)
    for i in range(9):
        with obs.span(f"r{i}"):
            pass
    ru = obs.rollup()
    assert ru["spans_dropped"] == 6 and ru["spans_recorded"] == 9
    assert ru["obs_dir"] == str(tmp_path) and ru["http_port"] is None


def test_export_writes_every_artifact(clean_obs, tmp_path):
    obs.configure(str(tmp_path), install_signal=False, export_at_exit=False)
    obs.counter("hits_total").inc(2)
    with obs.span("round"):
        pass
    out = obs.export()
    assert set(out) == {"chrome_trace", "jsonl_trace", "prometheus",
                        "metrics_json"}
    assert "hits_total 2" in open(out["prometheus"]).read()
    assert json.load(open(out["metrics_json"]))["hits_total"] == 2


def test_configure_from_env_and_spill(clean_obs, tmp_path, monkeypatch):
    monkeypatch.setenv(obs.ENV_VAR, str(tmp_path / "env"))
    monkeypatch.setenv(obs.ENV_SPILL, "1")
    assert obs.configure_from_env()
    assert not obs.configure_from_env()          # already on
    with obs.span("s"):
        pass
    assert obs.obs_dir() == str(tmp_path / "env")
    assert obs.tracer().spilled == 1


def test_http_endpoint_metrics_rollup_flight(clean_obs, tmp_path):
    obs.configure(str(tmp_path), install_signal=False, export_at_exit=False)
    obs.counter("http_hits_total", backend="t").inc(3)
    srv = obs.serve_http(0)
    assert srv is obs.serve_http(0)
    base = f"http://127.0.0.1:{srv.port}"
    prom = urllib.request.urlopen(f"{base}/metrics").read().decode()
    assert 'http_hits_total{backend="t"} 3' in prom
    assert json.loads(urllib.request.urlopen(f"{base}/rollup").read()
                      )["http_port"] == srv.port
    assert json.loads(urllib.request.urlopen(f"{base}/healthz").read()
                      )["status"] == "ok"
    fl = json.loads(urllib.request.urlopen(f"{base}/flight").read())
    assert fl["last_dump"] is None and fl["dumps"] == 0
    assert not glob.glob(str(tmp_path / "flight-*.json"))
    fl = json.loads(urllib.request.urlopen(urllib.request.Request(
        f"{base}/flight", method="POST"), data=b"").read())
    assert fl["dump"] and json.load(open(fl["dump"]))["reason"] == \
        "http_trigger"
    fl2 = json.loads(urllib.request.urlopen(f"{base}/flight").read())
    assert fl2["last_dump"] == fl["dump"] and fl2["dumps"] == 1
    # /slo answers 503 until an SLO engine is installed, /cluster the
    # observatory's report; any other path is unknown
    for path, code in (("/nope", 404), ("/slo", 503)):
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}{path}")
        assert err.value.code == code
    assert json.loads(urllib.request.urlopen(f"{base}/cluster").read()
                      )["scope"] == "local"
    obs.reset()
    with pytest.raises(OSError):
        urllib.request.urlopen(f"{base}/metrics", timeout=2)


def test_sample_device_memory_without_a_card(clean_obs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    obs.sample_device_memory()
    assert obs.registry().metrics() == []


# -- the port's spans: on and off bitwise ------------------------------------

def _data(n_clients=4, per_client=6, bs=3):
    rs = np.random.RandomState(0)
    n = n_clients * per_client
    x = rs.rand(n, 8, 8, 3).astype(np.float32)
    y = rs.randint(0, 10, n).astype(np.int64)
    idx = {i: np.arange(i * per_client, (i + 1) * per_client)
           for i in range(n_clients)}
    ev = tfed.build_eval_shard(x[:bs], y[:bs], bs)
    return tfed.FederatedData(
        train_data_num=n, test_data_num=bs, train_global=ev, test_global=ev,
        client_shards=tfed.build_client_shards(x, y, idx, bs),
        client_num_samples=np.full(n_clients, per_client, np.float32),
        test_client_shards=None, class_num=10, synthetic=True)


def _mesh_run():
    cfg = FedConfig(client_num_in_total=4, client_num_per_round=4,
                    comm_round=2, epochs=1, batch_size=3, lr=0.1,
                    frequency_of_the_test=1, round_deadline_s=60.0)
    trainer = ClientTrainer(create_model("resnet18_gn", 10, num_filters=4))
    eng = MeshFedAvgEngine(trainer, _data(), cfg, chunk=2, device="cpu")
    v = eng.run(variables=eng.init_variables(), rounds=2)
    return v, eng.metrics_history


def test_mesh_round_bitwise_obs_on_vs_off(clean_obs, tmp_path):
    v_off, m_off = _mesh_run()
    obs.configure(str(tmp_path), install_signal=False, export_at_exit=False)
    v_on, m_on = _mesh_run()
    assert all(torch.equal(v_off[k], v_on[k]) for k in v_off)
    assert [{k: v for k, v in m.items() if k != "round_time"} for m in m_off] \
        == [{k: v for k, v in m.items() if k != "round_time"} for m in m_on]
    out = obs.export()
    doc = json.load(open(out["chrome_trace"]))
    names = [e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert names.count("round") == 2 and names.count("eval") == 2
    assert names.count("h2d.upload_cohort") == 2
    assert names.count("trace.local_train") == 8
    assert names.count("trace.evaluate") >= 4
    rounds = [e for e in doc["traceEvents"] if e.get("name") == "round"]
    assert [e["args"]["engine"] for e in rounds] == ["MeshFedAvgEngine"] * 2
    # no flight dump: the deadline was not overrun
    assert not glob.glob(str(tmp_path / "flight-*.json"))


def _fednas_run():
    data = _data(2, 4, 2)
    cfg = FedConfig(client_num_in_total=2, client_num_per_round=2,
                    comm_round=1, epochs=1, batch_size=2, lr=0.05,
                    frequency_of_the_test=1)
    eng = FedNASSearchEngine(data, cfg, C=4, layers=1, steps=2, multiplier=2,
                             device="cpu")
    params, alphas = eng.run(rounds=1)
    return eng.net.flatten(params), eng.flatten_alphas(alphas)


def test_fednas_bitwise_obs_on_vs_off(clean_obs, tmp_path):
    off = _fednas_run()
    obs.configure(str(tmp_path), install_signal=False, export_at_exit=False)
    on = _fednas_run()
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    names = [e["name"] for e in obs.tracer().events()]
    assert names.count("round") == 1 and names.count("eval") == 1


def test_engine_error_dumps_flight(clean_obs, tmp_path):
    cfg = FedConfig(client_num_in_total=4, client_num_per_round=4,
                    comm_round=1, batch_size=3, lr=0.1)
    eng = FedAvgEngine(ClientTrainer(create_model("lr", 10, input_dim=192)),
                       _data(), cfg, device="cpu")
    obs.configure(str(tmp_path), install_signal=False, export_at_exit=False)

    def boom(*a, **kw):
        raise RuntimeError("round exploded")

    eng.round_fn = boom
    with pytest.raises(RuntimeError, match="round exploded"):
        eng.run(rounds=1)
    dumps = glob.glob(str(tmp_path / "flight-*.json"))
    assert len(dumps) == 1
    assert "engine_error:FedAvgEngine" in json.load(open(dumps[0]))["reason"]
