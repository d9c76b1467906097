"""The port's observatory (fedml_tpu_torch/obs: programs.py, timeline.py,
slo.py, cluster.py and httpd's /slo and /cluster), on the CPU.

* programs: dispatch counts and host walls per family, attribute access
  passed through and values untouched, the thread's current family, the
  first-use build counters attributed to the family that triggered them
  (through a stubbed build), CUDA event pairs queued in the dispatch path
  and resolved only by snapshot()/report() (fake events: this box has no
  card), the live FLOP census under FlopCounterMode on one run of the
  round, load_census against the JAX package's, and report()'s keys
  equal to the JAX package's plus ``stream_s``.  Every engine names the
  JAX family of its round, and a round is bitwise the same through the
  wrapper, observability on, as through the bare function.
* timeline: critical path, merge, rebase, clock offsets, lanes, the
  Chrome export and the text report on a fixed two-process event list:
  the JAX package's output exactly.
* slo: the same metric writes judged by both packages' engines give the
  same reports (validation, breaches with attribution, burn windows,
  quantile windows, no-data); the background evaluator; the breach dump.
* cluster: the sidecar trailer and the barrier ledger as the JAX
  package's; the cluster SLO names the dead rank; the coordinated dump
  fans out once per window; the ledger exports with the other artifacts.
* httpd: /slo answers 503 until an engine is installed, then its report
  with a scope; /cluster the observatory's report.

Tolerance: bitwise for reports built from the same registry contents;
window-dependent rates (a rate is a delta over wall seconds) compare by
status only.
"""
import glob
import json
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from fedml_tpu import obs as jax_obs
from fedml_tpu.obs import cluster as jax_cluster
from fedml_tpu.obs import programs as jax_programs
from fedml_tpu.obs import slo as jax_slo
from fedml_tpu.obs import timeline as jax_timeline
from fedml_tpu_torch import obs
from fedml_tpu_torch.obs import cluster, programs, slo, timeline
from fedml_tpu_torch.utils.config import FedConfig
from tests.test_torch_transports import with_free_ports

torch.set_num_threads(2)


@pytest.fixture
def clean_obs(monkeypatch):
    for var in (obs.ENV_VAR, obs.ENV_HTTP, obs.ENV_SPILL):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.delenv(programs.ENV_PEAK_FLOPS, raising=False)
    prev = signal.getsignal(signal.SIGUSR1)
    obs.reset()
    jax_obs.reset()
    yield
    programs.enable_census(False)
    obs.reset()
    jax_obs.reset()
    signal.signal(signal.SIGUSR1, prev)


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------

def test_instrument_counts_walls_and_passes_through(clean_obs):
    seen = []

    def round_fn(x, scale=2.0):
        seen.append(programs.current())
        return x * scale
    round_fn.tag = "mine"
    prog = programs.instrument("fedavg_streaming", round_fn)
    x = torch.arange(8.0)
    snap = programs.snapshot()
    for _ in range(3):
        out = prog(x, scale=3.0)
    assert torch.equal(out, x * 3.0) and prog.tag == "mine"
    assert seen == ["fedavg_streaming"] * 3 and programs.current() is None
    assert obs.counter("program_dispatches_total",
                       family="fedavg_streaming").value == 3
    row, = programs.report(snap)["families"]
    assert (row["family"], row["stage"], row["dispatches"]) == (
        "fedavg_streaming", "train", 3)
    assert row["dispatch_p95_s"] > 0 and row["dispatch_wall_s"] > 0
    assert row["stream_s"] == 0.0                # CPU tensors: no events
    again = programs.instrument("fedavg_resident", prog)
    assert again.inner is round_fn and again.family == "fedavg_resident"
    assert "fedavg_streaming" in obs.rollup()["program_families"]


def test_report_keys_are_jax_plus_stream_seconds(clean_obs):
    port = programs.instrument("async_commit", lambda x: x + 1)
    ref = jax_programs.instrument("async_commit", lambda x: x + 1)
    for _ in range(2):
        port(torch.zeros(2))
        ref(np.zeros(2))
    delta = {"schema": 1, "metrics": [
        {"name": "program_dispatches_total",
         "labels": {"family": "async_commit"}, "kind": "counter",
         "value": 3}]}
    obs.registry().merge_delta(delta, origin="host1")
    jax_obs.registry().merge_delta(delta, origin="host1")
    got, want = programs.report(), jax_programs.report()
    assert set(got) == set(want) and set(got["total"]) == set(want["total"])
    assert set(got["families"][0]) == set(want["families"][0]) | {"stream_s"}
    assert got["processes"] == want["processes"]
    assert got["families"][0]["stage"] == want["families"][0]["stage"]
    assert programs.format_table(got).splitlines()[0].split()[:5] == [
        "family", "stage", "disp", "wall", "s"]


class _Event:
    """A stand-in for torch.cuda.Event: records what was asked of it."""
    log = []

    def __init__(self, enable_timing=False):
        self.t, self.done = None, False

    def record(self, stream=None):
        self.t = time.perf_counter()
        _Event.log.append("record")

    def query(self):
        _Event.log.append("query")
        return self.done

    def synchronize(self):
        _Event.log.append("synchronize")
        self.done = True

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_cuda_events_are_queued_in_the_dispatch_and_resolved_by_reports(
        clean_obs, monkeypatch):
    """On the card a dispatch records an event pair on the current stream
    and never waits; snapshot()/report() wait for the pairs and add their
    elapsed time to the family's stream seconds."""
    monkeypatch.setattr(programs, "_cuda_device", lambda a, k: "cuda:0")
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: "stream")
    _Event.log = []
    prog = programs.instrument("fedavg_streaming",
                               lambda: time.sleep(0.002))
    for _ in range(3):
        prog()
    assert _Event.log == ["record"] * 6          # no wait in the dispatch
    counter = obs.counter("program_stream_seconds_total",
                          family="fedavg_streaming")
    assert counter.value == 0.0
    row, = programs.report()["families"]
    assert _Event.log.count("synchronize") == 3
    assert 0.006 <= row["stream_s"] <= row["dispatch_wall_s"] + 1e-3
    assert counter.value == pytest.approx(row["stream_s"], abs=1e-6)
    # past the cap the dispatch path resolves only what the stream passed
    fam = programs.register("fedavg_streaming")
    _Event.log = []
    for i in range(programs.MAX_PENDING_EVENTS + 1):
        start, end = _Event(), _Event()
        start.t, end.t, end.done = 0.0, 1e-3, i < 5
        fam.add_events(start, end)
    assert "synchronize" not in _Event.log
    assert len(fam._pending) == programs.MAX_PENDING_EVENTS + 1 - 5


def test_cuda_device_is_read_from_the_arguments():
    cpu = {"w": torch.zeros(2)}
    assert programs._cuda_device((cpu, (), {"x": torch.zeros(1)}, 3), {}) \
        is None
    assert programs._cuda_device((), {}) is None
    assert programs._cuda_device(((), 5), {"v": [1, 2]}) is None


def test_kernel_builds_count_under_the_triggering_family(
        clean_obs, monkeypatch, tmp_path):
    """A stubbed first-use build of the kernels (no nvcc here) counts once,
    attributed to the program family whose dispatch triggered it; a reused
    build counts nothing; a build outside any family is unattributed."""
    from fedml_tpu_torch.ops import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_sources", lambda: ([], "stub"))
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")

    class Done:
        returncode, stdout = 0, ""

    def fake_run(cmd, **kw):
        open(cmd[-1], "wb").close()          # the linked library
        return Done()

    monkeypatch.setattr(build.subprocess, "run", fake_run)
    path = programs.instrument("fedavg_streaming", build.build)()
    assert path.exists()
    assert programs.instrument("fedavg_streaming", build.build)() == path
    reg = obs.registry()
    assert reg.counter("kernel_build_total").value == 1
    assert reg.counter("kernel_build_total",
                       family="fedavg_streaming").value == 1
    assert reg.counter("kernel_build_seconds_total",
                       family="fedavg_streaming").value > 0
    path.unlink()
    build.build()
    assert reg.counter("kernel_build_total", family="unattributed").value == 1
    ru = obs.rollup()
    assert ru["kernel_build_total"] == 2 and ru["kernel_build_seconds_total"] > 0
    row, = programs.report()["families"]
    assert row["compile_seconds"] > 0            # the family's build seconds


def test_live_census_counts_one_run_of_the_round(clean_obs):
    """enable_census: the first dispatch runs once under FlopCounterMode
    (a 64x64 matmul is 2 * 64^3 FLOPs); the round's generator draws are
    those of a run without the census; later dispatches are not counted
    again.  MFU follows from a given peak."""
    calls = []

    def round_fn(a, gen):
        calls.append(1)
        return a @ a + torch.rand(a.shape, generator=gen)

    a = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    want = [round_fn(a, g) for g in [torch.Generator().manual_seed(1)] * 2]
    calls.clear()
    programs.enable_census(True)
    prog = programs.instrument("fedavg_resident", round_fn)
    snap = programs.snapshot()
    gen = torch.Generator().manual_seed(1)
    got = [prog(a, gen) for _ in range(2)]
    assert len(calls) == 2
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    fam = programs.register("fedavg_resident")
    assert fam.flops_per_dispatch == 2 * 64 ** 3
    assert fam.census_source == programs.LIVE_CENSUS_SOURCE
    assert "ctypes kernels excluded" in fam.census_source
    row, = programs.report(snap, peak=1e9)["families"]
    assert row["flops_total"] == 2 * 2 * 64 ** 3 and row["mfu"] > 0


def test_load_census_and_peak_flops_as_jax(clean_obs, monkeypatch):
    art = {"families": {
        "async_stream_commit": {"programs": {
            "a": {"flops": 1000.0, "bytes_accessed": 4000.0},
            "b": {"flops": 24.0}}},
        "no_census": {"programs": {"p": {"copy_ops": 0}}}}}
    assert programs.load_census(art) == jax_programs.load_census(art) == 1
    got = programs.register("async_stream_commit")
    want = jax_programs.register("async_stream_commit")
    assert (got.flops_per_dispatch, got.bytes_per_dispatch,
            got.census_source) == (want.flops_per_dispatch,
                                   want.bytes_per_dispatch,
                                   want.census_source)
    assert programs.peak_flops() is None          # no constant carried over
    monkeypatch.setenv(programs.ENV_PEAK_FLOPS, "9.89e14")
    assert programs.peak_flops() == 9.89e14


def _data(n_clients=4, per=6, bs=3, hw=8):
    from fedml_tpu_torch.data import federated as tfed
    rs = np.random.RandomState(0)
    n = n_clients * per
    x = rs.rand(n, hw, hw, 3).astype(np.float32)
    y = rs.randint(0, 10, n).astype(np.int64)
    idx = {i: np.arange(i * per, (i + 1) * per) for i in range(n_clients)}
    ev = tfed.build_eval_shard(x[:bs], y[:bs], bs)
    return tfed.FederatedData(
        train_data_num=n, test_data_num=bs, train_global=ev, test_global=ev,
        client_shards=tfed.build_client_shards(x, y, idx, bs),
        client_num_samples=np.full(n_clients, per, np.float32),
        test_client_shards=None, class_num=10, synthetic=True)


def _engines():
    from fedml_tpu_torch import algorithms as A
    from fedml_tpu_torch.algorithms.turboaggregate import TurboAggregateEngine
    from fedml_tpu_torch.parallel import engine as P
    return [
        (A.FedAvgEngine, {}, "fedavg_resident"),
        (A.FedProxEngine, {}, "fedprox_resident"),
        (A.FedOptEngine, {}, "fedopt_resident"),
        (A.FedNovaEngine, {}, "fednova_resident"),
        (A.FedAvgRobustEngine, {}, "robust_orderstat"),
        (A.HierarchicalFedAvgEngine, dict(group_num=2), "hierarchical"),
        (TurboAggregateEngine, {}, "turboaggregate_resident"),
        (P.MeshFedAvgEngine, dict(chunk=2), "fedavg_streaming"),
        (P.MeshFedProxEngine, dict(chunk=2), "fedprox_streaming"),
        (P.MeshFedOptEngine, dict(chunk=2), "fedopt_streaming"),
        (P.MeshFedNovaEngine, dict(chunk=2), "fednova_streaming"),
        (P.MeshRobustEngine, dict(chunk=2), "robust_orderstat"),
    ]


def test_every_engine_names_its_jax_family(clean_obs):
    from fedml_tpu_torch.core.trainer import ClientTrainer
    from fedml_tpu_torch.models import create_model
    trainer = ClientTrainer(create_model("resnet18_gn", 10, num_filters=4),
                            lr=0.1)
    cfg = FedConfig(client_num_in_total=4, client_num_per_round=4,
                    batch_size=3, lr=0.1, prox_mu=0.1)
    data = _data()
    for cls, kw, family in _engines():
        eng = cls(trainer, data, cfg, device="cpu", **kw)
        assert eng.program_family == family, cls.__name__
        assert isinstance(eng.round_fn, programs.InstrumentedProgram)
        assert jax_timeline.PROGRAM_FAMILY_STAGES.get(
            family, "train") == timeline.PROGRAM_FAMILY_STAGES[family] \
            == "train"


@pytest.mark.parametrize("mesh", [False, True])
def test_a_round_through_the_wrapper_is_the_bare_round(clean_obs, tmp_path,
                                                        mesh):
    """Off: the bare round function, observability off.  On: the
    instrumented dispatch with observability on.  Bitwise the same, and
    one dispatch counted under the engine's family."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgEngine
    from fedml_tpu_torch.core.trainer import ClientTrainer
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.parallel.engine import MeshFedAvgEngine
    trainer = ClientTrainer(create_model("resnet18_gn", 10, num_filters=4),
                            lr=0.1)
    cfg = FedConfig(client_num_in_total=4, client_num_per_round=4,
                    batch_size=3, lr=0.1)
    eng = (MeshFedAvgEngine(trainer, _data(), cfg, chunk=2, device="cpu")
           if mesh else FedAvgEngine(trainer, _data(), cfg, device="cpu"))
    v0 = eng.init_variables()
    off = eng.round_fn.inner(dict(v0), (), *eng._round_args(0))
    obs.configure(str(tmp_path), install_signal=False, export_at_exit=False)
    on = eng.round_fn(dict(v0), (), *eng._round_args(0))
    for k in v0:
        assert torch.equal(off[0][k], on[0][k]), k
    assert torch.equal(off[2]["train_loss"], on[2]["train_loss"])
    row, = programs.report()["families"]
    assert row["family"] == eng.program_family and row["dispatches"] == 1


# ---------------------------------------------------------------------------
# timeline
# ---------------------------------------------------------------------------

def _events(shift=0.0):
    """A server's trace: two rounds delimited by fsm.aggregate, with
    sends, decodes, an eval, an upload and reactor housekeeping, and a
    client's train spans (on another thread)."""
    X = lambda name, ts, dur, **args: {"name": name, "ph": "X", "ts": ts + shift,
                                      "dur": dur, "pid": 1, "tid": 1,
                                      "args": args}
    return [
        X("comm.send", 0.0, 1e3, node="server", rank=0),
        X("fsm.local_train", 2e3, 40e3, rank=1),
        X("fsm.local_train", 3e3, 55e3, rank=2),
        X("comm.send", 60e3, 2e3, node="client", rank=1),
        X("comm.decode", 63e3, 3e3, backend="tcp"),
        X("comm.decode", 64e3, 3e3, backend="tcp"),
        X("fsm.aggregate", 68e3, 4e3, round=0, node="server"),
        X("comm.send", 73e3, 1e3, node="server", rank=0),
        X("h2d.upload", 74e3, 2e3),
        X("fsm.local_train", 75e3, 30e3, rank=1),
        X("eval", 80e3, 5e3),
        X("reactor.housekeep", 90e3, 1e3),
        X("comm.decode", 110e3, 2e3, backend="tcp"),
        X("fsm.aggregate", 115e3, 5e3, round=1, node="server"),
        {"name": "chaos.drop", "ph": "i", "ts": 50e3 + shift, "pid": 1,
         "tid": 2, "args": {}},
    ]


def test_timeline_is_the_jax_timeline(tmp_path):
    meta0 = {"epoch_unix": 1_700_000_000.0, "pid": 1}
    meta1 = {"epoch_unix": 1_700_000_000.5, "pid": 2}
    clocks = [(meta0, [{"rank": 0, "offsets_s": {"1": 0.002}}]),
              (meta1, [{"rank": 1, "offsets_s": {"0": -0.002}}])]
    assert timeline.dir_offsets(clocks) == jax_timeline.dir_offsets(clocks)
    offs = timeline.dir_offsets(clocks)
    srcs = [(meta0, _events(), offs[0]), (meta1, _events(7e3), offs[1])]
    merged = timeline.merge_traces(srcs)
    assert merged == jax_timeline.merge_traces(srcs)
    assert timeline.rebase(_events(), meta1, 0.25) == jax_timeline.rebase(
        _events(), meta1, 0.25)
    for evs in (_events(), merged, [e for e in _events()
                                    if e["name"] != "fsm.aggregate"]):
        got, want = timeline.critical_path(evs), jax_timeline.critical_path(evs)
        assert got == want
        assert timeline.format_report(got) == jax_timeline.format_report(want)
        assert timeline.lane_events(got) == jax_timeline.lane_events(want)
    rep = timeline.critical_path(_events())
    assert rep["n_rounds"] == 2 and [r["round"] for r in rep["rounds"]] == [0, 1]
    for r in rep["rounds"]:
        assert sum(r["stages"].values()) == pytest.approx(r["wall_s"])
    assert {"train", "decode", "commit", "wait"} <= set(rep["stage_share"])
    ledger = [{"kind": "exchange", "seq": 1, "round": 0,
               "round_gating_rank": 2, "gate_margin_s": 0.1,
               "waits_s": {"0": 0.3, "1": 0.1, "2": 0.0}, "t_unix": 5.0}]
    assert timeline.barrier_lane_events(ledger) == \
        jax_timeline.barrier_lane_events(ledger)
    a = timeline.export_chrome(merged, str(tmp_path / "a.json"), rep, ledger)
    b = jax_timeline.export_chrome(merged, str(tmp_path / "b.json"), rep,
                                   ledger)
    assert json.load(open(a)) == json.load(open(b))
    path = tmp_path / "trace.jsonl"
    path.write_text(json.dumps({"__meta__": meta0}) + "\n" + "".join(
        json.dumps(e) + "\n" for e in _events()))
    assert timeline.load_trace_jsonl(str(path)) == \
        jax_timeline.load_trace_jsonl(str(path)) == (meta0, _events())
    assert timeline.stage_of({"name": "comm.send", "args": {"node": "client"}}
                             ) == "uplink"


def test_timeline_reads_the_port_tracer(clean_obs, tmp_path):
    obs.configure(str(tmp_path), install_signal=False, export_at_exit=False)
    for r in range(3):
        with obs.span("fsm.local_train", rank=1):
            time.sleep(0.003)
        with obs.span("fsm.aggregate", round=r, node="server"):
            pass
    rep = timeline.critical_path(obs.tracer().events())
    assert rep["n_rounds"] == 3 and rep["stage_share"]["train"] > 0.3
    path = obs.export()["jsonl_trace"]
    meta, events = timeline.load_trace_jsonl(path)
    assert timeline.critical_path(timeline.rebase(events, meta))[
        "n_rounds"] == 3


# ---------------------------------------------------------------------------
# slo
# ---------------------------------------------------------------------------

def test_slo_validation_as_jax():
    for mod in (slo, jax_slo):
        with pytest.raises(ValueError, match="unknown SLO kind"):
            mod.spec("x", "m", "nope", 1.0)
        with pytest.raises(ValueError, match="q must be"):
            mod.spec("x", "m", "quantile_max", 1.0, q=1.5)
        with pytest.raises(ValueError, match="burn_windows"):
            mod.spec("x", "m", "rate_min", 1.0, burn_windows=0)
        with pytest.raises(ValueError, match="duplicate SLO names"):
            mod.SloEngine([mod.spec("dup", "m", "delta_max", 0.0)] * 2)
    assert [(s.name, s.metric, s.kind, s.target, s.labels, s.q,
             s.burn_windows) for s in slo.default_slo_pack()] == \
        [(s.name, s.metric, s.kind, s.target, s.labels, s.q, s.burn_windows)
         for s in jax_slo.default_slo_pack()]


def _windows(facade, mod):
    """The same metric writes and evaluations through one package: five
    windows (green, breach with a labelled series, a slow quantile
    window, an idle one, a burning gauge)."""
    eng = mod.SloEngine([
        mod.spec("floor", "work_total", "rate_min", 1.0),
        mod.spec("no_bad", "bad_total", "delta_max", 0.0),
        mod.spec("p95", "lat_seconds", "quantile_max", 0.1, q=0.95),
        mod.spec("ghost", "never_written_total", "delta_max", 0.0),
        mod.spec("burn", "bad_total", "delta_max", 0.0, burn_windows=2,
                 labels={"backend": "tcp"}),
        mod.spec("depth", "queue_depth", "gauge_max", 5.0),
    ], dump_min_interval_s=1e9)
    eng.prime()
    h = facade.histogram("lat_seconds", buckets=(0.01, 0.1, 1.0))
    reports = []
    for step in range(5):
        facade.counter("work_total").inc(1000)
        if step in (1, 2, 3):
            facade.counter("bad_total", backend="tcp").inc(2)
            facade.counter("bad_total", backend="grpc").inc()
        for _ in range(50):
            h.observe(0.5 if step == 2 else 0.005)
        facade.gauge("queue_depth").set(3.0 + 2 * step)
        time.sleep(0.002)
        reports.append(eng.evaluate())
    return reports, eng


def test_slo_engine_reports_are_jax(clean_obs):
    got, eng = _windows(obs, slo)
    want, _ = _windows(jax_obs, jax_slo)
    for g, w in zip(got, want):
        for a, b in zip(g["slos"], w["slos"]):
            if a["kind"] == "rate_min":      # a delta over wall seconds
                a, b = dict(a, value=None), dict(b, value=None)
            assert a == b
        assert {k: v for k, v in g.items() if k != "slos"} == \
            {k: v for k, v in w.items() if k != "slos"}
    last = got[-1]
    assert set(last["breached"]) == {"no_bad", "p95", "burn", "depth"}
    assert obs.counter("slo_breaches_total", slo="no_bad").value == 3
    assert obs.gauge("slo_healthy", slo="ghost").value == 1.0
    assert eng.arm_summary() == {"breaches": last["breaches"],
                                 "breached": last["breached"],
                                 "healthy": False}


def test_slo_breach_dump_is_throttled(clean_obs, tmp_path):
    obs.configure(str(tmp_path), install_signal=False, export_at_exit=False)
    eng = slo.SloEngine([slo.spec("no_bad", "bad3_total", "delta_max", 0.0)],
                        dump_min_interval_s=60.0)
    eng.prime()
    for _ in range(2):
        obs.counter("bad3_total").inc()
        eng.evaluate()
    dumps = glob.glob(str(tmp_path / "flight-*.json"))
    assert len(dumps) == 1
    doc = json.load(open(dumps[0]))
    assert doc["reason"] == "slo_breach:no_bad"
    assert doc["slo"]["breached"] == ["no_bad"]


def test_slo_background_evaluator_installs_and_stops(clean_obs):
    eng = slo.SloEngine([slo.spec("ok", "y_total", "delta_max", 10.0)])
    with pytest.raises(ValueError, match="period_s"):
        eng.start(period_s=0)
    eng.start(period_s=0.05)
    assert slo.active() is eng and obs.rollup()["slo"]["pack"] == \
        slo.DEFAULT_PACK_NAME
    time.sleep(0.25)
    eng.stop()
    assert eng._thread is None and eng.report()["windows_evaluated"] >= 3
    obs.reset()
    assert slo.active() is None


# ---------------------------------------------------------------------------
# cluster
# ---------------------------------------------------------------------------

def test_sidecar_and_ledger_are_jax(clean_obs):
    obs.counter("x_total").inc(3)
    delta, _ = obs.registry().delta_snapshot()
    payload = b"\x01\x02carry\x00fml"
    frame = cluster.attach_sidecar(payload, delta)
    assert frame == jax_cluster.attach_sidecar(payload, delta) != payload
    assert cluster.split_sidecar(frame) == (payload, delta)
    for raw in (payload, b"", b"\xff" * 12 + cluster.SIDECAR_MAGIC):
        assert cluster.split_sidecar(raw) == (raw, None)
    assert cluster.SIDECAR_MAGIC == jax_cluster.SIDECAR_MAGIC
    arrivals = [("allgather", 1, 0, {0: 10.0, 1: 10.1, 2: 10.5}),
                ("allgather", 2, 1, {0: 10.0, 1: 10.6, 2: 10.2}),
                ("exchange", 3, 2, {0: 10.0, 1: 10.1, 2: 10.5}),
                ("gather", 4, None, {0: 10.0})]
    for mod in (cluster, jax_cluster):
        mod.set_role(0, 3)
        for a in arrivals:
            mod.note_barrier(*a)
    strip = lambda es: [{k: v for k, v in e.items() if k != "t_unix"}
                        for e in es]
    assert strip(cluster.barrier_ledger()) == strip(
        jax_cluster.barrier_ledger())
    got, want = cluster.straggler_summary(), jax_cluster.straggler_summary()
    got["recent"], want["recent"] = strip(got["recent"]), strip(want["recent"])
    assert got == want and got["top_gating_rank"] == 2
    assert obs.histogram("multihost_barrier_wait_seconds", rank="0").count == 3
    assert [(s.name, s.kind, s.target) for s in cluster.cluster_slo_pack()] \
        == [(s.name, s.kind, s.target) for s in jax_cluster.cluster_slo_pack()]


def test_cluster_slo_names_the_dead_rank_and_folds_remote_deltas(clean_obs):
    cluster.set_role(0, 3)
    assert cluster.scope() == "cluster"
    obs.counter("multihost_rounds_committed_total").inc()
    cluster.note_barrier("exchange", 0, 0, {0: 1.0, 1: 1.2, 2: 1.1})
    rep = cluster.cluster_slo_report()
    assert rep["scope"] == "cluster" and rep["healthy"], rep
    peer = obs.MetricsRegistry()
    peer.counter("multihost_rank_deaths_total", rank="1").inc()
    cluster.fold_remote(2, peer.delta_snapshot()[0])
    cluster.fold_remote(2, {"metrics": "not a list"})     # dropped, logged
    assert any(dict(m.labels).get("origin") == "host2"
               for m in obs.registry().metrics())
    obs.counter("multihost_rounds_committed_total").inc()
    rep = cluster.cluster_slo_report()
    assert rep["breached"] == ["cluster_no_rank_deaths"]
    assert rep["attribution"]["dead_ranks"] == ["1"]
    assert rep["attribution"]["gating_rank"] == 1
    cluster.note_heartbeat(1)
    doc = cluster.cluster_report()
    assert doc["ranks"]["1"]["alive"] and doc["ranks"]["0"]["self"]
    assert doc["ranks"]["2"]["last_fold_age_s"] is not None
    obs.reset()
    cluster.set_role(2, 3)
    assert cluster.cluster_slo_report() is None and cluster.scope() == "local"


def test_coordinated_dump_fans_out_once_a_window(clean_obs, tmp_path):
    assert cluster.maybe_coordinated_dump("nope") is False   # obs off
    obs.configure(str(tmp_path), install_signal=False, export_at_exit=False)
    fanned = []
    cluster.set_dump_broadcaster(fanned.append)
    assert cluster.maybe_coordinated_dump("view_change") is True
    assert cluster.maybe_coordinated_dump("storm") is False
    assert fanned == ["view_change"]
    assert obs.counter("multihost_coordinated_dumps_total").value == 1
    dump, = glob.glob(str(tmp_path / "flight-*.json"))
    assert json.load(open(dump))["reason"] == "coordinated:view_change"
    cluster.set_role(0, 2)
    cluster.note_barrier("allgather", 1, 0, {0: 1.0, 1: 1.3})
    out = obs.export()
    doc = json.load(open(out["barrier_ledger"]))
    assert doc["summary"]["top_gating_rank"] == 1 and len(doc["entries"]) == 1


# ---------------------------------------------------------------------------
# httpd
# ---------------------------------------------------------------------------

def test_httpd_slo_and_cluster_endpoints(clean_obs):
    srv = with_free_ports(1, lambda base: obs.serve_http(base))
    base = f"http://127.0.0.1:{srv.port}"
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(f"{base}/slo")
    assert err.value.code == 503
    eng = slo.SloEngine([slo.spec("ok", "q_total", "delta_max", 10.0)])
    eng.prime()
    eng.evaluate()
    slo.install(eng)
    sl = json.loads(urllib.request.urlopen(f"{base}/slo").read())
    assert sl["healthy"] and sl["scope"] == "local"
    assert sl["slos"][0]["name"] == "ok"
    cl = json.loads(urllib.request.urlopen(f"{base}/cluster").read())
    assert cl["scope"] == "local" and cl["rank"] is None
    cluster.set_role(0, 2)
    cl = json.loads(urllib.request.urlopen(f"{base}/cluster").read())
    assert cl["scope"] == "cluster" and cl["world"] == 2
    assert cl["slo"]["scope"] == "cluster" and "straggler" in cl
    sl = json.loads(urllib.request.urlopen(f"{base}/slo").read())
    assert sl["scope"] == "cluster"
    assert threading.active_count() > 1
