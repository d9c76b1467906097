"""Concurrent-uplink ingestion torture and the live-connection torture
(port of fedml_tpu/async_/torture.py).

The server's deserialize-and-aggregate path becomes the bottleneck under
concurrent uplinks (the Smart-NIC FL study, arXiv:2307.06561): receive
threads decoding frames, one manager lock serializing buffer inserts,
and an O(K*P) drained reduction at every commit.  `run_ingest_torture`
prices that path: N in-process simulated clients saturate a real backend
(TCP sockets, gRPC channels or the in-process router) with pre-encoded
result frames, no training and no downlinks, while the server ingests and
commits on its device (the card unless the caller names another),
reporting

    committed-updates/sec    sum of n_real over timed commits / wall
    decode p50/p95           from the comm_decode_seconds histogram
    lock wait                async_lock_wait_seconds growth (contention)

Clients send pre-encoded frames, so the wall measures the server's
ingestion pipeline alone.  Every arrival folds through the streaming
buffer (the fold kernel's accumulate form) or, defended, through the
screened fold (the squared-distance and clipped-fold kernels); the
legacy arm drains the [K, P] matrix at each commit.

`run_connection_torture` holds N live connections against one
reactor-transport server with paced, enveloped uplinks, and reports
admission latency, evictions, shedding and the FD delta.  The report keys
of both are the JAX package's.
"""
from __future__ import annotations

import logging
import os
import socket
import struct
import threading
import time
from typing import Optional

import numpy as np

from fedml_tpu_torch import obs
import torch

from fedml_tpu_torch.obs import propagate
from fedml_tpu_torch.obs import slo as obs_slo
from fedml_tpu_torch.obs.metrics import quantile_from_cumulative
from fedml_tpu_torch.async_.lifecycle import AsyncMessage, AsyncServerManager
from fedml_tpu_torch.comm import reliability
from fedml_tpu_torch.comm.chaos import ChaosConfig, ChaosPolicy
from fedml_tpu_torch.comm.message import Message, MessageCodec
from fedml_tpu_torch.comm.reliability import BackoffPolicy, ReliableEndpoint
from fedml_tpu_torch.comm.tcp_backend import _read_exact

log = logging.getLogger(__name__)

DEFAULT_P = 262_144          # 1 MiB f32 rows — a small-CNN-sized uplink


def make_template(p: int) -> dict:
    """Synthetic variables of exactly `p` f32 elements, shaped like a small
    model (one matrix and two vectors, the JAX package's shapes) so the
    RowLayout has several leaves to tile and the frame several buffers:
    a flat {name: tensor} dict in the port's naming."""
    if p < 4:
        return {"w": torch.zeros(p)}
    cols = 64 if p >= 8192 else 4
    rows = max(1, (p // 2) // cols)
    rest = p - rows * cols
    bias = rest // 2
    return {"dense.kernel": torch.zeros(rows, cols),
            "dense.bias": torch.zeros(bias),
            "head": torch.zeros(rest - bias)}


def _result_frame(template: dict, rank: int, p_seed: int) -> bytes:
    """One pre-encoded C2S result frame from `rank` (version 0: the
    torture server runs constant staleness weights, so the growing
    staleness is weight-neutral).  The values are RandomState(p_seed)
    draws, leaf by leaf in sorted-name order."""
    rs = np.random.RandomState(p_seed)
    vals = {k: torch.from_numpy(
        rs.randn(*template[k].shape).astype(np.float32))
        for k in sorted(template)}
    msg = Message(AsyncMessage.MSG_TYPE_C2S_ASYNC_RESULT, rank, 0)
    msg.add_params(AsyncMessage.MSG_ARG_KEY_MODEL_PARAMS,
                   {k: vals[k] for k in template})
    msg.add_params(AsyncMessage.MSG_ARG_KEY_NUM_SAMPLES, 32.0)
    msg.add_params(AsyncMessage.MSG_ARG_KEY_VERSION, 0)
    # under tracing, frames carry the trace block a real uplink would;
    # obs off, the frame is byte for byte the untraced one
    propagate.stamp(msg, rank)
    return MessageCodec.encode(msg)


# ---------------------------------------------------------------------------
# client drivers — raw-transport uplink spammers
# ---------------------------------------------------------------------------

def _tcp_client(host: str, port: int, frame: bytes, stop: threading.Event):
    prefix = struct.pack("<Q", len(frame))
    wire = prefix + frame                  # one buffer, one sendall
    s = socket.create_connection((host, port), timeout=30)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    try:
        while not stop.is_set():
            s.sendall(wire)                # kernel bufs = backpressure
    except OSError:
        pass                               # server closed mid-send
    finally:
        s.close()


def _grpc_client(host: str, port: int, frame: bytes, stop: threading.Event):
    from fedml_tpu_torch.comm.grpc_backend import open_stub
    ch, stub, rpc_error = open_stub(host, port)
    try:
        while not stop.is_set():
            stub(frame, timeout=60, wait_for_ready=True)
    except rpc_error:
        pass                               # server stopped
    finally:
        ch.close()


def _inproc_client(backend, frame: bytes, stop: threading.Event):
    try:
        while not stop.is_set():
            backend._obs_received(len(frame))
            backend._deliver_frame(frame)
            # yield the interpreter lock once a frame, as a socket
            # client's send does: the server's torch ops each release the
            # lock, and against spinning in-process senders every
            # re-acquire waits out their switch intervals (a legacy arm
            # of 16 updates took minutes)
            time.sleep(0)
    except Exception:
        pass                               # manager finished mid-frame


# ---------------------------------------------------------------------------
# reliable client drivers: window-limited uplink pushers that
# speak the FMLR envelope: each send gets a fresh per-peer seq, acks
# retire the window, losses/corruption resend on the backoff schedule
# ---------------------------------------------------------------------------

def _reliable_send_loop(ep: ReliableEndpoint, frame: bytes,
                        stop: threading.Event, window: int):
    while not stop.is_set():
        if ep.pending() >= window:
            time.sleep(0.0005)             # acks retire the window
            continue
        ep.send(0, frame)


def _reliable_tcp_client(host: str, port: int, frame: bytes,
                         stop: threading.Event, rank: int,
                         backoff: Optional[BackoffPolicy], window: int):
    s = socket.create_connection((host, port), timeout=30)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    slock = threading.Lock()

    def send_raw(peer: int, wire: bytes) -> None:
        with slock:
            s.sendall(struct.pack("<Q", len(wire)))
            s.sendall(wire)

    ep = ReliableEndpoint(rank, send_raw, policy=backoff,
                          name=f"torture-{rank}")

    def reader():                          # acks ride the same socket
        try:
            while not stop.is_set():
                (n,) = struct.unpack("<Q", _read_exact(s, 8))
                ep.on_wire(_read_exact(s, n))
        except (OSError, ConnectionError, struct.error):
            pass                           # server closed

    threading.Thread(target=reader, daemon=True).start()
    try:
        _reliable_send_loop(ep, frame, stop, window)
    except OSError:
        pass
    finally:
        ep.close()
        s.close()


def _reliable_grpc_client(host: str, port: int, frame: bytes,
                          stop: threading.Event, rank: int,
                          backoff: Optional[BackoffPolicy], window: int):
    from fedml_tpu_torch.comm.grpc_backend import open_stub
    ch, stub, rpc_error = open_stub(host, port)

    def send_raw(peer: int, wire: bytes) -> None:
        # the unary response IS the reply channel: the server's ack or
        # nack comes back as the RPC result
        resp = stub(bytes(wire), timeout=60, wait_for_ready=True)
        if resp and bytes(resp[:4]) == reliability.MAGIC:
            ep.on_wire(resp)

    ep = ReliableEndpoint(rank, send_raw, policy=backoff,
                          name=f"torture-{rank}")
    try:
        _reliable_send_loop(ep, frame, stop, window)
    except rpc_error:
        pass                               # server stopped
    finally:
        ep.close()
        ch.close()


def _reliable_inproc_client(backend, frame: bytes, stop: threading.Event,
                            rank: int, backoff: Optional[BackoffPolicy],
                            window: int):
    def send_raw(peer: int, wire: bytes) -> None:
        backend._obs_received(len(wire))
        # reply routes the server's ack straight back into this
        # client's endpoint — the in-memory twin of the TCP reverse
        # channel
        backend._deliver_frame(wire, reply=ep.on_wire)

    ep = ReliableEndpoint(rank, send_raw, policy=backoff,
                          name=f"torture-{rank}")
    try:
        _reliable_send_loop(ep, frame, stop, window)
    except Exception:
        pass                               # manager finished mid-frame
    finally:
        ep.close()


# ---------------------------------------------------------------------------
# the torture run
# ---------------------------------------------------------------------------

def run_ingest_torture(*, n_clients: int = 32, backend: str = "TCP",
                       p: int = DEFAULT_P, buffer_k: int = 8,
                       commits: int = 40, warmup_commits: int = 5,
                       ingest_pool: int = 8, decode_into: bool = True,
                       streaming: bool = True, base_port: int = 53200,
                       timeout_s: float = 300.0,
                       inbox_bound: Optional[int] = None,
                       template: Optional[dict] = None,
                       reliable: bool = False,
                       chaos: Optional[dict] = None, chaos_seed: int = 0,
                       reliable_backoff: Optional[BackoffPolicy] = None,
                       defense=None, window: int = 4,
                       device=None) -> dict:
    """Saturate one server with `n_clients` concurrent uplinks until
    `warmup_commits + commits` commits land; returns the ingestion
    report.  `streaming=False, ingest_pool=0, decode_into=False` is the
    legacy arm (inline decode on recv threads + drained O(K·P)
    commit) — FAITHFULLY, including its unbounded manager inbox: under
    saturation the recv threads decode into the heap faster than the
    one dispatch thread drains, so that arm measures the queue
    pathology too (and its memory grows for the run's duration — keep
    `commits` moderate).  `inbox_bound` bounds the inbox for sink-less
    (pool 0) configurations, blocking the recv threads when full so
    transport flow control backpressures the senders — the A/B's
    queue-discipline isolation arm.

    Chaos and reliability:
    `reliable=True` swaps the spam clients for window-limited FMLR
    uplink pushers (per-seq envelopes, ack-retired windows, backoff
    resend) and envelopes the server; `chaos` (a dict of
    comm.chaos.ChaosConfig rates, e.g. {"drop": 0.05, "dup": 0.01,
    "corrupt": 0.005}) installs a seeded injector on the server's
    receive path.  The report then carries the injected-event rollup
    plus retry/dedup/quarantine/recv-death counters — the
    goodput-vs-fault-rate curve's raw material.  `defense` (a
    DefenseConfig) runs every arrival through the admission pipeline's
    screened fold.  The server runs on `device` (the card unless named)."""
    if warmup_commits < 1:
        raise ValueError(
            f"warmup_commits must be >= 1 (the rate window opens at the "
            f"last warmup commit's wall time), got {warmup_commits}")
    backend = backend.upper()
    template = template if template is not None else make_template(p)
    total = warmup_commits + commits
    kw: dict = {}
    if backend == "INPROC":
        from fedml_tpu_torch.comm.inproc import InProcRouter
        kw["router"] = InProcRouter()
    elif backend in ("TCP", "GRPC"):
        kw["ip_config"] = {0: "127.0.0.1"}
        kw["base_port"] = base_port
        if backend == "TCP":
            # the pure-Python thread transport: the native library would
            # move decode threading off-harness, and the legacy and
            # bounded-inbox arms measure the thread-per-connection
            # pathology by definition (the reactor is priced by
            # run_connection_torture)
            kw["force_python_tcp"] = True
            kw["reactor"] = False

    tracer = obs.tracer()
    # trace watermark: several torture arms may share one process
    # tracer; this run's critical path must only see its own spans
    trace_t0 = tracer._now_us() if tracer is not None else 0.0
    hist = obs.histogram("comm_decode_seconds",
                         buckets=obs.metrics.DECODE_SECONDS_BUCKETS,
                         backend=backend.lower())
    lock_wait = obs.counter("async_lock_wait_seconds")
    recv = obs.counter("comm_received_bytes_total",
                       backend=backend.lower())
    # robustness counters: deltas over the run feed the chaos
    # report — process-wide totals (server endpoint + torture clients)
    rob = {name: obs.counter(f"comm_{name}_total") for name in (
        "reliable_retries", "reliable_acks",
        "reliable_dups_suppressed", "frames_quarantined",
        "reliable_abandoned", "recv_thread_deaths")}
    rob0 = {k: c.value for k, c in rob.items()}

    policy = None
    if chaos:
        policy = ChaosPolicy(ChaosConfig(seed=chaos_seed, **chaos))
    # one arm = one SLO evaluation window of the default serving-spine
    # pack: primed before the server starts, judged after it quiesces,
    # so breaches (quarantines, evictions, starved commits) attribute
    # per arm
    slo_eng = obs_slo.SloEngine(obs_slo.default_slo_pack(),
                                dump_min_interval_s=30.0)
    slo_eng.prime()
    server = AsyncServerManager(
        template, total, buffer_k, 0, n_clients + 1, backend,
        staleness_mode="constant", mix=1.0, streaming=streaming,
        ingest_pool=ingest_pool, decode_into=decode_into,
        redispatch=False, reliable=reliable, defense=defense,
        device=device, **kw)
    if policy is not None:
        server.com_manager.install_chaos(policy)
    if inbox_bound is not None and ingest_pool == 0:
        server.com_manager.bound_inbox(inbox_bound)
    server.run_async()

    stop = threading.Event()
    frames = [_result_frame(template, r, r) for r in
              range(1, n_clients + 1)]
    threads = []
    # full-run metric baselines — the fallback window for runs so fast
    # every commit lands before the post-warmup snapshot below is taken
    hist_start, lock_start, recv_start = (hist.cumulative(),
                                          lock_wait.value, recv.value)
    with obs.span("ingest.torture", backend=backend, clients=n_clients,
                  pool=ingest_pool, decode_into=decode_into,
                  streaming=streaming):
        for r, frame in enumerate(frames, start=1):
            if reliable:
                if backend == "TCP":
                    t = threading.Thread(
                        target=_reliable_tcp_client,
                        args=("127.0.0.1", base_port, frame, stop, r,
                              reliable_backoff, window), daemon=True)
                elif backend == "GRPC":
                    t = threading.Thread(
                        target=_reliable_grpc_client,
                        args=("127.0.0.1", base_port, frame, stop, r,
                              reliable_backoff, window), daemon=True)
                else:
                    t = threading.Thread(
                        target=_reliable_inproc_client,
                        args=(server.com_manager, frame, stop, r,
                              reliable_backoff, window), daemon=True)
            elif backend == "TCP":
                t = threading.Thread(target=_tcp_client,
                                     args=("127.0.0.1", base_port, frame,
                                           stop), daemon=True)
            elif backend == "GRPC":
                t = threading.Thread(target=_grpc_client,
                                     args=("127.0.0.1", base_port, frame,
                                           stop), daemon=True)
            else:
                t = threading.Thread(target=_inproc_client,
                                     args=(server.com_manager, frame,
                                           stop), daemon=True)
            t.start()
            threads.append(t)
        # metric baselines at the LAST WARMUP commit, so the decode
        # percentiles / lock wait / ingested bytes measure the same
        # post-warmup regime as the headline rate (jit+codec cold-start
        # and page-cold memcpys land in the excluded warmup window)
        deadline = time.perf_counter() + timeout_s
        while (len(server.commit_walls) < warmup_commits
               and not server.done.is_set()
               and time.perf_counter() < deadline):
            time.sleep(0.005)
        hist0, lock0, recv0 = (hist.cumulative(), lock_wait.value,
                               recv.value)
        finished = server.done.wait(
            timeout=max(0.0, deadline - time.perf_counter()))
        # a client whose transport errored out mid-run died silently
        # (its spam loop just ends) — count survivors BEFORE stop.set()
        # so a rate measured under reduced load is flagged, not silently
        # reported as n_clients' worth of pressure
        clients_alive = sum(1 for t in threads if t.is_alive())
        stop.set()
    if not finished:
        obs.dump_flight("ingest_torture_stall")
        server.finish()
        raise TimeoutError(
            f"ingest torture stalled: {server.version}/{total} commits in "
            f"{timeout_s}s (backend {backend}, {n_clients} clients, "
            f"pool {ingest_pool})")
    server.finish()                 # waits out in-flight decode tasks
    for t in threads:
        t.join(timeout=10)
    # one quiesced snapshot (post pool drain) feeds both percentiles
    # and the lock-wait delta — no straggler can split the windows
    hist1, lock1, recv1 = hist.cumulative(), lock_wait.value, recv.value
    if clients_alive < n_clients:
        log.warning(
            "%d/%d torture clients died before the run ended (transport "
            "timeout/error) — the reported rate was measured under "
            "reduced uplink pressure", n_clients - clients_alive,
            n_clients)
    metric_window = "post_warmup"
    if hist1[-1][1] - hist0[-1][1] <= 0:
        # the whole run landed inside one poll interval of the warmup
        # boundary: fall back to the full-run window rather than report
        # plausible-looking zeros for the percentiles
        metric_window = "full_run"
        hist0, lock0, recv0 = hist_start, lock_start, recv_start

    walls, sizes = server.commit_walls, server.commit_sizes
    dt = walls[-1] - walls[warmup_commits - 1]
    updates = int(sum(sizes[warmup_commits:]))
    frame_bytes = len(frames[0])
    report = {
        "backend": backend,
        "n_clients": n_clients,
        "p": int(sum(torch.as_tensor(v).numel()
                     for v in template.values())),
        "frame_bytes": frame_bytes,
        "buffer_k": buffer_k,
        "ingest_pool": ingest_pool,
        "decode_into": bool(decode_into),
        "streaming": bool(streaming),
        "inbox_bound": inbox_bound,
        "commits": commits,
        "updates_committed": updates,
        "committed_updates_per_sec": updates / dt if dt > 0 else 0.0,
        "commits_per_sec": commits / dt if dt > 0 else 0.0,
        "decode_p50_s": quantile_from_cumulative(hist0, hist1, 0.50),
        "decode_p95_s": quantile_from_cumulative(hist0, hist1, 0.95),
        "decode_samples": int(hist1[-1][1] - hist0[-1][1]),
        "metric_window": metric_window,
        "lock_wait_seconds": lock1 - lock0,
        "ingested_bytes": recv1 - recv0,
        "clients_alive_at_end": clients_alive,
        "staleness_p95": float(np.percentile(
            np.asarray(server.staleness_seen or [0.0]), 95)),
        # robustness accounting: injected faults and what the
        # reliability layer did about them (full-run deltas — faults
        # during warmup count too; the goodput ratio compares arms
        # under IDENTICAL accounting, so the window mismatch cancels)
        "reliable": bool(reliable),
        # admission accounting (honest torture clients must see zero
        # quarantines: the false-positive gate)
        "defense": defense is not None,
        "admission": (server._admission.report()
                      if server._admission is not None else None),
        "chaos": dict(chaos) if chaos else None,
        "chaos_injected": policy.summary() if policy is not None else None,
        "retries": rob["reliable_retries"].value
                   - rob0["reliable_retries"],
        "acks": rob["reliable_acks"].value - rob0["reliable_acks"],
        "dups_suppressed": rob["reliable_dups_suppressed"].value
                           - rob0["reliable_dups_suppressed"],
        "quarantined": rob["frames_quarantined"].value
                       - rob0["frames_quarantined"],
        "abandoned": rob["reliable_abandoned"].value
                     - rob0["reliable_abandoned"],
        "recv_thread_deaths": rob["recv_thread_deaths"].value
                              - rob0["recv_thread_deaths"],
    }
    # the run-scoped SLO verdict (full report + the compact per-arm
    # summary)
    slo_eng.evaluate()
    report["slo"] = slo_eng.report()
    report["slo_arm"] = slo_eng.arm_summary()
    # the torture server's final variables must be finite — a NaN here
    # means the fold/commit math broke under concurrency
    report["finite"] = bool(all(torch.isfinite(v).all().item()
                                for v in server.variables.values()))
    if tracer is not None:
        # commit-to-commit stage attribution (decode, fold, commit and
        # wait on this no-training harness): the critical path
        from fedml_tpu_torch.obs import timeline
        report["critical_path"] = timeline.critical_path(
            [e for e in tracer.events() if e["ts"] >= trace_t0])
    return report


# ---------------------------------------------------------------------------
# the live-connection torture: the reactor transport under N live
# sockets, storms, and shedding
# ---------------------------------------------------------------------------

def _swarm_subprocess(cfg, frame: bytes):
    """Launch the swarm as `python -m fedml_tpu_torch.comm.connswarm` so
    the client fds of a 10k-connection arm live in their own process (one
    ulimit -n cannot hold both halves of 10k connections).  The child
    imports the port's connswarm only."""
    import json
    import subprocess
    import sys
    import tempfile
    fd, frame_path = tempfile.mkstemp(prefix="connswarm_", suffix=".bin")
    with os.fdopen(fd, "wb") as f:
        f.write(frame)
    cfg.frame_path = frame_path
    cfd, cfg_path = tempfile.mkstemp(prefix="connswarm_", suffix=".json")
    with os.fdopen(cfd, "w") as f:
        f.write(cfg.to_json())
    proc = subprocess.Popen(
        [sys.executable, "-m", "fedml_tpu_torch.comm.connswarm", cfg_path],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def finish(timeout: float = 15.0) -> dict:
        proc.terminate()
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate(timeout=5.0)
        for p in (frame_path, cfg_path):
            try:
                os.unlink(p)
            except OSError:
                pass
        try:
            return json.loads(out.strip().splitlines()[-1])
        except (ValueError, IndexError):
            return {}

    return finish


def run_connection_torture(*, n_connections: int = 256, p: int = 1024,
                           buffer_k: int = 32, commits: int = 30,
                           warmup_commits: int = 3, ingest_pool: int = 4,
                           offered_rate: float = 2000.0,
                           base_port: int = 53600,
                           timeout_s: float = 600.0,
                           storm: bool = False,
                           churn_lifetime_s: float = 0.0,
                           chaos: Optional[dict] = None,
                           chaos_seed: int = 0, seed: int = 0,
                           reactor_config=None,
                           swarm_subprocess: Optional[bool] = None,
                           template: Optional[dict] = None,
                           device=None) -> dict:
    """N LIVE connections against one reactor-transport async server (on
    `device`, the card unless named): a selector swarm keeps every socket
    open with paced FMLR-enveloped uplinks at `offered_rate` aggregate
    frames/sec while the server ingests, dedups, acks, and commits.  `storm=True`
    replays a flash crowd as a connection storm (every SYN at once) and
    `churn_lifetime_s` adds reconnect churn (seeded exponential
    lifetimes); `chaos` installs the seeded fault injector at the
    server's receive chokepoint.  The report carries sustained
    committed-updates/sec, p50/p95 admission latency, peak open
    connections, every eviction/shed counter, recv-thread deaths, and the
    process FD delta (the leak audit).

    `swarm_subprocess=None` auto-selects: in-process below ~4k
    connections, a child process above (both halves of 10k connections
    cannot share one ulimit -n)."""
    from fedml_tpu_torch.comm.connswarm import ConnectionSwarm, SwarmConfig
    from fedml_tpu_torch.comm.reactor import (ReactorConfig, open_fd_count,
                                              reactor_default)

    if not reactor_default():
        # the subject under test IS the reactor; silently falling back
        # to the thread transport would bench the wrong thing (and the
        # report's reactor counters would read from a group that does
        # not exist)
        raise RuntimeError(
            "run_connection_torture benches the reactor transport, but "
            "FEDML_TCP_REACTOR=0 pins the thread transport process-wide "
            "— unset it to run the connection bench")
    if swarm_subprocess is None:
        swarm_subprocess = n_connections > 4096
    template = template if template is not None else make_template(p)
    total = warmup_commits + commits
    if reactor_config is None:
        reactor_config = ReactorConfig(
            reactors=max(2, (os.cpu_count() or 2)),
            max_connections=max(n_connections + 64, 256),
            stall_timeout_s=30.0,
            shed_on_pressure=True, shed_after_s=2.0)

    fd_before = open_fd_count()
    policy = None
    if chaos:
        policy = ChaosPolicy(ChaosConfig(seed=chaos_seed, **chaos))
    # arm-scoped SLO window, same shape as run_ingest_torture
    slo_eng = obs_slo.SloEngine(obs_slo.default_slo_pack(),
                                dump_min_interval_s=30.0)
    slo_eng.prime()
    server = AsyncServerManager(
        template, total, buffer_k, 0, n_connections + 1, "TCP",
        staleness_mode="constant", mix=1.0, streaming=True,
        ingest_pool=ingest_pool, decode_into=True, redispatch=False,
        ip_config={0: "127.0.0.1"}, base_port=base_port,
        force_python_tcp=True, reactor=True,
        reactor_config=reactor_config, device=device)
    if policy is not None:
        server.com_manager.install_chaos(policy)
    server.run_async()

    hist_adm = obs.histogram("comm_admission_seconds")
    hist_lag = obs.histogram("reactor_loop_lag_seconds", backend="tcp")
    evict = {r: obs.counter("comm_connections_evicted_total",
                            backend="tcp", reason=r)
             for r in ("stall", "rate", "shed", "idle", "protocol",
                       "error")}
    shed = obs.counter("comm_uplinks_shed_total", backend="tcp")
    drained = obs.counter("comm_connections_drained_total", backend="tcp")
    deaths = obs.counter("comm_recv_thread_deaths_total")
    dups = obs.counter("comm_reliable_dups_suppressed_total")
    quar = obs.counter("comm_frames_quarantined_total")
    base = {"evict": {r: c.value for r, c in evict.items()},
            "shed": shed.value, "drained": drained.value,
            "deaths": deaths.value, "dups": dups.value,
            "quar": quar.value, "adm": hist_adm.cumulative(),
            "lag": hist_lag.cumulative()}

    # ONE uplink frame shared by the whole swarm (the server's dedup
    # ledger is per-sender seq, so identical payload bytes are fine);
    # constant staleness weights make the version echo weight-neutral
    frame = _result_frame(template, 1, seed)
    scfg = SwarmConfig(
        host="127.0.0.1", port=base_port, n_connections=n_connections,
        offered_rate=offered_rate,
        ramp_s=(0.0 if storm else max(0.5, n_connections / 2000.0)),
        storm=storm, churn_lifetime_s=churn_lifetime_s,
        duration_s=timeout_s + 30.0, seed=seed)
    swarm_stats: dict = {}
    with obs.span("conn.torture", n=n_connections, storm=storm,
                  churn=churn_lifetime_s, chaos=bool(chaos)):
        if swarm_subprocess:
            collect = _swarm_subprocess(scfg, frame)
            swarm = None
        else:
            swarm = ConnectionSwarm(scfg, frame).start()
        deadline = time.perf_counter() + timeout_s
        while (len(server.commit_walls) < warmup_commits
               and not server.done.is_set()
               and time.perf_counter() < deadline):
            time.sleep(0.01)
        adm0 = hist_adm.cumulative()
        lag0 = hist_lag.cumulative()
        finished = server.done.wait(
            timeout=max(0.0, deadline - time.perf_counter()))
        # monotone for the group's lifetime — one read after the wait
        peak = server.com_manager._rg.peak_connections
        if swarm is not None:
            swarm.join()
            swarm_stats = dict(swarm.stats)
        else:
            swarm_stats = collect()
    if not finished:
        obs.dump_flight("connection_torture_stall")
        server.finish()
        raise TimeoutError(
            f"connection torture stalled: {server.version}/{total} "
            f"commits in {timeout_s}s ({n_connections} connections, "
            f"storm={storm})")
    server.finish()
    # teardown quiesce: poll the fd table back to its baseline before
    # the leak audit reads it — straggler closes (shed sockets, the
    # swarm's teardown) land a few hundred ms after finish(), and a
    # fixed sleep mis-read those transients as ±leaks
    deadline = time.perf_counter() + 2.0
    while True:
        fd_after = open_fd_count()
        if fd_after <= fd_before or time.perf_counter() >= deadline:
            break
        time.sleep(0.05)

    adm1, lag1 = hist_adm.cumulative(), hist_lag.cumulative()
    if adm1[-1][1] - adm0[-1][1] <= 0:
        adm0 = base["adm"]          # run outpaced the warmup snapshot
    if lag1[-1][1] - lag0[-1][1] <= 0:
        lag0 = base["lag"]          # same fallback for the lag window
    walls, sizes = server.commit_walls, server.commit_sizes
    dt = walls[-1] - walls[warmup_commits - 1]
    updates = int(sum(sizes[warmup_commits:]))
    report = {
        "n_connections": int(n_connections),
        "p": int(p),
        "buffer_k": int(buffer_k),
        "ingest_pool": int(ingest_pool),
        "offered_rate": float(offered_rate),
        "storm": bool(storm),
        "churn_lifetime_s": float(churn_lifetime_s),
        "chaos": dict(chaos) if chaos else None,
        "chaos_injected": policy.summary() if policy is not None else None,
        "commits": int(commits),
        "updates_committed": updates,
        "committed_updates_per_sec": updates / dt if dt > 0 else 0.0,
        "admission_p50_s": quantile_from_cumulative(adm0, adm1, 0.50),
        "admission_p95_s": quantile_from_cumulative(adm0, adm1, 0.95),
        # post-warmup window, like the admission percentiles — the
        # cold-start/jit iterations must not skew the steady-state gate
        "loop_lag_p95_s": quantile_from_cumulative(lag0, lag1, 0.95),
        "open_connections_peak": int(peak),
        "evicted": {r: evict[r].value - base["evict"][r]
                    for r in evict},
        "uplinks_shed": shed.value - base["shed"],
        "connections_drained": drained.value - base["drained"],
        "recv_thread_deaths": deaths.value - base["deaths"],
        "dups_suppressed": dups.value - base["dups"],
        "quarantined": quar.value - base["quar"],
        "fd_before": fd_before,
        "fd_after": fd_after,
        "fd_leaked": (fd_after - fd_before
                      if fd_before >= 0 and fd_after >= 0 else None),
        "swarm": swarm_stats,
        "seed": int(seed),
    }
    slo_eng.evaluate()
    report["slo"] = slo_eng.report()
    report["slo_arm"] = slo_eng.arm_summary()
    report["finite"] = bool(all(torch.isfinite(v).all().item()
                                for v in server.variables.values()))
    return report
