"""The fused serving cluster (port of fedml_tpu/scale/cluster.py): live
sockets feeding registry-sharded lanes across the elastic multi-process
tier.

    reactor      one ReactorGroup per host fronts that host's registry
                 range; an uplink rides the async server's one insert
                 path (`_ingest_row`: chaos filter, reliability envelope,
                 decode pool), not a fork of it
    lanes        decoded rows land in per-range ClusterLanes: a streaming
                 AsyncBuffer fold on the device per lane (one fold-kernel
                 launch a row), and a per-lane FIFO backlog for rows that
                 arrive past a full window (socket arrival order never
                 crosses a window boundary)
    fold         at each commit barrier the host takes every hosted
                 lane's partial in item order and folds across hosts
                 through an ElasticChannel as run_serve_sim does, with the
                 same pack_partial/fold_partials, so the fold order is a
                 function of the lane partition alone
    shed gate    lane pressure feeds the reactor's set_overload_gate: a
                 host whose lanes are saturated (window full and backlog
                 at its cap) refuses new connections at the door instead
                 of accepting uplinks it would drop

Two invariants: at world 1 the socket-fed lane given the synthetic serve
simulation's row sequence commits its digest (the fusion adds transport,
not math); and with live ingest every rank commits the same digest,
because every rank folds the same exchanged bytes in item order.
"""
from __future__ import annotations

import os
import socket
import struct
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from fedml_tpu_torch import obs
from fedml_tpu_torch.async_.lifecycle import AsyncMessage, AsyncServerManager
from fedml_tpu_torch.comm.message import Message, MessageCodec
from fedml_tpu_torch.obs import propagate
from fedml_tpu_torch.obs import slo as obs_slo
from fedml_tpu_torch.obs.metrics import quantile_from_cumulative
from fedml_tpu_torch.scale.registry import ClientRegistry
from fedml_tpu_torch.scale.serve import (fold_partials, pack_partial,
                                         rss_bytes, variables_digest,
                                         zero_partial)
from fedml_tpu_torch.utils.device import resolve_device

_LEN = struct.Struct("<Q")


class ClusterLane:
    """One registry range's live-socket serving state: the registry over
    [lo, hi), a streaming AsyncBuffer sized to the commit window on the
    device, and a bounded FIFO backlog for uplinks that arrive while the
    window is full.  `item` is the range's index in the world-sized
    partition: the cross-host fold is in item order, so the global mix
    does not depend on which host or socket delivered which row when."""

    def __init__(self, item: int, lo: int, hi: int, *, buffer_k: int,
                 row_dim: int, backlog_cap: int, device,
                 start_version: int = 0):
        from fedml_tpu_torch.async_.staleness import AsyncBuffer
        self.item = int(item)
        self.lo, self.hi = int(lo), int(hi)
        self.local_population = max(1, self.hi - self.lo)
        self.buffer_k = int(buffer_k)
        self.registry = ClientRegistry(self.local_population)
        self.buffer = AsyncBuffer(buffer_k, row_dim, streaming=True,
                                  device=device)
        self.backlog: deque = deque()
        self.backlog_cap = int(backlog_cap)
        self.version = int(start_version)
        self.admitted = 0
        self.overflow_dropped = 0
        # set the first time any uplink routes here (admitted, parked or
        # dropped): an untouched lane, typically a re-adopted range with
        # no sockets pointed at it, must not hold the window barrier to
        # its deadline every commit
        self.touched = False

    def full(self) -> bool:
        return self.buffer.count >= self.buffer_k

    def saturated(self) -> bool:
        """Window full and backlog at its cap: this lane cannot take
        another uplink without dropping one (the shed gate's signal)."""
        return (self.buffer.count >= self.buffer_k
                and len(self.backlog) >= self.backlog_cap)


class ClusterServeManager(AsyncServerManager):
    """One host of the fused serving cluster: the async server's reactor
    transport and decode pool, with its one insert path (`_ingest_row`)
    routed into per-range ClusterLanes instead of the single buffer.
    Commits are not triggered here: the cross-host loop
    (run_cluster_serve) closes windows at the commit barrier, so a socket
    burst never races a partial into the wrong window; rows past a full
    window park in the lane's backlog and drain, in arrival order, into
    the next window."""

    def __init__(self, row_dim: int, *, population: int,
                 cluster_rank: int = 0, world: int = 1,
                 buffer_k: int = 16, port: int = 54300,
                 n_connections: int = 256, ingest_pool: int = 2,
                 backlog_cap: Optional[int] = None,
                 sparse_uplink: bool = False,
                 reactor_config=None, device=None):
        from fedml_tpu_torch.comm.reactor import ReactorConfig
        if reactor_config is None:
            reactor_config = ReactorConfig(
                reactors=max(2, (os.cpu_count() or 2)),
                max_connections=max(n_connections + 64, 256),
                stall_timeout_s=30.0,
                shed_on_pressure=True, shed_after_s=2.0)
        self.row_dim = int(row_dim)
        self.population = int(population)
        self.cluster_rank = int(cluster_rank)
        self.world = int(world)
        self._backlog_cap = (int(backlog_cap) if backlog_cap is not None
                             else 4 * int(buffer_k))
        self._lanes: dict[int, ClusterLane] = {}
        self._retired_lanes: list[ClusterLane] = []
        self._hosted: tuple = ()
        self._rr = 0
        self.misrouted = 0
        template = {"w": torch.zeros(row_dim, dtype=torch.float32)}
        super().__init__(
            template, 1 << 62, buffer_k, 0, n_connections + 1, "TCP",
            staleness_mode="constant", mix=1.0, streaming=True,
            ingest_pool=ingest_pool, decode_into=True,
            sparse_uplink=sparse_uplink, redispatch=False,
            ip_config={0: "127.0.0.1"}, base_port=port,
            force_python_tcp=True, reactor=True,
            reactor_config=reactor_config, device=device)
        # the window barrier: _ingest_row notifies when a lane fills; the
        # loop waits on the manager lock the insert path times
        self._window_cv = threading.Condition(self._lock)
        self._adopt_locked(self.cluster_rank, 0)
        # lane pressure reaches the reactor's door, so a lane-bound host
        # sheds new connections instead of accepting uplinks it would drop
        # at the backlog cap
        rg = getattr(self.com_manager, "_rg", None)
        if rg is not None:
            rg.set_overload_gate(self.lane_pressure)

    # -- lane partition ------------------------------------------------------
    def _range_of(self, item: int) -> tuple:
        return (item * self.population // self.world,
                (item + 1) * self.population // self.world)

    def _adopt_locked(self, item: int, start_version: int) -> ClusterLane:
        lo, hi = self._range_of(item)
        lane = ClusterLane(item, lo, hi, buffer_k=self.buffer_k,
                           row_dim=self.row_dim,
                           backlog_cap=self._backlog_cap,
                           device=self.device, start_version=start_version)
        self._lanes[item] = lane
        self._hosted = tuple(sorted(self._lanes))
        return lane

    def adopt(self, item: int, start_version: int) -> None:
        with self._lock:
            if item not in self._lanes:
                self._adopt_locked(item, start_version)
                obs.instant("cluster.readopt", item=item,
                            rank=self.cluster_rank, version=start_version)

    def retire(self, item: int) -> None:
        with self._lock:
            lane = self._lanes.pop(item, None)
            if lane is not None:
                self._retired_lanes.append(lane)
                self._hosted = tuple(sorted(self._lanes))

    def hosted_items(self) -> tuple:
        return self._hosted

    def all_lanes(self) -> list:
        return list(self._lanes.values()) + self._retired_lanes

    # -- shed gate -----------------------------------------------------------
    def lane_pressure(self) -> bool:
        """True while any hosted lane is saturated: the reactor's overload
        gate, so the door sheds instead of the backlog dropping.  It runs
        on the reactor's loop thread and reads the hosted snapshot tuple,
        never iterating the mutable dict."""
        lanes = self._lanes
        for item in self._hosted:
            lane = lanes.get(item)
            if lane is not None and lane.saturated():
                return True
        return False

    # -- the insert path (decode pool and FSM route both land here) ----------
    def _ingest_row(self, sender: int, row, weight: float,
                    dispatched: int, *, sparse=None) -> None:
        t0 = time.perf_counter()
        self._lock.acquire()
        self._m_lock_wait.inc(time.perf_counter() - t0)
        try:
            if self.done.is_set():
                return                  # late straggler after shutdown
            hosted = self._hosted
            if not hosted:
                self.misrouted += 1
                return                  # the view moved every range away
            # a sender inside a hosted range lands in its range's lane
            # (registry attribution); anything else (a fleet's fixed
            # sender id, a client whose range another host owns) goes
            # round-robin over the hosted lanes
            item = ((sender % self.population) * self.world
                    // self.population)
            lane = self._lanes.get(item)
            if lane is None:
                lane = self._lanes[hosted[self._rr % len(hosted)]]
                self._rr += 1
            lane.touched = True
            staleness = float(lane.version - dispatched)
            # the lane folds the row's first row_dim elements (the
            # manager's scratch rows carry the layout's zero pad)
            dense = None if sparse is not None else \
                torch.as_tensor(row)[:self.row_dim]
            if lane.full() or lane.backlog:
                # window closed, or rows already queued behind it: park
                # in arrival order for the next window
                if len(lane.backlog) >= lane.backlog_cap:
                    lane.overflow_dropped += 1
                    return
                # the row is a scratch buffer the decode pool recycles
                # once this returns: parking needs a copy (the direct
                # fold below reads it before returning); sparse pairs
                # are fresh arrays
                lane.backlog.append((sparse if sparse is not None
                                     else dense.clone(), float(weight),
                                     staleness, int(sender)))
            else:
                self._admit_locked(lane, sparse if sparse is not None
                                   else dense, weight, staleness, sender)
            if lane.full():
                self._window_cv.notify_all()
        finally:
            self._lock.release()

    def _admit_locked(self, lane: ClusterLane, row, weight: float,
                      staleness: float, sender: int) -> None:
        with obs.span("ingest.fold", sender=sender):
            if isinstance(row, tuple):
                # (index, value) pairs of a sparse_topk frame: the sparse
                # fold, never a dense row
                lane.buffer.add_sparse(row[0], row[1], weight, staleness)
            else:
                lane.buffer.add(row, weight, staleness)
        lane.admitted += 1
        self.staleness_seen.append(staleness)
        self._m_staleness.observe(staleness)
        self._m_occupancy.set(lane.buffer.count)
        lane.registry.note_push(sender % lane.local_population,
                                staleness, lane.version)

    # -- window barrier ------------------------------------------------------
    def wait_window(self, deadline_s: float) -> bool:
        """Block until every hosted lane that has seen traffic has a full
        window, or the deadline passes (a lane without traffic must not
        wedge the barrier: it contributes what it has, possibly nothing,
        the same on every rank).  False on a deadline close."""
        deadline = time.perf_counter() + float(deadline_s)
        with self._window_cv:
            while True:
                active = [self._lanes[i] for i in self._hosted
                          if self._lanes[i].touched]
                if active and all(ln.full() for ln in active):
                    return True
                left = deadline - time.perf_counter()
                if left <= 0.0:
                    return False
                self._window_cv.wait(min(left, 0.05))

    def take_partials(self) -> dict:
        """Close the window: per hosted lane in item order, take the
        streaming partial and drain the backlog into the fresh window in
        FIFO order.  Returns {item: (acc, wsum, n)}."""
        out = {}
        with self._lock:
            for item in self._hosted:
                lane = self._lanes[item]
                acc, wsum, _w, _s, n, _raw = lane.buffer.take_stream()
                out[item] = (acc, wsum, int(n))
                lane.version += 1
                while lane.backlog and not lane.full():
                    row, w, s, sender = lane.backlog.popleft()
                    self._admit_locked(lane, row, w, s, sender)
                if lane.full():
                    self._window_cv.notify_all()
        return out


# ---------------------------------------------------------------------------
# uplink frame helpers: the swarm's payload and the tests' senders
# ---------------------------------------------------------------------------

def make_uplink_frame(row, *, sender: int = 1, weight: float = 1.0,
                      version: int = 0,
                      transport: Optional[str] = None) -> bytes:
    """One encoded C2S result frame carrying a flat f32 row under the
    cluster template {"w": row} (the JAX package's frame byte for byte).
    The weight rides NUM_SAMPLES; the cluster runs constant staleness, so
    the version echo weighs nothing.  `transport` puts the row on a lossy
    v2 wire dtype ("bf16" | "int8" | "sparse_topk"); None keeps the exact
    v1 frame."""
    msg = Message(AsyncMessage.MSG_TYPE_C2S_ASYNC_RESULT, sender, 0)
    msg.add_params(AsyncMessage.MSG_ARG_KEY_MODEL_PARAMS,
                   {"w": np.asarray(row, np.float32)})
    msg.add_params(AsyncMessage.MSG_ARG_KEY_NUM_SAMPLES, float(weight))
    msg.add_params(AsyncMessage.MSG_ARG_KEY_VERSION, int(version))
    if transport is not None:
        msg.set_wire_transport(AsyncMessage.MSG_ARG_KEY_MODEL_PARAMS,
                               transport)
    propagate.stamp(msg, sender)
    return MessageCodec.encode(msg)


def send_uplinks(host: str, port: int, frames, *,
                 hold_open: Optional[threading.Event] = None,
                 timeout_s: float = 30.0) -> None:
    """One blocking socket, the frames length-prefixed in order (the
    transport keeps it; with ingest_pool=1 the decode pool does too).
    The connection stays open until `hold_open` is set, so the server
    never sees a hangup mid-run."""
    s = socket.create_connection((host, port), timeout=timeout_s)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    try:
        for f in frames:
            s.sendall(_LEN.pack(len(f)) + f)
        if hold_open is not None:
            hold_open.wait(timeout=timeout_s)
    finally:
        try:
            s.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# the per-host loop: commit barrier and cross-host fold
# ---------------------------------------------------------------------------

def run_cluster_serve(population: int, *, commits: int,
                      warmup_commits: int = 2, buffer_k: int = 16,
                      row_dim: int = 256, port: int = 54300,
                      partition: tuple = (0, 1), channel=None,
                      elastic: bool = False, n_connections: int = 64,
                      ingest_pool: int = 2,
                      window_deadline_s: float = 20.0,
                      timeout_s: float = 600.0,
                      backlog_cap: Optional[int] = None,
                      sparse_uplink: bool = False,
                      reactor_config=None, chaos: Optional[dict] = None,
                      chaos_seed: int = 0,
                      crash_at_commit: Optional[int] = None,
                      slo_window: bool = False, device=None) -> dict:
    """Serve `commits` commit windows of live-socket uplinks on this
    host's registry range, on `device` (the card unless named), folding
    the lane partials across hosts at each commit barrier as
    run_serve_sim does (the same pack, fold and zero functions, the same
    ElasticChannel contract, the same re-adoption).  Returns the host
    report: the committed digest, local and cluster-wide committed
    updates/sec, admission percentiles, and every shed, eviction and drop
    counter.

    `crash_at_commit` is the fault hook: this host closes its channel
    after that many commits and returns a partial report; the survivors'
    next exchange evicts it, and its range's new owner has no sockets
    pointed at it, so that lane's windows close at the deadline with what
    arrived (zeros on every survivor)."""
    from fedml_tpu_torch.async_.staleness import make_stream_commit_fn
    from fedml_tpu_torch.comm.chaos import ChaosConfig, ChaosPolicy

    if commits <= warmup_commits:
        raise ValueError(f"commits ({commits}) must exceed "
                         f"warmup_commits ({warmup_commits})")
    rank, world = int(partition[0]), int(partition[1])
    if not 0 <= rank < world:
        raise ValueError(f"partition rank {rank} outside world {world}")
    if world > 1 and channel is None:
        raise ValueError("world > 1 needs a channel to fold the partial "
                         "aggregates upward")
    if elastic and world > 1 and not hasattr(channel, "exchange"):
        raise ValueError("elastic=True needs an ElasticChannel "
                         "(n_items=world)")
    device = resolve_device(device)
    mgr = ClusterServeManager(
        row_dim, population=population, cluster_rank=rank, world=world,
        buffer_k=buffer_k, port=port, n_connections=n_connections,
        ingest_pool=ingest_pool, backlog_cap=backlog_cap,
        sparse_uplink=sparse_uplink, reactor_config=reactor_config,
        device=device)
    if chaos:
        mgr.com_manager.install_chaos(
            ChaosPolicy(ChaosConfig(seed=chaos_seed, **chaos)))
    mgr.run_async()

    slo_eng = None
    if slo_window:
        slo_eng = obs_slo.SloEngine(obs_slo.default_slo_pack(),
                                    dump_min_interval_s=30.0)
        slo_eng.prime()
    hist_adm = obs.histogram("comm_admission_seconds")
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
            "quar": quar.value, "adm": hist_adm.cumulative()}

    zero_payload = zero_partial(row_dim)
    variables = {"w": torch.zeros(row_dim, dtype=torch.float32,
                                  device=device)}
    commit_fn = make_stream_commit_fn(variables)
    alpha = torch.ones((), dtype=torch.float32)
    version = 0
    deadline_windows = 0
    empty_commits = 0
    global_wsum = 0.0
    commit_walls: list = []     # per-commit wall time (barrier to barrier)
    commit_wsums: list = []     # per-commit folded global weight
    adopted_items: list[int] = []
    crashed_out = False
    t_wall0 = time.perf_counter()
    t_commit_prev = t_wall0
    hard_deadline = t_wall0 + float(timeout_s)
    t_timed = None
    admitted_at_warmup = 0
    global_at_warmup = 0.0
    adm0 = base["adm"]

    def lanes_admitted() -> int:
        return sum(ln.admitted for ln in mgr.all_lanes())

    try:
        with obs.span("cluster.run", population=population,
                      commits=commits, rank=rank, world=world,
                      elastic=elastic):
            while version < commits:
                if time.perf_counter() > hard_deadline:
                    obs.dump_flight("cluster_serve_stall")
                    raise TimeoutError(
                        f"cluster serve stalled: {version}/{commits} "
                        f"commits in {timeout_s}s (rank {rank}/{world}, "
                        f"{lanes_admitted()} admitted)")
                if crash_at_commit is not None and version == crash_at_commit:
                    # fault injection: this host vanishes mid-run
                    if channel is not None:
                        channel.close()
                    crashed_out = True
                    break
                if not mgr.wait_window(window_deadline_s):
                    deadline_windows += 1
                partials = mgr.take_partials()
                with obs.span("cluster.commit", version=version, rank=rank):
                    n_committed = sum(p[2] for p in partials.values())
                    if world > 1 and elastic:
                        payloads = {item: pack_partial(acc, wsum)
                                    for item, (acc, wsum, _n)
                                    in partials.items()}
                        allp, view = channel.exchange(
                            version, payloads,
                            lambda items: {i: zero_payload for i in items})
                        acc, wsum = fold_partials(
                            (allp[item] for item in range(world)), row_dim,
                            device)
                    elif world > 1:
                        acc, wsum, _n = partials[rank]
                        acc, wsum = fold_partials(
                            channel.allgather(pack_partial(acc, wsum)),
                            row_dim, device)
                    else:
                        # world 1 folds its one partial directly, as the
                        # serve simulation does
                        acc, wsum, _n = partials[rank]
                    # an all-empty window (every lane closed at its
                    # deadline with no arrivals, cluster-wide) must not
                    # fold acc/0 into the model; the folded wsum is the
                    # same on every rank, so is the skip
                    w = float(wsum)
                    if w > 0.0:
                        variables, _stats = commit_fn(variables, acc, wsum,
                                                      alpha)
                    else:
                        empty_commits += 1
                global_wsum += w
                t_now = time.perf_counter()
                commit_walls.append(t_now - t_commit_prev)
                t_commit_prev = t_now
                commit_wsums.append(w)
                obs.counter("async_updates_committed_total").inc(
                    n_committed)
                version += 1
                if world > 1 and elastic:
                    # the commit barrier puts the lanes on the view: one
                    # host a range, as in run_serve_sim
                    for item in list(mgr.hosted_items()):
                        if view.owner_of(item) != rank:
                            mgr.retire(item)
                    for item in view.assigned(rank):
                        if item not in mgr.hosted_items():
                            mgr.adopt(item, version)
                            adopted_items.append(item)
                if version == warmup_commits:
                    t_timed = time.perf_counter()
                    admitted_at_warmup = lanes_admitted()
                    global_at_warmup = global_wsum
                    adm0 = hist_adm.cumulative()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        mgr.finish()

    wall = time.perf_counter() - (t_timed if t_timed is not None
                                  else t_wall0)
    timed_updates = lanes_admitted() - (admitted_at_warmup
                                        if t_timed is not None else 0)
    timed_global = global_wsum - (global_at_warmup
                                  if t_timed is not None else 0.0)
    adm1 = hist_adm.cumulative()
    if adm1[-1][1] - adm0[-1][1] <= 0:
        adm0 = base["adm"]          # the run outpaced the warm-up snapshot
    rg = getattr(mgr.com_manager, "_rg", None)
    report = {
        "population": int(population),
        "partition": [rank, world],
        "port": int(port),
        "committed_digest": variables_digest(variables),
        "commits": int(version),
        "committed_updates": int(lanes_admitted()),
        "committed_updates_per_sec": (timed_updates / wall
                                      if wall > 0 else 0.0),
        "cluster_updates_per_sec": (timed_global / wall
                                    if wall > 0 else 0.0),
        "commit_walls_s": [round(w, 6) for w in commit_walls],
        "commit_wsums": [round(w, 2) for w in commit_wsums],
        "admission_p50_s": quantile_from_cumulative(adm0, adm1, 0.50),
        "admission_p95_s": quantile_from_cumulative(adm0, adm1, 0.95),
        "buffer_k": int(buffer_k),
        "row_dim": int(row_dim),
        "ingest_pool": int(ingest_pool),
        "n_connections": int(n_connections),
        "window_deadline_s": float(window_deadline_s),
        "deadline_windows": int(deadline_windows),
        "empty_commits": int(empty_commits),
        "lane_overflow_dropped": int(sum(ln.overflow_dropped
                                         for ln in mgr.all_lanes())),
        "misrouted": int(mgr.misrouted),
        "open_connections_peak": (int(rg.peak_connections)
                                  if rg is not None else 0),
        "shed_reasons": dict(rg.shed_reasons) if rg is not None else {},
        "evicted": {r: c.value - base["evict"][r]
                    for r, c in evict.items()},
        "uplinks_shed": shed.value - base["shed"],
        "connections_drained": drained.value - base["drained"],
        "recv_thread_deaths": deaths.value - base["deaths"],
        "dups_suppressed": dups.value - base["dups"],
        "quarantined": quar.value - base["quar"],
        "registry_bytes": int(sum(ln.registry.nbytes
                                  for ln in mgr.all_lanes())),
        "rss_bytes": rss_bytes(),
        "wall_s": float(wall),
        "chaos_injected": bool(chaos),
        "sparse_uplink": bool(sparse_uplink),
        "device": str(device),
    }
    if elastic:
        report["elastic"] = {
            "lanes": sorted(mgr.hosted_items()),
            "adopted_items": adopted_items,
            "retired_items": [ln.item for ln in mgr._retired_lanes],
            "crashed_at_commit": (crash_at_commit if crashed_out
                                  else None),
            "epoch": getattr(getattr(channel, "view", None), "epoch", 0),
            "view_changes": len(getattr(channel, "view_events", ())),
        }
    if slo_eng is not None:
        slo_eng.evaluate()
        report["slo_arm"] = slo_eng.arm_summary()
    return report
