"""The two-level multi-process runtime (port of the launcher, host
channel, block math and MultihostRunner of fedml_tpu/parallel/multihost.py).

The reference scales across machines with `mpirun -np N -hostfile ...`
(run_fedavg_distributed_pytorch.sh:16-35): one OS process per rank.  This
module is that deployment for the port:

* `MultihostContext` / `spawn_cluster` / ``python -m
  fedml_tpu_torch.parallel.launch``: a multi-process launcher.  N OS
  processes are wired by env (`FEDML_MH_RANK/WORLD/COORD`); the first
  rank that fails is blamed, the rest are killed, and every rank's
  outcome is summarised.
* `HostChannel`: the inter-process tier, a small TCP star (rank 0
  coordinates) carrying the flat f32 carry between processes.  It needs
  no backend collective, so two ranks can share one card (two NCCL ranks
  of one `torch.distributed` group cannot).  Every wait is bounded: a
  dead or hung rank raises `DeadRankError` naming it.  Its frames are
  the JAX channel's byte for byte, so a JAX rank and a port rank
  complete one allgather together.
* `MultihostRunner`: the two-level round.  For each block it owns, a
  rank trains the block's cohort through the engine's chunk loop and its
  fold kernels into one flat f32 carry (the engine's
  `_twolevel_partial`), copies it to the host, the ranks allgather the
  (optionally compressed, parallel/carry_codec.py) carries, every rank
  folds all block partials in global block order on the host in numpy,
  and every rank applies the same commit (`_twolevel_commit`).

Bitwise anchor: the reduction tree is a function of the block
partition, not of the process count.  The cohort is sampled per block
from fixed population ranges (`BlockCohortSampler`, numpy streams keyed
[seed, round, block]); lane j of block b trains with
``client_generator(seed, round, b * k_per_block + j)``, never a
rank-local index; and every rank folds all partials in global block
order.  Any process count that tiles the same blocks therefore commits
the same bits.

The elastic tier (`ElasticChannel`, `ClusterView`, `ElasticRunner`, the
launcher's ``elastic``/``respawn``) is slice 6b of the port; the
in-program mesh tier (`init_multihost`, `make_global_mesh`, the
hierarchical host mesh, ``jax_distributed``) is slice 6c.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import select
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from fedml_tpu_torch import obs
from fedml_tpu_torch.obs import cluster as _cluster

log = logging.getLogger(__name__)

ENV_RANK = "FEDML_MH_RANK"
ENV_WORLD = "FEDML_MH_WORLD"
ENV_COORD = "FEDML_MH_COORD"           # host:port of the HostChannel

ELASTIC_LATER = ("the elastic tier (elastic=/respawn=, ElasticChannel, "
                 "ElasticRunner) is slice 6b of the port, not ported yet")


# ---------------------------------------------------------------------------
# process context + cluster spawning
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MultihostContext:
    """One process's place in the launched cluster (env-carried, so any
    entry point resolves it the same way)."""
    rank: int
    world: int
    coordinator: str                    # "host:port" of the HostChannel

    @classmethod
    def from_env(cls) -> Optional["MultihostContext"]:
        if ENV_RANK not in os.environ or ENV_WORLD not in os.environ:
            return None
        world = int(os.environ[ENV_WORLD])
        rank = int(os.environ[ENV_RANK])
        if not 0 <= rank < world:
            raise ValueError(f"{ENV_RANK}={rank} outside world "
                             f"{world}")
        return cls(rank=rank, world=world,
                   coordinator=os.environ.get(ENV_COORD, "localhost:0"))

    @classmethod
    def single(cls) -> "MultihostContext":
        return cls(rank=0, world=1, coordinator="localhost:0")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class MultihostLaunchError(RuntimeError):
    """A launched rank failed or hung; the message names it."""


def _rank_outcome(rc: Optional[int], policy_killed: bool = False) -> str:
    """One rank's exit, human-named: clean and nonzero exit codes, and
    the signal's name for a signal death (SIGKILL, the chaos or OOM
    shape, reads differently from SIGSEGV, a real crash, and from a
    plain nonzero exit, a named Python error)."""
    if rc is None:
        return "still running"
    if rc == 0:
        return "ok"
    if rc < 0:
        try:
            name = signal.Signals(-rc).name
        except ValueError:
            name = f"signal {-rc}"
        suffix = (" by launcher cleanup after the first failure"
                  if policy_killed else "")
        return f"killed by {name}{suffix}"
    return f"exit rc={rc}"


def spawn_cluster(cmd: list[str], procs: int, *,
                  env: Optional[dict] = None,
                  timeout_s: float = 600.0,
                  echo: bool = False,
                  coordinator_host: str = "localhost",
                  coordinator_port: Optional[int] = None,
                  elastic: bool = False,
                  respawn: bool = False,
                  kill_grace_s: float = 5.0) -> list[str]:
    """Fork `procs` copies of `cmd` wired as one cluster (env
    FEDML_MH_RANK/WORLD/COORD); returns each rank's stdout, rank-ordered.

    Failure policy (fail-fast): the first rank to exit nonzero kills the
    rest and raises MultihostLaunchError naming that rank (with its
    stderr tail) and every rank's outcome: exit code, or the signal's
    name for a signal death, so an injected kill reads differently from
    the channel-EOF deaths it causes.  A deadline overrun kills
    everything and names the ranks still running.  `echo` streams each
    child's stderr line-prefixed (`[rank i]`).  The coordinator binds
    `coordinator_port`, or a free port when None."""
    outs, _report = spawn_cluster_report(
        cmd, procs, env=env, timeout_s=timeout_s, echo=echo,
        coordinator_host=coordinator_host,
        coordinator_port=coordinator_port, elastic=elastic,
        respawn=respawn, kill_grace_s=kill_grace_s)
    return outs


def spawn_cluster_report(cmd: list[str], procs: int, *,
                         env: Optional[dict] = None,
                         timeout_s: float = 600.0,
                         echo: bool = False,
                         coordinator_host: str = "localhost",
                         coordinator_port: Optional[int] = None,
                         elastic: bool = False,
                         respawn: bool = False,
                         kill_grace_s: float = 5.0
                         ) -> tuple[list[str], dict]:
    """spawn_cluster plus a per-rank outcome report: ({rank stdouts},
    {"ranks": {r: {"rc", "outcome"}}, "first_failed": r | None})."""
    if procs < 1:
        raise ValueError(f"procs must be >= 1, got {procs}")
    if not cmd:
        raise ValueError("empty worker command")
    if respawn and not elastic:
        raise ValueError("respawn=True needs elastic=True (a fail-fast "
                         "cluster kills the survivors the rejoiner "
                         "would rejoin)")
    if elastic:
        raise NotImplementedError(ELASTIC_LATER)
    port = free_port() if coordinator_port is None else coordinator_port
    coord = f"{coordinator_host}:{port}"
    base_env = {**os.environ, **(env or {}),
                ENV_WORLD: str(procs), ENV_COORD: coord}
    base_env.pop("FEDML_MH_REJOIN", None)
    ps: list[subprocess.Popen] = []
    bufs: dict[int, tuple[list, list]] = {}
    drains: list[threading.Thread] = []
    policy_killed: set[int] = set()

    def _drain(rank: int, p: subprocess.Popen):
        buf_out: list = []
        buf_err: list = []
        bufs[rank] = (buf_out, buf_err)

        def _pump(stream, buf, is_err):
            for line in stream:
                buf.append(line)
                if echo and is_err:
                    # stderr streams live (progress, tracebacks); stdout
                    # is returned buffered so machine-readable lines
                    # stay contiguous per rank
                    print(f"[rank {rank}] {line}", end="",
                          file=sys.stderr, flush=True)
        t_err = threading.Thread(target=_pump,
                                 args=(p.stderr, buf_err, True))
        t_err.start()
        _pump(p.stdout, buf_out, False)
        t_err.join()

    try:
        for r in range(procs):
            e = dict(base_env)
            e[ENV_RANK] = str(r)
            p = subprocess.Popen(cmd, env=e, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
            ps.append(p)
            t = threading.Thread(target=_drain, args=(r, p))
            t.start()
            drains.append(t)
    except BaseException:
        for p in ps:
            p.kill()
            p.wait()
        for t in drains:
            t.join()
        raise

    def _summary() -> str:
        return "; ".join(f"rank {r}: "
                         f"{_rank_outcome(ps[r].poll(), r in policy_killed)}"
                         for r in range(procs))

    def _kill(ranks) -> None:
        for r in ranks:
            policy_killed.add(r)
            ps[r].kill()
        for r in ranks:      # reap: the summary must show the kill
            try:             # outcome, not "still running"
                ps[r].wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass

    deadline = time.monotonic() + timeout_s
    first_failed: Optional[int] = None
    try:
        while True:
            for r in range(procs):
                if (first_failed is None and ps[r].poll() is not None
                        and ps[r].returncode != 0):
                    first_failed = r
            live = [r for r in range(procs) if ps[r].poll() is None]
            if first_failed is not None or not live:
                break
            if time.monotonic() > deadline:
                _kill(live)
                raise MultihostLaunchError(
                    f"multihost launch timed out after {timeout_s:.0f}s: "
                    f"rank(s) {live} still running (of {procs})\n"
                    f"per-rank: {_summary()}")
            time.sleep(0.05)
        if first_failed is not None:
            # give survivors a short grace (a dead peer's channel EOF
            # usually fails them promptly with their OWN named error),
            # then kill what still runs
            grace = time.monotonic() + kill_grace_s
            while (time.monotonic() < grace
                   and any(p.poll() is None for p in ps)):
                time.sleep(0.05)
            _kill([r for r in range(procs) if ps[r].poll() is None])
    except BaseException:
        _kill([r for r in range(procs) if ps[r].poll() is None])
        raise
    finally:
        for t in drains:
            t.join()
    report = {
        "first_failed": first_failed,
        "ranks": {r: {"rc": ps[r].returncode,
                      "outcome": _rank_outcome(ps[r].returncode,
                                               r in policy_killed)}
                  for r in range(procs)},
    }
    bad = [r for r in range(procs) if ps[r].returncode != 0]
    if bad:
        # blame the FIRST rank observed failing (the injected or original
        # fault), not a survivor that died of the resulting channel EOF
        i = first_failed if first_failed in bad else bad[0]
        raise MultihostLaunchError(
            f"multihost rank {i}/{procs} failed first "
            f"(rc={ps[i].returncode}; {len(bad)}/{procs} ranks "
            f"failed):\nper-rank: {_summary()}\n"
            f"{''.join(bufs.get(i, ([], []))[1])[-3000:]}")
    outs = ["".join(bufs.get(r, ([], []))[0]) for r in range(procs)]
    return outs, report


# ---------------------------------------------------------------------------
# HostChannel: the inter-process tier
# ---------------------------------------------------------------------------

class DeadRankError(RuntimeError):
    """A peer rank died or stalled past the bounded channel timeout; the
    message names it."""


# A frame is u64 length + payload.  The coordinator's broadcast is one
# frame whose payload is u32 world, then each rank's payload as u64 length
# + bytes, rank-ordered: the JAX channel's wire format.  The port writes
# and reads its pieces in place (a carry is tens of MB: a joined copy of
# the blob, and a copy per received chunk, cost more than the loopback
# transfer), so received payloads are bytearrays.

def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack("<Q", len(payload)))
    sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:])
        if not k:
            raise ConnectionError("peer closed")
        got += k
    return buf


def _recv_frame(sock: socket.socket) -> bytearray:
    (n,) = struct.unpack("<Q", _recv_exact(sock, 8))
    return _recv_exact(sock, n)


def _send_parts(sock: socket.socket, parts: list) -> int:
    """The broadcast frame, written piece by piece; returns its bytes on
    the wire."""
    n = 4 + sum(8 + len(p) for p in parts)
    sock.sendall(struct.pack("<QI", n, len(parts)))
    for p in parts:
        sock.sendall(struct.pack("<Q", len(p)))
        sock.sendall(p)
    return n + 8


def _recv_parts(sock: socket.socket) -> tuple[list, int]:
    """(the rank-ordered payloads, the frame's length) of one broadcast,
    each payload received into its own buffer."""
    n, world = struct.unpack("<QI", _recv_exact(sock, 12))
    parts, used = [], 4
    for _ in range(world):
        (k,) = struct.unpack("<Q", _recv_exact(sock, 8))
        used += 8 + k
        if used > n:
            raise ConnectionError(f"malformed broadcast: {used} > {n} B")
        parts.append(_recv_exact(sock, k))
    if used != n:
        raise ConnectionError(f"malformed broadcast: {used} != {n} B")
    return parts, n


def _dial_with_backoff(host: str, port: int, deadline: float, what: str,
                       *, initial_s: float = 0.05,
                       cap_s: float = 1.0) -> socket.socket:
    """Deadline-bounded TCP dial with exponential backoff: a coordinator
    still setting up its accept refuses connects transiently, and
    retrying with growing sleeps (initial_s doubling to cap_s) inside
    the caller's deadline turns that window into latency instead of a
    launch failure.  The final failure raises DeadRankError naming
    `what` and the last OS error."""
    delay = initial_s
    last: Optional[Exception] = None
    while True:
        budget = deadline - time.monotonic()
        if budget <= 0:
            raise DeadRankError(
                f"{what}: could not connect to {host}:{port} before its "
                f"deadline (last error: "
                f"{type(last).__name__ if last is not None else 'none'}:"
                f" {last})") from last
        try:
            return socket.create_connection(
                (host, port), timeout=min(5.0, max(0.1, budget)))
        except OSError as e:
            last = e
            time.sleep(min(delay, max(0.0, deadline - time.monotonic())))
            delay = min(delay * 2.0, cap_s)


def _export_channel_byte_counters(rank: int, bytes_sent: int,
                                  bytes_received: int) -> None:
    """Publish a channel's cumulative byte counters as obs metrics
    (called at round boundaries: the counters themselves stay plain ints
    on the hot path)."""
    r = str(rank)
    sent = obs.counter("multihost_bytes_sent_total", rank=r)
    recv = obs.counter("multihost_bytes_received_total", rank=r)
    sent.inc(max(0.0, bytes_sent - sent.value))
    recv.inc(max(0.0, bytes_received - recv.value))


def _account_carry(raw: int, wire: int) -> None:
    """Carry-codec compression accounting: raw = the f32 bytes of the
    carry partials this rank encoded, wire = the encoded payload it
    shipped; the gauge is the cumulative raw/wire quotient."""
    c_raw = obs.counter("multihost_carry_raw_bytes_total")
    c_wire = obs.counter("multihost_carry_compressed_bytes_total")
    c_raw.inc(raw)
    c_wire.inc(wire)
    if c_wire.value > 0:
        obs.gauge("multihost_carry_compression_ratio").set(
            c_raw.value / c_wire.value)


class _GatherHandle:
    """In-flight state of ONE pipelined carry gather: rank 0 holds the
    background frame collector, workers the chained frame-push tail;
    gather_finish() consumes it.  One handle per collective."""

    __slots__ = ("n_frames", "deadline", "seq", "own", "pending",
                 "collector", "pushed", "aborted")

    def __init__(self, n_frames: int, deadline: float, seq: int):
        self.n_frames = int(n_frames)
        self.deadline = float(deadline)
        self.seq = int(seq)
        self.own: list[bytes] = []
        self.pending = None
        self.collector = None
        self.pushed = 0
        self.aborted = False


class HostChannel:
    """Small-payload allgather/barrier between the cluster's processes,
    carrying the flat f32 carry partials of the two-level round.

    Star topology: rank 0 coordinates (gathers every rank's payload,
    broadcasts the rank-ordered list), so every failure has a single
    observer that can name the dead rank.  All waits are bounded
    (`timeout_s`): a dead peer raises DeadRankError naming it instead of
    hanging the round loop.  Bytes and times land in
    multihost_bytes_sent/received_total and multihost_allgather_seconds.
    Rank 0's barrier arrivals go to the cluster observatory's ledger
    (obs/cluster.py)."""

    def __init__(self, ctx: MultihostContext, *,
                 timeout_s: float = 120.0,
                 connect_timeout_s: float = 60.0):
        self.ctx = ctx
        self.timeout_s = float(timeout_s)
        self.bytes_sent = 0
        self.bytes_received = 0
        self._mark = (0, 0)
        self._seq = 0
        # the runner stamps the round in flight here so the barrier
        # ledger can attribute gather waits to a round
        self.round_hint: Optional[int] = None
        self._peers: dict[int, socket.socket] = {}
        self._sock: Optional[socket.socket] = None
        self._listener: Optional[socket.socket] = None
        _cluster.set_role(ctx.rank, ctx.world)
        if ctx.world <= 1:
            return
        host, port = ctx.coordinator.rsplit(":", 1)
        port = int(port)
        if ctx.rank == 0:
            self._listener = socket.create_server((host, port))
            self._listener.settimeout(connect_timeout_s)
            deadline = time.monotonic() + connect_timeout_s

            def _setup_dead(reason: str):
                missing = sorted(set(range(1, ctx.world))
                                 - set(self._peers))
                for s in self._peers.values():
                    s.close()
                self._listener.close()
                raise DeadRankError(
                    f"multihost channel setup: rank(s) {missing} "
                    f"{reason} within {connect_timeout_s:.0f}s")

            while len(self._peers) < ctx.world - 1:
                try:
                    conn, _ = self._listener.accept()
                except socket.timeout:
                    conn = None
                if conn is None or time.monotonic() > deadline:
                    _setup_dead("never connected")
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                # accepted sockets block whatever the listener's
                # timeout: bound the rank handshake too, or a
                # connected-but-stalled peer hangs setup
                conn.settimeout(max(0.001, deadline - time.monotonic()))
                try:
                    (r,) = struct.unpack("<I", _recv_exact(conn, 4))
                except (socket.timeout, ConnectionError, OSError):
                    conn.close()
                    _setup_dead("connected but never sent a rank "
                                "handshake")
                self._peers[r] = conn
        else:
            # rank 0's accept window opens asynchronously with this
            # process's start, so first-connect refusals are expected
            self._sock = _dial_with_backoff(
                host, port, time.monotonic() + connect_timeout_s,
                f"multihost channel setup: rank {ctx.rank} dialing the "
                f"rank-0 coordinator at {ctx.coordinator}")
            self._sock.setsockopt(socket.IPPROTO_TCP,
                                  socket.TCP_NODELAY, 1)
            self._sock.sendall(struct.pack("<I", ctx.rank))

    # -- collective ops ------------------------------------------------------
    def allgather(self, payload: bytes,
                  timeout_s: Optional[float] = None) -> list[bytes]:
        """Every rank contributes `payload`; every rank receives the
        rank-ordered list.  Bounded: a silent rank raises DeadRankError
        naming it."""
        t0 = time.perf_counter()
        timeout = self.timeout_s if timeout_s is None else float(timeout_s)
        self._seq += 1
        ctx = self.ctx
        if ctx.world <= 1:
            return [payload]
        deadline = time.monotonic() + timeout
        try:
            if ctx.rank == 0:
                # barrier ledger: rank 0's own arrival opens the loop,
                # each peer's is its frame landing.  Piggybacked metric
                # sidecars are stripped BEFORE the broadcast, so every
                # rank folds the identical payload bytes
                arrivals = {0: time.monotonic()}
                parts: list[Optional[bytes]] = [None] * ctx.world
                parts[0] = payload
                for r in sorted(self._peers):
                    sock = self._peers[r]
                    sock.settimeout(max(0.001,
                                        deadline - time.monotonic()))
                    try:
                        parts[r] = _recv_frame(sock)
                    except (socket.timeout, ConnectionError, OSError) as e:
                        missing = sorted(r2 for r2 in range(1, ctx.world)
                                         if parts[r2] is None)
                        raise DeadRankError(
                            f"multihost allgather #{self._seq}: no "
                            f"payload from rank(s) {missing} within "
                            f"{timeout:.0f}s ({type(e).__name__}: "
                            f"process dead or hung)") from e
                    arrivals[r] = time.monotonic()
                    self.bytes_received += len(parts[r])
                    parts[r], side = _cluster.split_sidecar(parts[r])
                    if side is not None:
                        _cluster.fold_remote(r, side)
                _cluster.note_barrier("allgather", self._seq,
                                      self.round_hint, arrivals)
                for r in sorted(self._peers):
                    try:
                        self.bytes_sent += _send_parts(self._peers[r],
                                                       parts)
                    except (socket.timeout, ConnectionError, OSError) as e:
                        raise DeadRankError(
                            f"multihost allgather #{self._seq}: "
                            f"broadcast to rank {r} failed "
                            f"({type(e).__name__}: rank died after "
                            f"contributing)") from e
                return list(parts)          # type: ignore[arg-type]
            # non-root: ship ours, await the broadcast.  settimeout()
            # persists on the socket: reset it before the send, or the
            # send runs under the last allgather's near-expired deadline
            self._sock.settimeout(max(0.001,
                                      deadline - time.monotonic()))
            # live telemetry plane: a bounded metrics delta as a
            # self-describing payload trailer, stripped by rank 0;
            # attached ONLY when an obs dir is configured, so the obs-off
            # wire stays byte-identical
            out = payload
            if _cluster.telemetry_enabled():
                out = _cluster.attach_sidecar(
                    payload, _rollup_delta(_cluster.SIDECAR_CAP_BYTES))
            try:
                _send_frame(self._sock, out)
            except (socket.timeout, ConnectionError, OSError) as e:
                raise DeadRankError(
                    f"multihost allgather #{self._seq}: rank {ctx.rank} "
                    f"could not ship its payload to the rank-0 "
                    f"coordinator ({type(e).__name__}: coordinator dead "
                    f"or backpressured past {timeout:.0f}s)") from e
            self.bytes_sent += len(out) + 8
            self._sock.settimeout(max(0.001, deadline - time.monotonic()))
            try:
                parts, n = _recv_parts(self._sock)
            except (socket.timeout, ConnectionError, OSError) as e:
                raise DeadRankError(
                    f"multihost allgather #{self._seq}: rank {ctx.rank} "
                    f"got no broadcast from the rank-0 coordinator "
                    f"within {timeout:.0f}s ({type(e).__name__}: "
                    f"coordinator dead, or a peer stalled it)") from e
            self.bytes_received += n
            return parts
        finally:
            obs.histogram("multihost_allgather_seconds").observe(
                time.perf_counter() - t0)

    def barrier(self, timeout_s: Optional[float] = None) -> None:
        self.allgather(b"", timeout_s=timeout_s)

    # -- per-round wire accounting -------------------------------------------
    def mark_round(self) -> None:
        """Open a per-round wire window: bytes per round are what the
        channel moved between mark_round() and round_wire_delta()."""
        self._mark = (self.bytes_sent, self.bytes_received)

    def round_wire_delta(self) -> dict[str, int]:
        s0, r0 = self._mark
        return {"sent": self.bytes_sent - s0,
                "received": self.bytes_received - r0}

    # -- pipelined gather (exchange under compute) ---------------------------
    def gather_begin(self, n_frames: int,
                     timeout_s: Optional[float] = None) -> _GatherHandle:
        """Open a pipelined allgather of `n_frames` frames per rank:
        each rank pushes frames as they materialize (gather_push) and
        the collective completes in gather_finish(), so frame j's
        transfer overlaps frame j+1's block compute.  Equivalent by
        construction to allgather(b"".join(frames)): the frames
        concatenate in push order and the broadcast blob is identical,
        which keeps the f32 escape hatch bitwise under overlap."""
        timeout = self.timeout_s if timeout_s is None else float(timeout_s)
        self._seq += 1
        h = _GatherHandle(n_frames, time.monotonic() + timeout, self._seq)
        if self.ctx.world > 1 and self.ctx.rank == 0 and h.n_frames:
            from fedml_tpu_torch.parallel.prefetch import AsyncValue
            h.collector = AsyncValue(self._collect_frames, h,
                                     name=f"gather#{h.seq}")
        return h

    def _collect_frames(self, h: _GatherHandle):
        """Rank 0's background collector: drain every peer's frames in
        per-peer FIFO order while rank 0's own blocks compute; joined in
        gather_finish() (errors re-raise there).  Returns (frames,
        arrivals): a peer arrives at the barrier when its LAST frame
        lands."""
        remaining = {r: h.n_frames for r in self._peers}
        frames: dict[int, list[bytes]] = {r: [] for r in self._peers}
        arrivals: dict[int, float] = {}
        by_sock = {s: r for r, s in self._peers.items()}
        while any(remaining.values()) and not h.aborted:
            budget = h.deadline - time.monotonic()
            if budget <= 0:
                owing = sorted(r for r, n in remaining.items() if n)
                raise DeadRankError(
                    f"multihost gather #{h.seq}: rank(s) {owing} still "
                    f"owe carry frames at the deadline (process dead, "
                    f"hung, or its block compute overran the window)")
            socks = [self._peers[r] for r, n in remaining.items() if n]
            try:
                rl, _, _ = select.select(socks, [], [], min(0.2, budget))
            except (OSError, ValueError):
                rl = []          # a sock closed under us: deadline names it
            for s in rl:
                r = by_sock[s]
                s.settimeout(max(0.001, h.deadline - time.monotonic()))
                try:
                    f = _recv_frame(s)
                except (socket.timeout, ConnectionError, OSError) as e:
                    raise DeadRankError(
                        f"multihost gather #{h.seq}: rank {r} died "
                        f"mid-frame ({type(e).__name__})") from e
                self.bytes_received += len(f)
                frames[r].append(f)
                remaining[r] -= 1
                if remaining[r] == 0:
                    arrivals[r] = time.monotonic()
        return frames, arrivals

    def gather_push(self, h: _GatherHandle, frame: bytes) -> None:
        """Ship one frame into an open gather.  Rank 0 keeps its own
        (they never cross the wire); workers chain the send onto the
        previous push, so socket writes serialize while the caller
        returns to computing the next block."""
        h.pushed += 1
        if self.ctx.world <= 1 or self.ctx.rank == 0:
            h.own.append(bytes(frame))
            return
        from fedml_tpu_torch.parallel.prefetch import AsyncValue

        prev = h.pending

        def _ship(prev=prev, frame=frame):
            if prev is not None:
                prev.result()
            self._sock.settimeout(max(0.001,
                                      h.deadline - time.monotonic()))
            try:
                _send_frame(self._sock, frame)
            except (socket.timeout, ConnectionError, OSError) as e:
                raise DeadRankError(
                    f"multihost gather #{h.seq}: rank {self.ctx.rank} "
                    f"could not ship a carry frame to the rank-0 "
                    f"coordinator ({type(e).__name__})") from e
            self.bytes_sent += len(frame) + 8

        h.pending = AsyncValue(_ship, name=f"gather_push#{h.seq}")

    def gather_finish(self, h: _GatherHandle) -> list[bytes]:
        """Complete the collective: the rank-ordered list of per-rank
        payloads (each rank's frames joined in push order), the shape
        allgather returns."""
        ctx = self.ctx
        if ctx.world <= 1:
            return [b"".join(h.own)]
        if h.pushed != h.n_frames:
            raise ValueError(
                f"multihost gather #{h.seq}: {h.pushed} frames pushed "
                f"but {h.n_frames} promised; the collective would "
                f"hang every peer")
        if ctx.rank == 0:
            # rank 0 arrives when its own frames are pushed and it
            # enters the finish; the collector stamps each peer
            t_own = time.monotonic()
            parts: list[bytes] = [b""] * ctx.world
            parts[0] = b"".join(h.own)
            frames, arrivals = (h.collector.result()
                                if h.collector is not None
                                else ({r: [] for r in self._peers}, {}))
            arrivals[0] = t_own
            _cluster.note_barrier("gather", h.seq, self.round_hint,
                                  arrivals)
            for r, fl in frames.items():
                parts[r] = fl[0] if len(fl) == 1 else b"".join(fl)
            for r in sorted(self._peers):
                try:
                    self._peers[r].settimeout(
                        max(0.001, h.deadline - time.monotonic()))
                    self.bytes_sent += _send_parts(self._peers[r], parts)
                except (socket.timeout, ConnectionError, OSError) as e:
                    raise DeadRankError(
                        f"multihost gather #{h.seq}: broadcast to rank "
                        f"{r} failed ({type(e).__name__}: rank died "
                        f"after contributing)") from e
            return parts
        if h.pending is not None:
            h.pending.result()           # drain the push tail first
        self._sock.settimeout(max(0.001, h.deadline - time.monotonic()))
        try:
            parts, n = _recv_parts(self._sock)
        except (socket.timeout, ConnectionError, OSError) as e:
            raise DeadRankError(
                f"multihost gather #{h.seq}: rank {ctx.rank} got no "
                f"broadcast from the rank-0 coordinator "
                f"({type(e).__name__}: coordinator dead, or a peer "
                f"stalled it)") from e
        self.bytes_received += n
        return parts

    def gather_abort(self, h: _GatherHandle) -> None:
        """Invalidate an in-flight gather on the error path: the
        collector exits at its next poll instead of waiting out the
        deadline, and the push tail is drained best-effort."""
        h.aborted = True
        for av in (h.pending, h.collector):
            if av is not None:
                try:
                    av.result()
                except Exception:
                    pass

    def export_byte_counters(self) -> None:
        _export_channel_byte_counters(self.ctx.rank, self.bytes_sent,
                                      self.bytes_received)

    def close(self) -> None:
        for s in self._peers.values():
            try:
                s.close()
            except OSError:
                pass
        self._peers.clear()
        for s in (self._sock, self._listener):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self._sock = self._listener = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# topology-independent block sampling and the host fold
# ---------------------------------------------------------------------------

class BlockCohortSampler:
    """Per-block cohort sampling over fixed population ranges, the
    sampling half of the bitwise anchor.

    The population [0, C) splits into `n_blocks` contiguous ranges;
    block b draws `k_per_block` clients without replacement from its
    range on a private `default_rng([seed, round, block])` stream.  Every
    quantity is a pure function of (seed, round, block), not of which
    process computes it, and the draw touches no global RNG, so it is
    safe on a background thread."""

    def __init__(self, population: int, n_blocks: int, k_per_block: int,
                 seed: int):
        if n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
        if population % n_blocks:
            raise ValueError(
                f"population ({population}) must divide evenly into "
                f"{n_blocks} blocks (the id-range partition must be "
                f"topology-independent)")
        self.population = int(population)
        self.n_blocks = int(n_blocks)
        self.range_size = population // n_blocks
        if not 1 <= k_per_block <= self.range_size:
            raise ValueError(
                f"k_per_block ({k_per_block}) must be in [1, "
                f"{self.range_size}] (each block samples within its "
                f"{self.range_size}-client range)")
        self.k_per_block = int(k_per_block)
        self.seed = int(seed)

    def sample_block(self, round_idx: int, block: int) -> np.ndarray:
        """Global client ids of block `block`'s round-`round_idx`
        cohort, sorted ascending (one canonical order for every
        topology)."""
        if not 0 <= block < self.n_blocks:
            raise ValueError(f"block {block} outside [0, "
                             f"{self.n_blocks})")
        lo = block * self.range_size
        if self.k_per_block == self.range_size:
            return np.arange(lo, lo + self.range_size, dtype=np.int64)
        rng = np.random.default_rng(
            [self.seed, int(round_idx), int(block)])
        ids = rng.choice(self.range_size, size=self.k_per_block,
                         replace=False)
        return np.sort(ids).astype(np.int64) + lo


def fold_block_partials(parts: dict[int, np.ndarray],
                        n_blocks: int) -> np.ndarray:
    """THE deterministic inter-process reduction: a left fold of the
    per-block f32 partials in global block order, on the host.  Float
    addition is not associative, so the fold order is the contract:
    never a tree reduction or a kernel here."""
    missing = [b for b in range(n_blocks) if b not in parts]
    if missing:
        raise DeadRankError(
            f"two-level fold: block partial(s) {missing} missing from "
            f"the allgather (owning rank dead mid-round?)")
    total = np.array(parts[0], dtype=np.float32, copy=True)
    for b in range(1, n_blocks):
        total += np.asarray(parts[b], dtype=np.float32)
    return total


def fold_sparse_partials(pairs: dict[int, tuple], n_blocks: int,
                         dim: int) -> np.ndarray:
    """Sparse twin of ``fold_block_partials``: scatter-add each block's
    (idx, vals) pairs into the flat f32 carry in global block order,
    never densifying a per-block vector.  Per element the additions come
    in the dense fold's block order, so ranks agree for the same
    reason."""
    missing = [b for b in range(n_blocks) if b not in pairs]
    if missing:
        raise DeadRankError(
            f"two-level fold: block partial(s) {missing} missing from "
            f"the allgather (owning rank dead mid-round?)")
    total = np.zeros(int(dim), dtype=np.float32)
    for b in range(n_blocks):
        idx, vals = pairs[b]
        # top-k indices are unique within a block, so fancy-index +=
        # is a well-defined scatter-add
        total[idx] += np.asarray(vals, dtype=np.float32)
    return total


# ---------------------------------------------------------------------------
# the two-level round loop
# ---------------------------------------------------------------------------

# per-PROCESS metrics-rollup baseline: (registry identity, prev state),
# keyed on the registry object so obs.reset() resets the baseline with
# it.  The allgather piggyback and the end-of-run rollup advance the same
# baseline (their windows are disjoint, so rank 0 never double-counts),
# hence the lock around the read-modify-write.
_rollup_state: Optional[tuple] = None
_rollup_lock = threading.Lock()


def _rollup_delta(cap_bytes: Optional[int] = None) -> Optional[dict]:
    """This process's metrics delta since the last one it shipped.  With
    `cap_bytes` (the live piggyback), an empty delta or one over the
    frame budget returns None without advancing the baseline: it rides a
    later frame or the final rollup."""
    global _rollup_state
    with _rollup_lock:
        reg = obs.registry()
        prev = (_rollup_state[1]
                if _rollup_state is not None and _rollup_state[0] is reg
                else None)
        delta, state = reg.delta_snapshot(prev)
        if cap_bytes is not None and (
                not delta.get("metrics")
                or len(json.dumps(delta, sort_keys=True).encode())
                > cap_bytes):
            return None
        _rollup_state = (reg, state)
        return delta


class MultihostRunner:
    """Two-level multi-process round loop over a FedAvg-family chunked
    engine (parallel/engine.py: FedAvg, FedProx, FedOpt, FedNova and
    MeshRobustEngine's norm_clip).

    Per round, on every process:

      1. sample: `BlockCohortSampler` draws each block's cohort from its
         population range, a pure function of (seed, round, block);
      2. partial: for each OWNED block (contiguous tiling: rank r owns
         blocks [r·B/W, (r+1)·B/W)), the block's cohort is uploaded
         (streaming: host gather of the block, double-buffered one round
         ahead through parallel/prefetch.py; resident: an index-select on
         this rank's id-range stack, uploaded once) and trained through
         the engine's `_twolevel_partial`, which returns the flat f32
         carry on the host;
      3. exchange: `HostChannel.allgather` of the encoded partials (or
         the pipelined gather with `overlap_exchange`), then EVERY
         process folds all B partials in global block order;
      4. commit: `_twolevel_commit` divides and applies the server
         update identically on every process.

    Bitwise anchor: with a fixed `n_blocks`, same-seed runs at any
    process count that tiles the blocks commit identical bits, and with
    one block the round is the engine's `round_fn_streaming` on the same
    cohort.  The engine runs one device per rank (`n_shards` 1 in the
    handshake); two ranks may share one card."""

    def __init__(self, engine, ctx: Optional[MultihostContext] = None,
                 *, n_blocks: Optional[int] = None,
                 channel: Optional[HostChannel] = None,
                 timeout_s: float = 120.0,
                 carry_codec: str = "f32",
                 carry_chunk: Optional[int] = None,
                 overlap_exchange: bool = False,
                 on_round_end: Optional[Callable[[int], None]] = None):
        from fedml_tpu_torch.parallel.carry_codec import (DEFAULT_CHUNK,
                                                          make_carry_codec)
        from fedml_tpu_torch.parallel.engine import MeshFedAvgEngine
        if not isinstance(engine, MeshFedAvgEngine):
            raise ValueError(
                f"MultihostRunner drives the flat FedAvg-family chunked "
                f"engines, not {type(engine).__name__}")
        engine._ensure_twolevel()
        self.engine = engine
        self.ctx = ctx if ctx is not None else (
            MultihostContext.from_env() or MultihostContext.single())
        self.timeout_s = float(timeout_s)
        self.on_round_end = on_round_end
        world = self.ctx.world
        self.n_blocks = int(n_blocks) if n_blocks else world
        if self.n_blocks % world:
            raise ValueError(
                f"n_blocks ({self.n_blocks}) must be a multiple of the "
                f"process count ({world}): contiguous tiling is the "
                f"bitwise contract")
        cfg = engine.cfg
        if cfg.client_num_per_round % self.n_blocks:
            raise ValueError(
                f"client_num_per_round ({cfg.client_num_per_round}) "
                f"must divide evenly into {self.n_blocks} blocks")
        self.sampler = BlockCohortSampler(
            engine.data.client_num, self.n_blocks,
            cfg.client_num_per_round // self.n_blocks, cfg.seed)
        bpp = self.n_blocks // world
        self.owned_blocks = tuple(range(self.ctx.rank * bpp,
                                        (self.ctx.rank + 1) * bpp))
        # this process's population id range (contiguous because its
        # blocks are): the resident device stack holds only this slice
        self.range_lo = self.owned_blocks[0] * self.sampler.range_size
        self.range_hi = ((self.owned_blocks[-1] + 1)
                         * self.sampler.range_size)
        self._channel = channel
        self._owns_channel = channel is None
        self._range_stack = None
        self._prefetched = None
        self.codec = make_carry_codec(
            carry_codec,
            chunk=DEFAULT_CHUNK if carry_chunk is None else carry_chunk)
        self.overlap_exchange = bool(overlap_exchange)
        self.round_walls: list[float] = []
        self.carry_bytes: list[int] = []
        self.carry_wire_sent: list[int] = []
        self.carry_raw: list[int] = []       # f32 bytes before encoding
        self.carry_payload: list[int] = []   # encoded payload bytes
        self.overlap_waits: list[float] = []
        self.exchange_walls: list[float] = []

    # -- setup ---------------------------------------------------------------
    @property
    def channel(self) -> HostChannel:
        if self._channel is None:
            self._channel = HostChannel(self.ctx,
                                        timeout_s=self.timeout_s)
        return self._channel

    def _config_doc(self) -> bytes:
        """The canonical cross-rank config document: the quantities the
        bitwise contract depends on, in the JAX runner's schema
        (`n_shards` is 1: one device per rank)."""
        eng = self.engine
        return json.dumps({
            "n_blocks": self.n_blocks,
            "k_per_block": self.sampler.k_per_block,
            "population": self.sampler.population,
            "n_shards": 1,
            "chunk": eng.chunk,
            "seed": eng.cfg.seed,
            "family": eng.program_family,
            "streaming": bool(eng.streaming),
            # the carry codec shapes every wire payload: a mixed-codec
            # cluster is named at the handshake, not found mid-round
            "carry_codec": self.codec.name,
            "carry_chunk": self.codec.chunk,
        }, sort_keys=True).encode()

    def _handshake(self) -> None:
        """Cross-rank config agreement: the bitwise contract holds only
        when every process runs the same partition and programs; a
        mismatch names the rank instead of silently diverging."""
        doc = self._config_doc()
        docs = self.channel.allgather(doc, timeout_s=self.timeout_s)
        for r, d in enumerate(docs):
            if d != docs[0]:
                raise RuntimeError(
                    f"multihost config mismatch: rank {r} runs "
                    f"{d.decode()!r} vs rank 0's {docs[0].decode()!r}; "
                    f"the two-level reduction would not be bitwise")

    # -- per-round pieces ----------------------------------------------------
    def _lane0(self, block: int) -> int:
        """The block's first lane in the round's cohort: lane j of block
        b trains with client_generator(seed, round, lane0 + j), whatever
        rank computes it."""
        return block * self.sampler.k_per_block

    def _upload_range_stack(self):
        """Resident mode: upload THIS process's population id range
        once (device residency is id-range partitioned across ranks)."""
        if self._range_stack is None:
            eng = self.engine
            lo, hi = self.range_lo, self.range_hi
            host = eng._cast_stack_x({k: np.asarray(v)[lo:hi] for k, v in
                                      eng._host_shards().items()})
            eng.transfer_stats.add_h2d_bytes(
                sum(v.numel() * v.element_size() for v in host.values()))
            from fedml_tpu_torch.parallel.prefetch import upload
            stack = {k: upload(v, eng.device) for k, v in host.items()}
            weights = eng._upload_weights(np.asarray(
                eng.data.client_num_samples, np.float32)[lo:hi])
            self._range_stack = (stack, weights)
        return self._range_stack

    def _gather_streaming(self, round_idx: int):
        """Host-gather and upload every OWNED block's cohort (the
        per-rank input pipeline; runs on the prefetch thread when
        pipelined)."""
        return [(b, *self.engine._stream_gather(
            self.sampler.sample_block(round_idx, b)))
            for b in self.owned_blocks]

    def _streaming_blocks(self, round_idx: int, rounds: int) -> list:
        """The streaming input head with the per-rank double-buffered
        prefetch: consume round r's gathered blocks (from the prefetch
        thread when pipelined) and schedule round r+1's gather and
        upload."""
        from fedml_tpu_torch.parallel.prefetch import AsyncValue
        eng = self.engine
        pre, self._prefetched = self._prefetched, None
        if pre is not None and pre[0] == round_idx:
            blocks = pre[1].result()
        else:
            if pre is not None:
                try:
                    pre[1].result()
                except Exception:
                    log.warning("discarding failed stale multihost "
                                "prefetch for round %d", pre[0],
                                exc_info=True)
            with eng.transfer_stats.waiting():       # unhidden gather
                blocks = self._gather_streaming(round_idx)
        if eng.prefetch and round_idx + 1 < rounds:
            self._prefetched = (round_idx + 1, AsyncValue(
                self._gather_streaming, round_idx + 1,
                stats=eng.transfer_stats, device=eng.device))
        return blocks

    def _iter_partials(self, variables, round_idx: int, rounds: int):
        """(block, host f32 carry) in owned-block order, so each block's
        carry can ship while the next one computes."""
        eng = self.engine
        if eng.streaming:
            for b, cohort, weights in self._streaming_blocks(round_idx,
                                                             rounds):
                yield b, eng._twolevel_partial(
                    variables, cohort, weights, round_idx, self._lane0(b))
            return
        stack, stack_w = self._upload_range_stack()
        for b in self.owned_blocks:
            local = (self.sampler.sample_block(round_idx, b)
                     - self.range_lo)
            yield b, eng._twolevel_partial_resident(
                variables, stack, stack_w, local, round_idx, self._lane0(b))

    # -- codec plumbing ------------------------------------------------------
    def _encode_block(self, block: int, vec: np.ndarray) -> bytes:
        with obs.span("multihost.encode_carry", codec=self.codec.name,
                      block=block):
            data = self.codec.encode(block, vec)
        self._round_raw += vec.size * 4
        self._round_payload += len(data)
        return data

    def _finish_round_bytes(self) -> None:
        """Close this round's byte accounting: payload-level raw/wire
        into the codec counters and the channel-measured wire deltas."""
        _account_carry(self._round_raw, self._round_payload)
        self.carry_raw.append(self._round_raw)
        self.carry_payload.append(self._round_payload)
        d = self.channel.round_wire_delta()
        self.carry_bytes.append(d["received"])
        self.carry_wire_sent.append(d["sent"])

    def _fold_docs(self, docs: list, dim: int) -> np.ndarray:
        """Split every rank's payload into its blocks' frames, decode
        through the codec and fold in global block order."""
        bpp = self.n_blocks // self.ctx.world
        enb = self.codec.encoded_nbytes(dim)
        all_parts: dict[int, bytes] = {}
        for r, doc in enumerate(docs):
            if len(doc) != bpp * enb:
                raise DeadRankError(
                    f"two-level allreduce: rank {r} shipped "
                    f"{len(doc)} bytes, expected {bpp * enb} "
                    f"({bpp} blocks x {enb} B {self.codec.name} "
                    f"carry): config skew or a truncated frame")
            view = memoryview(doc)
            for j in range(bpp):
                all_parts[r * bpp + j] = view[j * enb:(j + 1) * enb]
        return self._decode_fold(all_parts)

    def _decode_fold(self, bufs: dict) -> np.ndarray:
        """Decode per-block payloads and fold: dense codecs decode then
        left-fold; sparse codecs scatter-add (idx, vals) pairs in the
        same global block order; topk_ef integrates every block's
        reconstruction mirror, then left-folds."""
        if getattr(self.codec, "sparse", False):
            if hasattr(self.codec, "integrate"):
                return fold_block_partials(
                    {int(b): self.codec.integrate(int(b), v)
                     for b, v in bufs.items()}, self.n_blocks)
            pairs, dim = {}, 0
            for b, v in bufs.items():
                dim, idx, vals = self.codec.decode_pairs(v)
                pairs[int(b)] = (idx, vals)
            return fold_sparse_partials(pairs, self.n_blocks, dim)
        return fold_block_partials(
            {int(b): self.codec.decode(v)
             for b, v in bufs.items()}, self.n_blocks)

    def carry_state(self) -> dict:
        """The codec's residual state (error-feedback accumulators): a
        checkpoint's extra_state, so a resumed run continues the same
        compression-error trajectory."""
        return self.codec.state_dict()

    def load_carry_state(self, state: Optional[dict]) -> None:
        self.codec.load_state_dict(state or {})

    def _round_exchange(self, variables, round_idx: int,
                        rounds: int) -> np.ndarray:
        """One round's partials and the inter-process exchange,
        returning the folded carry.  Serial: compute every owned block,
        then one blocking allgather of the encoded payload.  Overlapped
        (`overlap_exchange`): open a pipelined gather and push each
        block's encoded carry as it materializes, so the transfer rides
        under the remaining blocks' compute; only gather_finish is
        visible wait.  Both move identical bytes in identical order."""
        ch = self.channel
        ch.mark_round()
        self._round_raw = self._round_payload = 0
        w0 = time.perf_counter()
        dim = 0
        if self.overlap_exchange and self.ctx.world > 1:
            h = ch.gather_begin(len(self.owned_blocks),
                                timeout_s=self.timeout_s)
            try:
                for b, vec in self._iter_partials(variables, round_idx,
                                                  rounds):
                    dim = vec.size
                    ch.gather_push(h, self._encode_block(b, vec))
                with obs.span("multihost.overlap_wait", round=round_idx):
                    t0 = time.perf_counter()
                    docs = ch.gather_finish(h)
                    wait = time.perf_counter() - t0
            except Exception:
                ch.gather_abort(h)
                raise
            self.overlap_waits.append(wait)
            self.exchange_walls.append(time.perf_counter() - w0)
        else:
            parts = dict(self._iter_partials(variables, round_idx, rounds))
            dim = next(iter(parts.values())).size
            payload = b"".join(self._encode_block(b, parts[b])
                               for b in sorted(parts))
            with obs.span("multihost.allreduce", round=round_idx):
                t0 = time.perf_counter()
                docs = ch.allgather(payload, timeout_s=self.timeout_s)
                wait = time.perf_counter() - t0
            # the whole exchange is visible wait on the serial path, so
            # overlap_fraction reports an honest ~0
            self.overlap_waits.append(wait)
            self.exchange_walls.append(wait)
        self._finish_round_bytes()
        return self._fold_docs(docs, dim)

    # -- the loop ------------------------------------------------------------
    def run(self, variables: Optional[dict] = None,
            rounds: Optional[int] = None) -> dict:
        """Drive `rounds` two-level rounds; returns the trained variables
        (the same bits on every process).  Only rank 0 evaluates and
        appends metrics_history."""
        eng = self.engine
        cfg = eng.cfg
        rounds = rounds if rounds is not None else cfg.comm_round
        if variables is None:
            variables = eng.init_variables()
        server_state = eng.server_init(variables)
        self._handshake()
        try:
            for round_idx in range(rounds):
                t0 = time.perf_counter()
                with obs.span("round.twolevel", round=round_idx,
                              rank=self.ctx.rank,
                              blocks=len(self.owned_blocks)):
                    self.channel.round_hint = round_idx
                    total = self._round_exchange(variables, round_idx,
                                                 rounds)
                    variables, server_state, m = eng._twolevel_commit(
                        variables, server_state, total)
                if eng.device.type == "cuda":
                    torch.cuda.synchronize(eng.device)
                obs.counter("multihost_rounds_committed_total",
                            rank=str(self.ctx.rank)).inc()
                self.round_walls.append(time.perf_counter() - t0)
                self.channel.export_byte_counters()
                if self.ctx.rank == 0 and (
                        round_idx % cfg.frequency_of_the_test == 0
                        or round_idx == rounds - 1):
                    with obs.span("eval", round=round_idx):
                        stats = eng.evaluate(variables)
                    stats.update(round=round_idx,
                                 train_loss=float(m["train_loss"]),
                                 round_time=self.round_walls[-1])
                    eng.metrics_history.append(stats)
                    log.info("round %d: %s", round_idx, stats)
                if self.on_round_end is not None:
                    self.on_round_end(round_idx)
        except Exception as e:
            obs.dump_flight(f"multihost_error:rank{self.ctx.rank}: "
                            f"{e!r}")
            raise
        finally:
            pre, self._prefetched = self._prefetched, None
            if pre is not None:
                try:
                    pre[1].result()
                except Exception:
                    pass
        self._rollup_metrics()
        return variables

    def _rollup_metrics(self) -> None:
        """Ship every rank's metric deltas to rank 0 and fold them under
        origin="host<i>": an N-process run keeps per-process series
        instead of last-writer-wins gauges.  The delta is since the last
        rollup in this process, so back-to-back runners do not re-ship
        an earlier run's counters."""
        if self.ctx.world <= 1:
            return
        try:
            self.channel.round_hint = None   # ledger: not a round barrier
            delta = _rollup_delta()
            docs = self.channel.allgather(
                json.dumps(delta).encode(), timeout_s=self.timeout_s)
            if self.ctx.rank == 0:
                for r, doc in enumerate(docs):
                    if r == 0 or not doc:
                        continue
                    obs.registry().merge_delta(json.loads(doc.decode()),
                                               origin=f"host{r}")
        except DeadRankError:
            raise
        except Exception:
            log.warning("multihost metrics rollup failed", exc_info=True)

    def report(self, warmup_rounds: int = 0) -> dict:
        """Timing and byte rollup over the rounds run so far (warm-up
        rounds left out of the rate)."""
        walls = self.round_walls[warmup_rounds:]
        carry = self.carry_bytes[warmup_rounds:] or [0]
        sent = self.carry_wire_sent[warmup_rounds:] or [0]
        raw = self.carry_raw[warmup_rounds:]
        payload = self.carry_payload[warmup_rounds:]
        waits = self.overlap_waits[warmup_rounds:]
        ewalls = self.exchange_walls[warmup_rounds:]
        return {
            "rank": self.ctx.rank,
            "world": self.ctx.world,
            "n_blocks": self.n_blocks,
            "rounds": len(self.round_walls),
            "rounds_per_sec": (len(walls) / sum(walls)
                               if walls and sum(walls) > 0 else 0.0),
            "round_wall_p50_s": (float(np.median(walls))
                                 if walls else 0.0),
            "carry_allreduce_bytes_per_round": float(np.mean(carry)),
            # the sum of the per-round deltas, not channel.bytes_received:
            # the channel also carries handshake and rollup frames
            "carry_allreduce_bytes_total": int(sum(self.carry_bytes)),
            "carry_codec": self.codec.name,
            "carry_raw_bytes_per_round": (float(np.mean(raw))
                                          if raw else 0.0),
            "carry_payload_bytes_per_round": (float(np.mean(payload))
                                              if payload else 0.0),
            "carry_compression_ratio": (sum(raw) / sum(payload)
                                        if sum(payload) else 1.0),
            "carry_wire_sent_bytes_per_round": float(np.mean(sent)),
            # the share of the exchange window (first partial shipped to
            # folded carry ready) NOT spent blocking the round loop: ~0
            # serial, > 0 when the overlapped gather hides the transfer
            "overlap_fraction": (max(0.0, 1.0 - sum(waits)
                                     / sum(ewalls))
                                 if ewalls and sum(ewalls) > 0
                                 else 0.0),
        }

    def close(self) -> None:
        if self._channel is not None and self._owns_channel:
            self._channel.close()
            self._channel = None


def variables_digest(variables: dict) -> str:
    """md5 over the raw bytes of every leaf in the dict's order (the
    trainer's flat order): THE bitwise-equality digest of the
    multi-process pins."""
    h = hashlib.md5()
    for v in variables.values():
        t = v.detach().to("cpu").contiguous().reshape(-1)
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()
