"""Selector-based connection swarm: the client half of a live-connection
load test (port of fedml_tpu/comm/connswarm.py, the same code: it never
touched JAX).

Driving 10k live uplinks cannot be done with 10k client threads any
more than serving them can: the swarm is the reactor's mirror image —
ONE event loop owning N non-blocking client sockets that connect
(optionally as a storm: every SYN at once, the push-notification
stampede), keep a paced uplink going (an aggregate offered rate spread
round-robin across the fleet, each frame riding the FMLR envelope so
the server's dedup ledger and ack path see production-shaped traffic),
read-and-discard the acks, and churn (seeded exponential lifetimes →
close + reconnect; a server-side eviction/shed also reconnects — the
flash-crowd arrival shape replayed as connection churn).

Runs in-process (a daemon thread) or as a subprocess
(`python -m fedml_tpu_torch.comm.connswarm <config.json>`), so a 10k
fleet can split its file descriptors across two processes: one
process's `ulimit -n` may not hold both halves of 10k connections.
Everything is seeded: same seed, same connect/churn schedule.  The swarm
is host code; it never touches a tensor or the card.
"""
from __future__ import annotations

import dataclasses
import errno
import heapq
import json
import logging
import selectors
import socket
import struct
import sys
import threading
import time
import zlib
from collections import deque
from typing import Optional

import numpy as np

from fedml_tpu_torch.comm import reliability

log = logging.getLogger(__name__)

_LEN = struct.Struct("<Q")
_INPROGRESS = (errno.EINPROGRESS, errno.EWOULDBLOCK, errno.EAGAIN)


@dataclasses.dataclass
class SwarmConfig:
    """Knobs of one swarm run.  The pre-encoded uplink frame is passed
    as bytes in-process, or via `frame_path` for the subprocess mode.

    `targets` stripes ONE fleet across N host endpoints —
    a list of [host, port] pairs; sender i dials targets[(i-1) % N],
    and the stats grow a `per_target` block (connects/refused/frames
    per endpoint).  None keeps the single-endpoint (host, port)
    behavior byte-for-byte.  `arrival` (an ArrivalConfig asdict)
    replays a diurnal/flash-crowd profile (scale/arrivals.py) over real
    sockets:
    offered_rate becomes the fleet's PEAK and the instantaneous rate
    follows λ(t)/λ_peak of the configured process."""
    host: str = "127.0.0.1"
    port: int = 53600
    n_connections: int = 256
    offered_rate: float = 2000.0     # aggregate uplink frames/sec
    ramp_s: float = 1.0              # clean arm: connects spread over this
    storm: bool = False              # storm arm: every connect at t=0
    churn_lifetime_s: float = 0.0    # mean conn lifetime (0 = no churn)
    reconnect_delay_s: float = 0.05
    duration_s: float = 600.0        # subprocess self-termination bound
    seed: int = 0
    frame_path: Optional[str] = None
    tick_s: float = 0.01
    targets: Optional[list] = None   # [[host, port], ...] multi-endpoint
    arrival: Optional[dict] = None   # ArrivalConfig asdict rate profile
    # max banked send budget, in seconds of offered load (the
    # no-post-stall-burst cap).  A small cap (~0.05) makes a fleet that
    # waited out the serving hosts' startup pace at λ(t) instead of
    # dumping a burst
    burst_cap_s: float = 1.0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, text: str) -> "SwarmConfig":
        return cls(**json.loads(text))


class _CConn:
    __slots__ = ("sock", "fd", "sender", "connected", "pending",
                 "die_at", "mask", "target")

    def __init__(self, sock: socket.socket, sender: int,
                 target: str = ""):
        self.sock = sock
        self.fd = sock.fileno()
        self.sender = sender
        self.connected = False
        self.pending: Optional[memoryview] = None
        self.die_at: Optional[float] = None
        self.mask = 0
        self.target = target


class ConnectionSwarm:
    """One event loop, N client connections, paced enveloped uplinks."""

    def __init__(self, cfg: SwarmConfig, frame: bytes):
        self.cfg = cfg
        self.frame = bytes(frame)
        self._crc = zlib.crc32(self.frame) & 0xFFFFFFFF
        self._rng = np.random.default_rng([cfg.seed, 7])
        self._sel = selectors.DefaultSelector()
        self._conns: dict[int, _CConn] = {}
        self._seq: dict[int, int] = {}       # persists across reconnects
        self._send_ring: deque = deque()     # round-robin uplink order
        self._events: list[tuple[float, int]] = []  # heap: (due, sender),
        #                                             absolute monotonic
        self.stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # one fleet, N endpoints: sender i always dials the
        # SAME target — striping is a pure function of the sender id,
        # so reconnects land where the seq ledger expects them
        self._targets = [(str(h), int(p))
                         for h, p in (cfg.targets
                                      or [(cfg.host, cfg.port)])]
        self.stats = {"connects": 0, "reconnects": 0, "refused": 0,
                      "frames_sent": 0, "conn_errors": 0,
                      "per_target": {
                          f"{h}:{p}": {"connects": 0, "refused": 0,
                                       "frames_sent": 0,
                                       "conn_errors": 0}
                          for h, p in self._targets}}
        self._arr = None
        if cfg.arrival:
            from fedml_tpu_torch.scale.arrivals import (ArrivalConfig,
                                                  make_arrivals)
            self._arr = make_arrivals(ArrivalConfig(**cfg.arrival))

    def _target_of(self, sender: int) -> tuple:
        return self._targets[(sender - 1) % len(self._targets)]

    def _tstat(self, conn_or_key) -> dict:
        key = (conn_or_key if isinstance(conn_or_key, str)
               else conn_or_key.target)
        return self.stats["per_target"][key]

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ConnectionSwarm":
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name="conn-swarm")
        self._thread.start()
        return self

    def join(self, timeout: float = 10.0) -> None:
        self.stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    # -- loop ----------------------------------------------------------------
    def run(self) -> None:
        cfg = self.cfg
        t0 = time.monotonic()
        for sender in range(1, cfg.n_connections + 1):
            due = 0.0 if cfg.storm else (
                cfg.ramp_s * sender / cfg.n_connections)
            heapq.heappush(self._events, (t0 + due, sender))
        budget = 0.0
        last = t0
        deadline = t0 + cfg.duration_s
        try:
            while not self.stop.is_set() and time.monotonic() < deadline:
                now = time.monotonic()
                while self._events and self._events[0][0] <= now:
                    _, sender = heapq.heappop(self._events)
                    self._connect(sender, now)
                for key, mask in self._sel.select(timeout=cfg.tick_s):
                    conn = key.data
                    if self._conns.get(conn.fd) is not conn:
                        continue
                    try:
                        if mask & selectors.EVENT_WRITE:
                            self._on_writable(conn)
                        # re-check liveness BETWEEN handlers: a failed
                        # handshake (READ|WRITE on a refused connect)
                        # closes + reschedules in the WRITE handler,
                        # and running READ on the corpse would
                        # reschedule the same sender a second time —
                        # doubling the fleet on every refusal
                        if (mask & selectors.EVENT_READ
                                and self._conns.get(conn.fd) is conn):
                            self._on_readable(conn)
                    except OSError:
                        if self._conns.get(conn.fd) is conn:
                            self._drop(conn, error=True)
                now = time.monotonic()
                # arrival-profile pacing: offered_rate is
                # the fleet's peak; the instantaneous rate follows the
                # configured diurnal/flash λ(t) shape — real sockets
                # replaying the arrival processes
                rate = (cfg.offered_rate if self._arr is None
                        else cfg.offered_rate
                        * self._arr.rate_fraction(now - t0))
                budget = min(budget + rate * (now - last),
                             cfg.offered_rate * cfg.burst_cap_s)
                last = now
                tried = 0
                limit = len(self._send_ring)
                while budget >= 1.0 and tried < limit and self._send_ring:
                    conn = self._send_ring.popleft()
                    tried += 1
                    if self._conns.get(conn.fd) is not conn:
                        continue          # churned away: drop ring entry
                    if conn.connected and conn.pending is None:
                        if self._uplink(conn):
                            budget -= 1.0
                    if self._conns.get(conn.fd) is conn:
                        self._send_ring.append(conn)
                if cfg.churn_lifetime_s > 0.0:
                    self._churn(now)
        finally:
            for conn in list(self._conns.values()):
                self._close(conn)
            try:
                self._sel.close()
            except OSError:
                pass

    # -- connect / churn -----------------------------------------------------
    def _schedule_reconnect(self, sender: int) -> None:
        if self.stop.is_set():
            return
        delay = self.cfg.reconnect_delay_s * (
            1.0 + float(self._rng.random()))
        heapq.heappush(self._events, (time.monotonic() + delay, sender))

    def _connect(self, sender: int, now: float) -> None:
        host, port = self._target_of(sender)
        tkey = f"{host}:{port}"
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setblocking(False)
        try:
            rc = s.connect_ex((host, port))
        except OSError:
            s.close()
            self.stats["conn_errors"] += 1
            self._tstat(tkey)["conn_errors"] += 1
            self._schedule_reconnect(sender)
            return
        if rc not in (0,) and rc not in _INPROGRESS:
            s.close()
            self.stats["refused"] += 1
            self._tstat(tkey)["refused"] += 1
            self._schedule_reconnect(sender)
            return
        conn = _CConn(s, sender, target=tkey)
        if self.cfg.churn_lifetime_s > 0.0:
            conn.die_at = now + float(self._rng.exponential(
                self.cfg.churn_lifetime_s))
        try:
            self._sel.register(s, selectors.EVENT_WRITE
                               | selectors.EVENT_READ, conn)
        except (ValueError, OSError):
            # FD pressure / transient selector failure: this sender
            # must NOT silently vanish from the swarm (a run under
            # reduced load would masquerade as n_connections of
            # pressure) — count + retry
            s.close()
            self.stats["conn_errors"] += 1
            self._schedule_reconnect(sender)
            return
        conn.mask = selectors.EVENT_WRITE | selectors.EVENT_READ
        self._conns[conn.fd] = conn
        self.stats["connects"] += 1
        self._tstat(conn)["connects"] += 1
        if self._seq.get(sender, 0) > 0:
            self.stats["reconnects"] += 1
        self._send_ring.append(conn)

    def _churn(self, now: float) -> None:
        for conn in list(self._conns.values()):
            if conn.die_at is not None and now >= conn.die_at:
                sender = conn.sender
                self._close(conn)
                self._schedule_reconnect(sender)

    # -- socket events -------------------------------------------------------
    def _on_writable(self, conn: _CConn) -> None:
        if not conn.connected:
            err = conn.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
            if err != 0:
                # refused/reset mid-handshake: the shed gate at work —
                # retry after the reconnect delay (the storm's churn)
                self.stats["refused"] += 1
                self._tstat(conn)["refused"] += 1
                sender = conn.sender
                self._close(conn)
                self._schedule_reconnect(sender)
                return
            conn.connected = True
            try:
                conn.sock.setsockopt(socket.IPPROTO_TCP,
                                     socket.TCP_NODELAY, 1)
            except OSError:
                pass
        if conn.pending is not None:
            n = conn.sock.send(conn.pending)
            conn.pending = (conn.pending[n:] if n < len(conn.pending)
                            else None)
        self._interest(conn)

    def _on_readable(self, conn: _CConn) -> None:
        # acks/nacks: drain and discard — the swarm prices the server,
        # not the client's bookkeeping
        data = conn.sock.recv(1 << 16)
        if not data:
            # server closed us (eviction / shed / drain): reconnect —
            # exactly the churn pressure the storm arm measures
            self.stats["conn_errors"] += 1
            self._drop(conn)

    def _uplink(self, conn: _CConn) -> bool:
        seq = self._seq.get(conn.sender, 0)
        self._seq[conn.sender] = seq + 1
        head = reliability._HEADER.pack(
            reliability.MAGIC, reliability.KIND_DATA, conn.sender, seq,
            self._crc)
        wire = head + self.frame
        buf = _LEN.pack(len(wire)) + wire
        try:
            n = conn.sock.send(buf)
        except (BlockingIOError, InterruptedError):
            n = 0
        except OSError:
            self._drop(conn, error=True)
            return False
        if n < len(buf):
            conn.pending = memoryview(buf)[n:]
        self.stats["frames_sent"] += 1
        self._tstat(conn)["frames_sent"] += 1
        self._interest(conn)
        return True

    # -- bookkeeping ---------------------------------------------------------
    def _interest(self, conn: _CConn) -> None:
        mask = selectors.EVENT_READ
        if conn.pending is not None or not conn.connected:
            mask |= selectors.EVENT_WRITE
        if mask != conn.mask:
            try:
                self._sel.modify(conn.sock, mask, conn)
                conn.mask = mask
            except (KeyError, ValueError, OSError):
                pass

    def _drop(self, conn: _CConn, error: bool = False) -> None:
        if error:
            self.stats["conn_errors"] += 1
        sender = conn.sender
        self._close(conn)
        self._schedule_reconnect(sender)

    def _close(self, conn: _CConn) -> None:
        if self._conns.pop(conn.fd, None) is None:
            return
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass


def main(argv: Optional[list] = None) -> int:
    """Subprocess entry: `python -m fedml_tpu_torch.comm.connswarm cfg.json`.
    Runs until SIGTERM (or duration_s), then prints one JSON stats
    line for the parent process to collect."""
    import signal
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("usage: python -m fedml_tpu_torch.comm.connswarm <config.json>",
              file=sys.stderr)
        return 2
    cfg = SwarmConfig.from_json(open(argv[0]).read())
    if not cfg.frame_path:
        print("subprocess swarm needs frame_path", file=sys.stderr)
        return 2
    frame = open(cfg.frame_path, "rb").read()
    swarm = ConnectionSwarm(cfg, frame)

    def _term(signum, frm):
        swarm.stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    swarm.run()
    print(json.dumps(swarm.stats), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
