"""Selector/event-loop reactor transport — overload-safe live connections


The FedML regime (arXiv:2007.13518) is live concurrent uplinks, and the
Smart-NIC server study (arXiv:2307.06561) shows the connection layer —
not the aggregation math — is what collapses first.  The thread-per-
connection transport (one Python recv thread per peer) dies far below
the registry's 1M-client capacity: 10k peers means 10k blocked OS
threads before the first frame decodes.  This module replaces that with
a classic reactor:

* **one `selectors`-based event loop per core** (`Reactor`), owning
  NON-BLOCKING accepted sockets with per-connection bounded read/write
  buffers and incremental frame reassembly (8-byte LE length prefix ‖
  frame — the same wire format as the thread transport, byte for byte);
* complete frames feed the backend's existing `_deliver_frame`
  chokepoint, so chaos injection, the reliability envelope,
  trace stamping, and the admission screen all ride
  UNCHANGED — the reactor is a transport swap, not a protocol change
  (a reactor-transport async run commits the same accumulator as the
  thread-per-connection run, pinned in tests/test_reactor.py);
* **backpressure as read-interest suspension**: when the decode pool or
  the bounded inbox cannot admit a frame
  (`BaseCommManager._reactor_pressure`), the reactor STOPS READING that
  peer — bytes queue in the kernel socket buffer and TCP flow control
  reaches the sender — instead of blocking a shared loop thread the
  way a blocking sink blocks a dedicated recv thread;
* **overload safety**, every degradation counted, never a silent hang:
  slow-peer (slowloris) stall eviction (a connection mid-frame with no
  progress past `stall_timeout_s` is closed), optional idle eviction,
  per-connection byte- and frame-rate ceilings (violating windows
  throttle, repeat offenders evict), a load-shedding gate that rejects
  new connections and sheds the stalest-uplink peers when the decode
  pool saturates past `shed_after_s` / RSS crosses `rss_limit_bytes` /
  an external gate trips, and graceful drain on shutdown (pending
  writes flush inside `drain_s`, then every socket closes — the FD
  audit in tests/test_reactor.py holds a 10k-churn run to zero leaks).

Known tradeoff, stated honestly: a SINK-LESS backend (the sync FSM
deployment path — no decode pool installed) decodes frames inline on
the owning loop thread, so concurrent multi-MB decodes serialize per
loop where the thread transport overlapped them across per-connection
recv threads (zlib/numpy release the GIL).  `reactors=N` spreads
connections across loops; the production ingestion path (the async
server's decode pool) never decodes on the loop at all — it is the
sink-less, many-large-concurrent-uplink corner that prefers
`reactor=False`, and the round-barrier FSM deployments that live in
that corner are latency-tolerant by construction.

Observability: `comm_open_connections` gauge,
`comm_connections_evicted_total{reason=stall|rate|shed|idle|protocol|
error}`,
`comm_uplinks_shed_total`, `comm_connections_drained_total`,
`comm_accept_fd_exhausted_total`, a `reactor_loop_lag_seconds`
histogram on the sub-ms decode ladder, and `reactor.*` spans/instants
feeding the timeline's "reactor" stage.
"""
from __future__ import annotations

import dataclasses
import errno
import itertools
import logging
import os
import selectors
import socket
import struct
import threading
import time
from collections import deque
from typing import Callable, Optional

from fedml_tpu_torch import obs

log = logging.getLogger(__name__)

_LEN = struct.Struct("<Q")
_RECV_CHUNK = 1 << 18            # 256 KiB per readable event per conn

ENV_REACTOR = "FEDML_TCP_REACTOR"    # "0" = thread-per-connection escape


def reactor_default() -> bool:
    """Process-wide default transport choice: the reactor, unless
    FEDML_TCP_REACTOR=0 pins the legacy thread-per-connection path
    (the same escape-hatch stance as FEDML_WIRE_V1/FEDML_RELIABLE)."""
    return os.environ.get(ENV_REACTOR, "") != "0"


def fd_limit() -> tuple[int, int]:
    """(soft, hard) RLIMIT_NOFILE — the `ulimit -n` every FD-exhaustion
    message must name."""
    import resource
    return resource.getrlimit(resource.RLIMIT_NOFILE)


def open_fd_count() -> int:
    """Open descriptors of this process (-1 where /proc is absent) —
    the churn test's leak probe."""
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return -1


class FdExhaustionError(OSError):
    """accept(2) failed with EMFILE/ENFILE: the process (or system) is
    out of file descriptors.  Named — with the current `ulimit -n` in
    the message — so the operator sees "raise the fd limit or shed
    load", not a bare OSError that killed the listener."""


def accept_exhaustion(exc: OSError) -> Optional[FdExhaustionError]:
    """Translate an accept(2) OSError into the named FD-exhaustion
    error (None when it is some other failure).  The reactor logs the
    translated error and keeps the listener ALIVE with a short accept
    backoff; the thread transport's accept loop does the same — under
    no circumstance does fd pressure silently end accepting."""
    if exc.errno in (errno.EMFILE, errno.ENFILE):
        soft, hard = fd_limit()
        return FdExhaustionError(
            exc.errno,
            f"accept failed: file descriptors exhausted "
            f"(ulimit -n: soft={soft} hard={hard}) — raise the limit or "
            f"let the shed gate cap connections")
    return None


@dataclasses.dataclass
class ReactorConfig:
    """Overload-safety knobs of one reactor group (one listening
    backend).  Defaults are permissive — existing deployments behave
    like the thread transport did; the connection bench and the CLI
    tighten them."""
    reactors: int = 1                 # event loops (≈ one per core)
    max_connections: int = 16384      # inbound admission ceiling
    max_frame_bytes: int = 1 << 30    # oversized length prefix = protocol evict
    read_buffer: int = 4 << 20        # unparsed inbound bytes beyond which
    #                                   reads pause (a frame may exceed it;
    #                                   the bound then is frame + one chunk)
    write_buffer: int = 8 << 20       # pending outbound cap — a peer that
    #                                   won't read its acks past this is a
    #                                   slow reader and evicts as a stall
    stall_timeout_s: Optional[float] = 30.0   # mid-frame no-progress evict
    idle_timeout_s: Optional[float] = None    # fully-idle evict (opt-in)
    max_bytes_per_sec: Optional[float] = None   # per-conn ceilings; a
    max_frames_per_sec: Optional[float] = None  # violating window throttles
    rate_violation_limit: int = 3     # consecutive violating windows -> evict
    shed_on_pressure: bool = False    # decode-pool pressure sustained past
    shed_after_s: float = 1.0         # shed_after_s trips the shed gate
    shed_batch: int = 8               # conns shed per housekeeping pass
    rss_limit_bytes: Optional[int] = None     # memory watermark gate
    drain_s: float = 2.0              # graceful-drain budget at close()
    tick_s: float = 0.05              # loop wakeup when idle
    housekeep_s: float = 0.25         # eviction/resume scan cadence

    def __post_init__(self):
        if self.reactors < 1:
            raise ValueError(f"reactors must be >= 1, got {self.reactors}")
        if self.max_connections < 1:
            raise ValueError("max_connections must be >= 1")


class _Conn:
    """Per-connection reactor state: reassembly buffer, bounded write
    queue, rate window, and the activity clocks the eviction deadlines
    read."""

    __slots__ = ("sock", "fd", "outbound", "buf", "need", "out",
                 "out_bytes", "created", "last_progress", "last_frame",
                 "last_write_progress", "win_start", "win_bytes",
                 "win_frames", "win_flagged", "violations",
                 "paused_pressure", "rate_pause_until",
                 "registered_mask", "closed")

    def __init__(self, sock: socket.socket, outbound: bool):
        now = time.monotonic()
        self.sock = sock
        self.fd = sock.fileno()
        self.outbound = outbound
        self.buf = bytearray()
        self.need: Optional[int] = None
        self.out: deque = deque()
        self.out_bytes = 0
        self.created = now
        self.last_progress = now
        self.last_frame = now
        self.last_write_progress = now
        self.win_start = now
        self.win_bytes = 0
        self.win_frames = 0
        self.win_flagged = False
        self.violations = 0
        self.paused_pressure = False
        self.rate_pause_until = 0.0
        self.registered_mask = 0
        self.closed = False


class Reactor:
    """One event loop: a selector + its thread.  All mutation of the
    selector and the conn table happens ON the loop thread — cross-
    thread callers go through `call_soon` + the wake socketpair."""

    def __init__(self, group: "ReactorGroup", idx: int):
        self.group = group
        self.idx = idx
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ,
                           ("wake", None))
        self._pending: deque = deque()
        self._plock = threading.Lock()
        self._conns: dict[int, _Conn] = {}
        # insertion-ordered (dict-as-set): the resume sweep pops FIFO
        # and a re-paused conn re-inserts at the END, so paused peers
        # genuinely rotate — a plain set iterates in fd-hash order and
        # would let the lowest-fd peer starve the rest under sustained
        # pressure
        self._pressure_paused: dict[int, None] = {}
        self._ready_hook_installed = False
        self._alive = True
        self._draining = False
        self._drain_deadline = 0.0
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"reactor-{group.name}-{idx}")

    # -- cross-thread entry points -------------------------------------------
    def call_soon(self, fn: Callable[[], None]) -> None:
        with self._plock:
            self._pending.append(fn)
        try:
            self._wake_w.send(b"\0")
        except OSError:
            pass                    # loop gone / wake buffer full: either
            #                         way the loop wakes within tick_s

    def adopt(self, sock: socket.socket, outbound: bool) -> None:
        self.call_soon(lambda: self._register(sock, outbound))

    def forget(self, sock: socket.socket) -> None:
        """Drop a socket another thread already invalidated/closed
        (the _raw_send failure path) without double-closing it."""
        fd = -1
        try:
            fd = sock.fileno()
        except OSError:
            pass
        self.call_soon(lambda: self._forget(sock, fd))

    def send(self, conn: _Conn, data: bytes) -> None:
        if threading.current_thread() is self._thread:
            self._enqueue(conn, data)
        else:
            self.call_soon(lambda: self._enqueue(conn, data))

    # -- loop ----------------------------------------------------------------
    def _run(self) -> None:
        cfg = self.group.cfg
        next_house = time.monotonic() + cfg.housekeep_s
        while self._alive:
            try:
                events = self._sel.select(timeout=cfg.tick_s)
            except OSError:
                events = []
            t0 = time.perf_counter()
            worked = bool(events)
            while True:
                with self._plock:
                    if not self._pending:
                        break
                    fn = self._pending.popleft()
                worked = True
                try:
                    fn()
                except Exception:
                    log.exception("reactor-%s-%d: pending callback failed",
                                  self.group.name, self.idx)
            for key, mask in events:
                kind, payload = key.data
                try:
                    if kind == "wake":
                        try:
                            while self._wake_r.recv(4096):
                                pass
                        except OSError:
                            pass
                    elif kind == "listener":
                        self.group._on_accept(self)
                    elif kind == "conn":
                        if mask & selectors.EVENT_WRITE:
                            self._on_writable(payload)
                        if mask & selectors.EVENT_READ:
                            self._on_readable(payload)
                except Exception:
                    # the zero-recv-deaths contract: nothing that
                    # escapes a handler may kill the LOOP — count it
                    # like a thread death would have been and close
                    # only the offending connection
                    self.group.backend._m_recv_deaths.inc()
                    log.exception("reactor-%s-%d: handler died",
                                  self.group.name, self.idx)
                    if kind == "conn":
                        self._evict(payload, "error")
            now = time.monotonic()
            if now >= next_house or self._draining:
                self._housekeep(now)
                next_house = now + cfg.housekeep_s
            if worked:
                # loop lag: how long this iteration's event batch held
                # the loop (every other connection's added latency);
                # idle ticks don't observe — the ladder measures lag
                # under load, not sleep accuracy
                self.group._m_loop_lag.observe(time.perf_counter() - t0)
        self._teardown()

    # -- registration / interest ---------------------------------------------
    def _register(self, sock: socket.socket, outbound: bool) -> None:
        if not self._alive or self._draining:
            self._safe_close(sock)
            if not outbound:
                self.group._note_inbound_closed()
            return
        conn = _Conn(sock, outbound)
        try:
            self._sel.register(sock, selectors.EVENT_READ, ("conn", conn))
        except KeyError:
            # the kernel reused the fd of a socket whose forget() has
            # not drained yet: evict the stale registration by object
            # and retry once — never leak the fresh socket
            self._forget_stale_fd(conn.fd)
            try:
                self._sel.register(sock, selectors.EVENT_READ,
                                   ("conn", conn))
            except (KeyError, ValueError, OSError):
                self._safe_close(sock)
                if not outbound:
                    self.group._note_inbound_closed()
                return
        except (ValueError, OSError):
            self._safe_close(sock)
            if not outbound:
                self.group._note_inbound_closed()
            return
        conn.registered_mask = selectors.EVENT_READ
        self._conns[conn.fd] = conn

    def _forget(self, sock: socket.socket, fd: int) -> None:
        # resolve by OBJECT identity, not fd: the caller may have
        # closed the socket already (fileno() == -1) and the kernel may
        # have reused the fd for a newer conn — popping blindly by fd
        # would corrupt the table
        conn = self._conns.get(fd) if fd >= 0 else None
        if conn is None or conn.sock is not sock:
            conn = next((c for c in self._conns.values()
                         if c.sock is sock), None)
        if conn is not None:
            self._conns.pop(conn.fd, None)
            conn.closed = True
            self.group._note_close(conn)
        try:
            self._sel.unregister(sock)
        except (KeyError, ValueError, OSError):
            pass

    def _forget_stale_fd(self, fd: int) -> None:
        """Drop a stale conn (and its selector entry) still keyed on a
        now-reused fd."""
        conn = self._conns.pop(fd, None)
        if conn is not None:
            conn.closed = True
            try:
                self._sel.unregister(conn.sock)
            except (KeyError, ValueError, OSError):
                pass
            self.group._note_close(conn)

    def _set_interest(self, conn: _Conn) -> None:
        if conn.closed:
            return
        mask = 0
        now = time.monotonic()
        if (not conn.paused_pressure and now >= conn.rate_pause_until
                and len(conn.buf) <= max(self.group.cfg.read_buffer,
                                         (conn.need or 0) + 8)):
            mask |= selectors.EVENT_READ
        if conn.out:
            mask |= selectors.EVENT_WRITE
        if mask == conn.registered_mask:
            return
        try:
            if mask == 0:
                self._sel.unregister(conn.sock)
            elif conn.registered_mask == 0:
                self._sel.register(conn.sock, mask, ("conn", conn))
            else:
                self._sel.modify(conn.sock, mask, ("conn", conn))
            conn.registered_mask = mask
        except (KeyError, ValueError, OSError):
            self._close(conn)

    # -- read path: reassembly + delivery ------------------------------------
    def _on_readable(self, conn: _Conn) -> None:
        if conn.closed:
            return
        try:
            data = conn.sock.recv(_RECV_CHUNK)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close(conn)
            return
        if not data:
            # peer closed (or half-closed its write side): deliver any
            # complete frames already buffered, then close — a shutdown
            # mid-frame drops the partial silently like a torn wire
            self._parse(conn, at_eof=True)
            self._close(conn)
            return
        conn.buf += data
        conn.last_progress = time.monotonic()
        self._parse(conn)

    def _parse(self, conn: _Conn, at_eof: bool = False) -> None:
        group = self.group
        backend = group.backend
        cfg = group.cfg
        while not conn.closed:
            if conn.need is None:
                if len(conn.buf) < 8:
                    break
                need = _LEN.unpack_from(conn.buf)[0]
                if need > cfg.max_frame_bytes:
                    log.warning(
                        "%s: peer %s declared a %d-byte frame (cap %d) — "
                        "evicting (protocol)", group.name,
                        self._peer(conn), need, cfg.max_frame_bytes)
                    self._evict(conn, "protocol")
                    return
                conn.need = need
            if len(conn.buf) < 8 + conn.need:
                break
            if not conn.outbound and backend._reactor_pressure():
                # outbound (dial-out) conns carry only reliability
                # acks, consumed before the sink — pausing them under
                # pool pressure buys no backpressure and only triggers
                # resend storms (like _rate_account, they are exempt)
                if at_eof:
                    # the peer is GONE and the pool is full: delivering
                    # would block the loop in the sink's semaphore —
                    # shed the parked frames instead, each one counted
                    # (the dropped-frames counter, the shutdown-drain
                    # precedent); an enveloped sender that reconnects
                    # resends them unacked
                    self._shed_parked(conn)
                    return
                # backpressure propagates as
                # read-interest suspension — the frame stays parked in
                # the buffer, the kernel buffer fills, TCP flow control
                # reaches the sender; the LOOP keeps serving everyone
                # else.  Housekeeping resumes the read when the decode
                # pool frees up.
                if not conn.paused_pressure:
                    conn.paused_pressure = True
                    self._pressure_paused[conn.fd] = None
                    group._note_pressure(True)
                    self._set_interest(conn)
                    if not self._ready_hook_installed:
                        # event-driven resume: the consumer pings us the
                        # moment capacity frees, so paused reads resume
                        # within one loop wakeup — the housekeeping scan
                        # is only the fallback
                        self._ready_hook_installed = True
                        backend.add_ingest_ready_hook(
                            self._ingest_ready_ping)
                return
            need = conn.need
            payload = bytes(memoryview(conn.buf)[8:8 + need])
            del conn.buf[:8 + need]
            conn.need = None
            now = time.monotonic()
            conn.last_frame = now
            conn.last_progress = now
            # no in-band reply on OUTBOUND conns: they are blocking
            # sockets whose write side belongs to the sender threads —
            # an ack enqueued from the loop could block in send() on a
            # peer that never reads (and protocol-conformant peers only
            # ever send acks down our dial-outs, which need no reply);
            # backends whose peers cannot read in-band replies at all
            # (native fh_*) opt out wholesale via reactor_inband_reply
            reply = (self._make_reply(conn)
                     if not conn.outbound
                     and getattr(backend, "reactor_inband_reply", True)
                     else None)
            backend._obs_received(len(payload))
            if not conn.outbound:
                # rate ceiling: the already-reassembled frame still
                # delivers (we have it), but a violating conn throttles
                # (reads suspend until the window rolls) or — on repeat
                # violation — evicts before its next frame
                self._rate_account(conn, now, len(payload))
            try:
                backend._deliver_frame(payload, reply=reply)
            except Exception:
                backend._m_recv_deaths.inc()
                log.exception("%s: frame delivery died (%d bytes)",
                              group.name, len(payload))
                self._evict(conn, "error")
                return

    def _shed_parked(self, conn: _Conn) -> None:
        """Count-and-discard the complete frames parked in a dead
        conn's buffer (EOF under pool pressure)."""
        backend = self.group.backend
        while len(conn.buf) >= 8:
            need = conn.need if conn.need is not None \
                else _LEN.unpack_from(conn.buf)[0]
            if len(conn.buf) < 8 + need:
                break
            del conn.buf[:8 + need]
            conn.need = None
            backend._m_dropped.inc()
        conn.buf.clear()

    def _rate_account(self, conn: _Conn, now: float, nbytes: int) -> bool:
        """Per-connection byte/frame rate ceilings over 1 s windows.
        Returns True when the conn was throttled or evicted."""
        cfg = self.group.cfg
        if cfg.max_bytes_per_sec is None and cfg.max_frames_per_sec is None:
            return False
        if now - conn.win_start >= 1.0:
            if not conn.win_flagged and conn.violations > 0:
                conn.violations -= 1      # a clean window earns one back
            conn.win_start = now
            conn.win_bytes = 0
            conn.win_frames = 0
            conn.win_flagged = False
        conn.win_bytes += nbytes
        conn.win_frames += 1
        over = ((cfg.max_bytes_per_sec is not None
                 and conn.win_bytes > cfg.max_bytes_per_sec)
                or (cfg.max_frames_per_sec is not None
                    and conn.win_frames > cfg.max_frames_per_sec))
        if not over:
            return False
        if not conn.win_flagged:
            # one violation per WINDOW, not per frame — a coalesced
            # recv batch must not burn the whole violation budget in
            # one parse pass (the documented ladder is throttle first,
            # evict after rate_violation_limit consecutive bad windows)
            conn.win_flagged = True
            conn.violations += 1
        if conn.violations >= cfg.rate_violation_limit:
            self._evict(conn, "rate")
            return True
        # throttle: no reads until the current window rolls over
        conn.rate_pause_until = conn.win_start + 1.0
        self._set_interest(conn)
        return True

    # -- write path ----------------------------------------------------------
    def _make_reply(self, conn: _Conn) -> Callable[[bytes], None]:
        """The transport's reverse channel for this connection: acks and
        nacks ride back length-prefixed over the same socket the data
        arrived on (reliability.py's reply contract)."""
        def reply(wire: bytes) -> None:
            self.send(conn, _LEN.pack(len(wire)) + bytes(wire))
        return reply

    def _enqueue(self, conn: _Conn, data: bytes) -> None:
        if conn.closed:
            return
        if conn.outbound:
            # a blocking dial-out socket cannot be written from the
            # loop (send() could block it forever); no reply callable
            # is handed out for these, so this is a programming error
            log.warning("reactor write to an outbound conn dropped "
                        "(fd=%d) — dial-out writes belong to the "
                        "sender threads", conn.fd)
            return
        if conn.out_bytes + len(data) > self.group.cfg.write_buffer:
            # a peer that will not read what we send is the write-side
            # slowloris; its pending bytes are bounded by eviction, not
            # by the heap
            log.warning("%s: write buffer overflow (%d pending) for %s — "
                        "evicting slow reader", self.group.name,
                        conn.out_bytes, self._peer(conn))
            self._evict(conn, "stall")
            return
        conn.out.append(memoryview(bytes(data)))
        conn.out_bytes += len(data)
        self._on_writable(conn)

    def _on_writable(self, conn: _Conn) -> None:
        if conn.closed:
            return
        try:
            while conn.out:
                mv = conn.out[0]
                n = conn.sock.send(mv)
                conn.out_bytes -= n
                conn.last_write_progress = time.monotonic()
                if n < len(mv):
                    conn.out[0] = mv[n:]
                    break
                conn.out.popleft()
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self._close(conn)
            return
        self._set_interest(conn)

    # -- housekeeping: resume / evict / shed ---------------------------------
    def _housekeep(self, now: float) -> None:
        with obs.span("reactor.housekeep", idx=self.idx,
                      conns=len(self._conns)):
            self._housekeep_inner(now)

    def _housekeep_inner(self, now: float) -> None:
        group = self.group
        cfg = group.cfg
        if self._draining:
            done = all(not c.out for c in self._conns.values())
            if done or now >= self._drain_deadline:
                for conn in list(self._conns.values()):
                    group._m_drained.inc()
                    self._close(conn)
                self._alive = False
            return
        if self._pressure_paused:
            self._resume_paused()          # fallback sweep
        for conn in list(self._conns.values()):
            if conn.rate_pause_until and now >= conn.rate_pause_until:
                conn.rate_pause_until = 0.0
                self._set_interest(conn)
            if conn.closed or conn.outbound:
                continue
            stalled_read = (conn.need is not None or len(conn.buf) > 0)
            if (cfg.stall_timeout_s is not None and stalled_read
                    and not conn.paused_pressure
                    and now - conn.last_progress > cfg.stall_timeout_s):
                # slowloris: a header or partial frame is pending and
                # the peer has fed us nothing for the whole deadline
                self._evict(conn, "stall")
                continue
            if (cfg.stall_timeout_s is not None and conn.out
                    and now - conn.last_write_progress
                    > cfg.stall_timeout_s):
                self._evict(conn, "stall")
                continue
            if (cfg.idle_timeout_s is not None
                    and now - max(conn.last_frame, conn.created)
                    > cfg.idle_timeout_s):
                # distinct reason: opt-in idle reaping must not pollute
                # the slowloris (mid-frame stall) signal in an incident
                self._evict(conn, "idle")
        if group._overloaded(now):
            self._shed(now)
        if self.idx == 0:
            group._maybe_resume_listener(now)

    def _ingest_ready_ping(self) -> None:
        """The consumer's capacity-freed wakeup.  Fires on EVERY decode-
        task completion once installed, so the empty-paused fast path
        must cost one attribute read — no lock, no wake syscall —
        or the hook would tax the whole steady-state hot path forever
        after one transient pressure episode."""
        if self._pressure_paused and self._alive:
            self.call_soon(self._resume_paused)

    def _resume_paused(self) -> None:
        """Resume every pressure-paused conn while capacity holds —
        parse order round-robins so one chatty peer cannot starve the
        rest of the paused set."""
        if not self._pressure_paused or self._draining:
            return
        if self.group.backend._reactor_pressure():
            return                    # still full; the next ready ping
            #                           (or housekeeping) retries
        self.group._note_pressure(False)
        for fd in list(self._pressure_paused):
            conn = self._conns.get(fd)
            self._pressure_paused.pop(fd, None)
            if conn is None or conn.closed:
                continue
            conn.paused_pressure = False
            self._set_interest(conn)
            self._parse(conn)         # frames parked in the buffer
            # re-evaluate interest AFTER the parse drained the buffer:
            # a parked frame larger than read_buffer failed the read-
            # mask bound before the drain, and leaving READ off would
            # starve a healthy peer into a bogus stall eviction
            self._set_interest(conn)
            if conn.paused_pressure:
                break                 # refilled mid-sweep; rest stay paused

    def _shed(self, now: float) -> None:
        """Shed the lowest-priority uplinks: staleness-ranked — the
        inbound conns whose last completed frame is OLDEST (their
        uplinks are the stalest) go first."""
        ranked = sorted(
            (c for c in self._conns.values()
             if not c.outbound and not c.closed),
            key=lambda c: c.last_frame)
        for conn in ranked[:self.group.cfg.shed_batch]:
            self.group._m_shed.inc()
            self._evict(conn, "shed")

    # -- teardown ------------------------------------------------------------
    def begin_drain(self, deadline: float) -> None:
        def _start():
            self._draining = True
            self._drain_deadline = deadline
            for conn in list(self._conns.values()):
                # stop reading; keep write interest so pending acks
                # flush inside the drain budget
                conn.paused_pressure = True
                self._set_interest(conn)
        self.call_soon(_start)

    def stop(self) -> None:
        self._alive = False
        try:
            self._wake_w.send(b"\0")
        except OSError:
            pass

    def join(self, timeout: float) -> None:
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)

    def _teardown(self) -> None:
        for conn in list(self._conns.values()):
            self._close(conn)
        for s in (self._wake_r, self._wake_w):
            self._safe_close(s)
        try:
            self._sel.close()
        except OSError:
            pass

    def force_close(self) -> None:
        """Last-resort close from the shutting-down thread when the
        loop failed to exit: a leaked fd is worse than a racy close."""
        for conn in list(self._conns.values()):
            self._safe_close(conn.sock)
        self._conns.clear()

    # -- close helpers -------------------------------------------------------
    def _evict(self, conn: _Conn, reason: str) -> None:
        if conn.closed:
            return
        self.group._m_evicted(reason).inc()
        obs.instant("reactor.evict", reason=reason, fd=conn.fd,
                    outbound=conn.outbound)
        self._close(conn)

    def _close(self, conn: _Conn) -> None:
        if conn.closed:
            return
        conn.closed = True
        self._conns.pop(conn.fd, None)
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        self._safe_close(conn.sock)
        self.group._note_close(conn)

    @staticmethod
    def _safe_close(sock: socket.socket) -> None:
        try:
            sock.close()
        except OSError:
            pass

    @staticmethod
    def _peer(conn: _Conn) -> str:
        try:
            return str(conn.sock.getpeername())
        except OSError:
            return f"fd={conn.fd}"


class ReactorGroup:
    """N reactors + one listening socket (registered on reactor 0) for
    one backend.  Owns the admission gate, the shed decision, and the
    connection counters; the backend owns the protocol."""

    def __init__(self, backend, bind_addr: Optional[tuple[str, int]],
                 cfg: Optional[ReactorConfig] = None, name: str = "tcp"):
        self.backend = backend
        self.cfg = cfg if cfg is not None else ReactorConfig()
        self.name = name
        self._lock = threading.Lock()
        self._open_inbound = 0
        self.peak_connections = 0
        self._pressure_since: Optional[float] = None
        self._rss_checked = 0.0
        self._rss_over = False
        self._overload_gate: Optional[Callable[[], bool]] = None
        # per-reason door-shed ledger: ceiling / external gate /
        # sustained ingest pressure / RSS watermark.  The fused-cluster
        # report reads this to attribute sheds to LANE pressure (the
        # registry-fed gate) vs the transport's own watermarks.
        self.shed_reasons = {"ceiling": 0, "gate": 0, "pressure": 0,
                             "rss": 0}
        self._listener_paused_until = 0.0
        self._listener_registered = False
        b = backend.backend_name
        # rank label: a set() gauge shared by several in-process groups
        # (server + dial-back clients in one test/torture process)
        # would flap last-writer-wins without it
        self._m_open = obs.gauge("comm_open_connections", backend=b,
                                 rank=str(getattr(backend, "rank", 0)))
        self._m_shed = obs.counter("comm_uplinks_shed_total", backend=b)
        self._m_drained = obs.counter("comm_connections_drained_total",
                                      backend=b)
        self._m_fd_exhausted = obs.counter(
            "comm_accept_fd_exhausted_total", backend=b)
        self._m_loop_lag = obs.histogram(
            "reactor_loop_lag_seconds",
            buckets=obs.metrics.DECODE_SECONDS_BUCKETS, backend=b)
        self._evict_counters: dict[str, obs.Counter] = {}
        self.listener: Optional[socket.socket] = None
        if bind_addr is not None:
            # bind synchronously so a busy port raises from the
            # constructor exactly like the thread transport did
            ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                ls.bind(bind_addr)
                ls.listen(1024)
            except OSError:
                ls.close()
                raise
            ls.setblocking(False)
            self.listener = ls
        self.reactors = [Reactor(self, i)
                         for i in range(self.cfg.reactors)]
        self._rr = itertools.cycle(self.reactors)

    def _m_evicted(self, reason: str):
        c = self._evict_counters.get(reason)
        if c is None:
            c = obs.counter("comm_connections_evicted_total",
                            backend=self.backend.backend_name,
                            reason=reason)
            self._evict_counters[reason] = c
        return c

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        for r in self.reactors:
            r._thread.start()
        if self.listener is not None:
            r0 = self.reactors[0]
            r0.call_soon(self._register_listener)

    def _register_listener(self) -> None:
        if self.listener is None:
            return
        try:
            self.reactors[0]._sel.register(
                self.listener, selectors.EVENT_READ, ("listener", None))
            self._listener_registered = True
        except (ValueError, KeyError, OSError):
            pass

    def _unregister_listener(self) -> None:
        if self.listener is None or not self._listener_registered:
            return
        try:
            self.reactors[0]._sel.unregister(self.listener)
        except (KeyError, ValueError, OSError):
            pass
        self._listener_registered = False

    def adopt_outbound(self, sock: socket.socket) -> None:
        """Register a dial-out connection for reads (acks/nacks from
        the peer ride back over it) — replaces the thread transport's
        per-connection reader thread.  The socket stays BLOCKING: the
        sender threads' sendall path owns writes; the reactor only ever
        recv()s after the selector said readable."""
        next(self._rr).adopt(sock, outbound=True)

    def forget(self, sock: socket.socket) -> None:
        for r in self.reactors:
            r.forget(sock)

    def close(self) -> None:
        """Graceful drain, then teardown: stop accepting, give pending
        writes `drain_s` to flush, close every socket, stop the loops.
        After this returns no reactor-owned fd is open (the churn
        test's audit)."""
        with obs.span("reactor.drain", backend=self.backend.backend_name,
                      open=self._open_inbound):
            if self.listener is not None:
                self.reactors[0].call_soon(self._unregister_listener)
            deadline = time.monotonic() + self.cfg.drain_s
            for r in self.reactors:
                r.begin_drain(deadline)
            for r in self.reactors:
                r.join(timeout=self.cfg.drain_s + 2.0)
            for r in self.reactors:
                if r._thread.is_alive():
                    r.stop()
            for r in self.reactors:
                r.join(timeout=2.0)
            for r in self.reactors:
                if r._thread.is_alive():
                    log.warning("reactor-%s-%d did not exit; force-closing "
                                "its sockets", self.name, r.idx)
                    r.force_close()
            if self.listener is not None:
                try:
                    self.listener.close()
                except OSError:
                    pass
                self.listener = None

    # -- accept + admission --------------------------------------------------
    def _on_accept(self, reactor: Reactor) -> None:
        now = time.monotonic()
        while True:
            try:
                s, _addr = self.listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError as e:
                if self.listener is None:
                    return
                exh = accept_exhaustion(e)
                if exh is not None:
                    # NAMED error with the
                    # current ulimit, listener survives with a backoff
                    # instead of the accept loop dying on a bare OSError
                    self._m_fd_exhausted.inc()
                    log.error("%s: %s", self.name, exh)
                    obs.instant("reactor.fd_exhausted",
                                backend=self.backend.backend_name)
                    self._listener_paused_until = now + 0.5
                    self._unregister_listener()
                    return
                log.warning("%s: accept failed: %s", self.name, e)
                return
            why = ("ceiling"
                   if self._open_inbound >= self.cfg.max_connections
                   else self._overload_reason(now))
            if why is not None:
                # load shedding at the door: reject before the conn
                # costs a registration — counted + attributed, never
                # silent
                self._m_shed.inc()
                self.shed_reasons[why] += 1
                obs.instant("reactor.shed_accept",
                            open=self._open_inbound, reason=why)
                Reactor._safe_close(s)
                continue
            try:
                s.setblocking(False)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                Reactor._safe_close(s)
                continue
            # admission accounting happens HERE, not at the (deferred)
            # registration on the target loop — a storm draining the
            # whole listen backlog in one pass must see an up-to-date
            # count, or the ceiling overshoots by the backlog depth
            self._note_inbound_open()
            next(self._rr).adopt(s, outbound=False)

    def _maybe_resume_listener(self, now: float) -> None:
        if (self.listener is not None and not self._listener_registered
                and now >= self._listener_paused_until
                and not self.reactors[0]._draining):
            self._register_listener()

    # -- overload decision ---------------------------------------------------
    def set_overload_gate(self, fn: Optional[Callable[[], bool]]) -> None:
        """External shed signal (the serving layer's watermark —
        decode-pool depth, commit backlog, anything): while it returns
        True, new connections are rejected and the stalest uplinks are
        shed batch by batch."""
        self._overload_gate = fn

    def _note_pressure(self, pressing: bool) -> None:
        if not self.cfg.shed_on_pressure:
            return
        with self._lock:
            if pressing and self._pressure_since is None:
                self._pressure_since = time.monotonic()
            elif not pressing:
                self._pressure_since = None

    def _overloaded(self, now: float) -> bool:
        return self._overload_reason(now) is not None

    def _overload_reason(self, now: float) -> Optional[str]:
        """Which watermark (if any) says shed: "gate" (the external
        serving-layer signal — lane/registry pressure), "pressure"
        (sustained ingest-pool backpressure), or "rss"."""
        gate = self._overload_gate
        if gate is not None:
            try:
                if gate():
                    return "gate"
            except Exception:
                log.exception("%s: overload gate failed", self.name)
        if self.cfg.shed_on_pressure:
            with self._lock:
                since = self._pressure_since
            if since is not None and now - since >= self.cfg.shed_after_s:
                return "pressure"
        if self.cfg.rss_limit_bytes is not None:
            if now - self._rss_checked > 0.5:
                from fedml_tpu_torch.scale.serve import rss_bytes
                self._rss_checked = now
                self._rss_over = rss_bytes() > self.cfg.rss_limit_bytes
            if self._rss_over:
                return "rss"
        return None

    # -- connection accounting -----------------------------------------------
    def _note_inbound_open(self) -> None:
        with self._lock:
            self._open_inbound += 1
            if self._open_inbound > self.peak_connections:
                self.peak_connections = self._open_inbound
            self._m_open.set(self._open_inbound)

    def _note_inbound_closed(self) -> None:
        with self._lock:
            self._open_inbound = max(0, self._open_inbound - 1)
            self._m_open.set(self._open_inbound)

    def _note_close(self, conn: _Conn) -> None:
        if conn.outbound:
            cb = getattr(self.backend, "_on_outbound_closed", None)
            if cb is not None:
                try:
                    cb(conn.sock)
                except Exception:
                    pass
            return
        self._note_inbound_closed()

    @property
    def open_connections(self) -> int:
        with self._lock:
            return self._open_inbound
