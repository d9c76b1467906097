"""TCP comm backend — length-prefixed MessageCodec frames over raw sockets.

The lean transport for trusted intra-cluster control traffic (the reference
covers this niche with Torch-RPC/TensorPipe, trpc_comm_manager.py:26-144 —
tensor-native, no JSON).  Frame format: 8-byte little-endian length ‖
MessageCodec bytes.

Two receive transports, one wire format:

* **reactor** (default): a `selectors` event loop per core
  (comm/reactor.py) owns non-blocking accepted sockets with bounded
  buffers, incremental frame reassembly, stall/rate eviction, load
  shedding, and graceful drain — the overload-safe path that holds 10k
  live connections.  Backpressure from the decode pool reaches the
  peer as read-interest suspension, never as a blocked loop thread.
* **threads** (`reactor=False`, or FEDML_TCP_REACTOR=0 process-wide):
  the original one-recv-thread-per-connection path — kept as the
  behavioral spec, the bitwise anchor (a reactor run commits the same
  accumulator, pinned in tests/test_reactor.py), and the ingest
  torture's faithful legacy A/B arm.

When the native C++ transport (fedml_tpu_torch/native/) is built, `TcpBackend`
transparently uses it for the socket loop; this pure-Python path is the
fallback and the behavioral spec.

Reliability: with `enable_reliability()` the frame rides the
FMLR envelope and acks flow back over the SAME connection the data
arrived on (both transports hand `_deliver_frame` a reply callable) —
so a client that only dials out still gets its acks; outbound
connections are registered with the reactor for reads (thread mode
spawns a reader) so dial-out acks for OUR enveloped sends are seen too.
Resends reuse `_raw_send`, which invalidates the cached connection on
failure and redials — a server restart (the crash-resume scenario) is
survived by the backoff schedule, not by the caller.
"""
from __future__ import annotations

import logging
import socket
import struct
import threading
import time
from typing import Optional, Union

from fedml_tpu_torch.comm.base import BaseCommManager
from fedml_tpu_torch.comm.message import Message, MessageCodec
from fedml_tpu_torch.comm.reactor import (ReactorConfig, ReactorGroup,
                                    accept_exhaustion, reactor_default)
from fedml_tpu_torch.comm.reliability import BackoffPolicy

log = logging.getLogger(__name__)

# THE connect-retry schedule (replaces the ad-hoc 0.2 s sleep loop):
# effectively unbounded attempts — the caller's retry_for deadline is
# the bound, the policy only shapes the delays
_CONNECT_BACKOFF = BackoffPolicy(base_s=0.2, mult=1.5, max_s=2.0,
                                 jitter=0.2, max_attempts=1_000_000)


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


class TcpBackend(BaseCommManager):
    backend_name = "tcp"

    def __init__(self, rank: int, ip_config: Union[str, dict],
                 base_port: int = 52000,
                 reactor: Optional[bool] = None,
                 reactor_config: Optional[ReactorConfig] = None):
        super().__init__()
        from fedml_tpu_torch.comm.grpc_backend import load_ip_config
        self.rank = rank
        self.ip_config = load_ip_config(ip_config)
        self.base_port = base_port
        self._conns: dict[int, socket.socket] = {}
        self._conn_lock = threading.Lock()
        # accepted (inbound) connections (thread mode), closed on
        # close(): leaving them established would hold the listen port
        # hostage against a same-port restart — the crash-resume rebind
        # — and leave peers talking into a half-dead socket
        self._accepted: set[socket.socket] = set()
        self._alive = True
        # FEDML_TCP_REACTOR=0 overrides everything (the escape hatch);
        # an explicit reactor= argument overrides the default
        if not reactor_default():
            reactor = False
        elif reactor is None:
            reactor = True
        self.reactor_mode = bool(reactor)
        self._rg: Optional[ReactorGroup] = None
        self._listener: Optional[socket.socket] = None
        if self.reactor_mode:
            # the group binds synchronously, so a busy port raises from
            # the constructor exactly like the thread transport
            self._rg = ReactorGroup(
                self, ("0.0.0.0", base_port + rank), reactor_config,
                name=f"tcp-{rank}")
            self._rg.start()
            return
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("0.0.0.0", base_port + rank))
        self._listener.listen(64)
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while self._alive:
            try:
                conn, _ = self._listener.accept()
            except OSError as e:
                exh = accept_exhaustion(e)
                if exh is not None and self._alive:
                    # fd exhaustion is a NAMED
                    # error with the current ulimit, and the listener
                    # SURVIVES with a backoff — a bare OSError used to
                    # end this loop and silently stop accepting forever
                    log.error("tcp rank %d: %s", self.rank, exh)
                    time.sleep(0.5)
                    continue
                return
            with self._conn_lock:
                self._accepted.add(conn)
            threading.Thread(target=self._recv_loop, args=(conn,),
                             daemon=True).start()

    def _recv_loop(self, conn: socket.socket) -> None:
        # reply channel: acks/nacks ride back over the connection the
        # frame came in on — the only route to a peer that never
        # listens (the torture spam clients)
        wlock = threading.Lock()

        def reply(wire: bytes) -> None:
            with wlock:
                conn.sendall(struct.pack("<Q", len(wire)))
                conn.sendall(wire)

        try:
            while self._alive:
                (length,) = struct.unpack("<Q", _read_exact(conn, 8))
                payload = _read_exact(conn, length)
                self._obs_received(len(payload))
                # _deliver_frame: inline decode, or hand the raw frame
                # to an installed ingest sink (async decode pool) — a
                # blocked sink stalls this loop and TCP flow control
                # backpressures the sender
                self._deliver_frame(payload, reply=reply)
        except (ConnectionError, OSError):
            conn.close()
        except Exception:
            # the chaos acceptance gate: NOTHING that escapes the
            # delivery path may silently kill a recv thread — count it
            # so "zero recv-thread deaths" is assertable
            self._m_recv_deaths.inc()
            log.exception("tcp recv loop died on an unexpected error")
            conn.close()
        finally:
            with self._conn_lock:
                self._accepted.discard(conn)

    def _on_outbound_closed(self, sock: socket.socket) -> None:
        """Reactor callback: a dial-out connection it owned for reads
        died/was drained — drop the cached handle so the next send
        redials instead of writing into a closed socket."""
        with self._conn_lock:
            for rx, s in list(self._conns.items()):
                if s is sock:
                    self._conns.pop(rx, None)

    def _connect(self, receiver: int, retry_for: float = 60.0) -> socket.socket:
        with self._conn_lock:
            s = self._conns.get(receiver)
        if s is not None:
            return s
        # multi-process launches race: the peer's listener may not be bound
        # yet (run_fedavg_grpc.sh starts all ranks at once), so refused
        # connections retry on the shared backoff schedule — OUTSIDE the
        # lock, so one slow peer cannot stall sends to the others (or
        # close())
        deadline = time.monotonic() + retry_for
        attempt = 0
        while True:
            try:
                s = socket.create_connection(
                    (self.ip_config[receiver], self.base_port + receiver),
                    timeout=30)
                break
            except (ConnectionRefusedError, ConnectionResetError,
                    TimeoutError):
                # transient launch/restart races only — a gaierror
                # (typo'd host) must fail fast, not burn the deadline
                if time.monotonic() >= deadline:
                    raise
                self._obs_retry()
                attempt += 1
                time.sleep(_CONNECT_BACKOFF.delay(attempt))
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with self._conn_lock:
            racer = self._conns.get(receiver)
            if racer is not None:           # lost a concurrent connect race
                s.close()
                return racer
            self._conns[receiver] = s
        if self.reactor_mode:
            # the reactor owns reads on dial-out conns (acks from an
            # enveloping peer); the socket stays blocking — sender
            # threads own the write side via sendall under _conn_lock
            self._rg.adopt_outbound(s)
        elif self._reliable_tx:
            # dial-out connections need a reader: the peer's acks for
            # our enveloped frames come back over this socket
            threading.Thread(target=self._recv_loop, args=(s,),
                             daemon=True).start()
        return s

    def _raw_send(self, receiver: int, wire: bytes) -> None:
        """Raw framed write (reliability resends + acks).  A transport
        failure invalidates the cached connection — the NEXT attempt
        redials, which is how a restarted peer (crash-resume) is
        rejoined — and re-raises for the resend scheduler."""
        sock = self._connect(receiver, retry_for=5.0)
        try:
            with self._conn_lock:
                sock.sendall(struct.pack("<Q", len(wire)))
                sock.sendall(wire)
        except OSError:
            with self._conn_lock:
                if self._conns.get(receiver) is sock:
                    self._conns.pop(receiver, None)
            if self._rg is not None:
                self._rg.forget(sock)   # BEFORE close: fileno still valid
            try:
                sock.close()
            except OSError:
                pass
            raise

    def _chaos_disconnect(self, msg: Message) -> bool:
        """Disconnect-mid-frame fault: send the length prefix plus HALF
        the frame, then hard-close the connection.  The receiver's
        reassembly path sees the torn frame end in EOF, drops the
        partial, and closes that conn only; the next real send redials
        — the torn-wire case the reliability resend exists for, so
        under the envelope the frame is registered first and
        recovers."""
        rx = msg.get_receiver_id()
        payload = MessageCodec.encode(msg)
        if self._reliable_tx:
            payload = self._reliability_endpoint().wrap(rx, payload)
        try:
            sock = self._connect(rx, retry_for=5.0)
            with self._conn_lock:
                sock.sendall(struct.pack("<Q", len(payload)))
                sock.sendall(payload[:max(1, len(payload) // 2)])
                self._conns.pop(rx, None)
            if self._rg is not None:
                self._rg.forget(sock)   # BEFORE close: fileno still valid
            sock.close()
        except OSError:
            pass                     # the fault IS a broken connection
        return True

    def send_message(self, msg: Message) -> None:
        # chunked streaming send: the codec hands back a frame prefix +
        # one part per array buffer, and each part goes to the socket
        # directly — a multi-GB model frame is never materialized as one
        # contiguous buffer (the old encode() + concat path transiently
        # held ~3x the payload: arrays + BytesIO + the length-prefixed
        # copy)
        if not self._stamp_frame(msg):
            return                   # chaos send gate dropped the frame
        rx = msg.get_receiver_id()
        if self._reliable_tx:
            # the envelope needs the whole frame (CRC + resend buffer),
            # so the reliable path joins the parts; first transmit +
            # retries live in the endpoint
            payload = MessageCodec.encode(msg)
            wire = self._reliability_endpoint().send(rx, payload)
            self._obs_sent(len(wire))
            return
        total, parts = MessageCodec.encode_parts(msg)
        sock = self._connect(rx)
        with self._conn_lock:
            sock.sendall(struct.pack("<Q", total))
            for part in parts:
                sock.sendall(part)
        self._obs_sent(total)

    def close(self) -> None:
        self._alive = False
        if self.reactor_mode:
            # graceful drain: the group stops accepting, flushes
            # pending writes inside its drain budget, and closes every
            # socket it owns (accepted AND adopted dial-outs) — the
            # listen port is free for a same-port restart when this
            # returns
            self._rg.close()
            with self._conn_lock:
                for s in self._conns.values():
                    try:
                        s.close()
                    except OSError:
                        pass
                self._conns.clear()
            return
        # shutdown BEFORE close: close() alone does not interrupt the
        # accept(2) the _accept_loop thread is blocked in, and the
        # in-flight syscall keeps the kernel socket alive and LISTENING
        # — which held the port hostage against a same-port restart
        # (the crash-resume rebind) even with the fd closed
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass                    # never listened / already dead
        self._listener.close()
        with self._conn_lock:
            for s in self._conns.values():
                s.close()
            self._conns.clear()
            for s in list(self._accepted):
                try:
                    s.close()       # releases the listen port for a
                except OSError:     # same-port restart (crash-resume)
                    pass
            self._accepted.clear()
