"""NativeTcpBackend — the C++ transport behind the comm interface.

Same wire format and constructor as the pure-Python TcpBackend (its
behavioral spec): 8-byte LE length ‖ MessageCodec frame.  Socket accept,
framing, and the inbound queue live in native threads
(fedml_tpu_torch/native/fedml_host.cpp); Python only decodes Messages — so the
GIL never gates frame reassembly, the reference's known chokepoint (its
comm daemons are Python threads, mpi_receive_thread.py:19-28).

Falls back is the caller's job: `native_available()` says whether the
library loaded; managers select backend "NATIVE_TCP" explicitly or "TCP"
picks native automatically when present.

Reactor receive path: `reactor=True` rewires this backend's
INBOUND side onto the shared selector reactor (comm/reactor.py) — same
wire format, but with the overload-safety machinery (bounded buffers,
stall/rate eviction, load shedding, graceful drain, read-suspension
backpressure) the native drain loop cannot provide.  Outbound sends
keep the native fh_connect/fh_send fast path either way.  Default is
the native drain loop (its no-GIL frame reassembly is the point of
this backend); deployments that need overload safety over raw C++
throughput opt in per instance or via FEDML_TCP_REACTOR.
"""
from __future__ import annotations

import ctypes
import logging
import threading
import time
from typing import Optional, Union

from fedml_tpu_torch.comm.base import BaseCommManager
from fedml_tpu_torch.comm.message import Message, MessageCodec
from fedml_tpu_torch.comm.reactor import ReactorConfig, ReactorGroup
from fedml_tpu_torch.comm.reliability import BackoffPolicy
from fedml_tpu_torch.native import load_library

log = logging.getLogger(__name__)

# launch-race connect retry — the shared backoff schedule,
# bounded by the caller's retry_for deadline
_CONNECT_BACKOFF = BackoffPolicy(base_s=0.2, mult=1.5, max_s=2.0,
                                 jitter=0.2, max_attempts=1_000_000)


def native_available() -> bool:
    return load_library() is not None


class NativeTcpBackend(BaseCommManager):
    backend_name = "native_tcp"
    # fh_* peers never read their dial-out sockets (the API has no
    # in-band reply channel) — a reactor inbound path must route
    # acks/nacks through _raw_send (dial the peer's own listener), NOT
    # back over the accepted socket where they'd rot unread and every
    # enveloped frame would resend to abandonment
    reactor_inband_reply = False

    def __init__(self, rank: int, ip_config: Union[str, dict],
                 base_port: int = 52000, reactor: bool = False,
                 reactor_config: Optional[ReactorConfig] = None):
        super().__init__()
        from fedml_tpu_torch.comm.grpc_backend import load_ip_config
        self._lib = load_library()
        if self._lib is None:
            raise RuntimeError("native transport unavailable (no g++?)")
        self.rank = rank
        self.ip_config = load_ip_config(ip_config)
        self.base_port = base_port
        self._conns: dict[int, int] = {}
        self._conn_lock = threading.Lock()
        self._alive = True
        from fedml_tpu_torch.comm.reactor import reactor_default
        # FEDML_TCP_REACTOR=0 is PROCESS-WIDE (same hatch TcpBackend
        # honors): it pins the native drain loop even when a caller
        # asked for the reactor inbound path
        self.reactor_mode = bool(reactor) and reactor_default()
        self._rg: Optional[ReactorGroup] = None
        self._server = None
        self._drain = None
        if self.reactor_mode:
            # inbound over the Python reactor (overload safety:
            # eviction deadlines, rate ceilings, shed gate, drain);
            # outbound stays native fh_send.  Same 8-byte-LE-length
            # wire, so native and reactor peers interoperate.
            self._rg = ReactorGroup(
                self, ("0.0.0.0", base_port + rank), reactor_config,
                name=f"native-{rank}")
            self._rg.start()
            return
        self._server = self._lib.fh_server_create(base_port + rank)
        if not self._server:
            raise OSError(f"cannot listen on port {base_port + rank}")
        self._drain = threading.Thread(target=self._drain_loop, daemon=True)
        self._drain.start()

    def _drain_loop(self) -> None:
        buf = ctypes.POINTER(ctypes.c_ubyte)()
        length = ctypes.c_long()
        while self._alive:
            rc = self._lib.fh_recv(self._server, ctypes.byref(buf),
                                   ctypes.byref(length), 200)
            if rc == -2:          # server closed
                return
            if rc != 0:           # timeout — re-check aliveness
                continue
            try:
                payload = ctypes.string_at(buf, length.value)
            finally:
                self._lib.fh_buf_free(buf)
            self._obs_received(len(payload))
            try:
                # inline decode or the async ingest sink (comm/base.py)
                self._deliver_frame(payload)
            except Exception:     # malformed frame: drop, keep serving
                # _deliver_frame quarantines codec errors itself now;
                # anything that still lands here is an unexpected
                # delivery-path failure — counted like a thread death
                # would be (the loop survives, the signal must not hide)
                self._m_recv_deaths.inc()
                log.exception("undecodable frame (%d bytes)", length.value)

    def _connect_locked(self, receiver: int, retry_for: float = 30.0):
        c = self._conns.get(receiver)
        if c is None:
            host = self.ip_config[receiver].encode()
            # ride out the multi-process startup race (peer's listener not
            # bound yet).  This holds _conn_lock while retrying — acceptable
            # because this transport serializes sends by design (see
            # send_message) and the race only exists at launch.
            deadline = time.monotonic() + retry_for
            attempt = 0
            while True:
                c = self._lib.fh_connect(host, self.base_port + receiver)
                if c:
                    break
                if time.monotonic() >= deadline:
                    raise ConnectionError(
                        f"cannot reach rank {receiver} at "
                        f"{self.ip_config[receiver]}:"
                        f"{self.base_port + receiver}")
                self._obs_retry()
                attempt += 1
                time.sleep(_CONNECT_BACKOFF.delay(attempt))
            self._conns[receiver] = c
        return c

    def _send_wire_locked_retry(self, rx: int, payload: bytes) -> None:
        """connect + fh_send with the one-shot stale-handle retry, all
        under _conn_lock (see send_message)."""
        with self._conn_lock:
            conn = self._connect_locked(rx)
            if self._lib.fh_send(conn, payload, len(payload)) != 0:
                self._obs_retry()
                stale = self._conns.pop(rx, None)
                if stale is not None:
                    self._lib.fh_conn_close(stale)
                conn = self._connect_locked(rx)
                if self._lib.fh_send(conn, payload, len(payload)) != 0:
                    raise ConnectionError(f"send to rank {rx} failed")

    def _raw_send(self, receiver: int, wire: bytes) -> None:
        """Reliability transmit primitive: every native peer listens, so
        acks/resends dial the peer's own server (there is no in-band
        reply channel in the fh_* API)."""
        self._send_wire_locked_retry(receiver, bytes(wire))

    def send_message(self, msg: Message) -> None:
        # encode applies the v2 wire features (transport dtypes, zlib
        # head); fh_send frames one contiguous buffer, so the chunked
        # send stays a pure-Python-TCP feature
        if not self._stamp_frame(msg):
            return                  # chaos send gate dropped the frame
        payload = MessageCodec.encode(msg)
        rx = msg.get_receiver_id()
        if self._reliable_tx:
            wire = self._reliability_endpoint().send(rx, payload)
            self._obs_sent(len(wire))
            return
        # the whole connect+send (and the dead-connection retry) runs under
        # _conn_lock, like the pure-Python spec's sendall — so a failing
        # sender can never fh_conn_close a handle another thread is using
        self._send_wire_locked_retry(rx, payload)
        self._obs_sent(len(payload))

    def close(self) -> None:
        if not self._alive:
            return
        self._alive = False
        if self.reactor_mode:
            self._rg.close()        # drain + close every inbound socket
            with self._conn_lock:
                for c in self._conns.values():
                    self._lib.fh_conn_close(c)
                self._conns.clear()
            return
        with self._conn_lock:
            for c in self._conns.values():
                self._lib.fh_conn_close(c)
            self._conns.clear()
        # the drain thread may be inside fh_recv on the Server's condvar —
        # it must exit (≤200 ms timeout tick) BEFORE fh_server_close deletes
        # the Server, or the wait is a use-after-free.  If it hasn't exited
        # (e.g. an _on_message observer callback is wedged) the Server is
        # deliberately leaked: a leak is recoverable, a freed condvar under
        # a waiting thread is not.
        self._drain.join(timeout=5)
        if self._drain.is_alive():
            log.warning("drain thread still running after 5s; leaking "
                        "native server to avoid use-after-free")
            return
        self._lib.fh_server_close(self._server)
        self._server = None
