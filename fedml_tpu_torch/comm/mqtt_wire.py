"""Minimal MQTT 3.1.1 wire implementation: an in-repo broker and client
(port of fedml_tpu/comm/mqtt_wire.py, the same code: it never touched
JAX).

paho-mqtt and a broker daemon may be absent where the port runs (the
card's machine has neither), which would leave the MQTT backend's wire
behaviour untested.  This module closes that gap natively: a small
threaded broker and a paho-surface-compatible client speaking real MQTT
3.1.1 frames (CONNECT/CONNACK, PUBLISH QoS 0, SUBSCRIBE/SUBACK,
PINGREQ/PINGRESP, DISCONNECT) over TCP sockets.  A JAX-package peer and
a port peer can share one broker: the frames and the JSON payloads are
the same bytes.

Reference behaviour being mirrored: the reference talks to an external
broker through paho (mqtt_comm_manager.py:14-126); its topic scheme and
JSON payloads ride unchanged.  MqttBackend falls back to MiniMqttClient
when paho is missing, so the "MQTT" backend works on the wire with no
dependency, and against a real broker (mosquitto etc.) through paho
where paho is installed.

Scope: QoS 0, clean sessions, no retained messages or wills — the
subset the FL topic scheme uses.  Topic filters support '+' (one level)
and a trailing '#' (multi-level), per spec 4.7.
"""
from __future__ import annotations

import logging
import socket
import struct
import sys
import threading
from dataclasses import dataclass
from typing import Callable, Optional

from fedml_tpu_torch.comm.tcp_backend import _read_exact

log = logging.getLogger(__name__)

CONNECT, CONNACK, PUBLISH, SUBSCRIBE, SUBACK = 0x10, 0x20, 0x30, 0x82, 0x90
PINGREQ, PINGRESP, DISCONNECT = 0xC0, 0xD0, 0xE0


def _varint(n: int) -> bytes:
    """MQTT 'remaining length' encoding (spec 2.2.3)."""
    out = bytearray()
    while True:
        d, n = n % 128, n // 128
        out.append(d | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _read_frame(sock: socket.socket) -> tuple[int, bytes]:
    """Returns (fixed-header byte 1, payload)."""
    h = _read_exact(sock, 1)[0]
    mult, length = 1, 0
    for _ in range(4):
        d = _read_exact(sock, 1)[0]
        length += (d & 0x7F) * mult
        if not d & 0x80:
            break
        mult *= 128
    else:
        raise ConnectionError("malformed remaining length")
    return h, _read_exact(sock, length) if length else b""


def _mqtt_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">H", len(b)) + b


def _frame(header: int, payload: bytes) -> bytes:
    return bytes([header]) + _varint(len(payload)) + payload


def topic_matches(filt: str, topic: str) -> bool:
    """MQTT topic-filter matching (spec 4.7: '+' one level, '#' rest)."""
    fp, tp = filt.split("/"), topic.split("/")
    for i, f in enumerate(fp):
        if f == "#":
            return True
        if i >= len(tp) or (f != "+" and f != tp[i]):
            return False
    return len(fp) == len(tp)


@dataclass
class MqttMessage:
    """What the on_message callback receives (paho surface subset)."""
    topic: str
    payload: bytes


class MiniMqttBroker:
    """Threaded MQTT 3.1.1 broker (QoS 0, clean sessions)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socket.create_server((host, port))
        self.host, self.port = self._srv.getsockname()[:2]
        self._lock = threading.Lock()
        self._subs: dict[socket.socket, list[str]] = {}
        # per-connection write locks: _route (publisher threads) and the
        # connection's own _serve thread (SUBACK/PINGRESP) both write to
        # a subscriber socket — unserialized sendalls would interleave
        # frames and desync the stream
        self._wlocks: dict[socket.socket, threading.Lock] = {}
        self._running = True
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    # a stalled subscriber (full TCP buffer, process paused) must not
    # wedge the publisher's serve thread forever: sends time out and the
    # dead connection is dropped (its serve loop then cleans up)
    SEND_TIMEOUT_S = 30.0

    def _send(self, conn: socket.socket, data: bytes) -> None:
        wlock = self._wlocks.get(conn)
        if wlock is None:
            return                   # connection already torn down
        try:
            with wlock:
                conn.sendall(data)
        except (socket.timeout, OSError):
            log.warning("broker: dropping stalled/dead subscriber")
            try:
                # shutdown (not just close) so the connection's _serve
                # thread blocked in recv wakes up and runs its cleanup —
                # close() alone does not interrupt an in-flight recv
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            conn.close()

    def _serve(self, conn: socket.socket) -> None:
        try:
            h, _ = _read_frame(conn)
            if h & 0xF0 != CONNECT:
                return
            # send-direction timeout ONLY (SO_SNDTIMEO): reads stay
            # blocking — a settimeout() would fire mid-frame on recv.
            # The payload is a struct timeval on POSIX but a DWORD of
            # milliseconds on Windows.
            conn.setsockopt(
                socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                struct.pack("<L", int(self.SEND_TIMEOUT_S * 1000))
                if sys.platform == "win32"
                else struct.pack("ll", int(self.SEND_TIMEOUT_S), 0))
            with self._lock:
                self._subs[conn] = []
                self._wlocks[conn] = threading.Lock()
            self._send(conn, _frame(CONNACK, b"\x00\x00"))
            while True:
                h, body = _read_frame(conn)
                t = h & 0xF0
                if t == PUBLISH:
                    tl = struct.unpack(">H", body[:2])[0]
                    topic = body[2:2 + tl].decode()
                    payload = body[2 + tl:]     # QoS 0: no packet id
                    self._route(topic, payload)
                elif t == SUBSCRIBE & 0xF0:
                    pid, off, codes = body[:2], 2, b""
                    with self._lock:
                        while off < len(body):
                            fl = struct.unpack(">H", body[off:off + 2])[0]
                            filt = body[off + 2:off + 2 + fl].decode()
                            off += 3 + fl       # + requested-qos byte
                            self._subs[conn].append(filt)
                            codes += b"\x00"    # granted QoS 0
                    self._send(conn, _frame(SUBACK, pid + codes))
                elif t == PINGREQ:
                    self._send(conn, _frame(PINGRESP, b""))
                elif t == DISCONNECT:
                    return
        except (ConnectionError, OSError):
            pass
        finally:
            with self._lock:
                self._subs.pop(conn, None)
                self._wlocks.pop(conn, None)
            conn.close()

    def _route(self, topic: str, payload: bytes) -> None:
        pub = _frame(PUBLISH, _mqtt_str(topic) + payload)
        with self._lock:
            targets = [c for c, filts in self._subs.items()
                       if any(topic_matches(f, topic) for f in filts)]
        for c in targets:
            self._send(c, pub)       # _send drops dead receivers itself

    def close(self) -> None:
        self._running = False
        self._srv.close()
        with self._lock:
            conns = list(self._subs)
        for c in conns:
            c.close()


class MiniMqttClient:
    """paho-surface-compatible MQTT 3.1.1 client (the subset MqttBackend
    uses: connect / subscribe / publish / loop_start / loop_stop /
    disconnect, with an `on_message(client, userdata, msg)` callback)."""

    def __init__(self, client_id: str = ""):
        self._client_id = client_id or "mini-mqtt"
        self.on_message: Optional[Callable] = None
        self._sock: Optional[socket.socket] = None
        self._send_lock = threading.Lock()
        self._reader: Optional[threading.Thread] = None
        self._pinger: Optional[threading.Thread] = None
        self._running = False
        self._keepalive = 60
        # PUBLISHes read while synchronously waiting for a SUBACK — the
        # reader loop delivers them first, in arrival order
        self._pending: list[MqttMessage] = []

    def connect(self, host: str, port: int = 1883,
                keepalive: int = 60) -> None:
        self._sock = socket.create_connection((host, port), timeout=30)
        var = (_mqtt_str("MQTT") + b"\x04\x02"      # level 4, clean session
               + struct.pack(">H", keepalive) + _mqtt_str(self._client_id))
        self._sock.sendall(_frame(CONNECT, var))
        h, body = _read_frame(self._sock)
        if h & 0xF0 != CONNACK or body[1] != 0:
            raise ConnectionError(f"CONNACK refused: {body!r}")
        # blocking reads from here on: a read TIMEOUT can fire mid-frame
        # and desync the stream, so keepalive pings come from a separate
        # pinger thread instead of a socket timeout
        self._sock.settimeout(None)
        self._keepalive = keepalive

    @staticmethod
    def _parse_publish(body: bytes) -> MqttMessage:
        tl = struct.unpack(">H", body[:2])[0]
        return MqttMessage(topic=body[2:2 + tl].decode(),
                           payload=body[2 + tl:])

    def subscribe(self, topic: str, qos: int = 0) -> None:
        body = b"\x00\x01" + _mqtt_str(topic) + bytes([qos])
        with self._send_lock:
            self._sock.sendall(_frame(SUBSCRIBE, body))
        if self._running:
            return      # reader owns the socket; it consumes the SUBACK
        # pre-loop_start (the backend's construction path): wait for the
        # SUBACK so the subscription is REGISTERED before the caller's
        # next step — a QoS-0 publish races an unacked subscribe and
        # would be silently dropped.  PUBLISHes for earlier
        # subscriptions that arrive meanwhile are buffered, not lost.
        while True:
            h, rbody = _read_frame(self._sock)
            t = h & 0xF0
            if t == SUBACK:
                return
            if t == PUBLISH:
                self._pending.append(self._parse_publish(rbody))

    def publish(self, topic: str, payload) -> None:
        if isinstance(payload, str):
            payload = payload.encode()
        with self._send_lock:
            self._sock.sendall(_frame(PUBLISH, _mqtt_str(topic) + payload))

    def loop_start(self) -> None:
        self._running = True
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()
        self._pinger = threading.Thread(target=self._ping_loop, daemon=True)
        self._pinger.start()

    def _deliver(self, msg: MqttMessage) -> None:
        if self.on_message is not None:
            try:
                self.on_message(self, None, msg)
            except Exception:            # paho swallows handler errors
                log.exception("on_message handler failed")

    def _read_loop(self) -> None:
        pending, self._pending = self._pending, []
        for msg in pending:              # buffered during subscribe()
            self._deliver(msg)
        while self._running:
            try:
                h, body = _read_frame(self._sock)
            except (ConnectionError, OSError):
                return
            if h & 0xF0 == PUBLISH:
                self._deliver(self._parse_publish(body))
            # SUBACK / PINGRESP: nothing to do

    def _ping_loop(self) -> None:
        import time
        interval = max(self._keepalive / 2.0, 0.5)
        while self._running:
            time.sleep(interval)
            if not self._running:
                return
            try:
                with self._send_lock:
                    self._sock.sendall(_frame(PINGREQ, b""))
            except OSError:
                return

    def loop_stop(self) -> None:
        self._running = False

    def disconnect(self) -> None:
        self._running = False
        if self._sock is not None:
            try:
                with self._send_lock:
                    self._sock.sendall(_frame(DISCONNECT, b""))
            except OSError:
                pass
            self._sock.close()
