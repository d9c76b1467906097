"""Reliable-delivery envelope — exactly-once frame ingestion over lossy
transports.

FedML's target regime (arXiv:2007.13518) is intermittent, unreliable
cross-device clients, yet the wire layer assumed a clean network: no
frame integrity check, no ack/resend, no duplicate suppression.  That
was survivable while the server drained whole-cohort barriers, but the
aggregation-on-arrival path folds every delivered frame straight
into the streaming accumulator — ONE retried or duplicated uplink
silently corrupts the weighted sum.  This module closes the gap with a
thin, v1-compatible envelope around the existing MessageCodec frames:

    FMLR ‖ u8 kind ‖ u32 sender ‖ u64 seq ‖ u32 crc32(inner) ‖ inner

* **seq** is per-(sender, peer) monotonic — the receiver's dedup ledger
  drops replays BEFORE decode, so the streaming accumulator under a
  dup-storm is BITWISE the clean-run accumulator (pinned in
  tests/test_chaos.py).
* **crc32** covers the inner frame — a corrupt frame is quarantined
  (metric + NACK) instead of killing the recv thread.
* **ack/nack** ride the reverse channel (the TCP reply path, the gRPC
  unary response, a dial-back on native/inproc); unacked frames resend
  with jittered exponential backoff from ONE `BackoffPolicy` — the
  same policy object the per-backend connect/send retry loops now draw
  their delays from, replacing the ad-hoc sleeps.

Envelopes only exist when a sender opted in
(`BaseCommManager.enable_reliability`); with reliability disabled (or
the `FEDML_RELIABLE=0` escape hatch) frames are byte-identical to the
pre-envelope build across every codec flavor (pinned in
tests/test_wire_codec.py).  Receivers unwrap FMLR frames regardless of
their own send-side setting, so mixed deployments interoperate in both
directions — the same compatibility stance as wire codec v2.

Delivery semantics, stated honestly: an ACK means *delivered and
deduplicated*, not yet folded — exactly-once INGESTION comes from the
ledger guarding the one `_ingest_row` insert path, and crash durability
from the async server's per-commit orbax checkpoint
(fedml_tpu/async_/lifecycle.py), not from the ack itself.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import random
import struct
import threading
import time
import zlib
from typing import Callable, Optional

import numpy as np

from fedml_tpu_torch import obs

log = logging.getLogger(__name__)

ENV_RELIABLE = "FEDML_RELIABLE"      # "0" = escape hatch: never envelope

MAGIC = b"FMLR"
KIND_DATA = 0
KIND_ACK = 1
KIND_NACK = 2

_HEADER = struct.Struct("<4sBIQI")   # magic, kind, sender, seq, crc
HEADER_LEN = _HEADER.size


def escape_hatch_off() -> bool:
    """True when FEDML_RELIABLE=0 force-disables the envelope process-wide
    (mirrors FEDML_WIRE_V1 / --no_prefetch: one env var back to the
    pre-PR wire behavior)."""
    return os.environ.get(ENV_RELIABLE, "") == "0"


@dataclasses.dataclass
class BackoffPolicy:
    """Jittered exponential backoff — THE retry-delay schedule.  One
    policy object serves the resend thread, the TCP/native connect
    loops, and the gRPC send retry, so "how patient is this federation
    with a flaky peer" is one tunable, not five ad-hoc sleeps.

    delay(attempt) = min(base_s·mult^(attempt-1), max_s) ± jitter —
    jitter is drawn from the policy's own seeded PRNG, so two policies
    with the same seed produce the same schedule (the chaos benches
    stay repeatable)."""
    base_s: float = 0.25
    mult: float = 2.0
    max_s: float = 4.0
    jitter: float = 0.25          # ± fraction of the base delay
    max_attempts: int = 12        # resend gives up (loudly) after this
    seed: int = 0

    def __post_init__(self):
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()

    def delay(self, attempt: int) -> float:
        d = min(self.base_s * (self.mult ** max(0, attempt - 1)),
                self.max_s)
        if self.jitter <= 0.0:
            return d
        with self._lock:
            u = self._rng.uniform(-self.jitter, self.jitter)
        return max(0.0, d * (1.0 + u))


class _PeerLedger:
    """Per-sender duplicate ledger: `contig` is the highest seq with
    every predecessor seen; out-of-order arrivals park in `pending`
    until the gap closes, so memory is bounded by the sender's in-flight
    window (plus losses), not the stream length."""

    __slots__ = ("contig", "pending")

    def __init__(self):
        self.contig = -1
        self.pending: set[int] = set()

    def seen(self, seq: int) -> bool:
        return seq <= self.contig or seq in self.pending

    def mark(self, seq: int) -> None:
        if seq == self.contig + 1:
            self.contig += 1
            while (self.contig + 1) in self.pending:
                self.pending.discard(self.contig + 1)
                self.contig += 1
        elif seq > self.contig:
            self.pending.add(seq)


class _Outstanding:
    __slots__ = ("peer", "wire", "attempts", "due")

    def __init__(self, peer: int, wire: bytes, due: float):
        self.peer = peer
        self.wire = wire
        self.attempts = 1
        self.due = due


class ReliableEndpoint:
    """One process's reliability state over one transport: per-peer seq
    assignment + outstanding map on the send side, dedup ledger + CRC
    quarantine + ack emission on the receive side, and a lazy daemon
    resend thread driving the backoff schedule.

    `send_raw(peer, wire)` is the transport's raw frame write (it may
    raise — failures just leave the frame outstanding for the resend
    thread).  `on_wire(data, reply=...)` processes any FMLR frame;
    `reply` (when the transport has a reverse channel, e.g. the TCP
    connection the frame arrived on) short-circuits the ack back the
    way the data came."""

    def __init__(self, rank: int, send_raw: Callable[[int, bytes], None],
                 policy: Optional[BackoffPolicy] = None, name: str = ""):
        self.rank = int(rank)
        self.name = name
        self._send_raw = send_raw
        self.policy = policy if policy is not None else BackoffPolicy()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._seq: dict[int, int] = {}
        self._outstanding: dict[tuple[int, int], _Outstanding] = {}
        self._ledger: dict[int, _PeerLedger] = {}
        self._alive = True
        self._thread: Optional[threading.Thread] = None
        self._m_retries = obs.counter("comm_reliable_retries_total")
        self._m_acks = obs.counter("comm_reliable_acks_total")
        self._m_nacks = obs.counter("comm_reliable_nacks_total")
        self._m_dups = obs.counter("comm_reliable_dups_suppressed_total")
        self._m_quar = obs.counter("comm_frames_quarantined_total")
        self._m_abandoned = obs.counter("comm_reliable_abandoned_total")

    # -- send side -----------------------------------------------------------
    def wrap(self, peer: int, frame: bytes) -> bytes:
        """Envelope `frame` for `peer`: assign the next seq, register it
        outstanding (the resend thread owns it until the ack lands), and
        return the wire bytes.  Callers that transmit themselves (the
        chaos disconnect hook) use this; normal sends go through
        send()."""
        frame = bytes(frame)
        crc = zlib.crc32(frame) & 0xFFFFFFFF
        with self._lock:
            seq = self._seq.get(peer, 0)
            self._seq[peer] = seq + 1
            wire = _HEADER.pack(MAGIC, KIND_DATA, self.rank, seq,
                                crc) + frame
            self._outstanding[(peer, seq)] = _Outstanding(
                peer, wire, time.monotonic() + self.policy.delay(1))
            self._ensure_thread_locked()
            self._cv.notify()
        return wire

    def send(self, peer: int, frame: bytes) -> bytes:
        """wrap + best-effort first transmit.  A transport failure here
        does NOT raise: the frame is already outstanding and the resend
        thread retries it on the backoff schedule — exactly the crash
        window (peer down, server restarting) the envelope exists for."""
        wire = self.wrap(peer, frame)
        try:
            self._send_raw(peer, wire)
        except Exception as e:
            self._m_retries.inc()
            log.debug("%s: first transmit to %d failed (%s); resend "
                      "thread owns it", self.name, peer, e)
        return wire

    def pending(self) -> int:
        with self._lock:
            return len(self._outstanding)

    # -- crash-resume state --------------------------------------------------
    # slack added to restored send seqs: dispatches sent AFTER the last
    # checkpoint but before the crash consumed seqs the checkpoint never
    # saw — restarting exactly at the saved counter would reuse them and
    # the peers' ledgers would suppress the resumed server's first sends
    # (including the send_start re-handshake).  The slack dwarfs any
    # realistic between-checkpoint send count; seqs are u64, so burning
    # 2^16 per crash costs nothing.
    SEQ_RESUME_SLACK = 65536

    def export_seq_state(self, size: int) -> dict:
        """Checkpointable per-peer state for ranks [0, size): the next
        send seq, and the dedup ledger's high-water mark (max seq seen —
        the conservative summary: replays at or below it are suppressed
        after resume; unseen gap seqs below it are suppressed too, which
        LOSES those updates rather than double-folding an already-
        committed one — for FL aggregation loss is benign, corruption is
        not)."""
        with self._lock:
            seq = np.zeros((size,), np.int64)
            for p, s in self._seq.items():
                if 0 <= p < size:
                    seq[p] = s
            seen = np.full((size,), -1, np.int64)
            for p, led in self._ledger.items():
                if 0 <= p < size:
                    seen[p] = max([led.contig] + sorted(led.pending)[-1:])
        return {"seq": seq, "seen": seen}

    def import_seq_state(self, state: dict) -> None:
        """Restore a checkpoint's export_seq_state: send seqs resume
        past the saved counters (plus SEQ_RESUME_SLACK), and each peer's
        ledger watermark suppresses replays of pre-crash deliveries —
        the exactly-once guarantee survives the crash-resume window
        where an ingested frame's ACK died with the old server."""
        seq = np.asarray(state["seq"], np.int64)
        seen = np.asarray(state["seen"], np.int64)
        with self._lock:
            for p in range(seq.shape[0]):
                if seq[p] > 0:
                    self._seq[p] = max(self._seq.get(p, 0),
                                       int(seq[p]) + self.SEQ_RESUME_SLACK)
                if seen[p] >= 0:
                    led = self._ledger.get(p)
                    if led is None:
                        led = self._ledger[p] = _PeerLedger()
                    led.contig = max(led.contig, int(seen[p]))

    def flush(self, timeout: float = 10.0) -> bool:
        """Wait until every outstanding frame is acked (or abandoned)."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while self._outstanding:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(timeout=min(left, 0.1))
        return True

    # -- receive side --------------------------------------------------------
    def on_wire(self, data, reply: Optional[Callable[[bytes], None]] = None
                ) -> Optional[bytes]:
        """Process one FMLR frame.  Returns the inner payload for DATA
        frames that pass CRC and the dedup ledger (the caller then runs
        the normal decode/sink path), None otherwise (ack/nack
        bookkeeping, suppressed duplicate, quarantined corruption)."""
        head = bytes(data[:HEADER_LEN])
        if len(head) < HEADER_LEN:
            self._m_quar.inc()
            log.warning("%s: truncated reliability header (%d bytes) — "
                        "quarantined", self.name, len(head))
            return None
        magic, kind, sender, seq, crc = _HEADER.unpack(head)
        if kind == KIND_ACK:
            with self._lock:
                if self._outstanding.pop((sender, seq), None) is not None:
                    self._m_acks.inc()
                    self._cv.notify_all()
            return None
        if kind == KIND_NACK:
            # the peer SAW the frame but couldn't use it: resend now
            with self._lock:
                ent = self._outstanding.get((sender, seq))
                if ent is not None:
                    ent.due = time.monotonic()
                    self._cv.notify()
            return None
        if kind != KIND_DATA:
            self._m_quar.inc()
            log.warning("%s: unknown envelope kind %d from %d — "
                        "quarantined", self.name, kind, sender)
            return None
        inner = bytes(data[HEADER_LEN:])
        if (zlib.crc32(inner) & 0xFFFFFFFF) != crc:
            # corrupt in flight: quarantine + NACK so the sender resends
            # instead of the recv thread dying mid-decode
            self._m_quar.inc()
            obs.instant("chaos.quarantine", sender=sender, seq=seq,
                        nbytes=len(inner))
            self._control(KIND_NACK, sender, seq, reply)
            self._m_nacks.inc()
            return None
        with self._lock:
            led = self._ledger.get(sender)
            if led is None:
                led = self._ledger[sender] = _PeerLedger()
            dup = led.seen(seq)
            if not dup:
                led.mark(seq)
        if dup:
            # replay (retry storm / injected duplicate): suppress, but
            # RE-ACK — the original ack may be the thing that was lost
            self._m_dups.inc()
            self._control(KIND_ACK, sender, seq, reply)
            return None
        self._control(KIND_ACK, sender, seq, reply)
        return inner

    def _control(self, kind: int, peer: int, seq: int,
                 reply: Optional[Callable[[bytes], None]]) -> None:
        wire = _HEADER.pack(MAGIC, kind, self.rank, seq, 0)
        try:
            if reply is not None:
                reply(wire)
            else:
                self._send_raw(peer, wire)
        except Exception as e:
            # a lost ack is recoverable (the peer resends, the ledger
            # suppresses) — never let it kill the recv path
            log.debug("%s: ack/nack to %d failed (%s)", self.name, peer, e)

    # -- resend thread -------------------------------------------------------
    def _ensure_thread_locked(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._resend_loop, daemon=True,
                name=f"reliable-resend-{self.name}")
            self._thread.start()

    def _resend_loop(self) -> None:
        while True:
            with self._lock:
                if not self._alive:
                    return
                now = time.monotonic()
                due = [e for e in self._outstanding.values()
                       if e.due <= now]
                if not due:
                    nxt = min((e.due for e in
                               self._outstanding.values()),
                              default=now + 0.2)
                    self._cv.wait(timeout=max(0.01, min(nxt - now, 0.2)))
                    continue
                for e in due:
                    e.attempts += 1
                    if e.attempts > self.policy.max_attempts:
                        self._outstanding.pop(
                            (e.peer, _HEADER.unpack(
                                e.wire[:HEADER_LEN])[3]), None)
                        self._m_abandoned.inc()
                        log.warning(
                            "%s: frame to %d abandoned after %d attempts",
                            self.name, e.peer, e.attempts - 1)
                        continue
                    e.due = now + self.policy.delay(e.attempts)
                send_now = [e for e in due
                            if e.attempts <= self.policy.max_attempts]
            for e in send_now:                 # transmit OUTSIDE the lock
                self._m_retries.inc()
                obs.instant("chaos.retry", peer=e.peer,
                            attempt=e.attempts)
                try:
                    self._send_raw(e.peer, e.wire)
                except Exception as ex:
                    log.debug("%s: resend to %d failed (%s)", self.name,
                              e.peer, ex)

    def close(self) -> None:
        with self._lock:
            self._alive = False
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=2)
