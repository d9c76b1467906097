"""Seeded wire-level fault injection: the federation chaos layer (port of
fedml_tpu/comm/chaos.py, the same code: it never touched JAX).

FL_PyTorch (arXiv:2202.03099) frames robustness scenarios as first-class
experiment axes; FedML's own regime (arXiv:2007.13518) is intermittent
clients on unreliable links.  This module makes those scenarios
injectable at the two chokepoints every backend already funnels through
(comm/base.py), so one policy object tortures every transport alike:

* **send gate** (`BaseCommManager._stamp_frame`): partition (a peer set
  whose outbound frames all vanish), per-peer drop/delay overrides, and
  disconnect-mid-frame (the TCP backend tears the connection down
  halfway through a frame — the torn-wire case `_read_exact` turns into
  a ConnectionError);
* **receive path** (`_deliver_frame` / the MQTT JSON handler): drop,
  duplicate, reorder (hold one frame, release it after the next),
  delay, and byte-corruption — applied to the raw frame bytes BEFORE
  the reliability envelope or the codec sees them, exactly where a bad
  NIC or a flaky broker would hit.

Determinism: every draw flows through a per-stream
`np.random.Generator` seeded from (cfg.seed, direction, stream id) —
send streams are keyed by peer rank, receive streams by the receiving
thread (one per connection/client on every real transport).  A stream's
injected-event trace is therefore a pure function of the seed and its
own frame order, regardless of cross-stream thread interleaving: two
runs with the same seed produce identical per-stream traces, two seeds
differ, and the same seed and frames give the JAX policy's schedule
bitwise.  The bounded `events` list is that trace; `counts` is its
rollup (`summary()`).
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Iterable, Optional

import numpy as np

from fedml_tpu_torch import obs

log = logging.getLogger(__name__)

# receive-side fault kinds, in the cumulative-draw order (one uniform
# per frame walks this ladder — a frame suffers at most one fault)
RECV_KINDS = ("drop", "dup", "reorder", "delay", "corrupt")
# send-side kinds the gate can return
SEND_KINDS = ("partition", "drop", "delay", "disconnect")

_MAX_EVENTS = 50_000


@dataclasses.dataclass
class ChaosConfig:
    """Fault rates (probabilities per frame).  drop/dup/reorder/delay/
    corrupt apply at the receive chokepoint; disconnect at the send
    gate (mid-frame teardown needs the sender's socket).  `per_peer`
    maps a peer rank to overrides for the SEND gate's drop/delay/
    disconnect — per-peer receive attribution would need the envelope
    decoded first, so asymmetric links are modeled sender-side."""
    drop: float = 0.0
    dup: float = 0.0
    reorder: float = 0.0
    delay: float = 0.0
    corrupt: float = 0.0
    disconnect: float = 0.0
    delay_s: float = 0.01            # mean injected delay (exponential)
    corrupt_nbytes: int = 8          # bytes flipped per corrupted frame
    seed: int = 0
    per_peer: Optional[dict] = None  # rank -> {"drop"/"delay"/"disconnect": p}

    def __post_init__(self):
        for k in ("drop", "dup", "reorder", "delay", "corrupt",
                  "disconnect"):
            v = getattr(self, k)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"chaos rate {k}={v} outside [0, 1]")


class _Stream:
    __slots__ = ("rng", "n")

    def __init__(self, seed: int, direction: int, ident: int):
        self.rng = np.random.default_rng([seed, direction, ident])
        self.n = 0


class ChaosPolicy:
    """Seeded fault injector; install on a backend with
    `BaseCommManager.install_chaos`.  Thread-safe; one policy may be
    shared by several backends (the event trace then interleaves their
    streams, each stream still deterministic)."""

    def __init__(self, cfg: Optional[ChaosConfig] = None, **rates):
        self.cfg = cfg if cfg is not None else ChaosConfig(**rates)
        self._lock = threading.Lock()
        self._send_streams: dict[int, _Stream] = {}
        self._recv_tls = threading.local()
        self._next_recv = 0
        self._partitioned: set[int] = set()
        self.events: list[dict] = []
        self.counts: dict[str, int] = {}
        self._m_injected = obs.counter("comm_chaos_injected_total")

    # -- partitions (dynamic — a chaos scenario toggles these mid-run) -------
    def partition(self, *ranks: int) -> None:
        """Make `ranks` unreachable: every outbound frame to them drops
        (counted as "partition") until heal()."""
        with self._lock:
            self._partitioned.update(int(r) for r in ranks)

    def heal(self, *ranks: int) -> None:
        """Lift the partition for `ranks` (all of it when empty)."""
        with self._lock:
            if ranks:
                self._partitioned.difference_update(int(r) for r in ranks)
            else:
                self._partitioned.clear()

    def partitioned(self) -> frozenset:
        with self._lock:
            return frozenset(self._partitioned)

    # -- bookkeeping ---------------------------------------------------------
    def _record(self, stream: str, n: int, kind: str) -> None:
        with self._lock:
            self.counts[kind] = self.counts.get(kind, 0) + 1
            if len(self.events) < _MAX_EVENTS:
                self.events.append({"stream": stream, "n": n,
                                    "kind": kind})
        self._m_injected.inc()
        obs.instant(f"chaos.{kind}", stream=stream, n=n)

    def trace(self) -> list[dict]:
        with self._lock:
            return list(self.events)

    def summary(self) -> dict:
        with self._lock:
            return dict(self.counts)

    # -- send gate -----------------------------------------------------------
    def plan_send(self, peer: int) -> tuple[str, float]:
        """One draw from `peer`'s send stream: ("pass"|"drop"|"delay"|
        "disconnect"|"partition", delay_seconds).  Partition wins before
        any draw (and consumes none, so healing preserves the stream's
        remaining schedule)."""
        with self._lock:
            if peer in self._partitioned:
                pass_through = False
            else:
                pass_through = True
            st = self._send_streams.get(peer)
            if st is None:
                st = self._send_streams[peer] = _Stream(
                    self.cfg.seed, 0, peer)
        if not pass_through:
            self._record(f"send:{peer}", -1, "partition")
            return "partition", 0.0
        over = (self.cfg.per_peer or {}).get(peer, {})
        p_drop = float(over.get("drop", 0.0))
        p_delay = float(over.get("delay", 0.0))
        p_disc = float(over.get("disconnect", self.cfg.disconnect))
        if p_drop + p_delay + p_disc <= 0.0:
            return "pass", 0.0
        with self._lock:
            n = st.n
            st.n += 1
            u = float(st.rng.random())
            d = float(st.rng.exponential(self.cfg.delay_s))
        if u < p_drop:
            self._record(f"send:{peer}", n, "drop")
            return "drop", 0.0
        if u < p_drop + p_delay:
            self._record(f"send:{peer}", n, "delay")
            return "delay", d
        if u < p_drop + p_delay + p_disc:
            self._record(f"send:{peer}", n, "disconnect")
            return "disconnect", 0.0
        return "pass", 0.0

    # -- receive path --------------------------------------------------------
    def _recv_stream(self) -> tuple[str, _Stream]:
        st = getattr(self._recv_tls, "stream", None)
        if st is None:
            with self._lock:
                ident = self._next_recv
                self._next_recv += 1
            st = _Stream(self.cfg.seed, 1, ident)
            self._recv_tls.stream = st
            self._recv_tls.ident = ident
        return f"recv:{self._recv_tls.ident}", st

    def filter_recv(self, payload) -> Iterable:
        """Apply one receive-side fault draw to `payload`; returns the
        list of frames to actually deliver (possibly empty, possibly
        two, possibly byte-flipped).  May sleep (injected delay) — it
        runs on the transport's recv thread, so the delay backpressures
        exactly like real network latency would.

        A reorder-held frame is released behind the NEXT frame of its
        own receive stream regardless of that frame's own draw, so
        "reorder" really means swapped delivery, never a disguised drop
        (only a frame held at the very end of a stream is lost — the tail
        truncation any real reordering window has).

        The reorder slot is the stream's (its receive thread's), where
        the JAX policy keeps one slot for all its streams.  A frame held
        from one connection and released behind another's was delivered
        with the other connection's reply channel: its reliability ack
        went to the wrong peer, where it retired that peer's outstanding
        frame of the same sequence number, so that frame was never resent
        and a FedAvg round waited for it forever.  On one stream the
        two slots are the same, so a one-thread schedule is the JAX
        policy's bitwise."""
        c = self.cfg
        total = c.drop + c.dup + c.reorder + c.delay + c.corrupt
        if total <= 0.0:
            return (payload,)
        held = getattr(self._recv_tls, "held", None)
        self._recv_tls.held = None
        out = self._fate(payload)
        if held is not None:
            out = tuple(out) + (held,)
        return out

    def _fate(self, payload) -> tuple:
        c = self.cfg
        name, st = self._recv_stream()
        with self._lock:
            n = st.n
            st.n += 1
            u = float(st.rng.random())
            d = float(st.rng.exponential(c.delay_s))
            k = c.corrupt_nbytes
            idx = st.rng.integers(0, max(1, len(payload)),
                                  size=max(1, k)) if c.corrupt else None
        edge = c.drop
        if u < edge:
            self._record(name, n, "drop")
            return ()
        edge += c.dup
        if u < edge:
            self._record(name, n, "dup")
            return (payload, payload)
        edge += c.reorder
        if u < edge:
            # stash; filter_recv releases it behind the stream's NEXT frame
            self._record(name, n, "reorder")
            self._recv_tls.held = bytes(payload)
            return ()
        edge += c.delay
        if u < edge:
            self._record(name, n, "delay")
            time.sleep(min(d, 1.0))
            return (payload,)
        edge += c.corrupt
        if u >= edge:
            return (payload,)      # the frame passes clean
        # corrupt: flip bytes at the drawn offsets (on a copy — the
        # caller's buffer may be shared)
        self._record(name, n, "corrupt")
        bad = bytearray(payload)
        if bad:
            for i in np.asarray(idx).tolist():
                bad[int(i) % len(bad)] ^= 0xFF
        return (bytes(bad),)
