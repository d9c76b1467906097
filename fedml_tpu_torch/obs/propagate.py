"""Cross-process trace propagation — the federation-wide observability
glue.

A federated round's wall time is split across processes: client train,
uplink encode, transport, decode-into, streaming fold, commit.  Each
process's SpanTracer only sees its own slice; this module carries the
connective tissue on the wire frames themselves, at the comm layer's
send/`_deliver_frame` chokepoints (fedml_tpu_torch/comm/base.py):

* ``stamp(msg, rank, clock)`` — attach a compact **trace block**
  (``__fedml_trace__`` param: sender rank, send wall-clock, sender
  trace-relative timestamp, round/version id, span digest, clock echo)
  to an outbound Message.  ONLY when tracing is enabled: with obs
  disabled the param is never added and frames stay BYTE-IDENTICAL to
  the untraced build (pinned in tests/test_wire_codec.py).
* ``note(msg, backend, clock)`` — pop the trace block (and a
  piggybacked metrics delta, ``__fedml_metrics__``) off an inbound
  Message before the FSM sees it: feed the per-peer clock-offset
  estimator, record a ``trace.recv`` instant carrying the peer's span
  digest (the "shipped client spans" tools/trace_timeline.py merges),
  and fold the metrics delta into this process's registry under
  ``origin="remote"`` — a cohort rollup, never per-client labels.

Clock alignment is the piggybacked **handshake echo**: every receive
observes ``delta = t_recv(mine) − t_send(theirs) = offset + transit``;
every send echoes back the minimum delta observed FROM the receiver.
With both directions' minima the peer offset is the classic symmetric
estimate ``(delta − echo) / 2`` and transit ``(delta + echo) / 2`` —
no extra messages, accuracy bounded by transit asymmetry.  One-way-only
peers fall back to ``min(delta)`` (an upper bound: transit ≥ 0).
`ClockSync` state is bounded (``max_peers``) so a million-client server
cannot grow an unbounded peer map.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Optional

from fedml_tpu_torch import obs

TRACE_KEY = "__fedml_trace__"
METRICS_KEY = "__fedml_metrics__"

# process-wide view of live ClockSyncs so obs.export() can write the
# peer-offset table tools/trace_timeline.py aligns traces with.  Weak
# refs: each comm manager owns its clock, and a long-lived process that
# constructs managers per run/connection must not pin every dead
# manager's peer map here forever.
_registry_lock = threading.Lock()
_clock_syncs: list["weakref.ref[ClockSync]"] = []


class ClockSync:
    """Per-peer clock-offset estimator fed by piggybacked timestamps.

    ``offset(peer)`` is the estimated seconds to ADD to the peer's
    wall-clock timestamps to land on this process's clock.  Memory is
    capped at `max_peers` (overflow peers are counted, not tracked) —
    the million-client constraint."""

    def __init__(self, backend: str, max_peers: int = 4096):
        self.backend = backend
        self.rank: Optional[int] = None      # learned at first stamp
        self.max_peers = max_peers
        self.peers_skipped = 0
        self._lock = threading.Lock()
        self._delta_min: dict[int, float] = {}   # min(t_recv − t_send)
        self._echo: dict[int, float] = {}        # peer's min for OUR sends
        self._m_transit = obs.histogram(
            "trace_transit_seconds",
            buckets=obs.metrics.DECODE_SECONDS_BUCKETS, backend=backend)
        self._m_offset = obs.gauge("trace_clock_offset_seconds",
                                   backend=backend)
        # cached handle: note() runs per received frame — the registry
        # get-or-create lookup must not
        self._m_frames = obs.counter("trace_frames_total",
                                     backend=backend)

    def observe(self, peer: int, delta: float,
                echo: Optional[float]) -> None:
        with self._lock:
            if peer not in self._delta_min and \
                    len(self._delta_min) >= self.max_peers:
                self.peers_skipped += 1
                return
            d = self._delta_min.get(peer)
            self._delta_min[peer] = delta if d is None else min(d, delta)
            if echo is not None:
                e = self._echo.get(peer)
                self._echo[peer] = echo if e is None else min(e, echo)
            off, transit = self._estimate(peer)
        self._m_offset.set(off)
        if transit is not None:
            self._m_transit.observe(max(0.0, transit))

    def _estimate(self, peer: int):
        """(offset, transit) under _lock; transit None without echo."""
        d = self._delta_min[peer]
        e = self._echo.get(peer)
        if e is None:
            return d, None            # one-way bound: transit >= 0
        return (d - e) / 2.0, (d + e) / 2.0

    def delta_for(self, peer: int) -> Optional[float]:
        """Min observed delta FROM `peer` — the echo a frame bound for
        that peer carries."""
        with self._lock:
            return self._delta_min.get(peer)

    def offsets(self) -> dict[int, float]:
        """{peer_rank: offset_seconds} — add to peer timestamps to map
        onto this clock."""
        with self._lock:
            return {p: self._estimate(p)[0] for p in self._delta_min}

    def export(self) -> dict:
        with self._lock:
            return {
                "backend": self.backend,
                "rank": self.rank,
                "offsets_s": {str(p): self._estimate(p)[0]
                              for p in self._delta_min},
                "echoed": sorted(self._echo),
                "peers_skipped": self.peers_skipped,
            }


def make_clock(backend: str) -> ClockSync:
    """ClockSync factory that registers the instance for export()."""
    c = ClockSync(backend)
    with _registry_lock:
        _clock_syncs.append(weakref.ref(c))
        # prune refs whose manager (and clock) died — a long-lived
        # process creating managers per run must not grow this list
        _clock_syncs[:] = [r for r in _clock_syncs if r() is not None]
    return c


def clock_exports() -> list[dict]:
    with _registry_lock:
        syncs = [c for c in (r() for r in _clock_syncs) if c is not None]
    return [c.export() for c in syncs if c._delta_min or c.rank is not None]


def reset_clocks() -> None:
    """Test hook (obs.reset() calls through)."""
    with _registry_lock:
        _clock_syncs.clear()


def stamp(msg, rank: int, clock: Optional[ClockSync] = None) -> None:
    """Attach the trace block to an outbound Message — a no-op (and
    byte-neutral) unless tracing is enabled."""
    t = obs.tracer()
    if t is None:
        return
    blk = {
        "r": int(rank),
        "t": time.time(),             # send wall-clock (offset source)
        "m": t._now_us(),             # sender trace-relative, us
        "d": t.digest(),
    }
    rd = msg.get("model_version", msg.get("round_idx"))
    if rd is not None:
        blk["rd"] = int(rd)
    if clock is not None:
        clock.rank = int(rank)
        e = clock.delta_for(msg.get_receiver_id())
        if e is not None:
            blk["e"] = e
    msg.add_params(TRACE_KEY, blk)


def note(msg, backend: str = "",
         clock: Optional[ClockSync] = None) -> None:
    """Strip + account the trace block and metrics delta of an inbound
    Message (the receive chokepoint's twin of stamp()).  Always safe to
    call: both params are absent on untraced frames."""
    params = msg.msg_params
    mblk = params.pop(METRICS_KEY, None)
    if mblk is not None:
        # cohort rollup: ONE origin label, never the sender's id
        obs.registry().merge_delta(mblk, origin="remote")
    blk = params.pop(TRACE_KEY, None)
    if blk is None:
        return
    now = time.time()
    peer = int(blk.get("r", -1))
    delta = now - float(blk.get("t", now))
    if clock is not None:
        clock.observe(peer, delta, blk.get("e"))
        clock._m_frames.inc()
    else:
        obs.counter("trace_frames_total", backend=backend).inc()
    t = obs.tracer()
    if t is not None:
        t.instant("trace.recv", peer=peer, backend=backend,
                  round=blk.get("rd"), delta_s=round(delta, 6),
                  send_unix=blk.get("t"), send_ts_us=blk.get("m"),
                  digest=blk.get("d"))
