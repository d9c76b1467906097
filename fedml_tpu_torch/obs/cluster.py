"""Cluster observatory: live cross-rank telemetry, barrier straggler
attribution, cluster-scoped SLOs and coordinated incident dumps (port of
fedml_tpu/obs/cluster.py, the same code: it never touched JAX).

It is the cluster-wide view over the one-process judgment layer (the
SLO engine, the flight recorder, the metrics registry), riding channels
that already exist; it opens no connection of its own:

* **Live telemetry plane.**  Workers piggyback bounded metric deltas
  (``delta_snapshot`` docs, the shape obs/propagate.py carries) on
  frames they already send — heartbeat headers, or a self-describing
  payload trailer (`attach_sidecar` / `split_sidecar`) — and rank 0
  folds them continuously under ``origin="host<i>"`` (`fold_remote`).
  The piggyback attaches ONLY when an obs dir is configured
  (`telemetry_enabled`), so the obs-off wire bytes are byte-identical
  to a channel without the observatory.

* **Barrier ledger.**  Rank 0 stamps per-rank arrival times at every
  gather/allgather/exchange and `note_barrier` turns them into ledger
  entries: ``round_gating_rank`` (the last arrival — the rank the
  whole commit waited on), ``gate_margin_s`` (how far behind the
  second-latest it was), and per-rank waits observed into
  ``multihost_barrier_wait_seconds{rank}``.  Always on: the ledger is
  local bookkeeping with zero wire impact.

* **Cluster SLO pack.**  `cluster_slo_pack` evaluated on rank 0 over
  the folded registry (committed-rounds/sec floor, barrier-wait p95
  ceiling, view-change latency ceiling, zero rank deaths), with
  `cluster_slo_report` attaching an **attribution** block naming the
  dead rank(s) and the dominant gating rank.

* **Coordinated incident dumps.**  A view change, rank death, or
  cluster-SLO breach on the coordinator routes through
  `maybe_coordinated_dump`: one throttle window, a local flight dump,
  and a registered broadcaster (a channel's DUMP control frame) so every
  surviving rank snapshots the same incident window into its own obs
  dir.

The channels that feed it (the multi-process runner's heartbeats and
allgathers) come to the port with its multi-process slice; until then
it runs in-process, fed by its public functions.  This module must NOT
import the multi-process runner — the channels produce arrivals/deltas
and register the dump broadcaster; this module folds and judges.
`/cluster` (httpd) reads the reports built here.
"""
from __future__ import annotations

import collections
import json
import logging
import struct
import threading
import time
from typing import Callable, Optional

from fedml_tpu_torch import obs
from fedml_tpu_torch.obs import metrics as _metrics
from fedml_tpu_torch.obs import slo as _slo

log = logging.getLogger(__name__)

# Sidecar trailer marker for allgather payload piggybacks.  The frame
# is ``payload + delta_json + <u32 len(delta_json)> + SIDECAR_MAGIC``;
# self-describing, so a receiver strips it iff present (mixed
# enablement across ranks stays safe) and an astronomically-unlikely
# payload collision is rejected by the JSON/schema check.
SIDECAR_MAGIC = b"\x00fmlMET1"
# Per-beat piggyback budget: a delta bigger than this waits for the
# end-of-run rollup instead of bloating a control frame.
SIDECAR_CAP_BYTES = 64 * 1024
# Coordinated dumps share one throttle window (the flight dumps'
# discipline): a breach storm yields one synchronized artifact set,
# not hundreds.
DUMP_MIN_INTERVAL_S = 30.0
# A rank whose last heartbeat is older than this reads as not-alive in
# the /cluster liveness view.
LIVENESS_STALE_S = 10.0
_MAX_LEDGER = 512


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.rank: Optional[int] = None
        self.world: Optional[int] = None
        self.elastic = False
        # sticky: once a rank-0 channel registers, this process is the
        # coordinator for scope/report purposes — in-process tests run
        # every rank's channel in one process and the workers must not
        # demote the view
        self.is_coord = False
        self.hb_last: dict[int, float] = {}     # rank -> monotonic
        self.fold_last: dict[int, float] = {}   # rank -> monotonic
        self.ledger: collections.deque = collections.deque(
            maxlen=_MAX_LEDGER)
        self.gating_counts: dict[int, int] = {}
        self.engine: Optional[_slo.SloEngine] = None
        self.last_dump = float("-inf")
        self.broadcaster: Optional[Callable[[str], None]] = None


_state = _State()


def reset() -> None:
    """Fresh observatory state (wired into obs.reset for tests)."""
    global _state
    _state = _State()


def telemetry_enabled() -> bool:
    """Piggyback/DUMP frames attach only when an obs dir is configured
    — the obs-off wire stays byte-identical by construction."""
    return obs.enabled()


def scope() -> str:
    """"cluster" when this process coordinates (its folded registry
    speaks for every rank), else "local" — the /slo + /cluster field
    that keeps one rank's green from masquerading as the cluster's."""
    return "cluster" if _state.is_coord else "local"


def set_role(rank: int, world: int, *, elastic: bool = False) -> None:
    """Channel construction hook: record this process's place in the
    cluster.  Rank 0 becomes the coordinator: it gets the cluster SLO
    engine, primed HERE so the evaluation window spans the run."""
    st = _state
    with st.lock:
        if rank == 0:
            st.rank, st.world, st.elastic = 0, int(world), bool(elastic)
            st.is_coord = True
            if st.engine is None:
                st.engine = _slo.SloEngine(cluster_slo_pack(),
                                           pack_name="cluster")
                st.engine.prime()
        elif st.rank is None:
            st.rank, st.world, st.elastic = (int(rank), int(world),
                                             bool(elastic))


def set_dump_broadcaster(fn: Optional[Callable[[str], None]]) -> None:
    """Register the channel-owned fan-out (a channel's DUMP
    frame).  None unregisters (channel close)."""
    with _state.lock:
        _state.broadcaster = fn


# ---------------------------------------------------------------------------
# live telemetry plane
# ---------------------------------------------------------------------------

def note_heartbeat(rank: int) -> None:
    with _state.lock:
        _state.hb_last[int(rank)] = time.monotonic()


def fold_remote(rank: int, delta) -> None:
    """Fold a peer's piggybacked ``delta_snapshot`` doc into this
    process's registry under ``origin="host<rank>"`` — the same merge
    the end-of-run rollup uses, so live folds and the final rollup
    land in the same series."""
    if not isinstance(delta, dict) or not delta.get("metrics"):
        return
    try:
        obs.registry().merge_delta(delta, origin=f"host{int(rank)}")
    except Exception:
        log.warning("cluster observatory: dropping unfoldable delta "
                    "from rank %s", rank, exc_info=True)
        return
    with _state.lock:
        _state.fold_last[int(rank)] = time.monotonic()


def attach_sidecar(payload: bytes, delta: Optional[dict]) -> bytes:
    """Append a self-describing metrics trailer to an allgather
    payload (worker side).  Returns `payload` unchanged when there is
    nothing to ship or the delta exceeds the frame budget."""
    if not delta or not delta.get("metrics"):
        return payload
    blob = json.dumps(delta, sort_keys=True).encode()
    if len(blob) > SIDECAR_CAP_BYTES:
        return payload
    return (payload + blob + struct.pack("<I", len(blob))
            + SIDECAR_MAGIC)


def split_sidecar(frame: bytes) -> tuple[bytes, Optional[dict]]:
    """Strip (payload, delta) from a possibly-trailered frame.  Frames
    without the trailer pass through untouched — receivers call this
    unconditionally, which is what makes mixed obs-on/obs-off ranks
    safe and keeps the broadcast payloads bitwise-clean."""
    tail = len(SIDECAR_MAGIC) + 4
    if len(frame) < tail or not frame.endswith(SIDECAR_MAGIC):
        return frame, None
    (n,) = struct.unpack_from("<I", frame, len(frame) - tail)
    end = len(frame) - tail
    if n == 0 or n > end:
        return frame, None
    try:
        delta = json.loads(frame[end - n:end].decode())
    except (UnicodeDecodeError, ValueError):
        return frame, None
    if not isinstance(delta, dict) or delta.get("schema") != 1:
        return frame, None
    return frame[:end - n], delta


# ---------------------------------------------------------------------------
# barrier ledger
# ---------------------------------------------------------------------------

def note_barrier(kind: str, seq: int, round_idx: Optional[int],
                 arrivals: dict) -> Optional[dict]:
    """Record one barrier's per-rank arrival stamps (rank 0 only —
    the star's single observer).  ``arrivals`` maps rank -> monotonic
    arrival time; the gate is the LAST arrival, and everyone else's
    wait is how long they idled behind it."""
    if len(arrivals) < 2:
        return None
    order = sorted(arrivals.items(), key=lambda kv: (kv[1], kv[0]))
    t_gate = order[-1][1]
    gating = int(order[-1][0])
    margin = float(t_gate - order[-2][1])
    waits = {int(r): float(t_gate - t) for r, t in arrivals.items()}
    entry = {
        "kind": str(kind),
        "seq": int(seq),
        "round": None if round_idx is None else int(round_idx),
        "round_gating_rank": gating,
        "gate_margin_s": margin,
        "waits_s": {str(r): waits[r] for r in sorted(waits)},
        "t_unix": time.time(),
    }
    with _state.lock:
        _state.ledger.append(entry)
        _state.gating_counts[gating] = (
            _state.gating_counts.get(gating, 0) + 1)
    for r in sorted(waits):
        obs.histogram("multihost_barrier_wait_seconds",
                      rank=str(r)).observe(waits[r])
    return entry


def barrier_ledger() -> list[dict]:
    with _state.lock:
        return list(_state.ledger)


def _quantile(xs: list[float], q: float) -> float:
    s = sorted(xs)
    return float(s[min(len(s) - 1, int(round(q * (len(s) - 1))))])


def straggler_summary(tail: int = 8) -> dict:
    """The ``/cluster`` straggler block: who gates, by how much,
    and each rank's wait distribution."""
    with _state.lock:
        entries = list(_state.ledger)
        gating = dict(_state.gating_counts)
    per_rank: dict[str, list[float]] = {}
    for e in entries:
        for r, w in e["waits_s"].items():
            per_rank.setdefault(r, []).append(w)
    top = max(gating, key=lambda r: gating[r]) if gating else None
    return {
        "barriers": len(entries),
        "gating_counts": {str(r): gating[r] for r in sorted(gating)},
        "top_gating_rank": top,
        "worst_gate_margin_s": max(
            (e["gate_margin_s"] for e in entries), default=0.0),
        "per_rank_wait_s": {
            r: {"p50": _quantile(ws, 0.5), "p95": _quantile(ws, 0.95),
                "max": max(ws)}
            for r, ws in sorted(per_rank.items())},
        "recent": entries[-int(tail):],
    }


# ---------------------------------------------------------------------------
# cluster SLO pack
# ---------------------------------------------------------------------------

def cluster_slo_pack() -> list:
    """Cluster-scoped objectives, judged on rank 0 over the FOLDED
    registry (local + piggybacked/rolled-up peer series)."""
    return [
        _slo.spec("cluster_round_floor",
                  "multihost_rounds_committed_total", "rate_min", 0.01,
                  description="cluster commits rounds at all: floor on "
                              "committed rounds/sec across the window"),
        _slo.spec("cluster_barrier_wait_p95",
                  "multihost_barrier_wait_seconds", "quantile_max", 2.5,
                  q=0.95,
                  description="straggler budget: p95 of per-rank commit-"
                              "barrier waits (the ledger's histogram)"),
        _slo.spec("cluster_view_change_p95",
                  "multihost_view_change_seconds", "quantile_max", 5.0,
                  q=0.95,
                  description="membership repair latency: p95 of view-"
                              "change (eviction -> survivors re-tasked)"),
        _slo.spec("cluster_no_rank_deaths",
                  "multihost_rank_deaths_total", "delta_max", 0.0,
                  description="zero rank deaths in the window (any "
                              "eviction breaches, naming the rank)"),
    ]


def _dead_ranks() -> list[str]:
    dead = []
    for m in obs.registry().metrics():
        if m.name != "multihost_rank_deaths_total":
            continue
        labels = dict(m.labels)
        if "rank" in labels and m.value > 0:
            dead.append(labels["rank"])
    return sorted(set(dead))


def attribution() -> dict:
    """Who to blame: dead ranks from the death counters, the dominant
    gating rank from the ledger, and each rank's wait p95."""
    summary = straggler_summary(tail=0)
    return {
        "dead_ranks": _dead_ranks(),
        "gating_rank": summary["top_gating_rank"],
        "gating_counts": summary["gating_counts"],
        "per_rank_wait_p95_s": {
            r: s["p95"] for r, s in summary["per_rank_wait_s"].items()},
    }


def cluster_slo_report() -> Optional[dict]:
    """Evaluate the cluster pack (rank 0 only; None elsewhere) and
    attach the attribution block.  A breached evaluation routes
    through the coordinated-dump chokepoint so every survivor
    snapshots the incident."""
    with _state.lock:
        eng = _state.engine
    if eng is None:
        return None
    eng.evaluate()
    rep = eng.report()
    rep["scope"] = "cluster"
    rep["attribution"] = attribution()
    if rep.get("breached"):
        maybe_coordinated_dump(
            "cluster_slo:" + ",".join(sorted(rep["breached"])))
    return rep


# ---------------------------------------------------------------------------
# coordinated incident dumps
# ---------------------------------------------------------------------------

def maybe_coordinated_dump(reason: str) -> bool:
    """THE coordinator-side incident chokepoint: one throttle window
    covering view changes, rank deaths, and SLO breaches.  Fires a
    local flight dump plus the registered channel broadcaster (the
    channel's DUMP frame) so every surviving rank snapshots the
    same window.  No-op (False) when telemetry is off — no obs dir
    means no artifact to write and no extra wire frames."""
    if not telemetry_enabled():
        return False
    now = time.monotonic()
    with _state.lock:
        if now - _state.last_dump < DUMP_MIN_INTERVAL_S:
            return False
        _state.last_dump = now
        bc = _state.broadcaster
    obs.counter("multihost_coordinated_dumps_total").inc()
    obs.dump_flight(f"coordinated:{reason}")
    if bc is not None:
        try:
            bc(str(reason))
        except Exception:
            log.warning("cluster observatory: dump broadcast failed",
                        exc_info=True)
    return True


# ---------------------------------------------------------------------------
# reports + export
# ---------------------------------------------------------------------------

def _top_counters(n: int = 10) -> list[dict]:
    rows = []
    for m in obs.registry().metrics():
        if not isinstance(m, _metrics.Counter):
            continue
        rows.append({"name": m.name, "labels": dict(m.labels),
                     "value": m.value})
    rows.sort(key=lambda r: -r["value"])
    return rows[:n]


def _epoch_by_rank() -> dict[int, float]:
    out: dict[int, float] = {}
    for m in obs.registry().metrics():
        if m.name != "multihost_epoch":
            continue
        labels = dict(m.labels)
        if "rank" in labels:
            try:
                out[int(labels["rank"])] = m.value
            except (TypeError, ValueError):
                continue
    return out


def cluster_report() -> dict:
    """The ``/cluster`` endpoint document: per-rank liveness (heartbeat
    age), telemetry freshness (last-fold age), epoch, the straggler
    summary, the cluster SLO view, and the hottest counters."""
    now = time.monotonic()
    st = _state
    with st.lock:
        rank, world, elastic = st.rank, st.world, st.elastic
        hb = dict(st.hb_last)
        folds = dict(st.fold_last)
        eng = st.engine
    epochs = _epoch_by_rank()
    known = set(hb) | set(folds) | set(epochs)
    if rank is not None:
        known.add(rank)
    ranks = {}
    for r in sorted(known):
        hb_age = (now - hb[r]) if r in hb else None
        fold_age = (now - folds[r]) if r in folds else None
        ranks[str(r)] = {
            "self": r == rank,
            "alive": (r == rank
                      or (hb_age is not None
                          and hb_age < LIVENESS_STALE_S)),
            "last_heartbeat_age_s": hb_age,
            "last_fold_age_s": fold_age,
            "epoch": epochs.get(r),
        }
    doc = {
        "scope": scope(),
        "rank": rank,
        "world": world,
        "elastic": elastic,
        "ranks": ranks,
        "straggler": straggler_summary(),
        "top_counters": _top_counters(),
    }
    if eng is not None:
        slo_doc = eng.report()
        slo_doc["scope"] = "cluster"
        doc["slo"] = slo_doc
    return doc


def export_dir(path) -> None:
    """Write barrier_ledger.json next to the other obs artifacts
    (obs.export calls this); silent no-op with an empty ledger."""
    entries = barrier_ledger()
    if not entries:
        return
    doc = {"schema": 1, "rank": _state.rank,
           "summary": straggler_summary(), "entries": entries}
    import os
    with open(os.path.join(str(path), "barrier_ledger.json"), "w",
              encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
