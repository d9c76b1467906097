"""SLO engine: the judgment layer over the always-on metrics registry
(port of fedml_tpu/obs/slo.py, the same code: it never touched JAX).

The federation emits rich raw telemetry (obs/metrics.py); this module
judges it.  It evaluates declarative SLO specs as low-overhead windowed
deltas over the existing :class:`MetricsRegistry`:

* a spec names a metric (name + label subset), an objective kind, a
  target, an evaluation window and a burn budget;
* evaluation reuses the registry's existing collection path — counter
  values and ``Histogram.cumulative()`` snapshots diffed per window,
  percentiles through the ONE shared ``quantile_from_cumulative``
  definition.  No new observation path, no per-event cost: the entire
  engine runs at evaluation time (a handful of snapshot diffs per
  window);
* a breach increments ``slo_breaches_total{slo}``, sets
  ``slo_healthy{slo}`` to 0, fires a THROTTLED flight-recorder dump
  (one per ``dump_min_interval_s`` across all specs — a breach storm
  must not turn the recorder into the incident), and surfaces through
  ``obs.rollup()``, the Prometheus exporter, and the httpd ``/slo``
  endpoint.

Burn budget (the burn-rate idea at windowed-delta granularity): a spec
with ``burn_windows = n`` only FIRES after n consecutive breaching
evaluation windows — transient spikes spend budget, sustained burn
pages.  ``burn_windows = 1`` (the default) fires immediately.

The default pack (:func:`default_slo_pack`) encodes the serving spine's
health contract — committed-updates/sec floor, admission-latency p95,
reactor loop-lag p95, zero quarantines/evictions/sheds, zero
recv-thread deaths.  A clean run is green on it; a run with corrupted
frames breaches ``no_quarantines``.  Specs whose metric a run never
wrote report ``no_data`` and stay healthy.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Optional, Sequence

from fedml_tpu_torch.obs.metrics import (MetricsRegistry,
                                   quantile_from_cumulative)

SLO_KINDS = ("rate_min", "rate_max", "delta_max", "quantile_max",
             "gauge_max")

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One declarative objective over one metric family.

    ``metric`` + ``labels`` select series: every registry series with
    that name whose labels are a SUPERSET of ``labels`` contributes
    (counters/histograms merge across the matching label sets — a
    per-backend counter family evaluates as its federation-wide sum).

    Kinds (all evaluated on the delta since the previous evaluation
    window, except ``gauge_max`` which reads the live value):

        rate_min       counter delta / window_s  >= target
        rate_max       counter delta / window_s  <= target
        delta_max      counter delta              <= target
                       (target 0 == "this must never happen")
        quantile_max   windowed histogram q-quantile <= target
        gauge_max      current gauge value        <= target
    """
    name: str
    metric: str
    kind: str
    target: float
    labels: tuple = ()                  # (("k", "v"), ...) subset match
    q: float = 0.95                     # quantile_max only
    burn_windows: int = 1               # consecutive breaches to fire
    description: str = ""

    def __post_init__(self):
        if self.kind not in SLO_KINDS:
            raise ValueError(f"unknown SLO kind {self.kind!r} "
                             f"(choose one of {SLO_KINDS})")
        if self.burn_windows < 1:
            raise ValueError(
                f"burn_windows must be >= 1, got {self.burn_windows}")
        if self.kind == "quantile_max" and not (0.0 <= self.q <= 1.0):
            raise ValueError(f"q must be in [0, 1], got {self.q}")
        # labels arrive as a dict from callers; freeze to a sorted tuple
        # so the spec stays hashable/dataclass-frozen
        if isinstance(self.labels, dict):
            object.__setattr__(
                self, "labels",
                tuple(sorted((str(k), str(v))
                             for k, v in self.labels.items())))


def spec(name: str, metric: str, kind: str, target: float,
         labels: Optional[dict] = None, **kw) -> SloSpec:
    """Terse constructor (labels as a dict)."""
    return SloSpec(name=name, metric=metric, kind=kind, target=target,
                   labels=tuple(sorted((str(k), str(v))
                                       for k, v in (labels or {}).items())),
                   **kw)


def default_slo_pack() -> list[SloSpec]:
    """The serving spine's default health contract (the JAX package's
    pack, unchanged).

    Every target is green on a clean run, and a faulty one breaches —

    * corrupted frames => ``no_quarantines`` breaches (a wire-level
      quarantine is an incident signal);
    * a connection storm sheds/evicts connections => ``no_evictions`` /
      ``no_sheds`` breach (the admission ceiling sheds by design under
      a storm — the SLO says an operator should LOOK, not that the
      server misbehaved);
    * a wedged server starves commits => ``committed_updates_floor``;
    * ``no_recv_thread_deaths``: a receive thread must never die.

    Latency targets (admission p95, loop-lag p95) are deliberately
    loose operational ceilings (well above the clean arms' sub-ms
    steady state, below a pathological stall) — they page on collapse,
    not on box-load jitter."""
    return [
        spec("committed_updates_floor", "async_updates_committed_total",
             "rate_min", 1.0, burn_windows=3,
             description="the server must keep committing: >= 1 "
                         "update/sec sustained.  burn_windows=3 — a "
                         "single idle window between rounds spends "
                         "budget, three consecutive starved windows "
                         "page"),
        spec("admission_p95", "comm_admission_seconds",
             "quantile_max", 1.0, q=0.95,
             description="transport hand-off -> buffer insert p95 "
                         "under 1 s (clean arms run sub-ms; a stalled "
                         "decode pool or reactor pushes seconds)"),
        spec("reactor_loop_lag_p95", "reactor_loop_lag_seconds",
             "quantile_max", 0.5, q=0.95,
             description="reactor event-loop iterations must not hold "
                         "the loop > 500 ms at p95"),
        spec("no_quarantines", "comm_frames_quarantined_total",
             "delta_max", 0.0,
             description="wire-level quarantines (CRC/undecodable) are "
                         "an incident signal, not steady state"),
        spec("no_update_quarantines", "async_updates_quarantined_total",
             "delta_max", 0.0,
             description="admission-screen quarantines mean an active "
                         "anomaly (attack or drift) — page an operator"),
        spec("no_evictions", "comm_connections_evicted_total",
             "delta_max", 0.0,
             description="stall/rate/shed evictions counted by the "
                         "reactor transport"),
        spec("no_sheds", "comm_uplinks_shed_total", "delta_max", 0.0,
             description="load-shedding engaged — capacity, not "
                         "correctness, but an operator should know"),
        spec("no_recv_thread_deaths", "comm_recv_thread_deaths_total",
             "delta_max", 0.0,
             description="recv-thread deaths == 0, as a standing "
                         "objective"),
    ]


DEFAULT_PACK_NAME = "serving_spine_default"


class SloEngine:
    """Evaluates a pack of :class:`SloSpec` over windowed registry
    deltas.  One instance = one evaluation scope (a run primes a fresh
    engine; a long-running server starts one periodic engine).

    Thread-safe for the intended shapes: `evaluate()` serializes under
    the engine lock; the background `start()` thread is just a caller
    of `evaluate()`."""

    def __init__(self, specs: Sequence[SloSpec],
                 registry: Optional[MetricsRegistry] = None, *,
                 pack_name: str = DEFAULT_PACK_NAME,
                 dump_min_interval_s: float = 30.0):
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names in pack: {names}")
        self.specs = list(specs)
        self.pack_name = pack_name
        self.dump_min_interval_s = float(dump_min_interval_s)
        self._registry = registry          # None = resolve obs.registry()
        self._lock = threading.Lock()
        self._state: dict[str, dict] = {}  # spec -> per-series snapshots
        self._t_prev: Optional[float] = None
        self._last_dump = -float("inf")
        self._breaches = {s.name: 0 for s in self.specs}
        self._burn = {s.name: 0 for s in self.specs}
        self._last = {s.name: {"status": "no_data", "value": None}
                      for s in self.specs}
        self._windows = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- registry access -----------------------------------------------------

    def _reg(self) -> MetricsRegistry:
        if self._registry is not None:
            return self._registry
        from fedml_tpu_torch import obs
        return obs.registry()

    def _matching(self, s: SloSpec) -> list:
        want = set(s.labels)
        out = []
        for m in self._reg().metrics():
            if m.name == s.metric and want.issubset(set(m.labels)):
                out.append(m)
        return out

    def _snapshot(self, s: SloSpec) -> dict:
        """Per-series raw state for the spec's metric family."""
        snap = {}
        for m in self._matching(s):
            key = m.labels
            if m.kind == "histogram":
                snap[key] = m.cumulative()
            else:
                snap[key] = m.value
        return snap

    # -- evaluation ----------------------------------------------------------

    def prime(self) -> None:
        """Open the first evaluation window: snapshot every spec's
        series so the next `evaluate()` measures deltas from HERE, not
        from process birth."""
        with self._lock:
            for s in self.specs:
                self._state[s.name] = self._snapshot(s)
            self._t_prev = time.perf_counter()

    def _measure(self, s: SloSpec, prev: dict, cur: dict,
                 window_s: float):
        """(value, status) for one spec over one window, judged from
        the SAME `cur` snapshot that becomes the next window's baseline
        — an increment landing mid-evaluation is judged either this
        window or the next, never dropped between two reads.  Series
        absent from the registry => ("no_data", healthy): the default
        pack spans subsystems a given run may not exercise.
        Histogram series snapshot as cumulative lists, counters/gauges
        as floats."""
        if not cur:
            return None, "no_data"
        if s.kind == "gauge_max":
            vals = [v for v in cur.values() if not isinstance(v, list)]
            if not vals:
                return None, "no_data"
            value = max(vals)
            return value, ("breach" if value > s.target else "ok")
        if s.kind == "quantile_max":
            # merge windowed deltas across matching series bucket-wise
            # (same canonical ladder per name); a series whose ladder
            # mismatches the first one is skipped with a WARNING — a
            # partially-merged percentile must not pass silently as the
            # federation-wide one
            total_after, total_before = None, None
            for labels, after in cur.items():
                if not isinstance(after, list):
                    continue
                before = prev.get(labels)
                if not isinstance(before, list):
                    before = [(le, 0) for le, _ in after]
                if total_after is None:
                    total_after = [list(x) for x in after]
                    total_before = [list(x) for x in before]
                elif len(after) == len(total_after) and all(
                        a[0] == t[0] for a, t in zip(after, total_after)):
                    for i in range(len(after)):
                        total_after[i][1] += after[i][1]
                        total_before[i][1] += before[i][1]
                else:
                    log.warning(
                        "slo %s: series %s of %s has a different bucket "
                        "ladder — skipped from the merged quantile",
                        s.name, dict(labels), s.metric)
            if total_after is None or (total_after[-1][1]
                                       - total_before[-1][1]) <= 0:
                return None, "no_data"       # empty window: nothing to judge
            value = quantile_from_cumulative(
                [tuple(x) for x in total_before],
                [tuple(x) for x in total_after], s.q)
            return value, ("breach" if value > s.target else "ok")
        # counter kinds
        delta = 0.0
        for labels, v in cur.items():
            if isinstance(v, list):
                continue                     # kind/metric mismatch: skip
            p = prev.get(labels, 0.0)
            delta += v - (0.0 if isinstance(p, list) else float(p))
        if s.kind == "delta_max":
            return delta, ("breach" if delta > s.target else "ok")
        rate = delta / window_s if window_s > 0 else 0.0
        if s.kind == "rate_min":
            return rate, ("breach" if rate < s.target else "ok")
        return rate, ("breach" if rate > s.target else "ok")  # rate_max

    def evaluate(self) -> dict:
        """One evaluation pass over every spec (the window = time since
        prime()/the previous evaluate()).  Fires breach side effects and
        returns the report."""
        from fedml_tpu_torch import obs
        with self._lock:
            now = time.perf_counter()
            if self._t_prev is None:
                # evaluate() without prime(): all-time window (counters
                # since birth) — still well-defined, window = 0 guards
                # the rate division
                self._t_prev = now
            window_s = max(0.0, now - self._t_prev)
            fired = []
            for s in self.specs:
                prev = self._state.get(s.name, {})
                cur = self._snapshot(s)      # ONE read: judged AND kept
                value, status = self._measure(s, prev, cur, window_s)
                if status == "breach":
                    self._burn[s.name] += 1
                    if self._burn[s.name] >= s.burn_windows:
                        self._breaches[s.name] += 1
                        fired.append((s, value))
                else:
                    self._burn[s.name] = 0
                self._last[s.name] = {"status": status, "value": value}
                # the judged snapshot IS the next window's baseline —
                # re-reading the registry here would drop any increment
                # that landed between the two reads from BOTH windows
                self._state[s.name] = cur
                obs.gauge("slo_healthy", slo=s.name).set(
                    0.0 if status == "breach" else 1.0)
                if value is not None:
                    obs.gauge("slo_value", slo=s.name).set(value)
            self._t_prev = now
            self._windows += 1
            want_dump = bool(fired) and (
                now - self._last_dump >= self.dump_min_interval_s)
            if want_dump:
                self._last_dump = now
        for s, value in fired:
            obs.counter("slo_breaches_total", slo=s.name).inc()
            obs.instant("slo.breach", slo=s.name, value=value,
                        target=s.target, window_s=window_s)
        if fired and want_dump:
            # throttled: ONE dump per interval names every spec that
            # fired this pass — a breach storm must not turn the flight
            # recorder into a second incident
            obs.dump_flight(
                "slo_breach:" + ",".join(s.name for s, _ in fired),
                extra={"slo": self.report()})
        return self.report()

    def report(self) -> dict:
        """JSON-able verdict: per-spec status/value/target/breaches +
        the pack rollup (`healthy`, `breaches`, `breached` names) —
        the /slo endpoint's body."""
        with self._lock:
            slos = []
            for s in self.specs:
                last = self._last[s.name]
                slos.append({
                    "name": s.name,
                    "metric": s.metric,
                    "kind": s.kind,
                    "q": s.q if s.kind == "quantile_max" else None,
                    "target": s.target,
                    "value": last["value"],
                    "status": last["status"],
                    "burn": self._burn[s.name],
                    "burn_windows": s.burn_windows,
                    "breaches": self._breaches[s.name],
                })
            breached = [r["name"] for r in slos if r["breaches"] > 0]
            return {
                "pack": self.pack_name,
                "windows_evaluated": self._windows,
                "healthy": not breached,
                "breaches": sum(self._breaches.values()),
                "breached": breached,
                "slos": slos,
            }

    def arm_summary(self) -> dict:
        """Compact verdict of one evaluation scope."""
        r = self.report()
        return {"breaches": r["breaches"], "breached": r["breached"],
                "healthy": r["healthy"]}

    # -- background evaluator ------------------------------------------------

    def start(self, period_s: float = 5.0) -> "SloEngine":
        """Prime + evaluate every `period_s` on a daemon thread.  Also
        installs this engine as the process's active one (the /slo
        endpoint and obs.rollup() read it)."""
        if period_s <= 0:
            raise ValueError(f"period_s must be > 0, got {period_s}")
        if self._thread is not None:
            return self
        self.prime()
        install(self)
        self._stop.clear()

        def loop():
            while not self._stop.wait(period_s):
                try:
                    self.evaluate()
                except Exception:            # pragma: no cover - defensive
                    import logging
                    logging.getLogger(__name__).exception(
                        "slo evaluation failed")

        self._thread = threading.Thread(target=loop, name="obs-slo",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, final_evaluate: bool = True) -> None:
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout=10)
        self._thread = None
        if final_evaluate:
            self.evaluate()


# -- the process's active engine ---------------------------------------------
# One installable engine per process: /slo and obs.rollup() read it.
# Short-lived engines (one run's verdict) need not install.

_active_lock = threading.Lock()
_active: Optional[SloEngine] = None


def install(engine: Optional[SloEngine]) -> None:
    global _active
    with _active_lock:
        _active = engine


def active() -> Optional[SloEngine]:
    return _active


def reset() -> None:
    """Test hook (obs.reset() calls through): drop the active engine."""
    global _active
    with _active_lock:
        eng = _active
        _active = None
    if eng is not None and eng._thread is not None:
        eng._stop.set()
