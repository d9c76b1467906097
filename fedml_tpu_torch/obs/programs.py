"""Per-program-family profile registry: live attribution of dispatches,
host walls, device stream time, first-use builds and FLOPs to the round
families the engines run (port of fedml_tpu/obs/programs.py).

The JAX package wraps each jitted round program; the port's engines run
eager PyTorch on the card, so a "program" here is one engine round
function, and its family is the JAX package's name for the same round
(``fedavg_streaming`` for MeshFedAvgEngine, ``fedavg_resident`` for
FedAvgEngine, ``hierarchical``, ...; obs/timeline.py maps each to a
stage).

* ``instrument(family, fn)`` wraps a round function so every dispatch
  counts (``program_dispatches_total{family}``) and times its host wall
  (``program_dispatch_seconds{family}`` on the sub-ms canonical ladder),
  under the JAX package's names.  Attribute access passes through to the
  wrapped function, and the wrapper never touches values: results are
  bitwise the same with it or without it;
* while a wrapped function runs, its family is the thread's CURRENT
  family.  The JAX facade's compile listener reads it to attribute
  compiles; eager PyTorch compiles nothing, and the port counts the
  first-use builds of its native libraries instead (the CUDA kernels'
  and the native transport's: ``obs.note_kernel_build``, read into
  ``kernel_build_total`` / ``kernel_build_seconds_total``, unlabelled
  and ``{family}``-attributed);
* **device time.**  When a dispatch's arguments live on a CUDA device,
  the wrapper records a ``torch.cuda.Event`` pair on that device's
  current stream around the call.  The pairs resolve lazily, in
  ``snapshot()`` and ``report()``, never in the dispatch path, which
  adds no synchronize: it only enqueues the two events.  A family's
  ``stream_s`` is the STREAM'S ELAPSED TIME between its two events,
  summed over dispatches: from the moment the stream reached the call's
  first work to the moment it finished the call's last, idle gaps
  included (a host-bound round keeps the stream waiting on the host
  inside that window).  It is not the card's busy time; a profiler
  trace gives that;
* a FLOP census joins in: either live (``enable_census()``: the first
  dispatch of each family runs under
  ``torch.utils.flop_counter.FlopCounterMode``, which counts the torch
  ops it dispatches; the round is never run a second time, which would
  draw the clients' generators again) or from a JSON artifact of the
  JAX package's HLO audit shape (``load_census()``).  The live count
  sees torch ops only: the hand-written kernels, launched through
  ctypes, are outside it, and its ``census_source`` says so.

``report(since=snapshot())`` gives per-family dispatch counts, wall
p50/p95, build seconds, stream seconds, flops per dispatch and MFU
against ``peak_flops()`` (``FEDML_PEAK_FLOPS``; None without it: no
constant of another device is carried over).
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Optional

import torch

from fedml_tpu_torch.obs.metrics import quantile_from_cumulative

ENV_CENSUS = "FEDML_OBS_CENSUS"
ENV_PEAK_FLOPS = "FEDML_PEAK_FLOPS"
LIVE_CENSUS_SOURCE = "flop_counter_mode (torch ops; ctypes kernels excluded)"
# event pairs a family holds before the dispatch path resolves the ones
# the stream has passed (query() only: it never waits)
MAX_PENDING_EVENTS = 1024

_lock = threading.Lock()
_families: dict[str, "ProgramFamily"] = {}
_tls = threading.local()
_census_enabled: Optional[bool] = None      # None = resolve env lazily


def _stage_of(family: str) -> str:
    from fedml_tpu_torch.obs.timeline import PROGRAM_FAMILY_STAGES
    return PROGRAM_FAMILY_STAGES.get(family, "other")


class ProgramFamily:
    """Profile state of one program family.  Metric handles re-resolve
    when obs.reset() swapped the registry (identity check per call —
    cheaper than a registry lookup, correct across test resets)."""

    def __init__(self, name: str):
        self.name = name
        self.stage = _stage_of(name)
        self.flops_per_dispatch: Optional[float] = None
        self.bytes_per_dispatch: Optional[float] = None
        self.census_source: Optional[str] = None
        self._reg = None
        self._ctr = None
        self._hist = None
        self._stream = None
        self._events_lock = threading.Lock()
        self._pending: deque = deque()    # (start, end) CUDA event pairs

    def _handles(self):
        from fedml_tpu_torch import obs
        reg = obs.registry()
        if reg is not self._reg:
            # a registry swap means obs.reset() ran: re-enter the family
            # table too, so a pre-reset wrapper's next dispatch shows up
            # in families()/snapshot()/report() again
            with _lock:
                _families.setdefault(self.name, self)
            self._reg = reg
            self._ctr = reg.counter("program_dispatches_total",
                                    family=self.name)
            self._hist = reg.histogram("program_dispatch_seconds",
                                       family=self.name)
            self._stream = reg.counter("program_stream_seconds_total",
                                       family=self.name)
        return self._ctr, self._hist

    def observe_dispatch(self, seconds: float) -> None:
        ctr, hist = self._handles()
        hist.observe(seconds)
        ctr.inc()

    def add_events(self, start, end) -> None:
        """Queue one dispatch's CUDA event pair.  Past the cap, the pairs
        the stream has already passed resolve here (a non-blocking
        query); the rest wait for resolve()."""
        with self._events_lock:
            self._pending.append((start, end))
            if len(self._pending) > MAX_PENDING_EVENTS:
                self._resolve_locked(wait=False)

    def resolve(self) -> None:
        """Add every queued pair's elapsed stream time to
        ``program_stream_seconds_total{family}``, waiting for the events
        the stream has not reached yet (the report path, never the
        dispatch path)."""
        with self._events_lock:
            self._resolve_locked(wait=True)

    def _resolve_locked(self, wait: bool) -> None:
        total = 0.0
        while self._pending:
            start, end = self._pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                break
            self._pending.popleft()
            total += start.elapsed_time(end) / 1e3
        if total:
            self._handles()
            self._stream.inc(total)

    def attach_census(self, flops: Optional[float] = None,
                      bytes_accessed: Optional[float] = None,
                      source: str = "attached") -> None:
        if flops is not None:
            self.flops_per_dispatch = float(flops)
        if bytes_accessed is not None:
            self.bytes_per_dispatch = float(bytes_accessed)
        self.census_source = source


def register(family: str) -> ProgramFamily:
    with _lock:
        fam = _families.get(family)
        if fam is None:
            fam = _families[family] = ProgramFamily(family)
        return fam


def families() -> dict[str, ProgramFamily]:
    with _lock:
        return dict(_families)


def current() -> Optional[str]:
    """The family whose wrapped function is executing on THIS thread (the
    build counters' attribution source), or None."""
    return getattr(_tls, "family", None)


def reset() -> None:
    """Test hook (obs.reset() calls through): fresh family table +
    cleared thread-local.  Wrappers built before the reset re-register
    their family on next dispatch."""
    with _lock:
        _families.clear()
    _tls.family = None


# -- census ------------------------------------------------------------------

def enable_census(on: bool = True) -> None:
    global _census_enabled
    _census_enabled = bool(on)


def census_enabled() -> bool:
    global _census_enabled
    if _census_enabled is None:
        _census_enabled = os.environ.get(ENV_CENSUS, "") not in ("", "0")
    return _census_enabled


def load_census(report: Any) -> int:
    """Join a census artifact (path or loaded dict, the JAX package's
    hlo_copy_audit shape: {"families": {family: {"programs": {name:
    {"flops", "bytes_accessed"}}}}}) into the registry: per family,
    flops/bytes summed over the family's programs.  Returns how many
    families gained census numbers."""
    import json
    if isinstance(report, str):
        with open(report) as f:
            report = json.load(f)
    n = 0
    for family, doc in (report.get("families") or {}).items():
        progs = doc.get("programs") or {}
        flops = [p.get("flops") for p in progs.values()
                 if p.get("flops") is not None]
        nbytes = [p.get("bytes_accessed") for p in progs.values()
                  if p.get("bytes_accessed") is not None]
        if not flops and not nbytes:
            continue
        register(family).attach_census(
            flops=sum(flops) if flops else None,
            bytes_accessed=sum(nbytes) if nbytes else None,
            source="hlo_copy_audit")
        n += 1
    return n


def peak_flops() -> Optional[float]:
    """Peak-FLOP/s denominator for MFU: FEDML_PEAK_FLOPS when set (a run
    on a card sets its part's published rate for the dtype it computes
    in), else None — the MFU fields then stay null."""
    env = os.environ.get(ENV_PEAK_FLOPS)
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    return None


# -- the dispatch wrapper ----------------------------------------------------

def _cuda_device(args, kwargs):
    """The CUDA device of the first tensor among the arguments and the
    values of their dicts, lists and tuples (one level down), or None."""
    stack = list(args) + list(kwargs.values())
    for depth in (0, 1):
        nxt = []
        for a in stack:
            if isinstance(a, torch.Tensor):
                return a.device if a.is_cuda else None
            if depth == 0 and isinstance(a, dict):
                nxt.extend(a.values())
            elif depth == 0 and isinstance(a, (list, tuple)):
                nxt.extend(a)
        stack = nxt
    return None


class InstrumentedProgram:
    """Transparent wrapper around one round function: counts and times
    each dispatch, marks the thread's current family, records a CUDA
    event pair around a dispatch on the card, and (census mode) counts
    the first dispatch's FLOPs.  Every other attribute delegates to the
    wrapped function."""

    __slots__ = ("_fn", "_family", "_census_tried")

    def __init__(self, fn, family: ProgramFamily):
        self._fn = fn
        self._family = family
        self._census_tried = False

    @property
    def inner(self):
        return self._fn

    @property
    def family(self) -> str:
        return self._family.name

    def __call__(self, *args, **kwargs):
        fam = self._family
        census = (not self._census_tried and fam.flops_per_dispatch is None
                  and census_enabled())
        device = _cuda_device(args, kwargs)
        events = None
        if device is not None:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            stream = torch.cuda.current_stream(device)
            events[0].record(stream)
        prev = getattr(_tls, "family", None)
        _tls.family = fam.name
        t0 = time.perf_counter()
        try:
            if census:
                return self._counted(args, kwargs)
            return self._fn(*args, **kwargs)
        finally:
            dt = time.perf_counter() - t0
            if events is not None:
                events[1].record(stream)
                fam.add_events(*events)
            _tls.family = prev
            fam.observe_dispatch(dt)

    def _counted(self, args, kwargs):
        """The dispatch itself under FlopCounterMode: one run, so every
        generator the round draws from advances exactly as without the
        census."""
        from torch.utils.flop_counter import FlopCounterMode
        self._census_tried = True
        counter = FlopCounterMode(display=False)
        with counter:
            out = self._fn(*args, **kwargs)
        self._family.attach_census(flops=float(counter.get_total_flops()),
                                   source=LIVE_CENSUS_SOURCE)
        return out

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __repr__(self):
        return (f"InstrumentedProgram({self._family.name}, "
                f"{self._fn!r})")


def instrument(family: str, fn) -> InstrumentedProgram:
    """Wrap one round function under `family`.  An already-instrumented
    fn is re-tagged, not double-wrapped (double timing would inflate the
    family's dispatch walls)."""
    if isinstance(fn, InstrumentedProgram):
        fn = fn.inner
    return InstrumentedProgram(fn, register(family))


# -- windowed reporting ------------------------------------------------------

def snapshot() -> dict:
    """Opaque window baseline for report(since=...): per-family dispatch
    counts, histogram cumulative states, build and stream seconds, and a
    wall-clock stamp.  Resolves the families' queued CUDA event pairs
    first (it may wait for the card)."""
    from fedml_tpu_torch import obs
    reg = obs.registry()
    state: dict = {"t": time.perf_counter(), "families": {}}
    for name, fam in families().items():
        fam.resolve()
        ctr = reg.counter("program_dispatches_total", family=name)
        hist = reg.histogram("program_dispatch_seconds", family=name)
        state["families"][name] = {
            "dispatches": ctr.value,
            "cumulative": hist.cumulative(),
            "wall": hist.sum,
            "build_seconds": reg.counter("kernel_build_seconds_total",
                                         family=name).value,
            "stream_seconds": reg.counter("program_stream_seconds_total",
                                          family=name).value,
        }
    return state


def report(since: Optional[dict] = None, *,
           peak: Optional[float] = None,
           publish_gauges: bool = True) -> dict:
    """Per-family profile over the window since `since` (a snapshot();
    None = since process start / family registration).  Returns

        {"window_s", "peak_flops", "families": [
            {family, stage, dispatches, dispatch_wall_s,
             dispatch_p50_s, dispatch_p95_s, compile_seconds,
             flops_per_dispatch, bytes_per_dispatch, flops_total,
             bytes_total, mfu, census_source, stream_s}, ...],
         "processes": [...],        # per-process rows of origin-labeled
                                    # merged series
         "total": {...}}            # the whole-run row

    The JAX package's fields, with ``compile_seconds`` reading the
    family's first-use build seconds (``kernel_build_seconds_total``),
    plus ``stream_s``: the family's summed stream time between each
    dispatch's CUDA event pair (elapsed time, idle gaps included — see
    the module docstring), 0.0 for a family that never ran on the card.
    Resolves the queued event pairs first (it may wait for the card).
    MFU = flops_total / (window_s x peak_flops) — null without census
    numbers or a peak.  `publish_gauges` mirrors the rows into
    ``program_mfu{family}`` / ``program_bytes_moved_total{family}``
    gauges."""
    from fedml_tpu_torch import obs
    reg = obs.registry()
    if peak is None:
        peak = peak_flops()
    t0 = (since or {}).get("t")
    window_s = (time.perf_counter() - t0) if t0 is not None else None
    prev = (since or {}).get("families", {})
    rows = []
    for name, fam in sorted(families().items()):
        fam.resolve()
        ctr = reg.counter("program_dispatches_total", family=name)
        hist = reg.histogram("program_dispatch_seconds", family=name)
        p = prev.get(name, {})
        dispatches = ctr.value - p.get("dispatches", 0.0)
        wall = hist.sum - p.get("wall", 0.0)
        before = p.get("cumulative")
        after = hist.cumulative()
        if dispatches <= 0:
            continue                 # idle family: not in this window
        flops_total = (fam.flops_per_dispatch * dispatches
                       if fam.flops_per_dispatch is not None else None)
        bytes_total = (fam.bytes_per_dispatch * dispatches
                       if fam.bytes_per_dispatch is not None else None)
        mfu = None
        if (flops_total is not None and peak and window_s
                and window_s > 0):
            mfu = flops_total / (window_s * peak)
        build_s = (reg.counter("kernel_build_seconds_total",
                               family=name).value
                   - p.get("build_seconds", 0.0))
        stream_s = (reg.counter("program_stream_seconds_total",
                                family=name).value
                    - p.get("stream_seconds", 0.0))
        rows.append({
            "family": name,
            "stage": fam.stage,
            "dispatches": int(dispatches),
            "dispatch_wall_s": round(wall, 6),
            "dispatch_p50_s": quantile_from_cumulative(before, after, 0.5),
            "dispatch_p95_s": quantile_from_cumulative(before, after,
                                                       0.95),
            "compile_seconds": round(build_s, 4),
            "flops_per_dispatch": fam.flops_per_dispatch,
            "bytes_per_dispatch": fam.bytes_per_dispatch,
            "flops_total": flops_total,
            "bytes_total": bytes_total,
            "mfu": (round(mfu, 6) if mfu is not None else None),
            "census_source": fam.census_source,
            "stream_s": round(stream_s, 6),
        })
        if publish_gauges:
            if mfu is not None:
                obs.gauge("program_mfu", family=name).set(mfu)
            if bytes_total is not None:
                obs.gauge("program_bytes_moved_total",
                          family=name).set(bytes_total)
    total_flops = [r["flops_total"] for r in rows
                   if r["flops_total"] is not None]
    total_bytes = [r["bytes_total"] for r in rows
                   if r["bytes_total"] is not None]
    total_mfu = None
    if total_flops and peak and window_s and window_s > 0:
        total_mfu = sum(total_flops) / (window_s * peak)
    total = {
        "dispatches": sum(r["dispatches"] for r in rows),
        "dispatch_wall_s": round(sum(r["dispatch_wall_s"]
                                     for r in rows), 6),
        "flops_total": sum(total_flops) if total_flops else None,
        "bytes_total": sum(total_bytes) if total_bytes else None,
        "mfu": (round(total_mfu, 6) if total_mfu is not None else None),
    }
    if publish_gauges and total_mfu is not None:
        obs.gauge("program_mfu", family="_total").set(total_mfu)
    return {
        "window_s": (round(window_s, 3) if window_s is not None
                     else None),
        "peak_flops": peak,
        "families": rows,
        "processes": _per_process_rows(reg),
        "total": total,
    }


def _per_process_rows(reg) -> list:
    """Per-process breakdown: a multi-process run folds each rank's
    metric deltas into rank 0's registry under an ``origin`` label
    (``MetricsRegistry.merge_delta``); these rows surface the merged
    per-family dispatch series per origin.  All-time, not windowed: the
    fold happens once at run end, so a window baseline taken mid-run has
    nothing to subtract."""
    from fedml_tpu_torch.obs.metrics import MERGE_ORIGIN_LABEL
    counts: dict[tuple, float] = {}
    hists: dict[tuple, object] = {}
    for m in reg.metrics():
        labels = dict(m.labels)
        fam = labels.get("family")
        org = labels.get(MERGE_ORIGIN_LABEL)
        if fam is None or org is None:
            continue
        if m.name == "program_dispatches_total":
            counts[(fam, org)] = m.value
        elif m.name == "program_dispatch_seconds":
            hists[(fam, org)] = m
    rows = []
    for (fam, org) in sorted(counts):
        row = {"family": fam, "process": org,
               "dispatches": int(counts[(fam, org)]),
               "dispatch_wall_s": None, "dispatch_p50_s": None,
               "dispatch_p95_s": None}
        h = hists.get((fam, org))
        if h is not None:
            after = h.cumulative()
            row.update(
                dispatch_wall_s=round(h.sum, 6),
                dispatch_p50_s=quantile_from_cumulative(None, after,
                                                        0.5),
                dispatch_p95_s=quantile_from_cumulative(None, after,
                                                        0.95))
        rows.append(row)
    return rows


def format_table(rep: dict) -> str:
    """Human-readable per-family table."""
    lines = [f"{'family':<24}{'stage':<8}{'disp':>8}{'wall s':>10}"
             f"{'stream s':>10}{'p95 ms':>9}{'GFLOP/disp':>12}{'MFU':>8}"]
    for r in rep["families"]:
        gf = (f"{r['flops_per_dispatch'] / 1e9:.3f}"
              if r["flops_per_dispatch"] is not None else "-")
        mfu = f"{r['mfu']:.2%}" if r["mfu"] is not None else "-"
        lines.append(
            f"{r['family']:<24}{r['stage']:<8}{r['dispatches']:>8}"
            f"{r['dispatch_wall_s']:>10.3f}{r['stream_s']:>10.3f}"
            f"{r['dispatch_p95_s'] * 1e3:>9.2f}{gf:>12}{mfu:>8}")
    t = rep["total"]
    mfu = f"{t['mfu']:.2%}" if t["mfu"] is not None else "-"
    lines.append(f"{'TOTAL':<24}{'':<8}{t['dispatches']:>8}"
                 f"{t['dispatch_wall_s']:>10.3f}{'':>10}{'':>9}{'':>12}"
                 f"{mfu:>8}")
    return "\n".join(lines)
