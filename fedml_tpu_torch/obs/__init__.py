"""Observability: span tracer, metrics registry and flight recorder (port
of fedml_tpu/obs/__init__.py, the in-process core).

The process-global facade every layer instruments against:

  with obs.span("round", round=r): ...                         # tracing
  obs.counter("comm_sent_bytes_total", backend="tcp").inc(n)   # metrics
  with obs.deadline("round3", 120): ...                        # hang watchdog
  kill -USR1 <pid>                                             # flight dump

Two tiers, by cost:

* **Metrics are always on.**  A counter increment is one lock and one
  float add, so a later `obs.configure()` (or a test reading
  `obs.registry()`) sees the history, not a cold start.
* **Tracing and flight recording are opt-in**, through
  `configure(obs_dir)` or the FEDML_OBS_DIR environment variable
  (`configure_from_env`).  Until then `span()` returns a shared stateless
  no-op and nothing is buffered: the disabled path in an engine's loop is
  a flag check and a constant return.

`configure()` also installs the SIGUSR1 flight-dump handler (main thread
only) and an export at exit, so any run with observability on leaves a
loadable Chrome trace and a Prometheus snapshot behind.  `reset()` turns
it all off again (the tests' hook).  Everything here runs on the host
and reads no tensor: results are bitwise the same with observability on
or off.  The spans time the host; a span around device work measures its
enqueue unless the work ends in a synchronize.

Trace propagation across processes (``propagate.py``) came with the
wire core: the comm managers stamp and strip a trace block on every
frame while tracing is on.  What the JAX package has and the port does
not yet (slice 5b-ii): the jax compile listener (``jit_compile_*``, with
no counterpart in eager PyTorch), the per-program dispatch accounting
(``programs.py``, which becomes CUDA-event timing of the round
families), the timeline analyzer, the SLO engine and the cluster
observatory.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import os
import signal
import threading
import time
from typing import Optional

from fedml_tpu_torch.obs.flight import FlightRecorder, thread_stacks
from fedml_tpu_torch.obs.metrics import (Counter, Gauge, Histogram,
                                         MetricsRegistry)
from fedml_tpu_torch.obs.tracer import NOOP_SPAN, SpanTracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "SpanTracer",
    "FlightRecorder", "configure", "configure_from_env", "enabled",
    "obs_dir", "span", "instant", "counter", "gauge", "histogram",
    "registry", "tracer", "flight", "deadline", "dump_flight", "export",
    "rollup", "sample_device_memory", "reset", "serve_http", "http_server",
    "thread_stacks",
]

ENV_VAR = "FEDML_OBS_DIR"
ENV_HTTP = "FEDML_OBS_HTTP_PORT"
ENV_SPILL = "FEDML_OBS_SPILL"

_lock = threading.Lock()
_registry = MetricsRegistry()
_tracer: Optional[SpanTracer] = None
_flight: Optional[FlightRecorder] = None
_dir: Optional[str] = None
_http = None
_prev_sigusr1 = None
_atexit_registered = False


# -- lifecycle ---------------------------------------------------------------

def enabled() -> bool:
    return _dir is not None


def obs_dir() -> Optional[str]:
    return _dir


def configure(directory: str, *, flight_capacity: int = 4096,
              max_events: int = 200_000, install_signal: bool = True,
              export_at_exit: bool = True,
              spill_events: Optional[bool] = None,
              http_port: Optional[int] = None) -> None:
    """Turn tracing and flight recording on, writing artifacts under
    `directory`.  Configuring again swaps in a fresh tracer and ring
    (events already exported stay on disk).

    `spill_events` (or FEDML_OBS_SPILL=1) streams every span to
    `directory`/trace.spill.jsonl up to a byte cap, keeping the trace's
    head that the ring would evict.  `http_port` (or FEDML_OBS_HTTP_PORT)
    starts the loopback introspection endpoint (obs/httpd.py)."""
    global _tracer, _flight, _dir, _atexit_registered
    os.makedirs(directory, exist_ok=True)
    if spill_events is None:
        spill_events = os.environ.get(ENV_SPILL, "") not in ("", "0")
    with _lock:
        old = _tracer
        _flight = FlightRecorder(capacity=flight_capacity)
        _tracer = SpanTracer(
            max_events=max_events,
            spill_path=(os.path.join(directory, "trace.spill.jsonl")
                        if spill_events else None))
        # dumps read the tracer's tail: spans are not written through to
        # a second ring (that would double the hot path's cost)
        t = _tracer
        _flight.source = lambda: t.tail(flight_capacity)
        _dir = directory
        if export_at_exit and not _atexit_registered:
            _atexit_registered = True
            atexit.register(_atexit_export)
    if old is not None:
        old.close()
    if install_signal:
        _install_sigusr1()
    if http_port is None:
        port = os.environ.get(ENV_HTTP)
        http_port = int(port) if port else None
    if http_port is not None:
        serve_http(http_port)


def configure_from_env() -> bool:
    """Turn observability on from FEDML_OBS_DIR when it is set; no-op if
    already on."""
    d = os.environ.get(ENV_VAR)
    if d and not enabled():
        configure(d)
        return True
    return False


def reset() -> None:
    """Back to the disabled default with a fresh registry, closing the
    tracer's spill and any HTTP endpoint (the tests' hook).  Metric
    handles cached by objects built earlier keep writing to the OLD
    registry: tests reset() before building what they test.  The SIGUSR1
    handler stays installed (it dumps nothing while disabled); a caller
    that wants the old disposition back restores it itself."""
    global _registry, _tracer, _flight, _dir, _http
    with _lock:
        old_tracer, old_http = _tracer, _http
        _registry = MetricsRegistry()
        _tracer = None
        _flight = None
        _dir = None
        _http = None
    if old_tracer is not None:
        old_tracer.close()
    if old_http is not None:
        old_http.close()
    from fedml_tpu_torch.obs import propagate
    propagate.reset_clocks()


# -- tracing -----------------------------------------------------------------

def span(name: str, **attrs):
    """Nestable wall-clock span; the no-op singleton when disabled."""
    t = _tracer
    if t is None:
        return NOOP_SPAN
    return t.span(name, **attrs)


def instant(name: str, **attrs) -> None:
    t = _tracer
    if t is not None:
        t.instant(name, **attrs)


def tracer() -> Optional[SpanTracer]:
    return _tracer


# -- metrics -----------------------------------------------------------------

def registry() -> MetricsRegistry:
    return _registry


def counter(name: str, **labels) -> Counter:
    return _registry.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return _registry.gauge(name, **labels)


def histogram(name: str, buckets=None, **labels) -> Histogram:
    return _registry.histogram(name, buckets=buckets, **labels)


def sample_device_memory() -> None:
    """Live and peak device-memory gauges of the current CUDA device,
    from PyTorch's caching allocator (``memory_allocated``,
    ``max_memory_allocated``); nothing without a card.  Call sites gate on
    `enabled()`: polling each round is pointless when nothing exports the
    result."""
    import torch
    if not torch.cuda.is_available():
        return
    index = torch.cuda.current_device()
    live = torch.cuda.memory_allocated(index)
    gauge("device_bytes_in_use", device=str(index)).set(live)
    gauge("device_peak_bytes_in_use", device=str(index)).set_max(
        torch.cuda.max_memory_allocated(index))


# -- http introspection ------------------------------------------------------

def serve_http(port: int = 0):
    """Start (or return the running) loopback introspection endpoint:
    /metrics, /rollup, /healthz, /flight.  Works with metrics alone;
    /flight answers 503 until configure() arms the recorder.  Returns the
    ObsHttpServer (its `.port` is the bound port: pass 0 for an
    ephemeral one)."""
    global _http
    with _lock:
        if _http is not None:
            if port not in (0, _http.port):
                import sys
                print(f"obs.serve_http: endpoint already on port "
                      f"{_http.port}; ignoring request for {port}",
                      file=sys.stderr)
            return _http
    from fedml_tpu_torch.obs.httpd import ObsHttpServer
    server = ObsHttpServer(port=port)
    with _lock:
        if _http is None:
            _http = server
            return server
    server.close()                    # lost a concurrent-start race
    return _http


def http_server():
    return _http


# -- flight recorder ---------------------------------------------------------

def flight() -> Optional[FlightRecorder]:
    return _flight


def dump_flight(reason: str, extra: Optional[dict] = None) -> Optional[str]:
    """Dump the ring, the thread stacks and a metrics snapshot; returns
    the path (None when disabled)."""
    f, d = _flight, _dir
    if f is None or d is None:
        return None
    payload = {"metrics": _registry.snapshot()}
    if extra:
        payload.update(extra)
    return f.dump(d, reason, extra=payload)


def deadline(tag: str, seconds: Optional[float]):
    """Round-deadline watchdog: a flight dump fires if the with-block
    overruns `seconds`.  No-op when disabled or seconds is None."""
    f, d = _flight, _dir
    if f is None or d is None or seconds is None:
        return contextlib.nullcontext()
    return f.watchdog(seconds, tag, d,
                      extra_fn=lambda: {"metrics": _registry.snapshot()})


def _install_sigusr1() -> None:
    """SIGUSR1 -> flight dump.  Only installable from the main thread (a
    restriction of the signal module); elsewhere the caller keeps its
    current handler."""
    global _prev_sigusr1
    if not hasattr(signal, "SIGUSR1"):       # pragma: no cover - windows
        return

    def _dump_async():
        # settle briefly so the main thread has returned from the handler
        # to wherever it is stuck: the captured stack then shows that
        time.sleep(0.05)
        dump_flight("SIGUSR1")

    def handler(signum, frame):
        # dump from another thread, never inline: the handler runs on the
        # main thread between bytecodes, perhaps while it holds the ring's
        # or a metric's (non-reentrant) lock, and an inline dump would
        # deadlock the process it came to diagnose
        threading.Thread(target=_dump_async, name="obs-sigusr1-dump",
                         daemon=True).start()
        prev = _prev_sigusr1
        if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
            prev(signum, frame)              # pragma: no cover - chained

    handler._fedml_torch_obs = True           # reconfigure: no self-chain
    try:
        prev = signal.signal(signal.SIGUSR1, handler)
    except ValueError:                        # not the main thread
        return
    if not getattr(prev, "_fedml_torch_obs", False):
        _prev_sigusr1 = prev


# -- exporters ---------------------------------------------------------------

def export() -> dict[str, str]:
    """Write every artifact into obs_dir:

        trace.chrome.json   Chrome trace-event file (chrome://tracing,
                            ui.perfetto.dev)
        trace.jsonl         the same spans, one JSON object per line, led
                            by a __meta__ line (pid, epoch, drops)
        metrics.prom        Prometheus text exposition
        metrics.json        JSON metrics snapshot
        clock_offsets.json  the comm managers' peer clock offsets
                            (obs/propagate.py), when any traffic was
                            trace-stamped

    Returns {artifact: path}; {} when disabled."""
    t, d = _tracer, _dir
    if d is None:
        return {}
    out = {}
    if t is not None:
        out["chrome_trace"] = t.export_chrome(
            os.path.join(d, "trace.chrome.json"))
        out["jsonl_trace"] = t.export_jsonl(os.path.join(d, "trace.jsonl"))
    prom = os.path.join(d, "metrics.prom")
    with open(prom, "w") as f:
        f.write(_registry.to_prometheus())
    out["prometheus"] = prom
    mj = os.path.join(d, "metrics.json")
    with open(mj, "w") as f:
        f.write(_registry.to_json())
    out["metrics_json"] = mj
    from fedml_tpu_torch.obs import propagate
    clocks = propagate.clock_exports()
    if clocks:
        cj = os.path.join(d, "clock_offsets.json")
        with open(cj, "w") as f:
            json.dump(clocks, f, indent=1)
        out["clock_offsets"] = cj
    return out


def _atexit_export() -> None:                # pragma: no cover - exit path
    try:
        export()
    except OSError:
        pass


def rollup() -> dict:
    """A small summary for embedding in a result line: where the
    artifacts are, and the span accounting (drops and spills, so that a
    truncated trace never passes for a complete one)."""
    t = _tracer
    return {
        "obs_dir": _dir,
        "spans_recorded": (0 if t is None
                           else len(t.events()) + t.dropped),
        "spans_dropped": 0 if t is None else t.dropped,
        "spans_spilled": 0 if t is None else t.spilled,
        "spill_truncated": 0 if t is None else t.spill_truncated,
        "http_port": None if _http is None else _http.port,
        "flight_dumps": [] if _flight is None else list(_flight.dumps),
    }
