"""Profiling and transfer accounting (port of fedml_tpu/utils/profiling.py).

`trace(dir)` records a ``torch.profiler`` trace of the block (host and, on
the card, CUDA activity) as a Chrome trace in `dir`; `annotate(name)`
scopes a named region inside it (``record_function``).  `StepTimer` gives
the reference-style wall-clock numbers (rounds/sec, per-phase means)
without any profiler.  `TransferOverlapStats` is the streaming engines'
upload-against-compute accounting, written through to the obs registry.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Iterator, Optional

import torch

from fedml_tpu_torch import obs


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """``torch.profiler`` trace of everything inside the block, written to
    `log_dir` as a Chrome trace (CUDA activity too when a card is there)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.chrome.json"))


def annotate(name: str):
    """Named region inside a trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Accumulates wall-clock per named phase; call ``stop`` after a device
    synchronize for honest device timings."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def mean(self, name: str) -> float:
        return self.totals[name] / max(self.counts[name], 1)

    def report(self) -> dict[str, float]:
        return {f"{k}_mean_s": self.mean(k) for k in self.totals}


def _overlap_fraction(upload_wall: float, wait_wall: float) -> float:
    """Fraction of the upload wall that hid behind compute; 1.0 when there
    were no uploads (nothing left unhidden)."""
    if upload_wall <= 0.0:
        return 1.0
    return max(0.0, min(1.0, (upload_wall - wait_wall) / upload_wall))


class TransferOverlapStats:
    """Host-to-device transfer against compute, for the streaming and
    block-streamed engine paths.

    Producers (whichever thread gathers, casts and copies) time each upload
    with `uploading()`; the round loop times its blocking waits with
    `waiting()` and brackets each round with `round_start()`/`round_end()`.
    Per round (and cumulatively since `reset()`):

        upload_wall_s     sum of the upload calls' walls, any thread
        wait_wall_s       wall the round loop spent blocked on uploads
        round_wall_s      wall of the whole round
        compute_wall_s    round_wall_s - wait_wall_s
        overlap_fraction  (upload_wall - wait_wall) / upload_wall in [0, 1]

    Uploads are attributed to the round window they occur in by wall time.
    Thread-safe; two perf_counter calls an event, so it is always on.
    Every event writes through to the shared ``engine_*`` counters and
    histograms of the obs registry; the instance keeps its own cumulative
    view too, so one engine's `reset()` never touches another's."""

    def __init__(self):
        self._lock = threading.Lock()
        self._m_upload_total = obs.counter("engine_upload_wall_seconds_total")
        self._m_wait_total = obs.counter("engine_wait_wall_seconds_total")
        self._m_rounds = obs.counter("engine_rounds_total")
        self._h_upload = obs.histogram("engine_upload_wall_seconds")
        self._h_wait = obs.histogram("engine_wait_wall_seconds")
        self._h_round = obs.histogram("engine_round_wall_seconds")
        self._h_overlap = obs.histogram(
            "engine_round_overlap_fraction",
            buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0))
        self._m_h2d_bytes = obs.counter("engine_h2d_bytes_total")
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._upload_wall = 0.0
            self._wait_wall = 0.0
            self._h2d_bytes = 0
            self._round_t0: Optional[float] = None
            self._snap = (0.0, 0.0, 0)
            self.rounds: list[dict] = []

    def add_h2d_bytes(self, nbytes: int) -> None:
        """Record host-to-device payload bytes (any thread)."""
        n = int(nbytes)
        with self._lock:
            self._h2d_bytes += n
        self._m_h2d_bytes.inc(n)

    @property
    def h2d_bytes(self) -> int:
        with self._lock:
            return self._h2d_bytes

    @contextlib.contextmanager
    def uploading(self) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._upload_wall += dt
            self._m_upload_total.inc(dt)
            self._h_upload.observe(dt)

    @contextlib.contextmanager
    def waiting(self) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._wait_wall += dt
            self._m_wait_total.inc(dt)
            self._h_wait.observe(dt)

    def round_start(self) -> None:
        """Open a round window (auto-closes a window left open)."""
        if self._round_t0 is not None:
            self.round_end()
        with self._lock:
            self._snap = (self._upload_wall, self._wait_wall,
                          self._h2d_bytes)
        self._round_t0 = time.perf_counter()

    def round_end(self) -> Optional[dict]:
        """Close the open round window and record it; no-op when none is
        open."""
        if self._round_t0 is None:
            return None
        wall = time.perf_counter() - self._round_t0
        self._round_t0 = None
        with self._lock:
            up = self._upload_wall - self._snap[0]
            wait = self._wait_wall - self._snap[1]
            h2d = self._h2d_bytes - self._snap[2]
        rec = {"round_wall_s": wall, "upload_wall_s": up,
               "wait_wall_s": wait,
               "compute_wall_s": max(wall - wait, 0.0),
               "overlap_fraction": _overlap_fraction(up, wait),
               "h2d_bytes": h2d}
        self.rounds.append(rec)
        self._m_rounds.inc()
        self._h_round.observe(wall)
        self._h_overlap.observe(rec["overlap_fraction"])
        return rec

    def overlap_fraction(self) -> float:
        with self._lock:
            return _overlap_fraction(self._upload_wall, self._wait_wall)

    def report(self) -> dict:
        with self._lock:
            up, wait = self._upload_wall, self._wait_wall
            h2d = self._h2d_bytes
        return {"upload_wall_s": up, "wait_wall_s": wait,
                "overlap_fraction": _overlap_fraction(up, wait),
                "h2d_bytes": h2d, "rounds": len(self.rounds)}
