"""Trace-driven arrival processes: the load shapes of a production
federation (port of fedml_tpu/scale/arrivals.py, the same code: it is
numpy only).

A million-device fleet does not upload at a constant rate: participation
follows the day (devices charge and idle overnight: the diurnal sinusoid
every FL deployment paper plots), spikes on events (a push notification
wakes a flash crowd), and in postmortems is replayed from recorded
traces.  This module is the one seeded source of those shapes.  The
connection swarm (comm/connswarm.py) paces its live-socket fleet along
them; the serve simulation and the virtual-time scheduler of the JAX
package read them too, and come to the port with its async slice.

Generators are inhomogeneous Poisson processes sampled by thinning
(Lewis & Shedler): draw candidate gaps at the peak rate, accept with
probability λ(t)/λ_peak.  That is exact for any bounded λ(t), and a pure
function of the seed: identical arrival traces per seed, two seeds
differ, and the same seed gives the JAX package's times bitwise.
`TraceArrivals` replays an explicit timestamp array (or a file of
timestamps) verbatim.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

ARRIVAL_MODES = ("none", "constant", "diurnal", "flash", "trace")


@dataclasses.dataclass
class ArrivalConfig:
    """Knobs of the arrival process (CLI --arrival_*)."""
    mode: str = "none"            # none|constant|diurnal|flash|trace
    rate: float = 100.0           # base arrivals/sec (virtual time)
    period_s: float = 86400.0     # diurnal period
    amplitude: float = 0.8        # diurnal swing in [0, 1)
    flash_at_s: float = 300.0     # flash-crowd onset
    flash_duration_s: float = 60.0
    flash_boost: float = 10.0     # rate multiplier inside the burst
    trace_path: Optional[str] = None   # timestamps, one float per line
    seed: int = 0

    def __post_init__(self):
        if self.mode not in ARRIVAL_MODES:
            raise ValueError(f"unknown arrival mode {self.mode!r} "
                             f"(choose one of {ARRIVAL_MODES})")
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError(f"amplitude must be in [0, 1), got "
                             f"{self.amplitude}")
        if self.rate <= 0.0:
            raise ValueError(f"rate must be > 0, got {self.rate}")


class ArrivalProcess:
    """Base: rate(t) + thinning sampler + the scheduler's slowdown
    factor.  Subclasses define `rate(t)` and `peak_rate`; `seed` (set
    by make_arrivals from ArrivalConfig.seed) seeds `arrivals()` when
    the caller hands no Generator in."""

    peak_rate: float = 1.0
    seed: int = 0

    def rate(self, t: float) -> float:
        raise NotImplementedError

    def rate_fraction(self, t: float) -> float:
        """λ(t) / λ_peak in [0, 1] — the shape of the arrival process
        with its absolute rate divided out.  The connection swarm uses
        this to pace a live-socket fleet along the same diurnal/flash
        profile the virtual-time serve sim replays: offered_rate is
        the fleet's PEAK, and the instantaneous rate follows the
        profile."""
        if self.peak_rate <= 0.0:
            return 0.0
        return max(0.0, min(1.0, self.rate(t) / self.peak_rate))

    def slowdown(self, t: float) -> float:
        """How much slower the fleet responds at virtual time t than at
        peak load: λ_peak / λ(t), floored at 1 (peak = nominal).  The
        scheduler multiplies lifecycle latencies by this — a pure
        function of t, so seeded-determinism pins survive."""
        r = self.rate(t)
        if r <= 0.0:
            return float("inf")
        return max(1.0, self.peak_rate / r)

    def arrivals(self, t0: float = 0.0,
                 rng: Optional[np.random.Generator] = None
                 ) -> Iterator[float]:
        """Yield arrival times > t0, monotonically — the thinning
        sampler.  Deterministic per the generator handed in."""
        rng = rng if rng is not None else np.random.default_rng(self.seed)
        t = float(t0)
        lam = self.peak_rate
        while True:
            t += rng.exponential(1.0 / lam)
            if rng.random() * lam <= self.rate(t):
                yield t


class ConstantArrivals(ArrivalProcess):
    def __init__(self, rate: float):
        self.peak_rate = float(rate)

    def rate(self, t: float) -> float:
        return self.peak_rate


class DiurnalArrivals(ArrivalProcess):
    """λ(t) = base · (1 + a·sin(2πt/period)) — peak base·(1+a),
    trough base·(1−a)."""

    def __init__(self, rate: float, period_s: float, amplitude: float):
        self.base = float(rate)
        self.period = float(period_s)
        self.amplitude = float(amplitude)
        self.peak_rate = self.base * (1.0 + self.amplitude)

    def rate(self, t: float) -> float:
        return self.base * (1.0 + self.amplitude
                            * np.sin(2.0 * np.pi * t / self.period))


class FlashCrowdArrivals(DiurnalArrivals):
    """Diurnal base with a flash-crowd burst: λ multiplied by `boost`
    inside [at, at + duration) — the push-notification stampede."""

    def __init__(self, rate: float, period_s: float, amplitude: float,
                 flash_at_s: float, flash_duration_s: float,
                 flash_boost: float):
        super().__init__(rate, period_s, amplitude)
        self.flash_at = float(flash_at_s)
        self.flash_end = float(flash_at_s) + float(flash_duration_s)
        self.boost = float(flash_boost)
        self.peak_rate = self.base * (1.0 + self.amplitude) * self.boost

    def rate(self, t: float) -> float:
        r = super().rate(t)
        if self.flash_at <= t < self.flash_end:
            r *= self.boost
        return r


class TraceArrivals(ArrivalProcess):
    """Replay an explicit timestamp array verbatim (sorted ascending).
    rate(t) is the empirical rate in a sliding window — only the
    slowdown consumer reads it; `arrivals()` replays exactly."""

    def __init__(self, times, window_s: float = 60.0):
        self.times = np.sort(np.asarray(times, np.float64).reshape(-1))
        if self.times.size == 0:
            raise ValueError("empty arrival trace")
        self.window = float(window_s)
        span = max(float(self.times[-1] - self.times[0]), self.window)
        self.peak_rate = max(self._window_rate(t) for t in self.times)
        self._mean_rate = self.times.size / span

    @classmethod
    def from_file(cls, path: str, **kw) -> "TraceArrivals":
        return cls(np.loadtxt(path, dtype=np.float64, ndmin=1), **kw)

    def _window_rate(self, t: float) -> float:
        lo = np.searchsorted(self.times, t - self.window)
        hi = np.searchsorted(self.times, t, side="right")
        return max(float(hi - lo), 1.0) / self.window

    def rate(self, t: float) -> float:
        if t < self.times[0] or t > self.times[-1]:
            return self._mean_rate
        return self._window_rate(t)

    def arrivals(self, t0: float = 0.0, rng=None) -> Iterator[float]:
        for t in self.times:
            if t > t0:
                yield float(t)


def make_arrivals(cfg: ArrivalConfig) -> Optional[ArrivalProcess]:
    """ArrivalConfig -> process (None for mode 'none'); cfg.seed
    becomes the process's default `arrivals()` stream seed."""
    if cfg.mode == "none":
        return None
    if cfg.mode == "constant":
        proc = ConstantArrivals(cfg.rate)
    elif cfg.mode == "diurnal":
        proc = DiurnalArrivals(cfg.rate, cfg.period_s, cfg.amplitude)
    elif cfg.mode == "flash":
        proc = FlashCrowdArrivals(cfg.rate, cfg.period_s, cfg.amplitude,
                                  cfg.flash_at_s, cfg.flash_duration_s,
                                  cfg.flash_boost)
    elif cfg.trace_path is None:
        raise ValueError("arrival mode 'trace' needs trace_path")
    else:
        proc = TraceArrivals.from_file(cfg.trace_path)
    proc.seed = cfg.seed
    return proc
