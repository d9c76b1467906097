"""Update admission pipeline (port of fedml_tpu/async_/defense.py).

The gate at the async server's ONE insert path (``AsyncServerManager.
_ingest_row`` and the scheduler's arrival handler): every uplink row
passes, in order,

    1. finite canary      NaN/Inf anywhere in the row quarantines it (one
                          poisoned fold is irreversible: the streaming
                          accumulator has no undo);
    2. norm-bound clip    the update delta (row − g) is clipped to
                          ``norm_bound`` through the shared clip factor
                          (core/pytree.clip_scale);
    3. anomaly screen     a one-sided robust z-score of the delta norm
                          against exponentially weighted running stats of
                          accepted updates, and the cosine of the delta
                          against an EMA of accepted delta directions.  The
                          screen arms after ``screen_warmup`` updates.

On the card the screened fold is two hand-written kernels: Σ(row − g)²
comes from the squared-distance kernel (B.4, ``client_sqnorms``), and an
admitted row is folded by the clipped-fold kernel in its accumulate form
(B.5, ``clip_fold``: acc += w̃·g + w̃·clip·(row − g)).  With no clip
configured the row goes through the plain arrival fold (B.3) unchanged:
the JAX package's "the INPUT row passes through untouched" rule, which
keeps the degenerate-config pin exact.  The z and cosine stages and the
running-reference updates are torch scalar and vector ops on the device.

The JAX package folds ``where(ok, acc + w̃·clipped, acc)`` in one program.
Here the host reads the admit flag before any fold launches: a kernel
computes 0·NaN = NaN, so a quarantined row must never reach one.  The
quarantined row's only launch is its squared distance.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import numpy as np
import torch

from fedml_tpu_torch import obs
from fedml_tpu_torch.async_.staleness import (BUCKET_COMBINE_MODES,
                                              discounted_weight,
                                              flatten_vars_row)
from fedml_tpu_torch.core.pytree import clip_scale
from fedml_tpu_torch.obs import programs as obs_programs
from fedml_tpu_torch.ops.aggregate import client_sqnorms, clip_fold, fold
from fedml_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

QUARANTINE_REASONS = ("nonfinite", "norm_z", "cosine")


@dataclasses.dataclass
class DefenseConfig:
    """Knobs of the admission pipeline and the bucketed robust commit.  The
    degenerate config (buckets=1, trimmed_mean with trim 0, no clip, no
    screen, no DP) reproduces the streaming commit bitwise."""
    norm_bound: Optional[float] = None   # admission clip τ (None = off)
    screen: bool = False                 # z/cosine anomaly screen
    z_max: float = 4.0                   # robust z threshold on ‖Δ‖
    cos_min: float = -1.0                # cosine floor vs ref (-1 = off)
    screen_warmup: int = 8               # accepted updates before arming
    ref_ema: float = 0.1                 # EW rate: direction ref + norm stats
    buckets: int = 1                     # B bucket accumulators
    combine: str = "trimmed_mean"        # mean | trimmed_mean | median
    trim_k: int = 0                      # buckets trimmed per side
    dp_clip: Optional[float] = None      # DP-FedAvg per-client clip S
    dp_noise: float = 0.0                # DP noise multiplier z
    seed: int = 0                        # bucket-assignment seed

    def __post_init__(self):
        if self.combine not in BUCKET_COMBINE_MODES:
            raise ValueError(f"unknown bucket combine {self.combine!r} "
                             f"(choose one of {BUCKET_COMBINE_MODES})")
        if self.buckets < 1:
            raise ValueError(f"buckets must be >= 1, got {self.buckets}")
        if self.dp_noise > 0.0 and self.dp_clip is None:
            raise ValueError("dp_noise needs dp_clip: the DP guarantee "
                             "is calibrated to the per-client clip S")

    @property
    def clip_bound(self) -> Optional[float]:
        """The effective per-client clip: DP's S wins when set, else the
        admission norm bound."""
        return self.dp_clip if self.dp_clip is not None else self.norm_bound

    def active(self) -> bool:
        """Whether any admission stage beyond the finite canary is on."""
        return (self.clip_bound is not None or self.screen
                or self.dp_noise > 0.0)


def make_flatten_fn():
    """Device-side flatten of a variables dict into the buffer's flat-row
    layout (flatten_vars_row): the admission screen compares uplink rows
    against the current global in this layout."""
    return flatten_vars_row


def _make_stage_fn(cfg: DefenseConfig):
    """THE admission stage math, shared by the standalone screen
    (make_admission_fn) and the screened fold (make_screened_fold_fn):

        stages(row, g, ref, n_acc, mu, m2, want_clipped=True)
            -> (clipped, clip, ok, reason, new_ref, new_n, new_mu, new_m2)

    Σd² (d = row − g) is the squared-distance kernel's.  The finite canary
    rides it: any NaN or ±Inf element makes it non-finite.  `clip` is the
    shared clip factor (None with no clip configured, and then `clipped`
    is `row` itself); `clipped` = g + clip·d is built only when asked
    for.  The z test is one-sided against EW (mu, m2) norm stats with a
    10 %-of-mean std floor; the cosine stage (off at cos_min <= -1) reads
    d against the accepted-direction EMA `ref`.  Reason codes index
    QUARANTINE_REASONS + 1 (0 = admitted); the canary outranks z outranks
    cosine.  The norm stats learn from every finite row within the clip
    bound, the direction reference from admitted rows only (the JAX
    package's docstring gives the reasons)."""
    clip_bound = cfg.clip_bound
    z_max = float(cfg.z_max)
    cos_min = float(cfg.cos_min)
    warmup = float(max(1, cfg.screen_warmup))
    ema = float(np.float32(cfg.ref_ema))
    screen = bool(cfg.screen)
    cos_on = screen and cos_min > -1.0

    def stages(row, g, ref, n_acc, mu, m2, want_clipped=True):
        dev = row.device
        true = torch.ones((), dtype=torch.bool, device=dev)
        sq = client_sqnorms(row.reshape(1, -1), g)[0]
        finite = torch.isfinite(sq)
        nd = torch.sqrt(torch.clamp(sq, min=1e-24))
        d = row - g if cos_on or (want_clipped
                                  and clip_bound is not None) else None
        clip = clipped = None
        if clip_bound is not None:
            clip = clip_scale(sq, float(np.float32(clip_bound)))
            teaches = nd <= float(np.float32(clip_bound))
            if want_clipped:
                clipped = g + clip * d
        else:
            teaches = true
            clipped = row
        if screen:
            warm = n_acc >= warmup
            std = torch.sqrt(torch.clamp(m2, min=0.0))
            z = (nd - mu) / torch.maximum(std, 0.1 * mu + 1e-12)
            ok_z = (~warm) | (z <= z_max)
        else:
            ok_z = true
        if cos_on:
            refn = torch.sqrt((ref * ref).sum())
            cos = (d * ref).sum() / (nd * refn + 1e-12)
            ok_cos = (n_acc < warmup) | (cos >= cos_min)
        else:
            ok_cos = true
        ok = finite & ok_z & ok_cos
        one = torch.ones((), dtype=torch.int64, device=dev)
        reason = torch.where(~finite, one, torch.where(
            ~ok_z, 2 * one, torch.where(~ok_cos, 3 * one, 0 * one)))
        teach_stats = finite & teaches
        delta = nd - mu
        incr = ema * delta
        seen = n_acc > 0.0
        mu1 = torch.where(seen, mu + incr, nd)
        m21 = torch.where(seen, (1.0 - ema) * (m2 + delta * incr),
                          torch.zeros_like(m2))
        new_n = torch.where(teach_stats, n_acc + 1.0, n_acc)
        new_mu = torch.where(teach_stats, mu1, mu)
        new_m2 = torch.where(teach_stats, m21, m2)
        if cos_on:
            ref1 = torch.where(seen, (1.0 - ema) * ref + ema * d, d)
            new_ref = torch.where(ok, ref1, ref)
        else:
            new_ref = ref
        return clipped, clip, ok, reason, new_ref, new_n, new_mu, new_m2

    return stages


def make_admission_fn(cfg: DefenseConfig):
    """The standalone admission step:

        admit(row [P], g [P], ref [P], n_acc, mu, m2)
            -> (clipped_row [P], admit_flag, reason_code,
                new_ref, new_n_acc, new_mu, new_m2)

    The stage math is _make_stage_fn's."""
    stages = _make_stage_fn(cfg)

    def admit(row, g, ref, n_acc, mu, m2):
        clipped, _clip, *rest = stages(row, g, ref, n_acc, mu, m2)
        return (clipped, *rest)

    return obs_programs.instrument("async_admission", admit)


def make_screened_fold_fn(cfg: DefenseConfig, staleness_mode: str,
                          staleness_a: float, staleness_b: float):
    """Admission and the streaming fold, the production hot path:

        sfold(acc, wsum, row, g, ref, n_acc, mu, m2, weight, staleness)
            -> (acc', wsum', ok, reason, ref', n', mu', m2')

    The stages run first and the host reads `ok`; only an admitted row is
    folded, in place into `acc`: by the clipped-fold kernel with base w̃
    and factor w̃·clip when a clip is configured, else by the plain
    arrival fold (w̃ = weight·λ(staleness), the arrival fold's λ).  A
    quarantined row leaves acc and wsum bitwise unchanged."""
    stages = _make_stage_fn(cfg)
    clipping = cfg.clip_bound is not None

    def sfold(acc, wsum, row, g, ref, n_acc, mu, m2, weight, staleness):
        _clipped, clip, ok, reason, new_ref, new_n, new_mu, new_m2 = stages(
            row, g, ref, n_acc, mu, m2, want_clipped=False)
        if bool(ok):
            wt = discounted_weight(staleness_mode, staleness_a, staleness_b,
                                   weight, staleness, acc.device)
            V = row.reshape(1, -1)
            if clipping:
                clip_fold(acc, V, g, (wt * clip).contiguous(), wt)
            else:
                fold(acc, V, wt)
            wsum = wsum + wt[0]
        return acc, wsum, ok, reason, new_ref, new_n, new_mu, new_m2

    return obs_programs.instrument("async_screened_fold", sfold)


class UpdateAdmission:
    """Stateful admission gate: the stage math with the running reference,
    the quarantine accounting and the obs wiring.  One instance per
    server; callers serialize under the server lock.

    Staleness-aware: the gate keeps the last `GLOBAL_WINDOW` committed
    globals (flat rows on the device) and screens each uplink against the
    global its sender TRAINED FROM (the echoed dispatch version); older
    versions fall back to the oldest kept global.  The reference state
    lives on `device` (the card unless the caller names another)."""

    GLOBAL_WINDOW = 16

    def __init__(self, cfg: DefenseConfig, p: int, device=None):
        self.cfg = cfg
        self.p = p
        self.device = resolve_device(device)
        self._admit = make_admission_fn(cfg)
        self._sfold = None               # fused hot path, bound lazily
        self._ref = torch.zeros(p, dtype=torch.float32, device=self.device)
        zero = lambda: torch.zeros((), dtype=torch.float32, device=self.device)
        self._n, self._mu, self._m2 = zero(), zero(), zero()
        self._globals: dict[int, torch.Tensor] = {}
        self.accepted = 0
        self.quarantined: dict[str, int] = {}
        self.quarantine_log: list[tuple] = []       # (sender, reason)
        self._m_hist = obs.histogram(
            "defense_screen_seconds",
            buckets=obs.metrics.DECODE_SECONDS_BUCKETS)
        self._m_quar = {
            r: obs.counter("async_updates_quarantined_total", reason=r)
            for r in QUARANTINE_REASONS}

    def _row(self, row) -> torch.Tensor:
        return torch.as_tensor(row, dtype=torch.float32).to(self.device)

    def note_global(self, version: int, global_row) -> None:
        """Record the flat global at `version` (at init and after every
        commit); evicts beyond GLOBAL_WINDOW."""
        self._globals[int(version)] = self._row(global_row)
        while len(self._globals) > self.GLOBAL_WINDOW:
            del self._globals[min(self._globals)]

    def _global_for(self, version: Optional[int]) -> torch.Tensor:
        if version is not None and int(version) in self._globals:
            return self._globals[int(version)]
        if self._globals:
            # older than the window (or unknown): the oldest kept global
            # bounds the drift better than the newest
            return self._globals[min(self._globals)]
        return torch.zeros(self.p, dtype=torch.float32, device=self.device)

    def screen(self, row, global_row=None, sender: int = -1,
               version: Optional[int] = None):
        """Run one row through the pipeline: (admitted, reason — "ok" or a
        QUARANTINE_REASONS entry, clipped_row on the device or None)."""
        g = (self._global_for(version) if global_row is None
             else self._row(global_row))
        t0 = time.perf_counter()
        with obs.span("defense.screen", sender=sender):
            out_row, ok, reason, self._ref, self._n, self._mu, self._m2 = \
                self._admit(self._row(row), g, self._ref, self._n, self._mu,
                            self._m2)
            admitted = bool(ok)
        self._m_hist.observe(time.perf_counter() - t0)
        if admitted:
            self.accepted += 1
            return True, "ok", out_row
        return False, self._quarantine(sender, reason), None

    def _quarantine(self, sender: int, reason) -> str:
        """ONE quarantine-accounting path (counter, reason-labelled obs,
        bounded log, flight-recorder instant)."""
        why = QUARANTINE_REASONS[int(reason) - 1]
        self.quarantined[why] = self.quarantined.get(why, 0) + 1
        if len(self.quarantine_log) < 50_000:
            self.quarantine_log.append((int(sender), why))
        self._m_quar[why].inc()
        obs.instant("defense.quarantine", sender=sender, reason=why)
        log.debug("quarantined update from %s: %s", sender, why)
        return why

    def bind_fold(self, staleness_mode: str, staleness_a: float,
                  staleness_b: float) -> None:
        """Build the screened fold for the buffer's staleness family."""
        self._sfold = make_screened_fold_fn(self.cfg, staleness_mode,
                                            staleness_a, staleness_b)

    def screened_fold(self, acc, wsum, row, weight: float,
                      staleness: float, sender: int = -1,
                      version: Optional[int] = None):
        """Screen `row` and fold its accepted contribution into (acc,
        wsum): (ok, reason, acc', wsum'); on quarantine acc and wsum come
        back unchanged."""
        if self._sfold is None:
            raise RuntimeError("bind_fold() first")
        g = self._global_for(version)
        t0 = time.perf_counter()
        with obs.span("defense.screen", sender=sender):
            (acc1, wsum1, ok, reason, self._ref, self._n, self._mu,
             self._m2) = self._sfold(
                acc, wsum, self._row(row), g, self._ref, self._n, self._mu,
                self._m2, weight, staleness)
            admitted = bool(ok)
        self._m_hist.observe(time.perf_counter() - t0)
        if admitted:
            self.accepted += 1
            return True, "ok", acc1, wsum1
        return False, self._quarantine(sender, reason), acc1, wsum1

    def state(self) -> dict:
        """Checkpointable running-reference snapshot (host numpy), with the
        quarantine counters."""
        return {"ref": self._ref.cpu().numpy().copy(),
                "n_acc": self._n.cpu().numpy().copy(),
                "mu": self._mu.cpu().numpy().copy(),
                "m2": self._m2.cpu().numpy().copy(),
                "accepted": np.asarray(self.accepted, np.int64),
                "quarantined": np.asarray(
                    [self.quarantined.get(r, 0)
                     for r in QUARANTINE_REASONS], np.int64)}

    def load_state(self, state: dict) -> None:
        ref = np.asarray(state["ref"], np.float32)
        if ref.shape != (self.p,):
            raise ValueError(f"admission state shape mismatch: checkpoint "
                             f"ref {ref.shape} vs configured ({self.p},)")
        t = lambda a: torch.tensor(np.asarray(a, np.float32),
                                   device=self.device)
        self._ref, self._n = t(ref), t(state["n_acc"])
        self._mu, self._m2 = t(state["mu"]), t(state["m2"])
        self.accepted = int(state["accepted"])
        if "quarantined" in state:
            counts = np.asarray(state["quarantined"], np.int64)
            self.quarantined = {
                r: int(c) for r, c in zip(QUARANTINE_REASONS, counts)
                if int(c) > 0}

    def report(self) -> dict:
        return {"accepted": self.accepted,
                "quarantined": dict(self.quarantined),
                "quarantined_total": sum(self.quarantined.values())}
