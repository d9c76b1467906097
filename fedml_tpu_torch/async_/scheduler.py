"""Event-driven async round scheduler, the virtual-time simulation path
(port of fedml_tpu/async_/scheduler.py).

`AsyncFedAvgEngine` simulates a buffered-asynchronous federation
(FedBuff-style: commit on K buffered results or a round deadline;
FedAsync is the K=1 config) over a SIMULATED clock: client latencies,
crashes and rejoins come from the seeded lifecycle model
(async_/lifecycle.py), dispatch order is a deterministic event heap, and
no thread ever sleeps.  The event trace is bitwise the JAX package's for
the same seeds and config (it depends on the lifecycle's numpy draws and
the sampler only).

Clients are handed work in DISPATCH WAVES.  A wave trains its clients one
after another on the engine's device through ``trainer.local_train``,
as ``FedAvgEngine._train_cohort`` does (the JAX engine vmaps the wave):
wave w's clients are a ``sampler.sample_fast(w)`` draw, and lane i trains
with ``client_generator(seed, w, i)``, the generator the sync engine
gives lane i of round w.  The trained rows stay on the device.

The degenerate config — zero latency, zero dropout, buffer_k == cohort,
constant staleness weight, mix 1.0 — equals the port's FedAvgEngine
bitwise: the same cohorts, the same generators, the same rows, and one
finalize launch of the fold kernel over them (the drain commit).
Defended runs stream: each arrival goes through the admission pipeline
into the bucket accumulators (async_/defense.py).
"""
from __future__ import annotations

import dataclasses
import heapq
import logging
import time
from typing import Optional

import numpy as np
import torch

from fedml_tpu_torch import obs
from fedml_tpu_torch.algorithms.fedavg import FedAvgEngine
from fedml_tpu_torch.async_.adversary import (AdversarySim, AttackConfig,
                                              apply_data_attack)
from fedml_tpu_torch.async_.defense import DefenseConfig, UpdateAdmission
from fedml_tpu_torch.async_.lifecycle import ClientLifecycle, LifecycleConfig
from fedml_tpu_torch.async_.staleness import (AsyncBuffer, STALENESS_MODES,
                                              make_bucket_commit_fn,
                                              make_commit_fn)
from fedml_tpu_torch.scale import registry as _reg
from fedml_tpu_torch.scale.arrivals import (ArrivalConfig, ArrivalProcess,
                                            make_arrivals)
from fedml_tpu_torch.scale.registry import ClientRegistry

log = logging.getLogger(__name__)


class AsyncSchedulerDeadlock(RuntimeError):
    """No event can ever arrive and the buffer can never fill: every client
    crashed with no rejoin and no deadline configured.  A flight dump is
    written at raise time."""


# event kinds, in tie-break priority at equal virtual time: arrivals
# before rejoins (a rejoin at the same instant joins the NEXT wave)
_ARRIVE, _REJOIN, _DEADLINE = 0, 1, 2


class AsyncFedAvgEngine(FedAvgEngine):
    """Buffered staleness-aware async FedAvg over a simulated clock, on one
    device (CUDA unless `device` names another).

    One `run()` drives `rounds` COMMITS.  Results are staleness-discounted
    at commit time (staleness.make_commit_fn); `mix` is the FedAsync
    server mixing rate α.  `concurrency` clients are in flight at once;
    freed and rejoined clients are redispatched in waves.  `self.trace`
    records every dispatch/arrival/crash/rejoin/commit with virtual
    timestamps: two engines with equal seeds produce equal traces.
    `shardstore` (anything with ``.cohort(ids) -> (cohort, weights)``)
    supplies cohorts in place of the data's client stack."""

    def __init__(self, trainer, data, cfg, *, buffer_k: Optional[int] = None,
                 concurrency: Optional[int] = None,
                 staleness: str = "constant", staleness_a: float = 0.5,
                 staleness_b: float = 4.0, mix: float = 1.0,
                 round_deadline_s: Optional[float] = None,
                 lifecycle_cfg: Optional[LifecycleConfig] = None,
                 async_seed: Optional[int] = None,
                 attack: Optional[AttackConfig] = None,
                 defense: Optional[DefenseConfig] = None,
                 shardstore=None, arrivals: Optional[object] = None,
                 device=None):
        if staleness not in STALENESS_MODES:
            raise ValueError(f"unknown staleness mode {staleness!r} "
                             f"(choose one of {STALENESS_MODES})")
        # data-level attacks poison the byzantine clients' shards BEFORE
        # the engine takes the data: the attackers then run the honest
        # protocol on hostile data
        self.attack = attack
        self.defense = defense
        self._adversary = None
        if attack is not None and attack.mode != "none":
            self._adversary = AdversarySim(attack, cfg.client_num_in_total)
            data = apply_data_attack(data, attack, self._adversary)
        super().__init__(trainer, data, cfg, device=device)
        self.buffer_k = (buffer_k if buffer_k is not None
                         else cfg.client_num_per_round)
        if self.buffer_k < 1:
            raise ValueError(f"buffer_k must be >= 1, got {self.buffer_k}")
        self.concurrency = (concurrency if concurrency is not None
                            else max(self.buffer_k,
                                     cfg.client_num_per_round))
        if self.concurrency < self.buffer_k:
            raise ValueError(
                f"concurrency ({self.concurrency}) must be >= buffer_k "
                f"({self.buffer_k}): a full buffer needs that many "
                f"results in flight")
        self.staleness_mode = staleness
        self.staleness_a = staleness_a
        self.staleness_b = staleness_b
        self.mix = float(mix)
        self.round_deadline_s = round_deadline_s
        self.lifecycle_cfg = (lifecycle_cfg if lifecycle_cfg is not None
                              else LifecycleConfig(
                                  seed=async_seed if async_seed is not None
                                  else cfg.seed))
        if async_seed is not None:
            self.lifecycle_cfg = dataclasses.replace(self.lifecycle_cfg,
                                                     seed=async_seed)
        self.registry = ClientRegistry(self.sampler.client_num_in_total)
        self._shardstore = shardstore
        if isinstance(arrivals, ArrivalConfig):
            arrivals = make_arrivals(arrivals)
        self._arrivals: Optional[ArrivalProcess] = arrivals
        self._commit_fn = None
        self._admission: Optional[UpdateAdmission] = None
        self._buffer: Optional[AsyncBuffer] = None
        self.version = 0
        self.commits_deadline = 0
        self.trace: list[tuple] = []
        self.staleness_committed: list[float] = []
        self.occupancy_at_commit: list[int] = []
        self._m_occupancy = obs.gauge("async_buffer_occupancy")
        self._m_staleness = obs.histogram(
            "async_staleness", buckets=obs.metrics.STALENESS_BUCKETS)
        self._m_commits = obs.counter("async_commits_total")
        self._m_updates = obs.counter("async_updates_committed_total")
        self._m_dispatches = obs.counter("async_dispatches_total")

    # -- async server state ---------------------------------------------------
    def async_state(self) -> dict:
        """The async server state as host arrays: buffer contents, version
        and the client registry (and, defended, the admission's running
        reference; the bucket accumulators ride the buffer state).  The
        event clock is not part of it: a resumed run restarts the
        lifecycle clock but keeps every buffered result."""
        self._ensure_buffer()
        out = {"buffer": self._buffer.state(),
               "version": np.asarray(self.version, np.int64),
               "registry": self.registry.state()}
        if self._admission is not None:
            out["defense"] = self._admission.state()
        return out

    def load_async_state(self, state: dict) -> None:
        self._ensure_buffer()
        self._buffer.load_state(state["buffer"])
        self.version = int(state["version"])
        if "registry" in state:
            self.registry.load_state(
                {k: np.asarray(v) for k, v in state["registry"].items()})
        elif "client_contribs" in state:
            # an older state: migrate the two flat per-client arrays into
            # registry counters (last_seen cannot be rebuilt; it stays -1)
            contribs = np.asarray(state["client_contribs"], np.int64)
            stale = np.asarray(state["client_last_staleness"], np.float32)
            for cid in np.flatnonzero(contribs):
                s, loc = divmod(int(cid), self.registry.shard_size)
                sh = self.registry._alloc(s)
                sh["participation"][loc] = contribs[cid]
                sh["last_staleness"][loc] = stale[cid]
        else:
            raise ValueError(
                "async state carries neither 'registry' nor the legacy "
                "per-client arrays — not an async server state")
        if self._admission is not None and "defense" in state:
            self._admission.load_state(state["defense"])

    def _ensure_buffer(self) -> None:
        if self._buffer is not None:
            return
        p = self.trainer.spec.padded
        if self.defense is not None:
            # defended path: a streaming bucketed buffer; the staleness
            # discount moves into the arrival fold
            self._buffer = AsyncBuffer(
                self.buffer_k, p, streaming=True,
                staleness_mode=self.staleness_mode,
                staleness_a=self.staleness_a, staleness_b=self.staleness_b,
                buckets=self.defense.buckets, bucket_seed=self.defense.seed,
                device=self.device)
            self._admission = UpdateAdmission(self.defense, p, self.device)
            self._admission.bind_fold(self.staleness_mode, self.staleness_a,
                                      self.staleness_b)
        else:
            self._buffer = AsyncBuffer(self.buffer_k, p, device=self.device)

    def _template(self, variables: dict) -> dict:
        """`variables` in the trainer's flat order (the rows' layout)."""
        return {k: variables[k] for k in self.trainer.spec.names}

    # -- the event-driven loop ------------------------------------------------
    def run(self, variables: Optional[dict] = None,
            rounds: Optional[int] = None, logger=None, ckpt=None,
            ckpt_every: int = 0, resume: bool = False) -> dict:
        """Drive `rounds` commits of the async federation, with the base
        run()'s eval cadence, metrics_history and `logger` (each evaluated
        commit, keyed by its number).  `ckpt` (a
        utils.checkpoint.FedCheckpointManager) saves the variables and
        async_state() every `ckpt_every` commits; `resume` restores both
        from its latest save and runs on to the budget."""
        cfg = self.cfg
        variables = self._template(variables if variables is not None
                                   else self.init_variables())
        self._ensure_buffer()
        total = rounds if rounds is not None else cfg.comm_round
        if ckpt is not None and resume and ckpt.latest_round() is not None:
            _step, variables, _ss, extra = ckpt.restore(
                variables, (), extra_template=self.async_state())
            variables = self._template(variables)
            self.load_async_state(extra)
            log.info("async resume: version %d, buffer %d/%d", self.version,
                     self._buffer.count, self.buffer_k)
        if self._commit_fn is None:
            if self.defense is not None:
                d = self.defense
                self._commit_fn = make_bucket_commit_fn(
                    variables, combine=d.combine, trim_k=d.trim_k,
                    dp_noise=d.dp_noise, dp_clip=d.dp_clip or 1.0)
            else:
                self._commit_fn = make_commit_fn(
                    variables, mode=self.staleness_mode, a=self.staleness_a,
                    b=self.staleness_b)
        # the admission screen and the adversary both compare uplinks with
        # the model the clients trained FROM: one flat row per version
        flat = self.trainer.flatten(variables)
        if self._admission is not None:
            self._admission.note_global(self.version, flat)
        dp_rng = (torch.Generator(device=self.device).manual_seed(
            cfg.seed + 17) if self.defense is not None
            and self.defense.dp_noise > 0 else None)
        lifecycle = ClientLifecycle(self.lifecycle_cfg,
                                    self.sampler.client_num_in_total)
        heap: list[tuple] = []      # (t, kind, seq, payload)
        seq = 0
        now = 0.0
        wave_idx = self.version     # a resumed state starts at its version
        # a (re)started run re-pools every transient client status; the
        # counters (participation/staleness/quarantine) survive
        reg = self.registry
        reg.reset_transient()
        last_commit_t = 0.0
        deadline_armed_version = -1
        t_wall0 = time.perf_counter()
        n = self.trainer.spec.n

        def push(t, kind, payload):
            nonlocal seq
            heapq.heappush(heap, (t, kind, seq, payload))
            seq += 1

        def dispatch_wave():
            """Hand work to (a sampler draw of) free clients at the current
            version: the wave's clients train one after another, and each
            result is scheduled as an arrival at its lifecycle latency."""
            nonlocal wave_idx
            slots = self.concurrency - reg.count_in_flight
            if slots <= 0 or reg.count_free == 0:
                return
            draw = self.sampler.sample_fast(wave_idx)
            ids = draw[reg.status_of(draw) == _reg.FREE][:slots]
            if ids.size == 0:   # the draw missed every free client:
                ids = reg.free_ids(slots)     # take the pool directly
            ids = [int(i) for i in ids]
            if self._shardstore is not None:
                cohort, _ = self._shardstore.cohort(np.asarray(ids, np.int64))
                cohort = {k: torch.as_tensor(v).to(self.device)
                          for k, v in cohort.items()}
            else:
                cohort, _ = self.data.cohort(np.asarray(ids, np.int64),
                                             self.device)
            with obs.span("async.wave", wave=wave_idx, clients=len(ids),
                          version=self.version):
                rows, _losses, ns = self._train_cohort(flat, cohort,
                                                       wave_idx)
                ns = ns.cpu().numpy()
            g_np = (flat[:n].cpu().numpy() if self._adversary is not None
                    and self._adversary.attacks_model() else None)
            self._m_dispatches.inc(len(ids))
            for lane, cid in enumerate(ids):
                if lifecycle.draw_crash(cid):
                    self.trace.append(("crash", round(now, 9), cid,
                                       self.version))
                    obs.counter("async_dropouts_total").inc()
                    delay = lifecycle.draw_rejoin_delay(cid)
                    reg.note_crash(cid, rejoins=delay is not None)
                    if delay is not None:
                        push(now + delay, _REJOIN, cid)
                    continue
                row = rows[lane]
                if g_np is not None and self._adversary.is_byzantine(cid):
                    # the crafted row replaces the honest result AFTER the
                    # crash draw (a crashed byzantine dispatch never lands)
                    bad = self._adversary.corrupt_row(
                        cid, row[:n], g_np, self.version)
                    row = torch.zeros_like(row)
                    row[:n] = torch.from_numpy(bad)
                    self.trace.append(("attack", round(now, 9), cid,
                                       self.version))
                reg.note_dispatch_one(cid, self.version)
                lat = lifecycle.draw_latency(cid)
                if self._arrivals is not None:
                    # the arrival process shapes turnaround (a pure
                    # function of virtual time)
                    lat *= self._arrivals.slowdown(now)
                if self._adversary is not None:
                    lat += self._adversary.stale_extra_latency(cid)
                self.trace.append(("dispatch", round(now, 9), cid,
                                   self.version))
                push(now + lat, _ARRIVE, (cid, row, float(ns[lane])))
            wave_idx += 1

        def commit(deadline_fired: bool):
            nonlocal variables, flat, last_commit_t, deadline_armed_version
            mix = np.float32(self.mix)
            if self.defense is not None:
                accs, wsums, _w, _s, n_real, _raw = \
                    self._buffer.take_stream_buckets()
                self.occupancy_at_commit.append(n_real)
                self._m_occupancy.set(0)
                with obs.span("async.commit", version=self.version,
                              n_results=n_real, deadline=deadline_fired,
                              defended=True):
                    if dp_rng is not None:
                        variables, _stats = self._commit_fn(
                            variables, accs, wsums, mix, n_real, dp_rng)
                    else:
                        variables, _stats = self._commit_fn(
                            variables, accs, wsums, mix)
            else:
                rows, w, s, n_real = self._buffer.drain()
                self.occupancy_at_commit.append(n_real)
                self._m_occupancy.set(0)
                with obs.span("async.commit", version=self.version,
                              n_results=n_real, deadline=deadline_fired):
                    variables, _stats = self._commit_fn(variables, rows, w,
                                                        s, mix)
            flat = self.trainer.flatten(variables)
            self.version += 1
            if self._admission is not None:
                self._admission.note_global(self.version, flat)
            last_commit_t = now
            deadline_armed_version = -1
            self._m_commits.inc()
            self._m_updates.inc(n_real)
            if deadline_fired:
                self.commits_deadline += 1
                obs.counter("async_deadline_commits_total").inc()
            self.trace.append(("commit", round(now, 9), n_real,
                               self.version))
            c = self.version - 1
            if c % cfg.frequency_of_the_test == 0 or self.version >= total:
                with obs.span("async.eval", version=self.version):
                    stats = self.evaluate(variables)
                stats.update(round=c, commit=c,
                             staleness_mean=float(np.mean(
                                 self.staleness_committed[-n_real:]
                                 or [0.0])),
                             buffer_fill=n_real / self.buffer_k,
                             wall_time=time.perf_counter() - t_wall0)
                self.metrics_history.append(stats)
                if logger is not None:
                    logger.log(stats, step=c)
                log.info("commit %d: %s", c, stats)
            if ckpt is not None and ckpt_every and \
                    self.version % ckpt_every == 0:
                ckpt.save(c, variables, (), extra_state=self.async_state())
            if self.version < total:     # no wave past the final commit
                dispatch_wave()

        try:
            with obs.span("async.run", commits=total):
                if self.version < total:   # a resumed state at the budget
                    dispatch_wave()        # must not train a dead wave
                while self.version < total:
                    if not heap:
                        if reg.count_free > 0 and reg.count_in_flight == 0:
                            # crash-starved: every in-flight dispatch died,
                            # but clients rejoined — start a wave
                            dispatch_wave()
                            if heap:
                                continue
                        obs.dump_flight("async_scheduler_deadlock")
                        raise AsyncSchedulerDeadlock(
                            f"async scheduler deadlock at version "
                            f"{self.version}/{total}: buffer "
                            f"{self._buffer.count}/{self.buffer_k}, "
                            f"{reg.count_dead} clients dead with no "
                            f"rejoin, {reg.count_free} free but "
                            f"undispatchable")
                    t, kind, _s, payload = heapq.heappop(heap)
                    now = max(now, t)
                    if kind == _REJOIN:
                        cid = payload
                        reg.note_rejoin(cid)
                        self.trace.append(("rejoin", round(now, 9), cid,
                                           self.version))
                        obs.counter("async_rejoins_total").inc()
                        if reg.count_in_flight == 0:
                            dispatch_wave()
                        continue
                    if kind == _DEADLINE:
                        if (self.version == payload
                                and self._buffer.count > 0):
                            commit(deadline_fired=True)
                        continue
                    cid, row, n_samples = payload
                    dispatched_v = reg.note_return(cid)
                    staleness = float(self.version - dispatched_v)
                    self.trace.append(("arrive", round(now, 9), cid,
                                       self.version, staleness))
                    if self._admission is not None:
                        # the admission gate; a quarantined row never
                        # reaches the accumulator (the client is free
                        # again and goes out with the next wave)
                        ok, why, full = self._buffer.add_screened(
                            row, n_samples, staleness, self._admission,
                            sender=cid, version=int(dispatched_v))
                        if not ok:
                            reg.note_quarantine(cid)
                            self.trace.append(
                                ("quarantine", round(now, 9), cid, why))
                            continue
                    else:
                        full = self._buffer.add(row, n_samples, staleness)
                    self.staleness_committed.append(staleness)
                    reg.note_contribution(cid, staleness, self.version)
                    self._m_staleness.observe(staleness)
                    self._m_occupancy.set(self._buffer.count)
                    if full:
                        commit(deadline_fired=False)
                    elif (self.round_deadline_s is not None
                          and deadline_armed_version != self.version):
                        deadline_armed_version = self.version
                        push(last_commit_t + self.round_deadline_s,
                             _DEADLINE, self.version)
        except AsyncSchedulerDeadlock:
            raise               # already dumped, with the sharper reason
        except Exception as e:
            obs.dump_flight(f"engine_error:AsyncFedAvgEngine: {e!r}")
            raise
        return variables

    # -- observability rollup -------------------------------------------------
    def timeline_report(self) -> Optional[dict]:
        """Commit-to-commit critical-path attribution over the live
        tracer's spans (obs/timeline.py); None with tracing off."""
        t = obs.tracer()
        if t is None:
            return None
        from fedml_tpu_torch.obs import timeline
        return timeline.critical_path(t.events())

    def staleness_percentiles(self, qs=(50, 95)) -> dict:
        s = np.asarray(self.staleness_committed or [0.0])
        return {f"p{q}": float(np.percentile(s, q)) for q in qs}

    def async_report(self) -> dict:
        """Headline async numbers."""
        occ = np.asarray(self.occupancy_at_commit or [0])
        pct = self.staleness_percentiles()
        out = {
            "committed_updates": int(self.version),
            "deadline_commits": int(self.commits_deadline),
            "staleness_p50": pct["p50"],
            "staleness_p95": pct["p95"],
            "staleness_mean": float(np.mean(
                self.staleness_committed or [0.0])),
            "buffer_occupancy_mean": float(occ.mean()),
        }
        if self._admission is not None:
            out.update(self._admission.report())
        if self._adversary is not None:
            out["byzantine_clients"] = len(self._adversary.byzantine)
            # the unbounded counter (the events list is capped)
            out["attacks_injected"] = self._adversary.injected
        return out

    def quarantine_attribution(self) -> dict:
        """{"byzantine": n, "honest": n} quarantine split; needs both an
        adversary and an admission pipeline."""
        byz = self._adversary.byzantine if self._adversary else frozenset()
        out = {"byzantine": 0, "honest": 0}
        if self._admission is not None:
            for cid, _why in self._admission.quarantine_log:
                out["byzantine" if cid in byz else "honest"] += 1
        return out
