"""Virtual-time serve simulation: the million-client serving spine (port of
fedml_tpu/scale/serve.py).

What it measures: the server's cross-device round hot path at production
populations — cohort sampling over the sharded registry, per-uplink
registry bookkeeping, the streaming fold and the O(P) commit — under a
trace-driven arrival process in virtual time.  Client compute is out of
scope (updates are a rotating pool of pre-generated rows): the question
is whether the spine sustains committed updates per second while server
memory stays sub-linear in the population.

The loop (one process, no threads; the virtual clock comes from the
arrival process):

    arrivals  the arrival process (scale/arrivals.py) yields landing times
    dispatch  when in-flight drops below `concurrency`, the streaming
              cohort sampler draws a batch over the registry's eligibility
              mask and `note_dispatch` marks it
    ingest    each arrival pops the oldest in-flight client (a numpy
              ring), `note_return` yields its dispatched version ->
              staleness, the row folds into the streaming AsyncBuffer on
              the device (the arrival fold: the fold kernel's accumulate
              form, one launch an arrival), `note_contribution` updates
              the client's counters
    commit    buffer full -> the O(P) stream commit, version += 1
    faults    a seeded dropout stream crashes dispatches (no fold);
              crashed clients rejoin at the next commit

Determinism: sampler draws, the row pool, dropout and arrival times are
all ``default_rng([seed, ...])`` streams, so the trace (dispatches,
returns, staleness, crashes and rejoins, registry counters) is bitwise
the JAX package's on any device; only the committed row is floating
point.

Host-sharded serving: ``partition=(rank, world)`` makes this process own
only its client-id range, one lane keyed on its range's index (the item);
each commit packs the lane partials, exchanges them over a HostChannel
(one payload a rank) or an ElasticChannel (n_items = world, one payload a
range), and every rank folds them in item order on the host and applies
the same commit.  Elastic: a range whose host died folds zero in the
window of the death (the same bytes on every survivor), and at the next
commit barrier the view's new owner re-adopts it as a fresh lane
(``make_lane(item, start_version)``, the dead rank's item and streams
from their start); lanes the view moves away retire.
"""
from __future__ import annotations

import hashlib
import time
from typing import Optional

import numpy as np
import torch

from fedml_tpu_torch import obs
from fedml_tpu_torch.scale.arrivals import (ArrivalConfig, ArrivalProcess,
                                            make_arrivals)
from fedml_tpu_torch.scale.registry import ClientRegistry
from fedml_tpu_torch.scale.sampler import StreamingCohortSampler
from fedml_tpu_torch.utils.device import resolve_device


def pack_partial(acc, wsum) -> bytes:
    """One lane or rank partial on the wire: <f4 wsum, then the f32 acc
    row (the JAX package's one payload layout)."""
    acc = (acc.detach().cpu().numpy() if isinstance(acc, torch.Tensor)
           else np.asarray(acc))
    wsum = float(wsum) if isinstance(wsum, torch.Tensor) else wsum
    return np.float32(wsum).tobytes() + np.asarray(acc, np.float32).tobytes()


def zero_partial(row_dim: int) -> bytes:
    """The deterministic zero payload a not-yet-adopted range folds."""
    return (np.float32(0.0).tobytes()
            + np.zeros(row_dim, np.float32).tobytes())


def fold_partials(docs, row_dim: int, device=None):
    """Item-ordered sum of (wsum, acc) payloads on the host, in f32, as
    tensors on `device` (the card unless named): (acc [row_dim], wsum)."""
    t_wsum = np.float32(0.0)
    t_acc = np.zeros(row_dim, np.float32)
    for d in docs:
        t_wsum = np.float32(t_wsum + np.frombuffer(d, "<f4", count=1)[0])
        t_acc += np.frombuffer(d, "<f4", offset=4)
    device = resolve_device(device)
    return (torch.from_numpy(t_acc).to(device),
            torch.tensor(t_wsum, dtype=torch.float32, device=device))


def rss_bytes() -> int:
    """Resident set size of this process (0 where /proc is absent)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def variables_digest(variables: dict) -> str:
    """md5 over the raw bytes of every leaf, in the dict's order."""
    h = hashlib.md5()
    for leaf in variables.values():
        h.update(leaf.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


class _ServeLane:
    """One client-id range's serving state — registry shards, sampler,
    streaming buffer, in-flight ring and the seeded streams — run as a
    generator that yields its partial (acc, wsum, n) at every commit
    boundary.  The one-process path is one lane over the whole population
    (`item` 0), with the JAX package's world-1 streams, in its per-arrival
    op order (dispatch, arrival, pop, crash or fold, commit-yield,
    rejoins, refill).  `trace` hashes every event of that order.  With a
    world above 1 each lane's streams are keyed on its item too, so a
    range re-adopted on another rank replays the dead rank's streams."""

    def __init__(self, item: int, lo: int, hi: int, *, world: int = 1,
                 seed: int,
                 buffer_k: int, concurrency: int, row_dim: int,
                 sampler_mode: str, arrival: ArrivalConfig,
                 dropout_prob: float, banned_frac: float, device,
                 start_version: int = 0):
        from fedml_tpu_torch.async_.staleness import AsyncBuffer
        self.item = int(item)
        self.lo, self.hi = int(lo), int(hi)
        self.local_population = self.hi - self.lo
        self.buffer_k = int(buffer_k)
        self.concurrency = int(concurrency)
        self.dropout_prob = float(dropout_prob)
        self.registry = ClientRegistry(self.local_population)
        # per-range streams when sharded; the world-1 streams are the
        # unsharded ones
        self.rng = np.random.default_rng(
            [seed, 2] if world == 1 else [seed, 2, item])
        if banned_frac > 0.0:
            n_ban = max(1, int(banned_frac * self.local_population))
            self.registry.ban(np.unique(self.rng.integers(
                0, self.local_population, size=2 * n_ban))[:n_ban])
        self.sampler = StreamingCohortSampler(self.registry, buffer_k,
                                              seed=seed, mode=sampler_mode)
        self.buffer = AsyncBuffer(buffer_k, row_dim, streaming=True,
                                  device=device)
        # the pool is drawn on the host (the JAX package's stream) and
        # lives on the device: each arrival folds one of its rows
        self.pool = torch.from_numpy(self.rng.standard_normal(
            (64, row_dim)).astype(np.float32)).to(device)
        self.drop_rng = np.random.default_rng(
            [seed, 3] if world == 1 else [seed, 3, item])
        proc: Optional[ArrivalProcess] = make_arrivals(arrival)
        self.arr_iter = (proc.arrivals(0.0, np.random.default_rng(
            [arrival.seed, seed, 1] if world == 1
            else [arrival.seed, seed, 1, item]))
            if proc is not None else None)
        self.cap = 2 * self.concurrency + self.buffer_k
        self.ring = np.zeros(self.cap, np.int64)
        self.head = self.tail = 0
        self.version = int(start_version)
        self.admitted = 0
        self.crashed = 0
        self.draws = 0          # monotone per draw: every draw is fresh
        self.now = 0.0
        self._rejoin_at_commit: list[np.ndarray] = []
        self.trace = hashlib.md5()

    def _event(self, *vals) -> None:
        self.trace.update(np.asarray(vals, np.float64).tobytes())

    def _dispatch(self, need: int) -> int:
        ids = self.sampler.sample(self.draws, k=need)
        self.draws += 1
        if ids.size == 0:
            return 0
        self.registry.note_dispatch(ids, self.version)
        self.trace.update(np.asarray(ids, np.int64).tobytes())
        for c in ids:
            self.ring[self.tail % self.cap] = c
            self.tail += 1
        return int(ids.size)

    def gen(self):
        """Yield (acc, wsum, n_commit) at each commit boundary."""
        self._dispatch(self.concurrency)
        while True:
            if (self.head == self.tail
                    and self._dispatch(self.buffer_k) == 0):
                raise RuntimeError(
                    f"serve sim starved at version {self.version} "
                    f"(lane {self.item}): no eligible clients "
                    f"({self.registry.count_free} free)")
            if self.arr_iter is not None:
                try:
                    self.now = next(self.arr_iter)
                except StopIteration:
                    raise ValueError(
                        f"arrival trace exhausted after "
                        f"{self.admitted + self.crashed} arrivals at "
                        f"commit {self.version}: the trace needs "
                        f"~commits*buffer_k (+dropout) "
                        f"timestamps") from None
            cid = int(self.ring[self.head % self.cap])
            self.head += 1
            if (self.dropout_prob > 0.0
                    and self.drop_rng.random() < self.dropout_prob):
                self.registry.note_crash(cid, rejoins=True)
                self.crashed += 1
                self._event(0, cid, self.now)
                self._rejoin_at_commit.append(np.asarray([cid], np.int64))
            else:
                v = self.registry.note_return(cid)
                staleness = float(self.version - v)
                self._event(1, cid, self.now, staleness)
                full = self.buffer.add(self.pool[self.admitted % 64],
                                       1.0, staleness)
                self.registry.note_contribution(cid, staleness,
                                                self.version)
                self.admitted += 1
                if full:
                    acc, wsum, _w, _s, n_commit, _raw = \
                        self.buffer.take_stream()
                    yield acc, wsum, n_commit
                    self.version += 1
                    for ids in self._rejoin_at_commit:
                        for c in ids:
                            self.registry.note_rejoin(int(c))
                    self._rejoin_at_commit.clear()
            if (self.tail - self.head) <= (self.concurrency
                                           - self.buffer_k):
                with obs.span("serve.dispatch", version=self.version):
                    self._dispatch(self.concurrency
                                   - (self.tail - self.head))


def run_serve_sim(population: int, *, commits: int = 30,
                  warmup_commits: int = 2, buffer_k: int = 32,
                  concurrency: Optional[int] = None, row_dim: int = 1024,
                  sampler_mode: str = "stratified",
                  arrival: Optional[ArrivalConfig] = None,
                  dropout_prob: float = 0.0, banned_frac: float = 0.0,
                  seed: int = 0, partition: tuple = (0, 1),
                  channel=None, elastic: bool = False,
                  crash_at_commit: Optional[int] = None, device=None,
                  keep_variables: bool = False) -> dict:
    """Drive `commits` streaming commits at `population` simulated clients
    on `device` (the card unless named); returns the serve report
    (committed updates/sec, registry memory, RSS, virtual-time stats, the
    trace digest).  `keep_variables` adds the committed model
    (``report["variables"]``, tensors on the device).

    `partition=(rank, world)` with a world above 1 serves only this
    rank's id range and folds the ranks' partials over `channel` (a
    HostChannel; with `elastic` an ElasticChannel of n_items = world):
    every rank performs exactly `commits` commits, and the report's
    `committed_digest` agrees across ranks.  `crash_at_commit` is the
    fault hook: this rank closes its channel after that many commits and
    returns a partial report."""
    from fedml_tpu_torch.async_.staleness import make_stream_commit_fn

    if commits <= warmup_commits:
        raise ValueError(f"commits ({commits}) must exceed "
                         f"warmup_commits ({warmup_commits})")
    rank, world = int(partition[0]), int(partition[1])
    if not 0 <= rank < world:
        raise ValueError(f"partition rank {rank} outside world {world}")
    if world > 1 and channel is None:
        raise ValueError("world > 1 needs a HostChannel to fold the "
                         "partial aggregates upward")
    if elastic and world > 1 and not hasattr(channel, "exchange"):
        raise ValueError("elastic=True needs an ElasticChannel "
                         "(n_items=world); HostChannel is the "
                         "fail-fast transport")
    device = resolve_device(device)
    concurrency = (concurrency if concurrency is not None
                   else 4 * buffer_k)
    arrival = arrival if arrival is not None else ArrivalConfig(
        mode="constant", rate=1000.0, seed=seed)

    def make_lane(item: int, start_version: int = 0) -> _ServeLane:
        return _ServeLane(
            item, item * population // world,
            (item + 1) * population // world, world=world, seed=seed,
            buffer_k=buffer_k, concurrency=concurrency, row_dim=row_dim,
            sampler_mode=sampler_mode, arrival=arrival,
            dropout_prob=dropout_prob, banned_frac=banned_frac,
            device=device, start_version=start_version)

    primary = make_lane(rank)
    lanes: dict[int, _ServeLane] = {rank: primary}
    gens: dict[int, object] = {}
    retired: list[_ServeLane] = []      # lanes the view moved elsewhere
    adopted_items: list[int] = []
    zero_payload = zero_partial(row_dim)

    def all_lanes() -> list:
        return list(lanes.values()) + retired

    def registry_lanes() -> list:
        """At most one lane per item for the registry's state (the live
        lane wins over a retired one): re-adopting a range this rank had
        retired must not count its registry twice.  Work counters still
        sum over all_lanes(): a retired lane's updates were folded."""
        by_item = {ln.item: ln for ln in retired}
        by_item.update(lanes)
        return list(by_item.values())

    def lanes_admitted() -> int:
        return sum(ln.admitted for ln in all_lanes())

    def clock_lane() -> _ServeLane:
        """The lane whose virtual clock is this rank's now: the primary
        while hosted, else a hosted lane (a view change can retire the
        rank's own range; a retired lane's clock stops)."""
        if rank in lanes:
            return lanes[rank]
        return next(iter(lanes.values())) if lanes else primary

    # the commit math: a one-leaf flat "model" through the real streaming
    # buffer and the O(P) commit
    variables = {"w": torch.zeros(row_dim, dtype=torch.float32,
                                  device=device)}
    commit_fn = make_stream_commit_fn(variables)
    alpha = torch.ones((), dtype=torch.float32)
    version = 0
    t_wall0 = time.perf_counter()
    t_timed = None
    admitted_at_warmup = 0
    crashed_out = False
    with obs.span("serve.run", population=population, commits=commits,
                  sampler=sampler_mode, arrival=arrival.mode,
                  elastic=elastic):
        gens[rank] = primary.gen()
        while version < commits:
            if crash_at_commit is not None and version == crash_at_commit:
                # fault injection: this rank vanishes mid-run; the
                # survivors' next exchange evicts it
                if channel is not None:
                    channel.close()
                crashed_out = True
                break
            partials = {item: next(gens[item]) for item in sorted(gens)}
            n_committed = sum(p[2] for p in partials.values())
            with obs.span("serve.commit", version=version,
                          t_virtual=round(clock_lane().now, 3), rank=rank):
                if world > 1 and elastic:
                    payloads = {item: pack_partial(acc, wsum)
                                for item, (acc, wsum, _n)
                                in partials.items()}
                    # a range re-assigned here but not hosted yet folds
                    # zero this window (the same bytes on every
                    # survivor); its lane starts at the barrier below
                    allp, view = channel.exchange(
                        version, payloads,
                        lambda items: {i: zero_payload for i in items})
                    acc, wsum = fold_partials(
                        (allp[item] for item in range(world)), row_dim,
                        device)
                elif world > 1:
                    # one (wsum, acc) payload a rank, summed in rank order
                    acc, wsum, _n = partials[rank]
                    acc, wsum = fold_partials(
                        channel.allgather(pack_partial(acc, wsum)),
                        row_dim, device)
                else:
                    acc, wsum, _n = partials[rank]
                variables, _stats = commit_fn(variables, acc, wsum, alpha)
            obs.counter("async_updates_committed_total").inc(n_committed)
            version += 1
            if world > 1 and elastic:
                # the commit barrier puts the lanes on the view: one host
                # a range (two would race different partials for one
                # item); drop lanes moved away, adopt lanes moved here
                for item in list(gens):
                    if view.owner_of(item) != rank:
                        gens.pop(item).close()
                        retired.append(lanes.pop(item))
                for item in view.assigned(rank):
                    if item not in lanes:
                        lanes[item] = make_lane(item, start_version=version)
                        gens[item] = lanes[item].gen()
                        adopted_items.append(item)
                        obs.instant("serve.readopt", item=item, rank=rank,
                                    version=version)
            if version == warmup_commits:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                t_timed = time.perf_counter()
                admitted_at_warmup = lanes_admitted()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    wall = time.perf_counter() - (t_timed if t_timed is not None
                                  else t_wall0)
    timed_updates = lanes_admitted() - (admitted_at_warmup
                                        if t_timed is not None else 0)
    # contributor spread, from the allocated shards only (O(touched))
    distinct = max_part = 0
    for ln in registry_lanes():
        for sh in ln.registry._shards.values():
            part = sh["participation"]
            distinct += int(np.count_nonzero(part))
            max_part = max(max_part, int(part.max()) if part.size else 0)
    clk = clock_lane()
    report = {
        "population": int(population),
        "local_population": int(primary.local_population),
        "partition": [rank, world],
        "committed_digest": variables_digest(variables),
        "trace_digest": primary.trace.hexdigest(),
        "carry_allreduce_bytes": int(getattr(channel, "bytes_received", 0)
                                     if channel is not None else 0),
        "commits": int(version),
        "committed_updates": int(lanes_admitted()),
        "distinct_contributors": distinct,
        "max_client_participation": max_part,
        "committed_updates_per_sec": (timed_updates / wall
                                      if wall > 0 else 0.0),
        "buffer_k": int(buffer_k),
        "concurrency": int(concurrency),
        "row_dim": int(row_dim),
        "sampler_mode": sampler_mode,
        "sampler_peak_scratch_bytes": int(
            max(ln.sampler.peak_scratch_bytes for ln in all_lanes())),
        "arrival_mode": arrival.mode,
        "virtual_time_s": float(clk.now),
        "mean_arrival_rate": ((clk.admitted + clk.crashed) / clk.now
                              if clk.now > 0 else 0.0),
        "registry_bytes": int(sum(ln.registry.nbytes
                                  for ln in registry_lanes())),
        "registry_bytes_per_client": float(
            primary.registry.bytes_per_client),
        "registry_shards_allocated": sum(len(ln.registry._shards)
                                         for ln in registry_lanes()),
        "crashed": int(sum(ln.crashed for ln in all_lanes())),
        "banned": int(sum(ln.registry.count_banned
                          for ln in registry_lanes())),
        "rss_bytes": rss_bytes(),
        "wall_s": float(wall),
        "seed": int(seed),
        "device": str(device),
    }
    if elastic:
        report["elastic"] = {
            "lanes": sorted(lanes),
            "adopted_items": adopted_items,
            "retired_items": [ln.item for ln in retired],
            "lane_traces": {str(ln.item): ln.trace.hexdigest()
                            for ln in all_lanes()},
            "crashed_at_commit": (crash_at_commit if crashed_out
                                  else None),
            "epoch": getattr(getattr(channel, "view", None), "epoch", 0),
            "view_changes": len(getattr(channel, "view_events", ())),
        }
    if keep_variables:
        report["variables"] = variables
    return report
