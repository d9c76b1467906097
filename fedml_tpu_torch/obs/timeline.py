"""Round critical-path analyzer: merge per-process span traces into one
clock-aligned timeline and say which stage a round's wall time went to
(port of fedml_tpu/obs/timeline.py, the same code: it is stdlib only).

A federated round's wall is spread over processes: client train and
uplink encode happen in client processes or threads, transport transit
on the wire, decode on the server's receive path, and the aggregate on
the server's device.  The Smart-NIC FL study (arXiv:2307.06561)
identifies the server's stage attribution as what finds the FL
bottleneck; this module computes it from the span streams every layer
already emits:

* **merge** — `load_trace_jsonl` + `merge_traces` rebase each process's
  perf_counter-relative timestamps onto the unix clock via the
  `__meta__` line's `epoch_unix`, shifted by the per-peer clock offsets
  the comm layer estimated from piggybacked frame timestamps
  (obs/propagate.py, exported as clock_offsets.json);
* **rounds** — commit spans (`fsm.aggregate` of the message-driven
  server, `async.commit` of an async server, with args.round/version)
  delimit round windows: round v spans (previous commit end, this
  commit end].  Synchronous traces fall back to their explicit `round`
  spans;
* **stages** — every span name maps to a canonical stage
  (dispatch → train → uplink → decode → fold → commit …).  Within a
  window each stage claims the union of its spans' intervals, clipped
  to the window, with more-specific stages claiming first (a decode
  nested inside a handler attributes to decode); the unclaimed
  remainder is `wait` — transport transit + idle, the federation's
  dead time.  Claimed + wait == round wall by construction, so the
  stage table always explains the measured wall;
* **attribution** — per-round stage seconds, aggregate shares, and the
  p95 straggler attribution: among the slowest (≥ p95 wall) rounds,
  the stage with the largest mean share is the named bottleneck.

`critical_path()` runs in-process on a live tracer's events
(``obs.tracer().events()``) or on merged trace files.  The spans it reads
are host walls: a stage's seconds are the host's time in it, the card's
work overlapping them as the host enqueues it.
"""
from __future__ import annotations

import json
from typing import Iterable, Optional

# span name -> canonical stage.  Priority = order in STAGE_PRIORITY:
# when spans overlap inside a window (nesting, concurrent threads), the
# earlier stage claims the interval and later ones only keep what's
# left — so a decode nested in a comm.handle books as decode, and train
# time under an outer wave span books once.
SPAN_STAGES = {
    "async.commit": "commit",
    "fsm.aggregate": "commit",
    "ingest.fold": "fold",
    "ingest.decode": "decode",
    "comm.decode": "decode",
    "async.local_train": "train",
    "fsm.local_train": "train",
    "async.wave": "train",
    "round.block_step": "train",
    "round.chunked": "train",
    "h2d.upload_block": "h2d",
    "h2d.upload": "h2d",
    "async.eval": "eval",
    "eval": "eval",
    "checkpoint": "checkpoint",
    # reactor transport housekeeping/drain (eviction scans,
    # shed batches, graceful close) — rare, but when overload handling
    # dominates a round's wall the timeline must say so
    "reactor.housekeep": "reactor",
    "reactor.drain": "reactor",
}
# commit-family span names: their end times delimit round windows on
# event-driven paths (the async scheduler's commits, the deployment
# FSM's aggregates) where no single `round` call frame exists
COMMIT_SPANS = ("async.commit", "fsm.aggregate")

# program family -> canonical stage: the per-family profile registry
# (obs/programs.py) groups its dispatch-wall/stream-time/MFU rows into
# the SAME stage taxonomy this analyzer attributes round walls to, so
# the stage table and the program table speak one language.  The JAX
# package's family names, and the port's: its one-card engines count
# under the JAX names ("<stem>_resident" for the algorithms/ engines,
# "<stem>_streaming" for the chunked parallel/ engines,
# "robust_orderstat", "hierarchical"), plus the two engines the JAX
# package never instrumented.  Families not listed here report stage
# "other" (profiled, unmapped).
PROGRAM_FAMILY_STAGES = {
    # the sync engines' round programs — cohort training + aggregation
    # in one compiled dispatch
    "fedavg_resident": "train", "fedavg_streaming": "train",
    "fedavg_blockstream": "train",
    "fednova_resident": "train", "fednova_streaming": "train",
    "fednova_blockstream": "train",
    "fedprox_resident": "train", "fedprox_streaming": "train",
    "fedprox_blockstream": "train",
    "fedopt_resident": "train", "fedopt_streaming": "train",
    "fedopt_blockstream": "train",
    "robust_orderstat": "train", "robust_blockstream": "train",
    "hierarchical": "train", "gossip": "train",
    "fedseg_resident": "train", "turboaggregate_resident": "train",
    # the two-level multihost programs: per-block partials
    # are training work, the replicated carry commit is aggregation
    "fedavg_twolevel": "train", "fedprox_twolevel": "train",
    "fedopt_twolevel": "train", "fednova_twolevel": "train",
    "twolevel_commit": "commit",
    # the async ingestion/commit pipeline
    "async_fold": "fold", "async_drain_fold": "fold",
    "async_screened_fold": "fold", "async_admission": "fold",
    "async_commit": "commit", "async_stream_commit": "commit",
    "async_bucket_commit": "commit",
}
STAGE_PRIORITY = ("commit", "decode", "fold", "train", "uplink",
                  "dispatch", "h2d", "eval", "checkpoint", "reactor")
WAIT_STAGE = "wait"


def stage_of(ev: dict) -> Optional[str]:
    """Canonical stage of one span event (None = not a stage span)."""
    name = ev.get("name", "")
    s = SPAN_STAGES.get(name)
    if s is not None:
        return s
    if name == "comm.send":
        # direction decides: a server send is a dispatch (downlink), a
        # client send is the uplink encode+write
        node = (ev.get("args") or {}).get("node")
        return "dispatch" if node == "server" else "uplink"
    return None


# -- trace IO / merging ------------------------------------------------------

def load_trace_jsonl(path: str) -> tuple[dict, list[dict]]:
    """(meta, events) from a SpanTracer.export_jsonl file (or a spill
    file, which has no meta line — meta comes back {})."""
    meta, events = {}, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            doc = json.loads(line)
            if "__meta__" in doc:
                meta = doc["__meta__"]
            else:
                events.append(doc)
    return meta, events


def rebase(events: list[dict], meta: dict,
           offset_s: float = 0.0) -> list[dict]:
    """Map one process's trace-relative `ts` (µs since its tracer
    epoch) onto the unix clock (µs), shifted by `offset_s` — the
    estimated correction of THIS process's clock onto the reference
    process's (obs/propagate.py sign convention: add the offset to the
    peer's timestamps)."""
    base_us = (float(meta.get("epoch_unix", 0.0)) + offset_s) * 1e6
    out = []
    for ev in events:
        ev = dict(ev)
        ev["ts"] = ev["ts"] + base_us
        out.append(ev)
    return out


def merge_traces(sources: Iterable[tuple[dict, list[dict], float]]
                 ) -> list[dict]:
    """Merge per-process traces into one unix-clock timeline.
    `sources` yields (meta, events, offset_s) triples; colliding pids
    across hosts are left as-is (Chrome renders them as separate
    process groups only if distinct — pass distinct pids via meta when
    merging across hosts that reuse pids)."""
    merged = []
    for meta, events, offset_s in sources:
        merged.extend(rebase(events, meta, offset_s))
    merged.sort(key=lambda e: e["ts"])
    return merged


def dir_offsets(metas_clocks: list[tuple[dict, list[dict]]]
                ) -> list[float]:
    """Per-source clock corrections from the clock_offsets.json
    exports.  `metas_clocks` is [(meta, clock_export_list)] per source
    dir; the reference is the source whose comm managers include rank 0
    (else the first source).  A source containing rank r is shifted by
    the reference's estimated offset for peer r (0.0 when the reference
    never heard from r — same-host clocks agree anyway)."""
    ranks = []
    for _meta, clocks in metas_clocks:
        ranks.append({c.get("rank") for c in clocks
                      if c.get("rank") is not None})
    ref = 0
    for i, rs in enumerate(ranks):
        if 0 in rs:
            ref = i
            break
    ref_offsets: dict[str, float] = {}
    for c in metas_clocks[ref][1]:
        ref_offsets.update(c.get("offsets_s", {}))
    out = []
    for i, rs in enumerate(ranks):
        if i == ref:
            out.append(0.0)
            continue
        offs = [ref_offsets[str(r)] for r in rs if str(r) in ref_offsets]
        out.append(sum(offs) / len(offs) if offs else 0.0)
    return out


# -- interval algebra --------------------------------------------------------

def _union(iv: list[tuple[float, float]]) -> list[tuple[float, float]]:
    if not iv:
        return []
    iv = sorted(iv)
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _subtract(iv, taken):
    """Set difference of two merged-sorted interval lists."""
    out = []
    for s, e in iv:
        cur = s
        for ts, te in taken:
            if te <= cur or ts >= e:
                continue
            if ts > cur:
                out.append((cur, ts))
            cur = max(cur, te)
            if cur >= e:
                break
        if cur < e:
            out.append((cur, e))
    return out


def _total(iv) -> float:
    return sum(e - s for s, e in iv)


# -- round windows -----------------------------------------------------------

def round_windows(events: list[dict]) -> list[tuple[object, float, float]]:
    """[(round_id, t0_us, t1_us)] — commit-to-commit windows when
    commit-family spans exist (async scheduler commits, deployment FSM
    aggregates), else the sync loop's explicit `round` spans."""
    commits = sorted((e for e in events if e.get("name") in COMMIT_SPANS
                      and e.get("ph") == "X"),
                     key=lambda e: e["ts"] + e.get("dur", 0.0))
    if commits:
        t_first = min(e["ts"] for e in events)
        windows, prev_end = [], t_first
        for c in commits:
            end = c["ts"] + c.get("dur", 0.0)
            args = c.get("args") or {}
            rid = args.get("version", args.get("round"))
            windows.append((rid, prev_end, end))
            prev_end = end
        return windows
    rounds = [e for e in events if e.get("name") == "round"
              and e.get("ph") == "X"]
    return [((e.get("args") or {}).get("round"), e["ts"],
             e["ts"] + e.get("dur", 0.0))
            for e in sorted(rounds, key=lambda e: e["ts"])]


# -- the analyzer ------------------------------------------------------------

def critical_path(events: list[dict]) -> dict:
    """Per-round stage attribution + straggler report over a (merged or
    single-process) event list.  Stage seconds + `wait` sum to each
    round's wall exactly; the p95 attribution names the stage with the
    largest mean share among the slowest rounds."""
    windows = round_windows(events)
    spans = [(stage_of(e), e["ts"], e["ts"] + e.get("dur", 0.0))
             for e in events if e.get("ph") == "X"]
    spans = [(s, a, b) for s, a, b in spans if s is not None and b > a]
    rounds = []
    for rid, t0, t1 in windows:
        if t1 <= t0:
            continue
        taken: list[tuple[float, float]] = []
        stages = {}
        for stage in STAGE_PRIORITY:
            iv = _union([(max(a, t0), min(b, t1))
                         for s, a, b in spans
                         if s == stage and b > t0 and a < t1])
            mine = _subtract(iv, taken)
            if mine:
                stages[stage] = _total(mine) / 1e6
                taken = _union(taken + mine)
        wall = (t1 - t0) / 1e6
        stages[WAIT_STAGE] = max(0.0, wall - _total(taken) / 1e6)
        dominant = max(stages, key=stages.get)
        rounds.append({"round": rid, "t0_us": t0, "wall_s": wall,
                       "stages": {k: round(v, 6)
                                  for k, v in stages.items()},
                       "dominant": dominant})
    report = {"n_rounds": len(rounds), "rounds": rounds}
    if not rounds:
        return report
    totals: dict[str, float] = {}
    for r in rounds:
        for k, v in r["stages"].items():
            totals[k] = totals.get(k, 0.0) + v
    wall_total = sum(r["wall_s"] for r in rounds)
    walls = sorted(r["wall_s"] for r in rounds)

    def pct(q):
        i = min(len(walls) - 1, int(round(q * (len(walls) - 1))))
        return walls[i]

    p95 = pct(0.95)
    slow = [r for r in rounds if r["wall_s"] >= p95] or rounds
    slow_mean = {}
    for r in slow:
        for k, v in r["stages"].items():
            slow_mean[k] = slow_mean.get(k, 0.0) + v / len(slow)
    attr = max(slow_mean, key=slow_mean.get)
    slow_wall = sum(r["wall_s"] for r in slow) / len(slow)
    report.update({
        "stage_totals_s": {k: round(v, 6) for k, v in totals.items()},
        "stage_share": {k: round(v / wall_total, 4)
                        for k, v in totals.items()} if wall_total else {},
        "round_wall_p50_s": round(pct(0.50), 6),
        "round_wall_p95_s": round(p95, 6),
        "p95_attribution": {
            "stage": attr,
            "share": round(slow_mean[attr] / slow_wall, 4)
            if slow_wall else 0.0,
            "n_rounds": len(slow),
        },
    })
    return report


# -- chrome export with per-round lanes --------------------------------------

LANES_PID = 1 << 30          # synthetic "critical path" process row


def lane_events(report: dict) -> list[dict]:
    """Synthetic Chrome events rendering the critical-path claims as
    per-stage lanes (one tid per stage under a dedicated pid), so the
    stage attribution is VISIBLE next to the raw spans."""
    stages = list(STAGE_PRIORITY) + [WAIT_STAGE]
    out = [{"name": "process_name", "ph": "M", "pid": LANES_PID, "tid": 0,
            "args": {"name": "round critical path"}}]
    for i, st in enumerate(stages):
        out.append({"name": "thread_name", "ph": "M", "pid": LANES_PID,
                    "tid": i + 1, "args": {"name": f"stage:{st}"}})
    for r in report.get("rounds", []):
        t0 = r["t0_us"]
        cursor = t0
        # lanes are schematic: stages laid end-to-end in pipeline order
        # with their claimed totals (the raw spans above carry the
        # true interleaving)
        for i, st in enumerate(stages):
            sec = r["stages"].get(st, 0.0)
            if sec <= 0:
                continue
            out.append({"name": st, "ph": "X", "pid": LANES_PID,
                        "tid": i + 1, "ts": cursor, "dur": sec * 1e6,
                        "args": {"round": r["round"]}})
            cursor += sec * 1e6
        out.append({"name": f"round {r['round']}", "ph": "X",
                    "pid": LANES_PID, "tid": 0, "ts": t0,
                    "dur": r["wall_s"] * 1e6,
                    "args": {"dominant": r["dominant"]}})
    return out


BARRIER_PID = LANES_PID + 1  # synthetic "cluster barriers" process row


def barrier_lane_events(entries: list[dict]) -> list[dict]:
    """Synthetic Chrome events rendering the coordinator's barrier
    ledger (obs/cluster.py) as per-RANK lanes: each rank's
    wait behind the gate is a slice ending at the gate instant, the
    gating rank's slice is labeled GATE, and a tid-0 instant names the
    gating rank per barrier — the cross-rank straggler view next to
    the per-stage critical path."""
    if not entries:
        return []
    ranks = sorted({int(r) for e in entries
                    for r in e.get("waits_s", {})})
    out = [{"name": "process_name", "ph": "M", "pid": BARRIER_PID,
            "tid": 0, "args": {"name": "cluster barriers"}}]
    tid_of = {}
    for i, r in enumerate(ranks):
        tid_of[r] = i + 1
        out.append({"name": "thread_name", "ph": "M",
                    "pid": BARRIER_PID, "tid": i + 1,
                    "args": {"name": f"rank {r} wait"}})
    for e in entries:
        gate_us = e["t_unix"] * 1e6
        gating = e.get("round_gating_rank")
        label = (f"round {e['round']}" if e.get("round") is not None
                 else f"{e.get('kind', 'barrier')} #{e.get('seq')}")
        out.append({"name": f"gate: rank {gating} ({label})",
                    "ph": "i", "pid": BARRIER_PID, "tid": 0,
                    "ts": gate_us, "s": "p",
                    "args": {"round_gating_rank": gating,
                             "gate_margin_s": e.get("gate_margin_s"),
                             "kind": e.get("kind"),
                             "seq": e.get("seq")}})
        for r_str, w in e.get("waits_s", {}).items():
            r = int(r_str)
            out.append({"name": ("GATE" if r == gating else "wait"),
                        "ph": "X", "pid": BARRIER_PID,
                        "tid": tid_of[r], "ts": gate_us - w * 1e6,
                        "dur": max(w * 1e6, 1.0),
                        "args": {"rank": r, "wait_s": w,
                                 "round": e.get("round"),
                                 "gating": r == gating}})
    return out


def export_chrome(events: list[dict], path: str,
                  report: Optional[dict] = None,
                  barriers: Optional[list[dict]] = None) -> str:
    doc = {"traceEvents": (events
                           + (lane_events(report) if report else [])
                           + (barrier_lane_events(barriers)
                              if barriers else [])),
           "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def format_report(report: dict) -> str:
    """Human-readable critical-path table (the CLI's stdout)."""
    lines = [f"rounds analyzed: {report.get('n_rounds', 0)}"]
    if not report.get("rounds"):
        return lines[0]
    lines.append(f"round wall p50/p95: "
                 f"{report['round_wall_p50_s'] * 1e3:.1f}/"
                 f"{report['round_wall_p95_s'] * 1e3:.1f} ms")
    lines.append(f"{'stage':<12}{'total s':>10}{'share':>8}")
    for k, v in sorted(report["stage_totals_s"].items(),
                       key=lambda kv: -kv[1]):
        lines.append(f"{k:<12}{v:>10.3f}"
                     f"{report['stage_share'].get(k, 0.0):>8.1%}")
    a = report["p95_attribution"]
    lines.append(f"p95 straggler attribution: {a['stage']} "
                 f"({a['share']:.0%} of the slowest "
                 f"{a['n_rounds']} round(s))")
    return "\n".join(lines)
