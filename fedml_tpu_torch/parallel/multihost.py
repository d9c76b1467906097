"""The two-level multi-process runtime (port of the launcher, host
channel, block math and MultihostRunner of fedml_tpu/parallel/multihost.py).

The reference scales across machines with `mpirun -np N -hostfile ...`
(run_fedavg_distributed_pytorch.sh:16-35): one OS process per rank.  This
module is that deployment for the port:

* `MultihostContext` / `spawn_cluster` / ``python -m
  fedml_tpu_torch.parallel.launch``: a multi-process launcher.  N OS
  processes are wired by env (`FEDML_MH_RANK/WORLD/COORD`); the first
  rank that fails is blamed, the rest are killed, and every rank's
  outcome is summarised.
* `HostChannel`: the inter-process tier, a small TCP star (rank 0
  coordinates) carrying the flat f32 carry between processes.  It needs
  no backend collective, so two ranks can share one card (two NCCL ranks
  of one `torch.distributed` group cannot).  Every wait is bounded: a
  dead or hung rank raises `DeadRankError` naming it.  Its frames are
  the JAX channel's byte for byte, so a JAX rank and a port rank
  complete one allgather together.
* `MultihostRunner`: the two-level round.  For each block it owns, a
  rank trains the block's cohort through the engine's chunk loop and its
  fold kernels into one flat f32 carry (the engine's
  `_twolevel_partial`), copies it to the host, the ranks allgather the
  (optionally compressed, parallel/carry_codec.py) carries, every rank
  folds all block partials in global block order on the host in numpy,
  and every rank applies the same commit (`_twolevel_commit`).

Bitwise anchor: the reduction tree is a function of the block
partition, not of the process count.  The cohort is sampled per block
from fixed population ranges (`BlockCohortSampler`, numpy streams keyed
[seed, round, block]); lane j of block b trains with
``client_generator(seed, round, b * k_per_block + j)``, never a
rank-local index; and every rank folds all partials in global block
order.  Any process count that tiles the same blocks therefore commits
the same bits.

* The elastic tier: `ClusterView` (an epoch of membership and the pure
  block -> owner map), `ElasticChannel` (typed hellos, heartbeats, view
  changes that re-task the survivors mid-round, rejoin through a config
  digest and a snapshot at the commit barrier), `ElasticRunner` (the
  two-level round over it: a dead or hung rank's blocks are recomputed
  by the survivors, and the round commits the bits the clean run
  commits), and the launcher's ``elastic``/``respawn`` policy.

* The mesh helpers (the client-axis mesh across ranks, parallel/mesh.py):
  `init_multihost` joins this process into torch.distributed's gloo
  group from the FEDML_MH_* env (``spawn_cluster(jax_distributed=True)``
  exports the rendezvous under the JAX package's variable name, so one
  launch line drives both packages); `make_global_mesh` (every rank),
  `make_local_mesh` (this process alone) and
  `make_hierarchical_host_mesh` (a silo row per machine).
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import logging
import os
import select
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from fedml_tpu_torch import obs
from fedml_tpu_torch.obs import cluster as _cluster
from fedml_tpu_torch.parallel.mesh import (CLIENT_AXIS, Mesh, make_mesh,
                                           make_mesh_2d)
from fedml_tpu_torch.parallel.mesh import world as mesh_world

log = logging.getLogger(__name__)

ENV_RANK = "FEDML_MH_RANK"
ENV_WORLD = "FEDML_MH_WORLD"
ENV_COORD = "FEDML_MH_COORD"           # host:port of the HostChannel
ENV_JAX_COORD = "FEDML_MH_JAX_COORD"   # host:port of the mesh's rendezvous
# a member's local group (several ranks behind one host-channel member):
ENV_LOCAL_RANK = "FEDML_MH_LOCAL_RANK"     # this process's rank in it
ENV_LOCAL_WORLD = "FEDML_MH_LOCAL_WORLD"   # its size
ENV_LOCAL_COORD = "FEDML_MH_LOCAL_COORD"   # host:port of its rendezvous

# ---------------------------------------------------------------------------
# process context + cluster spawning
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MultihostContext:
    """One process's place in the launched cluster (env-carried, so any
    entry point resolves it the same way)."""
    rank: int
    world: int
    coordinator: str                    # "host:port" of the HostChannel
    jax_coordinator: Optional[str] = None   # the mesh's rendezvous, when wired
    local_rank: int = 0                 # rank in the member's local group
    local_world: int = 1                # ranks behind this member

    @classmethod
    def from_env(cls) -> Optional["MultihostContext"]:
        if ENV_RANK not in os.environ or ENV_WORLD not in os.environ:
            return None
        world = int(os.environ[ENV_WORLD])
        rank = int(os.environ[ENV_RANK])
        if not 0 <= rank < world:
            raise ValueError(f"{ENV_RANK}={rank} outside world "
                             f"{world}")
        local_world = int(os.environ.get(ENV_LOCAL_WORLD, "1"))
        local_rank = int(os.environ.get(ENV_LOCAL_RANK, "0"))
        if not 0 <= local_rank < local_world:
            raise ValueError(f"{ENV_LOCAL_RANK}={local_rank} outside the "
                             f"local group of {local_world}")
        return cls(rank=rank, world=world,
                   coordinator=os.environ.get(ENV_COORD, "localhost:0"),
                   jax_coordinator=os.environ.get(ENV_JAX_COORD),
                   local_rank=local_rank, local_world=local_world)

    @classmethod
    def single(cls) -> "MultihostContext":
        return cls(rank=0, world=1, coordinator="localhost:0")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class MultihostLaunchError(RuntimeError):
    """A launched rank failed or hung; the message names it."""


def _rank_outcome(rc: Optional[int], policy_killed: bool = False) -> str:
    """One rank's exit, human-named: clean and nonzero exit codes, and
    the signal's name for a signal death (SIGKILL, the chaos or OOM
    shape, reads differently from SIGSEGV, a real crash, and from a
    plain nonzero exit, a named Python error)."""
    if rc is None:
        return "still running"
    if rc == 0:
        return "ok"
    if rc < 0:
        try:
            name = signal.Signals(-rc).name
        except ValueError:
            name = f"signal {-rc}"
        suffix = (" by launcher cleanup after the first failure"
                  if policy_killed else "")
        return f"killed by {name}{suffix}"
    return f"exit rc={rc}"


def spawn_cluster(cmd: list[str], procs: int, *,
                  env: Optional[dict] = None,
                  timeout_s: float = 600.0,
                  echo: bool = False,
                  coordinator_host: str = "localhost",
                  coordinator_port: Optional[int] = None,
                  elastic: bool = False,
                  respawn: bool = False,
                  kill_grace_s: float = 5.0,
                  jax_distributed: bool = False) -> list[str]:
    """Fork `procs` copies of `cmd` wired as one cluster (env
    FEDML_MH_RANK/WORLD/COORD); returns each rank's stdout, rank-ordered
    (a respawned rank's incarnations joined in order).

    Fail-fast policy (the default): the first rank to exit nonzero kills
    the rest and raises MultihostLaunchError naming that rank (with its
    stderr tail) and every rank's outcome: exit code, or the signal's
    name for a signal death, so an injected kill reads differently from
    the channel-EOF deaths it causes.  A deadline overrun kills
    everything and names the ranks still running.

    Elastic policy (`elastic=True`): a dead rank does not take the
    survivors down; the cluster runs to its end and only a rank-0
    (coordinator) failure or the deadline raises.  With `respawn=True` a
    dead rank other than 0 is started once more with FEDML_MH_REJOIN=1,
    so the worker re-enters the cluster through the elastic rejoin
    handshake (ElasticChannel).

    `echo` streams each child's stderr line-prefixed (`[rank i]`).  The
    coordinator binds `coordinator_port`, or a free port when None.

    `jax_distributed` also exports FEDML_MH_JAX_COORD, the rendezvous
    `init_multihost` joins torch.distributed's group at: port
    `coordinator_port` + 1 when a port is given (keep both above the
    ephemeral range), else another free port."""
    outs, _report = spawn_cluster_report(
        cmd, procs, env=env, timeout_s=timeout_s, echo=echo,
        coordinator_host=coordinator_host,
        coordinator_port=coordinator_port, elastic=elastic,
        respawn=respawn, kill_grace_s=kill_grace_s,
        jax_distributed=jax_distributed)
    return outs


def spawn_cluster_report(cmd: list[str], procs: int, *,
                         env: Optional[dict] = None,
                         timeout_s: float = 600.0,
                         echo: bool = False,
                         coordinator_host: str = "localhost",
                         coordinator_port: Optional[int] = None,
                         elastic: bool = False,
                         respawn: bool = False,
                         kill_grace_s: float = 5.0,
                         jax_distributed: bool = False
                         ) -> tuple[list[str], dict]:
    """spawn_cluster plus a per-rank outcome report: ({rank stdouts},
    {"ranks": {r: {"rc", "outcome", "respawned", "incarnations",
    "all_rcs"}}, "first_failed": r | None})."""
    if procs < 1:
        raise ValueError(f"procs must be >= 1, got {procs}")
    if not cmd:
        raise ValueError("empty worker command")
    if respawn and not elastic:
        raise ValueError("respawn=True needs elastic=True (a fail-fast "
                         "cluster kills the survivors the rejoiner "
                         "would rejoin)")
    port = free_port() if coordinator_port is None else coordinator_port
    coord = f"{coordinator_host}:{port}"
    base_env = {**os.environ, **(env or {}),
                ENV_WORLD: str(procs), ENV_COORD: coord}
    for key in ("FEDML_MH_REJOIN", ENV_JAX_COORD, ENV_LOCAL_RANK,
                ENV_LOCAL_WORLD, ENV_LOCAL_COORD):
        base_env.pop(key, None)
    if jax_distributed:
        dist_port = (free_port() if coordinator_port is None
                     else coordinator_port + 1)
        base_env[ENV_JAX_COORD] = f"{coordinator_host}:{dist_port}"
    # per-rank incarnations (a respawn appends a second one)
    incarnations: list[list[subprocess.Popen]] = [[] for _ in range(procs)]
    bufs: dict[tuple[int, int], tuple[list, list]] = {}
    drains: list[threading.Thread] = []
    policy_killed: set[int] = set()

    def _drain(rank: int, gen: int, p: subprocess.Popen):
        buf_out: list = []
        buf_err: list = []
        bufs[(rank, gen)] = (buf_out, buf_err)

        def _pump(stream, buf, is_err):
            for line in stream:
                buf.append(line)
                if echo and is_err:
                    # stderr streams live (progress, tracebacks); stdout
                    # is returned buffered so machine-readable lines
                    # stay contiguous per rank
                    print(f"[rank {rank}] {line}", end="",
                          file=sys.stderr, flush=True)
        t_err = threading.Thread(target=_pump,
                                 args=(p.stderr, buf_err, True))
        t_err.start()
        _pump(p.stdout, buf_out, False)
        t_err.join()

    def _launch(rank: int, rejoin: bool = False) -> None:
        e = dict(base_env)
        e[ENV_RANK] = str(rank)
        if rejoin:
            e["FEDML_MH_REJOIN"] = "1"
        p = subprocess.Popen(cmd, env=e, text=True,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE)
        gen = len(incarnations[rank])
        incarnations[rank].append(p)
        t = threading.Thread(target=_drain, args=(rank, gen, p))
        t.start()
        drains.append(t)

    def _cur(rank: int) -> subprocess.Popen:
        return incarnations[rank][-1]

    def _live() -> list[int]:
        return [r for r in range(procs) if _cur(r).poll() is None]

    def _kill(ranks) -> None:
        for r in ranks:
            policy_killed.add(r)
            _cur(r).kill()
        for r in ranks:      # reap: the summary must show the kill
            try:             # outcome, not "still running"
                _cur(r).wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass

    try:
        for r in range(procs):
            _launch(r)
    except BaseException:
        for ps in incarnations:
            for p in ps:
                p.kill()
                p.wait()
        for t in drains:
            t.join()
        raise

    def _summary() -> str:
        rows = []
        for r in range(procs):
            tags = [_rank_outcome(p.poll(), r in policy_killed)
                    for p in incarnations[r]]
            rows.append(f"rank {r}: " + " -> respawned: ".join(tags))
        return "; ".join(rows)

    def _err_tail(rank: int) -> str:
        return "".join("".join(bufs.get((rank, g), ([], []))[1])
                       for g in range(len(incarnations[rank])))[-3000:]

    deadline = time.monotonic() + timeout_s
    first_failed: Optional[int] = None
    handled: set[tuple[int, int]] = set()
    respawned: set[int] = set()
    try:
        while True:
            for r in range(procs):
                for g, p in enumerate(incarnations[r]):
                    if (p.poll() is not None and p.returncode != 0
                            and (r, g) not in handled):
                        handled.add((r, g))
                        if first_failed is None:
                            first_failed = r
                        if (elastic and respawn and r != 0
                                and r not in respawned):
                            respawned.add(r)
                            log.warning(
                                "elastic launch: rank %d died (%s); "
                                "respawning once with FEDML_MH_REJOIN=1",
                                r, _rank_outcome(p.returncode))
                            _launch(r, rejoin=True)
            live = _live()
            if elastic:
                # survivors outlive a dead peer; only the coordinator's
                # death (or the deadline) is fatal to the cluster
                if _cur(0).poll() is not None and _cur(0).returncode != 0:
                    break
                if not live:
                    break
            elif first_failed is not None or not live:
                break
            if time.monotonic() > deadline:
                _kill(live)
                raise MultihostLaunchError(
                    f"multihost launch timed out after {timeout_s:.0f}s: "
                    f"rank(s) {live} still running (of {procs})\n"
                    f"per-rank: {_summary()}")
            time.sleep(0.05)
        if any(p.returncode not in (0, None)
               for ps in incarnations for p in ps):
            # give survivors a short grace (a dead peer's channel EOF
            # usually fails them promptly with their OWN named error;
            # elastic survivors already ran to their end), then kill
            # what still runs
            grace = time.monotonic() + kill_grace_s
            while time.monotonic() < grace and _live():
                time.sleep(0.05)
            _kill(_live())
    except BaseException:
        _kill(_live())
        raise
    finally:
        for t in drains:
            t.join()
    report = {
        "first_failed": first_failed,
        "ranks": {r: {"rc": _cur(r).returncode,
                      "outcome": _rank_outcome(_cur(r).returncode,
                                               r in policy_killed),
                      "respawned": r in respawned,
                      "incarnations": len(incarnations[r]),
                      "all_rcs": [p.returncode for p in incarnations[r]]}
                  for r in range(procs)},
    }
    bad = [r for r in range(procs) if _cur(r).returncode != 0]
    if bad and (not elastic or 0 in bad):
        # blame the FIRST rank observed failing (the injected or original
        # fault), not a survivor that died of the resulting channel EOF
        i = first_failed if first_failed in bad else bad[0]
        raise MultihostLaunchError(
            f"multihost rank {i}/{procs} failed first "
            f"(rc={_cur(i).returncode}; {len(bad)}/{procs} ranks "
            f"failed):\nper-rank: {_summary()}\n{_err_tail(i)}")
    outs = ["".join("".join(bufs.get((r, g), ([], []))[0])
                    for g in range(len(incarnations[r])))
            for r in range(procs)]
    return outs, report


# ---------------------------------------------------------------------------
# the mesh helpers: torch.distributed's group and the meshes over it
# ---------------------------------------------------------------------------

def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   required: bool = False,
                   timeout_s: float = 300.0) -> None:
    """Join this process into torch.distributed's gloo group (idempotent).

    Arguments left None come from the launcher's env: the rendezvous
    ``host:port`` from FEDML_MH_JAX_COORD (the JAX package's name for
    it), the world and rank from FEDML_MH_WORLD / FEDML_MH_RANK.  With no
    arguments on a single process it is a no-op, and a failure is logged,
    not raised.  With EXPLICIT arguments, or `required=True`, a failure
    raises: training independent replicas without a word would corrupt
    the run.  A rank that cannot join before `timeout_s` raises too (the
    same deadline bounds every later collective)."""
    import datetime

    import torch.distributed as dist
    if dist.is_initialized():
        return
    explicit = (required or coordinator_address is not None
                or num_processes is not None or process_id is not None)
    coord = coordinator_address or os.environ.get(ENV_JAX_COORD)
    world = (num_processes if num_processes is not None
             else int(os.environ[ENV_WORLD]) if ENV_WORLD in os.environ
             else None)
    rank = (process_id if process_id is not None
            else int(os.environ[ENV_RANK]) if ENV_RANK in os.environ
            else None)
    try:
        if coord is None or world is None or rank is None:
            raise RuntimeError(
                f"no rendezvous: {ENV_JAX_COORD}, {ENV_WORLD} and "
                f"{ENV_RANK} name it (spawn_cluster(jax_distributed=True) "
                f"exports them)")
        if world == 1 and not explicit:
            log.info("multihost: a world of one process; no group")
            return
        host = coord.rsplit(":", 1)[0]
        if host in ("localhost", "127.0.0.1", "::1"):
            # ranks of one machine: gloo's pairs over loopback, whatever
            # the hostname resolves to
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coord}", world_size=int(world),
            rank=int(rank), timeout=datetime.timedelta(seconds=timeout_s))
        log.info("multihost: process %d/%d joined the gloo group at %s",
                 rank, world, coord)
    except Exception as e:
        if explicit:
            raise RuntimeError(
                f"multi-host initialization failed for coordinator "
                f"{coord!r}: {e}") from e
        log.info("multihost init skipped (%s); single-process mode", e)


def make_global_mesh(axis_name: str = CLIENT_AXIS) -> Mesh:
    """1-D mesh over EVERY rank of the group: the cohort axis spans the
    cluster."""
    return make_mesh(axis_name=axis_name)


def member_ranks(ctx: Optional[MultihostContext] = None) -> list:
    """The ranks of torch.distributed's world that sit behind this
    process's host-channel member: the member's local group.  Its world is
    either the group alone (the ranks a member started, `join_local_group`)
    or every member's group (launched with ``--jax-distributed``: member m
    holds ranks m*k .. m*k + k - 1); without a local group, this rank."""
    ctx = ctx if ctx is not None else (MultihostContext.from_env()
                                       or MultihostContext.single())
    n_world, rank = mesh_world()
    k = ctx.local_world
    if n_world == k:
        return list(range(n_world))
    if k == 1:
        return [rank]
    if n_world != ctx.world * k:
        raise ValueError(
            f"a torch.distributed world of {n_world} ranks is neither one "
            f"member's local group ({k}) nor every member's ({ctx.world} "
            f"x {k})")
    m = rank // k
    return list(range(m * k, (m + 1) * k))


def make_local_mesh(axis_name: str = CLIENT_AXIS) -> Mesh:
    """1-D mesh of this host-channel member's local group (`member_ranks`):
    the intra-member tier of the two-level runner, which exchanges across
    members through its HostChannel instead.  Without a local group it is
    this process alone (no group, no collective).  Over every member's
    ranks each member's mesh is built on every rank, in member order
    (group creation is collective over the world)."""
    ctx = MultihostContext.from_env() or MultihostContext.single()
    n_world, rank = mesh_world()
    k = ctx.local_world
    if k == 1 or n_world == 1:
        return Mesh((axis_name,), np.array([rank], dtype=np.int64), rank)
    if n_world == k:
        return make_mesh(axis_name=axis_name)
    member_ranks(ctx)           # names a world that fits neither layout
    mine = None
    for m in range(n_world // k):
        mesh = make_mesh(axis_name=axis_name,
                         devices=range(m * k, (m + 1) * k))
        mine = mesh if mesh is not None else mine
    return mine


def exit_rank(rc: int) -> None:
    """End a rank process of a gloo world: run the atexit handlers (obs's
    export), flush, and leave without the interpreter's teardown, where
    gloo's threads may abort the process (std::terminate, "terminate
    called without an active exception") after its work is done."""
    import atexit
    atexit._run_exitfuncs()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)


class LocalGroup:
    """The further ranks a member's first rank started (`join_local_group`):
    `collect` waits for them and returns their stdout, `kill` ends them."""

    def __init__(self, procs: list):
        self.procs = procs

    def collect(self, timeout_s: float = 600.0) -> list:
        outs = []
        for i, p in enumerate(self.procs, start=1):
            out, _ = p.communicate(timeout=timeout_s)
            if p.returncode != 0:
                raise MultihostLaunchError(
                    f"local rank {i} of this member failed "
                    f"({_rank_outcome(p.returncode)})")
            outs.append(out)
        return outs

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def _exit_with_parent(ppid: int) -> None:
    """A local rank ends when the member's first rank (its parent) is
    gone: a member dies as a whole."""
    def watch():
        while os.getppid() == ppid:
            time.sleep(0.25)
        os._exit(3)
    threading.Thread(target=watch, daemon=True,
                     name="local-group-parent-watch").start()


def join_local_group(local_devices: int, cmd: list, *,
                     timeout_s: float = 300.0,
                     over_members: bool = False
                     ) -> tuple[MultihostContext, LocalGroup]:
    """Make this process one of `local_devices` ranks behind its
    host-channel member, joined by torch.distributed over gloo.

    The member's first rank (the process the launcher started) starts the
    k - 1 further ranks as `cmd` with FEDML_MH_LOCAL_RANK/WORLD/COORD in
    their env and the member's FEDML_MH_RANK; each of those ends when the
    first rank does.  The group's rendezvous is the host channel's port +
    2 + the member's rank (keep that many ports free above the
    coordinator's; `spawn_cluster(jax_distributed=True)` takes port + 1),
    and its world is the group alone.  With `over_members` the world is
    every member's ranks at the launcher's FEDML_MH_JAX_COORD instead
    (member m holds ranks m*k .. m*k + k - 1), so a mesh may span members;
    the two-level runner refuses one that does.

    Returns (this rank's context, the ranks it started: none unless it
    is the member's first rank)."""
    k = int(local_devices)
    ctx = MultihostContext.from_env() or MultihostContext.single()
    if k == 1:
        return ctx, LocalGroup([])
    procs = []
    if ctx.local_world == 1:
        if over_members:
            if not ctx.jax_coordinator:
                raise RuntimeError(
                    f"a world over every member's local group needs the "
                    f"launcher's {ENV_JAX_COORD} (launch --jax-distributed)")
            coord = ctx.jax_coordinator
        else:
            host, port = ctx.coordinator.rsplit(":", 1)
            coord = f"{host}:{int(port) + 2 + ctx.rank}"
        os.environ.update({ENV_LOCAL_WORLD: str(k), ENV_LOCAL_COORD: coord,
                           ENV_LOCAL_RANK: "0"})
        try:
            for i in range(1, k):
                procs.append(subprocess.Popen(
                    cmd, env={**os.environ, ENV_LOCAL_RANK: str(i)},
                    text=True, stdout=subprocess.PIPE))
        except BaseException:
            LocalGroup(procs).kill()
            raise
        ctx = MultihostContext.from_env()
    else:
        _exit_with_parent(os.getppid())
        if ctx.local_world != k:
            raise ValueError(f"local rank {ctx.local_rank} started for a "
                             f"group of {ctx.local_world}, configured {k}")
    group = LocalGroup(procs)
    coord = os.environ[ENV_LOCAL_COORD]
    try:
        if over_members:
            init_multihost(coordinator_address=coord,
                           num_processes=ctx.world * k,
                           process_id=ctx.rank * k + ctx.local_rank,
                           required=True, timeout_s=timeout_s)
        else:
            init_multihost(coordinator_address=coord, num_processes=k,
                           process_id=ctx.local_rank, required=True,
                           timeout_s=timeout_s)
    except BaseException:
        group.kill()
        raise
    return ctx, group


def host_mesh_layout(hosts: list, silos: Optional[int] = None
                     ) -> tuple[list, int]:
    """The rank order and silo count of make_hierarchical_host_mesh from
    each rank's hostname: ranks sorted by (hostname, rank), so a silo row
    holds one machine's ranks; `silos` defaults to the number of
    machines.  Warns when one machine holds every silo."""
    n = len(hosts)
    machines = len(set(hosts))
    silos = silos or machines
    if n % silos:
        raise ValueError(f"{n} ranks not divisible into {silos} silos")
    if machines == 1 and silos > 1:
        log.warning(
            "make_hierarchical_host_mesh: building %d VIRTUAL silos on one "
            "machine: every silo row shares this machine, so the "
            "cross-silo tier rides local links, not the network between "
            "machines.  This is the dev/test topology; launch each silo's "
            "ranks on its own machine so the silo tier really crosses "
            "machines.", silos)
    return sorted(range(n), key=lambda r: (hosts[r], r)), silos


def make_hierarchical_host_mesh(silos: Optional[int] = None) -> Mesh:
    """2-D (silo x clients) mesh with one silo per machine by default: the
    inner FedAvg fold stays among one machine's ranks, and only the
    per-silo means cross machines (SURVEY.md section 2.5, hierarchical
    aggregation).  Every rank calls it (the hostnames are gathered)."""
    import torch.distributed as dist
    n_world, _ = mesh_world()
    host = socket.gethostname()
    hosts = [host]
    if n_world > 1:
        hosts = [None] * n_world
        dist.all_gather_object(hosts, host)
    order, silos = host_mesh_layout(hosts, silos)
    return make_mesh_2d(n_silos=silos, devices=order)


# ---------------------------------------------------------------------------
# HostChannel: the inter-process tier
# ---------------------------------------------------------------------------

class DeadRankError(RuntimeError):
    """A peer rank died or stalled past the bounded channel timeout; the
    message names it."""


# A frame is u64 length + payload.  The coordinator's broadcast is one
# frame whose payload is u32 world, then each rank's payload as u64 length
# + bytes, rank-ordered: the JAX channel's wire format.  The port writes
# and reads its pieces in place (a carry is tens of MB: a joined copy of
# the blob, and a copy per received chunk, cost more than the loopback
# transfer), so received payloads are bytearrays.

def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack("<Q", len(payload)))
    sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:])
        if not k:
            raise ConnectionError("peer closed")
        got += k
    return buf


def _recv_frame(sock: socket.socket) -> bytearray:
    (n,) = struct.unpack("<Q", _recv_exact(sock, 8))
    return _recv_exact(sock, n)


def _send_parts(sock: socket.socket, parts: list) -> int:
    """The broadcast frame, written piece by piece; returns its bytes on
    the wire."""
    n = 4 + sum(8 + len(p) for p in parts)
    sock.sendall(struct.pack("<QI", n, len(parts)))
    for p in parts:
        sock.sendall(struct.pack("<Q", len(p)))
        sock.sendall(p)
    return n + 8


def _recv_parts(sock: socket.socket) -> tuple[list, int]:
    """(the rank-ordered payloads, the frame's length) of one broadcast,
    each payload received into its own buffer."""
    n, world = struct.unpack("<QI", _recv_exact(sock, 12))
    parts, used = [], 4
    for _ in range(world):
        (k,) = struct.unpack("<Q", _recv_exact(sock, 8))
        used += 8 + k
        if used > n:
            raise ConnectionError(f"malformed broadcast: {used} > {n} B")
        parts.append(_recv_exact(sock, k))
    if used != n:
        raise ConnectionError(f"malformed broadcast: {used} != {n} B")
    return parts, n


def _dial_with_backoff(host: str, port: int, deadline: float, what: str,
                       *, initial_s: float = 0.05,
                       cap_s: float = 1.0) -> socket.socket:
    """Deadline-bounded TCP dial with exponential backoff: a coordinator
    still setting up its accept refuses connects transiently, and
    retrying with growing sleeps (initial_s doubling to cap_s) inside
    the caller's deadline turns that window into latency instead of a
    launch failure.  The final failure raises DeadRankError naming
    `what` and the last OS error."""
    delay = initial_s
    last: Optional[Exception] = None
    while True:
        budget = deadline - time.monotonic()
        if budget <= 0:
            raise DeadRankError(
                f"{what}: could not connect to {host}:{port} before its "
                f"deadline (last error: "
                f"{type(last).__name__ if last is not None else 'none'}:"
                f" {last})") from last
        try:
            return socket.create_connection(
                (host, port), timeout=min(5.0, max(0.1, budget)))
        except OSError as e:
            last = e
            time.sleep(min(delay, max(0.0, deadline - time.monotonic())))
            delay = min(delay * 2.0, cap_s)


def _export_channel_byte_counters(rank: int, bytes_sent: int,
                                  bytes_received: int) -> None:
    """Publish a channel's cumulative byte counters as obs metrics
    (called at round boundaries: the counters themselves stay plain ints
    on the hot path)."""
    r = str(rank)
    sent = obs.counter("multihost_bytes_sent_total", rank=r)
    recv = obs.counter("multihost_bytes_received_total", rank=r)
    sent.inc(max(0.0, bytes_sent - sent.value))
    recv.inc(max(0.0, bytes_received - recv.value))


def _account_carry(raw: int, wire: int) -> None:
    """Carry-codec compression accounting: raw = the f32 bytes of the
    carry partials this rank encoded, wire = the encoded payload it
    shipped; the gauge is the cumulative raw/wire quotient."""
    c_raw = obs.counter("multihost_carry_raw_bytes_total")
    c_wire = obs.counter("multihost_carry_compressed_bytes_total")
    c_raw.inc(raw)
    c_wire.inc(wire)
    if c_wire.value > 0:
        obs.gauge("multihost_carry_compression_ratio").set(
            c_raw.value / c_wire.value)


class _GatherHandle:
    """In-flight state of ONE pipelined carry gather: rank 0 holds the
    background frame collector, workers the chained frame-push tail;
    gather_finish() consumes it.  One handle per collective."""

    __slots__ = ("n_frames", "deadline", "seq", "own", "pending",
                 "collector", "pushed", "aborted")

    def __init__(self, n_frames: int, deadline: float, seq: int):
        self.n_frames = int(n_frames)
        self.deadline = float(deadline)
        self.seq = int(seq)
        self.own: list[bytes] = []
        self.pending = None
        self.collector = None
        self.pushed = 0
        self.aborted = False


class _ContribHandle:
    """The early contributions of one elastic exchange: a worker chains
    one-block CONTRIB sends (the coordinator accepts several per round),
    rank 0 keeps its own blocks; ElasticChannel.exchange(pending=...)
    drains the handle.  A stale handle is harmless: the coordinator drops
    a CONTRIB whose round is not the one in flight."""

    __slots__ = ("round_idx", "blocks", "stash", "pending")

    def __init__(self, round_idx: int):
        self.round_idx = int(round_idx)
        self.blocks: list[int] = []
        self.stash: dict[int, bytes] = {}
        self.pending = None


class HostChannel:
    """Small-payload allgather/barrier between the cluster's processes,
    carrying the flat f32 carry partials of the two-level round.

    Star topology: rank 0 coordinates (gathers every rank's payload,
    broadcasts the rank-ordered list), so every failure has a single
    observer that can name the dead rank.  All waits are bounded
    (`timeout_s`): a dead peer raises DeadRankError naming it instead of
    hanging the round loop.  Bytes and times land in
    multihost_bytes_sent/received_total and multihost_allgather_seconds.
    Rank 0's barrier arrivals go to the cluster observatory's ledger
    (obs/cluster.py)."""

    def __init__(self, ctx: MultihostContext, *,
                 timeout_s: float = 120.0,
                 connect_timeout_s: float = 60.0):
        self.ctx = ctx
        self.timeout_s = float(timeout_s)
        self.bytes_sent = 0
        self.bytes_received = 0
        self._mark = (0, 0)
        self._seq = 0
        # the runner stamps the round in flight here so the barrier
        # ledger can attribute gather waits to a round
        self.round_hint: Optional[int] = None
        self._peers: dict[int, socket.socket] = {}
        self._sock: Optional[socket.socket] = None
        self._listener: Optional[socket.socket] = None
        _cluster.set_role(ctx.rank, ctx.world)
        if ctx.world <= 1:
            return
        host, port = ctx.coordinator.rsplit(":", 1)
        port = int(port)
        if ctx.rank == 0:
            self._listener = socket.create_server((host, port))
            self._listener.settimeout(connect_timeout_s)
            deadline = time.monotonic() + connect_timeout_s

            def _setup_dead(reason: str):
                missing = sorted(set(range(1, ctx.world))
                                 - set(self._peers))
                for s in self._peers.values():
                    s.close()
                self._listener.close()
                raise DeadRankError(
                    f"multihost channel setup: rank(s) {missing} "
                    f"{reason} within {connect_timeout_s:.0f}s")

            while len(self._peers) < ctx.world - 1:
                try:
                    conn, _ = self._listener.accept()
                except socket.timeout:
                    conn = None
                if conn is None or time.monotonic() > deadline:
                    _setup_dead("never connected")
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                # accepted sockets block whatever the listener's
                # timeout: bound the rank handshake too, or a
                # connected-but-stalled peer hangs setup
                conn.settimeout(max(0.001, deadline - time.monotonic()))
                try:
                    (r,) = struct.unpack("<I", _recv_exact(conn, 4))
                except (socket.timeout, ConnectionError, OSError):
                    conn.close()
                    _setup_dead("connected but never sent a rank "
                                "handshake")
                self._peers[r] = conn
        else:
            # rank 0's accept window opens asynchronously with this
            # process's start, so first-connect refusals are expected
            self._sock = _dial_with_backoff(
                host, port, time.monotonic() + connect_timeout_s,
                f"multihost channel setup: rank {ctx.rank} dialing the "
                f"rank-0 coordinator at {ctx.coordinator}")
            self._sock.setsockopt(socket.IPPROTO_TCP,
                                  socket.TCP_NODELAY, 1)
            self._sock.sendall(struct.pack("<I", ctx.rank))

    # -- collective ops ------------------------------------------------------
    def allgather(self, payload: bytes,
                  timeout_s: Optional[float] = None) -> list[bytes]:
        """Every rank contributes `payload`; every rank receives the
        rank-ordered list.  Bounded: a silent rank raises DeadRankError
        naming it."""
        t0 = time.perf_counter()
        timeout = self.timeout_s if timeout_s is None else float(timeout_s)
        self._seq += 1
        ctx = self.ctx
        if ctx.world <= 1:
            return [payload]
        deadline = time.monotonic() + timeout
        try:
            if ctx.rank == 0:
                # barrier ledger: rank 0's own arrival opens the loop,
                # each peer's is its frame landing.  Piggybacked metric
                # sidecars are stripped BEFORE the broadcast, so every
                # rank folds the identical payload bytes
                arrivals = {0: time.monotonic()}
                parts: list[Optional[bytes]] = [None] * ctx.world
                parts[0] = payload
                for r in sorted(self._peers):
                    sock = self._peers[r]
                    sock.settimeout(max(0.001,
                                        deadline - time.monotonic()))
                    try:
                        parts[r] = _recv_frame(sock)
                    except (socket.timeout, ConnectionError, OSError) as e:
                        missing = sorted(r2 for r2 in range(1, ctx.world)
                                         if parts[r2] is None)
                        raise DeadRankError(
                            f"multihost allgather #{self._seq}: no "
                            f"payload from rank(s) {missing} within "
                            f"{timeout:.0f}s ({type(e).__name__}: "
                            f"process dead or hung)") from e
                    arrivals[r] = time.monotonic()
                    self.bytes_received += len(parts[r])
                    parts[r], side = _cluster.split_sidecar(parts[r])
                    if side is not None:
                        _cluster.fold_remote(r, side)
                _cluster.note_barrier("allgather", self._seq,
                                      self.round_hint, arrivals)
                for r in sorted(self._peers):
                    try:
                        self.bytes_sent += _send_parts(self._peers[r],
                                                       parts)
                    except (socket.timeout, ConnectionError, OSError) as e:
                        raise DeadRankError(
                            f"multihost allgather #{self._seq}: "
                            f"broadcast to rank {r} failed "
                            f"({type(e).__name__}: rank died after "
                            f"contributing)") from e
                return list(parts)          # type: ignore[arg-type]
            # non-root: ship ours, await the broadcast.  settimeout()
            # persists on the socket: reset it before the send, or the
            # send runs under the last allgather's near-expired deadline
            self._sock.settimeout(max(0.001,
                                      deadline - time.monotonic()))
            # live telemetry plane: a bounded metrics delta as a
            # self-describing payload trailer, stripped by rank 0;
            # attached ONLY when an obs dir is configured, so the obs-off
            # wire stays byte-identical
            out = payload
            if _cluster.telemetry_enabled():
                out = _cluster.attach_sidecar(
                    payload, _rollup_delta(_cluster.SIDECAR_CAP_BYTES))
            try:
                _send_frame(self._sock, out)
            except (socket.timeout, ConnectionError, OSError) as e:
                raise DeadRankError(
                    f"multihost allgather #{self._seq}: rank {ctx.rank} "
                    f"could not ship its payload to the rank-0 "
                    f"coordinator ({type(e).__name__}: coordinator dead "
                    f"or backpressured past {timeout:.0f}s)") from e
            self.bytes_sent += len(out) + 8
            self._sock.settimeout(max(0.001, deadline - time.monotonic()))
            try:
                parts, n = _recv_parts(self._sock)
            except (socket.timeout, ConnectionError, OSError) as e:
                raise DeadRankError(
                    f"multihost allgather #{self._seq}: rank {ctx.rank} "
                    f"got no broadcast from the rank-0 coordinator "
                    f"within {timeout:.0f}s ({type(e).__name__}: "
                    f"coordinator dead, or a peer stalled it)") from e
            self.bytes_received += n
            return parts
        finally:
            obs.histogram("multihost_allgather_seconds").observe(
                time.perf_counter() - t0)

    def barrier(self, timeout_s: Optional[float] = None) -> None:
        self.allgather(b"", timeout_s=timeout_s)

    # -- per-round wire accounting -------------------------------------------
    def mark_round(self) -> None:
        """Open a per-round wire window: bytes per round are what the
        channel moved between mark_round() and round_wire_delta()."""
        self._mark = (self.bytes_sent, self.bytes_received)

    def round_wire_delta(self) -> dict[str, int]:
        s0, r0 = self._mark
        return {"sent": self.bytes_sent - s0,
                "received": self.bytes_received - r0}

    # -- pipelined gather (exchange under compute) ---------------------------
    def gather_begin(self, n_frames: int,
                     timeout_s: Optional[float] = None) -> _GatherHandle:
        """Open a pipelined allgather of `n_frames` frames per rank:
        each rank pushes frames as they materialize (gather_push) and
        the collective completes in gather_finish(), so frame j's
        transfer overlaps frame j+1's block compute.  Equivalent by
        construction to allgather(b"".join(frames)): the frames
        concatenate in push order and the broadcast blob is identical,
        which keeps the f32 escape hatch bitwise under overlap."""
        timeout = self.timeout_s if timeout_s is None else float(timeout_s)
        self._seq += 1
        h = _GatherHandle(n_frames, time.monotonic() + timeout, self._seq)
        if self.ctx.world > 1 and self.ctx.rank == 0 and h.n_frames:
            from fedml_tpu_torch.parallel.prefetch import AsyncValue
            h.collector = AsyncValue(self._collect_frames, h,
                                     name=f"gather#{h.seq}")
        return h

    def _collect_frames(self, h: _GatherHandle):
        """Rank 0's background collector: drain every peer's frames in
        per-peer FIFO order while rank 0's own blocks compute; joined in
        gather_finish() (errors re-raise there).  Returns (frames,
        arrivals): a peer arrives at the barrier when its LAST frame
        lands."""
        remaining = {r: h.n_frames for r in self._peers}
        frames: dict[int, list[bytes]] = {r: [] for r in self._peers}
        arrivals: dict[int, float] = {}
        by_sock = {s: r for r, s in self._peers.items()}
        while any(remaining.values()) and not h.aborted:
            budget = h.deadline - time.monotonic()
            if budget <= 0:
                owing = sorted(r for r, n in remaining.items() if n)
                raise DeadRankError(
                    f"multihost gather #{h.seq}: rank(s) {owing} still "
                    f"owe carry frames at the deadline (process dead, "
                    f"hung, or its block compute overran the window)")
            socks = [self._peers[r] for r, n in remaining.items() if n]
            try:
                rl, _, _ = select.select(socks, [], [], min(0.2, budget))
            except (OSError, ValueError):
                rl = []          # a sock closed under us: deadline names it
            for s in rl:
                r = by_sock[s]
                s.settimeout(max(0.001, h.deadline - time.monotonic()))
                try:
                    f = _recv_frame(s)
                except (socket.timeout, ConnectionError, OSError) as e:
                    raise DeadRankError(
                        f"multihost gather #{h.seq}: rank {r} died "
                        f"mid-frame ({type(e).__name__})") from e
                self.bytes_received += len(f)
                frames[r].append(f)
                remaining[r] -= 1
                if remaining[r] == 0:
                    arrivals[r] = time.monotonic()
        return frames, arrivals

    def gather_push(self, h: _GatherHandle, frame: bytes) -> None:
        """Ship one frame into an open gather.  Rank 0 keeps its own
        (they never cross the wire); workers chain the send onto the
        previous push, so socket writes serialize while the caller
        returns to computing the next block."""
        h.pushed += 1
        if self.ctx.world <= 1 or self.ctx.rank == 0:
            h.own.append(bytes(frame))
            return
        from fedml_tpu_torch.parallel.prefetch import AsyncValue

        prev = h.pending

        def _ship(prev=prev, frame=frame):
            if prev is not None:
                prev.result()
            self._sock.settimeout(max(0.001,
                                      h.deadline - time.monotonic()))
            try:
                _send_frame(self._sock, frame)
            except (socket.timeout, ConnectionError, OSError) as e:
                raise DeadRankError(
                    f"multihost gather #{h.seq}: rank {self.ctx.rank} "
                    f"could not ship a carry frame to the rank-0 "
                    f"coordinator ({type(e).__name__})") from e
            self.bytes_sent += len(frame) + 8

        h.pending = AsyncValue(_ship, name=f"gather_push#{h.seq}")

    def gather_finish(self, h: _GatherHandle) -> list[bytes]:
        """Complete the collective: the rank-ordered list of per-rank
        payloads (each rank's frames joined in push order), the shape
        allgather returns."""
        ctx = self.ctx
        if ctx.world <= 1:
            return [b"".join(h.own)]
        if h.pushed != h.n_frames:
            raise ValueError(
                f"multihost gather #{h.seq}: {h.pushed} frames pushed "
                f"but {h.n_frames} promised; the collective would "
                f"hang every peer")
        if ctx.rank == 0:
            # rank 0 arrives when its own frames are pushed and it
            # enters the finish; the collector stamps each peer
            t_own = time.monotonic()
            parts: list[bytes] = [b""] * ctx.world
            parts[0] = b"".join(h.own)
            frames, arrivals = (h.collector.result()
                                if h.collector is not None
                                else ({r: [] for r in self._peers}, {}))
            arrivals[0] = t_own
            _cluster.note_barrier("gather", h.seq, self.round_hint,
                                  arrivals)
            for r, fl in frames.items():
                parts[r] = fl[0] if len(fl) == 1 else b"".join(fl)
            for r in sorted(self._peers):
                try:
                    self._peers[r].settimeout(
                        max(0.001, h.deadline - time.monotonic()))
                    self.bytes_sent += _send_parts(self._peers[r], parts)
                except (socket.timeout, ConnectionError, OSError) as e:
                    raise DeadRankError(
                        f"multihost gather #{h.seq}: broadcast to rank "
                        f"{r} failed ({type(e).__name__}: rank died "
                        f"after contributing)") from e
            return parts
        if h.pending is not None:
            h.pending.result()           # drain the push tail first
        self._sock.settimeout(max(0.001, h.deadline - time.monotonic()))
        try:
            parts, n = _recv_parts(self._sock)
        except (socket.timeout, ConnectionError, OSError) as e:
            raise DeadRankError(
                f"multihost gather #{h.seq}: rank {ctx.rank} got no "
                f"broadcast from the rank-0 coordinator "
                f"({type(e).__name__}: coordinator dead, or a peer "
                f"stalled it)") from e
        self.bytes_received += n
        return parts

    def gather_abort(self, h: _GatherHandle) -> None:
        """Invalidate an in-flight gather on the error path: the
        collector exits at its next poll instead of waiting out the
        deadline, and the push tail is drained best-effort."""
        h.aborted = True
        for av in (h.pending, h.collector):
            if av is not None:
                try:
                    av.result()
                except Exception:
                    pass

    def export_byte_counters(self) -> None:
        _export_channel_byte_counters(self.ctx.rank, self.bytes_sent,
                                      self.bytes_received)

    def close(self) -> None:
        for s in self._peers.values():
            try:
                s.close()
            except OSError:
                pass
        self._peers.clear()
        for s in (self._sock, self._listener):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self._sock = self._listener = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# topology-independent block sampling and the host fold
# ---------------------------------------------------------------------------

class BlockCohortSampler:
    """Per-block cohort sampling over fixed population ranges, the
    sampling half of the bitwise anchor.

    The population [0, C) splits into `n_blocks` contiguous ranges;
    block b draws `k_per_block` clients without replacement from its
    range on a private `default_rng([seed, round, block])` stream.  Every
    quantity is a pure function of (seed, round, block), not of which
    process computes it, and the draw touches no global RNG, so it is
    safe on a background thread."""

    def __init__(self, population: int, n_blocks: int, k_per_block: int,
                 seed: int):
        if n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
        if population % n_blocks:
            raise ValueError(
                f"population ({population}) must divide evenly into "
                f"{n_blocks} blocks (the id-range partition must be "
                f"topology-independent)")
        self.population = int(population)
        self.n_blocks = int(n_blocks)
        self.range_size = population // n_blocks
        if not 1 <= k_per_block <= self.range_size:
            raise ValueError(
                f"k_per_block ({k_per_block}) must be in [1, "
                f"{self.range_size}] (each block samples within its "
                f"{self.range_size}-client range)")
        self.k_per_block = int(k_per_block)
        self.seed = int(seed)

    def sample_block(self, round_idx: int, block: int) -> np.ndarray:
        """Global client ids of block `block`'s round-`round_idx`
        cohort, sorted ascending (one canonical order for every
        topology)."""
        if not 0 <= block < self.n_blocks:
            raise ValueError(f"block {block} outside [0, "
                             f"{self.n_blocks})")
        lo = block * self.range_size
        if self.k_per_block == self.range_size:
            return np.arange(lo, lo + self.range_size, dtype=np.int64)
        rng = np.random.default_rng(
            [self.seed, int(round_idx), int(block)])
        ids = rng.choice(self.range_size, size=self.k_per_block,
                         replace=False)
        return np.sort(ids).astype(np.int64) + lo


def fold_block_partials(parts: dict[int, np.ndarray],
                        n_blocks: int) -> np.ndarray:
    """THE deterministic inter-process reduction: a left fold of the
    per-block f32 partials in global block order, on the host.  Float
    addition is not associative, so the fold order is the contract:
    never a tree reduction or a kernel here."""
    missing = [b for b in range(n_blocks) if b not in parts]
    if missing:
        raise DeadRankError(
            f"two-level fold: block partial(s) {missing} missing from "
            f"the allgather (owning rank dead mid-round?)")
    total = np.array(parts[0], dtype=np.float32, copy=True)
    for b in range(1, n_blocks):
        total += np.asarray(parts[b], dtype=np.float32)
    return total


def fold_sparse_partials(pairs: dict[int, tuple], n_blocks: int,
                         dim: int) -> np.ndarray:
    """Sparse twin of ``fold_block_partials``: scatter-add each block's
    (idx, vals) pairs into the flat f32 carry in global block order,
    never densifying a per-block vector.  Per element the additions come
    in the dense fold's block order, so ranks agree for the same
    reason."""
    missing = [b for b in range(n_blocks) if b not in pairs]
    if missing:
        raise DeadRankError(
            f"two-level fold: block partial(s) {missing} missing from "
            f"the allgather (owning rank dead mid-round?)")
    total = np.zeros(int(dim), dtype=np.float32)
    for b in range(n_blocks):
        idx, vals = pairs[b]
        # top-k indices are unique within a block, so fancy-index +=
        # is a well-defined scatter-add
        total[idx] += np.asarray(vals, dtype=np.float32)
    return total


# ---------------------------------------------------------------------------
# elastic membership: epoch-numbered views, heartbeats, deterministic block
# re-adoption, rejoin
# ---------------------------------------------------------------------------

def _send_msg(sock: socket.socket, mtype: str, header: dict,
              payload=b"") -> int:
    """One elastic-protocol message: a frame of [u32 header length][JSON
    header with its "t" type, keys sorted][payload], the JAX channel's
    bytes.  `payload` may be a list of byte-like pieces, written in
    order without joining them.  Returns the bytes on the wire."""
    hdr = json.dumps({"t": mtype, **header}, sort_keys=True).encode()
    pieces = payload if isinstance(payload, (list, tuple)) else [payload]
    n = 4 + len(hdr) + sum(memoryview(p).nbytes for p in pieces)
    sock.sendall(struct.pack("<QI", n, len(hdr)) + hdr)
    for p in pieces:
        if memoryview(p).nbytes:
            sock.sendall(p)
    return n + 8


def _recv_msg(sock: socket.socket) -> tuple[str, dict, memoryview, int]:
    """(type, header, payload, bytes on the wire) of one message; the
    payload is a view into the received frame (no copy)."""
    frame = _recv_frame(sock)
    (n,) = struct.unpack_from("<I", frame, 0)
    hdr = json.loads(bytes(frame[4:4 + n]).decode())
    return hdr.pop("t"), hdr, memoryview(frame)[4 + n:], len(frame) + 8


@dataclasses.dataclass(frozen=True)
class ClusterView:
    """One epoch of elastic membership: the sorted live ranks and the
    deterministic item -> owner map.  `n_items` is the fixed block space
    (the reduction tree's shape, never repartitioned); only ownership
    moves.  owner_of is a pure function of (members, n_items), so every
    rank that knows the member list derives the same partition.  With the
    full initial membership and a block count that the world divides it
    is the contiguous tiling (rank r owns blocks [r·B/W, (r+1)·B/W))."""
    epoch: int
    members: tuple
    n_items: int

    def owner_of(self, item: int) -> int:
        if not 0 <= item < self.n_items:
            raise ValueError(f"item {item} outside [0, {self.n_items})")
        return self.members[item * len(self.members) // self.n_items]

    def assigned(self, rank: int) -> tuple:
        return tuple(i for i in range(self.n_items)
                     if self.owner_of(i) == rank)


class ElasticChannel:
    """Epoch-numbered elastic membership over the HostChannel's star.
    Rank 0 coordinates: it owns the member list, detects death (the data
    link's EOF, bounded waits, and heartbeats: a stopped rank stops
    heartbeating and is suspected within `hb_timeout_s`, between
    exchanges too), drives view changes, and admits rejoiners at commit
    barriers.

    The collective is `exchange(round, parts, compute)`, a block-keyed
    allgather.  Every item is a pure function of (seed, round, block),
    not of who computes it, so when a rank dies mid-round the coordinator
    asks the survivors for exactly the missing items (`need` lists in
    VIEW messages, owners from ClusterView.owner_of over the shrunk
    membership) and the round completes with the bytes of a clean run.

    Every connection's first frame is a typed hello: "data" (CONTRIB,
    VIEW, RESULT, DUMP), "hb" (heartbeats) or "rejoin" (checked against
    the config digest: REJECT by name on a mismatch, else a SNAPSHOT
    {epoch, resume_round, members, tag} with the runner's blob at the next
    commit barrier).  Rank 0's death is fatal by design: workers name it
    in DeadRankError.  The frames are the JAX channel's byte for byte.
    Byte counters are bumped from the exchange thread and the handler
    threads, under their own lock."""

    def __init__(self, ctx: MultihostContext, *, n_items: int,
                 config_digest: str = "",
                 timeout_s: float = 120.0,
                 connect_timeout_s: float = 60.0,
                 hb_interval_s: float = 0.25,
                 hb_timeout_s: float = 2.0,
                 rejoin: bool = False):
        if n_items < 1:
            raise ValueError(f"n_items must be >= 1, got {n_items}")
        self.ctx = ctx
        self.n_items = int(n_items)
        self.config_digest = str(config_digest)
        self.timeout_s = float(timeout_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.hb_interval_s = float(hb_interval_s)
        self.hb_timeout_s = float(hb_timeout_s)
        self.bytes_sent = 0
        self.bytes_received = 0
        self._mark = (0, 0)
        self.view = ClusterView(0, tuple(range(ctx.world)), self.n_items)
        self.view_events: list[dict] = []
        # fault hook: a paused sender is a hung (stopped) rank whose
        # process still runs
        self.hb_paused = False
        self._item_nbytes: Optional[int] = None
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()     # byte counters only
        self._send_lock = threading.Lock()   # rank 0's data-link writes
        self._cond = threading.Condition(self._lock)
        self._closed = False
        self._sock: Optional[socket.socket] = None        # worker data
        self._hb_sock: Optional[socket.socket] = None     # worker hb
        self._listener: Optional[socket.socket] = None
        self._data: dict[int, socket.socket] = {}         # coordinator
        self._hb: dict[int, socket.socket] = {}
        self._hb_last: dict[int, float] = {}
        self._suspect: dict[int, str] = {}
        self._pending_rejoin: list[tuple[int, socket.socket]] = []
        # a later round's contributions read while a result was being
        # sent (_send_draining), handed to that round's exchange
        self._early_frames: list[tuple] = []
        host, port = ctx.coordinator.rsplit(":", 1)
        self._host, self._port = host, int(port)
        _cluster.set_role(ctx.rank, ctx.world, elastic=True)
        if ctx.world <= 1:
            return
        if ctx.rank == 0:
            # coordinated incident dumps fan out through this channel's
            # DUMP frames (only with telemetry on: the obs-off wire stays
            # clean)
            _cluster.set_dump_broadcaster(self._broadcast_dump_frames)
            grace = time.monotonic() + self.connect_timeout_s
            for m in self.view.members:
                if m != 0:
                    self._hb_last[m] = grace   # connect grace
            self._listener = socket.create_server((host, self._port))
            self._listener.settimeout(0.25)
            threading.Thread(target=self._accept_loop, daemon=True,
                             name="elastic-accept").start()
        elif not rejoin:
            self._connect_worker()
        # rejoin=True defers all dialing to rejoin_handshake()

    # -- byte-counted message wrappers ---------------------------------------
    def _send(self, sock, mtype, header, payload=b"") -> None:
        if self.ctx.rank == 0:
            with self._send_lock:
                n = _send_msg(sock, mtype, header, payload)
        else:
            n = _send_msg(sock, mtype, header, payload)
        with self._io_lock:
            self.bytes_sent += n

    def _recv(self, sock):
        mtype, hdr, payload, n = _recv_msg(sock)
        with self._io_lock:
            self.bytes_received += n
        return mtype, hdr, payload

    # -- per-round wire accounting -------------------------------------------
    def mark_round(self) -> None:
        """Open a per-round wire window (HostChannel.mark_round's
        contract, under the io lock: the handler threads bump the
        counters too)."""
        with self._io_lock:
            self._mark = (self.bytes_sent, self.bytes_received)

    def round_wire_delta(self) -> dict[str, int]:
        with self._io_lock:
            s0, r0 = self._mark
            return {"sent": self.bytes_sent - s0,
                    "received": self.bytes_received - r0}

    # -- worker side ---------------------------------------------------------
    def _connect_worker(self) -> None:
        ctx = self.ctx
        deadline = time.monotonic() + self.connect_timeout_s
        self._sock = _dial_with_backoff(
            self._host, self._port, deadline,
            f"elastic channel: rank {ctx.rank} data link to the "
            f"coordinator at {ctx.coordinator}")
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._send(self._sock, "hello",
                   {"rank": ctx.rank, "role": "data",
                    "digest": self.config_digest})
        self._sock.settimeout(max(0.1, deadline - time.monotonic()))
        try:
            mtype, hdr, _ = self._recv(self._sock)
        except (socket.timeout, ConnectionError, OSError) as e:
            raise DeadRankError(
                f"elastic channel: rank {ctx.rank} got no hello reply "
                f"from the coordinator within "
                f"{self.connect_timeout_s:.0f}s "
                f"({type(e).__name__})") from e
        if mtype == "reject":
            raise DeadRankError(hdr.get("error", "rejected"))
        self._install_view(hdr)
        self._hb_sock = _dial_with_backoff(
            self._host, self._port, deadline,
            f"elastic channel: rank {ctx.rank} heartbeat link to the "
            f"coordinator at {ctx.coordinator}")
        self._send(self._hb_sock, "hello",
                   {"rank": ctx.rank, "role": "hb"})
        threading.Thread(target=self._hb_loop, daemon=True,
                         name=f"elastic-hb-{ctx.rank}").start()

    def _hb_loop(self) -> None:
        while not self._closed:
            if not self.hb_paused:
                # the live telemetry plane: a bounded metrics delta on
                # the heartbeat's header, only with telemetry on (the
                # obs-off header stays exactly {})
                hdr = {}
                if _cluster.telemetry_enabled():
                    d = _rollup_delta(_cluster.SIDECAR_CAP_BYTES)
                    if d is not None:
                        hdr["delta"] = d
                try:
                    self._send(self._hb_sock, "hb", hdr)
                except (OSError, AttributeError):
                    return      # coordinator gone: the data path names it
            time.sleep(self.hb_interval_s)

    def _install_view(self, hdr: dict) -> None:
        v = ClusterView(int(hdr["epoch"]),
                        tuple(int(m) for m in hdr["members"]),
                        self.n_items)
        if v.epoch < self.view.epoch:
            return                       # stale (reordered) view
        if v.epoch > self.view.epoch:
            self.view_events.append({"epoch": v.epoch,
                                     "members": list(v.members)})
            obs.counter("multihost_view_changes_total").inc()
        self.view = v
        obs.gauge("multihost_epoch", rank=str(self.ctx.rank)).set(
            float(v.epoch))

    # -- coordinator side ----------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except (OSError, AttributeError):
                return
            threading.Thread(target=self._handle_hello, args=(conn,),
                             daemon=True).start()

    def _handle_hello(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(10.0)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            mtype, hdr, _ = self._recv(conn)
        except (socket.timeout, ConnectionError, OSError, ValueError):
            conn.close()
            return
        rank = int(hdr.get("rank", -1))
        role = hdr.get("role", mtype)
        if mtype == "rejoin" or role == "rejoin":
            self._handle_rejoin_hello(rank, hdr, conn)
            return
        if mtype != "hello" or rank < 0:
            conn.close()
            return
        if role == "data":
            if hdr.get("digest", "") != self.config_digest:
                try:
                    self._send(conn, "reject", {"error": (
                        f"elastic channel: rank {rank} config digest "
                        f"{hdr.get('digest', '')!r} does not match the "
                        f"cluster's {self.config_digest!r}: the "
                        f"two-level reduction would not be bitwise")})
                except OSError:
                    pass
                conn.close()
                return
            with self._cond:
                old = self._data.pop(rank, None)
                self._data[rank] = conn
                self._hb_last[rank] = max(
                    self._hb_last.get(rank, 0.0), time.monotonic())
                view = self.view
                self._cond.notify_all()
            if old is not None:
                try:
                    old.close()
                except OSError:
                    pass
            try:
                self._send(conn, "hello_ok",
                           {"epoch": view.epoch,
                            "members": list(view.members),
                            "n_items": self.n_items})
            except OSError:
                pass
        elif role == "hb":
            with self._lock:
                old = self._hb.pop(rank, None)
                self._hb[rank] = conn
                self._hb_last[rank] = max(
                    self._hb_last.get(rank, 0.0), time.monotonic())
            if old is not None:
                try:
                    old.close()
                except OSError:
                    pass
            self._hb_reader(rank, conn)
        else:
            conn.close()

    def _handle_rejoin_hello(self, rank: int, hdr: dict,
                             conn: socket.socket) -> None:
        """Check the digest now (a stale build is named at once), else
        queue the rejoiner for admission at the next commit barrier."""
        digest = hdr.get("digest", "")
        if digest != self.config_digest:
            try:
                self._send(conn, "reject", {"error": (
                    f"elastic rejoin: rank {rank} config digest "
                    f"{digest!r} does not match the cluster's "
                    f"{self.config_digest!r}: stale config or code; "
                    f"admission refused")})
            except OSError:
                pass
            conn.close()
            obs.counter("multihost_rejoins_rejected_total").inc()
            return
        with self._lock:
            self._pending_rejoin.append((rank, conn))
        obs.instant("multihost.rejoin_request", rank=rank)
        log.info("elastic: rank %d requested rejoin (pending admission "
                 "at the next commit barrier)", rank)

    def _hb_reader(self, rank: int, conn: socket.socket) -> None:
        conn.settimeout(self.hb_timeout_s)
        while not self._closed:
            try:
                mtype, hdr, _ = self._recv(conn)
                with self._lock:
                    self._hb_last[rank] = time.monotonic()
                    self._suspect.pop(rank, None)
                _cluster.note_heartbeat(rank)
                delta = hdr.get("delta") if mtype == "hb" else None
                if delta:
                    _cluster.fold_remote(rank, delta)
            except socket.timeout:
                with self._lock:
                    fresh = (rank in self.view.members
                             and rank not in self._suspect)
                    if fresh:
                        self._suspect[rank] = (
                            f"no heartbeat for {self.hb_timeout_s:.1f}s "
                            f"(process hung or stopped)")
                if fresh:
                    obs.instant("multihost.rank_suspect", rank=rank)
                    obs.counter("multihost_rank_suspects_total",
                                rank=str(rank)).inc()
                    log.warning("elastic: rank %d heartbeat silent, "
                                "suspected hung", rank)
            except (ConnectionError, OSError, ValueError):
                with self._lock:
                    if rank in self.view.members:
                        self._suspect.setdefault(
                            rank, "heartbeat link closed")
                return

    def wait_members(self) -> None:
        """Rank 0's setup barrier: wait for every initial member's data
        link within connect_timeout_s; ranks that never connect are
        evicted (an epoch bump, logged) instead of failing the launch."""
        if self.ctx.rank != 0 or self.ctx.world <= 1:
            return
        deadline = time.monotonic() + self.connect_timeout_s
        with self._cond:
            while time.monotonic() < deadline:
                missing = [m for m in self.view.members
                           if m != 0 and m not in self._data]
                if not missing:
                    return
                self._cond.wait(0.1)
            missing = [m for m in self.view.members
                       if m != 0 and m not in self._data]
        if missing:
            log.warning("elastic setup: rank(s) %s never connected "
                        "within %.0fs: evicting them and starting "
                        "without them", missing, self.connect_timeout_s)
            self._coord_view_change(missing, -1, None, None,
                                    reason="never connected at setup")

    def _coord_view_change(self, dead: list, round_idx: int,
                           have: Optional[dict], compute,
                           reason: str = "dead or hung") -> None:
        """The view change: evict `dead`, bump the epoch, send every
        surviving member a VIEW with the members and the missing items it
        now owns, then compute rank 0's own newly owned missing items.
        Latency runs to the point every survivor is re-tasked; the
        recompute is goodput, not membership latency."""
        t0 = time.perf_counter()
        dead = sorted(set(int(r) for r in dead))
        with obs.span("multihost.view_change",
                      epoch=self.view.epoch + 1, round=round_idx):
            with self._lock:
                for r in dead:
                    self._suspect.pop(r, None)
                    for tbl in (self._data, self._hb):
                        s = tbl.pop(r, None)
                        if s is not None:
                            try:
                                s.close()
                            except OSError:
                                pass
                members = tuple(m for m in self.view.members
                                if m not in dead)
                self.view = ClusterView(self.view.epoch + 1, members,
                                        self.n_items)
                view = self.view
                socks = dict(self._data)
            for r in dead:
                obs.counter("multihost_rank_deaths_total",
                            rank=str(r)).inc()
            obs.counter("multihost_view_changes_total").inc()
            obs.gauge("multihost_epoch", rank="0").set(float(view.epoch))
            missing = ([] if have is None else
                       [b for b in range(self.n_items) if b not in have])
            for m in view.members:
                if m == 0 or m not in socks:
                    continue
                need = [b for b in missing if view.owner_of(b) == m]
                try:
                    socks[m].settimeout(self.timeout_s)
                    self._send(socks[m], "view",
                               {"epoch": view.epoch, "round": round_idx,
                                "members": list(view.members),
                                "need": need})
                except (socket.timeout, OSError):
                    with self._lock:
                        self._suspect.setdefault(
                            m, "view notification failed")
        latency = time.perf_counter() - t0
        obs.histogram("multihost_view_change_seconds").observe(latency)
        self.view_events.append({
            "epoch": view.epoch, "round": round_idx, "dead": dead,
            "members": list(view.members), "latency_s": latency,
            "reason": reason})
        log.warning("elastic view change: epoch %d, rank(s) %s evicted "
                    "(%s), members now %s (%.1f ms)", view.epoch, dead,
                    reason, list(view.members), latency * 1e3)
        # every survivor snapshots the same incident window (throttled;
        # a no-op with telemetry off)
        _cluster.maybe_coordinated_dump(
            f"view_change:epoch{view.epoch}:dead{dead}")
        if have is not None and compute is not None:
            mine = [b for b in missing if view.owner_of(b) == 0]
            if mine:
                got = {int(b): bytes(v) for b, v in compute(mine).items()}
                self._note_items(got.values())
                have.update(got)

    # -- the elastic collective ----------------------------------------------
    def _note_items(self, values) -> None:
        for v in values:
            n = memoryview(v).nbytes
            if self._item_nbytes is None:
                self._item_nbytes = n
            elif n != self._item_nbytes:
                raise ValueError(
                    f"elastic exchange: item payload of {n} bytes, "
                    f"expected {self._item_nbytes} (config skew or a "
                    f"truncated frame)")

    def contrib_begin(self, round_idx: int) -> _ContribHandle:
        """Open an early-contribution window for `round_idx`: blocks
        pushed through contrib_push ship while the remaining blocks still
        compute, and exchange(pending=h) closes the window."""
        return _ContribHandle(round_idx)

    def contrib_push(self, h: _ContribHandle, block: int,
                     data: bytes) -> None:
        """Ship one block's payload into an open window.  Rank 0 keeps
        its own (they never cross the wire); a worker chains a one-block
        CONTRIB send onto the previous push, so the socket writes stay in
        order while the caller computes the next block.  A death in the
        window surfaces at exchange(), whose re-adoption recomputes from
        the round's frozen state, never from this buffer."""
        data = bytes(data)
        self._note_items([data])
        h.blocks.append(int(block))
        if self.ctx.world <= 1 or self.ctx.rank == 0:
            h.stash[int(block)] = data
            return
        from fedml_tpu_torch.parallel.prefetch import AsyncValue

        prev = h.pending

        def _ship(prev=prev, block=int(block), data=data):
            if prev is not None:
                prev.result()
            self._send_contrib(h.round_idx, {block: data})

        h.pending = AsyncValue(_ship, name=f"contrib_push#{h.round_idx}")

    def exchange(self, round_idx: int, parts: dict,
                 compute: Optional[Callable] = None,
                 pending: Optional[_ContribHandle] = None
                 ) -> tuple[dict, ClusterView]:
        """The block-keyed elastic allgather: contribute `parts` ({item:
        bytes or f32 array}), receive all n_items payloads and the view
        that completed the round.  `compute(items)` is the re-adoption
        callback, called on this thread when a view change assigns a dead
        rank's missing items here.  `pending` closes a contrib_begin
        window.  Every rank receives the same payload set, so a
        deterministic fold over it commits the same bits on every
        survivor."""
        t0 = time.perf_counter()
        parts = {int(b): (v.tobytes() if hasattr(v, "tobytes")
                          else bytes(v))
                 for b, v in parts.items()}
        self._note_items(parts.values())
        pre_sent: tuple = ()
        if pending is not None:
            if pending.round_idx != round_idx:
                raise ValueError(
                    f"elastic exchange round {round_idx}: pending "
                    f"contributions belong to round {pending.round_idx}")
            if self.ctx.rank == 0 or self.ctx.world <= 1:
                parts = {**pending.stash, **parts}
            else:
                if pending.pending is not None:
                    pending.pending.result()   # DeadRankError re-raises
                pre_sent = tuple(pending.blocks)
        try:
            if self.ctx.rank == 0:
                return self._exchange_coord(round_idx, parts, compute)
            return self._exchange_worker(round_idx, parts, compute,
                                         pre_sent)
        finally:
            obs.histogram("multihost_allgather_seconds").observe(
                time.perf_counter() - t0)

    def _exchange_coord(self, round_idx, parts, compute):
        have: dict = dict(parts)
        # barrier ledger: rank 0 arrives with its own parts in hand, each
        # member at its first accepted CONTRIB of this round
        arrivals: dict[int, float] = {self.ctx.rank: time.monotonic()}

        def take(m, mtype, hdr, payload):
            """One frame from member m's data link."""
            if mtype != "contrib":
                return
            if int(hdr.get("round", -1)) != round_idx:
                log.warning("elastic: dropping stale contrib for "
                            "round %s from rank %d (at round %d)",
                            hdr.get("round"), m, round_idx)
                return
            arrivals.setdefault(m, time.monotonic())
            blocks = [int(b) for b in hdr.get("blocks", [])]
            if self._item_nbytes is None and blocks:
                self._item_nbytes = len(payload) // len(blocks)
            sz = self._item_nbytes or 0
            if sz * len(blocks) != len(payload):
                with self._lock:
                    self._suspect.setdefault(
                        m, f"contrib size mismatch ({len(payload)} "
                           f"bytes for {len(blocks)} items of {sz})")
                return
            for j, b in enumerate(blocks):
                if 0 <= b < self.n_items and b not in have:
                    have[b] = payload[j * sz:(j + 1) * sz]

        deadline = time.monotonic() + self.timeout_s
        while True:
            missing = [b for b in range(self.n_items) if b not in have]
            # every live member's contribution is read before the result
            # goes out, even when other ranks already delivered its items
            # (an incumbent computing under the view before a rejoin ships
            # the rejoiner's block): a member still writing a contribution
            # larger than the socket buffers would block on it while this
            # rank blocks writing that member the result
            owed = [m for m in self.view.members if m not in arrivals]
            if not missing and not owed:
                break
            # rank 0's own outstanding items first (world 1, and the
            # re-adoption right after a view change)
            mine = [b for b in missing if self.view.owner_of(b) == 0]
            if mine:
                if compute is None:
                    raise DeadRankError(
                        f"elastic exchange #{round_idx}: items {mine} "
                        f"fell to rank 0 but no compute callback was "
                        f"given")
                got = {int(b): bytes(v) for b, v in compute(mine).items()}
                self._note_items(got.values())
                have.update(got)
                continue
            now = time.monotonic()
            with self._lock:
                why = dict(self._suspect)
                hb_stale = [m for m in self.view.members
                            if m != 0
                            and now - self._hb_last.get(m, now)
                            > self.hb_timeout_s]
                socks = dict(self._data)
            for m in hb_stale:
                why.setdefault(m, f"no heartbeat for "
                                  f"{self.hb_timeout_s:.1f}s (process "
                                  f"hung or stopped)")
            if now > deadline:
                # whoever still owes an item or its contribution at the
                # deadline is hung
                for m in ({self.view.owner_of(b) for b in missing}
                          | set(owed)) - {0}:
                    why.setdefault(m, f"owes items at the {self.timeout_s:.0f}"
                                      f"s deadline")
            dead = set(why) & (set(self.view.members) - {0})
            if dead:
                self._coord_view_change(
                    sorted(dead), round_idx, have, compute,
                    reason="; ".join(f"rank {m}: {why[m]}"
                                     for m in sorted(dead)))
                # the re-tasked survivors need fresh time to recompute
                # the dead rank's blocks, or a late view change cascades
                # into evictions of healthy ranks
                deadline = max(deadline, time.monotonic() + self.timeout_s)
                continue
            with self._lock:
                early, self._early_frames = self._early_frames, []
            for m, mtype, hdr, payload in early:
                if m in self.view.members:
                    take(m, mtype, hdr, payload)
            rl: list = []
            waitable = [s for m, s in socks.items()
                        if m in self.view.members]
            if waitable:
                try:
                    rl, _, _ = select.select(waitable, [], [], 0.1)
                except (OSError, ValueError):
                    rl = []     # a sock closed under us: re-snapshot
            else:
                time.sleep(0.05)
            for s in rl:
                m = next((r for r, c in socks.items() if c is s), None)
                if m is None:
                    continue
                try:
                    s.settimeout(max(0.05, min(5.0, deadline - now)))
                    mtype, hdr, payload = self._recv(s)
                except (socket.timeout, ConnectionError, OSError,
                        ValueError):
                    with self._lock:
                        self._suspect.setdefault(m, "data link failed")
                    continue
                take(m, mtype, hdr, payload)
        _cluster.note_barrier("exchange", round_idx, round_idx, arrivals)
        # broadcast the complete payload set in item order
        blob = [have[b] for b in range(self.n_items)]
        view = self.view
        with self._lock:
            socks = dict(self._data)
        for m in view.members:
            if m == 0 or m not in socks:
                continue
            try:
                self._send_draining(socks[m], m, round_idx, "result",
                                    {"epoch": view.epoch, "round": round_idx,
                                     "members": list(view.members)},
                                    blob)
            except (socket.timeout, OSError):
                with self._lock:
                    self._suspect.setdefault(m, "result send failed")
        return have, view

    def _send_draining(self, sock, m: int, round_idx: int, mtype, header,
                       payload) -> None:
        """Send on member m's data link while a helper thread reads what
        the member still writes there: the rest of an overlapped
        contribution (a frame a block) whose items other ranks already
        delivered, which is dropped.  Without it, a result larger than the
        socket buffers and such a frame block each other until the send's
        deadline (ROADMAP C.19).  The member may read the whole result
        and ship its next round's first frame before the helper stops:
        such a later round's frame is kept for that round's exchange."""
        stop = threading.Event()

        def drain():
            while True:
                try:
                    rl, _, _ = select.select([sock], [], [], 0.01)
                except (OSError, ValueError):
                    return
                if not rl:
                    if stop.is_set():
                        return
                    continue
                try:
                    frame = self._recv(sock)
                except (socket.timeout, ConnectionError, OSError,
                        ValueError):
                    return
                if int(frame[1].get("round", -1)) > round_idx:
                    with self._lock:
                        self._early_frames.append((m, *frame))

        sock.settimeout(self.timeout_s)
        t = threading.Thread(target=drain, name="elastic-drain", daemon=True)
        t.start()
        try:
            self._send(sock, mtype, header, payload)
        finally:
            stop.set()
            t.join()

    def _exchange_worker(self, round_idx, parts, compute,
                         pre_sent: tuple = ()):
        sent = set(parts) | set(pre_sent)
        if parts or not pre_sent:
            # an all-early overlap round has nothing left to contribute
            # inline; everything else keeps the eager single CONTRIB
            self._send_contrib(round_idx, parts)
        deadline = time.monotonic() + self.timeout_s
        while True:
            self._sock.settimeout(max(0.05, deadline - time.monotonic()))
            try:
                mtype, hdr, payload = self._recv(self._sock)
            except (socket.timeout, ConnectionError, OSError,
                    ValueError) as e:
                raise DeadRankError(
                    f"elastic exchange round {round_idx}: rank "
                    f"{self.ctx.rank} lost the rank-0 coordinator "
                    f"({type(e).__name__}: coordinator dead, or this "
                    f"rank was evicted from the view)") from e
            if mtype == "view":
                self._install_view(hdr)
                # a view change re-tasks the survivors: the round runs
                # longer than one clean window
                deadline = max(deadline, time.monotonic() + self.timeout_s)
                need = [int(b) for b in hdr.get("need", [])
                        if int(b) not in sent]
                if need and compute is not None:
                    out = {int(b): bytes(v)
                           for b, v in compute(need).items()}
                    self._send_contrib(round_idx, out)
                    sent |= set(out)
            elif mtype == "result":
                if int(hdr.get("round", -1)) != round_idx:
                    continue             # a stale, consumed round
                self._install_view(hdr)
                sz = len(payload) // self.n_items
                if sz * self.n_items != len(payload):
                    raise DeadRankError(
                        f"elastic exchange round {round_idx}: result "
                        f"payload of {len(payload)} bytes does not tile "
                        f"{self.n_items} items")
                return ({b: payload[b * sz:(b + 1) * sz]
                         for b in range(self.n_items)}, self.view)
            elif mtype == "dump":
                # the coordinator saw a view change, death or breach:
                # snapshot the same window into this rank's obs dir
                obs.dump_flight("coordinated:" + str(hdr.get("reason", "")))

    def _send_contrib(self, round_idx: int, parts: dict) -> None:
        blocks = sorted(parts)
        try:
            self._sock.settimeout(self.timeout_s)
            self._send(self._sock, "contrib",
                       {"epoch": self.view.epoch, "round": round_idx,
                        "blocks": blocks},
                       [parts[b] for b in blocks])
        except (socket.timeout, ConnectionError, OSError) as e:
            raise DeadRankError(
                f"elastic exchange round {round_idx}: rank "
                f"{self.ctx.rank} could not ship its contribution to "
                f"the coordinator ({type(e).__name__})") from e

    # -- rejoin --------------------------------------------------------------
    def rejoin_handshake(self) -> tuple[bytes, int, str]:
        """A restarted worker's entry: dial the coordinator's rejoin role
        with the config digest and await admission (at the next commit
        barrier).  Returns (snapshot blob, resume round, run tag) and
        leaves the channel connected (data and heartbeat links) under
        the new membership.  `run_tag` names the run the snapshot
        belongs to: a worker driving several runs over one channel must
        resume the one the coordinator is in."""
        ctx = self.ctx
        deadline = time.monotonic() + self.connect_timeout_s
        sock = _dial_with_backoff(
            self._host, self._port, deadline,
            f"elastic rejoin: rank {ctx.rank} dialing the coordinator "
            f"at {ctx.coordinator}")
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._send(sock, "rejoin",
                       {"rank": ctx.rank, "digest": self.config_digest})
            # admission lands at a commit barrier: a round on top of the
            # connect window
            sock.settimeout(self.timeout_s + self.connect_timeout_s)
            try:
                mtype, hdr, payload = self._recv(sock)
            except (socket.timeout, ConnectionError, OSError) as e:
                raise DeadRankError(
                    f"elastic rejoin: rank {ctx.rank} got no admission "
                    f"from the coordinator within "
                    f"{self.timeout_s + self.connect_timeout_s:.0f}s "
                    f"({type(e).__name__}: run finished or coordinator "
                    f"dead)") from e
            if mtype == "reject":
                raise DeadRankError(hdr.get("error", "rejoin rejected"))
            if mtype != "snapshot":
                raise DeadRankError(
                    f"elastic rejoin: unexpected {mtype!r} reply")
        finally:
            sock.close()
        self._install_view(hdr)
        self._connect_worker()
        log.info("elastic: rank %d readmitted at epoch %d, resuming run "
                 "%r at round %d", ctx.rank, self.view.epoch,
                 hdr.get("tag", ""), int(hdr["resume_round"]))
        return bytes(payload), int(hdr["resume_round"]), hdr.get("tag", "")

    def admit_rejoins(self, resume_round: int,
                      snapshot_fn: Callable[[], bytes],
                      tag: str = "") -> list:
        """Rank 0, at a commit barrier: admit every pending rejoiner (an
        epoch bump, a SNAPSHOT reply with the view, the resume round and
        the blob snapshot_fn builds, a VIEW to the incumbents).  Returns
        the admitted ranks."""
        if self.ctx.rank != 0:
            return []
        with self._lock:
            pending, self._pending_rejoin = self._pending_rejoin, []
        if not pending:
            return []
        blob = snapshot_fn()
        admitted = []
        for rank, conn in pending:
            if rank in self.view.members:
                try:
                    self._send(conn, "reject", {"error": (
                        f"elastic rejoin: rank {rank} is still a live "
                        f"member of epoch {self.view.epoch}: a rank id "
                        f"cannot be claimed twice")})
                except OSError:
                    pass
                conn.close()
                continue
            members = tuple(sorted(set(self.view.members) | {rank}))
            view = ClusterView(self.view.epoch + 1, members, self.n_items)
            try:
                conn.settimeout(self.timeout_s)
                self._send(conn, "snapshot",
                           {"epoch": view.epoch,
                            "resume_round": int(resume_round),
                            "members": list(members),
                            "n_items": self.n_items,
                            "tag": tag},
                           blob)
            except (socket.timeout, OSError):
                conn.close()
                log.warning("elastic: rejoiner rank %d vanished before "
                            "its snapshot was delivered", rank)
                continue
            conn.close()
            with self._lock:
                self.view = view
                # connect grace for the fresh data and heartbeat links
                self._hb_last[rank] = (time.monotonic()
                                       + self.connect_timeout_s)
                self._suspect.pop(rank, None)
            admitted.append(rank)
            obs.counter("multihost_rejoins_admitted_total").inc()
            obs.gauge("multihost_epoch", rank="0").set(float(view.epoch))
            obs.counter("multihost_view_changes_total").inc()
            self.view_events.append({
                "epoch": view.epoch, "round": int(resume_round),
                "rejoined": [rank], "members": list(members),
                "latency_s": 0.0, "reason": "rejoin admitted"})
            log.warning("elastic: rank %d readmitted at epoch %d (resume "
                        "round %d)", rank, view.epoch, resume_round)
        if admitted:
            with self._lock:
                socks = dict(self._data)
            for m in self.view.members:
                if m == 0 or m in admitted or m not in socks:
                    continue
                try:
                    socks[m].settimeout(self.timeout_s)
                    self._send(socks[m], "view",
                               {"epoch": self.view.epoch,
                                "round": int(resume_round),
                                "members": list(self.view.members),
                                "need": []})
                except (socket.timeout, OSError):
                    with self._lock:
                        self._suspect.setdefault(
                            m, "view notification failed")
        return admitted

    def _broadcast_dump_frames(self, reason: str) -> None:
        """Fan a coordinated-dump order out to every member's data link
        (the observatory's DUMP broadcaster).  Best effort: a member that
        died in between is the failure detector's business."""
        with self._lock:
            socks = {m: s for m, s in self._data.items()
                     if m in self.view.members}
        for m, s in socks.items():
            try:
                self._send(s, "dump", {"reason": str(reason)})
            except OSError:
                pass

    # -- plumbing shared with HostChannel ------------------------------------
    def export_byte_counters(self) -> None:
        with self._io_lock:
            sent, recv = self.bytes_sent, self.bytes_received
        _export_channel_byte_counters(self.ctx.rank, sent, recv)

    def close(self) -> None:
        self._closed = True
        if self.ctx.rank == 0:
            _cluster.set_dump_broadcaster(None)
        with self._lock:
            socks = (list(self._data.values()) + list(self._hb.values())
                     + [c for _, c in self._pending_rejoin])
            self._data.clear()
            self._hb.clear()
            self._pending_rejoin.clear()
        for s in socks + [self._sock, self._hb_sock, self._listener]:
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self._sock = self._hb_sock = self._listener = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# the two-level round loop
# ---------------------------------------------------------------------------

# per-PROCESS metrics-rollup baseline: (registry identity, prev state),
# keyed on the registry object so obs.reset() resets the baseline with
# it.  The allgather piggyback and the end-of-run rollup advance the same
# baseline (their windows are disjoint, so rank 0 never double-counts),
# hence the lock around the read-modify-write.
_rollup_state: Optional[tuple] = None
_rollup_lock = threading.Lock()


def _rollup_delta(cap_bytes: Optional[int] = None) -> Optional[dict]:
    """This process's metrics delta since the last one it shipped.  With
    `cap_bytes` (the live piggyback), an empty delta or one over the
    frame budget returns None without advancing the baseline: it rides a
    later frame or the final rollup."""
    global _rollup_state
    with _rollup_lock:
        reg = obs.registry()
        prev = (_rollup_state[1]
                if _rollup_state is not None and _rollup_state[0] is reg
                else None)
        delta, state = reg.delta_snapshot(prev)
        if cap_bytes is not None and (
                not delta.get("metrics")
                or len(json.dumps(delta, sort_keys=True).encode())
                > cap_bytes):
            return None
        _rollup_state = (reg, state)
        return delta


class MultihostRunner:
    """Two-level multi-process round loop over a FedAvg-family chunked
    engine (parallel/engine.py: FedAvg, FedProx, FedOpt, FedNova and
    MeshRobustEngine's norm_clip).

    Per round, on every process:

      1. sample: `BlockCohortSampler` draws each block's cohort from its
         population range, a pure function of (seed, round, block);
      2. partial: for each OWNED block (contiguous tiling: rank r owns
         blocks [r·B/W, (r+1)·B/W)), the block's cohort is uploaded
         (streaming: host gather of the block, double-buffered one round
         ahead through parallel/prefetch.py; resident: an index-select on
         this rank's id-range stack, uploaded once) and trained through
         the engine's `_twolevel_partial`, which returns the flat f32
         carry on the host;
      3. exchange: `HostChannel.allgather` of the encoded partials (or
         the pipelined gather with `overlap_exchange`), then EVERY
         process folds all B partials in global block order;
      4. commit: `_twolevel_commit` divides and applies the server
         update identically on every process.

    Bitwise anchor: with a fixed `n_blocks`, same-seed runs at any
    process count that tiles the blocks commit identical bits, and with
    one block the round is the engine's `round_fn_streaming` on the same
    cohort.  The engine runs one device per rank (`n_shards` 1 in the
    handshake); two ranks may share one card."""

    _contiguous = True          # rank r owns blocks [r·B/W, (r+1)·B/W)

    def __init__(self, engine, ctx: Optional[MultihostContext] = None,
                 *, n_blocks: Optional[int] = None,
                 channel: Optional[HostChannel] = None,
                 timeout_s: float = 120.0,
                 carry_codec: str = "f32",
                 carry_chunk: Optional[int] = None,
                 overlap_exchange: bool = False,
                 on_round_end: Optional[Callable[[int], None]] = None):
        from fedml_tpu_torch.parallel.carry_codec import (DEFAULT_CHUNK,
                                                          make_carry_codec)
        from fedml_tpu_torch.parallel.engine import MeshFedAvgEngine
        from fedml_tpu_torch.parallel.hierarchical import (
            MeshHierarchicalEngine)
        if (not isinstance(engine, MeshFedAvgEngine)
                or isinstance(engine, MeshHierarchicalEngine)):
            # the hierarchical engine's rounds are group_comm_round
            # inner rounds per silo: folding its sums flat here would
            # quietly compute plain FedAvg (its multi-process layout is
            # the silo-per-machine mesh, make_hierarchical_host_mesh)
            raise ValueError(
                f"MultihostRunner drives the flat FedAvg-family chunked "
                f"engines, not {type(engine).__name__}")
        self.ctx = ctx if ctx is not None else (
            MultihostContext.from_env() or MultihostContext.single())
        # the engine's mesh must be this member's local group: the
        # cross-member tier is the HostChannel, never a mesh collective
        mine = member_ranks(self.ctx)
        k = self.ctx.local_world
        for r in engine.mesh.grid.reshape(-1).tolist():
            if r not in mine:
                raise ValueError(
                    f"MultihostRunner needs the engine's mesh inside this "
                    f"member's local group (build it with "
                    f"make_local_mesh()): its rank {r} belongs to "
                    f"host-channel member {r // k}, and this process is "
                    f"member {self.ctx.rank} (ranks {mine})")
        engine._ensure_twolevel()
        self.engine = engine
        # several ranks behind this member: they train each block's lanes
        # together, and the first of them (the leader) ships the carry
        self.group = engine.mesh if engine.mesh.size > 1 else None
        self.leads = self.group is None or engine.mesh.is_first
        self._share_stacks: dict[int, dict] = {}
        self.timeout_s = float(timeout_s)
        self.on_round_end = on_round_end
        world = self.ctx.world
        self.n_blocks = int(n_blocks) if n_blocks else world
        if self._contiguous and self.n_blocks % world:
            raise ValueError(
                f"n_blocks ({self.n_blocks}) must be a multiple of the "
                f"process count ({world}): contiguous tiling is the "
                f"bitwise contract")
        cfg = engine.cfg
        if cfg.client_num_per_round % self.n_blocks:
            raise ValueError(
                f"client_num_per_round ({cfg.client_num_per_round}) "
                f"must divide evenly into {self.n_blocks} blocks")
        self.sampler = BlockCohortSampler(
            engine.data.client_num, self.n_blocks,
            cfg.client_num_per_round // self.n_blocks, cfg.seed)
        if self._contiguous:
            bpp = self.n_blocks // world
            self.owned_blocks = tuple(range(self.ctx.rank * bpp,
                                            (self.ctx.rank + 1) * bpp))
            # this process's population id range (contiguous because its
            # blocks are): the resident device stack holds only this slice
            self.range_lo = self.owned_blocks[0] * self.sampler.range_size
            self.range_hi = ((self.owned_blocks[-1] + 1)
                             * self.sampler.range_size)
        self._channel = channel
        self._owns_channel = channel is None
        self._range_stack = None
        self._prefetched = None
        self.codec = make_carry_codec(
            carry_codec,
            chunk=DEFAULT_CHUNK if carry_chunk is None else carry_chunk)
        self.overlap_exchange = bool(overlap_exchange)
        self.round_walls: list[float] = []
        self.carry_bytes: list[int] = []
        self.carry_wire_sent: list[int] = []
        self.carry_raw: list[int] = []       # f32 bytes before encoding
        self.carry_payload: list[int] = []   # encoded payload bytes
        self.overlap_waits: list[float] = []
        self.exchange_walls: list[float] = []

    # -- setup ---------------------------------------------------------------
    @property
    def channel(self) -> HostChannel:
        if self._channel is None:
            self._channel = HostChannel(self.ctx,
                                        timeout_s=self.timeout_s)
        return self._channel

    def _config_doc(self) -> bytes:
        """The canonical cross-rank config document: the quantities the
        bitwise contract depends on, in the JAX runner's schema
        (`n_shards`: the ranks of the member's local group)."""
        eng = self.engine
        return json.dumps({
            "n_blocks": self.n_blocks,
            "k_per_block": self.sampler.k_per_block,
            "population": self.sampler.population,
            "n_shards": self.engine.n_shards,
            "chunk": eng.chunk,
            "seed": eng.cfg.seed,
            "family": eng.program_family,
            "streaming": bool(eng.streaming),
            # the carry codec shapes every wire payload: a mixed-codec
            # cluster is named at the handshake, not found mid-round
            "carry_codec": self.codec.name,
            "carry_chunk": self.codec.chunk,
        }, sort_keys=True).encode()

    def _handshake(self) -> None:
        """Cross-rank config agreement: the bitwise contract holds only
        when every process runs the same partition and programs; a
        mismatch names the rank instead of silently diverging."""
        doc = self._config_doc()
        docs = self.channel.allgather(doc, timeout_s=self.timeout_s)
        for r, d in enumerate(docs):
            if d != docs[0]:
                raise RuntimeError(
                    f"multihost config mismatch: rank {r} runs "
                    f"{d.decode()!r} vs rank 0's {docs[0].decode()!r}; "
                    f"the two-level reduction would not be bitwise")

    # -- per-round pieces ----------------------------------------------------
    def _lane0(self, block: int) -> int:
        """The block's first lane in the round's cohort: lane j of block
        b trains with client_generator(seed, round, lane0 + j), whatever
        rank computes it."""
        return block * self.sampler.k_per_block

    def _upload_id_range(self, lo: int, hi: int) -> tuple:
        """The client stack and weights of population ids [lo, hi) on the
        device."""
        eng = self.engine
        host = eng._cast_stack_x({k: np.asarray(v)[lo:hi] for k, v in
                                  eng._host_shards().items()})
        eng.transfer_stats.add_h2d_bytes(
            sum(v.numel() * v.element_size() for v in host.values()))
        from fedml_tpu_torch.parallel.prefetch import upload
        stack = {k: upload(v, eng.device) for k, v in host.items()}
        weights = eng._upload_weights(np.asarray(
            eng.data.client_num_samples, np.float32)[lo:hi])
        return stack, weights

    def _upload_range_stack(self):
        """Resident mode: upload THIS process's population id range
        once (device residency is id-range partitioned across ranks)."""
        if self._range_stack is None:
            self._range_stack = self._upload_id_range(self.range_lo,
                                                      self.range_hi)
        return self._range_stack

    def _gather_streaming(self, round_idx: int):
        """Host-gather and upload every OWNED block's cohort (the
        per-rank input pipeline; runs on the prefetch thread when
        pipelined)."""
        return [(b, *self.engine._stream_gather(
            self.sampler.sample_block(round_idx, b)))
            for b in self.owned_blocks]

    def _streaming_blocks(self, round_idx: int, rounds: int) -> list:
        """The streaming input head with the per-rank double-buffered
        prefetch: consume round r's gathered blocks (from the prefetch
        thread when pipelined) and schedule round r+1's gather and
        upload."""
        from fedml_tpu_torch.parallel.prefetch import AsyncValue
        eng = self.engine
        pre, self._prefetched = self._prefetched, None
        if pre is not None and pre[0] == round_idx:
            blocks = pre[1].result()
        else:
            if pre is not None:
                try:
                    pre[1].result()
                except Exception:
                    log.warning("discarding failed stale multihost "
                                "prefetch for round %d", pre[0],
                                exc_info=True)
            with eng.transfer_stats.waiting():       # unhidden gather
                blocks = self._gather_streaming(round_idx)
        if eng.prefetch and round_idx + 1 < rounds:
            self._prefetched = (round_idx + 1, AsyncValue(
                self._gather_streaming, round_idx + 1,
                stats=eng.transfer_stats, device=eng.device))
        return blocks

    def _iter_partials(self, variables, round_idx: int, rounds: int):
        """(block, host f32 carry) in owned-block order, so each block's
        carry can ship while the next one computes."""
        eng = self.engine
        if self.group is not None:
            for b in self.owned_blocks:
                yield b, self._group_partial(variables, round_idx, b)
            return
        if eng.streaming:
            for b, cohort, weights in self._streaming_blocks(round_idx,
                                                             rounds):
                yield b, eng._twolevel_partial(
                    variables, cohort, weights, round_idx, self._lane0(b))
            return
        stack, stack_w = self._upload_range_stack()
        for b in self.owned_blocks:
            local = (self.sampler.sample_block(round_idx, b)
                     - self.range_lo)
            yield b, eng._twolevel_partial_resident(
                variables, stack, stack_w, local, round_idx, self._lane0(b))

    # -- the member's local group --------------------------------------------
    # Each rank of the group trains its share of a block's lanes (the
    # block's cohort padded to the group with zero-weight repeats of its
    # first client, rank i taking the i-th equal range, lanes keyed on the
    # global lane), and the group folds the per-rank sums left in mesh
    # order on the host (the engine's `_twolevel_partial`).  The leader
    # drives: it names every block before the group computes it (the
    # elastic tier re-tasks blocks mid-round) and hands the folded carry of
    # every member to the others for the commit, so the followers need no
    # channel and the group commits one set of bits.
    def _announce(self, cmd) -> None:
        if self.group is not None and self.leads:
            self.group.broadcast_object(cmd, self.engine.client_axes)

    def _block_ids(self, round_idx: int, b: int) -> tuple:
        """This rank's (ids, wmask, position range) of block b's cohort."""
        ids = self.sampler.sample_block(round_idx, b)
        pad = (-len(ids)) % self.engine.n_shards
        wmask = np.concatenate([np.ones(len(ids), np.float32),
                                np.zeros(pad, np.float32)])
        ids = np.concatenate([ids, np.repeat(ids[:1], pad)])
        return ids, wmask, self.engine.shard.rows(len(ids))

    def _share_bounds(self, b: int) -> list:
        """Population ids where each group rank's share of block b's id
        range starts (and the range's end)."""
        rs, k = self.sampler.range_size, self.engine.n_shards
        return [b * rs + (i * rs) // k for i in range(k + 1)]

    def _share_stack(self, b: int) -> dict:
        """Resident mode: this rank's share of block b's id range on the
        device (cached while the block is this member's)."""
        hit = self._share_stacks.get(b)
        if hit is None:
            bounds = self._share_bounds(b)
            i = self.engine.shard.index
            hit = self._share_stacks[b] = self._upload_id_range(
                bounds[i], bounds[i + 1])[0]
        return hit

    def _resident_share(self, b: int, ids: np.ndarray,
                        rows: slice) -> dict:
        """This rank's lanes of block b from the group's resident shares:
        every rank copies the rows it holds to the host, the group
        gathers them, and each rank uploads its lanes' rows (the bytes,
        not sums, so the cohort is the host gather's bit for bit)."""
        eng = self.engine
        bounds = self._share_bounds(b)
        holder = np.searchsorted(bounds, ids, side="right") - 1
        held = [np.nonzero(holder == r)[0] for r in range(eng.n_shards)]
        slot = np.empty(len(ids), np.int64)
        for h in held:
            slot[h] = np.arange(len(h))
        width = max(len(h) for h in held)
        me = eng.shard.index
        stack = self._share_stack(b)
        local = torch.as_tensor(ids[held[me]] - bounds[me], dtype=torch.long,
                                device=eng.device)
        from fedml_tpu_torch.parallel.prefetch import upload
        cohort = {}
        for key, v in stack.items():
            part = v.index_select(0, local).to("cpu")
            send = part.new_zeros((width,) + tuple(part.shape[1:]))
            send[:len(part)] = part
            wire = (send.view(torch.int16) if send.element_size() == 2
                    and send.is_floating_point() else send)
            got = eng.exchange.gather(wire.numpy(), eng.client_axes)
            mine = np.stack([got[holder[p]][slot[p]]
                             for p in range(rows.start, rows.stop)])
            t = torch.from_numpy(mine)
            if wire is not send:
                t = t.view(send.dtype)
            eng.transfer_stats.add_h2d_bytes(t.numel() * t.element_size())
            cohort[key] = upload(t, eng.device)
        return cohort

    def _group_partial(self, variables, round_idx: int,
                       b: int) -> np.ndarray:
        """Block b's host f32 carry, computed with the group (the leader
        names the block first)."""
        self._announce(("compute", int(b)))
        eng = self.engine
        ids, wmask, rows = self._block_ids(round_idx, b)
        if eng.streaming:
            cohort, weights = eng._stream_gather(ids[rows], wmask[rows])
        else:
            cohort = self._resident_share(b, ids, rows)
            weights = eng._upload_weights(np.take(np.asarray(
                eng.data.client_num_samples, np.float32), ids[rows])
                * wmask[rows])
        return eng._twolevel_partial(variables, cohort, weights, round_idx,
                                     self._lane0(b))

    def _group_commit(self, variables, server_state, total):
        """The leader's commit: its group's followers get the folded carry
        first and commit the same bits."""
        if self.group is not None:
            self._announce(("commit",))
            self.group.broadcast(total, self.engine.client_axes)
        return self.engine._twolevel_commit(variables, server_state, total)

    def _keep_shares(self, blocks) -> None:
        """Drop the resident shares of blocks this member no longer owns."""
        for b in list(self._share_stacks):
            if b not in blocks:
                del self._share_stacks[b]

    def _follow_compute(self, variables, round_idx: int, b: int) -> None:
        self._group_partial(variables, round_idx, b)

    def _run_follower(self, variables, server_state, rounds: int) -> dict:
        """A follower's loop: compute the blocks the leader names, keep
        only the resident shares of the blocks it says this member owns,
        and commit the carry it hands over."""
        axes = self.engine.client_axes
        for round_idx in range(rounds):
            t0 = time.perf_counter()
            while True:
                cmd = self.group.broadcast_object(None, axes)
                if cmd[0] == "compute":
                    self._follow_compute(variables, round_idx, cmd[1])
                elif cmd[0] == "round":
                    self._keep_shares(cmd[1])
                elif cmd[0] == "commit":
                    break
                else:
                    raise RuntimeError(f"local group: unknown command "
                                       f"{cmd!r} from the leader")
            total = self.group.broadcast(None, axes)
            variables, server_state, _m = self.engine._twolevel_commit(
                variables, server_state, total)
            if self.engine.device.type == "cuda":
                torch.cuda.synchronize(self.engine.device)
            self.round_walls.append(time.perf_counter() - t0)
            if self.on_round_end is not None:
                self.on_round_end(round_idx)
        return variables

    def _group_handshake(self) -> None:
        """The group's ranks run one configuration (the leader's)."""
        if self.group is None:
            return
        doc = self._config_doc()
        lead = self.group.broadcast_object(doc, self.engine.client_axes)
        if lead != doc:
            raise RuntimeError(
                f"local group config mismatch: rank {self.group.rank} runs "
                f"{doc.decode()!r} vs the leader's {lead.decode()!r}")

    # -- codec plumbing ------------------------------------------------------
    def _encode_block(self, block: int, vec: np.ndarray) -> bytes:
        with obs.span("multihost.encode_carry", codec=self.codec.name,
                      block=block):
            data = self.codec.encode(block, vec)
        self._round_raw += vec.size * 4
        self._round_payload += len(data)
        return data

    def _finish_round_bytes(self) -> None:
        """Close this round's byte accounting: payload-level raw/wire
        into the codec counters and the channel-measured wire deltas."""
        _account_carry(self._round_raw, self._round_payload)
        self.carry_raw.append(self._round_raw)
        self.carry_payload.append(self._round_payload)
        d = self.channel.round_wire_delta()
        self.carry_bytes.append(d["received"])
        self.carry_wire_sent.append(d["sent"])

    def _fold_docs(self, docs: list, dim: int) -> np.ndarray:
        """Split every rank's payload into its blocks' frames, decode
        through the codec and fold in global block order."""
        bpp = self.n_blocks // self.ctx.world
        enb = self.codec.encoded_nbytes(dim)
        all_parts: dict[int, bytes] = {}
        for r, doc in enumerate(docs):
            if len(doc) != bpp * enb:
                raise DeadRankError(
                    f"two-level allreduce: rank {r} shipped "
                    f"{len(doc)} bytes, expected {bpp * enb} "
                    f"({bpp} blocks x {enb} B {self.codec.name} "
                    f"carry): config skew or a truncated frame")
            view = memoryview(doc)
            for j in range(bpp):
                all_parts[r * bpp + j] = view[j * enb:(j + 1) * enb]
        return self._decode_fold(all_parts)

    def _decode_fold(self, bufs: dict) -> np.ndarray:
        """Decode per-block payloads and fold: dense codecs decode then
        left-fold; sparse codecs scatter-add (idx, vals) pairs in the
        same global block order; topk_ef integrates every block's
        reconstruction mirror, then left-folds."""
        if getattr(self.codec, "sparse", False):
            if hasattr(self.codec, "integrate"):
                return fold_block_partials(
                    {int(b): self.codec.integrate(int(b), v)
                     for b, v in bufs.items()}, self.n_blocks)
            pairs, dim = {}, 0
            for b, v in bufs.items():
                dim, idx, vals = self.codec.decode_pairs(v)
                pairs[int(b)] = (idx, vals)
            return fold_sparse_partials(pairs, self.n_blocks, dim)
        return fold_block_partials(
            {int(b): self.codec.decode(v)
             for b, v in bufs.items()}, self.n_blocks)

    def carry_state(self) -> dict:
        """The codec's residual state (error-feedback accumulators): a
        checkpoint's extra_state, so a resumed run continues the same
        compression-error trajectory."""
        return self.codec.state_dict()

    def load_carry_state(self, state: Optional[dict]) -> None:
        self.codec.load_state_dict(state or {})

    def _round_exchange(self, variables, round_idx: int,
                        rounds: int) -> np.ndarray:
        """One round's partials and the inter-process exchange,
        returning the folded carry.  Serial: compute every owned block,
        then one blocking allgather of the encoded payload.  Overlapped
        (`overlap_exchange`): open a pipelined gather and push each
        block's encoded carry as it materializes, so the transfer rides
        under the remaining blocks' compute; only gather_finish is
        visible wait.  Both move identical bytes in identical order."""
        ch = self.channel
        ch.mark_round()
        self._round_raw = self._round_payload = 0
        w0 = time.perf_counter()
        dim = 0
        if self.overlap_exchange and self.ctx.world > 1:
            h = ch.gather_begin(len(self.owned_blocks),
                                timeout_s=self.timeout_s)
            try:
                for b, vec in self._iter_partials(variables, round_idx,
                                                  rounds):
                    dim = vec.size
                    ch.gather_push(h, self._encode_block(b, vec))
                with obs.span("multihost.overlap_wait", round=round_idx):
                    t0 = time.perf_counter()
                    docs = ch.gather_finish(h)
                    wait = time.perf_counter() - t0
            except Exception:
                ch.gather_abort(h)
                raise
            self.overlap_waits.append(wait)
            self.exchange_walls.append(time.perf_counter() - w0)
        else:
            parts = dict(self._iter_partials(variables, round_idx, rounds))
            dim = next(iter(parts.values())).size
            payload = b"".join(self._encode_block(b, parts[b])
                               for b in sorted(parts))
            with obs.span("multihost.allreduce", round=round_idx):
                t0 = time.perf_counter()
                docs = ch.allgather(payload, timeout_s=self.timeout_s)
                wait = time.perf_counter() - t0
            # the whole exchange is visible wait on the serial path, so
            # overlap_fraction reports an honest ~0
            self.overlap_waits.append(wait)
            self.exchange_walls.append(wait)
        self._finish_round_bytes()
        return self._fold_docs(docs, dim)

    # -- the loop ------------------------------------------------------------
    def run(self, variables: Optional[dict] = None,
            rounds: Optional[int] = None, logger=None) -> dict:
        """Drive `rounds` two-level rounds; returns the trained variables
        (the same bits on every process).  Only rank 0 (its local group's
        leader) evaluates, appends metrics_history and logs each evaluated
        round to `logger` (utils/metrics.py::RunLogger)."""
        eng = self.engine
        cfg = eng.cfg
        rounds = rounds if rounds is not None else cfg.comm_round
        if variables is None:
            variables = eng.init_variables()
        server_state = eng.server_init(variables)
        self._group_handshake()
        if not self.leads:
            return self._run_follower(variables, server_state, rounds)
        self._handshake()
        try:
            for round_idx in range(rounds):
                t0 = time.perf_counter()
                with obs.span("round.twolevel", round=round_idx,
                              rank=self.ctx.rank,
                              blocks=len(self.owned_blocks)):
                    self.channel.round_hint = round_idx
                    total = self._round_exchange(variables, round_idx,
                                                 rounds)
                    variables, server_state, m = self._group_commit(
                        variables, server_state, total)
                if eng.device.type == "cuda":
                    torch.cuda.synchronize(eng.device)
                obs.counter("multihost_rounds_committed_total",
                            rank=str(self.ctx.rank)).inc()
                self.round_walls.append(time.perf_counter() - t0)
                self.channel.export_byte_counters()
                if self.ctx.rank == 0 and (
                        round_idx % cfg.frequency_of_the_test == 0
                        or round_idx == rounds - 1):
                    with obs.span("eval", round=round_idx):
                        stats = eng.evaluate(variables)
                    stats.update(round=round_idx,
                                 train_loss=float(m["train_loss"]),
                                 round_time=self.round_walls[-1])
                    eng.metrics_history.append(stats)
                    if logger is not None:
                        logger.log(stats, step=round_idx)
                    log.info("round %d: %s", round_idx, stats)
                if self.on_round_end is not None:
                    self.on_round_end(round_idx)
        except Exception as e:
            obs.dump_flight(f"multihost_error:rank{self.ctx.rank}: "
                            f"{e!r}")
            raise
        finally:
            pre, self._prefetched = self._prefetched, None
            if pre is not None:
                try:
                    pre[1].result()
                except Exception:
                    pass
        self._rollup_metrics()
        return variables

    def _rollup_metrics(self) -> None:
        """Ship every rank's metric deltas to rank 0 and fold them under
        origin="host<i>": an N-process run keeps per-process series
        instead of last-writer-wins gauges.  The delta is since the last
        rollup in this process, so back-to-back runners do not re-ship
        an earlier run's counters."""
        if self.ctx.world <= 1:
            return
        try:
            self.channel.round_hint = None   # ledger: not a round barrier
            delta = _rollup_delta()
            docs = self.channel.allgather(
                json.dumps(delta).encode(), timeout_s=self.timeout_s)
            if self.ctx.rank == 0:
                for r, doc in enumerate(docs):
                    if r == 0 or not doc:
                        continue
                    obs.registry().merge_delta(json.loads(doc.decode()),
                                               origin=f"host{r}")
        except DeadRankError:
            raise
        except Exception:
            log.warning("multihost metrics rollup failed", exc_info=True)

    def report(self, warmup_rounds: int = 0) -> dict:
        """Timing and byte rollup over the rounds run so far (warm-up
        rounds left out of the rate)."""
        walls = self.round_walls[warmup_rounds:]
        carry = self.carry_bytes[warmup_rounds:] or [0]
        sent = self.carry_wire_sent[warmup_rounds:] or [0]
        raw = self.carry_raw[warmup_rounds:]
        payload = self.carry_payload[warmup_rounds:]
        waits = self.overlap_waits[warmup_rounds:]
        ewalls = self.exchange_walls[warmup_rounds:]
        return {
            "rank": self.ctx.rank,
            "world": self.ctx.world,
            "n_blocks": self.n_blocks,
            "rounds": len(self.round_walls),
            "rounds_per_sec": (len(walls) / sum(walls)
                               if walls and sum(walls) > 0 else 0.0),
            "round_wall_p50_s": (float(np.median(walls))
                                 if walls else 0.0),
            "carry_allreduce_bytes_per_round": float(np.mean(carry)),
            # the sum of the per-round deltas, not channel.bytes_received:
            # the channel also carries handshake and rollup frames
            "carry_allreduce_bytes_total": int(sum(self.carry_bytes)),
            "carry_codec": self.codec.name,
            "carry_raw_bytes_per_round": (float(np.mean(raw))
                                          if raw else 0.0),
            "carry_payload_bytes_per_round": (float(np.mean(payload))
                                              if payload else 0.0),
            "carry_compression_ratio": (sum(raw) / sum(payload)
                                        if sum(payload) else 1.0),
            "carry_wire_sent_bytes_per_round": float(np.mean(sent)),
            # the share of the exchange window (first partial shipped to
            # folded carry ready) NOT spent blocking the round loop: ~0
            # serial, > 0 when the overlapped gather hides the transfer
            "overlap_fraction": (max(0.0, 1.0 - sum(waits)
                                     / sum(ewalls))
                                 if ewalls and sum(ewalls) > 0
                                 else 0.0),
        }

    def close(self) -> None:
        if self._channel is not None and self._owns_channel:
            self._channel.close()
            self._channel = None


class ElasticRunner(MultihostRunner):
    """The elastic twin of the two-level round: the same sample, partial,
    exchange and commit, but the inter-process tier is an ElasticChannel.
    A dead or hung rank triggers a view change, the survivors recompute
    its blocks mid-round, and a restarted process re-enters through the
    rejoin handshake (the config digest, then rank 0's snapshot at a
    commit barrier).

    Bitwise under death, by construction: `BlockCohortSampler` draws on
    [seed, round, block] streams and every partial is a function of
    (variables, seed, round, block) alone (lane j of block b trains with
    client_generator(seed, round, b·k + j)), so a re-adopted block's
    partial is the one the dead rank would have shipped, and
    `fold_block_partials` folds all blocks in global block order whoever
    computed them.  A run that loses a rank commits the clean run's bits.

    Differences from the fail-fast runner, on purpose: the blocks are
    owned through `ClusterView` (any block count, so 3 ranks may own
    unequal shares of 4 blocks); resident mode caches a device stack per
    block and drops it when the view moves the block away; the streaming
    path gathers each block when it computes it (the cross-round prefetch
    assumes fixed ownership); and the end-of-run metrics rollup is left
    out (membership may change under it).

    The rejoin snapshot is the port's own, not the JAX package's: host
    copies of the model, the server state, the engine's extra state (the
    norm_clip weak-DP noise generator, drawn once a round on every rank)
    and the carry codec's state, through torch.save (bf16 leaves ride as
    they are).  It rides the same coordinator sockets as every carry."""

    _contiguous = False

    def __init__(self, engine, ctx: Optional[MultihostContext] = None,
                 *, n_blocks: Optional[int] = None,
                 channel: Optional[ElasticChannel] = None,
                 timeout_s: float = 120.0,
                 connect_timeout_s: float = 60.0,
                 hb_interval_s: float = 0.25,
                 hb_timeout_s: float = 2.0,
                 run_tag: str = "run",
                 carry_codec: str = "f32",
                 carry_chunk: Optional[int] = None,
                 overlap_exchange: bool = False,
                 on_round_end: Optional[Callable[[int], None]] = None):
        if channel is not None and not isinstance(channel, ElasticChannel):
            raise ValueError(
                f"ElasticRunner needs an ElasticChannel (got "
                f"{type(channel).__name__}); use MultihostRunner for the "
                f"fail-fast HostChannel")
        super().__init__(engine, ctx, n_blocks=n_blocks, channel=channel,
                         timeout_s=timeout_s, carry_codec=carry_codec,
                         carry_chunk=carry_chunk,
                         overlap_exchange=overlap_exchange,
                         on_round_end=on_round_end)
        self.connect_timeout_s = float(connect_timeout_s)
        self.hb_interval_s = float(hb_interval_s)
        self.hb_timeout_s = float(hb_timeout_s)
        self.run_tag = str(run_tag)
        if channel is not None and channel.n_items != self.n_blocks:
            raise ValueError(
                f"channel n_items ({channel.n_items}) != n_blocks "
                f"({self.n_blocks}): the block space is the reduction "
                f"tree and must agree")
        self._block_stacks: dict[int, tuple] = {}
        self._round_ctx: Optional[tuple] = None
        self.computed: list[tuple] = []     # (round, block) in order
        self.readopted: list[tuple] = []    # the re-adopted subset
        self.readopt_walls: list[float] = []
        self.rejoined_at: Optional[int] = None

    @property
    def channel(self) -> ElasticChannel:
        if self._channel is None:
            self._channel = ElasticChannel(
                self.ctx, n_items=self.n_blocks,
                config_digest=self.config_digest(),
                timeout_s=self.timeout_s,
                connect_timeout_s=self.connect_timeout_s,
                hb_interval_s=self.hb_interval_s,
                hb_timeout_s=self.hb_timeout_s,
                rejoin=os.environ.get("FEDML_MH_REJOIN") == "1")
        return self._channel

    def config_digest(self) -> str:
        return hashlib.md5(self._config_doc()).hexdigest()

    # -- per-block partials (whoever owns them) ------------------------------
    def _block_stack(self, b: int) -> tuple:
        """Resident mode, one block's id range on the device (cached while
        the block is owned here)."""
        hit = self._block_stacks.get(b)
        if hit is None:
            rs = self.sampler.range_size
            hit = self._block_stacks[b] = self._upload_id_range(
                b * rs, (b + 1) * rs)
        return hit

    def _compute_partials(self, variables, round_idx: int,
                          blocks) -> dict[int, np.ndarray]:
        eng = self.engine
        parts: dict[int, np.ndarray] = {}
        for b in blocks:
            b = int(b)
            ids = self.sampler.sample_block(round_idx, b)
            if self.group is not None:
                parts[b] = self._group_partial(variables, round_idx, b)
            elif eng.streaming:
                cohort, weights = eng._stream_gather(ids)
                parts[b] = eng._twolevel_partial(
                    variables, cohort, weights, round_idx, self._lane0(b))
            else:
                stack, stack_w = self._block_stack(b)
                parts[b] = eng._twolevel_partial_resident(
                    variables, stack, stack_w,
                    ids - b * self.sampler.range_size, round_idx,
                    self._lane0(b))
            self.computed.append((round_idx, b))
        return parts

    def _follow_compute(self, variables, round_idx: int, b: int) -> None:
        self._compute_partials(variables, round_idx, [b])

    def _readopt_compute(self, blocks) -> dict[int, bytes]:
        """The re-adoption callback the channel calls on a view change
        (on the thread that called exchange): recompute the named blocks
        against this round's frozen variables, encoded through the same
        codec as owned blocks (an int8_ef residual of a freshly adopted
        block starts at zero: the compression error's trajectory, never
        the ranks' agreement)."""
        if self._round_ctx is None:
            raise RuntimeError("re-adoption requested outside a round")
        variables, round_idx = self._round_ctx
        blocks = [int(b) for b in blocks]
        t0 = time.perf_counter()
        with obs.span("multihost.readopt", round=round_idx,
                      blocks=len(blocks)):
            parts = self._compute_partials(variables, round_idx, blocks)
        self.readopt_walls.append(time.perf_counter() - t0)
        self.readopted.extend((round_idx, b) for b in blocks)
        return {b: self.codec.encode(b, v) for b, v in parts.items()}

    # -- the rejoin snapshot -------------------------------------------------
    def _snapshot_blob(self, resume_round: int, variables,
                       server_state) -> bytes:
        """The rejoin catch-up snapshot: the committed model, the server
        state, the engine's extra state and the codec's state, as host
        copies through torch.save (byte-exact: the rejoiner re-enters the
        bitwise contract).  The topk_ef reconstruction mirror is
        replicated decode state and must ride; int8_ef residuals are
        encoder-local, and the rejoiner's retain_blocks() drops the
        coordinator's copies, so its residuals restart at zero."""
        from fedml_tpu_torch.utils.checkpoint import _to_host
        extra = getattr(self.engine, "_resume_state", lambda: None)()
        buf = io.BytesIO()
        torch.save({"round": int(resume_round),
                    "variables": _to_host(variables),
                    "server_state": _to_host(server_state),
                    "engine": _to_host(extra),
                    "carry": self.carry_state()}, buf)
        return buf.getvalue()

    def _install_snapshot(self, blob: bytes) -> tuple:
        """(variables, server_state, resume round) from a snapshot, on
        this engine's device, with the engine and codec state installed
        before the first fold."""
        from fedml_tpu_torch.utils.checkpoint import _like
        eng = self.engine
        snap = torch.load(io.BytesIO(blob), map_location="cpu",
                          weights_only=False)
        variables = {k: v.to(eng.device)
                     for k, v in snap["variables"].items()}
        server_state = _like(snap["server_state"],
                             eng.server_init(variables))
        if snap.get("engine"):
            eng._load_resume_state(snap["engine"])
        self.load_carry_state(snap.get("carry"))
        return variables, server_state, int(snap["round"])

    # -- the elastic loop ----------------------------------------------------
    def run(self, variables: Optional[dict] = None,
            rounds: Optional[int] = None, rejoin: Optional[bool] = None,
            rejoin_state: Optional[tuple] = None, logger=None) -> dict:
        """Drive the elastic two-level loop.  `rejoin=True` (by default
        from FEDML_MH_REJOIN, which the launcher's respawn sets) makes
        this process re-enter a running cluster: the digest handshake,
        the snapshot installed, the run resumed at the coordinator's
        commit barrier.  `rejoin_state=(blob, resume_round)` injects a
        handshake the caller already made (mh_worker makes its own, so
        the snapshot's run tag can pick the run to resume)."""
        eng = self.engine
        cfg = eng.cfg
        rank = self.ctx.rank
        rounds = rounds if rounds is not None else cfg.comm_round
        if rejoin is None:
            rejoin = (os.environ.get("FEDML_MH_REJOIN") == "1"
                      and rank != 0)
        if self.group is not None and (rejoin or rejoin_state is not None):
            raise NotImplementedError(
                "elastic rejoin of a member with a local group "
                "(local_devices > 1): a dead member's group stays down and "
                "the survivors re-adopt its blocks; respawn members of one "
                "rank")
        if not self.leads:
            if variables is None:
                variables = eng.init_variables()
            self._group_handshake()
            return self._run_follower(variables, eng.server_init(variables),
                                      rounds)
        self._group_handshake()
        ch = self.channel
        if rank == 0:
            ch.wait_members()
        if rejoin or rejoin_state is not None:
            if rejoin_state is not None:
                blob, _resume = rejoin_state
            else:
                blob, _resume, tag = ch.rejoin_handshake()
                if tag and tag != self.run_tag:
                    log.warning(
                        "elastic rejoin: admitted into run %r but this "
                        "runner drives %r; resuming anyway (the caller "
                        "should route on the tag, see mh_worker)", tag,
                        self.run_tag)
            variables, server_state, start_round = \
                self._install_snapshot(blob)
            self.rejoined_at = start_round
        else:
            if variables is None:
                variables = eng.init_variables()
            server_state = eng.server_init(variables)
            start_round = 0
        try:
            for round_idx in range(start_round, rounds):
                t_round = time.perf_counter()
                self._round_ctx = (variables, round_idx)
                with obs.span("round.twolevel", round=round_idx, rank=rank,
                              epoch=ch.view.epoch, elastic=True):
                    mine = ch.view.assigned(rank)
                    # drop the resident stacks of blocks the view moved
                    # away, or repeated death and rejoin leave every rank
                    # holding every block
                    for b in list(self._block_stacks):
                        if b not in mine:
                            del self._block_stacks[b]
                    self._keep_shares(mine)
                    self._announce(("round", list(mine)))
                    # error-feedback residuals follow ownership too
                    self.codec.retain_blocks(mine)
                    ch.mark_round()
                    self._round_raw = self._round_payload = 0
                    w0 = time.perf_counter()
                    if self.overlap_exchange and self.ctx.world > 1:
                        hnd = ch.contrib_begin(round_idx)
                        for b in mine:
                            part = self._compute_partials(
                                variables, round_idx, [b])
                            ch.contrib_push(hnd, b,
                                            self._encode_block(b, part[b]))
                        with obs.span("multihost.overlap_wait",
                                      round=round_idx):
                            t0 = time.perf_counter()
                            all_parts, _view = ch.exchange(
                                round_idx, {}, self._readopt_compute,
                                pending=hnd)
                            wait = time.perf_counter() - t0
                        self.overlap_waits.append(wait)
                        self.exchange_walls.append(time.perf_counter() - w0)
                    else:
                        parts = self._compute_partials(variables, round_idx,
                                                       mine)
                        enc = {b: self._encode_block(b, v)
                               for b, v in parts.items()}
                        with obs.span("multihost.allreduce",
                                      round=round_idx):
                            t0 = time.perf_counter()
                            all_parts, _view = ch.exchange(
                                round_idx, enc, self._readopt_compute)
                            wait = time.perf_counter() - t0
                        self.overlap_waits.append(wait)
                        self.exchange_walls.append(wait)
                    self._finish_round_bytes()
                    total = self._decode_fold(all_parts)
                    variables, server_state, m = self._group_commit(
                        variables, server_state, total)
                if eng.device.type == "cuda":
                    torch.cuda.synchronize(eng.device)
                obs.counter("multihost_rounds_committed_total",
                            rank=str(rank)).inc()
                self._round_ctx = None
                self.round_walls.append(time.perf_counter() - t_round)
                ch.export_byte_counters()
                if rank == 0:
                    # the commit barrier is the admission point: the
                    # snapshot ships the bits just committed
                    ch.admit_rejoins(
                        round_idx + 1,
                        lambda: self._snapshot_blob(
                            round_idx + 1, variables, server_state),
                        tag=self.run_tag)
                if rank == 0 and (round_idx % cfg.frequency_of_the_test == 0
                                  or round_idx == rounds - 1):
                    with obs.span("eval", round=round_idx):
                        stats = eng.evaluate(variables)
                    stats.update(round=round_idx,
                                 train_loss=float(m["train_loss"]),
                                 round_time=self.round_walls[-1])
                    eng.metrics_history.append(stats)
                    if logger is not None:
                        logger.log(stats, step=round_idx)
                    log.info("round %d: %s", round_idx, stats)
                if self.on_round_end is not None:
                    self.on_round_end(round_idx)
        except Exception as e:
            obs.dump_flight(f"multihost_elastic_error:rank{rank}: {e!r}")
            raise
        finally:
            self._round_ctx = None
        return variables

    def report(self, warmup_rounds: int = 0) -> dict:
        rep = super().report(warmup_rounds)
        ch = self._channel
        events = list(ch.view_events) if ch is not None else []
        lat = [e["latency_s"] for e in events if e.get("latency_s")]
        rep.update({
            "elastic": True,
            "epoch": ch.view.epoch if ch is not None else 0,
            "members": list(ch.view.members) if ch is not None else [],
            "view_changes": len(events),
            "view_change_latency_s": float(np.mean(lat)) if lat else 0.0,
            "view_events": events,
            "rejoined_at_round": self.rejoined_at,
            "computed": [list(x) for x in self.computed],
            "readopted": [list(x) for x in self.readopted],
            "readopt_s": list(self.readopt_walls),
            "resident_blocks": sorted(set(self._block_stacks)
                                      | set(self._share_stacks)),
        })
        return rep


def variables_digest(variables: dict) -> str:
    """md5 over the raw bytes of every leaf in the dict's order (the
    trainer's flat order): THE bitwise-equality digest of the
    multi-process pins."""
    h = hashlib.md5()
    for v in variables.values():
        t = v.detach().to("cpu").contiguous().reshape(-1)
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()
