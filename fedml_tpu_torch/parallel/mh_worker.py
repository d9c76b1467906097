"""One rank of a launched two-level cluster (port of
fedml_tpu/parallel/mh_worker.py).

    python -m fedml_tpu_torch.parallel.launch --procs 2 -- \\
        python -m fedml_tpu_torch.parallel.mh_worker CONFIG.json

Reads its rank and world from the FEDML_MH_* env (set by the launcher,
parallel/multihost.py::spawn_cluster), builds a synthetic separable-LR
workload, drives MultihostRunner (or ElasticRunner) for the configured
residency mode(s) over one channel, and prints ONE JSON line per rank:

    {"rank", "world", "n_blocks", "elastic", "rejoined",
     "digests": {mode: md5}, "rounds_per_sec",
     "carry_allreduce_bytes_per_round", ...}

Config keys (all optional; defaults in DEFAULTS):
    clients, spc, dim, classes, k_per_round, n_blocks, rounds, warmup,
    seed, modes ["streaming", "resident"], lr, channel_timeout_s,
    die_rank/die_at_round (crash injection: that rank hard-exits rc=3 at
    the end of that round), eval (bool: rank 0 reports its final
    test_acc), carry_codec (f32 | int8 | int8_ef | topk | topk_ef),
    carry_chunk (f32 elements per quantization scale), overlap_exchange
    (bool: push each block's encoded carry under the remaining blocks'
    compute), device (the engines' device: the card unless "cpu" is
    named).

The elastic keys:
    elastic (bool: ElasticRunner over an ElasticChannel; a rank's death
    is a view change and its blocks are re-adopted, and a respawned rank
    with FEDML_MH_REJOIN=1 rejoins the run the coordinator is in, routed
    by the snapshot's run tag), hang_rank/hang_at_round/hang_s (hang
    injection: that rank pauses its heartbeats and sleeps hang_s at the
    end of that round; the coordinator evicts it by heartbeat timeout and
    it exits rc=4 when it wakes to a closed channel),
    hb_timeout_s/hb_interval_s (the failure detector), and
    round_sleep_s/round_sleep_mode (a sleep at the end of every round of
    that mode, or of every mode: it holds a run open so a respawned rank
    rejoins mid-run).

serve_cluster (a dict) routes the worker into the fused serving cluster
(scale/cluster.py) instead of the training engines: this rank binds a
reactor on its endpoint port and serves live-socket uplinks into its
registry-shard lanes, folding the partials across ranks at each commit
barrier over an ElasticChannel.  Keys: population, commits,
warmup_commits, buffer_k, row_dim, connections, ingest_pool,
window_deadline_s, timeout_s, ports (one per rank) or base_port (port =
base + rank), chaos (a wire-fault dict), chaos_seed,
die_rank/die_at_commit (that rank closes its channel after that many
commits and exits rc=3), slo (bool), sparse_uplink (bool).

jax_distributed (bool): each rank joins torch.distributed's gloo group
(`init_multihost`, at the launcher's FEDML_MH_JAX_COORD) before it
builds its engine; the runner and its digests do not change.

local_devices (int, default 1): the ranks behind each host-channel
member.  With k > 1 the process the launcher started is the member's
first rank: it starts k - 1 further ranks of this worker
(multihost.py::join_local_group), the group joins a gloo world of its own
(with jax_distributed, one world over every member's ranks at the
launcher's rendezvous), and every engine trains on the member's local
mesh: each rank trains its share of a block's lanes, the group folds the
shares in mesh order, the first rank ships the carry through the channel,
and the whole group commits the same bits.  `--procs` still counts
members, and each member prints one JSON line, with its further ranks'
lines under "local_ranks".  A member's further ranks end with it; an
elastic run's survivors re-adopt a dead member's blocks, and a respawned
member with a local group is refused (it does not rejoin).

algorithms (list, default ["fedavg"]: "fedavg", "fedprox", "fedopt",
"fednova", "norm_clip") and carry_codecs (list, default [carry_codec])
add arms: every (algorithm, codec, mode) runs over the one channel, and
an arm other than the first algorithm and codec is keyed
"algorithm/codec/mode" in "digests".  init_npz (a .npz of the model's
leaves by the trainer's names) starts every arm from those weights;
dump_dir makes member 0's first rank write each arm's committed model
there as "<key with '/' as '_'>.npz".
"""
import json
import os
import sys
import time

DEFAULTS = {
    "clients": 16, "spc": 24, "dim": 16, "classes": 10,
    "k_per_round": 8, "n_blocks": None, "rounds": 3, "warmup": 1,
    "seed": 0, "modes": ["streaming", "resident"], "lr": 0.1,
    "channel_timeout_s": 60.0, "die_rank": None, "die_at_round": None,
    "eval": False, "carry_codec": "f32", "carry_chunk": None,
    "overlap_exchange": False, "device": None,
    "elastic": False, "hang_rank": None, "hang_at_round": None,
    "hang_s": 20.0, "hb_timeout_s": 2.0, "hb_interval_s": 0.25,
    "round_sleep_s": 0.0, "round_sleep_mode": None,
    "serve_cluster": None, "jax_distributed": False, "local_devices": 1,
    "algorithms": ["fedavg"], "carry_codecs": None,
    "init_npz": None, "dump_dir": None,
}

ALGORITHMS = ("fedavg", "fedprox", "fedopt", "fednova", "norm_clip")


def check_config(cfg: dict) -> None:
    """Refuse a configuration the worker cannot run, by name."""
    if int(cfg.get("local_devices", 1)) < 1:
        raise ValueError(f"local_devices must be >= 1, got "
                         f"{cfg['local_devices']}")
    for algo in cfg.get("algorithms") or ["fedavg"]:
        if algo not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {algo!r} (one of "
                             f"{ALGORITHMS})")
    for mode in cfg["modes"]:
        if mode not in ("streaming", "resident"):
            raise ValueError(f"unknown residency mode {mode!r}")
    if cfg["hang_rank"] is not None and not cfg["elastic"]:
        raise ValueError("hang_rank needs 'elastic': true (a fail-fast "
                         "channel has no heartbeats to miss)")


def config_digest(cfg: dict) -> str:
    """The elastic config digest: md5 of the whole worker config, so a
    skewed rank or a stale rejoiner is rejected by name at hello."""
    import hashlib
    return hashlib.md5(json.dumps(cfg, sort_keys=True).encode()).hexdigest()


def build_case(cfg: dict):
    """The synthetic separable-LR federated case (the JAX worker's, same
    numbers from RandomState(7)); returns make_engine(streaming,
    algorithm), the engine on this member's local mesh."""
    import numpy as np

    from fedml_tpu_torch.core.trainer import ClientTrainer
    from fedml_tpu_torch.data.federated import (FederatedData,
                                                build_client_shards,
                                                build_eval_shard)
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.parallel import engine as E
    from fedml_tpu_torch.utils.config import FedConfig

    C, spc, dim, classes = (cfg["clients"], cfg["spc"], cfg["dim"],
                            cfg["classes"])
    bs = min(8, spc)
    rs = np.random.RandomState(7)
    n = C * spc
    w = rs.randn(dim, classes)
    x = rs.randn(n, dim).astype(np.float32)
    y = np.argmax(x @ w + 0.2 * rs.randn(n, classes),
                  axis=1).astype(np.int64)
    idx = {i: np.arange(i * spc, (i + 1) * spc) for i in range(C)}
    data = FederatedData(
        train_data_num=n, test_data_num=n,
        train_global=build_eval_shard(x, y, n),
        test_global=build_eval_shard(x, y, n),
        client_shards=build_client_shards(x, y, idx, bs),
        client_num_samples=np.full(C, spc, np.float32),
        test_client_shards=None, class_num=classes)
    fedcfg = FedConfig(client_num_in_total=C,
                       client_num_per_round=cfg["k_per_round"],
                       comm_round=cfg["rounds"], epochs=1,
                       batch_size=bs, lr=cfg["lr"], seed=cfg["seed"],
                       frequency_of_the_test=10_000, prox_mu=0.1,
                       server_optimizer="adam", server_lr=0.01,
                       norm_bound=1.0, stddev=1e-3)

    def make_engine(streaming: bool, algorithm: str = "fedavg"):
        model = create_model("lr", classes, input_dim=dim)
        trainer = ClientTrainer(model, lr=fedcfg.lr)
        # the engines' default mesh is this member's local mesh
        kw = dict(streaming=streaming, device=cfg["device"])
        if algorithm == "norm_clip":
            return E.MeshRobustEngine(trainer, data, fedcfg,
                                      defense="norm_clip", **kw)
        cls = {"fedavg": E.MeshFedAvgEngine, "fedprox": E.MeshFedProxEngine,
               "fedopt": E.MeshFedOptEngine,
               "fednova": E.MeshFedNovaEngine}[algorithm]
        return cls(trainer, data, fedcfg, **kw)

    return make_engine


def _serve_cluster_main(ctx, cfg: dict) -> int:
    """One host of the fused serving cluster: the elastic channel (world
    > 1), run_cluster_serve on this rank's endpoint port, and ONE JSON
    line (with the launch counts of the run).  A rank with crash
    injection armed exits rc=3 without a JSON line (the launcher's
    report names it; the survivors' reports are the evidence)."""
    from fedml_tpu_torch.ops import launch_counts, reset_launch_counts
    from fedml_tpu_torch.parallel.multihost import ElasticChannel
    from fedml_tpu_torch.scale.cluster import run_cluster_serve

    sc = dict(cfg["serve_cluster"])
    channel = None
    crashed = False
    if ctx.world > 1:
        channel = ElasticChannel(
            ctx, n_items=ctx.world, config_digest=config_digest(cfg),
            timeout_s=cfg["channel_timeout_s"],
            hb_interval_s=cfg["hb_interval_s"],
            hb_timeout_s=cfg["hb_timeout_s"])
    ports = sc.get("ports")
    port = (int(ports[ctx.rank]) if ports
            else int(sc.get("base_port", 54300)) + ctx.rank)
    crash_at = (sc.get("die_at_commit")
                if sc.get("die_rank") == ctx.rank else None)
    try:
        reset_launch_counts()
        report = run_cluster_serve(
            int(sc.get("population", 4096)),
            commits=int(sc.get("commits", 8)),
            warmup_commits=int(sc.get("warmup_commits", 2)),
            buffer_k=int(sc.get("buffer_k", 16)),
            row_dim=int(sc.get("row_dim", 256)),
            port=port, partition=(ctx.rank, ctx.world),
            channel=channel, elastic=ctx.world > 1,
            n_connections=int(sc.get("connections", 64)),
            ingest_pool=int(sc.get("ingest_pool", 2)),
            sparse_uplink=bool(sc.get("sparse_uplink", False)),
            window_deadline_s=float(sc.get("window_deadline_s", 10.0)),
            timeout_s=float(sc.get("timeout_s", 600.0)),
            chaos=sc.get("chaos"),
            chaos_seed=int(sc.get("chaos_seed", 0)),
            crash_at_commit=crash_at,
            slo_window=bool(sc.get("slo", ctx.rank == 0)),
            device=cfg["device"])
        report["launches"] = launch_counts()
        crashed = bool(crash_at is not None
                       and report.get("elastic", {})
                                 .get("crashed_at_commit") is not None)
    finally:
        if channel is not None and not crashed:
            channel.close()
    if crashed:
        print(f"rank {ctx.rank}: injected crash at commit {crash_at}",
              file=sys.stderr, flush=True)
        os._exit(3)
    print(json.dumps({"rank": ctx.rank, "world": ctx.world,
                      "serve_cluster": report}, default=str), flush=True)
    return 0


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("usage: python -m fedml_tpu_torch.parallel.mh_worker "
              "CONFIG.json", file=sys.stderr)
        return 2
    with open(argv[0]) as f:
        cfg = {**DEFAULTS, **json.load(f)}
    check_config(cfg)
    from fedml_tpu_torch.parallel.multihost import (LocalGroup,
                                                    MultihostContext,
                                                    init_multihost,
                                                    join_local_group)
    ctx = MultihostContext.from_env() or MultihostContext.single()
    local = LocalGroup([])
    if int(cfg["local_devices"]) > 1 and ctx.rank != 0 \
            and os.environ.get("FEDML_MH_REJOIN") == "1":
        print(f"rank {ctx.rank}: a member with a local group "
              f"(local_devices {cfg['local_devices']}) does not rejoin",
              file=sys.stderr, flush=True)
        return 5
    if int(cfg["local_devices"]) > 1:
        # the member's further ranks (started by its first rank) and the
        # gloo world they train in; collectives wait out the leader's
        # channel exchange, so their deadline is the channel's, and more
        ctx, local = join_local_group(
            int(cfg["local_devices"]),
            [sys.executable, "-m", "fedml_tpu_torch.parallel.mh_worker",
             argv[0]],
            timeout_s=4 * float(cfg["channel_timeout_s"]) + 60.0,
            over_members=bool(cfg["jax_distributed"]
                              and ctx.jax_coordinator))
    elif cfg["jax_distributed"] and ctx.jax_coordinator:
        init_multihost(coordinator_address=ctx.jax_coordinator,
                       num_processes=ctx.world, process_id=ctx.rank,
                       required=True, timeout_s=cfg["channel_timeout_s"])
    try:
        return _train_main(ctx, cfg, local)
    except BaseException:
        local.kill()
        raise


def _arms(cfg: dict) -> list:
    """(key, algorithm, codec, mode) of every arm, in run order."""
    algos = list(cfg["algorithms"] or ["fedavg"])
    codecs = list(cfg["carry_codecs"] or [cfg["carry_codec"]])
    arms = []
    for algo in algos:
        for codec in codecs:
            for mode in cfg["modes"]:
                key = (mode if (algo, codec) == (algos[0], codecs[0])
                       else f"{algo}/{codec}/{mode}")
                arms.append((key, algo, codec, mode))
    return arms


def _train_main(ctx, cfg: dict, local) -> int:
    from fedml_tpu_torch import obs
    from fedml_tpu_torch.obs import cluster as cluster_mod
    from fedml_tpu_torch.parallel.multihost import (DeadRankError,
                                                    ElasticChannel,
                                                    ElasticRunner,
                                                    HostChannel,
                                                    MultihostRunner,
                                                    variables_digest)
    leads = ctx.local_rank == 0
    n_blocks = cfg["n_blocks"] or ctx.world
    rejoining = (os.environ.get("FEDML_MH_REJOIN") == "1"
                 and ctx.rank != 0)
    obs_root = os.environ.get("FEDML_OBS_DIR")
    if obs_root:
        # a per-RANK obs namespace: co-spawned workers handed one dir
        # would race each other's exports, and a rejoining incarnation
        # reuses its rank id, so it is namespaced by pid too.  Enabling
        # obs also arms the telemetry piggybacks and the coordinated
        # dumps; with the env unset the wire stays byte-identical to the
        # channel without the observatory
        sub = (f"rank{ctx.rank}-pid{os.getpid()}" if rejoining
               else f"rank{ctx.rank}")
        if ctx.local_rank:
            sub += f"-local{ctx.local_rank}"
        obs.configure(os.path.join(obs_root, sub))
    if cfg["serve_cluster"]:
        return _serve_cluster_main(ctx, cfg)
    make_engine = build_case(cfg)
    current_mode = {"mode": None}
    channel = None

    def on_round_end(round_idx: int) -> None:
        if cfg["round_sleep_s"] > 0 and (
                cfg["round_sleep_mode"] is None
                or cfg["round_sleep_mode"] == current_mode["mode"]):
            # pacing: a respawned process needs seconds to boot, so a
            # sleep a round holds the run open for its rejoin
            time.sleep(float(cfg["round_sleep_s"]))
        if (cfg["die_rank"] == ctx.rank
                and cfg["die_at_round"] == round_idx and not rejoining):
            print(f"rank {ctx.rank}: injected crash at round "
                  f"{round_idx}", file=sys.stderr, flush=True)
            os._exit(3)
        if (cfg["hang_rank"] == ctx.rank and leads
                and cfg["hang_at_round"] == round_idx and not rejoining):
            # a stopped process's shape without stopping it (a stopped
            # child never exits and would wedge the launcher): the
            # heartbeats pause, the rank is silent for hang_s, and the
            # coordinator must evict it by heartbeat timeout
            print(f"rank {ctx.rank}: injected hang at round {round_idx} "
                  f"for {cfg['hang_s']:.0f}s", file=sys.stderr, flush=True)
            channel.hb_paused = True
            time.sleep(float(cfg["hang_s"]))
            channel.hb_paused = False

    # ONE channel for the whole worker: every residency mode rides it
    # (re-binding the coordinator port between modes would race peers);
    # a member's further ranks reach it through their leader only
    if not leads:
        channel = None
    elif cfg["elastic"]:
        channel = ElasticChannel(
            ctx, n_items=n_blocks, config_digest=config_digest(cfg),
            timeout_s=cfg["channel_timeout_s"],
            hb_interval_s=cfg["hb_interval_s"],
            hb_timeout_s=cfg["hb_timeout_s"], rejoin=rejoining)
    else:
        channel = HostChannel(ctx, timeout_s=cfg["channel_timeout_s"])
    out = {"rank": ctx.rank, "world": ctx.world, "n_blocks": n_blocks,
           "elastic": bool(cfg["elastic"]), "rejoined": bool(rejoining),
           "local_rank": ctx.local_rank,
           "local_devices": int(cfg["local_devices"]),
           "digests": {}, "per_mode": {}}
    arms = _arms(cfg)
    modes = [a[0] for a in arms]
    rejoin_state = None
    try:
        if cfg["elastic"] and rejoining:
            # the handshake comes before any engine: the snapshot's run
            # tag names the residency mode the coordinator is in, and a
            # respawned process resumes THAT run (the runs share one
            # channel: rejoining another would cross-wire the exchanges)
            blob, resume_round, tag = channel.rejoin_handshake()
            if tag in modes:
                skipped, modes = (modes[:modes.index(tag)],
                                  modes[modes.index(tag):])
                if skipped:
                    print(f"rank {ctx.rank}: rejoined into {tag!r}; "
                          f"skipping completed mode(s) {skipped}",
                          file=sys.stderr, flush=True)
            rejoin_state = (blob, resume_round)
        arms = [a for a in arms if a[0] in modes]
        for mi, (mode, algo, codec, res) in enumerate(arms):
            current_mode["mode"] = res
            engine = make_engine(streaming=(res == "streaming"),
                                 algorithm=algo)
            kw = dict(n_blocks=n_blocks, channel=channel,
                      timeout_s=cfg["channel_timeout_s"],
                      carry_codec=codec,
                      carry_chunk=cfg["carry_chunk"],
                      overlap_exchange=cfg["overlap_exchange"],
                      on_round_end=on_round_end)
            start = None
            if cfg["init_npz"]:
                import numpy as np
                import torch
                with np.load(cfg["init_npz"]) as z:
                    start = {k: torch.from_numpy(z[k]).to(engine.device)
                             for k in engine.init_variables()}
            t0 = time.perf_counter()
            if cfg["elastic"]:
                runner = ElasticRunner(
                    engine, ctx, hb_interval_s=cfg["hb_interval_s"],
                    hb_timeout_s=cfg["hb_timeout_s"], run_tag=mode, **kw)
                try:
                    # only the first run of a respawned process resumes
                    # mid-run; later modes start as a member
                    variables = runner.run(
                        variables=start, rounds=cfg["rounds"], rejoin=False,
                        rejoin_state=rejoin_state if mi == 0 else None)
                except DeadRankError as e:
                    if cfg["hang_rank"] == ctx.rank and not rejoining:
                        # the injected hang got this rank evicted, as
                        # intended: exit distinctly (rc=4, not a crash)
                        print(f"rank {ctx.rank}: evicted after injected "
                              f"hang: {e}", file=sys.stderr, flush=True)
                        return 4
                    raise
            else:
                runner = MultihostRunner(engine, ctx, **kw)
                variables = runner.run(variables=start, rounds=cfg["rounds"])
            rep = runner.report(warmup_rounds=cfg["warmup"])
            rep["total_wall_s"] = time.perf_counter() - t0
            out["digests"][mode] = variables_digest(variables)
            if cfg["dump_dir"] and ctx.rank == 0 and leads:
                import numpy as np
                np.savez(os.path.join(cfg["dump_dir"],
                                      mode.replace("/", "_") + ".npz"),
                         **{k: v.detach().to("cpu").float().numpy()
                            for k, v in variables.items()})
            out["per_mode"][mode] = rep
            if cfg["eval"] and ctx.rank == 0 and leads:
                out.setdefault("eval", {})[mode] = \
                    engine.evaluate(variables)["test_acc"]
        # headline numbers: the streaming mode when run, else the first
        head = ("streaming" if "streaming" in out["per_mode"]
                else next(iter(out["per_mode"])))
        for k in ("rounds_per_sec", "carry_allreduce_bytes_per_round",
                  "carry_codec", "carry_compression_ratio",
                  "carry_wire_sent_bytes_per_round",
                  "carry_payload_bytes_per_round",
                  "carry_raw_bytes_per_round", "overlap_fraction"):
            out[k] = out["per_mode"][head][k]
        if ctx.rank == 0 and leads:
            # the coordinator's barrier ledger and cluster SLO verdict
            # (always-on local bookkeeping)
            out["straggler"] = cluster_mod.straggler_summary()
            out["cluster_slo"] = cluster_mod.cluster_slo_report()
        if local.procs:
            out["local_ranks"] = [
                json.loads(o.strip().splitlines()[-1])
                for o in local.collect(timeout_s=float(
                    cfg["channel_timeout_s"]) + 60.0)]
        print(json.dumps(out, default=str), flush=True)
    finally:
        if channel is not None:
            channel.close()
    return 0


if __name__ == "__main__":
    from fedml_tpu_torch.parallel.multihost import exit_rank
    exit_rank(main())
