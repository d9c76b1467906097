"""One rank of a launched two-level cluster (port of
fedml_tpu/parallel/mh_worker.py, its fail-fast part).

    python -m fedml_tpu_torch.parallel.launch --procs 2 -- \\
        python -m fedml_tpu_torch.parallel.mh_worker CONFIG.json

Reads its rank and world from the FEDML_MH_* env (set by the launcher,
parallel/multihost.py::spawn_cluster), builds a synthetic separable-LR
workload, drives MultihostRunner for the configured residency mode(s)
over one HostChannel, and prints ONE JSON line per rank:

    {"rank", "world", "n_blocks", "digests": {mode: md5},
     "rounds_per_sec", "carry_allreduce_bytes_per_round", ...}

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

The elastic keys (elastic, hang_rank) and serve_cluster are slice 6b of
the port; jax_distributed and local_devices > 1 are slice 6c.  Setting
any of them raises.
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
}

# keys whose tier is a later slice of the port: (key, slice)
_LATER = (("elastic", "6b"), ("hang_rank", "6b"), ("serve_cluster", "6b"),
          ("jax_distributed", "6c"))


def check_config(cfg: dict) -> None:
    """Refuse the keys of tiers this slice does not carry, by name."""
    for key, sl in _LATER:
        if cfg.get(key):
            raise NotImplementedError(
                f"mh_worker: {key!r} belongs to slice {sl} of the port, "
                f"not ported yet")
    if cfg.get("local_devices", 1) != 1:
        raise NotImplementedError(
            "mh_worker: local_devices > 1 (an in-program mesh per rank) "
            "belongs to slice 6c of the port; a rank drives one device")
    for mode in cfg["modes"]:
        if mode not in ("streaming", "resident"):
            raise ValueError(f"unknown residency mode {mode!r}")


def build_case(cfg: dict):
    """The synthetic separable-LR federated case (the JAX worker's, same
    numbers from RandomState(7)); returns make_engine(streaming)."""
    import numpy as np

    from fedml_tpu_torch.core.trainer import ClientTrainer
    from fedml_tpu_torch.data.federated import (FederatedData,
                                                build_client_shards,
                                                build_eval_shard)
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.parallel.engine import MeshFedAvgEngine
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
                       frequency_of_the_test=10_000)

    def make_engine(streaming: bool):
        model = create_model("lr", classes, input_dim=dim)
        return MeshFedAvgEngine(ClientTrainer(model, lr=fedcfg.lr), data,
                                fedcfg, streaming=streaming,
                                device=cfg["device"])

    return make_engine


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("usage: python -m fedml_tpu_torch.parallel.mh_worker "
              "CONFIG.json", file=sys.stderr)
        return 2
    with open(argv[0]) as f:
        cfg = {**DEFAULTS, **json.load(f)}
    check_config(cfg)
    from fedml_tpu_torch import obs
    from fedml_tpu_torch.obs import cluster as cluster_mod
    from fedml_tpu_torch.parallel.multihost import (HostChannel,
                                                    MultihostContext,
                                                    MultihostRunner,
                                                    variables_digest)
    ctx = MultihostContext.from_env() or MultihostContext.single()
    make_engine = build_case(cfg)
    n_blocks = cfg["n_blocks"] or ctx.world
    obs_root = os.environ.get("FEDML_OBS_DIR")
    if obs_root:
        # a per-RANK obs namespace: co-spawned workers handed one dir
        # would race each other's exports.  Enabling obs also arms the
        # telemetry piggyback; with the env unset the wire stays
        # byte-identical to the channel without the observatory
        obs.configure(os.path.join(obs_root, f"rank{ctx.rank}"))

    def on_round_end(round_idx: int) -> None:
        if (cfg["die_rank"] == ctx.rank
                and cfg["die_at_round"] == round_idx):
            print(f"rank {ctx.rank}: injected crash at round "
                  f"{round_idx}", file=sys.stderr, flush=True)
            os._exit(3)

    # ONE channel for the whole worker: both residency modes ride it
    # (re-binding the coordinator port between modes would race peers)
    channel = HostChannel(ctx, timeout_s=cfg["channel_timeout_s"])
    out = {"rank": ctx.rank, "world": ctx.world, "n_blocks": n_blocks,
           "digests": {}, "per_mode": {}}
    try:
        for mode in cfg["modes"]:
            engine = make_engine(streaming=(mode == "streaming"))
            runner = MultihostRunner(
                engine, ctx, n_blocks=n_blocks, channel=channel,
                timeout_s=cfg["channel_timeout_s"],
                carry_codec=cfg["carry_codec"],
                carry_chunk=cfg["carry_chunk"],
                overlap_exchange=cfg["overlap_exchange"],
                on_round_end=on_round_end)
            t0 = time.perf_counter()
            variables = runner.run(rounds=cfg["rounds"])
            rep = runner.report(warmup_rounds=cfg["warmup"])
            rep["total_wall_s"] = time.perf_counter() - t0
            out["digests"][mode] = variables_digest(variables)
            out["per_mode"][mode] = rep
            if cfg["eval"] and ctx.rank == 0:
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
        if ctx.rank == 0:
            # the coordinator's barrier ledger and cluster SLO verdict
            # (always-on local bookkeeping)
            out["straggler"] = cluster_mod.straggler_summary()
            out["cluster_slo"] = cluster_mod.cluster_slo_report()
        print(json.dumps(out, default=str), flush=True)
    finally:
        channel.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
