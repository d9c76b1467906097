"""Unified experiment launcher of the port (fedml_tpu/cli.py, flag for
flag): the fedml_experiments parity surface.

One CLI replaces the reference's per-(algorithm x paradigm) main_*.py files
and the fed_launch unified launcher (fedml_experiments/distributed/
fed_launch/main.py): the canonical flag set of main_fedavg.py:46-135 plus
`--algorithm` dispatch.  `mpirun -np N` + hostfiles + gpu_mapping.yaml are
replaced by ranks joined by torch.distributed: `--mesh` runs the cohort
over a mesh of every rank of the world (one process: a mesh of one rank,
the one-card engine bitwise); under a launched multihost cluster
(`--multihost_procs N`, or parallel/launch.py) the engine's mesh is this
member's local group and the two-level runner exchanges carries across
members.

The engines run on the CUDA card unless `--device` names another
(`--device cpu` runs every kernel's plain PyTorch version); without a
card the default raises, never falling back to the CPU.

Usage:
  python -m fedml_tpu_torch --algorithm fedavg --dataset mnist --model lr \\
      --client_num_in_total 1000 --client_num_per_round 10 --comm_round 100
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Optional

import numpy as np
import torch

from fedml_tpu_torch.utils.config import FedConfig

ALGORITHMS = ("fedavg", "fedopt", "fedprox", "fednova", "fedavg_robust",
              "hierarchical", "decentralized", "fednas", "fedgan",
              "fedgkt", "splitnn", "fedseg", "vfl", "turboaggregate",
              "centralized")

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "fedml_tpu_torch",
        description="federated learning on PyTorch and CUDA (the port of "
                    "fedml_tpu)")
    # canonical reference flags (main_fedavg.py:46-135)
    p.add_argument("--algorithm", choices=ALGORITHMS, default="fedavg")
    p.add_argument("--model", type=str, default="lr")
    p.add_argument("--dataset", type=str, default="mnist")
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--partition_method", type=str, default="hetero")
    p.add_argument("--partition_alpha", type=float, default=0.5)
    p.add_argument("--client_num_in_total", type=int, default=10)
    p.add_argument("--client_num_per_round", type=int, default=10)
    p.add_argument("--comm_round", type=int, default=10)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=10)
    p.add_argument("--client_optimizer", type=str, default="sgd")
    p.add_argument("--lr", type=float, default=0.03)
    p.add_argument("--momentum", type=float, default=0.0)
    p.add_argument("--wd", type=float, default=0.0)
    # None = "not set on the command line": FedConfig supplies the FedOpt
    # defaults (sgd @ 1.0 / 0.0) while fedgkt can tell an explicit
    # --server_momentum 0.0 apart from the flag being absent
    p.add_argument("--server_optimizer", type=str, default=None)
    p.add_argument("--server_lr", type=float, default=None)
    p.add_argument("--server_momentum", type=float, default=None)
    p.add_argument("--prox_mu", type=float, default=0.0)
    p.add_argument("--norm_bound", type=float, default=5.0)
    p.add_argument("--stddev", type=float, default=0.0)
    p.add_argument("--frequency_of_the_test", type=int, default=5)
    p.add_argument("--no_local_test_eval", dest="local_test_eval",
                   action="store_false",
                   help="skip the per-client test eval inside evaluate() "
                        "(reference _local_test_on_all_clients parity is "
                        "ON by default)")
    p.add_argument("--seed", type=int, default=0)
    # the one flag the JAX CLI lacks: the port's entry points run on the
    # card unless the caller names another device
    p.add_argument("--device", type=str, default=None,
                   help="torch device the engines run on (default: the "
                        "CUDA card, which must be present; 'cpu' runs the "
                        "kernels' plain PyTorch versions).  A self-spawned "
                        "multihost cluster's processes inherit it")
    p.add_argument("--ci", type=int, default=0)
    p.add_argument("--synthetic_scale", type=float, default=1.0)
    p.add_argument("--train_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    # fedseg utils parity: LR_Scheduler (poly/cos/step + warmup) and
    # SegmentationLosses (focal, ignore_index) — fedseg/utils.py:71-157
    p.add_argument("--lr_scheduler", type=str, default=None,
                   choices=("poly", "cos", "step"),
                   help="per-local-round LR schedule over E*B steps")
    p.add_argument("--lr_step", type=int, default=0,
                   help="step schedule: epochs per 0.1x decay")
    p.add_argument("--warmup_epochs", type=int, default=0)
    p.add_argument("--loss_type", type=str, default=None,
                   choices=("ce", "focal"),
                   help="override the dataset-derived loss")
    p.add_argument("--train_ignore_id", type=int, default=None,
                   help="label id excluded from train loss + metrics "
                        "(segmentation void label, reference 255)")
    p.add_argument("--max_batches_per_client", type=int, default=None)
    p.add_argument("--augment", action="store_true",
                   help="crop+flip(+cutout) augmentation in the train step")
    # real multi-process deployment (the reference's run_fedavg_grpc.sh /
    # run_fedavg_trpc.sh launch pattern): one process per rank
    p.add_argument("--deploy", choices=("server", "client"), default=None,
                   help="run ONE deployment rank over sockets instead of "
                        "the in-process simulation")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world_size", type=int, default=3,
                   help="server + clients (deployment mode)")
    p.add_argument("--comm_backend", type=str, default="TCP",
                   choices=("GRPC", "TCP", "NATIVE_TCP"))
    p.add_argument("--base_port", type=int, default=52000)
    p.add_argument("--wire_transport", type=str, default="none",
                   choices=("none", "bf16", "int8"),
                   help="deployment mode: lossy wire dtype for the "
                        "server->client model sync (wire codec v2, "
                        "comm/message.py) — bf16 halves / int8 quarters "
                        "the downlink model bytes; client uploads feed "
                        "the aggregation and ALWAYS ride exact.  "
                        "'none' (default) keeps every payload exact; "
                        "FEDML_WIRE_V1=1 force-disables v2 framing "
                        "process-wide (the escape hatch)")
    p.add_argument("--wire_compress", action="store_true",
                   help="deployment mode: zlib-compress the wire "
                        "frame's header+small-array section (lossless; "
                        "wire codec v2)")
    # chaos + reliability (comm/chaos.py + comm/reliability.py)
    p.add_argument("--reliable", action="store_true",
                   help="deployment mode: envelope frames with the "
                        "reliability layer (per-peer seq + CRC32, "
                        "ack/nack, backoff resend, duplicate "
                        "suppression) — exactly-once ingestion over "
                        "lossy links; FEDML_RELIABLE=0 force-disables "
                        "it process-wide (the escape hatch)")
    p.add_argument("--chaos_drop", type=float, default=0.0,
                   help="deployment mode: P(inbound frame dropped) — "
                        "seeded wire-level fault injection "
                        "(comm/chaos.py); pair with --reliable to "
                        "exercise the resend path")
    p.add_argument("--chaos_dup", type=float, default=0.0,
                   help="deployment mode: P(inbound frame duplicated)")
    p.add_argument("--chaos_corrupt", type=float, default=0.0,
                   help="deployment mode: P(inbound frame byte-flipped "
                        "— quarantined + nacked under --reliable)")
    p.add_argument("--chaos_delay", type=float, default=0.0,
                   help="deployment mode: P(inbound frame delayed "
                        "~exp(10ms))")
    p.add_argument("--chaos_seed", type=int, default=0,
                   help="fault-injection seed: same seed = same "
                        "per-stream injected-event trace")
    # overload-safe reactor transport (comm/reactor.py)
    p.add_argument("--tcp_transport", choices=("reactor", "threads"),
                   default="reactor",
                   help="deployment mode, TCP/NATIVE_TCP: 'reactor' "
                        "(default) = the selector event-loop transport "
                        "— bounded per-connection buffers, slow-peer "
                        "stall eviction, per-connection rate ceilings, "
                        "load shedding and graceful drain (holds 10k "
                        "live connections); 'threads' = the legacy "
                        "one-recv-thread-per-connection path "
                        "(FEDML_TCP_REACTOR=0 forces it process-wide)")
    p.add_argument("--conn_reactors", type=int, default=1,
                   help="reactor transport: event loops (≈ one per "
                        "core on a busy server)")
    p.add_argument("--conn_max", type=int, default=16384,
                   help="reactor transport: inbound-connection "
                        "admission ceiling — accepts past it are shed "
                        "(counted in comm_uplinks_shed_total)")
    p.add_argument("--conn_stall_timeout_s", type=float, default=30.0,
                   help="reactor transport: slowloris eviction — a "
                        "connection mid-frame with no progress for "
                        "this long is closed (comm_connections_"
                        "evicted_total{reason=stall})")
    p.add_argument("--conn_max_frames_per_sec", type=float, default=None,
                   help="reactor transport: per-connection frame-rate "
                        "ceiling (violating windows throttle, repeat "
                        "offenders evict with reason=rate); unset = "
                        "no ceiling")
    p.add_argument("--conn_max_bytes_per_sec", type=float, default=None,
                   help="reactor transport: per-connection byte-rate "
                        "ceiling (same throttle-then-evict ladder)")
    # async federation (fedml_tpu_torch/async_): buffered staleness-aware
    # commits over a seeded client-lifecycle simulator — FedBuff-style
    # semi-async (commit on K buffered results or a deadline), FedAsync
    # as the K=1 degenerate config.  PERF.md "Async federation".
    p.add_argument("--async", dest="async_mode", action="store_true",
                   help="run the buffered asynchronous scheduler "
                        "(fedml_tpu_torch/async_) instead of synchronous "
                        "rounds: commits fire on --async_buffer_k "
                        "buffered results or --async_round_deadline_s, "
                        "client results are staleness-discounted "
                        "(--async_staleness), and client churn comes "
                        "from the seeded lifecycle simulator "
                        "(--async_latency/--async_dropout_prob).  "
                        "comm_round counts COMMITS.  FedAvg/FedProx "
                        "only; incompatible with --mesh")
    p.add_argument("--async_buffer_k", type=int, default=None,
                   help="aggregation-buffer capacity K (default "
                        "client_num_per_round; 1 = pure FedAsync)")
    p.add_argument("--async_concurrency", type=int, default=None,
                   help="clients in flight at once (default "
                        "max(buffer_k, client_num_per_round))")
    p.add_argument("--async_round_deadline_s", type=float, default=None,
                   help="commit a part-full buffer after this many "
                        "(simulated) seconds since the last commit — "
                        "the crash/straggler escape hatch")
    p.add_argument("--async_staleness", type=str, default="constant",
                   choices=("constant", "polynomial", "hinge"),
                   help="staleness-discount family (FedAsync §5)")
    p.add_argument("--async_staleness_a", type=float, default=0.5,
                   help="polynomial exponent / hinge slope")
    p.add_argument("--async_staleness_b", type=float, default=4.0,
                   help="hinge knee (staleness where discounting starts)")
    p.add_argument("--async_mix", type=float, default=1.0,
                   help="server mixing rate alpha: v <- (1-a)v + "
                        "a*discounted_buffer_mean (1.0 installs the "
                        "mean — the FedAvg-degenerate setting)")
    p.add_argument("--async_seed", type=int, default=None,
                   help="lifecycle-simulator seed (default --seed); two "
                        "runs with equal seeds produce identical event "
                        "traces")
    p.add_argument("--async_latency", type=str, default="none",
                   choices=("none", "lognormal", "pareto"),
                   help="per-dispatch client latency family")
    p.add_argument("--async_latency_scale", type=float, default=1.0,
                   help="latency scale in simulated seconds")
    p.add_argument("--async_latency_sigma", type=float, default=0.5,
                   help="lognormal sigma / per-client heterogeneity "
                        "uses --async_heterogeneity")
    p.add_argument("--async_pareto_alpha", type=float, default=2.0,
                   help="pareto tail index for --async_latency pareto "
                        "(>1 for a finite mean; lower = heavier tail)")
    p.add_argument("--async_heterogeneity", type=float, default=0.0,
                   help="per-client persistent speed-factor spread "
                        "(lognormal sigma; 0 = homogeneous fleet)")
    p.add_argument("--async_dropout_prob", type=float, default=0.0,
                   help="P(crash mid-round) per dispatch")
    p.add_argument("--async_rejoin_prob", type=float, default=1.0,
                   help="P(a crashed client ever rejoins)")
    p.add_argument("--async_rejoin_delay_s", type=float, default=5.0,
                   help="mean rejoin delay (exponential, simulated s)")
    # million-client serving spine (fedml_tpu_torch/scale/):
    # trace-driven arrival processes shape the async lifecycle's
    # turnaround with a load curve — at the trough of the diurnal cycle
    # (or outside a flash crowd) the fleet answers slower, so staleness
    # and deadline behavior see production load shapes.  The standalone
    # heavy-traffic bench is `python bench.py --mode serve`.
    p.add_argument("--arrival_process", type=str, default="none",
                   choices=("none", "constant", "diurnal", "flash",
                            "trace"),
                   help="with --async: load-curve family modulating "
                        "dispatch turnaround (fedml_tpu_torch/scale/"
                        "arrivals.py) — diurnal sinusoid, flash-crowd "
                        "burst, or a replayed timestamp trace")
    p.add_argument("--arrival_rate", type=float, default=100.0,
                   help="base arrivals/sec of the load curve "
                        "(virtual seconds)")
    p.add_argument("--arrival_period_s", type=float, default=86400.0,
                   help="diurnal period (simulated seconds)")
    p.add_argument("--arrival_amplitude", type=float, default=0.8,
                   help="diurnal swing in [0, 1)")
    p.add_argument("--arrival_flash_at", type=float, default=300.0,
                   help="flash-crowd onset (simulated seconds)")
    p.add_argument("--arrival_flash_duration", type=float, default=60.0,
                   help="flash-crowd duration (simulated seconds)")
    p.add_argument("--arrival_flash_boost", type=float, default=10.0,
                   help="flash-crowd rate multiplier")
    p.add_argument("--arrival_trace", type=str, default=None,
                   help="replayed-trace file: one arrival timestamp "
                        "per line (--arrival_process trace)")
    # adversarial robustness (fedml_tpu_torch/async_/adversary.py +
    # defense.py): a seeded byzantine cohort rides the lifecycle, and
    # the server's admission pipeline + bucketed robust streaming
    # commit defend the async aggregation.  PERF.md "Adversarial
    # robustness".
    p.add_argument("--attack_mode", type=str, default="none",
                   choices=("none", "signflip", "boost", "gaussian",
                            "labelflip", "backdoor", "mixed"),
                   help="with --async: seeded byzantine-client attack — "
                        "signflip reverses update directions, boost is "
                        "scaled model replacement, gaussian adds noise, "
                        "labelflip/backdoor poison the attackers' "
                        "shards (data/poison.py), mixed = boost + "
                        "labelflip (the acceptance arm)")
    p.add_argument("--attack_frac", type=float, default=0.2,
                   help="byzantine fraction of the fleet")
    p.add_argument("--attack_boost", type=float, default=10.0,
                   help="model-replacement scale (boost/mixed)")
    p.add_argument("--attack_noise_std", type=float, default=1.0,
                   help="gaussian-attack noise std")
    p.add_argument("--attack_target_label", type=int, default=0,
                   help="label-flip/backdoor target class")
    p.add_argument("--attack_collude", action="store_true",
                   help="colluding cohort: every byzantine client at a "
                        "version sends the identical crafted row")
    p.add_argument("--attack_stale", action="store_true",
                   help="stale-attack: byzantine uplinks are timed to "
                        "land at high staleness (--attack_stale_lag)")
    p.add_argument("--attack_stale_lag", type=float, default=3.0,
                   help="extra byzantine dispatch latency (sim seconds)")
    p.add_argument("--attack_seed", type=int, default=0,
                   help="adversary seed: same seed = same byzantine set "
                        "and corruption streams")
    p.add_argument("--defense_norm_bound", type=float, default=None,
                   help="admission clip: client update deltas are "
                        "norm-clipped to this bound at the insert path "
                        "(the ONE clip definition norm_diff_clip/the "
                        "clip-aggregation kernel share)")
    p.add_argument("--defense_screen", action="store_true",
                   help="arm the z-score + cosine anomaly screen "
                        "against a running reference of accepted "
                        "updates (quarantines instead of folding)")
    p.add_argument("--defense_z_max", type=float, default=4.0,
                   help="robust z threshold on the update-delta norm")
    p.add_argument("--defense_cos_min", type=float, default=-1.0,
                   help="cosine floor vs the accepted-direction "
                        "reference (-1 disables; catches sign-flip)")
    p.add_argument("--defense_warmup", type=int, default=8,
                   help="accepted updates before the screen arms")
    p.add_argument("--defense_buckets", type=int, default=1,
                   help="bucketed robust streaming aggregation: B "
                        "seeded bucket accumulators, committed via a "
                        "robust combine ACROSS bucket means (O(B*P) "
                        "memory; 1 + trim 0 = the exact undefended streaming "
                        "commit)")
    p.add_argument("--defense_combine", type=str, default="trimmed_mean",
                   choices=("mean", "trimmed_mean", "median"),
                   help="combine across bucket means")
    p.add_argument("--defense_trim_k", type=int, default=0,
                   help="buckets trimmed per side (trimmed_mean)")
    p.add_argument("--defense_dp_clip", type=float, default=None,
                   help="DP-FedAvg per-client clip S (uses the shared "
                        "clip definition; required by --defense_dp_noise)")
    p.add_argument("--defense_dp_noise", type=float, default=0.0,
                   help="DP-FedAvg noise multiplier z: Gaussian noise "
                        "sigma z*S/m added inside the commit")
    p.add_argument("--defense_seed", type=int, default=0,
                   help="bucket-assignment seed")
    # secure aggregation (fedml_tpu_torch/secure/): pairwise-mask
    # uplinks over the live messaging FSMs — the server only ever sees
    # masked field words; masks cancel exactly in the cohort sum and
    # dropout recovery reconstructs a dead client's masks from
    # escrowed key shares.  PERF.md "Secure aggregation".
    p.add_argument("--secure_agg", action="store_true",
                   help="pairwise-mask secure aggregation on the "
                        "messaging paths (sync FSM, or the live async "
                        "server with --async); combine with "
                        "--defense_dp_clip/--defense_dp_noise for the "
                        "end-to-end private mode (client-side clip+"
                        "noise BEFORE masking)")
    p.add_argument("--secure_threshold", type=int, default=0,
                   help="minimum surviving clients to unmask a round "
                        "(also the key-share reconstruction threshold); "
                        "0 = cohort majority")
    p.add_argument("--secure_scale", type=int, default=2 ** 16,
                   help="fixed-point quantization scale (field words = "
                        "round(x*scale) mod p); the usable range is "
                        "±(p-1)/(2*scale)")
    p.add_argument("--secure_seed", type=int, default=0,
                   help="keyring seed: every rank derives the same DH "
                        "key material + escrowed shares from it "
                        "(simulation-grade trust model — see "
                        "fedml_tpu_torch/secure/secagg.py)")
    # replacements for mpirun/hostfile/gpu_mapping
    p.add_argument("--streaming", action="store_true",
                   help="host-resident client stack; upload only each "
                        "round's sampled cohort (cross-device scale)")
    p.add_argument("--cohort_chunk", type=int, default=None,
                   help="max client model replicas live per shard "
                        "(default 8; tools/profile_bench.py)")
    p.add_argument("--batch_unroll", type=int, default=None,
                   help="unroll factor of the JAX package's local batch "
                        "scan; no effect in the port, whose batches run "
                        "as a Python loop (checked >= 1 all the same)")
    p.add_argument("--local_dtype", type=str, default=None,
                   choices=("float32", "bfloat16"),
                   help="dtype of the LOCAL training masters (mesh "
                        "engines): bfloat16 runs the per-client step "
                        "chain in bf16, aggregation and the global model "
                        "stay f32 (the main path's recipe)")
    p.add_argument("--stack_dtype", type=str, default=None,
                   choices=("float32", "bfloat16", "uint8"),
                   help="storage dtype of the client stack's INPUTS (mesh "
                        "engines): bfloat16 halves the cohort's device "
                        "footprint and upload bytes; uint8 stores image "
                        "cohorts in their 8-bit form (4x fewer bytes than "
                        "f32) and dequantizes on the device a chunk at a "
                        "time.  Both are accuracy tradeoffs the user opts "
                        "into; omit the flag for the exact f32 path")
    p.add_argument("--stream_block", type=int, default=None,
                   help="block-streamed rounds (FedAvg-family mesh "
                        "engines): upload the cohort in blocks of this "
                        "many clients WITHIN each round (double-"
                        "buffered), accumulating the linear sums on the "
                        "device: device data memory becomes O(block), so "
                        "the cohort is bounded by host memory; the "
                        "cohort's bytes cross host->device every round.  "
                        "Implies --streaming")
    p.add_argument("--no_prefetch", action="store_true",
                   help="disable the background host->device prefetch "
                        "pipeline on the streaming/block-stream mesh "
                        "paths (strictly synchronous gather->upload->"
                        "compute — the escape hatch for bitwise "
                        "comparison against the pipelined rounds; "
                        "PERF.md 'Prefetch pipeline')")
    p.add_argument("--no_flat_stack", action="store_true",
                   help="the JAX package's flat image-cohort storage "
                        "switch (an XLA layout workaround); no effect in "
                        "the port")
    p.add_argument("--mesh", action="store_true",
                   help="shard the cohort over a mesh of every rank of "
                        "torch.distributed's world (one process: a mesh "
                        "of one rank, the one-card engine bitwise; under "
                        "a launched cluster, this member's local group)")
    p.add_argument("--mesh_batch", type=int, default=None,
                   help="with --mesh: fold this many ranks into a "
                        "'batch' axis (clients x batch mesh) — each "
                        "client's per-step batch splits over it with a "
                        "per-step grad psum (per-client sample "
                        "parallelism for ranks > cohort; must divide "
                        "both the world's rank count and the batch size)")
    p.add_argument("--multihost", action="store_true",
                   help="join the multi-host runtime first "
                        "(torch.distributed over gloo, at the launcher's "
                        "rendezvous; replaces mpirun)")
    p.add_argument("--multihost_procs", type=int, default=None,
                   help="self-spawn this many processes as a multihost "
                        "cluster on this box (the dev harness; equals "
                        "`tools/launch_multihost.py --procs N -- <this "
                        "command>`): each process trains its client-id "
                        "range's blocks on a LOCAL mesh and the P-sized "
                        "carry allreduces across processes "
                        "(two-level aggregation, )")
    p.add_argument("--agg_blocks", type=int, default=None,
                   help="multihost: block count of the two-level "
                        "reduction tree (default: the process count). "
                        "The tree is a function of the BLOCK partition, "
                        "not the topology — pin it across runs to keep "
                        "commits bitwise comparable at different "
                        "process counts")
    p.add_argument("--elastic", action="store_true",
                   help="multihost: elastic membership  — a "
                        "dead or hung rank triggers an epoch-numbered "
                        "view change and the survivors re-adopt its "
                        "blocks mid-round (bitwise-identical commits by "
                        "the block-partition contract); a restarted "
                        "rank (FEDML_MH_REJOIN=1, set by the launcher's "
                        "--respawn) rejoins via config-digest handshake "
                        "+ a rank-0 model snapshot.  Default is "
                        "FAIL-FAST: one dead rank kills the cluster, "
                        "named")
    p.add_argument("--hb_timeout_s", type=float, default=2.0,
                   help="with --elastic: heartbeat silence after which "
                        "a rank is suspected hung (the SIGSTOP "
                        "detector; detection runs between allgathers, "
                        "not only inside one)")
    p.add_argument("--cluster_serve", action="store_true",
                   help="run the fused serving cluster  "
                        "instead of training: this process binds a "
                        "reactor endpoint on --cluster_port (+rank) "
                        "and serves live-socket uplinks into its "
                        "registry-shard lanes, folding lane partials "
                        "cross-host at each commit barrier.  Composes "
                        "with --multihost_procs N --elastic (one host "
                        "per process); drive load with `python -m "
                        "fedml_tpu_torch.comm.connswarm CFG.json` pointed at "
                        "the endpoints")
    p.add_argument("--cluster_port", type=int, default=54300,
                   help="cluster serving: this host's uplink endpoint "
                        "port is cluster_port + rank")
    p.add_argument("--cluster_population", type=int, default=4096,
                   help="cluster serving: total client-id space, "
                        "range-partitioned across hosts")
    p.add_argument("--cluster_commits", type=int, default=8,
                   help="cluster serving: commit windows to serve")
    p.add_argument("--cluster_buffer_k", type=int, default=16,
                   help="cluster serving: uplinks per lane per commit "
                        "window")
    p.add_argument("--cluster_row_dim", type=int, default=256,
                   help="cluster serving: flat model row dimension")
    p.add_argument("--cluster_connections", type=int, default=64,
                   help="cluster serving: reactor connection budget "
                        "per host")
    p.add_argument("--cluster_ingest_pool", type=int, default=2,
                   help="cluster serving: decode-pool workers per host")
    p.add_argument("--cluster_window_s", type=float, default=10.0,
                   help="cluster serving: commit-window deadline — a "
                        "lane with no socket traffic contributes what "
                        "it has when this passes instead of wedging "
                        "the cluster barrier")
    p.add_argument("--carry_codec", type=str, default="f32",
                   choices=("f32", "int8", "int8_ef", "topk", "topk_ef"),
                   help="multihost: wire codec for the inter-host carry "
                        "(f32, the default, is the bitwise "
                        "escape hatch — bytes identical to the uncompressed "
                        "tier); int8 is per-chunk affine fixed-point "
                        "(~4x fewer bytes); int8_ef adds per-block "
                        "error-feedback residuals so the SUM over "
                        "rounds converges to the true sum; topk ships "
                        "only the k=dim/16 largest-|v| entries (~7.5x "
                        "fewer bytes, LOSSY); topk_ef adds the int8_ef "
                        "residual discipline to top-k so the summed "
                        "carry drift stays a single round's truncation")
    p.add_argument("--overlap_exchange", action="store_true",
                   help="multihost: ship each block's encoded carry as "
                        "soon as it is computed so the exchange "
                        "overlaps the remaining blocks' compute "
                        "(AsyncValue send chain). Commits are "
                        "bitwise-identical to the serial exchange at "
                        "the same codec — frames concatenate in the "
                        "same global block order")
    p.add_argument("--group_num", type=int, default=2,
                   help="hierarchical: silo count")
    p.add_argument("--group_comm_round", type=int, default=2)
    p.add_argument("--defense", type=str, default="norm_clip",
                   choices=("norm_clip", "krum", "multi_krum", "median",
                            "trimmed_mean"))
    p.add_argument("--n_byzantine", type=int, default=0,
                   help="assumed Byzantine count (krum neighbor count, "
                        "trimmed-mean trim width)")
    p.add_argument("--multi_krum_m", type=int, default=None,
                   help="multi-krum selection size (default K - f - 2)")
    p.add_argument("--topology", type=str, default="ring",
                   choices=("ring", "ws", "asymmetric"),
                   help="decentralized graph: ring = symmetric ring "
                        "(add Watts-Strogatz extra links by raising "
                        "--neighbor_num above 2); ws = deprecated alias "
                        "for ring; asymmetric = directed with randomly "
                        "deleted links (reference "
                        "asymmetric_topology_manager.py)")
    p.add_argument("--neighbor_num", type=int, default=2,
                   help="ring topology: neighbors per worker; >2 adds "
                        "Watts-Strogatz style extra links "
                        "(symmetric_topology_manager.py:21-52)")
    p.add_argument("--unrolled", action="store_true",
                   help="fednas: 2nd-order architect")
    p.add_argument("--gdas", action="store_true",
                   help="fednas: GDAS single-path gumbel sampling")
    p.add_argument("--nas_channels", type=int, default=16)
    p.add_argument("--nas_layers", type=int, default=8)
    p.add_argument("--nas_steps", type=int, default=4)
    p.add_argument("--nas_multiplier", type=int, default=4)
    # observability / checkpointing (SURVEY.md §5 gaps the build fills)
    p.add_argument("--obs_dir", type=str, default=None,
                   help="enable the unified observability layer "
                        "(fedml_tpu_torch/obs): span tracer (Chrome-trace + "
                        "JSONL exports), metrics registry (Prometheus "
                        "text + JSON snapshots — comm bytes per "
                        "backend, retries, round/upload walls, program "
                        "dispatches, device memory gauges), and a flight "
                        "recorder "
                        "that dumps recent events + thread stacks on "
                        "SIGUSR1, engine errors, or round-deadline "
                        "overruns.  Artifacts land in this directory; "
                        "defaults off (zero overhead).  PERF.md "
                        "'Observability' has the triage recipes")
    p.add_argument("--round_deadline_s", type=float, default=None,
                   help="with --obs_dir: flight-recorder dump when one "
                        "round exceeds this wall-clock (the hang/"
                        "straggler tripwire; the run is NOT killed)")
    p.add_argument("--obs_http_port", type=int, default=None,
                   help="serve the loopback introspection endpoint on "
                        "this port (0 = ephemeral): /metrics Prometheus "
                        "text, /rollup JSON, /flight dump trigger — "
                        "long async/torture runs become inspectable "
                        "without SIGUSR1 shell access.  Works without "
                        "--obs_dir (metrics are always on); "
                        "FEDML_OBS_HTTP_PORT is the env twin")
    p.add_argument("--slo", action="store_true",
                   help="run the default serving-spine SLO pack "
                        "(fedml_tpu_torch/obs/slo.py) as a periodic "
                        "background evaluator: committed-updates/sec "
                        "floor, admission/loop-lag p95 ceilings, zero "
                        "quarantines/evictions/sheds/recv-deaths.  A "
                        "breach increments slo_breaches_total{slo}, "
                        "fires a throttled flight dump (with "
                        "--obs_dir), and surfaces on the httpd /slo "
                        "endpoint and obs.rollup().  Works without "
                        "--obs_dir (metrics are always on)")
    p.add_argument("--slo_period_s", type=float, default=5.0,
                   help="with --slo: seconds between SLO evaluation "
                        "windows (each window judges the metric DELTAS "
                        "since the previous one)")
    p.add_argument("--run_dir", type=str, default="./runs")
    p.add_argument("--run_name", type=str, default=None)
    p.add_argument("--ckpt_dir", type=str, default=None)
    p.add_argument("--ckpt_every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile_dir", type=str, default=None)
    return p


def _load(cfg: FedConfig, store_uint8: bool = False):
    from fedml_tpu_torch.data import load_data
    return load_data(cfg.dataset, data_dir=cfg.data_dir,
                     client_num_in_total=cfg.client_num_in_total,
                     batch_size=cfg.batch_size,
                     partition_method=cfg.partition_method,
                     partition_alpha=cfg.partition_alpha,
                     max_batches_per_client=cfg.max_batches_per_client,
                     seed=cfg.seed, synthetic_scale=cfg.synthetic_scale,
                     store_uint8=store_uint8)


# engines that consume the mesh cohort path's knobs (--stack_dtype,
# --stream_block, ...): the uint8 loader storage is gated on these so a
# non-mesh engine never receives a quantized stack it cannot dequantize
_STACK_DTYPE_ALGOS = ("fedavg", "fedopt", "fedprox", "fednova",
                      "fedavg_robust")
# the mesh engines of the port (every algorithm but these four)
_NO_MESH_ALGOS = ("splitnn", "vfl", "turboaggregate")


def _trainer(cfg: FedConfig, data, model_name: Optional[str] = None,
             force_time_axis: bool = False,
             default_train_ignore: Optional[int] = None):
    """The ClientTrainer of a run.  `model_name` overrides cfg.model
    (fedseg forces segnet), `force_time_axis` broadcasts the per-sample
    mask over trailing label axes (sequence time or segmentation H, W),
    `default_train_ignore` is the void label applied when the user gave
    no --train_ignore_id (VOC 255)."""
    from fedml_tpu_torch.core.trainer import ClientTrainer, make_lr_schedule
    from fedml_tpu_torch.models import create_model
    loss = "bce" if cfg.dataset == "stackoverflow_lr" else "ce"
    if cfg.loss_type:
        loss = cfg.loss_type
    # LEAF shakespeare is a scalar next-char task (the model predicts the
    # last position only, reference rnn.py:30-33); the TFF variants are
    # per-position
    has_time = force_time_axis or cfg.dataset in ("fed_shakespeare",
                                                  "stackoverflow_nwp")
    kw = ({"last_only": True}
          if cfg.model in ("rnn", "transformer")
          and cfg.dataset == "shakespeare" else {})
    # flax infers a model's input width from the first batch; the port's
    # models take it: LR the flattened features, the CNNs their images'
    # channels and side
    sample = np.shape(data.client_shards["x"])[3:]
    name = model_name or cfg.model
    if name == "lr":
        kw["input_dim"] = int(np.prod(sample))
    elif name in ("cnn", "cnn_dropout") and len(sample) >= 2:
        kw.update(image_hw=int(sample[0]),
                  in_channels=int(sample[2]) if len(sample) == 3 else 1)
    model = create_model(name, data.class_num, **kw)
    dtype = (torch.bfloat16 if cfg.train_dtype == "bfloat16"
             else torch.float32)
    aug = None
    if cfg.augment:
        if default_train_ignore is not None:
            # segmentation: augment transforms x only, which would
            # misalign the spatial labels
            raise SystemExit("--augment is not supported for fedseg")
        if np.ndim(data.client_shards["x"]) != 6:  # [C, B, bs, H, W, ch]
            raise SystemExit("--augment requires an image dataset")
        from fedml_tpu_torch.data.augment import make_augment_fn
        cut = 16 if cfg.dataset in ("cifar10", "cifar100", "cinic10",
                                    "fed_cifar100") else None
        aug = make_augment_fn(crop_padding=4, flip=True, cutout_length=cut)
    # TFF metric convention: NWP/snippet accuracy ignores <pad> (id 0 in
    # both text.py vocab layouts)
    ignore = 0 if cfg.dataset in ("fed_shakespeare",
                                  "stackoverflow_nwp") else None
    lr = cfg.lr
    if cfg.lr_scheduler:
        # the schedule spans one local round: E epochs x B padded batches
        # (padding steps advance its count, so ragged clients walk the
        # same decay)
        B = np.shape(data.client_shards["x"])[1]
        lr = make_lr_schedule(cfg.lr_scheduler, cfg.lr,
                              total_steps=cfg.epochs * B,
                              iters_per_epoch=B,
                              lr_step_epochs=cfg.lr_step,
                              warmup_steps=cfg.warmup_epochs * B)
    train_ignore = (default_train_ignore if cfg.train_ignore_id is None
                    else cfg.train_ignore_id)
    return ClientTrainer(model, loss=loss, optimizer=cfg.client_optimizer,
                         lr=lr, momentum=cfg.momentum,
                         weight_decay=cfg.wd, prox_mu=cfg.prox_mu,
                         has_time_axis=has_time, train_dtype=dtype,
                         augment=aug, eval_ignore_id=ignore,
                         train_ignore_id=train_ignore)


def _local_dtype(args):
    """--local_dtype -> torch dtype (None: f32 local masters)."""
    return torch.bfloat16 if args.local_dtype == "bfloat16" else None


def _stack_dtype(args):
    """--stack_dtype -> torch dtype (None/float32: store the inputs as
    loaded).  Unknown values raise: argparse's choices guard the CLI, but
    programmatic callers building a Namespace by hand must not have a
    typo silently mean the f32 stack."""
    v = getattr(args, "stack_dtype", None)
    if v in (None, "float32"):
        return None
    if v == "bfloat16":
        return torch.bfloat16
    if v == "uint8":
        return torch.uint8
    raise SystemExit(
        f"--stack_dtype {v!r} is not supported (choose float32, "
        "bfloat16, or uint8)")


def _attack_config(args):
    """--attack_* flags -> AttackConfig (None when no attack)."""
    if getattr(args, "attack_mode", "none") == "none":
        return None
    from fedml_tpu_torch.async_ import AttackConfig
    return AttackConfig(
        mode=args.attack_mode, frac=args.attack_frac,
        boost=args.attack_boost, noise_std=args.attack_noise_std,
        target_label=args.attack_target_label,
        collude=args.attack_collude, stale=args.attack_stale,
        stale_lag=args.attack_stale_lag, seed=args.attack_seed)


def _defense_config(args):
    """--defense_* flags -> DefenseConfig (None when every stage is at
    its default: the undefended path stays untouched)."""
    if not (args.defense_norm_bound is not None or args.defense_screen
            or args.defense_buckets > 1 or args.defense_trim_k > 0
            or args.defense_combine != "trimmed_mean"
            or args.defense_dp_noise > 0.0
            or args.defense_dp_clip is not None):
        return None
    from fedml_tpu_torch.async_ import DefenseConfig
    return DefenseConfig(
        norm_bound=args.defense_norm_bound, screen=args.defense_screen,
        z_max=args.defense_z_max, cos_min=args.defense_cos_min,
        screen_warmup=args.defense_warmup, buckets=args.defense_buckets,
        combine=args.defense_combine, trim_k=args.defense_trim_k,
        dp_clip=args.defense_dp_clip, dp_noise=args.defense_dp_noise,
        seed=args.defense_seed)


def _secure_config(args):
    """--secure_agg flags -> SecAggConfig (None when secure mode is off).
    The private mode composes through the defense DP flags on purpose:
    --defense_dp_clip/--defense_dp_noise become CLIENT-side clip and
    noise before masking (the server never sees a per-client row)."""
    if not getattr(args, "secure_agg", False):
        return None
    from fedml_tpu_torch.secure import SecAggConfig
    return SecAggConfig(
        threshold=args.secure_threshold,
        scale=args.secure_scale,
        seed=args.secure_seed,
        dp_clip=args.defense_dp_clip,
        dp_noise=args.defense_dp_noise)


def _arrival_config(args):
    """--arrival_* flags -> ArrivalConfig (None when mode is 'none')."""
    if getattr(args, "arrival_process", "none") == "none":
        return None
    from fedml_tpu_torch.scale import ArrivalConfig
    return ArrivalConfig(
        mode=args.arrival_process, rate=args.arrival_rate,
        period_s=args.arrival_period_s, amplitude=args.arrival_amplitude,
        flash_at_s=args.arrival_flash_at,
        flash_duration_s=args.arrival_flash_duration,
        flash_boost=args.arrival_flash_boost,
        trace_path=args.arrival_trace, seed=args.seed)


def _lifecycle_config(args, cfg: FedConfig):
    from fedml_tpu_torch.async_ import LifecycleConfig
    return LifecycleConfig(
        latency=args.async_latency,
        latency_scale=args.async_latency_scale,
        latency_sigma=args.async_latency_sigma,
        pareto_alpha=args.async_pareto_alpha,
        heterogeneity=args.async_heterogeneity,
        dropout_prob=args.async_dropout_prob,
        rejoin_prob=args.async_rejoin_prob,
        rejoin_delay_s=args.async_rejoin_delay_s,
        seed=args.async_seed if args.async_seed is not None else cfg.seed)


def _build_async_engine(args, cfg: FedConfig, data):
    """--async: the buffered staleness-aware scheduler over the seeded
    lifecycle simulator (async_/).  FedAvg/FedProx only: the commit is the
    FedAvg mixing rule."""
    from fedml_tpu_torch.async_ import AsyncFedAvgEngine
    if args.algorithm not in ("fedavg", "fedprox"):
        raise SystemExit(f"--async supports fedavg/fedprox, not "
                         f"{args.algorithm!r}")
    if args.mesh:
        raise SystemExit("--async runs the dispatch-wave engine; --mesh is "
                         "not supported (the async cohort is bounded by "
                         "--async_concurrency, not device memory)")
    return AsyncFedAvgEngine(
        _trainer(cfg, data), data, cfg,
        buffer_k=args.async_buffer_k,
        concurrency=args.async_concurrency,
        staleness=args.async_staleness,
        staleness_a=args.async_staleness_a,
        staleness_b=args.async_staleness_b,
        mix=args.async_mix,
        round_deadline_s=args.async_round_deadline_s,
        lifecycle_cfg=_lifecycle_config(args, cfg),
        attack=_attack_config(args),
        defense=_defense_config(args),
        arrivals=_arrival_config(args),
        device=args.device)


def _mesh_for(args, cfg: FedConfig, algo: str):
    """The engine's mesh for --mesh (None without it): a (clients x batch)
    mesh with --mesh_batch, else this member's local group under a
    launched cluster, else every rank of torch.distributed's world."""
    if args.mesh_batch is not None and args.mesh_batch < 1:
        raise SystemExit(f"--mesh_batch must be >= 1, got {args.mesh_batch}")
    if (args.streaming or args.cohort_chunk or args.local_dtype
            or args.stack_dtype or args.mesh_batch) and not args.mesh:
        raise SystemExit("--streaming/--cohort_chunk/--local_dtype/"
                         "--stack_dtype/"
                         "--mesh_batch require --mesh (they configure the "
                         "mesh engine's cohort path)")
    if not args.mesh:
        return None
    from fedml_tpu_torch.parallel.mesh import (make_mesh, make_mesh_batch,
                                               world)
    if args.mesh_batch:
        if algo not in ("fedavg", "fedopt", "fedprox", "fednova",
                        "fedavg_robust", "fedseg"):
            raise SystemExit(f"--mesh_batch supports the FedAvg-family "
                             f"mesh engines, not {algo!r}")
        n_dev = world()[0]
        if n_dev % args.mesh_batch:
            raise SystemExit(f"--mesh_batch {args.mesh_batch} must divide "
                             f"the rank count ({n_dev}; one process a "
                             f"device: launch more ranks with "
                             f"--multihost)")
        if cfg.batch_size % args.mesh_batch:
            raise SystemExit(f"--mesh_batch {args.mesh_batch} must divide "
                             f"the batch size ({cfg.batch_size})")
        return make_mesh_batch(n_dev // args.mesh_batch, args.mesh_batch)
    from fedml_tpu_torch.parallel.multihost import (MultihostContext,
                                                    make_local_mesh)
    # under a launched multihost cluster the engine's mesh is the member's
    # local group: the cross-member traffic is the runner's carry
    # exchange, never a mesh collective
    return (make_local_mesh() if MultihostContext.from_env() is not None
            else make_mesh())


def build_engine(args, cfg: FedConfig, data):
    """Algorithm dispatch (the reference's fed_launch algorithm select)."""
    algo = args.algorithm
    dev = args.device
    if getattr(args, "async_mode", False):
        return _build_async_engine(args, cfg, data)
    if (getattr(args, "attack_mode", "none") != "none"
            or _defense_config(args) is not None):
        log.warning(
            "--attack_*/--defense_* reach only the --async engine (the "
            "sync robust path is --algorithm fedavg_robust --defense ...); "
            "ignored by %s", algo)
    if getattr(args, "arrival_process", "none") != "none":
        log.warning("--arrival_* reaches only the --async engine (sync "
                    "rounds have no virtual clock to shape); ignored by %s",
                    algo)
    mesh = _mesh_for(args, cfg, algo)
    if mesh is not None and algo in _NO_MESH_ALGOS:
        log.warning("--mesh has no %s engine; running the single-device "
                    "path", algo)
    if args.stack_dtype and algo not in _STACK_DTYPE_ALGOS:
        log.warning("--stack_dtype reaches only the FedAvg-family mesh "
                    "engines; ignored by %s", algo)
    if args.stream_block is not None and (
            mesh is None or algo not in _STACK_DTYPE_ALGOS):
        log.warning("--stream_block reaches only the FedAvg-family MESH "
                    "engines (needs --mesh); ignored by %s%s", algo,
                    "" if mesh is not None else " without --mesh")
    if args.batch_unroll is not None and algo in ("fednas", "fedgan",
                                                  "fedgkt", "splitnn",
                                                  "vfl"):
        log.warning("--batch_unroll is ignored by %s (no ClientTrainer "
                    "batch loop)", algo)
    if algo in ("fedavg", "fedopt", "fedprox", "fednova", "fedavg_robust",
                "turboaggregate", "centralized"):
        trainer = _trainer(cfg, data)
        if mesh is not None and algo in _STACK_DTYPE_ALGOS:
            from fedml_tpu_torch.parallel import (MeshFedAvgEngine,
                                                  MeshFedNovaEngine,
                                                  MeshFedOptEngine,
                                                  MeshFedProxEngine,
                                                  MeshRobustEngine)
            cls = {"fedavg": MeshFedAvgEngine, "fedopt": MeshFedOptEngine,
                   "fedprox": MeshFedProxEngine,
                   "fednova": MeshFedNovaEngine,
                   "fedavg_robust": MeshRobustEngine}[algo]
            kw = {}
            if algo == "fedavg_robust":
                # all five defenses run on the mesh (the order statistics
                # through the gathered cohort matrix, or the two-phase
                # block stream with --stream_block)
                kw = dict(defense=args.defense,
                          n_byzantine=args.n_byzantine,
                          multi_krum_m=args.multi_krum_m)
            return cls(trainer, data, cfg, mesh=mesh,
                       streaming=args.streaming, chunk=args.cohort_chunk,
                       local_dtype=_local_dtype(args),
                       stack_dtype=_stack_dtype(args),
                       stream_block=args.stream_block,
                       prefetch=not args.no_prefetch, device=dev, **kw)
        if algo == "centralized":
            from fedml_tpu_torch.algorithms.centralized import (
                CentralizedTrainer)
            if mesh is not None and (args.streaming or args.cohort_chunk
                                     or args.local_dtype):
                log.warning("centralized mesh data parallelism ignores "
                            "--streaming/--cohort_chunk/--local_dtype")
            # mesh = the reference's DDP: the batch split over the ranks
            return CentralizedTrainer(trainer, data, cfg, mesh=mesh,
                                      device=dev)
        from fedml_tpu_torch import algorithms as A
        cls = {"fedavg": A.FedAvgEngine, "fedopt": A.FedOptEngine,
               "fedprox": A.FedProxEngine,
               "fednova": A.FedNovaEngine}.get(algo)
        if cls is not None:
            return cls(trainer, data, cfg, device=dev)
        if algo == "fedavg_robust":
            return A.FedAvgRobustEngine(trainer, data, cfg,
                                        defense=args.defense,
                                        n_byzantine=args.n_byzantine,
                                        multi_krum_m=args.multi_krum_m,
                                        device=dev)
        from fedml_tpu_torch.algorithms.turboaggregate import (
            TurboAggregateEngine)
        return TurboAggregateEngine(trainer, data, cfg, device=dev)

    if algo == "hierarchical":
        if args.streaming:
            log.warning("--streaming has no hierarchical engine path; the "
                        "client stack stays device-resident")
        if mesh is not None:
            from fedml_tpu_torch.parallel import MeshHierarchicalEngine
            from fedml_tpu_torch.parallel.mesh import make_mesh_2d, world
            n = world()[0]
            if n % args.group_num:
                raise SystemExit(
                    f"--mesh hierarchical lays {args.group_num} silos over "
                    f"the ranks, and the world has {n} (one process a "
                    f"device: launch a multiple of --group_num ranks with "
                    f"--multihost)")
            return MeshHierarchicalEngine(
                _trainer(cfg, data), data, cfg, n_silos=args.group_num,
                mesh=make_mesh_2d(args.group_num),
                group_comm_round=args.group_comm_round,
                chunk=args.cohort_chunk, local_dtype=_local_dtype(args),
                device=dev)
        from fedml_tpu_torch.algorithms import HierarchicalFedAvgEngine
        return HierarchicalFedAvgEngine(
            _trainer(cfg, data), data, cfg, group_num=args.group_num,
            group_comm_round=args.group_comm_round, device=dev)

    if algo == "decentralized":
        if mesh is not None:
            if args.local_dtype == "bfloat16":
                log.warning(
                    "--local_dtype bfloat16 does not apply to gossip: "
                    "worker models persist across rounds (no f32 global "
                    "to re-cast from each round), so bf16 masters would "
                    "accumulate rounding round over round; use "
                    "--train_dtype bfloat16 for bf16 compute instead")
            from fedml_tpu_torch.parallel import MeshGossipEngine
            return MeshGossipEngine(_trainer(cfg, data), data, cfg,
                                    mesh=mesh, device=dev)
        from fedml_tpu_torch.algorithms import DecentralizedGossipEngine
        from fedml_tpu_torch.core.topology import (
            AsymmetricTopologyManager, SymmetricTopologyManager)
        C = cfg.client_num_in_total
        if args.topology == "ws":
            log.warning("--topology ws is a deprecated alias for ring (use "
                        "--neighbor_num > 2 for Watts-Strogatz extra links)")
        topo = (AsymmetricTopologyManager(C)
                if args.topology == "asymmetric"
                else SymmetricTopologyManager(
                    C, neighbor_num=args.neighbor_num))
        topo.generate_topology()
        return DecentralizedGossipEngine(_trainer(cfg, data), data, cfg,
                                         topology=topo, device=dev)

    if algo == "fednas":
        nas_kw = dict(unrolled=args.unrolled, gdas=args.gdas,
                      C=args.nas_channels, layers=args.nas_layers,
                      steps=args.nas_steps,
                      multiplier=args.nas_multiplier, device=dev)
        if mesh is not None:
            if args.streaming or args.local_dtype:
                log.warning("fednas mesh engine supports --cohort_chunk "
                            "only; --streaming/--local_dtype are ignored")
            from fedml_tpu_torch.algorithms.fednas import (
                make_mesh_fednas_engine)
            return make_mesh_fednas_engine(data, cfg, mesh=mesh,
                                           chunk=args.cohort_chunk,
                                           **nas_kw)
        from fedml_tpu_torch.algorithms import FedNASSearchEngine
        return FedNASSearchEngine(data, cfg, **nas_kw)

    if algo == "fedseg":
        from fedml_tpu_torch.algorithms.fedseg import (
            FedSegEngine, make_mesh_fedseg_engine)
        # segnet, the mask broadcast over label H, W, VOC void 255
        # (reference SegmentationLosses ignore_index, fedseg/utils.py:72)
        trainer = _trainer(cfg, data, model_name="segnet",
                           force_time_axis=True, default_train_ignore=255)
        if mesh is not None:
            return make_mesh_fedseg_engine(
                trainer, data, cfg, mesh=mesh, streaming=args.streaming,
                chunk=args.cohort_chunk, local_dtype=_local_dtype(args),
                prefetch=not args.no_prefetch, device=dev)
        return FedSegEngine(trainer, data, cfg, device=dev)

    if algo == "fedgan":
        from fedml_tpu_torch.algorithms.fedgan import (
            FedGANEngine, make_mesh_fedgan_engine)
        from fedml_tpu_torch.models.gan import Discriminator, Generator
        out_dim = int(np.prod(np.shape(data.client_shards["x"])[3:]))
        if mesh is not None:
            if args.streaming or args.local_dtype:
                log.warning("fedgan mesh engine supports --cohort_chunk "
                            "only; --streaming/--local_dtype are ignored")
            return make_mesh_fedgan_engine(
                Generator(latent_dim=64, out_dim=out_dim), Discriminator(),
                data, cfg, latent_dim=64, mesh=mesh,
                chunk=args.cohort_chunk, device=dev)
        return FedGANEngine(Generator(latent_dim=64, out_dim=out_dim),
                            Discriminator(), data, cfg, latent_dim=64,
                            device=dev)

    if algo == "fedgkt":
        from fedml_tpu_torch.algorithms.fedgkt import (FedGKTEngine,
                                                       MeshFedGKTEngine)
        from fedml_tpu_torch.models.resnet_gkt import (ResNetClientGKT,
                                                       ResNetServerGKT)
        # GKT's server optimizer TRAINS the big model (client-lr default,
        # GKTServerTrainer.py:39-44): only --server_* flags the user
        # passed (parser default None) are forwarded
        kw = {"device": dev}
        if args.server_optimizer is not None:
            kw["server_optimizer"] = args.server_optimizer
        if args.server_lr is not None:
            kw["server_lr"] = args.server_lr
        if args.server_momentum is not None:
            kw["server_momentum"] = args.server_momentum
        models = (ResNetClientGKT(num_classes=data.class_num),
                  ResNetServerGKT(num_classes=data.class_num))
        if mesh is not None:
            if args.streaming or args.cohort_chunk or args.local_dtype:
                log.warning("fedgkt mesh engine ignores --streaming/"
                            "--cohort_chunk/--local_dtype (GKT is "
                            "full-participation resident)")
            return MeshFedGKTEngine(*models, data, cfg, mesh=mesh, **kw)
        return FedGKTEngine(*models, data, cfg, **kw)

    if algo == "splitnn":
        from fedml_tpu_torch.algorithms.split_nn import SplitNNEngine
        from fedml_tpu_torch.models.split import split_cnn, split_mlp
        is_img = np.ndim(data.client_shards["x"]) >= 5
        cm, sm = (split_cnn(data.class_num) if is_img
                  else split_mlp(data.class_num))
        return SplitNNEngine(cm, sm, data, cfg, device=dev)

    if algo == "vfl":
        from fedml_tpu_torch.algorithms.vertical_fl import VFLEngine
        from fedml_tpu_torch.data import load_vfl_data
        x, y, splits = load_vfl_data(
            cfg.dataset if cfg.dataset in ("nus_wide", "lending_club")
            else "lending_club", data_dir=cfg.data_dir)
        eng = VFLEngine(splits, cfg, device=dev)
        eng._vfl_data = (x, y)          # consumed by main()
        return eng

    raise ValueError(f"unknown algorithm {algo!r}")


def _evaluate_log(trainer, variables: dict, data, logger, extra: dict,
                  device) -> None:
    """Evaluate `variables` on the global test split and log the run's
    one summary line."""
    sums = trainer.evaluate(trainer.flatten(variables), {
        k: torch.as_tensor(np.asarray(v)).to(device)
        for k, v in data.test_global.items()})
    cnt = max(float(sums["count"]), 1.0)
    logger.log({"test_acc": float(sums["correct"]) / cnt,
                "test_loss": float(sums["loss_sum"]) / cnt, **extra})


def _run_secure(args, cfg: FedConfig, logger) -> int:
    """--secure_agg: a messaging FSM with the pairwise-mask data plane
    (secure/).  Secure mode exists only on the live engines (the sync
    messaging FSM and the async lifecycle server): the dispatch-wave
    engine has no per-client wire to mask.  `--async --secure_agg` keeps
    the lifecycle simulator but forces the cohort barrier: masks cancel
    only over the whole cohort."""
    from fedml_tpu_torch.utils.device import resolve_device
    sec = _secure_config(args)
    if (args.defense_screen or args.defense_norm_bound is not None
            or args.defense_buckets > 1 or args.defense_trim_k > 0
            or args.defense_combine != "trimmed_mean"):
        log.warning(
            "--defense_screen/--defense_norm_bound/--defense_buckets/"
            "--defense_trim_k/--defense_combine are blinded under "
            "--secure_agg: the server only ever sees masked field words, "
            "so plaintext admission screening cannot run.  The surviving "
            "enforcement is the client-side quantizer range refusal")
    device = resolve_device(args.device)
    data = _load(cfg)
    trainer = _trainer(cfg, data)
    if getattr(args, "async_mode", False):
        if args.async_buffer_k is not None:
            log.warning("--async_buffer_k is ignored under --secure_agg "
                        "(the masked fold is a cohort barrier: buffer_k == "
                        "cohort)")
        from fedml_tpu_torch.async_.lifecycle import run_async_messaging
        variables, server = run_async_messaging(
            trainer, data, cfg,
            buffer_k=cfg.client_num_per_round,
            worker_num=cfg.client_num_per_round,
            total_commits=cfg.comm_round,
            deadline_s=args.async_round_deadline_s,
            mix=args.async_mix,
            lifecycle_cfg=_lifecycle_config(args, cfg),
            secure=sec, device=device)
        extra = {"rounds": server.version,
                 "secure_below_threshold": server.secure_below_threshold,
                 **{f"secagg_{k}": v
                    for k, v in server._secure.report().items()}}
    else:
        from fedml_tpu_torch.comm.fedavg_messaging import (
            run_messaging_fedavg)
        variables = run_messaging_fedavg(
            trainer, data, cfg, worker_num=cfg.client_num_per_round,
            secure=sec, device=device)
        extra = {"rounds": cfg.comm_round}
    _evaluate_log(trainer, variables, data, logger, extra, device)
    return 0


def _run_deployment(args, cfg: FedConfig, logger) -> int:
    """One deployment rank over real sockets (reference run_fedavg_grpc.sh
    / run_fedavg_trpc.sh: N OS processes, rank 0 the server).  Both roles
    load the dataset (clients need shards, the server the init model and
    the eval split); the model exchange runs the fedavg_messaging FSM."""
    from fedml_tpu_torch.comm.fedavg_messaging import (FedAvgAggregator,
                                                       FedAvgClientManager,
                                                       FedAvgServerManager)
    from fedml_tpu_torch.utils.context import graceful_abort
    from fedml_tpu_torch.utils.device import resolve_device

    # rank-prefixed logs, one process per rank (reference
    # main_fedavg.py:415-420 logger format)
    for h in logging.getLogger().handlers:
        h.setFormatter(logging.Formatter(
            f"[rank {args.rank}] %(asctime)s %(name)s "
            "%(levelname)s %(message)s"))
    device = resolve_device(args.device)
    data = _load(cfg)
    trainer = _trainer(cfg, data)
    size = args.world_size
    if args.deploy == "client" and not 1 <= args.rank < size:
        raise SystemExit(
            f"--deploy client needs --rank in [1, {size - 1}] "
            f"(rank 0 is the server); got {args.rank}")
    ip_config = {r: "127.0.0.1" for r in range(size)}
    kw = dict(ip_config=ip_config, base_port=args.base_port)
    if args.comm_backend in ("TCP", "NATIVE_TCP"):
        # the transport and its overload-safety knobs are deployment
        # flags: a flash crowd is survived by configuration
        from fedml_tpu_torch.comm.reactor import ReactorConfig
        kw["reactor"] = args.tcp_transport == "reactor"
        kw["reactor_config"] = ReactorConfig(
            reactors=args.conn_reactors,
            max_connections=args.conn_max,
            stall_timeout_s=args.conn_stall_timeout_s,
            max_frames_per_sec=args.conn_max_frames_per_sec,
            max_bytes_per_sec=args.conn_max_bytes_per_sec)

    def _harden(manager) -> None:
        """Opt this rank's transport into the reliability envelope and/or
        install the seeded fault injector: robustness scenarios are a
        flag, not a code edit."""
        if args.reliable:
            manager.com_manager.enable_reliability()
        rates = {k: getattr(args, f"chaos_{k}")
                 for k in ("drop", "dup", "corrupt", "delay")}
        if any(v > 0.0 for v in rates.values()):
            from fedml_tpu_torch.comm.chaos import ChaosConfig, ChaosPolicy
            manager.com_manager.install_chaos(
                ChaosPolicy(ChaosConfig(seed=args.chaos_seed, **rates)))

    def _init_vars():
        return trainer.init(torch.Generator().manual_seed(cfg.seed), device)

    # deployed secure mode: every rank rebuilds the SAME SecureAggregator
    # from --secure_seed (keyring and escrow are deterministic)
    secagg = None
    sec_cfg = _secure_config(args)
    if sec_cfg is not None:
        from fedml_tpu_torch.async_.staleness import flat_dim
        from fedml_tpu_torch.secure import SecureAggregator
        secagg = SecureAggregator(sec_cfg, range(1, size),
                                  flat_dim(_init_vars()), device=device)

    if args.deploy == "server":
        agg = FedAvgAggregator(_init_vars(), size - 1,
                               cfg.client_num_in_total, size - 1,
                               secure=secagg, device=device)
        server = FedAvgServerManager(
            agg, cfg.comm_round, 0, size, args.comm_backend,
            model_transport=(None if args.wire_transport == "none"
                             else args.wire_transport),
            wire_compress=args.wire_compress, **kw)
        _harden(server)
        with graceful_abort(server):
            server.run_async()
            server.send_init_msg()
            if not server.done.wait(timeout=600):
                raise TimeoutError(
                    "deployment server: rounds did not finish")
        server.finish()
        _evaluate_log(trainer, agg.variables, data, logger,
                      {"rounds": server.round_idx}, device)
        return 0

    client = FedAvgClientManager(trainer, data, cfg.epochs, args.rank, size,
                                 args.comm_backend,
                                 total_rounds=cfg.comm_round,
                                 wire_compress=args.wire_compress,
                                 secure=secagg, device=device,
                                 seed=cfg.seed, **kw)
    _harden(client)
    with graceful_abort(client):
        client.run()        # blocks until total_rounds uploads are done
    return 0


def _notify_sweep(args) -> None:
    """wandb-sweep coordination (reference fedavg/utils.py:19-27): agents
    block on a named pipe until the run reports completion.  Called from
    every run mode's exit path."""
    pipe = os.environ.get("FEDML_SWEEP_PIPE")
    if pipe:
        from fedml_tpu_torch.utils.context import (
            post_complete_message_to_sweep_process)
        post_complete_message_to_sweep_process(vars(args), pipe_path=pipe)


def _strip_arg(argv: list[str], flag: str) -> list[str]:
    """Remove `flag` (and its value, both `--f N` and `--f=N` forms) from
    an argv copy: the multihost self-spawn must not recurse."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == flag:
            skip = True
            continue
        if a.startswith(flag + "="):
            continue
        out.append(a)
    return out


def _run_cluster_serve_cli(args, mh_ctx) -> int:
    """One serving host of the fused cluster: bind the reactor endpoint at
    cluster_port + rank, serve live-socket uplinks into this rank's
    registry-shard lanes, fold partials across hosts at each commit
    barrier, and print the host report as one JSON line (mh_worker's
    serve_cluster contract)."""
    import hashlib
    import json

    from fedml_tpu_torch import obs
    from fedml_tpu_torch.scale.cluster import run_cluster_serve
    if args.obs_dir:
        obs.configure(args.obs_dir)
    else:
        obs.configure_from_env()
    rank, world = (0, 1) if mh_ctx is None else (mh_ctx.rank,
                                                 mh_ctx.world)
    channel = None
    if world > 1:
        from fedml_tpu_torch.parallel.multihost import ElasticChannel
        knobs = {k: getattr(args, k) for k in
                 ("cluster_population", "cluster_commits",
                  "cluster_buffer_k", "cluster_row_dim",
                  "cluster_connections", "cluster_window_s")}
        digest = hashlib.md5(json.dumps(
            knobs, sort_keys=True).encode()).hexdigest()
        channel = ElasticChannel(
            mh_ctx, n_items=world, config_digest=digest,
            timeout_s=120.0, hb_interval_s=0.25,
            hb_timeout_s=args.hb_timeout_s)
    try:
        report = run_cluster_serve(
            args.cluster_population,
            commits=args.cluster_commits,
            warmup_commits=min(2, args.cluster_commits - 1),
            buffer_k=args.cluster_buffer_k,
            row_dim=args.cluster_row_dim,
            port=args.cluster_port + rank,
            partition=(rank, world), channel=channel,
            elastic=world > 1,
            n_connections=args.cluster_connections,
            ingest_pool=args.cluster_ingest_pool,
            window_deadline_s=args.cluster_window_s,
            slo_window=(rank == 0), device=args.device)
    finally:
        if channel is not None:
            channel.close()
    print(json.dumps({"rank": rank, "world": world,
                      "serve_cluster": report}, default=str), flush=True)
    return 0


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    from fedml_tpu_torch.parallel.multihost import MultihostContext
    mh_ctx = MultihostContext.from_env()
    if args.multihost_procs is not None and mh_ctx is None:
        # self-spawn harness: re-run this exact command N times wired as
        # one cluster (the children see FEDML_MH_* and take the runner
        # path below instead of spawning again)
        if args.multihost_procs < 1:
            raise SystemExit(f"--multihost_procs must be >= 1, got "
                             f"{args.multihost_procs}")
        from fedml_tpu_torch.parallel.multihost import (MultihostLaunchError,
                                                        spawn_cluster)
        child = ([sys.executable, "-m", "fedml_tpu_torch.cli"]
                 + _strip_arg(list(argv if argv is not None
                                   else sys.argv[1:]),
                              "--multihost_procs"))
        try:
            for rank, out in enumerate(spawn_cluster(
                    child, args.multihost_procs,
                    jax_distributed=args.multihost,
                    elastic=args.elastic, echo=True)):
                for line in out.splitlines():
                    print(f"[rank {rank}] {line}")
        except MultihostLaunchError as e:
            print(f"multihost launch failed: {e}", file=sys.stderr)
            return 1
        return 0
    from fedml_tpu_torch.utils.device import resolve_device
    # the card unless --device names another: no card and no --device
    # raises here, before any work
    resolve_device(args.device)
    if args.cluster_serve:
        # the fused serving cluster: no FedConfig, no training engines;
        # this process is one serving host
        return _run_cluster_serve_cli(args, mh_ctx)
    if args.batch_unroll is not None and args.batch_unroll < 1:
        # here, not in build_engine: the --deploy path builds its trainer
        # without build_engine and must get the same clean error
        raise SystemExit(
            f"--batch_unroll must be >= 1, got {args.batch_unroll}")
    cfg = FedConfig.from_args(args)
    cfg.ci = bool(args.ci)
    from fedml_tpu_torch import obs
    if args.obs_dir:
        obs_dir = args.obs_dir
        if mh_ctx is not None and mh_ctx.world > 1:
            # one obs dir per rank: co-launched processes handed one dir
            # race each other's exports; a rejoining incarnation reuses
            # its rank id, so it is namespaced by pid too
            sub = f"rank{mh_ctx.rank}"
            if os.environ.get("FEDML_MH_REJOIN") == "1":
                sub = f"rank{mh_ctx.rank}-pid{os.getpid()}"
            obs_dir = os.path.join(obs_dir, sub)
        obs.configure(obs_dir)
    else:
        obs.configure_from_env()
    if args.obs_http_port is not None:
        port = obs.serve_http(args.obs_http_port).port
        log.info("obs introspection endpoint on http://127.0.0.1:%d "
                 "(/metrics /rollup /healthz /slo /cluster /flight)", port)
    slo_engine = None
    if args.slo:
        if args.slo_period_s <= 0:
            raise SystemExit(
                f"--slo_period_s must be > 0, got {args.slo_period_s}")
        from fedml_tpu_torch.obs import slo as slo_mod
        specs = slo_mod.default_slo_pack()
        if mh_ctx is not None and mh_ctx.rank == 0 and mh_ctx.world > 1:
            # the coordinator judges the cluster too: its folded registry
            # carries every rank's series
            from fedml_tpu_torch.obs import cluster as cluster_mod
            specs = specs + cluster_mod.cluster_slo_pack()
        slo_engine = slo_mod.SloEngine(specs).start(args.slo_period_s)
    if mh_ctx is not None and mh_ctx.jax_coordinator:
        # the launcher's rendezvous (--jax-distributed): every launched
        # rank joins torch.distributed's gloo group before any engine
        from fedml_tpu_torch.parallel.multihost import init_multihost
        init_multihost(coordinator_address=mh_ctx.jax_coordinator,
                       num_processes=mh_ctx.world,
                       process_id=mh_ctx.rank, required=True)
    elif args.multihost:
        from fedml_tpu_torch.parallel.multihost import init_multihost
        init_multihost(required=True)

    from fedml_tpu_torch.utils.metrics import RunLogger
    logger = RunLogger(root=args.run_dir, project="fedml_tpu_torch",
                       name=args.run_name, config=vars(args))

    def _finish():
        logger.finish()
        # explicit export (atexit also fires, but in-process callers want
        # the artifacts before main() returns)
        if slo_engine is not None:
            # one final window, so a breach in the run's tail still lands
            # in the exported counters
            slo_engine.stop(final_evaluate=True)
        if obs.enabled():
            obs.export()
        _notify_sweep(args)

    if args.deploy:
        rc = _run_deployment(args, cfg, logger)
        _finish()
        return rc
    if args.secure_agg:
        rc = _run_secure(args, cfg, logger)
        _finish()
        return rc
    ckpt = None
    if args.ckpt_dir:
        from fedml_tpu_torch.utils.checkpoint import FedCheckpointManager
        ckpt = FedCheckpointManager(args.ckpt_dir)

    if args.algorithm == "vfl":
        eng = build_engine(args, cfg, None)
        x, y = eng._vfl_data
        params = eng.fit(x, y, epochs=cfg.comm_round)
        logger.log({"train_acc": eng.score(params, x, y)})
        _finish()
        return 0

    # uint8 cohort storage starts at the LOADER when the engine dequantizes
    # on the device: the stack never takes the f32 detour through host
    # memory.  The gate mirrors build_engine's --stack_dtype check
    store_u8 = (args.stack_dtype == "uint8" and args.mesh
                and args.algorithm in _STACK_DTYPE_ALGOS)
    data = _load(cfg, store_uint8=store_u8)
    eng = build_engine(args, cfg, data)

    import inspect
    mh_runner = None
    if mh_ctx is not None or args.agg_blocks is not None or args.elastic:
        from fedml_tpu_torch.parallel.multihost import (ElasticRunner,
                                                        MultihostRunner)
        if not args.mesh:
            raise SystemExit(
                "multihost execution drives the mesh engines: add --mesh")
        if ckpt is not None:
            log.warning("--ckpt_dir is ignored under multihost execution "
                        "(the two-level runner does not checkpoint)")
        if args.elastic:
            # elastic membership: view changes and block re-adoption on a
            # rank's death, rejoin on respawn; fail-fast is the default
            mh_runner = ElasticRunner(
                eng, mh_ctx, n_blocks=args.agg_blocks,
                hb_timeout_s=args.hb_timeout_s,
                carry_codec=args.carry_codec,
                overlap_exchange=args.overlap_exchange)
        else:
            mh_runner = MultihostRunner(
                eng, mh_ctx, n_blocks=args.agg_blocks,
                carry_codec=args.carry_codec,
                overlap_exchange=args.overlap_exchange)

    run_params = inspect.signature(eng.run).parameters
    engine_logs = "logger" in run_params

    def _run():
        if mh_runner is not None:
            try:
                mh_runner.run(logger=logger)
            finally:
                mh_runner.close()
            return
        kw = {}
        if engine_logs:
            kw = dict(logger=logger, ckpt=ckpt,
                      ckpt_every=args.ckpt_every, resume=args.resume)
        eng.run(**kw)

    if args.profile_dir:
        from fedml_tpu_torch.utils.profiling import trace
        with trace(args.profile_dir):
            _run()
    else:
        _run()

    # engines that took the logger already logged each evaluated round
    if eng.metrics_history and not (engine_logs or mh_runner is not None):
        logger.log(eng.metrics_history[-1])
    _finish()
    return 0


def entry() -> None:
    """Console-script entry (`fedml-tpu-torch ...`, pyproject
    [project.scripts])."""
    sys.exit(main())


if __name__ == "__main__":
    entry()
