#!/usr/bin/env python3
"""Drive the PyTorch port's FedAvg, robust-aggregation, model-zoo,
data-layer, one-card-algorithm, FedNAS, message-driven FedAvg, async,
two-level multi-process and elastic paths on one CUDA card (message-driven FedAvg
also under injected faults and over MQTT, with program timing and the
observatory), and hold every
hand-written kernel against its plain PyTorch version.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order (any failed check raises, so the exit code is non-zero):

1. the card: name and power limit, as nvidia-smi prints them;
2. the build: the CUDA kernels under fedml_tpu_torch/csrc are compiled
   for sm_90a into fedml_tpu_torch/_build (or the build is reused), and
   the native transport with g++; the build counters (kernel_build_total)
   count exactly the libraries built;
3. each kernel against its plain version at the main paths' shapes, with
   its time, the plain version's time, one library call's time as a
   yardstick, and its bound from the bytes it must move.  GroupNorm runs
   with bf16 x and bf16 gamma/beta as the main path holds them, and also
   in the other three pairings of bf16 and f32; its kernels and the
   squared-distance kernel must give bitwise the same outputs on a second
   launch; one GroupNorm layer's forward and backward must issue exactly
   the two GroupNorm kernels and no other device work, and its device
   time is printed per stage shape; the streaming variant of the
   GroupNorm kernels is checked at a shape too large to hold on the chip;
4. one f32 FedAvg round (2 clients x 2 batches of 32, full ResNet-18-GN
   width, TF32 off) on the card and on the CPU from the same weights and
   data: the aggregated models must agree;
5. the main path: MeshFedAvgEngine(chunk=2, local_dtype=bfloat16) with a
   bf16 ClientTrainer at lr 0.1, 8 clients of 390 CIFAR-10-shaped
   samples (13 batches of 32), 3 rounds then one evaluation; the launch
   counters, zeroed just before, must equal the counts the shapes give;
   then a round of one chunk's 2 clients under torch.profiler: the
   card's busy share and where its time goes;
6. one f32 norm-clipped FedAvgRobustEngine round (3 clients x 2 batches
   of 32, full width, TF32 off) on the card and on the CPU, with the bound
   set so that some clients are clipped and some are not; then the
   distance taken apart: the card's squared-distance and clipped-fold
   kernels on the CPU's trained rows against f64, FedAvg's round on the
   same clients card against CPU, and each client's trained row;
7. MeshRobustEngine's order-statistic defenses (krum, multi-krum, median,
   trimmed mean): one f32 round each, 4 clients x 1 batch of 32, on the
   card and on the CPU;
8. the robust main path: MeshRobustEngine(norm_clip, chunk=2, bf16 local
   masters) on phase 5's clients, 3 rounds then one evaluation, with
   exact launch counts (the squared-distance and clipped-fold kernels,
   no weighted fold);
9. one bf16 round each of MeshFedOptEngine, MeshFedProxEngine and
   MeshFedNovaEngine at 4 clients, full width, with their launch counts;
10. the model zoo (slice 3a): every family of create_model at its
   published width, one f32 FedAvg round on the card and on the CPU
   (TF32 off), or, for the two models with fixed dropout rates, one
   batch's logits and gradients in eval mode; each family's update
   distance against its limit;
11. the ResNet-56 path: MeshFedAvgEngine with the main path's recipe on
   ResNet-56 (BatchNorm statistics in the row), 2 rounds then one
   evaluation, the fold's launches exact, the fold against its plain
   version at the row's [2, 860,160], the global statistics against the
   plain weighted mean of the clients', and a profiled round of 2
   clients: busy share and device time by kind (convolutions, BatchNorm,
   copies, other);
12. a word-LSTM round on MeshFedAvgEngine at full width, with the
   sequence axis and <pad> left out of the eval;
13. the data layer (slice 3b), from CIFAR-10 pickles written into a
   temporary directory: load_data(store_uint8=True) against the written
   pixels and the f32 loader, the augmentation's draws and transforms on
   the card against the CPU, one f32 round from the uint8 stack against
   the CPU, then the main path fed by the loader (stack_dtype=uint8,
   augmentation on; 3 rounds and one evaluation, exact launch counts) and
   one uint8 norm-clip round, and the cohort's upload in uint8 and f32;
14. slice 7a-i, the one-card algorithms beyond FedAvg: both GroupNorm
   kernels against their plain versions at FedGKT's stage shapes (2
   groups, 8-32 channels a group) and FedSeg's (4 groups), f32 and bf16,
   with their launch plans and f32 times beside their bounds; one f32
   round (or epoch) of every new engine on the card and on the CPU from
   the same weights (TurboAggregate, hierarchical, centralized, DSGD,
   push-sum, vertical FL, SplitNN, FedSeg with its metrics, FedGKT with
   its server logits, FedGAN given the same z), within phase 4's limits
   and with exact launch counts; the slice's path, FedGKT at the full
   width of its pair on phase 5's clients (2 rounds, one evaluation, exact
   GroupNorm launches, each phase's share of the round, a profiled
   round of 1 client); and FedSeg at full width on the pascal_voc stand-in (2 rounds,
   its last evaluation's metrics, exact launches);
15. slice 7a-ii, FedNAS with the DARTS search space, and the obs core:
   both GroupNorm kernels at the DARTS nets' eight (C, G) shapes (the
   supernet's 8 groups of 2-8 channels, the retrain net's odd widths 9
   and 27) in f32 and bf16, with plans, times and bounds; the second
   derivative through one GroupNorm layer (kernels and the analytic
   double backward) against the plain version's autograd on the card and
   against the CPU; the second-order correction g2 - g1 of one
   micro-space architecture gradient, card against CPU, relative to its
   own norm; one f32 round of each search mode (first order, exact second
   order, GDAS) in the micro space and at full width, card against CPU
   with exact launches; the slice's path, FedNAS at the published DARTS
   widths (1 first-order round, 1 second-order on 1 client, 1 GDAS, each
   with an evaluation, the derived genotype, then its retrain at C 36 and 20
   layers for one FedAvg round), with exact launches, s/round by mode and
   a profiled first-order step; and one main-path round with
   observability off and on, bitwise equal, its trace holding the round,
   eval and upload spans;
16. slice 5b-i, the wire core and message-driven FedAvg: the codec on
   ResNet-18-GN's variables taken from the card in f32 and bf16 (v1
   bitwise, decode_into equal to decode, the bf16 transport equal to the
   card's .to(bfloat16), int8 within half an affine step, sparse_topk
   keeping exactly each leaf's k largest entries, encode_parts joining to
   encode; bytes and MB/s); run_messaging_fedavg on the main path's
   recipe (8 client threads, bf16 masters) for 1 round over INPROC, TCP
   (the Python reactor) and NATIVE_TCP, each with exact GroupNorm and fold
   launches, s/round beside FedAvgEngine on the same clients, wire bytes
   and the shares of the fsm.local_train, comm.decode and fsm.aggregate
   spans; one round with the bf16 downlink (half the bytes, within phase
   4's limits of the exact round); one f32 round over TCP against one
   FedAvgEngine round (within 1e-6 of the update's norm); remote SplitNN
   (split_cnn, 2 clients, one epoch of 4 batches) on the card over
   INPROC and TCP, twice each with cuDNN's deterministic algorithms,
   against the same protocol on the CPU (ROADMAP C.11);
17. slice 5b-ii: one f32 round of message-driven FedAvg at full width
   over TCP on threads, clean and then with every rank hardened
   (reliability envelope, a seeded chaos policy dropping, duplicating,
   reordering, delaying and corrupting frames): bitwise equal, the same
   launches, every fault kind injected; each run traced, its critical
   path finding the one round, the default SLO pack judging it; the
   main path's MeshFedAvgEngine and FedAvgEngine on 2 clients, one round
   each under the FLOP census, through the bare round function with
   observability off and through the instrumented one with observability
   on: bitwise equal, one dispatch a family, stream seconds from CUDA
   events positive and within the host wall + 1 ms, no build after
   phase 2;
   FedML's edge leg, messaging FedAvg over MQTT through the in-repo
   broker (LR on the mnist stand-in, 8 clients, 2 rounds, then one with
   FMLZ), bitwise equal to INPROC, one fold a round;
18. slice 4a, the async server: AsyncFedAvgEngine on the main path's
   recipe (8 clients, K = 4, polynomial staleness, seeded latencies,
   crashes and rejoins) for 4 commits with exact launches, s/commit and
   one profiled 2-client commit's busy share; the degenerate f32 config
   bitwise FedAvgEngine; the streaming commit bitwise the drained one on
   the card (every staleness mode, full and partial) and the arrival and
   screened folds timed beside their bounds; one f32 commit card against
   CPU; the attacked, defended scheduler (exact squared-distance and
   clipped-fold launches, quarantines by reason) and NaN/±inf rows that
   change no accumulator bit; run_async_messaging over INPROC (4 client
   threads, 3 commits, launches exact) and one secure round at full
   width whose masked field sum, folded on the card, is the plain
   fixed-point sum word for word;
19. slice 4b and the one-card part of slice 6: the main path
   block-streamed (MeshFedAvgEngine(stream_block=2), one round with the
   upload prefetch and one without, both bitwise the streaming round
   under cuDNN's deterministic algorithms, wsum and GroupNorm launches
   exact, at most two blocks of the cohort resident, peak device memory
   and the transfer overlap printed) and a norm_clip block round
   (launches exact; in f32 card against CPU within phase 4's limits); the
   two-phase order statistics (median bitwise the resident round, krum
   selecting the resident round's client, the pinned host matrix's
   bytes); checkpoint and resume at phase 16's f32 shape (FedAvgEngine 2
   + 1 resumed rounds bitwise 3 straight ones, the async scheduler's
   saved state restored bitwise, the async server's crash-resume over
   INPROC); the serve spine at bench.py's serve settings cut to 8 commits
   (one fold launch an arrival, registry bytes/client within the gate,
   the trace bitwise a CPU run's); the ingest torture over TCP at
   ResNet-18-GN's flat width, plain and defended (launches exact), and
   one secure messaging round at full width (the field sum bitwise the
   plain fixed-point sum); the connection torture at 256 connections
   (FD delta 0);
20. slice 6a, the two-level multi-process runtime, in real processes
   sharing this one card through the port's launcher (the script starts
   itself as each rank, ``chip_smoke.py --rank20 CONFIG``): the main path
   at 4 batches a client (MH_BATCHES, as 22a and 24a) through
   MultihostRunner (2 blocks of 4 clients, 2 rounds an arm) at 1
   rank and at 2 ranks, streaming and resident, the f32 exchange serial
   and overlapped, then norm_clip with weak-DP noise; every FedAvg arm
   commits one digest, norm_clip another, launches exact per rank, each
   arm's s/round, exchange wall, carry bytes and overlap fraction; one f32
   two-level round card against CPU within phase 4's limits; the LR
   mh_worker with int8_ef and topk_ef, 2 ranks bitwise 1, and a rank
   killed after round 0, which rank 0's DeadRankError and the launcher
   must both name;
21. slice 6b, the elastic tier, in real processes sharing this card
   through ``python -m fedml_tpu_torch.parallel.launch --elastic
   [--respawn]`` (the script starts itself as each rank, ``chip_smoke.py
   --rank21 CONFIG``): the main path through ElasticRunner (4 blocks of 2
   clients, so 3 ranks own 2, 1 and 1), clean at 1 rank and at 3 ranks
   (streaming and resident), a hang arm (a rank's heartbeats stop; the
   coordinator evicts it and the survivors re-adopt its block), and kill
   arms for FedAvg and for norm_clip with its weak-DP noise (rank 1 exits
   abruptly after round 0, is respawned once and rejoins through the
   snapshot); every FedAvg run of every reporting incarnation commits the
   clean 1-rank digest, norm_clip its own, the clean runs read 0 view
   changes, launches exact for every incarnation from the blocks it
   computed; s/round, view-change latency, re-adoption seconds, boot and
   peak device memory per rank; then run_serve_sim at partition=(r, 2) in
   two processes (equal to two threads of this process) and its elastic
   variant with a crash, the serve_cluster route of the port's mh_worker
   at 2 ranks fed live frames from here, and the socket-fed lane at world
   1 against the synthetic serve simulation, one wsum launch an admitted
   row;
22. slice 6c-i, the client-axis mesh across ranks, in real processes
   sharing this card through ``python -m fedml_tpu_torch.parallel.launch
   --jax-distributed -- python -m fedml_tpu_torch.parallel.mesh_worker``
   (each rank joins torch.distributed's gloo group; the floats cross
   ranks through the host and fold in rank order): 22a at 2 ranks, the
   main path at MH_BATCHES through MeshFedAvgEngine(mesh=make_mesh(2))
   (2 rounds, streaming) and norm_clip with weak-DP noise (2 rounds), whose digests
   are phase 20's 1-rank two-block digests, and one median round bitwise
   this process's one-card round; a mesh of one
   rank bitwise the one-card engine here; 22b at 8 clients of 4 batches:
   MeshHierarchicalEngine on 2 x 2 (4 ranks, one digest) within f32
   tolerance of the flat mesh round of 4, and MeshGossipEngine's ring of
   2 bitwise the ring of one; launches exact per rank, s/round, the
   gathers' walls and bytes and peak device memory per rank;
23. slice 6c-ii, the batch axis across ranks, in one cluster of 4 ranks
   sharing this card (the mesh worker through the launcher; 2-rank arms
   on disjoint sub-meshes at the same time): 23a the main path on
   make_mesh_batch(1, 2) (each step's 32 samples split 16 a rank, one
   host fold of the gradient a step), its launches the one-device
   round's, one digest, an f32 arm within phase 4's limits of the
   one-device round, and both GroupNorm kernels at N = 16; 23b norm_clip
   on make_mesh_batch(2, 2); 23c stream_block over 2 ranks against the
   streaming round and itself, and checkpoint/resume over 2 ranks bitwise
   the uninterrupted run; 23d the FedGKT, FedSeg, FedGAN and FedNAS mesh
   variants and the data-parallel CentralizedTrainer (ResNet-56 with
   BatchNorm folded over the ranks) against their one-device runs here;
24. slices 6c-iii and 7b: 24a the main path through MultihostRunner
   with two ranks behind each host-channel member (``chip_smoke.py
   --rank24 CONFIG`` through the port's launcher; each member's first
   rank starts its second; MH_BATCHES), 1 member x 2 ranks and 2
   members x 2 ranks (4 processes on this card), FedAvg and norm_clip with weak-DP noise, 2
   rounds of 2 blocks of 4 clients: one digest an algorithm over every
   rank of both runs, launches exact per rank (the member's first rank
   evaluating), the committed models within LG_TOL of phase 20's 1-rank
   two-block run (a block's lanes fold in another order); 24b the CLI
   in process (``fedml_tpu_torch.cli.main``) on the main path's model at
   full width, bf16, ``--mesh --streaming --cohort_chunk 2``, 4 clients
   of 4 batches, 2 rounds: its summary has test_acc, its final model
   (from its checkpoint) is bitwise the engine built by hand from the
   same recipe, launches exact, then ``--algorithm fedavg_robust
   --defense norm_clip``; 24c the CLI's own cluster (``--multihost_procs
   2 --mesh --agg_blocks 2``) and the one-process ``--mesh --agg_blocks
   2`` log the same summary;
25. one JSON line of the zoo's, C.1's, the data path's and slices 7a-i's,
   7a-ii's, 5b-i's, 5b-ii's, 4a's, 4b's, 6a's, 6b's, 6c-i's, 6c-ii's,
   6c-iii's and 7b's numbers, one listing every TPU kernel of the JAX
   package with its port's numbers and its launches on every path, then
   the last line {"ok": true, "device": {...}}.

It needs one card; it imports nothing of JAX or of fedml_tpu.
``python3 chip_smoke.py --phase 19`` (or ``--phase 20`` ... ``--phase
24``) builds the kernels and runs that phase alone (a quicker check of
that slice; it prints no kernel line).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import pickle
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import zlib
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from fedml_tpu_torch import native, obs
from fedml_tpu_torch.algorithms import (DecentralizedGossipEngine,
                                        HierarchicalFedAvgEngine)
from fedml_tpu_torch.algorithms.centralized import CentralizedTrainer
from fedml_tpu_torch.algorithms.fedavg import FedAvgEngine
from fedml_tpu_torch.algorithms.fedavg_robust import FedAvgRobustEngine
from fedml_tpu_torch.algorithms.fedgan import FedGANEngine
from fedml_tpu_torch.algorithms.fedgkt import FedGKTEngine
from fedml_tpu_torch.algorithms.fednas import (FedNASSearchEngine,
                                               make_train_engine)
from fedml_tpu_torch.algorithms.fedseg import FedSegEngine
from fedml_tpu_torch.algorithms.split_nn import SplitNNEngine
from fedml_tpu_torch.algorithms.turboaggregate import TurboAggregateEngine
from fedml_tpu_torch.algorithms.vertical_fl import VFLEngine
from fedml_tpu_torch.async_ import (STALENESS_MODES, AsyncBuffer,
                                    AsyncClientManager, AsyncFedAvgEngine,
                                    AsyncServerManager, AttackConfig,
                                    DefenseConfig, LifecycleConfig,
                                    UpdateAdmission, make_drain_fold_fn,
                                    make_fold_fn, make_stream_commit_fn,
                                    run_async_messaging,
                                    run_connection_torture,
                                    run_ingest_torture)
from fedml_tpu_torch.comm.chaos import ChaosConfig, ChaosPolicy
from fedml_tpu_torch.comm.fedavg_messaging import (FedAvgAggregator,
                                                   FedAvgClientManager,
                                                   FedAvgServerManager,
                                                   MyMessage,
                                                   run_messaging_fedavg)
from fedml_tpu_torch.comm.inproc import InProcRouter
from fedml_tpu_torch.comm.message import Message, MessageCodec
from fedml_tpu_torch.comm.mqtt_wire import MiniMqttBroker
from fedml_tpu_torch.comm.split_messaging import (SplitClientCompute,
                                                  SplitNNClientManager,
                                                  SplitNNServerManager,
                                                  SplitServerCompute)
from fedml_tpu_torch.core import mpc
from fedml_tpu_torch.core import robust as robust_ops
from fedml_tpu_torch.core.flatmodel import FlatModel
from fedml_tpu_torch.core.partition import partition_homo
from fedml_tpu_torch.core.pytree import clip_scale
from fedml_tpu_torch.core.topology import (AsymmetricTopologyManager,
                                           SymmetricTopologyManager)
from fedml_tpu_torch.core.trainer import ClientTrainer, client_generator
from fedml_tpu_torch.data import augment
from fedml_tpu_torch.data.augment import make_augment_fn
from fedml_tpu_torch.data.federated import (FederatedData, build_client_shards,
                                            build_eval_shard)
from fedml_tpu_torch.gn_timing import (FLAX_EPS, GN_LAYERS_PER_STAGE,
                                       GN_STAGES, GROUPS, cuda_ms,
                                       device_kernels, host_ms, layer_call,
                                       stage_inputs)
from fedml_tpu_torch.data.loaders import load_data, load_vfl_data
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.gan import Discriminator, Generator
from fedml_tpu_torch.models.resnet_gkt import ResNetClientGKT, ResNetServerGKT
from fedml_tpu_torch.models.split import split_cnn
from fedml_tpu_torch.obs import programs, timeline
from fedml_tpu_torch.obs.slo import SloEngine, default_slo_pack
from fedml_tpu_torch.ops import build, launch_counts, reset_launch_counts
from fedml_tpu_torch.ops.aggregate import (clip_agg, clip_agg_plain, fold,
                                           flatten_stacked_tree, fold_plain,
                                           sqnorm, sqnorm_plain, weighted_mean,
                                           weighted_mean_flat,
                                           weighted_mean_flat_plain, wsum)
from fedml_tpu_torch.ops.groupnorm import (GroupNorm, gn_backward,
                                           gn_backward_plain, gn_forward,
                                           gn_forward_plain, group_norm,
                                           launch_plan)
from fedml_tpu_torch.parallel.engine import (MeshFedAvgEngine,
                                             fedavg_fold,
                                             MeshFedNovaEngine,
                                             MeshFedOptEngine,
                                             MeshFedProxEngine,
                                             MeshRobustEngine,
                                             chunked_weighted_train)
from fedml_tpu_torch.parallel.gossip import MeshGossipEngine
from fedml_tpu_torch.parallel.mesh import make_mesh
from fedml_tpu_torch.parallel.multihost import (DeadRankError,
                                                ElasticChannel,
                                                ElasticRunner, HostChannel,
                                                MultihostContext,
                                                MultihostRunner,
                                                join_local_group,
                                                make_local_mesh,
                                                spawn_cluster,
                                                variables_digest)
from fedml_tpu_torch.scale import ArrivalConfig, run_serve_sim
from fedml_tpu_torch.scale.cluster import (make_uplink_frame,
                                           run_cluster_serve, send_uplinks)
from fedml_tpu_torch.secure import SecAggConfig, SecureAggregator
from fedml_tpu_torch.utils.checkpoint import FedCheckpointManager
from fedml_tpu_torch.utils.config import FedConfig

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 rate outside the tensor cores
GN_STREAMING_SHAPE = (2, 224, 224, 64)   # a group too large for 8 blocks' smem
N_PARAMS = 11_173_962          # ResNet-18-GN at num_filters=64, 10 classes
P_PADDED = N_PARAMS + (-N_PARAMS) % 512
BATCH, SAMPLES, BATCHES = 32, 390, 13
MAIN_CLIENTS, MAIN_CHUNK, MAIN_ROUNDS = 8, 2, 3
R56_ROUNDS = 2                 # phase 11 (cut from 3 to hold the script's time)
R56_PROFILED = 1               # phase 11's profiled clients (cut from 2 likewise)
PROFILED_BATCHES = 4           # batches of phases 11 and 14's profiled rounds
#                                (cut from 13 to hold the script's time)
SIDE_CLIENTS = 4               # phases 7 and 9
BN_RANGE = "fedml_batch_norm"  # the profiled BatchNorm forwards' range
# the TPU kernel each port kernel replaces: (the pl.pallas_call that
# launches it, file:line; the function that reaches it and its kernel body)
TPU_KERNELS = {
    "gn_forward": ("fedml_tpu/ops/groupnorm.py:208", "_pallas_fwd -> _fwd_kernel"),
    "gn_backward": ("fedml_tpu/ops/groupnorm.py:237", "_pallas_dx -> _bwd_kernel"),
    "wsum": ("fedml_tpu/ops/aggregate.py:103", "_wmean_flat -> _wmean_kernel"),
    "sqnorm": ("fedml_tpu/ops/aggregate.py:165",
               "robust_weighted_mean_pallas -> _sqnorm_kernel"),
    "clip_agg": ("fedml_tpu/ops/aggregate.py:186",
                 "robust_weighted_mean_pallas -> _clip_agg_kernel"),
}
STILL_TO_PORT: list = []


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                rtol: float, atol_of_max: float) -> float:
    """|got - want| <= rtol * |want| + atol_of_max * max|want|, elementwise;
    returns the max abs error.  A failure is counted again on the host, so
    that its message tells a wrong result (both counts agree) from device
    memory that changed under the check (they differ)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    limit = rtol * want.abs() + atol_of_max * float(want.abs().max())
    bad = int((err > limit).sum())
    if bad or not torch.isfinite(got).all():
        g, w = got.cpu(), want.cpu()
        e = (g - w).abs()
        host_bad = int((e > rtol * w.abs() + atol_of_max * w.abs().max()).sum())
        raise AssertionError(
            f"{name}: {bad} elements outside rtol {rtol} + {atol_of_max} x "
            f"max|want| (max abs err {float(err.max()):.3e}); counted again "
            f"on the host: {host_bad} of {g.numel()} (max abs err "
            f"{float(e.max()):.3e}, {int((~torch.isfinite(g)).sum())} not "
            "finite)")
    return float(err.max())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build() -> None:
    """Build (or reuse) the kernels and the native transport, and read the
    compiler's -Xptxas -v report: every kernel entry and which of them
    spill registers.  The build counters (kernel_build_total) must count
    exactly the libraries that were not built yet."""
    t0 = time.perf_counter()
    fresh = (not (build.BUILD_DIR / f"libfedml_kernels_{build._sources()[1]}"
                  ".so").exists()) + (not native.library_built())
    path = build.build()
    build.library()
    if native.load_library() is None:
        raise AssertionError("the native transport did not build")
    BUILDS.update({n: obs.counter(n).value for n in (
        "kernel_build_total", "kernel_build_seconds_total")},
        unattributed=obs.counter("kernel_build_total",
                                 family="unattributed").value)
    if BUILDS["kernel_build_total"] != fresh or BUILDS["unattributed"] != fresh:
        raise AssertionError(f"build counters {BUILDS} != {fresh} libraries "
                             "built")
    log = path.with_suffix(".log").read_text()
    entries = log.count("Compiling entry function")
    spills, name = [], None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[-1].strip()
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if found and (int(found.group(1)) or int(found.group(2))):
            spills.append(f"{name}: {found.group(0)}")
    print(f"[build] {path.relative_to(build.PACKAGE_DIR.parent)} ready in "
          f"{time.perf_counter() - t0:.1f} s (sm_90a, nvcc), the native "
          f"transport too; {fresh} built here (kernel_build_total "
          f"{BUILDS['kernel_build_total']:.0f}, "
          f"{BUILDS['kernel_build_seconds_total']:.1f} s); ptxas: {entries} "
          f"kernel entries, {len(spills)} with register spills"
          + "".join(f"\n[build]   {s}" for s in spills))


def gn_check(x, dy, gamma, beta, tag: str,
             groups: int = GROUPS) -> tuple[float, float]:
    """The GroupNorm kernels against their plain versions on one input, and
    a second launch of each bitwise equal to the first, in `groups` groups;
    returns the max abs error of y and of dx.  Tolerances: y and dx in
    bf16 within one bf16 ulp of the plain version (rtol 2^-7) plus 2^-10
    of the largest |value|
    (the statistics' f32 sums run in another order and can move a
    rounding), in f32 within rtol 1e-5 + 1e-6 x max; mean and rstd within
    rtol 1e-4 + 1e-5 x max (f32 sums of up to 32K terms); dgamma and dbeta,
    which come out in gamma's dtype, within one bf16 ulp (rtol 2^-7) +
    1e-5 x max for bf16 gamma, and as f32 within rtol 1e-4 + 1e-5 x max
    from bf16 x or 1e-5 + 1e-6 x max from f32 x."""
    out_tol = (2 ** -7, 2 ** -10) if x.dtype == torch.bfloat16 else (1e-5, 1e-6)
    if gamma.dtype == torch.bfloat16:
        par_tol = (2 ** -7, 1e-5)
    else:
        par_tol = (1e-4, 1e-5) if x.dtype == torch.bfloat16 else (1e-5, 1e-6)
    fwd = gn_forward(x, gamma, beta, groups, FLAX_EPS)
    yp, meanp, rstdp = gn_forward_plain(x, gamma, beta, groups, FLAX_EPS)
    err_f = check_close(f"gn_fwd y {tag}", fwd[0], yp, *out_tol)
    check_close(f"gn_fwd mean {tag}", fwd[1], meanp, 1e-4, 1e-5)
    check_close(f"gn_fwd rstd {tag}", fwd[2], rstdp, 1e-4, 1e-5)
    bwd = gn_backward(x, dy, gamma, meanp, rstdp, groups)
    dxp, dgp, dbp = gn_backward_plain(x, dy, gamma, meanp, rstdp, groups)
    err_b = check_close(f"gn_bwd dx {tag}", bwd[0], dxp, *out_tol)
    check_close(f"gn_bwd dgamma {tag}", bwd[1], dgp, *par_tol)
    check_close(f"gn_bwd dbeta {tag}", bwd[2], dbp, *par_tol)
    if not bwd[1].dtype == bwd[2].dtype == gamma.dtype:
        raise AssertionError(f"gn_bwd {tag}: dgamma/dbeta in {bwd[1].dtype}, "
                             f"not gamma's {gamma.dtype}")
    again = (*gn_forward(x, gamma, beta, groups, FLAX_EPS),
             *gn_backward(x, dy, gamma, meanp, rstdp, groups))
    for name, a, b in zip(("y", "mean", "rstd", "dx", "dgamma", "dbeta"),
                          (*fwd, *bwd), again):
        if not torch.equal(a, b):
            raise AssertionError(f"gn {tag}: two launches gave other {name}")
    return err_f, err_b


def gn_layer_kernels(x, dy, gamma, beta, tag: str) -> tuple[float, list]:
    """One GroupNorm layer's forward and backward as training runs it
    (group_norm, then autograd): its device time per call, and its device
    work under the profiler, which must be exactly one launch each of the
    forward and backward kernels and nothing else.  Any other device work
    fails at once; a profile whose counts come up short (the tracer
    sometimes loses records) is taken again, at most three times."""
    layer = layer_call(group_norm, *(t.detach().clone().requires_grad_()
                                     for t in (x, gamma, beta)), dy)
    ours = ("gn_fwd_kernel", "gn_bwd_kernel")
    for _ in range(3):
        rows = device_kernels(layer)
        if any(not any(k in r["name"] for k in ours) for r in rows):
            raise AssertionError(f"one GroupNorm layer {tag} issued other "
                                 f"device work than its two kernels: {rows}")
        if (len(rows) == 2 and all(r["launches"] == 1 for r in rows)
                and all(any(k in r["name"] for r in rows) for k in ours)):
            return cuda_ms(layer), rows
        # the tracer lost some kernel records (it never adds any): again
    raise AssertionError(f"one GroupNorm layer {tag}: no profile in three "
                         f"showed one launch of each of its kernels: {rows}")


def phase_gn(gen: torch.Generator) -> tuple[dict, dict]:
    """GN forward and backward at the four stage shapes: bf16 x with bf16
    gamma/beta (the main path's layers), checked, timed, and as one layer
    under the profiler; then bf16 x with f32 gamma (timed too: the
    yardstick the first port's numbers were taken with), f32 x with f32
    and with bf16 gamma; then the streaming variant at a larger shape.
    Tolerances in gn_check."""
    fwd = {"shapes": []}
    bwd = {"shapes": []}
    for shape in GN_STAGES:
        N, H, W, C = shape
        x, dy, gamma, beta = stage_inputs(shape, gen, param_dtype=torch.float32)
        g16, b16 = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
        x32, dy32 = x.float(), dy.float()
        err_f, err_b = gn_check(x, dy, g16, b16, f"{shape} bf16 x, bf16 gamma")
        gn_check(x, dy, gamma, beta, f"{shape} bf16 x, f32 gamma")
        gn_check(x32, dy32, gamma, beta, f"{shape} f32 x, f32 gamma")
        gn_check(x32, dy32, g16, b16, f"{shape} f32 x, bf16 gamma")
        layer_ms, layer_rows = gn_layer_kernels(x, dy, g16, b16, str(shape))
        _, mean, rstd = gn_forward_plain(x, g16, b16, GROUPS, FLAX_EPS)

        # library yardsticks on the same values, in the NCHW contiguous
        # layout PyTorch's own GroupNorm kernels require
        x4 = x.permute(0, 3, 1, 2).contiguous()
        dy4 = dy.permute(0, 3, 1, 2).contiguous()
        _, lmean, lrstd = torch.ops.aten.native_group_norm(
            x4, g16, b16, N, C, H * W, GROUPS, FLAX_EPS)
        elems = x.numel()
        stats_bytes = 2 * N * GROUPS * 4
        f_bytes = 2 * elems * 2 + 2 * C * 2 + stats_bytes
        f_flops = 8 * elems             # two sums, a square, normalise, affine
        b_bytes = 3 * elems * 2 + C * 2 + stats_bytes + 2 * C * 2
        b_flops = 12 * elems
        fwd["shapes"].append(dict(
            shape=list(shape), max_abs_err=err_f,
            ms=cuda_ms(lambda: gn_forward(x, g16, b16, GROUPS, FLAX_EPS)),
            ms_f32_gamma=cuda_ms(lambda: gn_forward(x, gamma, beta, GROUPS,
                                                    FLAX_EPS)),
            host_ms=host_ms(lambda: gn_forward(x, g16, b16, GROUPS, FLAX_EPS)),
            plain_ms=cuda_ms(lambda: gn_forward_plain(x, g16, b16, GROUPS,
                                                      FLAX_EPS)),
            library_ms=cuda_ms(lambda: F.group_norm(x4, GROUPS, g16, b16,
                                                    FLAX_EPS)),
            bound=bound_ms(f_bytes, f_flops),
            layer_ms=layer_ms, layer_kernels=layer_rows))
        bwd["shapes"].append(dict(
            shape=list(shape), max_abs_err=err_b,
            ms=cuda_ms(lambda: gn_backward(x, dy, g16, mean, rstd, GROUPS)),
            ms_f32_gamma=cuda_ms(lambda: gn_backward(x, dy, gamma, mean, rstd,
                                                     GROUPS)),
            host_ms=host_ms(lambda: gn_backward(x, dy, g16, mean, rstd, GROUPS)),
            plain_ms=cuda_ms(lambda: gn_backward_plain(x, dy, g16, mean, rstd,
                                                       GROUPS)),
            library_ms=cuda_ms(lambda: torch.ops.aten.native_group_norm_backward(
                dy4, x4, lmean, lrstd, g16, N, C, H * W, GROUPS,
                [True, True, True])),
            bound=bound_ms(b_bytes, b_flops)))
    for name, rec in (("gn_forward", fwd), ("gn_backward", bwd)):
        for s in rec["shapes"]:
            print(f"[kernel] {name} {s['shape']} bf16 x, bf16 gamma, G={GROUPS}: "
                  f"max abs err {s['max_abs_err']:.3e}; {s['ms'] * 1e3:.1f} us "
                  f"on the card ({s['ms_f32_gamma'] * 1e3:.1f} us with f32 "
                  f"gamma; {s['host_ms'] * 1e3:.1f} us a call on the host), "
                  f"plain {s['plain_ms'] * 1e3:.1f} us, library "
                  f"{s['library_ms'] * 1e3:.1f} us, bound "
                  f"{s['bound'][0] * 1e3:.2f} us ({s['bound'][1]})")
    for s in fwd["shapes"]:
        print(f"[kernel] one GroupNorm layer {s['shape']} bf16, forward and "
              f"backward: {s['layer_ms'] * 1e3:.1f} us of device time, device "
              "work " + ", ".join(f"{r['name'].split('<')[0].split('::')[-1]} "
                                  f"{r['us']:.1f} us" for r in s["layer_kernels"]))
    print("[kernel] GroupNorm: bf16 and f32 x with bf16 and f32 gamma within "
          "tolerance; two launches gave bitwise equal y, mean, rstd, dx, "
          "dgamma and dbeta; one layer issued exactly its two kernels")

    shape = GN_STREAMING_SHAPE
    N, S, C = shape[0], shape[1] * shape[2], shape[3]
    for backward in (False, True):
        if launch_plan(N, S, C, GROUPS, torch.bfloat16, backward=backward).resident:
            raise AssertionError(f"{shape}: the plan holds the group on chip")
    x, dy, g16, b16 = stage_inputs(shape, gen)
    err_f, err_b = gn_check(x, dy, g16, b16, f"{shape} streaming")
    _, mean, rstd = gn_forward_plain(x, g16, b16, GROUPS, FLAX_EPS)
    streaming = dict(
        shape=list(shape), max_abs_err=[err_f, err_b],
        fwd_ms=cuda_ms(lambda: gn_forward(x, g16, b16, GROUPS, FLAX_EPS)),
        bwd_ms=cuda_ms(lambda: gn_backward(x, dy, g16, mean, rstd, GROUPS)),
        bound_ms=[bound_ms(2 * x.numel() * 2, 0)[0],
                  bound_ms(3 * x.numel() * 2, 0)[0]])
    fwd["streaming"] = bwd["streaming"] = streaming
    print(f"[kernel] GroupNorm streaming variant {list(shape)} bf16: max abs "
          f"err y {err_f:.3e}, dx {err_b:.3e}; forward "
          f"{streaming['fwd_ms'] * 1e3:.1f} us (bound "
          f"{streaming['bound_ms'][0] * 1e3:.1f}), backward "
          f"{streaming['bwd_ms'] * 1e3:.1f} us (bound "
          f"{streaming['bound_ms'][1] * 1e3:.1f}); bitwise repeats")
    return fwd, bwd


def fold_check(gen: torch.Generator, P: int) -> dict:
    """The weighted fold at a mesh chunk: a [2, P] bf16 lane matrix into an
    f32 accumulator, against its plain version, timed.  Tolerance: 1e-6
    relative to |acc| + sum_k |w_k v_k| per element (f32 sums of k + 1
    terms in another order)."""
    V = torch.randn(MAIN_CHUNK, P, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.tensor([390.0, 390.0], device="cuda")
    acc0 = torch.randn(P, generator=gen, device="cuda")
    acc, accp = acc0.clone(), acc0.clone()
    fold(acc, V, w)
    fold_plain(accp, V, w)
    scale = acc0.abs() + (w[:, None] * V.float()).abs().sum(0)
    err = float((acc - accp).abs().max())
    if not bool(((acc - accp).abs() <= 1e-6 * scale).all()):
        raise AssertionError(f"fold [{MAIN_CHUNK}, {P}]: max abs err {err:.3e} "
                             "beyond 1e-6 x scale")
    return dict(shape=[MAIN_CHUNK, P], max_abs_err=err,
                ms=cuda_ms(lambda: wsum(acc, V, w, finalize=False)),
                host_ms=host_ms(lambda: wsum(acc, V, w, finalize=False)),
                plain_ms=cuda_ms(lambda: fold_plain(acc, V, w)),
                library_ms=cuda_ms(lambda: w @ V.float()),
                bound=bound_ms(MAIN_CHUNK * P * 2 + 2 * P * 4 + MAIN_CHUNK * 4,
                               2 * MAIN_CHUNK * P))


def fold_line(tag: str, rec: dict) -> str:
    return (f"[kernel] wsum fold {rec['shape']} bf16 -> f32 acc ({tag}): max "
            f"abs err {rec['max_abs_err']:.3e}; {rec['ms'] * 1e3:.2f} us on the "
            f"card ({rec['host_ms'] * 1e3:.1f} us a call on the host), plain "
            f"{rec['plain_ms'] * 1e3:.2f} us, library (w @ V.float()) "
            f"{rec['library_ms'] * 1e3:.2f} us, bound {rec['bound'][0] * 1e3:.2f} "
            f"us ({rec['bound'][1]}) ({card_line()})")


def phase_fold(gen: torch.Generator) -> dict:
    """The weighted fold at the main path's chunk ([2, P] bf16 into an f32
    accumulator, fold_check); then the finalize form on [8, P] f32, within
    1e-6 of sum_k |w_k v_k| / sum(w)."""
    P = P_PADDED
    rec = fold_check(gen, P)
    V8 = torch.randn(8, P, generator=gen, device="cuda")
    w8 = torch.rand(8, generator=gen, device="cuda") * 400
    fin, finp = weighted_mean_flat(V8, w8), weighted_mean_flat_plain(V8, w8)
    fin_scale = (w8[:, None] * V8).abs().sum(0) / w8.sum()
    fin_err = float((fin - finp).abs().max())
    if not bool(((fin - finp).abs() <= 1e-6 * fin_scale + 1e-12).all()):
        raise AssertionError(f"finalize: max abs err {fin_err:.3e}")
    rec["finalize"] = dict(
        shape=[8, P], dtype="float32", max_abs_err=fin_err,
        ms=cuda_ms(lambda: weighted_mean_flat(V8, w8)),
        plain_ms=cuda_ms(lambda: weighted_mean_flat_plain(V8, w8)),
        library_ms=cuda_ms(lambda: (w8 @ V8) / w8.sum()),
        bound_ms=bound_ms(8 * P * 4 + P * 4 + 8 * 4, 2 * 8 * P)[0])
    f = rec["finalize"]
    print(fold_line("ResNet-18-GN main path", rec))
    print(f"[kernel] wsum finalize [8, {P}] f32: max abs err {fin_err:.3e}; "
          f"{f['ms'] * 1e3:.1f} us, plain {f['plain_ms'] * 1e3:.1f} us, library "
          f"{f['library_ms'] * 1e3:.1f} us, bound {f['bound_ms'] * 1e3:.1f} us")
    return rec


def synthetic_data(n_clients: int, per_client: int, seed: int) -> FederatedData:
    """CIFAR-10-shaped clients made as bench.py makes them: uniform images,
    uniform labels, equal shards of `per_client` samples."""
    rs = np.random.RandomState(seed)
    n = n_clients * per_client
    x = rs.rand(n, 32, 32, 3).astype(np.float32)
    y = rs.randint(0, 10, n).astype(np.int64)
    idx = {i: np.arange(i * per_client, (i + 1) * per_client)
           for i in range(n_clients)}
    ev = build_eval_shard(x[:BATCH], y[:BATCH], BATCH)
    return FederatedData(
        train_data_num=n, test_data_num=n, train_global=ev, test_global=ev,
        client_shards=build_client_shards(x, y, idx, BATCH),
        client_num_samples=np.full(n_clients, per_client, np.float32),
        test_client_shards=None, class_num=10, synthetic=True)


def update_distance(tag: str, g0: dict, g1: dict, c0: dict, c1: dict):
    """The L2 distance between the card's update (g1 - g0) and the CPU's
    (c1 - c0), relative to the CPU update's norm: (over the whole model,
    the three worst leaves).  The inits must be equal, the card's result
    finite."""
    per_leaf, diff_sq, norm_sq = {}, 0.0, 0.0
    for name in c1:
        assert torch.equal(g0[name].cpu(), c0[name]), f"{tag} {name}: inits differ"
        assert torch.isfinite(g1[name]).all(), f"{tag} {name}: non-finite on card"
        dg = g1[name].cpu().double() - g0[name].cpu().double()
        dc = c1[name].double() - c0[name].double()
        d, n = float((dg - dc).norm()) ** 2, float(dc.norm()) ** 2
        per_leaf[name] = math.sqrt(d / max(n, 1e-30))
        diff_sq, norm_sq = diff_sq + d, norm_sq + n
    worst = sorted(per_leaf.items(), key=lambda kv: -kv[1])[:3]
    return math.sqrt(diff_sq / norm_sq), worst


def f32_off() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def phase_f32_round() -> None:
    """One f32 FedAvg round on the card (kernels) and on the CPU (plain
    versions) from the same weights and data, TF32 off.  Tolerance, on the
    aggregated update (new - old): the L2 distance between the two devices'
    updates is at most 1e-3 of the update's norm over the whole model, and
    at most 1e-2 within any leaf (f32 sums in another order, and other
    convolution algorithms, through two SGD steps of 20 conv and GroupNorm
    layers: a few 1e-5 is expected; a wrong kernel moves it to O(1))."""
    f32_off()
    print("[f32 round] torch.backends.cudnn.allow_tf32 = False, "
          "torch.backends.cuda.matmul.allow_tf32 = False")
    data = synthetic_data(2, 2 * BATCH, seed=1)
    cfg = FedConfig(model="resnet18_gn", dataset="cifar10",
                    client_num_in_total=2, client_num_per_round=2, epochs=1,
                    batch_size=BATCH, lr=0.1)
    trainer = ClientTrainer(create_model("resnet18_gn", 10), lr=0.1)
    out = {}
    for device in ("cuda", "cpu"):
        engine = FedAvgEngine(trainer, data, cfg, device=device)
        v0 = engine.init_variables()
        t0 = time.perf_counter()
        v1 = engine.run(variables=dict(v0), rounds=1)
        out[device] = (v0, v1, engine.metrics_history[-1],
                       time.perf_counter() - t0)
    (g0, g1, gm, gt), (c0, c1, cm, ct) = out["cuda"], out["cpu"]
    whole, worst = update_distance("f32 round", g0, g1, c0, c1)
    print(f"[f32 round] 2 clients x 2 batches of {BATCH}, full width: card "
          f"{gt:.2f} s, CPU {ct:.2f} s; update distance {whole:.3e} of its "
          f"norm (limit 1e-3), worst leaves "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst) + " (limit 1e-2); "
          f"train_loss card {gm['train_loss']:.6f} CPU {cm['train_loss']:.6f}")
    if whole > 1e-3 or worst[0][1] > 1e-2:
        raise AssertionError("f32 round: the card's update differs from the "
                             "CPU's beyond the limits above")
    torch.backends.cudnn.allow_tf32 = True


def phase_main_path() -> dict:
    """The bench's main path on the port; returns the launch counts."""
    data = synthetic_data(MAIN_CLIENTS, SAMPLES, seed=0)
    cfg = FedConfig(model="resnet18_gn", dataset="cifar10",
                    client_num_in_total=MAIN_CLIENTS,
                    client_num_per_round=MAIN_CLIENTS, epochs=1,
                    batch_size=BATCH, lr=0.1, frequency_of_the_test=10_000)
    trainer = ClientTrainer(create_model("resnet18_gn", 10), lr=cfg.lr,
                            train_dtype=torch.bfloat16)
    engine = MeshFedAvgEngine(trainer, data, cfg, chunk=MAIN_CHUNK,
                              local_dtype=torch.bfloat16)
    variables = engine.init_variables()
    v0 = {k: v.clone() for k, v in variables.items()}
    server_state = engine.server_init(variables)
    cohort, weights = engine.stream_cohort(0)
    assert cohort["x"].shape == (MAIN_CLIENTS, BATCHES, BATCH, 32, 32, 3)
    torch.cuda.synchronize()

    reset_launch_counts()
    round_s, losses = [], []
    for _ in range(MAIN_ROUNDS):
        t0 = time.perf_counter()
        variables, server_state, m = engine.round_fn_streaming(
            variables, server_state, cohort, weights)
        losses.append(float(m["train_loss"]))      # waits for the round
        round_s.append(time.perf_counter() - t0)
    stats = engine.evaluate(variables)
    torch.cuda.synchronize()
    counts = launch_counts()

    steps = MAIN_ROUNDS * MAIN_CLIENTS * BATCHES
    eval_batches = 2                  # the train and test eval shards
    expected = {"gn_forward": 20 * (steps + eval_batches),
                "gn_backward": 20 * steps,
                "wsum": MAIN_ROUNDS * (MAIN_CLIENTS // MAIN_CHUNK),
                "sqnorm": 0, "clip_agg": 0}
    if counts != expected:
        raise AssertionError(f"launch counts {counts} != expected {expected}")
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"non-finite train loss: {losses}")
    same = [k for k in v0 if torch.equal(variables[k], v0[k])]
    if same or any(v.dtype != torch.float32 for v in variables.values()):
        raise AssertionError(f"{len(same)} of {len(v0)} global leaves "
                             f"unchanged ({same}), or the global model left f32")
    steady = statistics.mean(round_s[1:])
    print(f"[main path] MeshFedAvgEngine(chunk={MAIN_CHUNK}, local_dtype=bf16), "
          f"{MAIN_CLIENTS} clients x {BATCHES} batches of {BATCH}, "
          f"ResNet-18-GN full width ({N_PARAMS} params)")
    print(f"[main path] train_loss per round {losses}; eval {stats}")
    print(f"[main path] s/round {round_s} -> {steady:.4f} s/round over rounds "
          f"2-{MAIN_ROUNDS} ({card_line()})")
    print(f"[main path] launches {counts} == expected")
    # the busy share from a round of one chunk's clients (the same steps per
    # client; a whole round's trace takes most of a minute to read)
    sub = {k: v[:MAIN_CHUNK] for k, v in cohort.items()}
    sub_round = lambda: engine.round_fn_streaming(
        variables, server_state, sub, weights[:MAIN_CHUNK])
    sub_round()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sub_round()
    torch.cuda.synchronize()
    profile_round(sub_round, time.perf_counter() - t0,
                  tag=f"profile, {MAIN_CHUNK} clients")
    return counts


def kernel_kinds(prof) -> dict:
    """Device seconds by kind from the profiler's op tree: every kernel
    launched under a BatchNorm forward (the BN_RANGE ranges) or backward
    (its autograd node) is BatchNorm; the others go by name."""
    from torch.autograd import DeviceType
    share = {k: 0.0 for k in ("convolutions (cuDNN)", "BatchNorm",
                              "copies and casts", "port kernels (fedml)",
                              "other")}

    def kind(name: str, in_bn: bool) -> str:
        low = name.lower()
        if in_bn:
            return "BatchNorm"
        if "fedml" in low:
            return "port kernels (fedml)"
        if any(t in low for t in ("conv", "cudnn", "xmma", "gemm", "wgrad",
                                  "dgrad", "fprop", "cutlass", "sm90")):
            return "convolutions (cuDNN)"
        if any(t in low for t in ("copy", "memcpy", "memset", "catarray")):
            return "copies and casts"
        return "other"

    def visit(e, in_bn: bool) -> None:
        in_bn = in_bn or e.name == BN_RANGE or "BatchNormTrainBackward" in e.name
        for k in e.kernels:
            share[kind(k.name, in_bn)] += k.duration / 1e6
        for c in e.cpu_children:
            visit(c, in_bn)

    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.cpu_parent is None:
            visit(e, False)
    return share


def profile_round(run_round, steady_s: float, tag: str = "profile") -> dict:
    """One more round (``run_round()``) under torch.profiler, with each
    BatchNorm forward in a named range: the card's busy time (kernels,
    copies and fills, summed) against the unprofiled round's wall time,
    the device time by kind from the op tree, and the largest items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from fedml_tpu_torch.models.norms import BatchNorm
    forward = BatchNorm.forward

    def named_forward(self, x, train=False):
        with record_function(BN_RANGE):
            return forward(self, x, train)

    torch.cuda.synchronize()
    BatchNorm.forward = named_forward
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_round()
            torch.cuda.synchronize()
    finally:
        BatchNorm.forward = forward
    # the range's own device-side row is an annotation spanning its
    # kernels and the gaps between them, not device work
    rows = [(e.key, e.self_device_time_total / 1e6, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and e.key != BN_RANGE]
    if not rows:
        print(f"[{tag}] the profiler saw no device time on this card")
        return {}
    busy = sum(r[1] for r in rows)
    kinds = kernel_kinds(prof)
    rec = dict(busy_s=busy, steady_s=steady_s, busy_share=busy / steady_s,
               kinds=kinds, attributed_s=sum(kinds.values()),
               top=[dict(name=n[:120], s=t, launches=c) for n, t, c in
                    sorted(rows, key=lambda r: -r[1])[:8]])
    print(f"[{tag}] one round: device busy {busy:.4f} s of the unprofiled "
          f"{steady_s:.4f} s/round ({busy / steady_s:.1%} busy, "
          f"{1 - busy / steady_s:.1%} idle); {rec['attributed_s']:.4f} s of "
          f"it attributed by the op tree ({card_line()}):")
    for k, t in kinds.items():
        print(f"[{tag}]   {k}: {t:.4f} s "
              f"({t / max(rec['attributed_s'], 1e-12):.1%})")
    for r in rec["top"]:
        print(f"[{tag}]   {r['s'] * 1e3:9.2f} ms {r['launches']:7d}x "
              f"{r['name']}")
    return rec


def terms_scale(V: torch.Tensor, g: torch.Tensor, cf: torch.Tensor, base,
                acc0: torch.Tensor | None = None) -> torch.Tensor:
    """|acc| + |base * g| + sum_k |cf_k (v_k - g)| per element: the scale
    the clipped fold's f32 rounding is relative to."""
    s = (cf[:, None].abs() * (V.float() - g.float()).abs()).sum(0) \
        + abs(float(base)) * g.float().abs()
    return s if acc0 is None else s + acc0.abs()


def phase_robust_kernels(gen: torch.Generator) -> dict:
    """The squared-distance and clipped-fold kernels at the slice's shapes:
    a mesh chunk ([2, P] bf16 lanes, bf16 g, the accumulate form into an
    f32 carry) and FedAvgRobustEngine's cohort ([8, P] f32, the in-place
    form through an aliased buffer).  The clients sit near g, as trained
    clients do.  Tolerance: norms within rtol 1e-5 (f32 sums in another
    order); the fold within 1e-6 of the sum of |terms| per element.  Two
    squared-distance launches on one input must agree bitwise."""
    P = P_PADDED
    recs = {"sqnorm": [], "clip_agg": []}
    for k, dtype, where in ((MAIN_CHUNK, torch.bfloat16, "mesh chunk fold"),
                            (8, torch.float32, "FedAvgRobustEngine")):
        g = torch.randn(P, generator=gen, device="cuda").to(dtype)
        V = (g.float() + 0.01 * torch.randn(k, P, generator=gen, device="cuda")
             ).to(dtype)
        sq = sqnorm(V, g)
        if not torch.equal(sq, sqnorm(V, g)):
            raise AssertionError("sqnorm: two launches on one input differ")
        err_sq = check_close(f"sqnorm [{k}, P] {dtype}", sq, sqnorm_plain(V, g),
                             1e-5, 0.0)
        esz = V.element_size()
        recs["sqnorm"].append(dict(
            shape=[k, P], dtype=str(dtype).split(".")[-1], where=where,
            max_abs_err=err_sq,
            ms=cuda_ms(lambda: sqnorm(V, g)), host_ms=host_ms(lambda: sqnorm(V, g)),
            plain_ms=cuda_ms(lambda: sqnorm_plain(V, g)),
            library="torch.cdist(V.float(), g[None].float())",
            library_ms=cuda_ms(lambda: torch.cdist(V.float(), g[None].float())),
            bound=bound_ms((k + 1) * P * esz + 4 * k, 3 * k * P)))

        w = torch.rand(k, generator=gen, device="cuda") * 400 + 1
        s_clip = clip_scale(sq, float(sq.sqrt().median()))
        D = V.float() - g.float()                  # the yardstick's input
        if dtype == torch.bfloat16:                # accumulate, as the mesh
            cf, base = (w * s_clip).contiguous(), w.sum()
            acc0 = torch.randn(P, generator=gen, device="cuda")
            acc, accp = acc0.clone(), acc0.clone()
            clip_agg(acc, V, g, cf, base, accumulate=True)
            clip_agg_plain(accp, V, g, cf, base, accumulate=True)
            scale = terms_scale(V, g, cf, base, acc0)
            got, want = acc, accp
            call = lambda: clip_agg(acc, V, g, cf, base, accumulate=True)
            plain = lambda: clip_agg_plain(accp, V, g, cf, base, accumulate=True)
            library = lambda: torch.addmv(acc, D.t(), cf)
            n_bytes, form = k * P * esz + P * esz + 2 * 4 * P, "accumulate"
        else:                                      # in place into g
            cf, base = (w / w.sum() * s_clip).contiguous(), 1.0
            got, want = g.clone(), g.clone()
            clip_agg(got, V, got, cf, base, accumulate=False)
            clip_agg_plain(want, V, g, cf, base, accumulate=False)
            scale = terms_scale(V, g, cf, base)
            buf, bufp = g.clone(), g.clone()
            call = lambda: clip_agg(buf, V, buf, cf, base, accumulate=False)
            plain = lambda: clip_agg_plain(bufp, V, bufp, cf, base,
                                           accumulate=False)
            library = lambda: torch.addmv(g, D.t(), cf)
            n_bytes, form = k * P * esz + P * esz + 4 * P, "in place"
        err = float((got - want).abs().max())
        if not bool(((got - want).abs() <= 1e-6 * scale + 1e-30).all()):
            raise AssertionError(f"clip_agg {form} [{k}, P]: max abs err "
                                 f"{err:.3e} beyond 1e-6 x sum|terms|")
        recs["clip_agg"].append(dict(
            shape=[k, P], dtype=str(dtype).split(".")[-1], where=where,
            form=form, max_abs_err=err, ms=cuda_ms(call), host_ms=host_ms(call),
            plain_ms=cuda_ms(plain), library="torch.addmv(acc, (V - g).T, cf)",
            library_ms=cuda_ms(library),
            bound=bound_ms(n_bytes, 3 * k * P + 2 * P)))
        del D
    for name, rs in recs.items():
        for r in rs:
            print(f"[kernel] {name} {r.get('form', '')} {r['shape']} {r['dtype']} "
                  f"({r['where']}): max abs err {r['max_abs_err']:.3e}; "
                  f"{r['ms'] * 1e3:.1f} us on the card ({r['host_ms'] * 1e3:.1f} "
                  f"us a call on the host), plain {r['plain_ms'] * 1e3:.1f} us, "
                  f"library ({r['library']}) {r['library_ms'] * 1e3:.1f} us, "
                  f"bound {r['bound'][0] * 1e3:.1f} us ({r['bound'][1]})")
    print("[kernel] sqnorm: two launches on one input gave bitwise equal norms")
    return recs


def phase_robust_f32_round() -> dict:
    """One f32 norm-clipped FedAvgRobustEngine round on the card (kernels)
    and on the CPU (plain versions) from the same weights and data, TF32
    off.  The bound is the median of the clients' update norms, measured
    on the card first, so that the largest update is clipped and the
    smallest is not.  Limits as in the f32 FedAvg round.  Then c1_split
    takes the distance apart."""
    f32_off()
    n_clients = 3
    data = synthetic_data(n_clients, 2 * BATCH, seed=2)
    trainer = ClientTrainer(create_model("resnet18_gn", 10), lr=0.1)
    probe = FedAvgEngine(trainer, data, FedConfig(
        client_num_in_total=n_clients, client_num_per_round=n_clients,
        batch_size=BATCH, lr=0.1), device="cuda")
    flat = trainer.flatten(probe.init_variables())
    cohort, _ = data.cohort(probe.sampler.sample(0), "cuda")
    norms = [float((trainer.local_train(flat, {k: t[i] for k, t in cohort.items()},
                                        1)[0] - flat).norm())
             for i in range(n_clients)]
    tau = statistics.median(norms)
    factors = [min(1.0, tau / n) for n in norms]
    if not (min(factors) < 1.0 and max(factors) == 1.0):
        raise AssertionError(f"robust round: factors {factors} do not both "
                             "clip and pass")
    cfg = FedConfig(model="resnet18_gn", dataset="cifar10",
                    client_num_in_total=n_clients,
                    client_num_per_round=n_clients, epochs=1,
                    batch_size=BATCH, lr=0.1, norm_bound=tau)
    out, trained = {}, {}
    for device in ("cuda", "cpu"):
        engine = FedAvgRobustEngine(trainer, data, cfg, defense="norm_clip",
                                    device=device)
        aggregate = engine.aggregate

        def recording_aggregate(stacked, w, g, state, _device=device,
                                _aggregate=aggregate):
            trained[_device] = (stacked, w)
            return _aggregate(stacked, w, g, state)

        engine.aggregate = recording_aggregate
        v0 = engine.init_variables()
        t0 = time.perf_counter()
        v1, _, m = engine.round_fn(dict(v0), (), *engine._round_args(0))
        out[device] = (v0, v1, float(m["train_loss"]), time.perf_counter() - t0)
    (g0, g1, gl, gt), (c0, c1, cl, ct) = out["cuda"], out["cpu"]
    whole, worst = update_distance("robust round", g0, g1, c0, c1)
    print(f"[robust f32 round] FedAvgRobustEngine(norm_clip), {n_clients} "
          f"clients x 2 batches of {BATCH}, full width: update norms "
          f"{[round(n, 4) for n in norms]}, bound {tau:.4f}, clip factors "
          f"{[round(f, 4) for f in factors]}; card {gt:.2f} s, CPU {ct:.2f} s; "
          f"update distance {whole:.3e} of its norm (limit 1e-3), worst "
          "leaves " + ", ".join(f"{k} {v:.3e}" for k, v in worst)
          + f" (limit 1e-2); train_loss card {gl:.6f} CPU {cl:.6f}")
    if whole > 1e-3 or worst[0][1] > 1e-2:
        raise AssertionError("robust f32 round: the card's update differs "
                             "from the CPU's beyond the limits above")
    return c1_split(trainer, trained, c0, tau, whole)


def c1_split(trainer: ClientTrainer, trained: dict, v0: dict, tau: float,
             robust_distance: float) -> dict:
    """Where the f32 robust round's card-to-CPU distance comes from
    (ROADMAP C.1), from the rows phase 6's two rounds trained:

    * the aggregation alone: the CPU's trained [3, P] parameter rows through
      the card's squared-distance and clipped-fold kernels (the in-place
      form FedAvgRobustEngine uses) and through their plain f32 twins on
      the CPU, each against the same arithmetic in f64.  Limits: norms
      within rtol 1e-5, the fold within 1e-5 of the update's norm (f32 sums
      of 3 terms; storing g + u in f32 alone costs ~6e-8 of |g|);
    * FedAvg's round on the same three clients: the weighted mean of each
      device's own trained rows (what FedAvgEngine.aggregate computes),
      card against CPU, with phase 4's limits;
    * the trained rows themselves: each client's card row against its CPU
      row, relative to that client's update."""
    names = trainer.param_names
    rows = {d: flatten_stacked_tree({k: st[k] for k in names})[0].cpu()
            for d, (st, _) in trained.items()}
    w = trained["cpu"][1].float()
    g = flatten_stacked_tree({k: v0[k][None] for k in names})[0][0]
    V = rows["cpu"]
    V64, g64 = V.double(), g.double()
    sq64 = ((V64 - g64) ** 2).sum(1)
    sq_err = {"card": float(((sqnorm(V.cuda(), g.cuda()).double().cpu() - sq64)
                             .abs() / sq64).max()),
              "plain": float(((sqnorm_plain(V, g).double() - sq64).abs()
                              / sq64).max())}
    cf = (w / w.sum() * clip_scale(sq64.float(), tau)).contiguous()
    want = g64 + (cf.double()[:, None] * (V64 - g64)).sum(0)
    card = g.cuda().clone()
    clip_agg(card, V.cuda(), card, cf.cuda(), 1.0, accumulate=False)
    plain = g.clone()
    clip_agg_plain(plain, V, plain, cf, 1.0, accumulate=False)
    unorm = float((want - g64).norm())
    fold_err = {"card": float((card.cpu().double() - want).norm()) / unorm,
                "plain": float((plain.double() - want).norm()) / unorm}
    fedavg = {}
    for d, (st, wd) in trained.items():
        fedavg[d] = weighted_mean({k: t.float() for k, t in st.items()}, wd)
    fed_whole, fed_worst = update_distance(
        "C.1 FedAvg", v0, {k: v.cpu() for k, v in fedavg["cuda"].items()}, v0,
        fedavg["cpu"])
    row_dist = [float((rows["cuda"][i] - V[i]).double().norm()
                      / (V64[i] - g64).norm()) for i in range(len(V))]
    rec = dict(sqnorm_rel_err=sq_err, clip_fold_err=fold_err,
               fedavg_distance=fed_whole, fedavg_worst_leaf=fed_worst[0],
               robust_distance=robust_distance, row_distance=row_dist)
    print(f"[C.1] the CPU's trained rows [{len(V)}, {V.shape[1]}] f32 against "
          f"f64: sqnorm card {sq_err['card']:.3e}, plain {sq_err['plain']:.3e} "
          f"(relative, limit 1e-5); clipped fold in place card "
          f"{fold_err['card']:.3e}, plain {fold_err['plain']:.3e} of the "
          f"update's norm (limit 1e-5)")
    print(f"[C.1] FedAvg's round on the same 3 clients, card against CPU: "
          f"update distance {fed_whole:.3e} (limit 1e-3), worst leaf "
          f"{fed_worst[0][0]} {fed_worst[0][1]:.3e} (limit 1e-2); the "
          f"norm-clipped round {robust_distance:.3e}; each client's trained "
          f"row, card against CPU: {', '.join(f'{d:.3e}' for d in row_dist)} "
          f"of its update ({card_line()})")
    if max(sq_err.values()) > 1e-5 or max(fold_err.values()) > 1e-5:
        raise AssertionError("C.1: the aggregation kernels or their twins "
                             "stray from f64 beyond the limits above")
    if fed_whole > 1e-3 or fed_worst[0][1] > 1e-2:
        raise AssertionError("C.1: FedAvg's card round differs from the "
                             "CPU's beyond phase 4's limits")
    return rec


def phase_orderstat() -> None:
    """MeshRobustEngine's order-statistic defenses, one f32 round each on
    the card and on the CPU, 4 clients x 1 batch of 32, full width, TF32
    off; limits as in the f32 FedAvg round.  Where krum or multi-krum picks
    another client on the card, both score vectors are printed, and the
    phase fails only if they differ by more than 1e-4 relative."""
    f32_off()
    data = synthetic_data(SIDE_CLIENTS, BATCH, seed=3)
    cfg = FedConfig(model="resnet18_gn", dataset="cifar10",
                    client_num_in_total=SIDE_CLIENTS,
                    client_num_per_round=SIDE_CLIENTS, epochs=1,
                    batch_size=BATCH, lr=0.1)
    trainer = ClientTrainer(create_model("resnet18_gn", 10), lr=0.1)
    for defense in ("krum", "multi_krum", "median", "trimmed_mean"):
        out = {}
        for device in ("cuda", "cpu"):
            eng = MeshRobustEngine(trainer, data, cfg, defense=defense,
                                   chunk=MAIN_CHUNK, device=device)
            v0 = eng.init_variables()
            v1, _, m = eng.round_fn_streaming(dict(v0), (), *eng.stream_cohort(0))
            out[device] = (eng, v0, v1, float(m["train_loss"]))
        (ge, g0, g1, gl), (ce, c0, c1, cl) = out["cuda"], out["cpu"]
        whole, worst = update_distance(defense, g0, g1, c0, c1)
        ok = whole <= 1e-3 and worst[0][1] <= 1e-2
        print(f"[order stats] {defense}: update distance {whole:.3e} of its "
              f"norm (limit 1e-3), worst leaf {worst[0][0]} {worst[0][1]:.3e} "
              f"(limit 1e-2); train_loss card {gl:.6f} CPU {cl:.6f}")
        if ok:
            continue
        if defense not in ("krum", "multi_krum"):
            raise AssertionError(f"{defense}: the card's round differs from "
                                 "the CPU's beyond the limits above")
        scores = {}
        for device, (eng, v0, _, _) in out.items():
            cohort, w = eng.stream_cohort(0)
            flats = chunked_weighted_train(
                eng.trainer, eng.trainer.flatten(v0), cohort, w, 1,
                chunk_cap=MAIN_CHUNK, fold_fn=None, emit_flat_params=True)[3]
            scores[device] = robust_ops.krum_scores_flat(
                flats, eng.n_byzantine).double().cpu()
        rel = float(((scores["cuda"] - scores["cpu"]).abs()
                     / scores["cpu"].abs()).max())
        print(f"[order stats] {defense} picked other clients: krum scores card "
              f"{scores['cuda'].tolist()}, CPU {scores['cpu'].tolist()} "
              f"(max relative difference {rel:.3e}, limit 1e-4)")
        if rel > 1e-4:
            raise AssertionError(f"{defense}: krum scores differ by {rel:.3e}")


def phase_robust_main_path() -> dict:
    """The robust main path: MeshRobustEngine(norm_clip, chunk=2, bf16
    local masters) on phase 5's 8 clients x 13 batches, 3 rounds then one
    evaluation.  Per chunk: one squared-distance and one clipped-fold
    launch, and no weighted fold.  Then FedAvg and norm-clip rounds in
    turns (F R, R F, F R) on the same clients and model, so that drift in
    the host's speed falls on both alike."""
    torch.backends.cudnn.allow_tf32 = True
    data = synthetic_data(MAIN_CLIENTS, SAMPLES, seed=0)
    cfg = FedConfig(model="resnet18_gn", dataset="cifar10",
                    client_num_in_total=MAIN_CLIENTS,
                    client_num_per_round=MAIN_CLIENTS, epochs=1,
                    batch_size=BATCH, lr=0.1, frequency_of_the_test=10_000)
    trainer = ClientTrainer(create_model("resnet18_gn", 10), lr=cfg.lr,
                            train_dtype=torch.bfloat16)
    engine = MeshRobustEngine(trainer, data, cfg, defense="norm_clip",
                              chunk=MAIN_CHUNK, local_dtype=torch.bfloat16)
    variables = engine.init_variables()
    v0 = {k: v.clone() for k, v in variables.items()}
    server_state = engine.server_init(variables)
    cohort, weights = engine.stream_cohort(0)
    torch.cuda.synchronize()

    reset_launch_counts()
    round_s, losses = [], []
    for _ in range(MAIN_ROUNDS):
        t0 = time.perf_counter()
        variables, server_state, m = engine.round_fn_streaming(
            variables, server_state, cohort, weights)
        losses.append(float(m["train_loss"]))
        round_s.append(time.perf_counter() - t0)
    stats = engine.evaluate(variables)
    torch.cuda.synchronize()
    counts = launch_counts()

    steps = MAIN_ROUNDS * MAIN_CLIENTS * BATCHES
    chunks = MAIN_ROUNDS * (MAIN_CLIENTS // MAIN_CHUNK)
    expected = {"gn_forward": 20 * (steps + 2), "gn_backward": 20 * steps,
                "wsum": 0, "sqnorm": chunks, "clip_agg": chunks}
    if counts != expected:
        raise AssertionError(f"robust launch counts {counts} != {expected}")
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"non-finite robust train loss: {losses}")
    changed = sum(int(not torch.equal(variables[k], v0[k])) for k in v0)
    if changed != len(v0) or any(v.dtype != torch.float32
                                 for v in variables.values()):
        raise AssertionError(f"{len(v0) - changed} of {len(v0)} global leaves "
                             "unchanged, or the global model left f32")
    steady = statistics.mean(round_s[1:])
    print(f"[robust path] MeshRobustEngine(norm_clip, bound "
          f"{cfg.norm_bound}, chunk={MAIN_CHUNK}, local_dtype=bf16), "
          f"{MAIN_CLIENTS} clients x {BATCHES} batches of {BATCH}")
    print(f"[robust path] train_loss per round {losses}; eval {stats}")
    print(f"[robust path] s/round {round_s} -> {steady:.4f} s/round over "
          f"rounds 2-{MAIN_ROUNDS} ({card_line()})")
    print(f"[robust path] launches {counts} == expected")

    fedavg = MeshFedAvgEngine(trainer, data, cfg, chunk=MAIN_CHUNK,
                              local_dtype=torch.bfloat16)
    float(fedavg.round_fn_streaming(variables, (), cohort, weights)[2]
          ["train_loss"])                       # its first-call cost
    turns = {"fedavg": [], "norm_clip": []}
    for order in (("fedavg", "norm_clip"), ("norm_clip", "fedavg")):
        for name in order:
            eng = fedavg if name == "fedavg" else engine
            t0 = time.perf_counter()
            float(eng.round_fn_streaming(variables, (), cohort, weights)[2]
                  ["train_loss"])
            turns[name].append(time.perf_counter() - t0)
    med = {k: statistics.median(v) for k, v in turns.items()}
    print(f"[robust path] in turns: FedAvg s/round {turns['fedavg']}, "
          f"norm_clip {turns['norm_clip']}; medians {med['fedavg']:.4f} and "
          f"{med['norm_clip']:.4f} ({med['norm_clip'] / med['fedavg'] - 1:+.1%})")
    return counts


def phase_side_engines() -> None:
    """One bf16 round each of MeshFedOptEngine (adam), MeshFedProxEngine
    and MeshFedNovaEngine at 4 clients x 13 batches, full width: FedOpt
    and FedProx fold with the weighted fold, FedNova with the clipped
    fold's accumulate form."""
    data = synthetic_data(SIDE_CLIENTS, SAMPLES, seed=4)
    cfg = FedConfig(model="resnet18_gn", dataset="cifar10",
                    client_num_in_total=SIDE_CLIENTS,
                    client_num_per_round=SIDE_CLIENTS, epochs=1,
                    batch_size=BATCH, lr=0.1, server_optimizer="adam",
                    server_lr=0.01, prox_mu=0.01)
    trainer = ClientTrainer(create_model("resnet18_gn", 10), lr=cfg.lr,
                            train_dtype=torch.bfloat16)
    steps, chunks = SIDE_CLIENTS * BATCHES, SIDE_CLIENTS // MAIN_CHUNK
    for cls, folds in ((MeshFedOptEngine, {"wsum": chunks}),
                       (MeshFedProxEngine, {"wsum": chunks}),
                       (MeshFedNovaEngine, {"clip_agg": chunks})):
        eng = cls(trainer, data, cfg, chunk=MAIN_CHUNK,
                  local_dtype=torch.bfloat16)
        v0 = eng.init_variables()
        state = eng.server_init(v0)
        cohort, weights = eng.stream_cohort(0)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        v1, state, m = eng.round_fn_streaming(v0, state, cohort, weights)
        loss = float(m["train_loss"])
        dt = time.perf_counter() - t0
        counts = launch_counts()
        expected = {"gn_forward": 20 * steps, "gn_backward": 20 * steps,
                    "wsum": 0, "sqnorm": 0, "clip_agg": 0, **folds}
        if counts != expected:
            raise AssertionError(f"{cls.__name__}: launches {counts} != "
                                 f"{expected}")
        if not math.isfinite(loss) or not all(
                torch.isfinite(v).all() and not torch.equal(v, v0[k])
                for k, v in v1.items()):
            raise AssertionError(f"{cls.__name__}: non-finite loss {loss} or "
                                 "an unchanged or non-finite global leaf")
        print(f"[{cls.__name__}] one bf16 round, {SIDE_CLIENTS} clients x "
              f"{BATCHES} batches: train_loss {loss:.6f}, {dt:.3f} s (first "
              f"round), launches {counts} == expected")


# ---------------------------------------------------------------------------
# slice 3a: the model zoo
# ---------------------------------------------------------------------------

# family: (create_model name, output_dim, kwargs, data kind); each at the
# width FedML's benchmark table runs it
ZOO = {
    "LR": ("lr", 10, {}, "mnist"),
    "CNN": ("cnn", 62, {}, "femnist"),
    "CNNDropOut": ("cnn_dropout", 62, {}, "femnist"),
    "char-LSTM": ("rnn", 90, {}, "shakespeare"),
    "word-LSTM": ("rnn_stackoverflow", 10004, {}, "stackoverflow"),
    "TransformerLM": ("transformer", 10004, {}, "stackoverflow"),
    "ResNet-56": ("resnet56", 10, {}, "cifar10"),
    "MobileNet": ("mobilenet", 10, {}, "cifar10"),
    "MobileNetV3-large": ("mobilenet_v3", 10, {"dropout": 0.0}, "cifar10"),
    "EfficientNet-B0": ("efficientnet-b0", 10, {"drop_connect_rate": 0.0},
                        "cifar10"),
    "VGG-11": ("vgg11", 10, {}, "cifar10"),
}
ZOO_EVAL_MODE = ("CNNDropOut", "VGG-11")    # dropout at a fixed rate
LM_KINDS = {"shakespeare": (90, 80), "stackoverflow": (10004, 20)}
RESNET56_PARAMS, RESNET56_STATS, RESNET56_ROW = 855_770, 4_256, 860_160


def zoo_data(kind: str, n_clients: int, per_client: int, batch: int,
             seed: int) -> FederatedData:
    """Clients of `per_client` samples shaped as `kind`'s data: uniform
    images (MNIST 28x28, FEMNIST 28x28x1, CIFAR-10 32x32x3) with uniform
    labels, or uniform tokens with the next token as each position's label
    (Shakespeare's 90 characters at T = 80, StackOverflow's 10,004 words at
    T = 20; id 0 is <pad>, and the second half of every fourth sequence is
    padding)."""
    rs = np.random.RandomState(seed)
    n = n_clients * per_client
    if kind in LM_KINDS:
        vocab, T = LM_KINDS[kind]
        tok = rs.randint(1, vocab, (n, T + 1)).astype(np.int64)
        tok[::4, T // 2:] = 0
        x, y = tok[:, :T], tok[:, 1:]
    else:
        shape, classes = {"mnist": ((28, 28), 10), "femnist": ((28, 28, 1), 62),
                          "cifar10": ((32, 32, 3), 10)}[kind]
        x = rs.rand(n, *shape).astype(np.float32)
        y = rs.randint(0, classes, n).astype(np.int64)
    idx = {i: np.arange(i * per_client, (i + 1) * per_client)
           for i in range(n_clients)}
    ev = build_eval_shard(x[:batch], y[:batch], batch)
    return FederatedData(
        train_data_num=n, test_data_num=batch, train_global=ev, test_global=ev,
        client_shards=build_client_shards(x, y, idx, batch),
        client_num_samples=np.full(n_clients, per_client, np.float32),
        test_client_shards=None, class_num=int(y.max()) + 1, synthetic=True)


def zoo_trainer(family: str, **kw) -> ClientTrainer:
    name, out, model_kw, kind = ZOO[family]
    model = create_model(name, out, **model_kw)
    if family == "EfficientNet-B0":
        model.Dropout_0.rate = 0.0          # the variant's head rate: off
    return ClientTrainer(model, has_time_axis=kind in LM_KINDS, **kw)


def eval_mode_distance(trainer: ClientTrainer, data: FederatedData) -> tuple:
    """One batch's logits and CE gradients in eval mode on the card and on
    the CPU from the same weights: (max |logit error| / max |logit|,
    ||grad_card - grad_cpu|| / ||grad_cpu||)."""
    v0 = trainer.init(torch.Generator().manual_seed(0), "cpu")
    out = {}
    for device in ("cuda", "cpu"):
        params = {k: t.to(device).requires_grad_(k in trainer.param_names)
                  for k, t in v0.items()}
        x = torch.from_numpy(data.client_shards["x"][0, 0]).to(device)
        y = torch.from_numpy(data.client_shards["y"][0, 0]).to(device)
        logits = torch.func.functional_call(trainer.model, params, (x,))
        F.cross_entropy(logits, y).backward()
        out[device] = (logits.detach().cpu().double(), torch.cat(
            [params[k].grad.reshape(-1).cpu().double()
             for k in trainer.param_names]))
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    return (float((lg - lc).abs().max() / lc.abs().max()),
            float((gg - gc).norm() / gc.norm()))


def f64_round(trainer: ClientTrainer, data: FederatedData, v0: dict) -> dict:
    """The zoo phase's FedAvg round (every client, one epoch) on the CPU in
    float64: each client's local training from v0, then the sample-weighted
    mean."""
    flat = trainer.flatten({k: v.double() for k, v in v0.items()})
    shards = {k: torch.from_numpy(v) for k, v in data.client_shards.items()}
    w = torch.from_numpy(data.client_num_samples).double()
    rows = torch.stack([trainer.local_train(
        flat, {k: t[i] for k, t in shards.items()}, 1)[0] for i in range(len(w))])
    return trainer.unflatten((w[:, None] * rows).sum(0) / w.sum())


def leaf_distances(a0: dict, a1: dict, b0: dict, b1: dict) -> tuple:
    """(||(a1 - a0) - (b1 - b0)|| per leaf, ||b1 - b0|| per leaf), in f64."""
    d, n = {}, {}
    for k in b1:
        da = a1[k].cpu().double() - a0[k].cpu().double()
        db = b1[k].cpu().double() - b0[k].cpu().double()
        d[k], n[k] = float((da - db).norm()), float(db.norm())
    return d, n


def phase_zoo() -> dict:
    """Every family of the zoo at its published width: one f32 FedAvg round
    (2 clients x 1 batch of 32, lr 0.1, TF32 off) on the card and on the
    CPU from the same weights and data, and the CPU's round in float64 as
    the exact one.  The card's update must lie within 1e-3 of the update's
    norm of the CPU's, as phase 4, or within twice the distance f32
    rounding itself puts between the CPU's f32 and f64 rounds (the
    noise), whichever is larger; within any leaf (BatchNorm statistics
    included), within 1e-2 or ten times the noise.  At init, ResNet-56's
    and MobileNet's f32 gradients already sit 2e-3 to 5e-3 from the exact
    ones (the BatchNorm backwards of 28 to 55 layers cancel), and the
    worst of their ~300 leaves a few times farther, where a wrong layer
    moves the distance to O(1).  A leaf whose update is under
    1e-3 of the model's (the attention key bias, whose gradient is zero in
    exact arithmetic, so that both devices' updates are rounding noise) is
    measured against 1e-3 of the model's update instead.  CNNDropOut and
    VGG-11, whose dropout rates are fixed,
    compare one batch's logits (within 1e-4 of their largest) and
    gradients (within 1e-3 in L2) in eval mode, then train one round on
    the card with dropout on, which must stay finite."""
    f32_off()
    out = {}
    for family, (name, out_dim, _, kind) in ZOO.items():
        trainer = zoo_trainer(family, lr=0.1)
        data = zoo_data(kind, 2, BATCH, BATCH, seed=6)
        n = sum(p.numel() for p in trainer.model.parameters())
        cfg = FedConfig(model=name, client_num_in_total=2,
                        client_num_per_round=2, epochs=1, batch_size=BATCH,
                        lr=0.1)
        t0 = time.perf_counter()
        if family in ZOO_EVAL_MODE:
            logit_err, grad_err = eval_mode_distance(trainer, data)
            engine = FedAvgEngine(trainer, data, cfg, device="cuda")
            v1, _, m = engine.round_fn(engine.init_variables(), (),
                                       *engine._round_args(0))
            if not (math.isfinite(float(m["train_loss"])) and all(
                    torch.isfinite(t).all() for t in v1.values())):
                raise AssertionError(f"zoo {family}: a dropout round on the "
                                     "card is not finite")
            out[family] = dict(params=n, mode="eval", logit_err=logit_err,
                               grad_err=grad_err)
            print(f"[zoo] {family} ({n} params), eval mode: logits {logit_err:.3e} "
                  f"of their largest (limit 1e-4), gradients {grad_err:.3e} of "
                  f"their norm (limit 1e-3); a dropout round on the card: "
                  f"train_loss {float(m['train_loss']):.6f} "
                  f"({time.perf_counter() - t0:.1f} s, {card_line()})")
            if logit_err > 1e-4 or grad_err > 1e-3:
                raise AssertionError(f"zoo {family}: the card differs from the "
                                     "CPU beyond the limits above")
            continue
        res = {}
        for device in ("cuda", "cpu"):
            engine = FedAvgEngine(trainer, data, cfg, device=device)
            v0 = engine.init_variables()
            v1, _, m = engine.round_fn(dict(v0), (), *engine._round_args(0))
            res[device] = (v0, v1, float(m["train_loss"]))
        (g0, g1, gl), (c0, c1, cl) = res["cuda"], res["cpu"]
        update_distance(f"zoo {family}", g0, g1, c0, c1)   # inits, finite
        d_card, norms = leaf_distances(g0, g1, c0, c1)
        d_f32, _ = leaf_distances(c0, c1, c0, f64_round(trainer, data, c0))
        whole_norm = math.sqrt(sum(v * v for v in norms.values()))
        l2 = lambda d: math.sqrt(sum(v * v for v in d.values())) / whole_norm
        whole, noise = l2(d_card), l2(d_f32)
        limit = max(1e-3, 2 * noise)
        rel = lambda d, k: d[k] / max(norms[k], 1e-3 * whole_norm)
        leaf_limit = max(1e-2, 10 * noise)
        worst, worst_name = max((rel(d_card, k), k) for k in norms)
        out[family] = dict(params=n, stats=trainer.n_stats, mode="train",
                           update_distance=whole, limit=limit, f32_noise=noise,
                           worst_leaf=[worst_name, worst, leaf_limit])
        print(f"[zoo] {family} ({n} params, {trainer.n_stats} statistics): "
              f"update distance {whole:.3e} of its norm (limit {limit:.1e}; "
              f"f32 against f64 on the CPU {noise:.3e}), worst leaf "
              f"{worst_name} {worst:.3e} (limit {leaf_limit:.1e}); "
              f"train_loss card {gl:.6f} CPU {cl:.6f} "
              f"({time.perf_counter() - t0:.1f} s, {card_line()})")
        if whole > limit or worst > leaf_limit:
            raise AssertionError(f"zoo {family}: the card's round differs from "
                                 "the CPU's beyond the limits above")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    return out


def bn_layer_ms() -> list:
    """One BatchNorm layer's training forward and backward at ResNet-56's
    three stage shapes (bf16 x and scale, batch 32), device time a call
    (cuda_ms over 5 calls: the ~40 launches of 20 calls take the host
    longer to queue than cuda_ms's spin kernel lasts, and the card would
    wait on the host inside the timed window), beside cuDNN's batch_norm
    forward and backward on the same tensors as a yardstick."""
    from fedml_tpu_torch.models.norms import BatchNorm
    out = []
    for c, hw in ((16, 32), (32, 16), (64, 8)):
        bn = BatchNorm(c).to("cuda").to(torch.bfloat16)   # as on bf16 masters
        x = torch.randn(BATCH, c, hw, hw, device="cuda", dtype=torch.bfloat16
                        ).contiguous(memory_format=torch.channels_last)
        x.requires_grad_()
        dy = torch.randn_like(x)
        ours = lambda: torch.autograd.backward(bn(x, True), dy)
        lib = lambda: torch.autograd.backward(F.batch_norm(
            x, None, None, bn.scale, bn.bias, True, 0.1, 1e-5), dy)
        out.append(dict(shape=[BATCH, c, hw, hw], ms=cuda_ms(ours, reps=5),
                        library_ms=cuda_ms(lib, reps=5)))
        print(f"[resnet56 path] one BatchNorm layer {out[-1]['shape']} bf16, "
              f"forward and backward: {out[-1]['ms'] * 1e3:.1f} us of device "
              f"time (F.batch_norm: {out[-1]['library_ms'] * 1e3:.1f} us) "
              f"({card_line()})")
    return out


def phase_resnet56_path(gen: torch.Generator) -> dict:
    """ResNet-56 on CIFAR-10-shaped clients through MeshFedAvgEngine with
    the main path's recipe (8 clients x 13 batches of 32, one epoch of SGD
    at lr 0.1, bf16 compute on bf16 local masters, chunk 2), R56_ROUNDS
    rounds then one evaluation.  Its row is 855,770 parameters and 4,256 BatchNorm
    statistics, padded to 860,160; the fold kernel must run exactly once a
    chunk (4 a round) and nothing else of the port's.  Then: the fold
    against its plain version at [2, 860,160]; a round whose global
    statistics must equal the plain weighted mean of the clients' trained
    statistics rows (within 1e-6 of sum_k |w_k v_k| / sum(w), computed in
    f64 on the host); and a profiled round of R56_PROFILED client(s),
    PROFILED_BATCHES batches each."""
    torch.backends.cudnn.allow_tf32 = True
    data = synthetic_data(MAIN_CLIENTS, SAMPLES, seed=5)
    cfg = FedConfig(model="resnet56", dataset="cifar10",
                    client_num_in_total=MAIN_CLIENTS,
                    client_num_per_round=MAIN_CLIENTS, epochs=1,
                    batch_size=BATCH, lr=0.1, frequency_of_the_test=10_000)
    trainer = ClientTrainer(create_model("resnet56", 10), lr=cfg.lr,
                            train_dtype=torch.bfloat16)
    row = (trainer.n_params, trainer.n_stats, trainer.spec.padded)
    if row != (RESNET56_PARAMS, RESNET56_STATS, RESNET56_ROW):
        raise AssertionError(f"ResNet-56 row {row}")
    engine = MeshFedAvgEngine(trainer, data, cfg, chunk=MAIN_CHUNK,
                              local_dtype=torch.bfloat16)
    variables = engine.init_variables()
    v0 = {k: v.clone() for k, v in variables.items()}
    cohort, weights = engine.stream_cohort(0)
    torch.cuda.synchronize()

    reset_launch_counts()
    round_s, losses = [], []
    for r in range(R56_ROUNDS):
        t0 = time.perf_counter()
        variables, _, m = engine.round_fn_streaming(variables, (), cohort,
                                                    weights, r)
        losses.append(float(m["train_loss"]))
        round_s.append(time.perf_counter() - t0)
    stats = engine.evaluate(variables)
    torch.cuda.synchronize()
    counts = launch_counts()
    expected = {"gn_forward": 0, "gn_backward": 0,
                "wsum": R56_ROUNDS * (MAIN_CLIENTS // MAIN_CHUNK),
                "sqnorm": 0, "clip_agg": 0}
    if counts != expected:
        raise AssertionError(f"resnet56 launches {counts} != {expected}")
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"resnet56: non-finite train loss {losses}")
    if any(v.dtype != torch.float32 or not torch.isfinite(v).all()
           for v in variables.values()):
        raise AssertionError("resnet56: the global model left f32 or is not "
                             "finite")
    same = [k for k in v0 if torch.equal(variables[k], v0[k])]
    if any(k in trainer.stat_names for k in same):
        raise AssertionError(f"resnet56: statistics unchanged: {same}")
    steady = statistics.mean(round_s[1:])
    print(f"[resnet56 path] MeshFedAvgEngine(chunk={MAIN_CHUNK}, "
          f"local_dtype=bf16), {MAIN_CLIENTS} clients x {BATCHES} batches of "
          f"{BATCH}, ResNet-56 ({RESNET56_PARAMS} params + {RESNET56_STATS} "
          f"statistics, row {RESNET56_ROW})")
    print(f"[resnet56 path] train_loss per round {losses}; eval {stats}")
    print(f"[resnet56 path] s/round {round_s} -> {steady:.4f} s/round over "
          f"rounds 2-{R56_ROUNDS} ({card_line()})")
    print(f"[resnet56 path] launches {counts} == expected (one fold a chunk); "
          f"every statistics leaf moved, {len(same)} of "
          f"{len(trainer.param_names)} parameter leaves did not (updates "
          "under half a bf16 ulp on the bf16 local masters): "
          + ", ".join(same[:4]))

    fold_rec = fold_check(gen, RESNET56_ROW)
    fold_rec["launches"] = counts["wsum"]
    print(fold_line("ResNet-56 path", fold_rec))

    n_p, n = trainer.train_len, trainer.spec.n
    rows = []

    def recording_fold(num, lanes, w, chunk_shards):
        rows.append((lanes[:, n_p:n].double().cpu(), w.double().cpu()))
        fedavg_fold(num, lanes, w, chunk_shards)

    sums = engine._chunked(engine._local_flat(variables), cohort, weights,
                           MAIN_ROUNDS, fold_fn=recording_fold)
    new, _ = engine._finalize_from_sums(variables, sums)
    got = trainer.flatten(new)[n_p:n].double().cpu()
    V = torch.cat([r for r, _ in rows])
    w = torch.cat([w for _, w in rows])
    want = (w[:, None] * V).sum(0) / w.sum()
    err = float((got - want).abs().max())
    scale = (w[:, None] * V).abs().sum(0) / w.sum()
    if not bool(((got - want).abs() <= 1e-6 * scale + 1e-12).all()):
        raise AssertionError(f"resnet56: the global statistics are not the "
                             f"weighted mean of the clients' (max err {err:.3e})")
    print(f"[resnet56 path] global statistics segment ({n - n_p} values) = the "
          f"plain weighted mean of the {len(V)} clients' statistics rows: max "
          f"abs err {err:.3e} (limit 1e-6 of sum|w v| / sum w)")
    # the profile reads a round of R56_PROFILED client(s): a whole round's
    # trace (~300,000 events) takes minutes to read
    sub = {k: v[:R56_PROFILED, :PROFILED_BATCHES] for k, v in cohort.items()}
    sub_round = lambda: engine.round_fn_streaming(variables, (), sub,
                                                  weights[:R56_PROFILED])
    sub_round()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sub_round()
    torch.cuda.synchronize()
    sub_s = time.perf_counter() - t0
    prof = profile_round(sub_round, sub_s,
                         tag=f"resnet56 path, {R56_PROFILED} client(s)")
    return dict(s_per_round=round_s, steady_s=steady, losses=losses,
                eval=stats, launches=counts, fold=fold_rec,
                stats_fold_max_abs_err=err, profile=prof,
                profiled_round_s=sub_s, profiled_clients=R56_PROFILED,
                bn_layer=bn_layer_ms())


def phase_word_lstm() -> dict:
    """A short word-LSTM round on MeshFedAvgEngine at full width (vocab
    10,004, embed 96, LSTM 670; 4 clients x 8 batches of 16 sequences of
    20 tokens, f32 masters, chunk 2), with has_time_axis and
    eval_ignore_id=0: the fold launches exactly once a chunk, cuDNN is
    not asked to compact the LSTM's weights (no "not part of single
    contiguous chunk" warning), and one step's device work includes the
    LSTM kernels."""
    import warnings
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    data = zoo_data("stackoverflow", 4, 8 * 16, 16, seed=7)
    cfg = FedConfig(model="rnn_stackoverflow", dataset="stackoverflow_nwp",
                    client_num_in_total=4, client_num_per_round=4, epochs=1,
                    batch_size=16, lr=0.3, frequency_of_the_test=10_000)
    trainer = zoo_trainer("word-LSTM", lr=cfg.lr, eval_ignore_id=0)
    engine = MeshFedAvgEngine(trainer, data, cfg, chunk=MAIN_CHUNK)
    variables = engine.init_variables()
    cohort, weights = engine.stream_cohort(0)
    torch.cuda.synchronize()
    reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        variables, _, m = engine.round_fn_streaming(variables, (), cohort,
                                                    weights)
        loss = float(m["train_loss"])
        dt = time.perf_counter() - t0
        stats = engine.evaluate(variables)
    counts = launch_counts()
    compaction = [str(w.message) for w in caught
                  if "contiguous chunk" in str(w.message)]
    if counts["wsum"] != 4 // MAIN_CHUNK or compaction or not math.isfinite(loss):
        raise AssertionError(f"word-LSTM round: launches {counts}, loss {loss}, "
                             f"compaction warnings {compaction[:1]}")
    n_eval = int((data.test_global["y"] != 0).sum())
    sums = trainer.evaluate(trainer.flatten(variables),
                            engine._eval_shards["test"])
    if int(sums["count"]) != n_eval:
        raise AssertionError(f"word-LSTM eval counted {int(sums['count'])} "
                             f"positions, not the {n_eval} non-pad ones")
    flat = trainer.flatten(variables)
    batch = {k: t[0, 0] for k, t in cohort.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(flat, batch)
        torch.cuda.synchronize()
    lstm = sorted({e.key for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and ("lstm" in e.key.lower() or "rnn" in e.key.lower())})
    if not lstm:
        raise AssertionError("word-LSTM step ran no LSTM kernel on the card")
    print(f"[word-LSTM] MeshFedAvgEngine(chunk={MAIN_CHUNK}), 4 clients x 8 "
          f"batches of 16, vocab 10004, T 20: train_loss {loss:.6f}, {dt:.3f} s "
          f"(first round, {card_line()}); eval {stats} ({n_eval} non-pad "
          f"positions); launches {counts}; compaction warnings 0; LSTM kernels "
          + ", ".join(k[:60] for k in lstm[:4]))
    return dict(train_loss=loss, first_round_s=dt, eval=stats,
                launches=counts, lstm_kernels=lstm)


# ---------------------------------------------------------------------------
# slice 3b: the data layer
# ---------------------------------------------------------------------------

# five data_batch files of 700 images and a test_batch of 100: 3,500
# training images, so 8 clients of 437-438 fill 13 batches of 32 each
CIFAR_BATCH_IMAGES, CIFAR_TEST_IMAGES = 700, 100
DATA_SEED = 8


def write_cifar10(root: Path) -> tuple[np.ndarray, np.ndarray]:
    """A tiny cifar-10-batches-py under `root` in the real pickle format,
    pixels and labels seeded: returns the training pixels [N, 32, 32, 3]
    uint8 and labels in the order read_cifar_pickles concatenates them."""
    rs = np.random.RandomState(DATA_SEED)
    d = root / "cifar-10-batches-py"
    d.mkdir()
    xs, ys = [], []
    for name, n in ([(f"data_batch_{i}", CIFAR_BATCH_IMAGES)
                     for i in range(1, 6)] + [("test_batch", CIFAR_TEST_IMAGES)]):
        x = rs.randint(0, 256, (n, 3072)).astype(np.uint8)
        y = rs.randint(0, 10, n).tolist()
        with open(d / name, "wb") as f:
            pickle.dump({b"data": x, b"labels": y}, f)
        if name != "test_batch":
            xs.append(x.reshape(n, 3, 32, 32).transpose(0, 2, 3, 1))
            ys.append(np.asarray(y, np.int64))
    return np.concatenate(xs), np.concatenate(ys)


def load_cifar(root: Path, clients: int, batches: int,
               store_uint8: bool) -> FederatedData:
    return load_data("cifar10", data_dir=str(root), client_num_in_total=clients,
                     batch_size=BATCH, partition_method="homo",
                     max_batches_per_client=batches, store_uint8=store_uint8)


def capture_draws(aug, g: torch.Generator, x: torch.Tensor):
    """Run `aug(g, x)` with augment's transforms wrapped to record the draws
    they are handed: (output, {"crop": (ys, xs), "flip": (flags,),
    "cut": (cy, cx)})."""
    drawn, real = {}, {n: getattr(augment, n) for n in ("crop", "flip", "cut")}

    def wrap(name):
        def call(x, *draws, **kw):
            drawn[name] = draws[:1] if name == "flip" else draws[:2]
            return real[name](x, *draws, **kw)
        return call

    try:
        for name in real:
            setattr(augment, name, wrap(name))
        return aug(g, x), drawn
    finally:
        for name, fn in real.items():
            setattr(augment, name, fn)


def check_augmentation(x: torch.Tensor) -> dict:
    """The CIFAR pipeline's draws on the card's generator (ranges, rates,
    all on the card), then the same transforms with the same draws on the
    card and on the CPU: bitwise equal, since crop, flip and cutout only
    move and zero values.  Then its cost at one step's batch."""
    aug = make_augment_fn()
    g = torch.Generator(device="cuda").manual_seed(DATA_SEED)
    out, drawn = capture_draws(aug, g, x)
    (ys, xs), (flags,), (cy, cx) = drawn["crop"], drawn["flip"], drawn["cut"]
    n, h, w = x.shape[0], x.shape[1], x.shape[2]
    for t, hi in ((ys, 9), (xs, 9), (cy, h), (cx, w)):
        counts = torch.bincount(t, minlength=hi).cpu()
        if t.device.type != "cuda" or len(counts) != hi or counts.min() == 0 \
                or float((counts - n / hi).abs().max()) > 5 * math.sqrt(n / hi):
            raise AssertionError(f"augment draws off range or rate: {counts}")
    rate = float(flags.float().mean())
    if flags.device.type != "cuda" or abs(rate - 0.5) > 5 * 0.5 / math.sqrt(n):
        raise AssertionError(f"augment flips at rate {rate}")
    cpu = x.cpu()
    steps = ((augment.crop, (ys, xs), {"padding": 4}),
             (augment.flip, (flags,), {}),
             (augment.cut, (cy, cx), {"length": 16}))
    on_card, on_cpu = x, cpu
    for fn, draws, kw in steps:
        on_card = fn(on_card, *draws, **kw)
        on_cpu = fn(on_cpu, *(t.cpu() for t in draws), **kw)
        if not torch.equal(on_card.cpu(), on_cpu):
            raise AssertionError(f"augment {fn.__name__}: card and CPU differ")
    if not torch.equal(out.cpu(), on_cpu):
        raise AssertionError("augment: the pipeline differs from its transforms")
    batch = x[:BATCH].contiguous()
    rec = dict(images=n, flip_rate=rate,
               step_host_ms=host_ms(lambda: aug(g, batch)),
               step_ms=cuda_ms(lambda: aug(g, batch)))
    print(f"[data path] augment on the card: {n} images, crop offsets and "
          f"cutout centres over their whole ranges, flip rate {rate:.4f}; "
          f"crop, flip and cutout on the card bitwise equal to the CPU's with "
          f"the same draws; one step's batch [{BATCH}, 32, 32, 3] f32 "
          f"{rec['step_ms'] * 1e3:.1f} us of device time, "
          f"{rec['step_host_ms'] * 1e3:.1f} us a call on the host "
          f"({card_line()})")
    return rec


def bf16_held_only(unchanged: list) -> bool:
    """Whether every leaf a bf16-master round left bitwise unchanged is a
    GroupNorm scale.  A scale sits on the bf16 grid (it starts at 1.0 and
    moves in whole bf16 ulps), so a client whose every step moves it by
    less than half an ulp (2^-8 just above 1.0, 2^-9 below) keeps it
    bitwise, and so does the mean of such clients.  Every other leaf must
    move: a bias at 0.0 shows any nonzero update, and the kernels start
    off the grid.  (The f32 round from the same stack checks that every
    leaf moves.)"""
    return all(k.endswith(".scale") and k.split(".")[-2].startswith("GroupNorm")
               for k in unchanged)


def upload_ms(arr: np.ndarray, reps: int = 5) -> float:
    """Host wall time of one pageable upload of `arr` to the card, waited
    for: the median of `reps`."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.from_numpy(arr).to("cuda")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_data_path() -> dict:
    """The data layer on the card (slice 3b), from CIFAR-10 pickles written
    here: the loader's uint8 stack is the written pixels bitwise and
    dequantizes on the card within f32 rounding (2e-6 absolute: a few ulps
    of values up to 2.2) of the f32 loader's stack; augmentation's draws
    and transforms (check_augmentation); one f32 round from the uint8
    stack on the card and on the CPU (2 clients x 2 batches, TF32 off,
    phase 4's limits); then the slice's main path, load_data(store_uint8)
    into MeshFedAvgEngine(chunk=2, bf16 local masters, stack_dtype=uint8)
    with a bf16 trainer that augments, 8 clients x 13 batches, 3 rounds
    and one evaluation, and one MeshRobustEngine(norm_clip) round on the
    same stack: the launch counts exact (augmentation and the dequantize
    launch no hand kernel), every leaf finite and moved."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cifar") as tmp:
        root = Path(tmp)
        raw, labels = write_cifar10(root)
        t0 = time.perf_counter()
        d8 = load_cifar(root, MAIN_CLIENTS, BATCHES, True)
        load_s = time.perf_counter() - t0
        d32 = load_cifar(root, MAIN_CLIENTS, BATCHES, False)
        d2 = load_cifar(root, 2, 2, True)
    if d8.synthetic or d32.synthetic or d2.synthetic:
        raise AssertionError("load_data took the synthetic stand-in")
    want = build_client_shards(raw, labels,
                               partition_homo(len(labels), MAIN_CLIENTS, 0),
                               BATCH, max_batches=BATCHES, shuffle_seed=0)
    if not (d8.client_shards["x"].dtype == np.uint8
            and np.array_equal(d8.client_shards["x"], want["x"])
            and np.array_equal(d8.client_shards["y"], want["y"])):
        raise AssertionError("the uint8 stack is not the written pixels")
    if d8.client_shards["mask"].min() < 1:
        raise AssertionError("the clients do not fill 13 batches of 32")

    cfg = FedConfig(model="resnet18_gn", dataset="cifar10",
                    client_num_in_total=MAIN_CLIENTS,
                    client_num_per_round=MAIN_CLIENTS, epochs=1,
                    batch_size=BATCH, lr=0.1, frequency_of_the_test=10_000)
    trainer = ClientTrainer(create_model("resnet18_gn", 10), lr=cfg.lr,
                            train_dtype=torch.bfloat16,
                            augment=make_augment_fn())
    engine = MeshFedAvgEngine(trainer, d8, cfg, chunk=MAIN_CHUNK,
                              local_dtype=torch.bfloat16,
                              stack_dtype=torch.uint8)
    if engine._host_shards() is not d8.client_shards:
        raise AssertionError("the loader's uint8 stack did not pass through")
    cohort, weights = engine.stream_cohort(0)
    ids = engine.sampler.sample(0)
    deq = engine._restore_chunk_x({"x": cohort["x"]})["x"]
    deq_err = float((deq.cpu() - torch.from_numpy(
        d32.client_shards["x"][ids])).abs().max())
    print(f"[data path] load_data('cifar10', store_uint8=True) from written "
          f"pickles ({len(labels)} training images): synthetic False, "
          f"{load_s:.2f} s; the uint8 stack {tuple(cohort['x'].shape)} is the "
          f"written pixels bitwise; dequantized on the card, max abs err "
          f"{deq_err:.3e} against the f32 loader's stack (limit 2e-6)")
    if deq_err > 2e-6:
        raise AssertionError("the dequantized stack differs from the f32 one")
    aug_rec = check_augmentation(deq.reshape((-1,) + deq.shape[-3:]))
    del deq

    f32_off()
    f32_trainer = ClientTrainer(create_model("resnet18_gn", 10), lr=0.1)
    cfg2 = FedConfig(model="resnet18_gn", dataset="cifar10",
                     client_num_in_total=2, client_num_per_round=2, epochs=1,
                     batch_size=BATCH, lr=0.1)
    res = {}
    for device in ("cuda", "cpu"):
        eng = MeshFedAvgEngine(f32_trainer, d2, cfg2, chunk=MAIN_CHUNK,
                               stack_dtype=torch.uint8, device=device)
        v0 = eng.init_variables()
        v1, _, m = eng.round_fn(dict(v0), (), *eng._round_args(0))
        res[device] = (v0, v1, float(m["train_loss"]))
    (g0, g1, gl), (c0, c1, cl) = res["cuda"], res["cpu"]
    u8_whole, u8_worst = update_distance("uint8 f32 round", g0, g1, c0, c1)
    still = [k for k in c0 if torch.equal(g1[k].cpu(), g0[k].cpu())
             or torch.equal(c1[k], c0[k])]
    print(f"[data path] one f32 round from the uint8 stack, 2 clients x 2 "
          f"batches, TF32 off: update distance card against CPU "
          f"{u8_whole:.3e} (limit 1e-3), worst leaf {u8_worst[0][0]} "
          f"{u8_worst[0][1]:.3e} (limit 1e-2); every leaf moved on both "
          f"devices; train_loss card {gl:.6f} CPU {cl:.6f}")
    if u8_whole > 1e-3 or u8_worst[0][1] > 1e-2 or still:
        raise AssertionError(f"uint8 f32 round: the card differs from the CPU, "
                             f"or leaves did not move: {still}")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True

    variables = engine.init_variables()
    v0 = {k: v.clone() for k, v in variables.items()}
    torch.cuda.synchronize()
    reset_launch_counts()
    round_s, losses = [], []
    for r in range(MAIN_ROUNDS):
        t0 = time.perf_counter()
        variables, _, m = engine.round_fn_streaming(variables, (), cohort,
                                                    weights, r)
        losses.append(float(m["train_loss"]))
        round_s.append(time.perf_counter() - t0)
    stats = engine.evaluate(variables)
    torch.cuda.synchronize()
    counts = launch_counts()
    steps = MAIN_ROUNDS * MAIN_CLIENTS * BATCHES
    eval_batches = (d8.train_global["mask"].shape[0]
                    + d8.test_global["mask"].shape[0])
    expected = {"gn_forward": 20 * (steps + eval_batches),
                "gn_backward": 20 * steps,
                "wsum": MAIN_ROUNDS * (MAIN_CLIENTS // MAIN_CHUNK),
                "sqnorm": 0, "clip_agg": 0}
    if counts != expected:
        raise AssertionError(f"data path launches {counts} != {expected}")
    same = [k for k in v0 if torch.equal(variables[k], v0[k])]
    if not bf16_held_only(same) or not all(math.isfinite(l) for l in losses) \
            or not all(torch.isfinite(v).all() for v in variables.values()):
        raise AssertionError(f"data path: loss {losses}, unchanged {same}, or "
                             "a non-finite leaf")
    steady = statistics.mean(round_s[1:])
    print(f"[data path] MeshFedAvgEngine(chunk={MAIN_CHUNK}, local_dtype=bf16, "
          f"stack_dtype=uint8) + make_augment_fn(), {MAIN_CLIENTS} clients x "
          f"{BATCHES} batches of {BATCH}: train_loss per round {losses}; eval "
          f"{stats}")
    print(f"[data path] s/round {round_s} -> {steady:.4f} s/round over rounds "
          f"2-{MAIN_ROUNDS} ({card_line()})")
    print(f"[data path] launches {counts} == expected ({eval_batches} eval "
          "batches): augmentation and the dequantize launch no hand kernel; "
          f"every leaf finite; unchanged after {MAIN_ROUNDS} rounds: "
          f"{same or 'none'} (GroupNorm scales only: see bf16_held_only)")

    robust = MeshRobustEngine(trainer, d8, cfg, defense="norm_clip",
                              chunk=MAIN_CHUNK, local_dtype=torch.bfloat16,
                              stack_dtype=torch.uint8)
    torch.cuda.synchronize()
    reset_launch_counts()
    rv, _, rm = robust.round_fn_streaming(variables, (), cohort, weights)
    robust_loss = float(rm["train_loss"])
    robust_counts = launch_counts()
    steps1, chunks1 = MAIN_CLIENTS * BATCHES, MAIN_CLIENTS // MAIN_CHUNK
    want_counts = {"gn_forward": 20 * steps1, "gn_backward": 20 * steps1,
                   "wsum": 0, "sqnorm": chunks1, "clip_agg": chunks1}
    robust_same = [k for k in rv if torch.equal(rv[k], variables[k])]
    if robust_counts != want_counts or not math.isfinite(robust_loss) or any(
            not torch.isfinite(rv[k]).all() for k in rv) \
            or not bf16_held_only(robust_same):
        raise AssertionError(f"uint8 norm_clip round: launches {robust_counts} "
                             f"(want {want_counts}), loss {robust_loss}, "
                             f"unchanged {robust_same}, or a non-finite leaf")
    print(f"[data path] MeshRobustEngine(norm_clip, stack_dtype=uint8), one "
          f"round: train_loss {robust_loss:.6f}, launches {robust_counts} == "
          f"expected; unchanged: {robust_same or 'none'}")

    # the main path's recipe on the f32 stack without augmentation, in
    # turns with the data path, so that drift in the host's speed falls
    # on both alike
    plain = ClientTrainer(trainer.model, lr=cfg.lr, train_dtype=torch.bfloat16)
    f32_engine = MeshFedAvgEngine(plain, d32, cfg, chunk=MAIN_CHUNK,
                                  local_dtype=torch.bfloat16)
    f32_cohort = f32_engine.stream_cohort(0)
    float(f32_engine.round_fn_streaming(variables, (), *f32_cohort)[2]
          ["train_loss"])                       # its first-call cost
    turns = {"f32": [], "uint8+augment": []}
    for order in (("f32", "uint8+augment"), ("uint8+augment", "f32")):
        for name in order:
            eng, args = ((f32_engine, f32_cohort) if name == "f32"
                         else (engine, (cohort, weights)))
            t0 = time.perf_counter()
            float(eng.round_fn_streaming(variables, (), *args)[2]["train_loss"])
            turns[name].append(time.perf_counter() - t0)
    med = {k: statistics.median(v) for k, v in turns.items()}
    print(f"[data path] in turns, s/round: f32 stack without augmentation "
          f"{turns['f32']}, uint8 stack with augmentation "
          f"{turns['uint8+augment']}; medians {med['f32']:.4f} and "
          f"{med['uint8+augment']:.4f} "
          f"({med['uint8+augment'] / med['f32'] - 1:+.1%}) ({card_line()})")

    host8, host32 = engine._host_shards()["x"], d32.client_shards["x"]

    def stream_ms(eng) -> float:
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.stream_cohort(0)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    upload = dict(uint8_bytes=int(host8.nbytes), f32_bytes=int(host32.nbytes),
                  uint8_ms=upload_ms(host8), f32_ms=upload_ms(host32),
                  uint8_stream_ms=stream_ms(engine),
                  f32_stream_ms=stream_ms(f32_engine))
    print(f"[data path] the cohort's x as uploaded: uint8 "
          f"{upload['uint8_bytes']} B in {upload['uint8_ms']:.3f} ms, f32 "
          f"{upload['f32_bytes']} B in {upload['f32_ms']:.3f} ms (pageable "
          f"host memory, median of 5); stream_cohort (host gather and upload) "
          f"uint8 {upload['uint8_stream_ms']:.3f} ms, f32 "
          f"{upload['f32_stream_ms']:.3f} ms ({card_line()})")
    return dict(load_s=load_s, dequant_max_abs_err=deq_err,
                augment=aug_rec, uint8_round_distance=u8_whole,
                s_per_round=round_s, steady_s=steady, losses=losses,
                eval=stats, launches=counts, robust_launches=robust_counts,
                turns=turns, upload=upload)


# ---------------------------------------------------------------------------
# slice 7a-i: the one-card algorithms beyond FedAvg
# ---------------------------------------------------------------------------

GKT_GN_SHAPES = ((32, 32, 32, 16), (32, 16, 16, 32), (32, 8, 8, 64))   # G = 2
SEG_GN_SHAPES = ((8, 32, 32, 32), (8, 16, 16, 64), (8, 8, 8, 128))     # G = 4
GKT_CLIENT_GN, GKT_SERVER_GN, SEG_GN = 7, 38, 5   # GroupNorm layers per net
GKT_ROUNDS, SEG_ROUNDS = 2, 2   # FedGKT cut from 3 rounds to hold the time
GKT_PROFILED = 1               # clients in FedGKT's profiled round (was 2)
GKT_PARAMS = (14_650, 563_658)
SEG_PARAMS = 181_813


def gn_new_shapes(gen: torch.Generator,
                  shapes=tuple((s, 2) for s in GKT_GN_SHAPES)
                  + tuple((s, 4) for s in SEG_GN_SHAPES),
                  tag: str = "slice 7a") -> list:
    """Both GroupNorm kernels at `shapes` ((shape, groups) pairs; by
    default FedGKT's stage shapes in 2 groups and FedSeg's in 4) against
    their plain versions, with f32 x and gamma (the paths' case) and bf16
    x and gamma, within gn_check's tolerances; each shape's launch plans,
    and its f32 device time beside the bound of the bytes it must move."""
    recs = []
    for shape, G in shapes:
        N, H, W, C = shape
        x, dy, gamma, beta = stage_inputs(shape, gen, dtype=torch.float32,
                                          param_dtype=torch.float32)
        err32 = gn_check(x, dy, gamma, beta, f"{shape} f32, G={G}", G)
        err16 = gn_check(x.bfloat16(), dy.bfloat16(), gamma.bfloat16(),
                         beta.bfloat16(), f"{shape} bf16, G={G}", G)
        _, mean, rstd = gn_forward_plain(x, gamma, beta, G, FLAX_EPS)
        elems, stats = x.numel(), 2 * N * G * 4
        plans = {d: launch_plan(N, H * W, C, G, torch.float32,
                                backward=d == "backward")
                 for d in ("forward", "backward")}
        rec = dict(
            shape=list(shape), groups=G, cg=C // G,
            max_abs_err={"f32": list(err32), "bf16": list(err16)},
            plan={d: dict(K=p.K, threads=p.threads, resident=p.resident,
                          vec=p.vec) for d, p in plans.items()},
            fwd_ms=cuda_ms(lambda: gn_forward(x, gamma, beta, G, FLAX_EPS)),
            bwd_ms=cuda_ms(lambda: gn_backward(x, dy, gamma, mean, rstd, G)),
            fwd_bound=bound_ms(2 * elems * 4 + 2 * C * 4 + stats, 8 * elems),
            bwd_bound=bound_ms(3 * elems * 4 + 3 * C * 4 + stats,
                               12 * elems))
        recs.append(rec)
        print(f"[{tag}] GroupNorm {list(shape)} G={G} (Cg {C // G}): max "
              f"abs err y/dx f32 {err32[0]:.3e}/{err32[1]:.3e}, bf16 "
              f"{err16[0]:.3e}/{err16[1]:.3e}; plan forward "
              + ", backward ".join(
                  f"K={p.K} threads={p.threads} resident={p.resident} "
                  f"vec={p.vec}" for p in plans.values())
              + f"; f32 forward {rec['fwd_ms'] * 1e3:.2f} us (bound "
              f"{rec['fwd_bound'][0] * 1e3:.2f}), backward "
              f"{rec['bwd_ms'] * 1e3:.2f} us (bound "
              f"{rec['bwd_bound'][0] * 1e3:.2f})")
    return recs


def card_cpu(tag: str, run, expect: dict) -> dict:
    """`run(device)` -> (v0, v1, info): one round (or epoch) of an engine
    from the same weights, in f32 with TF32 off, on the card and on the
    CPU.  The card's launches, counted around its run, must equal `expect`
    (zero for any kernel not named), and the update v1 - v0 must lie within
    phase 4's limits of the CPU's (1e-3 of its norm over the model, 1e-2
    within any leaf)."""
    res = {}
    for device in ("cuda", "cpu"):
        reset_launch_counts()
        t0 = time.perf_counter()
        v0, v1, info = run(device)
        if device == "cuda":
            torch.cuda.synchronize()
            counts = launch_counts()
        res[device] = (v0, v1, info, time.perf_counter() - t0)
    (g0, g1, gi, gt), (c0, c1, ci, ct) = res["cuda"], res["cpu"]
    want = {k: expect.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts} != {want}")
    whole, worst = update_distance(tag, g0, g1, c0, c1)
    print(f"[slice 7a] {tag}: update distance {whole:.3e} of its norm (limit "
          f"1e-3), worst leaf {worst[0][0]} {worst[0][1]:.3e} (limit 1e-2); "
          f"card {gt:.2f} s, CPU {ct:.2f} s; launches "
          f"{ {k: v for k, v in counts.items() if v} }; card {gi}, CPU {ci}")
    if whole > 1e-3 or worst[0][1] > 1e-2:
        raise AssertionError(f"{tag}: the card's round differs from the CPU's "
                             "beyond phase 4's limits")
    return dict(update_distance=whole, worst_leaf=list(worst[0]),
                launches=counts, card_s=gt, cpu_s=ct, card=gi, cpu=ci)


def prefixed(**trees) -> dict:
    """{prefix: {name: tensor}} -> one {prefix.name: tensor} dict."""
    return {f"{p}.{k}": v for p, tree in trees.items() for k, v in tree.items()}


def engines_card_cpu() -> dict:
    """One f32 round (or epoch) of every engine of the slice, card against
    CPU, at a small size: 2-8 clients of one batch, the models at their
    published widths (ResNet-18-GN, the GKT pair, the segmentation net,
    the GAN pair, split_cnn, LR)."""
    f32_off()
    gw = lambda: torch.Generator().manual_seed(0)
    rgn = lambda: ClientTrainer(create_model("resnet18_gn", 10), lr=0.1)

    def cfg(n, **kw):
        base = dict(client_num_in_total=n, client_num_per_round=n, epochs=1,
                    batch_size=BATCH, lr=0.1, frequency_of_the_test=10_000)
        return FedConfig(**{**base, **kw})
    out = {}

    mnist4 = zoo_data("mnist", 4, BATCH, BATCH, seed=10)

    def turbo(device):
        eng = TurboAggregateEngine(ClientTrainer(create_model("lr", 10), lr=0.1),
                                   mnist4, cfg(4), device=device)
        v0 = eng.init_variables(gw())
        rows, ns = eng.train_cohort(v0, 0)
        plain, secure = eng.plain_mean(rows, ns), eng.secure_mean(rows, ns, 0)
        err = max(float((secure[k] - plain[k]).abs().max()) for k in plain)
        if err > len(rows) * 2.0 ** -16:
            raise AssertionError(f"TurboAggregate on {device}: the secure mean "
                                 f"is {err:.3e} from the plain one")
        return v0, plain, f"secure - plain max {err:.3e} (limit K 2^-16)"
    out["turboaggregate"] = card_cpu("TurboAggregate (LR, 4 clients)", turbo,
                                     {"wsum": 1})

    cifar4 = zoo_data("cifar10", 4, BATCH, BATCH, seed=11)

    def hierarchical(device):
        eng = HierarchicalFedAvgEngine(rgn(), cifar4, cfg(4), group_num=2,
                                       device=device)
        v0 = eng.init_variables(gw())
        v1, _, m = eng.round_fn(dict(v0), (), *eng._round_args(0))
        return v0, v1, f"train_loss {float(m['train_loss']):.6f}"
    out["hierarchical"] = card_cpu(
        "hierarchical (ResNet-18-GN, 2 groups of 2 clients)", hierarchical,
        {"gn_forward": 80, "gn_backward": 80, "wsum": 3})

    cifar2 = zoo_data("cifar10", 2, BATCH, BATCH, seed=12)
    cen = dataclasses.replace(cifar2, train_global={
        k: v.reshape((-1,) + v.shape[2:]) for k, v in cifar2.client_shards.items()})

    def centralized(device):
        tr = CentralizedTrainer(rgn(), cen, cfg(2), device=device)
        v0 = tr.trainer.init(gw(), device)
        v1 = tr.run(epochs=1, variables=dict(v0))
        return v0, v1, f"train_loss {tr.metrics_history[-1]['train_loss']:.6f}"
    out["centralized"] = card_cpu("centralized (ResNet-18-GN, 2 batches)",
                                  centralized, {"gn_forward": 100,
                                                "gn_backward": 40})

    susy = load_data("susy", client_num_in_total=8, batch_size=8,
                     synthetic_scale=0.01, seed=0)
    for push_sum in (False, True):
        def gossip(device, push_sum=push_sum):
            topo = (AsymmetricTopologyManager(8, 3, 0.3) if push_sum
                    else SymmetricTopologyManager(8, 2))
            eng = DecentralizedGossipEngine(
                ClientTrainer(create_model("lr", 2, input_dim=18), lr=0.1),
                susy, cfg(8), topology=topo, push_sum=push_sum, device=device)
            rows, w = eng.init_states(gw())
            w = w * torch.linspace(0.5, 1.5, 8).to(device)
            new, w1, _ = eng.round_fn(rows, w, eng.data.device_shards(device)[0])
            as_dict = lambda r: {f"client_{c}": r[c] for c in range(len(r))}
            return ({**as_dict(rows), "weights": w}, {**as_dict(new), "weights": w1},
                    f"test_acc {eng.evaluate(new, w1)['test_acc']:.4f}")
        name = "push-sum" if push_sum else "DSGD"
        out[name] = card_cpu(f"{name} (LR, 8 clients)", gossip, {})

    vx, vy, splits = load_vfl_data("lending_club", n_samples=512, seed=0)

    def vfl(device):
        eng = VFLEngine(splits, FedConfig(batch_size=64, lr=0.01,
                                          client_optimizer="adam"),
                        device=device)
        p0 = eng.init_params(gw())
        p1 = eng.fit(vx, vy, epochs=1, params=dict(p0))
        return p0, p1, f"train_loss {eng.metrics_history[-1]['train_loss']:.6f}"
    out["vfl"] = card_cpu("vertical FL (lending_club, 2 parties)", vfl, {})

    femnist2 = zoo_data("femnist", 2, BATCH, BATCH, seed=13)

    def splitnn(device):
        eng = SplitNNEngine(*split_cnn(62), femnist2, cfg(2), device=device)
        cp, sp = eng.init_params(gw())
        cps, sp1 = eng.run(rounds=1, params=(cp, sp))
        return (prefixed(client_0=cp, client_1=cp, server=sp),
                prefixed(client_0=cps[0], client_1=cps[1], server=sp1),
                f"train_loss {eng.metrics_history[-1]['train_loss']:.6f}")
    out["splitnn"] = card_cpu("SplitNN (split_cnn, 2 clients)", splitnn, {})

    voc = load_data("pascal_voc", client_num_in_total=2, batch_size=8,
                    synthetic_scale=0.05, max_batches_per_client=1, seed=0)
    voc_steps = 2 * voc.client_shards["mask"].shape[1]
    voc_eval = sum(s["mask"].shape[0] for s in (voc.train_global,
                                                 voc.test_global))

    def fedseg(device):
        trainer = ClientTrainer(create_model("segnet", 21), lr=0.05,
                                has_time_axis=True, train_ignore_id=255)
        eng = FedSegEngine(trainer, voc, cfg(2, batch_size=8), device=device)
        v0 = eng.init_variables(gw())
        v1, _, m = eng.round_fn(dict(v0), (), *eng._round_args(0))
        return v0, v1, {k: round(v, 6) for k, v in eng.evaluate(v1).items()}
    out["fedseg"] = card_cpu(
        "FedSeg (segnet width 32, 2 clients)", fedseg,
        {"gn_forward": SEG_GN * (voc_steps + voc_eval),
         "gn_backward": SEG_GN * voc_steps, "wsum": 1})
    card_m, cpu_m = out["fedseg"]["card"], out["fedseg"]["cpu"]
    worst = max(abs(card_m[k] - cpu_m[k]) for k in cpu_m)
    if worst > 1e-2:
        raise AssertionError(f"FedSeg: the card's metrics {card_m} differ from "
                             f"the CPU's {cpu_m} by {worst:.3e} (limit 1e-2)")

    cifar2g = synthetic_data(2, BATCH, seed=14)

    def fedgkt(device):
        eng = FedGKTEngine(ResNetClientGKT(10), ResNetServerGKT(10), cifar2g,
                           cfg(2), device=device)
        cp, sp = eng.init_params(gw())
        shards, _ = eng.data.device_shards(device)
        spf = eng.server.flatten(sp)
        flats, sp1, _, slog, _, s_loss = eng.train_round(
            [eng.client.flatten(cp)] * 2, spf, eng.server_tx.init(spf),
            torch.zeros(2, 1, BATCH, 10, device=device), shards)
        return (prefixed(client_0=cp, client_1=cp, server=sp,
                         logits={"server": torch.zeros_like(slog)}),
                prefixed(client_0=eng.client.unflatten(flats[0]),
                         client_1=eng.client.unflatten(flats[1]),
                         server=eng.server.unflatten(sp1),
                         logits={"server": slog}),
                f"server_loss {float(s_loss):.6f}")
    out["fedgkt"] = card_cpu(
        "FedGKT (full-width pair, 2 clients, server logits included)", fedgkt,
        {"gn_forward": 2 * 2 * (GKT_CLIENT_GN + GKT_SERVER_GN),
         "gn_backward": 2 * (GKT_CLIENT_GN + GKT_SERVER_GN)})

    mnist2 = zoo_data("mnist", 2, BATCH, BATCH, seed=15)

    def fedgan(device):
        eng = FedGANEngine(Generator(), Discriminator(), mnist2,
                           cfg(2, lr=0.001), device=device)
        p0 = eng.init_params(gw())
        cohort, _ = eng.data.cohort(np.arange(2), device)
        p1, m = eng.round_fn(dict(p0), cohort, 0)
        return p0, p1, (f"d_loss {float(m['d_loss']):.6f} g_loss "
                        f"{float(m['g_loss']):.6f}")
    out["fedgan"] = card_cpu("FedGAN (z from the same host draws, 2 clients)",
                             fedgan, {"wsum": 1})
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    return out


def timed_phase(engine, name: str, totals: dict) -> None:
    """Wrap engine.<name> so that its wall time, the card waited for before
    and after, adds to totals[name]."""
    inner = getattr(engine, name)

    def run(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args)
        torch.cuda.synchronize()
        totals[name] += time.perf_counter() - t0
        return out
    setattr(engine, name, run)


def phase_gkt_path() -> dict:
    """The slice's path: FedGKT at the published widths of its pair
    (ResNetClientGKT, ResNetServerGKT), f32, on phase 5's 8 clients of 13
    batches of 32, client SGD at lr 0.1, the server's SGD with momentum
    0.9 and wd 1e-4; GKT_ROUNDS rounds, then one evaluation; exact GroupNorm
    launch counts; each phase's share of the round; then a round of
    GKT_PROFILED of the clients (PROFILED_BATCHES batches each), timed and
    under the profiler."""
    data = synthetic_data(MAIN_CLIENTS, SAMPLES, seed=0)
    cfg = FedConfig(dataset="cifar10", client_num_in_total=MAIN_CLIENTS,
                    client_num_per_round=MAIN_CLIENTS, epochs=1,
                    batch_size=BATCH, lr=0.1, frequency_of_the_test=10_000)
    engine = FedGKTEngine(ResNetClientGKT(10), ResNetServerGKT(10), data, cfg)
    sizes = (engine.client.spec.n, engine.server.spec.n)
    if sizes != GKT_PARAMS:
        raise AssertionError(f"GKT pair sizes {sizes} != {GKT_PARAMS}")
    cp0, sp0 = engine.init_params()
    shards, _ = data.device_shards(engine.device)
    C, B = shards["mask"].shape[:2]
    flats = [engine.client.flatten(cp0)] * C
    sp = engine.server.flatten(sp0)
    opt = engine.server_tx.init(sp)
    slog = torch.zeros(C, B, BATCH, 10, device=engine.device)
    totals = {"_client_phase": 0.0, "_server_phase": 0.0}
    for name in totals:
        timed_phase(engine, name, totals)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launch_counts()
    round_s, shares, c_losses, s_losses = [], [], [], []
    for _ in range(GKT_ROUNDS):
        before = dict(totals)
        t0 = time.perf_counter()
        flats, sp, opt, slog, losses, s_loss = engine.train_round(
            flats, sp, opt, slog, shards)
        s_losses.append(float(s_loss))               # waits for the round
        round_s.append(time.perf_counter() - t0)
        c_losses.append(float(losses.mean()))
        shares.append({k.split("_")[1]: (totals[k] - before[k]) / round_s[-1]
                       for k in totals})
    stats = engine.evaluate(engine.client.unflatten(flats[0]),
                            engine.server.unflatten(sp))
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    steps = GKT_ROUNDS * C * B
    per_step = GKT_CLIENT_GN + GKT_SERVER_GN
    eval_batches = data.test_global["mask"].shape[0]
    expected = {"gn_forward": 2 * steps * per_step + eval_batches * per_step,
                "gn_backward": steps * per_step,
                "wsum": 0, "sqnorm": 0, "clip_agg": 0}
    if counts != expected:
        raise AssertionError(f"FedGKT path: launches {counts} != {expected}")
    if not all(math.isfinite(v) for v in c_losses + s_losses):
        raise AssertionError(f"FedGKT path: non-finite losses {c_losses} "
                             f"{s_losses}")
    if not bool(torch.isfinite(slog).all()) or slog.shape != (C, B, BATCH, 10):
        raise AssertionError("FedGKT path: server logits not finite or shaped")
    for tag, net, new, old in (("client 0", engine.client, flats[0],
                                engine.client.flatten(cp0)),
                               ("server", engine.server, sp,
                                engine.server.flatten(sp0))):
        same = [k for (k, a), b in zip(net.unflatten(new).items(),
                                       net.unflatten(old).values())
                if torch.equal(a, b)]
        if same:
            raise AssertionError(f"FedGKT path: {tag} leaves unchanged: {same}")
    feat_bytes = C * B * BATCH * 32 * 32 * 16 * 4
    steady = statistics.mean(round_s[1:])
    share = {k: statistics.mean(s[k] for s in shares[1:]) for k in shares[0]}
    print(f"[fedgkt path] FedGKTEngine, ResNetClientGKT ({sizes[0]} params) + "
          f"ResNetServerGKT ({sizes[1]} params), f32, {C} clients x {B} "
          f"batches of {BATCH}; uploaded features [{C}, {B}, {BATCH}, 32, 32, "
          f"16] f32 = {feat_bytes} B; peak device memory {peak} B")
    print(f"[fedgkt path] client loss per round {c_losses}, server loss "
          f"{s_losses}; eval {stats}")
    print(f"[fedgkt path] s/round {round_s} -> {steady:.4f} s/round over "
          f"rounds 2-{GKT_ROUNDS}; client phase {share['client']:.1%}, server "
          f"phase {share['server']:.1%} of the round ({card_line()})")
    print(f"[fedgkt path] launches {counts} == expected")
    # the busy share from a round of 1 of the 8 clients, PROFILED_BATCHES
    # of its batches (the same steps per client; a whole round's trace
    # takes minutes of host time to read)
    for name in totals:
        delattr(engine, name)                      # the untimed methods again
    sub = {k: v[:GKT_PROFILED, :PROFILED_BATCHES] for k, v in shards.items()}
    sub_round = lambda: engine.train_round(
        flats[:GKT_PROFILED], sp, opt,
        slog[:GKT_PROFILED, :PROFILED_BATCHES], sub)
    sub_round()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sub_round()
    torch.cuda.synchronize()
    sub_s = time.perf_counter() - t0
    prof = profile_round(sub_round, sub_s,
                         tag=f"fedgkt path, {GKT_PROFILED} client")
    print(f"[fedgkt path] the profiled {GKT_PROFILED}-client round took "
          f"{time.perf_counter() - t0:.1f} s of command time")
    return dict(s_per_round=round_s, steady_s=steady, phase_share=share,
                client_losses=c_losses, server_losses=s_losses, eval=stats,
                launches=counts, feature_bytes=feat_bytes, peak_bytes=peak,
                profiled_round_s=sub_s, profiled_clients=GKT_PROFILED,
                profile={k: v for k, v in prof.items() if k != "top"})


def phase_seg_path() -> dict:
    """FedSeg at its model's full width (SegEncoderDecoder(21, 32)) on the
    pascal_voc stand-in (512 images of 32x32, void 255, 4 clients, batches
    of 8), f32, lr 0.05: 2 rounds then one evaluation, exact launch
    counts."""
    data = load_data("pascal_voc", client_num_in_total=4, batch_size=8, seed=0)
    cfg = FedConfig(model="segnet", dataset="pascal_voc", client_num_in_total=4,
                    client_num_per_round=4, epochs=1, batch_size=8, lr=0.05,
                    train_ignore_id=255, frequency_of_the_test=10_000)
    trainer = ClientTrainer(create_model("segnet", 21), lr=cfg.lr,
                            has_time_axis=True, train_ignore_id=255)
    if trainer.n_params != SEG_PARAMS:
        raise AssertionError(f"segnet has {trainer.n_params} params")
    engine = FedSegEngine(trainer, data, cfg)
    variables = engine.init_variables()
    v0 = {k: v.clone() for k, v in variables.items()}
    K, B = data.client_shards["mask"].shape[:2]
    torch.cuda.synchronize()
    reset_launch_counts()
    round_s, losses = [], []
    for r in range(SEG_ROUNDS):
        t0 = time.perf_counter()
        variables, _, m = engine.round_fn(variables, (), *engine._round_args(r))
        losses.append(float(m["train_loss"]))
        round_s.append(time.perf_counter() - t0)
    stats = engine.evaluate(variables)
    torch.cuda.synchronize()
    counts = launch_counts()
    steps = SEG_ROUNDS * K * B
    eval_batches = sum(s["mask"].shape[0] for s in (data.train_global,
                                                     data.test_global))
    expected = {"gn_forward": SEG_GN * (steps + eval_batches),
                "gn_backward": SEG_GN * steps, "wsum": SEG_ROUNDS,
                "sqnorm": 0, "clip_agg": 0}
    if counts != expected:
        raise AssertionError(f"FedSeg path: launches {counts} != {expected}")
    same = [k for k in v0 if torch.equal(variables[k], v0[k])]
    if same or not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"FedSeg path: leaves unchanged {same} or "
                             f"non-finite losses {losses}")
    if not all(0.0 <= v <= 1.0 for v in stats.values()):
        raise AssertionError(f"FedSeg path: metrics out of [0, 1]: {stats}")
    print(f"[fedseg path] FedSegEngine, SegEncoderDecoder(21, 32) "
          f"({SEG_PARAMS} params), pascal_voc stand-in, {K} clients x {B} "
          f"batches of 8: train_loss per round {losses}; s/round {round_s} "
          f"({card_line()}); last eval {stats}; launches {counts} == expected")
    return dict(s_per_round=round_s, losses=losses, eval=stats,
                launches=counts)


def phase_slice7a(gen: torch.Generator) -> dict:
    """Phase 14: slice 7a-i's GroupNorm shapes, engines and two paths, each
    part's seconds of command time."""
    rec, seconds = {}, {}
    for key, part in (("gn_shapes", lambda: gn_new_shapes(gen)),
                      ("engines", engines_card_cpu),
                      ("fedgkt_path", phase_gkt_path),
                      ("fedseg_path", phase_seg_path)):
        t0 = time.perf_counter()
        rec[key] = part()
        seconds[key] = time.perf_counter() - t0
    rec["seconds"] = seconds
    print(f"[slice 7a] phase 14 took {sum(seconds.values()):.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    return rec


# ---------------------------------------------------------------------------
# slice 7a-ii: FedNAS with the DARTS search space, and the obs core
# ---------------------------------------------------------------------------

NAS_MODES = ("first_order", "unrolled", "gdas")
NAS_FULL = dict(C=16, layers=8, steps=4, multiplier=4)      # the published
NAS_MICRO = dict(C=4, layers=1, steps=2, multiplier=2)      # the tests' space
NAS_PARAMS, RETRAIN_C, RETRAIN_LAYERS = 1_987_194, 36, 20
NAS_CLIENTS, NAS_BATCHES, NAS_LR = 4, 2, 0.025   # batches cut from 4
# GroupNorm launches (forward, backward) of one local-search step, a train
# and a validation batch, by mode.  Full depth: 705 layers a forward; the
# w step runs all 705 backward, the first-order alpha step the 629 whose
# input depends on the alphas; the unrolled step adds the train forward's
# create_graph backward (705, each through the kernel) and the train
# forward's alpha-dependent 629 in the outer backward.  Micro: 37 layers,
# 6 of them alpha-dependent.  (Counted with the plain versions on the CPU
# at a narrow width: the counts do not depend on the width.)
NAS_STEP_GN = {"first_order": (2 * 705, 705 + 629),
               "unrolled": (3 * 705, 3 * 705 + 629),
               "gdas": (2 * 705, 705 + 629)}
NAS_MICRO_STEP_GN = {"first_order": (2 * 37, 37 + 6),
                     "unrolled": (3 * 37, 3 * 37 + 6),
                     "gdas": (2 * 37, 37 + 6)}
NAS_GN_FORWARD = 705
# (mode, rounds, clients a round): one round of each mode on 2 of the 4
# clients, the second-order round on 1 (its steps cost ~5x a first-order
# one), to keep the script's time
NAS_PATH_ROUNDS = (("first_order", 1, 2), ("unrolled", 1, 1),
                   ("gdas", 1, 2))


def nas_engine(data: FederatedData, mode: str, device=None, lr: float = 0.1,
               per_round: int | None = None, **space) -> FedNASSearchEngine:
    cfg = FedConfig(dataset="cifar10", client_num_in_total=data.client_num,
                    client_num_per_round=per_round or data.client_num, epochs=1,
                    batch_size=int(data.client_shards["mask"].shape[2]),
                    lr=lr, frequency_of_the_test=1)
    return FedNASSearchEngine(data, cfg, num_classes=10, device=device,
                              unrolled=mode == "unrolled",
                              gdas=mode == "gdas", **(space or NAS_FULL))


def rel_dist(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def gn_double_backward_card(gen: torch.Generator) -> dict:
    """torch.autograd.grad(create_graph=True) through one GroupNorm layer
    at a DARTS shape, f32: the second derivatives (with respect to x,
    gamma and dy) of the kernels plus the analytic double backward,
    against PyTorch's own second derivative of the plain version on the
    card (autograd through its ops) and against the port's op on the CPU;
    each within 1e-4 of the yardstick's norm.  The kernel path launches
    each GroupNorm kernel once."""
    shape, G = (32, 16, 16, 32), 8
    x, dy, gamma, beta = stage_inputs(shape, gen, dtype=torch.float32,
                                      param_dtype=torch.float32)
    w = torch.randn(shape, generator=gen, device="cuda")

    def second(fn, device):
        x_, g_, b_, dy_ = (t.detach().to(device).clone().requires_grad_()
                           for t in (x, gamma, beta, dy))
        y = fn(x_, g_, b_)
        gx, gg, gb = torch.autograd.grad(y, (x_, g_, b_), dy_,
                                         create_graph=True)
        loss = ((gx * w.to(device)).sum() + gg.square().sum()
                + (gb * gg).sum())
        return torch.autograd.grad(loss, (x_, g_, dy_))

    kernel = lambda x_, g_, b_: group_norm(x_, g_, b_, G, FLAX_EPS)
    plain = lambda x_, g_, b_: gn_forward_plain(x_, g_, b_, G, FLAX_EPS)[0]
    reset_launch_counts()
    card = second(kernel, "cuda")
    torch.cuda.synchronize()
    counts = launch_counts()
    if (counts["gn_forward"], counts["gn_backward"]) != (1, 1):
        raise AssertionError(f"GroupNorm double backward: launches {counts}")
    twin = second(plain, "cuda")
    cpu = second(kernel, "cpu")
    rec = {}
    for name, a, b, c in zip(("d/dx", "d/dgamma", "d/ddy"), card, twin, cpu):
        rec[name] = dict(vs_twin=rel_dist(a, b), vs_cpu=rel_dist(a, c))
        if max(rec[name].values()) > 1e-4 or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"GroupNorm double backward {name}: {rec}")
    print(f"[slice 7a-ii] GroupNorm double backward {list(shape)} G={G} f32: "
          + ", ".join(f"{k} {v['vs_twin']:.3e} from the plain version's "
                      f"autograd, {v['vs_cpu']:.3e} from the CPU"
                      for k, v in rec.items())
          + " (limit 1e-4 of the norm); launches 1 forward, 1 backward")
    return rec


def arch_correction_card() -> dict:
    """The second-order correction g2 - g1 of one micro-space _arch_grad
    (32 images of 32x32, the alphas off their near-uniform init), f32 with
    TF32 off, on the card against the CPU, relative to the correction's
    own norm (limit 1e-3): a correction that lost the GroupNorm terms of
    the second-order graph would be a small change of g2 and would hide
    inside a tolerance on g2 itself."""
    data = zoo_data("cifar10", 1, 2 * BATCH, BATCH, seed=21)
    out = {}
    for device in ("cuda", "cpu"):
        grads = []
        for mode in ("first_order", "unrolled"):
            eng = nas_engine(data, mode, device, **NAS_MICRO)
            params, alphas = eng.init_state(torch.Generator().manual_seed(0))
            p = eng.net.flatten(params)
            a = eng.flatten_alphas(alphas) * 300.0
            shard = {k: torch.as_tensor(v[0]).to(device)
                     for k, v in data.client_shards.items()}
            tb, vb = ({k: v[b] for k, v in shard.items()} for b in (0, 1))
            grads.append(eng._arch_grad(p, a, tb, vb))
        out[device] = grads
    (g1, g2), (c1, c2) = out["cuda"], out["cpu"]
    rec = dict(correction=rel_dist(g2 - g1, c2 - c1), g2=rel_dist(g2, c2),
               g1=rel_dist(g1, c1),
               correction_share=float((c2 - c1).norm() / c2.norm()))
    print(f"[slice 7a-ii] arch grad, micro space: the card's second-order "
          f"correction g2 - g1 is {rec['correction']:.3e} of its norm from "
          f"the CPU's (limit 1e-3); g2 {rec['g2']:.3e}, g1 {rec['g1']:.3e}; "
          f"the correction is {rec['correction_share']:.3e} of g2's norm")
    if rec["correction"] > 1e-3 or rec["correction_share"] == 0.0:
        raise AssertionError(f"second-order correction, card vs CPU: {rec}")
    return rec


def record_arch_grads(eng: FedNASSearchEngine, grads: list) -> None:
    """Append every alpha gradient the engine computes (before Adam) to
    `grads`."""
    inner = eng._arch_grad

    def recorded(*args, **kw):
        g = inner(*args, **kw)
        grads.append(g.detach().cpu().double())
        return g
    eng._arch_grad = recorded


def nas_card_cpu(tag: str, run, expect: dict, arch_lr: float = 3e-4) -> dict:
    """`run(device, dtype, grads)` -> (w0, a0, w1, a1, info): one search
    round from the same weights, alphas, data and noise, appending each
    step's alpha gradient (before Adam) to `grads`; run on the card in
    f32, on the CPU in f32 and on the CPU in f64 (TF32 off).  The card's
    launches must equal `expect`.  Held: the w update within 1e-3 of its
    norm of the CPU's f32 one (phase 4's limit); every alpha gradient
    within max(1e-3, 2 d) of its norm of the f64 one, d the CPU's own f32
    distance from it (the f32 formula's own error: GDAS's straight-through
    mix is one-hot only up to f32 rounding, which reaches the gradients on
    either device).  The alphas after Adam are not held: Adam's first
    step maps each gradient element g to about -lr sign(g), so an element
    whose gradient lies under the f32 noise moves a whole lr the other
    way; the elements more than 1e-2 lr apart are counted and printed."""
    res = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                          ("cpu", torch.float64)):
        reset_launch_counts()
        grads = []
        t0 = time.perf_counter()
        w0, a0, w1, a1, info = run(device, dtype, grads)
        if device == "cuda":
            torch.cuda.synchronize()
            counts = launch_counts()
        res[device, dtype] = ([t.detach().cpu().double()
                               for t in (w0, a0, w1, a1)],
                              grads, info, time.perf_counter() - t0)
    (card, g_card, c_info, c_s), (cpu, g_cpu, p_info, p_s), (_, g_f64, _, f_s) = (
        res.values())
    want = {k: expect.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts} != {want}")
    if not (torch.equal(card[0], cpu[0]) and torch.equal(card[1], cpu[1])):
        raise AssertionError(f"{tag}: the inits differ")
    if not g_card or not len(g_card) == len(g_cpu) == len(g_f64):
        raise AssertionError(f"{tag}: alpha gradients {len(g_card)} on the "
                             f"card, {len(g_cpu)}/{len(g_f64)} on the CPU")
    w_dist = rel_dist(card[2] - card[0], cpu[2] - cpu[0])
    ga = [dict(card=rel_dist(g, f), cpu_f32=rel_dist(c, f),
               card_cpu=rel_dist(g, c)) for g, c, f in zip(g_card, g_cpu, g_f64)]
    ga_ok = all(d["card"] <= max(1e-3, 2 * d["cpu_f32"]) for d in ga)
    da = ((card[3] - card[1]) - (cpu[3] - cpu[1])).abs()
    flips = int((da > 1e-2 * arch_lr).sum())
    print(f"[slice 7a-ii] {tag}: w update {w_dist:.3e} of its norm from the "
          f"CPU's (limit 1e-3); alpha gradients from the f64 CPU's: card "
          + ", ".join(f"{d['card']:.3e}" for d in ga) + ", CPU f32 "
          + ", ".join(f"{d['cpu_f32']:.3e}" for d in ga)
          + " (limit max(1e-3, 2x the CPU's)); card from CPU f32 "
          + ", ".join(f"{d['card_cpu']:.3e}" for d in ga)
          + f"; alphas after Adam: {flips} of {da.numel()} elements more "
          f"than 1e-2 lr apart (largest {float(da.max()) / arch_lr:.3e} lr); "
          f"card {c_s:.2f} s, CPU f32 {p_s:.2f} s, f64 {f_s:.2f} s; launches "
          f"{ {k: v for k, v in counts.items() if v} }; card {c_info}, CPU "
          f"{p_info}")
    if (w_dist > 1e-3 or not ga_ok
            or not all(bool(torch.isfinite(t).all())
                       for t in (card[2], card[3], *g_card))):
        raise AssertionError(f"{tag}: the card's round differs from the "
                             "CPU's beyond the limits above")
    return dict(w_update_distance=w_dist, alpha_grad=ga, alpha_flips=flips,
                alpha_elements=da.numel(),
                alpha_max_lr=float(da.max()) / arch_lr, launches=counts,
                card_s=c_s, cpu_s=p_s, cpu_f64_s=f_s, card=c_info,
                cpu=p_info)


def nas_rounds_card_cpu() -> dict:
    """One round of each search mode in the micro space (2 clients x 2
    batches of 8: one alpha and one w step each), and of the first-order
    and GDAS modes at full width (one client, a train and a validation
    batch of 1: one step), card against CPU (nas_card_cpu's limits), with
    exact launch counts.  The second order at full width is held by the
    micro rounds, the correction check and the path's launches: its f32
    and f64 steps take about a minute of the CPU."""
    out = {}
    for width, space, clients, bs, step_gn, modes in (
            ("micro", NAS_MICRO, 2, 8, NAS_MICRO_STEP_GN, NAS_MODES),
            ("full width", NAS_FULL, 1, 1, NAS_STEP_GN,
             ("first_order", "gdas"))):
        data = zoo_data("cifar10", clients, 2 * bs, bs, seed=22)
        for mode in modes:
            def run(device, dtype, grads, mode=mode):
                eng = nas_engine(data, mode, device, **space)
                record_arch_grads(eng, grads)
                params, alphas = eng.init_state(
                    torch.Generator().manual_seed(1))
                p0 = eng.net.flatten(params).to(dtype)
                a0 = eng.flatten_alphas(alphas).to(dtype)
                cohort, r = eng._round_args(0)
                cohort = {k: v.to(dtype) if v.is_floating_point() else v
                          for k, v in cohort.items()}
                p1, a1, m = eng.round_fn(p0, a0, cohort, r)
                return p0, a0, p1, a1, f"train_loss {float(m['train_loss']):.6f}"
            fwd, bwd = step_gn[mode]
            out[f"{mode} {width}"] = nas_card_cpu(
                f"FedNAS {mode} round ({width}, {clients} client(s) x 2 "
                f"batches of {bs})", run,
                {"gn_forward": clients * fwd, "gn_backward": clients * bwd,
                 "wsum": 1})
    return out


def nas_path_expected(eval_batches: int, retrain_gn: int, retrain_steps: int,
                      retrain_eval_batches: int) -> dict:
    """The FedNAS path's launches: every search round's steps (its clients
    x NAS_BATCHES / 2 steps) and evaluation, one fold a round; the retrain
    round's steps, its evaluation, its fold, with `retrain_gn` GroupNorm
    layers a forward (the derived genotype's count: 2 for a separable
    conv, 1 for a dilated conv or a stride-2 skip, none for a pool or a
    stride-1 skip; DARTS_V2's net has 239)."""
    fwd = bwd = folds = 0
    for mode, rounds, clients in NAS_PATH_ROUNDS:
        steps = clients * NAS_BATCHES // 2
        f, b = NAS_STEP_GN[mode]
        fwd += rounds * (steps * f + eval_batches * NAS_GN_FORWARD)
        bwd += rounds * steps * b
        folds += rounds
    fwd += retrain_gn * (retrain_steps + retrain_eval_batches)
    bwd += retrain_gn * retrain_steps
    return {"gn_forward": fwd, "gn_backward": bwd, "wsum": folds + 1,
            "sqnorm": 0, "clip_agg": 0}


def gn_shape_hooks(model: torch.nn.Module, seen: set) -> list:
    """Forward pre-hooks on `model`'s GroupNorm layers that add each call's
    (input shape, groups) to `seen`; returns their handles."""
    def hook(mod, args):
        seen.add((tuple(args[0].shape), mod.num_groups))
    return [m.register_forward_pre_hook(hook) for m in model.modules()
            if isinstance(m, GroupNorm)]


def phase_fednas_path() -> dict:
    """The slice's path: FedNAS at the published DARTS widths
    (DartsSearchNetwork C 16, 8 cells, 4 steps), f32, on NAS_CLIENTS
    CIFAR-10-shaped clients of NAS_BATCHES batches of 32 (the interleaved
    split: a train and a validation batch each), the published
    optimizers (w: clip 5, wd 3e-4, SGD lr 0.025 momentum 0.9; alphas:
    Adam 3e-4, b1 0.5, wd 1e-3): NAS_PATH_ROUNDS (1 first-order round on 2
    of the clients, 1 exact second-order round on 1, 1 GDAS round on 2),
    each with an evaluation; the derived genotype; then make_train_engine(genotype, C
    36, 20 layers) on the same clients, one FedAvg round and an
    evaluation.  TF32 is off (the caller's f32_off).  Exact launch counts
    over the whole path; s/round by mode; every (shape, groups) its
    GroupNorm layers ran at; a profiled first-order step of one client for
    the busy share."""
    t_build = time.perf_counter()
    data = synthetic_data(NAS_CLIENTS, NAS_BATCHES * BATCH, seed=0)
    engines = {m: nas_engine(data, m, lr=NAS_LR, per_round=clients)
               for m, _, clients in NAS_PATH_ROUNDS}
    if engines["first_order"].net.spec.n != NAS_PARAMS:
        raise AssertionError(f"supernet has {engines['first_order'].net.spec.n}"
                             " params")
    params, alphas = engines["first_order"].init_state()
    p0 = engines["first_order"].net.flatten(params)
    a0 = engines["first_order"].flatten_alphas(alphas)
    totals = {"round_fn": 0.0}
    per_mode = {}
    gn_seen = set()
    hooks = [h for eng in engines.values()
             for h in gn_shape_hooks(eng.net.model, gn_seen)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t_path = time.perf_counter()
    build_s = t_path - t_build
    for mode, rounds, clients in NAS_PATH_ROUNDS:
        eng = engines[mode]
        before = totals["round_fn"]
        timed_phase(eng, "round_fn", totals)
        params, alphas = eng.run(rounds=rounds, params=params, alphas=alphas)
        delattr(eng, "round_fn")
        per_mode[mode] = dict(s_per_round=(totals["round_fn"] - before) / rounds,
                              clients=clients,
                              history=eng.metrics_history[-rounds:])
    genotype = engines["gdas"].genotype(alphas)
    search_s = time.perf_counter() - t_path
    cfg = FedConfig(dataset="cifar10", client_num_in_total=NAS_CLIENTS,
                    client_num_per_round=NAS_CLIENTS, epochs=1,
                    batch_size=BATCH, lr=NAS_LR, frequency_of_the_test=1)
    retrain = make_train_engine(genotype, data, cfg, C=RETRAIN_C,
                                layers=RETRAIN_LAYERS)
    v0 = retrain.init_variables()
    hooks += gn_shape_hooks(retrain.trainer.model, gn_seen)
    t0 = time.perf_counter()
    v1 = retrain.run(variables=dict(v0), rounds=1)
    torch.cuda.synchronize()
    retrain_s = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for h in hooks:
        h.remove()
    eval_batches = data.test_global["mask"].shape[0]
    retrain_eval = sum(s["mask"].shape[0] for s in (data.train_global,
                                                    data.test_global))
    retrain_gn = sum(isinstance(m, GroupNorm)
                     for m in retrain.trainer.model.modules())
    expected = nas_path_expected(eval_batches, retrain_gn,
                                 NAS_CLIENTS * NAS_BATCHES, retrain_eval)
    if counts != expected:
        raise AssertionError(f"FedNAS path: launches {counts} != {expected}")
    p1 = engines["gdas"].net.flatten(params)
    a1 = engines["gdas"].flatten_alphas(alphas)
    if torch.equal(p0, p1) or torch.equal(a0, a1):
        raise AssertionError("FedNAS path: the weights or the alphas never moved")
    history = [h for m in per_mode.values() for h in m["history"]]
    if not all(math.isfinite(h["train_loss"]) and 0 <= h["test_acc"] <= 1
               for h in history + retrain.metrics_history):
        raise AssertionError(f"FedNAS path: bad metrics {history} "
                             f"{retrain.metrics_history}")
    for gene in (genotype.normal, genotype.reduce):
        if len(gene) != 8 or any(op == "none" for op, _ in gene):
            raise AssertionError(f"FedNAS path: bad genotype {genotype}")
    same = [k for k in v0 if torch.equal(v0[k], v1[k])]
    if same:
        raise AssertionError(f"FedNAS retrain: leaves unchanged {same}")
    n_retrain = retrain.trainer.n_params
    print(f"[fednas path] FedNASSearchEngine, DartsSearchNetwork (C 16, 8 "
          f"cells, {NAS_PARAMS} params, {NAS_GN_FORWARD} GroupNorm layers), "
          f"f32 with TF32 off, {NAS_CLIENTS} clients x {NAS_BATCHES} batches "
          f"of {BATCH} (the second-order round on "
          f"{dict((m, c) for m, _, c in NAS_PATH_ROUNDS)['unrolled']} of "
          f"them); peak device "
          f"memory {peak} B; GroupNorm ran at {len(gn_seen)} (shape, groups) "
          f"({card_line()})")
    for mode, rec in per_mode.items():
        print(f"[fednas path] {mode} ({rec['clients']} clients): s/round "
              f"{rec['s_per_round']:.4f}; "
              + "; ".join(f"round {h['round']} train_loss "
                          f"{h['train_loss']:.6f} test_acc {h['test_acc']:.4f}"
                          for h in rec["history"]))
    print(f"[fednas path] genotype {genotype}")
    print(f"[fednas path] retrain: DartsNetwork(genotype, C {RETRAIN_C}, "
          f"{RETRAIN_LAYERS} layers, {n_retrain} params, {retrain_gn} "
          f"GroupNorm layers), one FedAvg round "
          f"{retrain_s:.4f} s (with its evaluation); "
          f"{retrain.metrics_history[-1]}")
    print(f"[fednas path] launches {counts} == expected; search "
          f"{search_s:.1f} s")
    # the busy share from one first-order step of one client (a train and
    # a validation batch: the unit every round repeats; a whole round's
    # trace takes minutes to read)
    eng = engines["first_order"]
    p, a = eng.net.flatten(params), eng.flatten_alphas(alphas)
    shard = {k: torch.as_tensor(v[0, :2]).to(eng.device)
             for k, v in data.client_shards.items()}
    one = lambda: eng._local_search(p, a, shard, 1,
                                    torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one()
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prof = profile_round(one, one_s, tag="fednas path, 1 step")
    profile_s = time.perf_counter() - t0
    print(f"[fednas path] command time: engines and init {build_s:.1f} s, "
          f"search {search_s:.1f} s, retrain round {retrain_s:.1f} s, the "
          f"profiled step {profile_s:.1f} s")
    return dict(seconds=dict(build=build_s, search=search_s,
                             retrain=retrain_s, profile=profile_s),per_mode={k: v["s_per_round"] for k, v in per_mode.items()},
                history=history, genotype=str(genotype),
                retrain=dict(s=retrain_s, params=n_retrain, gn_layers=retrain_gn,
                             metrics=retrain.metrics_history[-1]),
                launches=counts, expected=expected, peak_bytes=peak,
                one_step_s=one_s, gn_shapes=sorted(gn_seen),
                profile={k: v for k, v in prof.items() if k != "top"})


def phase_obs_card() -> dict:
    """The obs core on the card: one main-path round (MeshFedAvgEngine,
    bf16, chunk 2) at 2 clients x 2 batches with observability off, then
    on, from the same weights and with cuDNN's deterministic algorithms,
    bitwise equal; the exported Chrome trace loads and holds the round,
    eval and upload spans."""
    data = synthetic_data(2, 2 * BATCH, seed=3)
    cfg = FedConfig(model="resnet18_gn", dataset="cifar10",
                    client_num_in_total=2, client_num_per_round=2, epochs=1,
                    batch_size=BATCH, lr=0.1, frequency_of_the_test=1)

    def run():
        trainer = ClientTrainer(create_model("resnet18_gn", 10), lr=cfg.lr,
                                train_dtype=torch.bfloat16)
        eng = MeshFedAvgEngine(trainer, data, cfg, chunk=2,
                               local_dtype=torch.bfloat16)
        v = eng.run(variables=eng.init_variables(), rounds=1)
        torch.cuda.synchronize()
        return v, [{k: x for k, x in m.items() if k != "round_time"}
                   for m in eng.metrics_history]

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        v_off, m_off = run()
        with tempfile.TemporaryDirectory() as tmp:
            obs.configure(tmp, install_signal=False, export_at_exit=False)
            try:
                v_on, m_on = run()
                out = obs.export()
                doc = json.load(open(out["chrome_trace"]))
                roll = obs.rollup()
            finally:
                obs.reset()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    differ = [k for k in v_off if not torch.equal(v_off[k], v_on[k])]
    if differ or m_off != m_on:
        raise AssertionError(f"obs on/off: {len(differ)} leaves differ "
                             f"({differ[:3]}), metrics {m_off} vs {m_on}")
    spans = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X":
            spans[e["name"]] = spans.get(e["name"], 0) + 1
    for name in ("round", "eval", "h2d.upload_cohort"):
        if not spans.get(name):
            raise AssertionError(f"obs trace lacks {name!r}: {spans}")
    print(f"[obs] main path, 2 clients x 2 batches: obs on and off bitwise "
          f"equal ({len(v_off)} leaves, metrics {m_on}); the trace holds "
          f"{spans}; rollup {roll}")
    return dict(spans=spans, rollup=roll)


def phase_slice7a_ii(gen: torch.Generator) -> dict:
    """Phase 15, f32 with TF32 off throughout (restored after): the
    GroupNorm double backward, the second-order correction, the search
    modes card against CPU, the FedNAS path, then both GroupNorm kernels
    at every (shape, groups) the path ran them at, and the obs core; each
    part's seconds of command time."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    f32_off()
    rec, seconds = {}, {}
    try:
        for key, part in (
                ("gn_double_backward", lambda: gn_double_backward_card(gen)),
                ("arch_correction", arch_correction_card),
                ("rounds", nas_rounds_card_cpu),
                ("fednas_path", phase_fednas_path),
                ("gn_shapes", lambda: gn_new_shapes(
                    gen, rec["fednas_path"]["gn_shapes"], "slice 7a-ii")),
                ("obs", phase_obs_card)):
            t0 = time.perf_counter()
            rec[key] = part()
            seconds[key] = time.perf_counter() - t0
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    rec["seconds"] = seconds
    print(f"[slice 7a-ii] phase 15 took {sum(seconds.values()):.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    return rec


# ---------------------------------------------------------------------------
# slice 5b-i: the wire core and message-driven FedAvg
# ---------------------------------------------------------------------------

MSG_ROUNDS = 1                 # phase 16 (cut from 2 to hold the script's time)
MSG_BACKENDS = ("INPROC", "TCP", "NATIVE_TCP")
MSG_F32_CLIENTS, MSG_F32_BATCHES = 4, 4       # the f32 FedAvg check
SPLIT_CLIENTS, SPLIT_BATCHES = 2, 4
MSG_SPANS = ("fsm.local_train", "comm.decode", "fsm.aggregate")


def free_base_port(n: int) -> int:
    """A base port p with p .. p + n - 1 free: p from a socket bound to
    port 0, the rest checked."""
    for _ in range(50):
        socks = []
        try:
            s = socket.socket()
            socks.append(s)
            s.bind(("0.0.0.0", 0))
            base = s.getsockname()[1]
            if base + n > 65535:
                continue
            for r in range(1, n):
                t = socket.socket()
                socks.append(t)
                t.bind(("0.0.0.0", base + r))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no {n} consecutive free ports")


def backend_kw(backend: str, size: int) -> dict:
    """The comm backend's arguments for `size` ranks on this host: TCP is
    the Python transport on the reactor, NATIVE_TCP the C++ one."""
    if backend == "INPROC":
        return {}
    kw = dict(ip_config={r: "127.0.0.1" for r in range(size)},
              base_port=free_base_port(size))
    if backend == "TCP":
        kw.update(force_python_tcp=True, reactor=True)
    return kw


def row_layout(tree: dict, key: str) -> SimpleNamespace:
    """decode_into's row layout of a flat {name: tensor} tree."""
    off, offsets = 0, {}
    for name, t in tree.items():
        offsets[f"/{key}/{name}"] = (off, t.numel(), tuple(t.shape))
        off += t.numel()
    return SimpleNamespace(key=key, p=off, offsets=offsets)


def codec_full_width() -> dict:
    """The codec on ResNet-18-GN's variables, taken from the card in f32 and
    bf16: v1 bitwise, the bf16 transport equal to the card's .to(bf16), int8
    within its affine half-step, sparse_topk keeping exactly its k largest
    entries, encode_parts joining to encode; bytes and MB/s of encode (card
    to frame, the copy to the host included) and decode."""
    trainer = ClientTrainer(create_model("resnet18_gn", 10), lr=0.1)
    f32 = trainer.init(torch.Generator().manual_seed(5), "cuda")
    trees = {"f32": f32, "bf16": {k: v.to(torch.bfloat16)
                                  for k, v in f32.items()}}
    host = {k: {n: v.cpu() for n, v in t.items()} for k, t in trees.items()}
    rec = {}

    def frame(tree, kind=None):
        m = Message(3, 1, 0)
        m.add_params("model_params", tree)
        if kind:
            m.set_wire_transport("model_params", kind)
        return m

    def timed(fn, reps=3):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        return out, (time.perf_counter() - t0) / reps

    for dtype, tree in trees.items():
        payload, enc_s = timed(lambda: MessageCodec.encode(frame(tree)))
        msg, dec_s = timed(lambda: MessageCodec.decode(payload))
        got = msg.get("model_params")
        bad = [k for k in tree if got[k].dtype != tree[k].dtype
               or not torch.equal(got[k], host[dtype][k])]
        if bad:
            raise AssertionError(f"codec v1 {dtype}: {len(bad)} leaves not "
                                 f"bitwise ({bad[:3]})")
        total, parts = MessageCodec.encode_parts(frame(tree))
        if b"".join(parts) != payload or total != len(payload):
            raise AssertionError(f"codec {dtype}: encode_parts != encode")
        row = torch.empty(sum(t.numel() for t in tree.values()))
        layout = row_layout(tree, "model_params")
        _, into_s = timed(lambda: MessageCodec.decode_into(payload, row,
                                                           layout))
        if not torch.equal(row, torch.cat([host[dtype][k].reshape(-1).float()
                                           for k in tree])):
            raise AssertionError(f"codec {dtype}: decode_into != decode")
        mb = len(payload) / 1e6
        rec[f"v1_{dtype}"] = dict(bytes=len(payload), encode_s=enc_s,
                                  decode_s=dec_s, decode_into_s=into_s,
                                  encode_mb_s=mb / enc_s,
                                  decode_mb_s=mb / dec_s,
                                  decode_into_mb_s=mb / into_s)
    payload, enc_s = timed(lambda: MessageCodec.encode(frame(f32, "bf16")))
    got, dec_s = timed(lambda: MessageCodec.decode(payload).get(
        "model_params"))
    bad = [k for k in f32 if not torch.equal(
        got[k], f32[k].to(torch.bfloat16).float().cpu())]
    if bad:
        raise AssertionError(f"bf16 transport != the card's .to(bfloat16) on "
                             f"{len(bad)} leaves ({bad[:3]})")
    rec["bf16_transport"] = dict(bytes=len(payload), encode_s=enc_s,
                                 decode_s=dec_s,
                                 encode_mb_s=len(payload) / 1e6 / enc_s)
    payload, enc_s = timed(lambda: MessageCodec.encode(frame(f32, "int8")))
    got = MessageCodec.decode(payload).get("model_params")
    worst = 0.0
    for k, v in host["f32"].items():
        x = v.double()
        step = max((float(x.max()) - float(x.min())) / 255.0, 0.0) or 1.0
        err = float((got[k].double() - x).abs().max())
        limit = 0.5 * step * (1 + 1e-6) + 2.0 ** -23 * float(x.abs().max())
        if err > limit:
            raise AssertionError(f"int8 transport {k}: max error {err:.3e} "
                                 f"beyond half a step {0.5 * step:.3e}")
        worst = max(worst, err / step)
    rec["int8_transport"] = dict(bytes=len(payload), encode_s=enc_s,
                                 worst_err_in_steps=worst)
    payload, enc_s = timed(lambda: MessageCodec.encode(frame(f32,
                                                             "sparse_topk")))
    layout = row_layout(f32, "model_params")
    _, idx, vals = MessageCodec.decode_sparse(payload, layout)
    flat = torch.cat([host["f32"][k].reshape(-1) for k in f32])
    want_k, off = 0, 0
    for k, v in host["f32"].items():
        n = v.numel()
        kk = max(1, n // 16)
        if kk >= n:
            raise AssertionError(f"sparse_topk: leaf {k} of {n} rides exact")
        sel = idx[(idx >= off) & (idx < off + n)] - off
        mag = v.reshape(-1).abs()
        kept = torch.zeros(n, dtype=torch.bool)
        kept[sel] = True
        if sel.numel() != kk or (kept.any() and (~kept).any() and float(
                mag[kept].min()) < float(mag[~kept].max())):
            raise AssertionError(f"sparse_topk {k}: kept {sel.numel()} of "
                                 f"k={kk}, or not the largest")
        want_k, off = want_k + kk, off + n
    if idx.numel() != want_k or not torch.equal(vals, flat[idx]):
        raise AssertionError("sparse_topk: the kept values are not the model's")
    rec["sparse_topk"] = dict(bytes=len(payload), encode_s=enc_s, k=want_k)
    line = card_line()
    print(f"[codec] ResNet-18-GN ({N_PARAMS} params), encode from the card "
          f"and decode on the host ({line}):")
    for key, r in rec.items():
        print(f"[codec]   {key}: {r['bytes']} B"
              + (f", encode {r['encode_mb_s']:.1f} MB/s" if "encode_mb_s" in r
                 else f", encode {r['encode_s'] * 1e3:.1f} ms")
              + (f", decode {r['decode_mb_s']:.1f} MB/s, decode_into "
                 f"{r['decode_into_mb_s']:.1f} MB/s" if "decode_mb_s" in r
                 else ""))
    print(f"[codec] v1 bitwise (f32, bf16), decode_into == decode, bf16 "
          f"transport == .to(bfloat16) on the card, int8 within "
          f"{worst:.4f} of a step (limit 0.5), sparse_topk kept exactly "
          f"{want_k} entries, each leaf's largest ({line})")
    return rec


def span_seconds(names) -> dict:
    """Summed host seconds of each named span in the tracer (all threads)."""
    out = {n: 0.0 for n in names}
    for e in obs.tracer().events():
        if e.get("ph") == "X" and e["name"] in out:
            out[e["name"]] += e["dur"] / 1e6
    return out


def messaging_run(trainer, data, cfg, backend: str, v0: dict, **kw) -> dict:
    """One run_messaging_fedavg on the card under tracing: the final
    variables, the launches it made (counted from zero), wire bytes, its
    rounds' walls and span seconds, and each round's global model."""
    sent = lambda: sum(obs.registry().counter(
        "comm_sent_bytes_total", backend=b).value
        for b in ("inproc", "tcp", "native_tcp"))
    marks, models = [], []

    def on_round(idx, variables):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        models.append({k: v.clone() for k, v in variables.items()})

    with tempfile.TemporaryDirectory() as tmp:
        obs.configure(tmp, install_signal=False, export_at_exit=False)
        try:
            b0 = sent()
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            out = run_messaging_fedavg(trainer, data, cfg, backend=backend,
                                       variables=v0, on_round_done=on_round,
                                       timeout=600, **kw,
                                       **backend_kw(backend,
                                                    cfg.client_num_per_round
                                                    + 1))
            torch.cuda.synchronize()
            counts = launch_counts()
            wall = time.perf_counter() - t0
            spans = span_seconds(MSG_SPANS)
            wire = sent() - b0
        finally:
            obs.reset()
    rounds = [b - a for a, b in zip([t0] + marks[:-1], marks)]
    return dict(variables=out, launches=counts, wire_bytes=wire,
                round_s=rounds, wall_s=wall, spans=spans, models=models)


def messaging_path() -> dict:
    """run_messaging_fedavg on the main path's recipe (ResNet-18-GN at full
    width, 8 clients of 13 batches of 32, one epoch of SGD at lr 0.1, bf16
    compute and local masters), MSG_ROUNDS rounds over each backend, each
    client a FedAvgClientManager thread: launches exact, s/round beside
    FedAvgEngine on the same clients, wire bytes, the spans' shares; then one
    round with the bf16 downlink against the exact first round."""
    data = synthetic_data(MAIN_CLIENTS, SAMPLES, seed=0)
    cfg = FedConfig(model="resnet18_gn", dataset="cifar10",
                    client_num_in_total=MAIN_CLIENTS,
                    client_num_per_round=MAIN_CLIENTS, epochs=1,
                    batch_size=BATCH, lr=0.1, comm_round=MSG_ROUNDS,
                    frequency_of_the_test=10_000)
    trainer = ClientTrainer(create_model("resnet18_gn", 10), lr=cfg.lr,
                            train_dtype=torch.bfloat16)
    v0 = trainer.init(torch.Generator().manual_seed(cfg.seed), "cuda")
    steps = MSG_ROUNDS * MAIN_CLIENTS * BATCHES
    expected = {"gn_forward": 20 * steps, "gn_backward": 20 * steps,
                "wsum": MSG_ROUNDS, "sqnorm": 0, "clip_agg": 0}
    engine = FedAvgEngine(trainer, data, cfg)
    engine_s, v, state = [], dict(v0), engine.server_init(v0)
    for r in range(MSG_ROUNDS):
        t0 = time.perf_counter()
        v, state, m = engine.round_fn(v, state, *engine._round_args(r))
        float(m["train_loss"])
        engine_s.append(time.perf_counter() - t0)
    line = card_line()
    runs = {}
    for backend in MSG_BACKENDS:
        run = messaging_run(trainer, data, cfg, backend, dict(v0),
                            local_dtype=torch.bfloat16)
        if run["launches"] != expected:
            raise AssertionError(f"messaging {backend}: launches "
                                 f"{run['launches']} != expected {expected}")
        bad = [k for k, t in run["variables"].items()
               if not torch.isfinite(t).all() or t.dtype != torch.float32]
        same = [k for k in v0 if torch.equal(run["variables"][k], v0[k])]
        if bad or len(same) == len(v0):
            raise AssertionError(f"messaging {backend}: {len(bad)} leaves not "
                                 f"finite f32, {len(same)} unchanged")
        share = {n: s / run["wall_s"] for n, s in run["spans"].items()}
        runs[backend] = run
        print(f"[messaging] {backend}: s/round {run['round_s']} (FedAvgEngine "
              f"on the same clients {engine_s}); wire "
              f"{run['wire_bytes'] / MSG_ROUNDS:.0f} B a round; span seconds "
              "over the run's wall: " + ", ".join(
                  f"{n} {s:.3f}" for n, s in share.items())
              + f" (the client spans overlap: {MAIN_CLIENTS} threads); launches "
              f"{run['launches']} == expected ({line})")
    # the bf16 downlink: one round from the same init; the clients' bf16
    # masters round the f32 downlink to the same values
    frames = {}

    class Capture(InProcRouter):
        def route(self, msg):
            n = super().route(msg)
            if msg.get_type() == MyMessage.MSG_TYPE_S2C_INIT_CONFIG:
                frames.setdefault(msg.wire_transport.get(
                    MyMessage.MSG_ARG_KEY_MODEL_PARAMS, "exact"), []).append(n)
            return n

    one = dataclasses.replace(cfg, comm_round=1)
    results = {}
    for transport in (None, "bf16"):
        results[transport] = run_messaging_fedavg(
            trainer, data, one, variables=dict(v0), router=Capture(),
            model_transport=transport, local_dtype=torch.bfloat16,
            timeout=600)
    whole, worst = update_distance("bf16 downlink", v0, results["bf16"],
                                   {k: t.cpu() for k, t in v0.items()},
                                   {k: t.cpu() for k, t in
                                    results[None].items()})
    bitwise = all(torch.equal(results["bf16"][k], results[None][k])
                  for k in v0)
    down = {k: sum(v) / len(v) for k, v in frames.items()}
    ratio = down["bf16"] / down["exact"]
    print(f"[messaging] bf16 downlink: {down['bf16']:.0f} B a client against "
          f"{down['exact']:.0f} ({ratio:.4f}); the round's update "
          f"{whole:.3e} of its norm from the exact round's (limit 1e-3), "
          f"worst leaves " + ", ".join(f"{k} {v:.3e}" for k, v in worst)
          + f" (limit 1e-2); bitwise {bitwise} ({line})")
    if whole > 1e-3 or worst[0][1] > 1e-2 or not 0.49 < ratio < 0.51:
        raise AssertionError("bf16 downlink: bytes not halved, or the round "
                             "beyond phase 4's limits of the exact round")
    return dict(engine_s=engine_s, expected=expected, fold=messaging_fold(),
                runs={b: {k: v for k, v in r.items()
                          if k not in ("variables", "models")}
                      for b, r in runs.items()},
                bf16_downlink=dict(bytes=down, ratio=ratio, distance=whole,
                                   worst=worst, bitwise=bitwise))


def messaging_fold() -> dict:
    """The messaging server's fold: the finalize form over the [8, P] bf16
    upload rows into a new f32 model, against its plain version (within
    1e-6 of sum_k |w_k v_k| / sum(w)), timed beside its byte bound and
    the library's matrix-vector product."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    V = torch.randn(MAIN_CLIENTS, P_PADDED, generator=gen,
                    device="cuda").to(torch.bfloat16)
    w = torch.full((MAIN_CLIENTS,), float(SAMPLES), device="cuda")
    got, want = weighted_mean_flat(V, w), weighted_mean_flat_plain(V, w)
    scale = (w[:, None] * V.float()).abs().sum(0) / w.sum()
    err = float((got - want).abs().max())
    if not bool(((got - want).abs() <= 1e-6 * scale + 1e-12).all()):
        raise AssertionError(f"messaging fold: max abs err {err:.3e}")
    rec = dict(shape=[MAIN_CLIENTS, P_PADDED], dtype="bfloat16",
               max_abs_err=err,
               ms=cuda_ms(lambda: weighted_mean_flat(V, w)),
               plain_ms=cuda_ms(lambda: weighted_mean_flat_plain(V, w)),
               library_ms=cuda_ms(lambda: (w @ V.float()) / w.sum()),
               bound=bound_ms(MAIN_CLIENTS * P_PADDED * 2 + P_PADDED * 4
                              + MAIN_CLIENTS * 4, 2 * MAIN_CLIENTS * P_PADDED))
    print(f"[kernel] wsum finalize [{MAIN_CLIENTS}, {P_PADDED}] bf16 -> f32 "
          f"(the messaging server's fold): max abs err {err:.3e}; "
          f"{rec['ms'] * 1e3:.2f} us, plain {rec['plain_ms'] * 1e3:.2f} us, "
          f"library ((w @ V.float()) / w.sum()) {rec['library_ms'] * 1e3:.2f} "
          f"us, bound {rec['bound'][0] * 1e3:.2f} us ({rec['bound'][1]}) "
          f"({card_line()})")
    return rec


def messaging_f32_is_fedavg() -> dict:
    """One f32 round over TCP against one FedAvgEngine round on the card,
    from the same init, TF32 off and cuDNN's deterministic algorithms: the
    updates within 1e-6 of the update's norm."""
    data = synthetic_data(MSG_F32_CLIENTS, MSG_F32_BATCHES * BATCH, seed=4)
    cfg = FedConfig(model="resnet18_gn", dataset="cifar10",
                    client_num_in_total=MSG_F32_CLIENTS,
                    client_num_per_round=MSG_F32_CLIENTS, epochs=1,
                    batch_size=BATCH, lr=0.1, comm_round=1,
                    frequency_of_the_test=10_000)
    trainer = ClientTrainer(create_model("resnet18_gn", 10), lr=cfg.lr)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        engine = FedAvgEngine(trainer, data, cfg)
        v0 = engine.init_variables()
        v_engine = engine.run(variables=dict(v0), rounds=1)
        v_msg = run_messaging_fedavg(trainer, data, cfg, backend="TCP",
                                     variables=dict(v0), timeout=600,
                                     **backend_kw("TCP", MSG_F32_CLIENTS + 1))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    whole, worst = update_distance(
        "f32 messaging", v0, v_msg, {k: t.cpu() for k, t in v0.items()},
        {k: t.cpu() for k, t in v_engine.items()})
    bitwise = all(torch.equal(v_msg[k], v_engine[k]) for k in v0)
    print(f"[messaging] f32 round over TCP vs FedAvgEngine ({MSG_F32_CLIENTS} "
          f"clients x {MSG_F32_BATCHES} batches, full width, TF32 off): update "
          f"distance {whole:.3e} of its norm (limit 1e-6); bitwise {bitwise} "
          f"({card_line()})")
    if whole > 1e-6:
        raise AssertionError("f32 messaging round is not the FedAvgEngine "
                             "round within 1e-6")
    return dict(distance=whole, bitwise=bitwise)


def split_shards(seed: int) -> dict:
    rs = np.random.RandomState(seed)
    return {"x": rs.rand(SPLIT_BATCHES, BATCH, 28, 28, 1).astype(np.float32),
            "y": rs.randint(0, 10, (SPLIT_BATCHES, BATCH)).astype(np.int64),
            "mask": np.ones((SPLIT_BATCHES, BATCH), np.float32)}


def split_run(device, backend: str, init: tuple) -> dict:
    """Remote SplitNN (split_cnn, SPLIT_CLIENTS clients, one epoch) on
    `device` over `backend`: the server's and every client's final
    params, the validation history, and the order in which the server
    trained the batches (a CRC of each train batch's labels)."""
    lower, upper = split_cnn()
    ccomp = SplitClientCompute(lower, lr=0.1, device=device)
    scomp = SplitServerCompute(upper, lr=0.1, device=device)
    order, train_step = [], scomp.train_step

    def traced_step(params, opt_state, acts, y, mask):
        order.append(zlib.crc32(torch.as_tensor(y).cpu().numpy().tobytes()))
        return train_step(params, opt_state, acts, y, mask)

    scomp.train_step = traced_step
    kw = (dict(router=InProcRouter()) if backend == "INPROC"
          else backend_kw(backend, SPLIT_CLIENTS + 1))
    sp, sopt = scomp.init(params=init[1])
    server = SplitNNServerManager(scomp, sp, sopt, max_rank=SPLIT_CLIENTS,
                                  backend=backend, **kw)
    clients = []
    for r in range(1, SPLIT_CLIENTS + 1):
        cp, copt = ccomp.init(params=init[0])
        clients.append(SplitNNClientManager(
            ccomp, cp, copt, split_shards(r), split_shards(100 + r), rank=r,
            max_rank=SPLIT_CLIENTS, epochs=1, backend=backend, **kw))
    try:
        for m in [server] + clients:
            m.run_async()
        clients[0].start_protocol()
        if not server.done.wait(timeout=300):
            raise AssertionError(f"split {device} {backend}: protocol hung")
    finally:
        for m in clients + [server]:
            m.finish()
    return dict(server=server.params, clients=[c.params for c in clients],
                history=server.val_history, order=order)


def split_card_cpu() -> dict:
    """Remote SplitNN on the card over INPROC and TCP, twice each, against
    the same protocol on the CPU, f32 (TF32 off) with cuDNN's
    deterministic algorithms: each run within phase 4's limits of the CPU,
    a backend's two runs bitwise equal, and the server training the
    batches in the CPU's order.  (Without the deterministic algorithms a
    run read up to 2.1e-4 of a client's update from the CPU: cuDNN's
    nondeterministic weight gradient, grown by SGD momentum; ROADMAP
    C.11.)"""
    lower, upper = split_cnn()
    g = torch.Generator().manual_seed(6)
    init = (FlatModel(lower).init(g, "cpu"), FlatModel(upper).init(g, "cpu"))
    cpu = split_run("cpu", "INPROC", init)
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for backend in ("INPROC", "TCP"):
            cards = [split_run("cuda", backend, init) for _ in range(2)]
            dists = {}
            for name, (g1, c1, g0) in {
                    "server": (cards[0]["server"], cpu["server"], init[1]),
                    **{f"client{i + 1}": (cards[0]["clients"][i],
                                          cpu["clients"][i], init[0])
                       for i in range(SPLIT_CLIENTS)}}.items():
                dists[name] = update_distance(f"split {backend} {name}", g0,
                                              g1, g0, c1)
            whole = max(d[0] for d in dists.values())
            leaf = max(d[1][0][1] for d in dists.values())
            again = [(part, k) for part in ("server", "clients")
                     for a, b in ([(cards[0][part], cards[1][part])]
                                  if part == "server" else
                                  zip(cards[0][part], cards[1][part]))
                     for k in a if not torch.equal(a[k], b[k])]
            same_order = cards[0]["order"] == cards[1]["order"] == cpu["order"]
            print(f"[split] split_cnn over {backend} on the card vs the CPU, "
                  f"cuDNN deterministic: updates {whole:.3e} of their norms "
                  f"(limit 1e-3), worst leaf {leaf:.3e} (limit 1e-2); the "
                  f"second run bitwise the first: {not again}; the server's "
                  f"batch order the CPU's: {same_order}; val_acc card "
                  f"{[h['val_acc'] for h in cards[0]['history']]} CPU "
                  f"{[h['val_acc'] for h in cpu['history']]} ({card_line()})")
            if whole > 1e-3 or leaf > 1e-2 or again or not same_order:
                raise AssertionError(
                    f"remote SplitNN over {backend}: the card beyond phase "
                    f"4's limits of the CPU, {len(again)} leaves differ "
                    f"between two runs ({again[:3]}), or the batch order "
                    "differs")
            out[backend] = dict(distance=whole, worst_leaf=leaf,
                                repeat_bitwise=not again)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return out


def phase_slice5b_i() -> dict:
    """Phase 16: the codec at full width, the messaging path over three
    backends, the f32 messaging round against FedAvgEngine, the bf16
    downlink, and remote SplitNN card against CPU; each part's seconds."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    rec, seconds = {}, {}
    try:
        for key, part in (("codec", codec_full_width),
                          ("messaging_path", messaging_path),
                          ("f32_round", lambda: (f32_off(),
                                                 messaging_f32_is_fedavg())[1]),
                          ("split", split_card_cpu)):
            t0 = time.perf_counter()
            rec[key] = part()
            seconds[key] = time.perf_counter() - t0
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    rec["seconds"] = seconds
    print(f"[slice 5b-i] phase 16 took {sum(seconds.values()):.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
          + f" ({card_line()})")
    return rec


# ---------------------------------------------------------------------------
# slice 5b-ii: chaos and reliability, MQTT, program timing, the observatory
# ---------------------------------------------------------------------------

# Every rank gets its own policy with this seed, as every process of a
# deployment reads one --chaos_seed.  On the chaos round's topology (4
# clients over Python TCP on threads) the server's receive streams 0-3 are
# the readers of its downlinks' acks and 4-7 the clients' uploads, and a
# client's stream 0 is its downlink: the first draws of streams 0-7 of
# this seed are drop, -, -, -, reorder, corrupt, dup, delay, so every kind
# fires once the round has run (drawn with numpy, the policy's generator).
CHAOS_SEED = 2210
CHAOS_RATES = dict(drop=0.05, dup=0.05, reorder=0.05, delay=0.05,
                   corrupt=0.02)
CHAOS_KINDS = tuple(CHAOS_RATES)
RELIABILITY_COUNTERS = ("comm_reliable_retries_total",
                        "comm_reliable_dups_suppressed_total",
                        "comm_frames_quarantined_total",
                        "comm_reliable_nacks_total",
                        "comm_reliable_abandoned_total")
MQTT_CLIENTS, MQTT_ROUNDS = 8, 2
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core rate
BUILDS = {}                    # phase 2's build counters (obs resets later)


def hardened_round(trainer, data, cfg, v0: dict, chaos: bool) -> dict:
    """One round of message-driven FedAvg over Python TCP on threads, the
    server, aggregator and clients built as run_messaging_fedavg builds
    them; with `chaos`, every rank hardened as a deployment's CLI does
    under --reliable --chaos_*: enable_reliability() and a ChaosPolicy of
    its own.  Traced and judged: returns the final variables, the launches
    the round made (counted from zero), its wall, the policies' summaries,
    the reliability counters, the critical path over the trace and the
    default SLO pack's report."""
    size = cfg.client_num_per_round + 1
    kw = dict(backend_kw("TCP", size), reactor=False)
    with tempfile.TemporaryDirectory() as tmp:
        obs.configure(tmp, install_signal=False, export_at_exit=False)
        try:
            judge = SloEngine(default_slo_pack())
            judge.prime()
            agg = FedAvgAggregator(v0, size - 1, cfg.client_num_in_total,
                                   size - 1)
            managers = [FedAvgServerManager(agg, cfg.comm_round, 0, size,
                                            "TCP", **kw)]
            managers += [FedAvgClientManager(trainer, data, cfg.epochs, r,
                                             size, "TCP", seed=cfg.seed, **kw)
                         for r in range(1, size)]
            policies = []
            if chaos:
                for m in managers:
                    if not m.com_manager.enable_reliability():
                        raise AssertionError("reliability refused on TCP")
                    policies.append(ChaosPolicy(ChaosConfig(
                        seed=CHAOS_SEED, **CHAOS_RATES)))
                    m.com_manager.install_chaos(policies[-1])
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            try:
                for m in managers[1:] + managers[:1]:
                    m.run_async()
                managers[0].send_init_msg()
                if not managers[0].done.wait(timeout=600):
                    raise AssertionError(f"hardened round (chaos {chaos}) "
                                         "did not finish in 600 s")
            finally:
                for m in managers[1:] + managers[:1]:
                    m.finish()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            path = timeline.critical_path(obs.tracer().events())
            verdict = judge.evaluate()
            counters = {n: obs.counter(n).value for n in RELIABILITY_COUNTERS}
        finally:
            obs.reset()
    injected = {}
    for p in policies:
        for k, v in p.summary().items():
            injected[k] = injected.get(k, 0) + v
    return dict(variables=agg.variables, launches=counts, wall_s=wall,
                injected=injected, counters=counters, critical_path=path,
                slo=verdict, seen=[m.rounds_seen for m in managers[1:]])


def chaos_round() -> dict:
    """17a and 17b: FedML's cross-silo deployment under faults at full
    width (ResNet-18-GN, f32, TF32 off, cuDNN deterministic) on phase 16's
    f32 clients, one round clean and one hardened under chaos from the
    same init: bitwise equal, the same launches (no client trained twice
    on a duplicate), every fault kind injected; the critical path of each
    trace finds the one round; the default SLO pack judges each."""
    data = synthetic_data(MSG_F32_CLIENTS, MSG_F32_BATCHES * BATCH, seed=4)
    cfg = FedConfig(model="resnet18_gn", dataset="cifar10",
                    client_num_in_total=MSG_F32_CLIENTS,
                    client_num_per_round=MSG_F32_CLIENTS, epochs=1,
                    batch_size=BATCH, lr=0.1, comm_round=1,
                    frequency_of_the_test=10_000)
    trainer = ClientTrainer(create_model("resnet18_gn", 10), lr=cfg.lr)
    v0 = trainer.init(torch.Generator().manual_seed(cfg.seed), "cuda")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {name: hardened_round(trainer, data, cfg, dict(v0), chaos)
                for name, chaos in (("clean", False), ("chaos", True))}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    clean, chaos = runs["clean"], runs["chaos"]
    line = card_line()
    steps = MSG_F32_CLIENTS * MSG_F32_BATCHES
    expected = {"gn_forward": 20 * steps, "gn_backward": 20 * steps,
                "wsum": 1, "sqnorm": 0, "clip_agg": 0}
    differ = [k for k in v0 if not torch.equal(chaos["variables"][k],
                                               clean["variables"][k])]
    for name, run in runs.items():
        cp = run["critical_path"]
        print(f"[chaos] {name}: {run['wall_s']:.3f} s for the round; "
              f"launches {run['launches']}; critical path "
              f"{cp['n_rounds']} round(s), stage shares "
              f"{cp.get('stage_share')}; default SLO pack: healthy "
              f"{run['slo']['healthy']}, breached {run['slo']['breached']} "
              f"({line})")
        if run["launches"] != expected or run["seen"] != [1] * MSG_F32_CLIENTS:
            raise AssertionError(f"chaos {name}: launches {run['launches']} "
                                 f"!= {expected} or rounds seen "
                                 f"{run['seen']}: a client trained twice")
        if cp["n_rounds"] != cfg.comm_round:
            raise AssertionError(f"chaos {name}: the critical path found "
                                 f"{cp['n_rounds']} rounds, ran "
                                 f"{cfg.comm_round}")
    missing = [k for k in CHAOS_KINDS if not chaos["injected"].get(k)]
    print(f"[chaos] seed {CHAOS_SEED}, rates {CHAOS_RATES}: injected "
          f"{chaos['injected']}; reliability {chaos['counters']}; clean "
          f"{clean['wall_s']:.3f} s/round, chaos {chaos['wall_s']:.3f} "
          f"s/round; {len(differ)} of {len(v0)} leaves differ from the clean "
          f"round ({line})")
    if differ or missing:
        raise AssertionError(f"chaos round: {len(differ)} leaves differ "
                             f"({differ[:3]}), kinds never injected "
                             f"{missing}")
    return {name: {k: v for k, v in run.items() if k != "variables"}
            for name, run in runs.items()}


def traced_run(eng, v0: dict, census: bool = False):
    """eng.run(variables=v0, rounds=1) with observability on (and the FLOP
    census): (variables, programs report of the run, builds in it)."""
    with tempfile.TemporaryDirectory() as tmp:
        obs.configure(tmp, install_signal=False, export_at_exit=False)
        programs.enable_census(census)
        try:
            snap = programs.snapshot()
            out = eng.run(variables=dict(v0), rounds=1)
            torch.cuda.synchronize()
            return (out, programs.report(snap, peak=BF16_FLOPS_PER_S),
                    obs.counter("kernel_build_total").value)
        finally:
            programs.enable_census(False)
            obs.reset()


def program_timing() -> dict:
    """17c: phase 5's MeshFedAvgEngine (chunk 2, bf16 masters) cut to 2
    clients and 1 round, and FedAvgEngine on the same clients, cuDNN
    deterministic.  Each engine runs its round three times from the same
    init: under the FLOP census (the first dispatch counted by
    FlopCounterMode), through the bare round function with observability
    off, and through the instrumented one with observability on.  All
    three bitwise equal; in the last, one dispatch for the family, its
    stream seconds positive and at most its host wall + 1 ms, MFU from the
    census's FLOPs; no native library built after phase 2."""
    data = synthetic_data(MAIN_CHUNK, SAMPLES, seed=0)
    cfg = FedConfig(model="resnet18_gn", dataset="cifar10",
                    client_num_in_total=MAIN_CHUNK,
                    client_num_per_round=MAIN_CHUNK, epochs=1,
                    batch_size=BATCH, lr=0.1, frequency_of_the_test=10_000)
    trainer = ClientTrainer(create_model("resnet18_gn", 10), lr=cfg.lr,
                            train_dtype=torch.bfloat16)
    engines = (MeshFedAvgEngine(trainer, data, cfg, chunk=MAIN_CHUNK,
                                local_dtype=torch.bfloat16),
               FedAvgEngine(trainer, data, cfg))
    line = card_line()
    rec = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    obs.reset()
    try:
        for eng in engines:
            v0 = eng.init_variables()
            counted, census, census_builds = traced_run(eng, v0, census=True)
            wrapped = eng.round_fn
            eng.round_fn = wrapped.inner
            try:
                off = eng.run(variables=dict(v0), rounds=1)
            finally:
                eng.round_fn = wrapped
            torch.cuda.synchronize()
            on, rep, builds = traced_run(eng, v0)
            row = next(r for r in rep["families"]
                       if r["family"] == eng.program_family)
            crow = next(r for r in census["families"]
                        if r["family"] == eng.program_family)
            differ = [k for k in v0 if not (torch.equal(off[k], on[k])
                                            and torch.equal(off[k],
                                                            counted[k]))]
            print(f"[programs] {type(eng).__name__} ({eng.program_family}, "
                  f"stage {row['stage']}): {row['dispatches']} dispatch, host "
                  f"wall {row['dispatch_wall_s']:.6f} s, stream "
                  f"{row['stream_s']:.6f} s (elapsed between the round's two "
                  f"events, idle gaps included); torch-op FLOPs a dispatch "
                  f"{row['flops_per_dispatch']:.4g} ({row['census_source']}; "
                  f"the census's dispatch {crow['dispatch_wall_s']:.3f} s), "
                  f"MFU against bf16's {BF16_FLOPS_PER_S:.3g}: {row['mfu']} "
                  f"over the run's {rep['window_s']} s; census, off and on: "
                  f"{len(differ)} of {len(v0)} leaves differ; builds "
                  f"{builds + census_builds:.0f} ({line})")
            if (row["dispatches"] != 1 or not 0.0 < row["stream_s"]
                    <= row["dispatch_wall_s"] + 1e-3 or differ
                    or builds or census_builds):
                raise AssertionError(
                    f"programs {eng.program_family}: dispatches "
                    f"{row['dispatches']} (ran 1), stream {row['stream_s']} "
                    f"s vs wall {row['dispatch_wall_s']} s, {len(differ)} "
                    f"leaves differ, {builds + census_builds} builds after "
                    "phase 2")
            rec[eng.program_family] = dict(row, census_wall_s=crow[
                "dispatch_wall_s"], window_s=rep["window_s"])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(f"[programs] phase 2 built {BUILDS['kernel_build_total']:.0f} "
          f"libraries in {BUILDS['kernel_build_seconds_total']:.1f} s "
          f"(kernel_build_total, unattributed "
          f"{BUILDS['unattributed']:.0f}); none after it")
    return dict(families=rec, phase2_builds=BUILDS)


def mqtt_edge() -> dict:
    """17d: FedML's edge leg, run_messaging_fedavg(backend="MQTT") through
    a MiniMqttBroker on loopback, on the mobile recipe: LR on the mnist
    stand-in, 8 clients, 2 rounds, f32 on the card, then one round with
    FMLZ: every round's global model bitwise the INPROC run's (f32 rides
    JSON floats exactly), one fold launch a round; JSON bytes a round and
    s/round."""
    data = load_data("mnist", client_num_in_total=MQTT_CLIENTS, batch_size=10,
                     synthetic_scale=0.05, seed=0)
    cfg = FedConfig(model="lr", dataset="mnist",
                    client_num_in_total=MQTT_CLIENTS,
                    client_num_per_round=MQTT_CLIENTS, epochs=1,
                    batch_size=10, lr=0.03, comm_round=MQTT_ROUNDS,
                    frequency_of_the_test=10_000)
    trainer = ClientTrainer(create_model("lr", 10), lr=cfg.lr)
    v0 = trainer.init(torch.Generator().manual_seed(cfg.seed), "cuda")
    broker = MiniMqttBroker(port=free_base_port(1))
    sent = lambda: obs.registry().counter("comm_sent_bytes_total",
                                          backend="mqtt").value
    runs = {}
    try:
        for name, backend, rounds, kw in (
                ("inproc", "INPROC", MQTT_ROUNDS, {}),
                ("mqtt", "MQTT", MQTT_ROUNDS, {}),
                ("mqtt_fmlz", "MQTT", 1, dict(wire_compress=True))):
            if backend == "MQTT":
                kw = dict(kw, host=broker.host, port=broker.port)
            models, marks = [], []

            def on_round(idx, variables):
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
                models.append({k: v.clone() for k, v in variables.items()})

            b0 = sent()
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            run_messaging_fedavg(trainer, data,
                                 dataclasses.replace(cfg, comm_round=rounds),
                                 backend=backend, variables=dict(v0),
                                 on_round_done=on_round, timeout=600, **kw)
            torch.cuda.synchronize()
            runs[name] = dict(models=models, launches=launch_counts(),
                              json_bytes_a_round=(sent() - b0) / rounds,
                              round_s=[b - a for a, b in
                                       zip([t0] + marks[:-1], marks)])
    finally:
        broker.close()
    line = card_line()
    want = runs["inproc"]["models"]
    for name, run in runs.items():
        differ = [(r, k) for r, m in enumerate(run["models"])
                  for k in v0 if not torch.equal(m[k], want[r][k])]
        print(f"[mqtt] {name}: {len(run['models'])} rounds, s/round "
              f"{run['round_s']}, JSON bytes a round "
              f"{run['json_bytes_a_round']:.0f} (server and clients), "
              f"launches {run['launches']}; {len(differ)} leaves differ from "
              f"INPROC's rounds ({line})")
        if differ or run["launches"]["wsum"] != len(run["models"]):
            raise AssertionError(f"mqtt {name}: {differ[:3]} differ from "
                                 f"INPROC, or wsum launches "
                                 f"{run['launches']['wsum']} != rounds")
    return {name: {k: v for k, v in run.items() if k != "models"}
            for name, run in runs.items()}


def phase_slice5b_ii() -> dict:
    """Phase 17: the chaos round and its observatory (f32, TF32 off,
    restored after), program timing on the main path, MQTT; each part's
    seconds."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    rec, seconds = {}, {}
    try:
        for key, part in (("chaos", lambda: (f32_off(), chaos_round())[1]),
                          ("programs", program_timing),
                          ("mqtt", mqtt_edge)):
            t0 = time.perf_counter()
            rec[key] = part()
            seconds[key] = time.perf_counter() - t0
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    rec["seconds"] = seconds
    print(f"[slice 5b-ii] phase 17 took {sum(seconds.values()):.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
          + f" ({card_line()})")
    return rec


# ---------------------------------------------------------------------------
# phase 18: slice 4a, the async server
# ---------------------------------------------------------------------------

ASYNC_COMMITS, ASYNC_K = 4, 4
# the lifecycle of parts (a) and (b): seed 7 crashes 3 dispatches, all of
# which rejoin, within the 4 commits (the trace does not depend on the model)
ASYNC_LIFECYCLE = dict(latency="lognormal", latency_scale=1.0,
                       latency_sigma=0.8, heterogeneity=0.5, dropout_prob=0.2,
                       rejoin_prob=1.0, rejoin_delay_s=2.0, seed=7)
ASYNC_MSG_WORKERS, ASYNC_MSG_COMMITS = 4, 3
ASYNC_PROFILED = 2             # clients in the profiled commit


def async_recipe(n_clients: int, commits: int, samples: int = SAMPLES,
                 dtype=torch.bfloat16, seed: int = 0):
    """The main path's recipe for the async paths: (trainer, data, cfg)."""
    data = synthetic_data(n_clients, samples, seed=seed)
    cfg = FedConfig(model="resnet18_gn", dataset="cifar10",
                    client_num_in_total=n_clients,
                    client_num_per_round=n_clients, epochs=1,
                    batch_size=BATCH, lr=0.1, comm_round=commits,
                    frequency_of_the_test=10_000)
    trainer = ClientTrainer(create_model("resnet18_gn", 10), lr=cfg.lr,
                            train_dtype=dtype)
    return trainer, data, cfg


def trace_kinds(trace: list) -> dict:
    kinds: dict = {}
    for t in trace:
        kinds[t[0]] = kinds.get(t[0], 0) + 1
    return kinds


def async_expected(eng: AsyncFedAvgEngine, batches: int) -> dict:
    """The launches an async run must have made, from its trace: every
    client of a wave trains (a crash draw comes after training), 20
    GroupNorm layers a step, 2 eval batches an evaluation; the drain
    commit is one finalize launch; a defended arrival is one squared
    distance, an admitted one a clipped fold."""
    kinds = trace_kinds(eng.trace)
    steps = batches * (kinds.get("dispatch", 0) + kinds.get("crash", 0))
    evals = 2 * len(eng.metrics_history)
    arrivals, quarantined = kinds.get("arrive", 0), kinds.get("quarantine", 0)
    defended = eng.defense is not None
    return {"gn_forward": 20 * (steps + evals), "gn_backward": 20 * steps,
            "wsum": 0 if defended else kinds.get("commit", 0),
            "sqnorm": arrivals if defended else 0,
            "clip_agg": arrivals - quarantined if defended else 0}


def async_run(eng: AsyncFedAvgEngine, v0: dict, tag: str) -> dict:
    """Run `eng` for ASYNC_COMMITS commits from v0 with the launch counts
    zeroed just before: launches exact, the model finite f32 and moved."""
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    v = eng.run(variables=dict(v0), rounds=ASYNC_COMMITS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    expected = async_expected(eng, BATCHES)
    if counts != expected:
        raise AssertionError(f"{tag}: launches {counts} != expected "
                             f"{expected}")
    bad = [k for k, t in v.items()
           if not torch.isfinite(t).all() or t.dtype != torch.float32]
    same = [k for k in v0 if torch.equal(v[k], v0[k])]
    if bad or len(same) == len(v0):
        raise AssertionError(f"{tag}: {len(bad)} leaves not finite f32, "
                             f"{len(same)} unchanged")
    rep = eng.async_report()
    kinds = trace_kinds(eng.trace)
    print(f"[{tag}] {ASYNC_COMMITS} commits of K={eng.buffer_k} from "
          f"{eng.concurrency} clients in flight: {wall:.2f} s, "
          f"{wall / ASYNC_COMMITS:.3f} s/commit; trace {kinds}; staleness "
          f"p50 {rep['staleness_p50']} p95 {rep['staleness_p95']}; launches "
          f"{counts} == expected ({card_line()})")
    return dict(wall_s=wall, s_per_commit=wall / ASYNC_COMMITS,
                launches=counts, trace=kinds, report=rep, variables=v)


def async_scheduler_path() -> dict:
    """18a: AsyncFedAvgEngine on the main path's recipe (ResNet-18-GN at
    full width, bf16 compute, 8 clients of 13 batches of 32) with
    polynomial λ (a = 0.5), K = 4, and the seeded lifecycle's latencies,
    crashes and rejoins, for 4 commits; then one commit of 2 clients
    profiled for the device's busy share."""
    trainer, data, cfg = async_recipe(MAIN_CLIENTS, ASYNC_COMMITS)
    eng = AsyncFedAvgEngine(trainer, data, cfg, buffer_k=ASYNC_K,
                            concurrency=MAIN_CLIENTS, staleness="polynomial",
                            lifecycle_cfg=LifecycleConfig(**ASYNC_LIFECYCLE))
    v0 = eng.init_variables()
    rec = async_run(eng, v0, "async scheduler")
    if not {"crash", "rejoin"} <= set(rec["trace"]):
        raise AssertionError("async scheduler: the lifecycle seed no longer "
                             "crashes and rejoins a client")
    # the busy share: one more commit of a 2-client engine, after one
    # unprofiled commit for its wall
    small = AsyncFedAvgEngine(trainer, data, cfg, buffer_k=ASYNC_PROFILED,
                              concurrency=ASYNC_PROFILED)
    v = small.run(variables=rec.pop("variables"), rounds=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v = small.run(variables=v, rounds=2)
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    rec["profile"] = profile_round(
        lambda: small.run(variables=v, rounds=3), steady,
        tag=f"async profile, {ASYNC_PROFILED} clients a commit")
    return rec


def async_degenerate_f32() -> dict:
    """18a: the degenerate config (zero latency and dropout, buffer_k = the
    cohort, constant λ, mix 1), f32 with TF32 off and cuDNN's
    deterministic algorithms, 4 clients x 2 batches, 2 commits: bitwise
    the port's FedAvgEngine over 2 rounds."""
    trainer, data, cfg = async_recipe(4, 2, samples=2 * BATCH,
                                      dtype=torch.float32, seed=5)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        sync = FedAvgEngine(trainer, data, cfg)
        v0 = sync.init_variables()
        want = sync.run(variables=dict(v0), rounds=2)
        got = AsyncFedAvgEngine(trainer, data, cfg, buffer_k=4).run(
            variables=dict(v0), rounds=2)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    bitwise = all(torch.equal(got[k], want[k]) for k in want)
    print(f"[async degenerate] 4 clients x 2 batches, 2 commits, f32: "
          f"bitwise FedAvgEngine's 2 rounds: {bitwise} ({card_line()})")
    if not bitwise:
        raise AssertionError("the degenerate async config is not "
                             "FedAvgEngine bitwise")
    return dict(bitwise=bitwise)


def async_stream_vs_drain(gen: torch.Generator) -> dict:
    """18a: the streaming buffer's arrival folds (one [1, P] accumulate
    launch each) against the drain twin over the capacity-padded [K, P]
    matrix, full and deadline-partial, in each staleness mode: the
    accumulators and the committed models bitwise equal, the launches one
    a lane.  Then the arrival fold and the screened fold timed at [1, P]
    f32 beside their bounds."""
    P = P_PADDED
    rows = torch.randn(ASYNC_K, P, generator=gen, device="cuda")
    w = [390.0, 390.0, 195.0, 390.0]
    s = [0.0, 1.0, 3.0, 2.0]
    template = {"row": torch.randn(P, generator=gen, device="cuda")}
    commit = make_stream_commit_fn(template)
    cases, launches = [], 0
    reset_launch_counts()
    for mode in STALENESS_MODES:
        for n_real in (ASYNC_K, 2):
            buf = AsyncBuffer(ASYNC_K, P, streaming=True,
                              staleness_mode=mode, device="cuda")
            for i in range(n_real):
                buf.add(rows[i], w[i], s[i])
            acc, acc_w, *_ = buf.take_stream()
            pad = torch.zeros_like(rows)
            pad[:n_real] = rows[:n_real]
            pw = np.zeros(ASYNC_K, np.float32)
            ps = np.zeros(ASYNC_K, np.float32)
            pw[:n_real], ps[:n_real] = w[:n_real], s[:n_real]
            dacc, dacc_w = make_drain_fold_fn(mode)(pad, pw, ps)
            a = commit(template, acc, acc_w, 0.7)[0]["row"]
            b = commit(template, dacc, dacc_w, 0.7)[0]["row"]
            ok = (torch.equal(acc, dacc) and torch.equal(acc_w, dacc_w)
                  and torch.equal(a, b))
            cases.append(dict(mode=mode, n_real=n_real, bitwise=ok))
            launches += n_real + ASYNC_K
            if not ok:
                raise AssertionError(f"streaming != drained commit "
                                     f"({mode}, {n_real} of {ASYNC_K})")
    torch.cuda.synchronize()
    if launch_counts()["wsum"] != launches:
        raise AssertionError(f"stream/drain: {launch_counts()['wsum']} fold "
                             f"launches, expected {launches} (one a lane)")
    print(f"[async stream/drain] the streaming commit equals the drained "
          f"commit bitwise at [{ASYNC_K}, {P}] f32, full and partial, in "
          f"{', '.join(STALENESS_MODES)}; {launches} fold launches, one a "
          f"lane ({card_line()})")
    # the arrival fold and the screened fold's two kernels at [1, P] f32,
    # each against its plain version with phase 3's tolerances, timed
    g = template["row"]
    V = (g + 0.01 * torch.randn(P, generator=gen, device="cuda"))[None]
    wt = torch.tensor([390.0], device="cuda")
    acc0 = torch.randn(P, generator=gen, device="cuda")
    acc, accp = acc0.clone(), acc0.clone()
    fold(acc, V, wt)
    fold_plain(accp, V, wt)
    fold_err = float((acc - accp).abs().max())
    if not bool(((acc - accp).abs()
                 <= 1e-6 * (acc0.abs() + (wt * V[0]).abs())).all()):
        raise AssertionError(f"arrival fold [1, {P}]: max abs err "
                             f"{fold_err:.3e} beyond 1e-6 x scale")
    sq = sqnorm(V, g)
    sq_err = check_close("sqnorm [1, P] f32", sq, sqnorm_plain(V, g), 1e-5,
                         0.0)
    cf = (wt * clip_scale(sq, 0.5 * float(sq.sqrt()))).contiguous()
    acc, accp = acc0.clone(), acc0.clone()
    clip_agg(acc, V, g, cf, wt, accumulate=True)
    clip_agg_plain(accp, V, g, cf, wt, accumulate=True)
    clip_err = float((acc - accp).abs().max())
    if not bool(((acc - accp).abs()
                 <= 1e-6 * terms_scale(V, g, cf, float(wt), acc0)).all()):
        raise AssertionError(f"clip_agg [1, {P}]: max abs err {clip_err:.3e}"
                             " beyond 1e-6 x sum|terms|")
    arrive = make_fold_fn("polynomial")
    zero = torch.zeros((), device="cuda")
    fold_rec = dict(
        shape=[1, P], dtype="float32", max_abs_err=fold_err,
        ms=cuda_ms(lambda: wsum(acc, V, wt, finalize=False)),
        host_ms=host_ms(lambda: arrive(acc, zero, V[0], 390.0, 1.0)),
        plain_ms=cuda_ms(lambda: fold_plain(acc, V, wt)),
        library_ms=cuda_ms(lambda: acc.addcmul_(V[0], wt)),
        bound=bound_ms(3 * P * 4 + 4, 2 * P))
    D = V - g
    adm = UpdateAdmission(DefenseConfig(norm_bound=1e6, screen=True,
                                        buckets=ASYNC_K), P, "cuda")
    adm.bind_fold("polynomial", 0.5, 4.0)
    adm.note_global(0, g)
    screened = dict(
        sqnorm_ms=cuda_ms(lambda: sqnorm(V, g)), sqnorm_max_abs_err=sq_err,
        sqnorm_plain_ms=cuda_ms(lambda: sqnorm_plain(V, g)),
        sqnorm_library_ms=cuda_ms(lambda: torch.cdist(V, g[None])),
        sqnorm_bound=bound_ms(2 * P * 4 + 4, 3 * P),
        clip_agg_ms=cuda_ms(lambda: clip_agg(acc, V, g, cf, wt, True)),
        clip_agg_max_abs_err=clip_err,
        clip_agg_plain_ms=cuda_ms(
            lambda: clip_agg_plain(acc, V, g, cf, wt, True)),
        clip_agg_library_ms=cuda_ms(lambda: torch.addmv(acc, D.t(), cf)),
        clip_agg_bound=bound_ms(4 * P * 4, 3 * P + 2 * P),
        host_ms=host_ms(lambda: adm.screened_fold(acc, zero, V[0], 390.0,
                                                  1.0, version=0)))
    del D
    screened["kernel_overhead"] = ((screened["sqnorm_ms"]
                                    + screened["clip_agg_ms"])
                                   / fold_rec["ms"])
    screened["host_overhead"] = screened["host_ms"] / fold_rec["host_ms"]
    print(f"[async fold] arrival fold [1, {P}] f32 into the f32 accumulator: "
          f"max abs err {fold_err:.3e}; {fold_rec['ms'] * 1e3:.2f} us on the "
          f"card, {fold_rec['host_ms'] * 1e3:.1f} us a call on the host (λ "
          f"and the weight's upload included), plain "
          f"{fold_rec['plain_ms'] * 1e3:.2f} us, library (acc.addcmul_) "
          f"{fold_rec['library_ms'] * 1e3:.2f} us, bound "
          f"{fold_rec['bound'][0] * 1e3:.2f} us ({fold_rec['bound'][1]}) "
          f"({card_line()})")
    print(f"[async fold] screened fold [1, {P}] f32: sqnorm (max abs err "
          f"{sq_err:.3e}) {screened['sqnorm_ms'] * 1e3:.2f} us, plain "
          f"{screened['sqnorm_plain_ms'] * 1e3:.2f}, library (torch.cdist) "
          f"{screened['sqnorm_library_ms'] * 1e3:.2f}, bound "
          f"{screened['sqnorm_bound'][0] * 1e3:.2f}; clip_agg accumulate "
          f"(max abs err {clip_err:.3e}) {screened['clip_agg_ms'] * 1e3:.2f} "
          f"us, plain {screened['clip_agg_plain_ms'] * 1e3:.2f}, library "
          f"(torch.addmv) {screened['clip_agg_library_ms'] * 1e3:.2f}, bound "
          f"{screened['clip_agg_bound'][0] * 1e3:.2f}: "
          f"{screened['kernel_overhead']:.2f}x the arrival fold's device "
          f"time; {screened['host_ms'] * 1e3:.1f} us a call on the host, "
          f"{screened['host_overhead']:.2f}x ({card_line()})")
    return dict(cases=cases, launches=launches, fold=fold_rec,
                screened=screened)


def async_card_cpu() -> dict:
    """18a: one f32 commit (2 clients x 2 batches, K = 2, polynomial λ,
    lognormal latencies) on the card and on the CPU from the same init:
    the same trace, the update within phase 4's limits."""
    trainer, data, cfg = async_recipe(2, 1, samples=2 * BATCH,
                                      dtype=torch.float32, seed=1)
    out = {}
    for device in ("cuda", "cpu"):
        eng = AsyncFedAvgEngine(
            trainer, data, cfg, buffer_k=2, staleness="polynomial",
            lifecycle_cfg=LifecycleConfig(latency="lognormal", seed=3),
            device=device)
        v0 = eng.init_variables()
        out[device] = (v0, eng.run(variables=dict(v0), rounds=1), eng.trace)
    (g0, g1, gt), (c0, c1, ct) = out["cuda"], out["cpu"]
    whole, worst = update_distance("async f32 commit", g0, g1, c0, c1)
    print(f"[async card/cpu] one f32 commit, 2 clients x 2 batches: update "
          f"distance {whole:.3e} of its norm (limit 1e-3), worst leaves "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst)
          + f" (limit 1e-2); traces equal {gt == ct} ({card_line()})")
    if whole > 1e-3 or worst[0][1] > 1e-2 or gt != ct:
        raise AssertionError("async f32 commit: the card differs from the "
                             "CPU beyond phase 4's limits, or the traces")
    return dict(distance=whole, worst=worst)


def async_defended_path() -> dict:
    """18b: the scheduler of 18a attacked (boost x10 from a quarter of the
    clients) and defended: the clip bound three times one honest client's
    update norm, the z screen armed after 4 updates, 4 buckets; 4 commits
    with exact launches (one squared distance an arrival, one clipped fold
    an admitted one), quarantines by reason; then NaN and ±inf rows into a
    screened buffer on the card change no accumulator bit and launch only
    their squared distance."""
    trainer, data, cfg = async_recipe(MAIN_CLIENTS, ASYNC_COMMITS)
    v0 = trainer.init(torch.Generator().manual_seed(cfg.seed), "cuda")
    flat = trainer.flatten(v0)
    shard = {k: torch.as_tensor(t[0]).cuda()
             for k, t in data.client_shards.items()}
    row, _, _ = trainer.local_train(flat, shard, 1, generator=client_generator(
        cfg.seed, 0, 0, "cuda"))
    honest = float((row - flat).norm())
    defense = DefenseConfig(norm_bound=3.0 * honest, screen=True,
                            screen_warmup=4, buckets=ASYNC_K)
    eng = AsyncFedAvgEngine(
        trainer, data, cfg, buffer_k=ASYNC_K, concurrency=MAIN_CLIENTS,
        staleness="polynomial", lifecycle_cfg=LifecycleConfig(
            **ASYNC_LIFECYCLE),
        attack=AttackConfig(mode="boost", frac=0.25, boost=10.0),
        defense=defense)
    rec = async_run(eng, v0, "async defended")
    rec.pop("variables")
    rec.update(honest_norm=honest, norm_bound=defense.norm_bound,
               quarantined=rec["report"]["quarantined"],
               attribution=eng.quarantine_attribution())
    print(f"[async defended] one honest update's norm {honest:.4f}, clip "
          f"bound {defense.norm_bound:.4f}; quarantined by reason "
          f"{rec['quarantined']}, by who {rec['attribution']}; "
          f"byzantine clients {rec['report']['byzantine_clients']}, attacks "
          f"{rec['report']['attacks_injected']} ({card_line()})")
    # a non-finite row never reaches a kernel but its squared distance
    adm = UpdateAdmission(defense, trainer.spec.padded, "cuda")
    adm.bind_fold("polynomial", 0.5, 4.0)
    adm.note_global(0, flat)
    buf = AsyncBuffer(ASYNC_K, trainer.spec.padded, streaming=True,
                      staleness_mode="polynomial", device="cuda")
    if not buf.add_screened(row, 390.0, 0.0, adm)[0]:
        raise AssertionError("async defended: an honest row was quarantined")
    torch.cuda.synchronize()
    acc, wsum0 = buf.acc.clone(), buf.wsum.clone()
    for bad in (float("nan"), float("inf"), float("-inf")):
        poisoned = row.clone()
        poisoned[12345] = bad
        reset_launch_counts()
        ok, why, _ = buf.add_screened(poisoned, 390.0, 0.0, adm, sender=1)
        torch.cuda.synchronize()
        counts = launch_counts()
        if (ok or why != "nonfinite" or not torch.equal(buf.acc, acc)
                or not torch.equal(buf.wsum, wsum0)
                or counts != {"gn_forward": 0, "gn_backward": 0, "wsum": 0,
                              "sqnorm": 1, "clip_agg": 0}):
            raise AssertionError(f"async defended: a {bad} row was {why}, "
                                 f"launched {counts}, or moved the "
                                 "accumulator")
    print(f"[async defended] NaN, +inf and -inf rows: quarantined "
          f"'nonfinite', the accumulator bitwise unchanged, one sqnorm "
          f"launch each and no fold ({card_line()})")
    return rec


def async_messaging_path() -> dict:
    """18c: run_async_messaging over INPROC on the main path's recipe
    (4 client threads, bf16 compute and local masters), streaming, K = 4,
    3 commits: GroupNorm launches exact for the trainings the clients ran,
    one arrival fold an admitted update; then one secure round at full
    width whose masked field sum, folded on the card, is bitwise the
    plain fixed-point sum of the clients' weighted rows."""
    trainer, data, cfg = async_recipe(ASYNC_MSG_WORKERS, ASYNC_MSG_COMMITS)
    v0 = trainer.init(torch.Generator().manual_seed(cfg.seed), "cuda")
    trainings = []
    train = AsyncClientManager._train

    def counted(self, variables, client_idx):
        trainings.append(client_idx)
        return train(self, variables, client_idx)

    AsyncClientManager._train = counted
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        v, srv = run_async_messaging(
            trainer, data, cfg, buffer_k=ASYNC_K,
            total_commits=ASYNC_MSG_COMMITS, worker_num=ASYNC_MSG_WORKERS,
            streaming=True, variables=dict(v0), local_dtype=torch.bfloat16,
            timeout_s=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        AsyncClientManager._train = train
    steps = BATCHES * len(trainings)
    expected = {"gn_forward": 20 * steps, "gn_backward": 20 * steps,
                "wsum": srv.updates_committed, "sqnorm": 0, "clip_agg": 0}
    if counts != expected or srv.version != ASYNC_MSG_COMMITS:
        raise AssertionError(f"async messaging: {srv.version} commits, "
                             f"launches {counts} != expected {expected}")
    if not all(torch.isfinite(t).all() for t in v.values()):
        raise AssertionError("async messaging: a non-finite global model")
    commit_s = [b - a for a, b in zip([t0] + srv.commit_walls[:-1],
                                      srv.commit_walls)]
    print(f"[async messaging] INPROC, {ASYNC_MSG_WORKERS} client threads, "
          f"streaming K={ASYNC_K}: {srv.version} commits in {wall:.2f} s "
          f"(s/commit {[round(x, 3) for x in commit_s]}), "
          f"{len(trainings)} trainings, {srv.updates_committed} updates "
          f"folded, staleness {srv.staleness_seen}; launches {counts} == "
          f"expected ({card_line()})")
    return dict(wall_s=wall, commit_s=commit_s, launches=counts,
                trainings=len(trainings),
                updates=srv.updates_committed,
                staleness=srv.staleness_seen, secure=async_secure_round(
                    trainer, data, cfg, v0))


def async_secure_round(trainer, data, cfg, v0: dict) -> dict:
    """18c: one secure round (K = the 4 clients) at full width: the
    clients' masked rows fold on the card in int64; the field sum at the
    barrier must equal the plain fixed-point sum of their weighted rows
    word for word."""
    plain, masked = {}, []
    client_row, commit = SecureAggregator.client_row, SecureAggregator.commit

    def recorded_row(self, cid, round_idx, flat, weight):
        plain[cid] = (np.array(flat, np.float64), float(weight))
        return client_row(self, cid, round_idx, flat, weight)

    def recorded_commit(self, round_idx, survivors, reset=True):
        masked.append(self.field_sum(round_idx, survivors)[0])
        masked.append(self._acc.device.type)
        return commit(self, round_idx, survivors, reset)

    SecureAggregator.client_row = recorded_row
    SecureAggregator.commit = recorded_commit
    try:
        t0 = time.perf_counter()
        v, srv = run_async_messaging(
            trainer, data, cfg, buffer_k=ASYNC_MSG_WORKERS, total_commits=1,
            worker_num=ASYNC_MSG_WORKERS, variables=dict(v0),
            local_dtype=torch.bfloat16, secure=SecAggConfig(seed=3),
            timeout_s=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        SecureAggregator.client_row = client_row
        SecureAggregator.commit = commit
    sec = srv._secure
    want = np.zeros(sec.words, np.int64)
    for flat, w in plain.values():
        q = np.empty(sec.words, np.int64)
        q[:sec.dim] = mpc.quantize(flat * w, sec.cfg.scale, sec.cfg.prime)
        q[sec.dim] = mpc.quantize(np.array([w]), sec.cfg.scale,
                                  sec.cfg.prime)[0]
        want = (want + q) % sec.cfg.prime
    words, device = masked
    bitwise = bool(np.array_equal(words, want))
    print(f"[async secure] one round, {len(plain)} clients, {sec.words} field "
          f"words each, folded on {device}: {wall:.2f} s; masked field sum "
          f"== plain fixed-point sum: {bitwise}; committed "
          f"{srv.updates_committed} ({card_line()})")
    if (not bitwise or device != "cuda" or srv.version != 1
            or not all(torch.isfinite(t).all() for t in v.values())):
        raise AssertionError("async secure round: the masked field sum is not "
                             "the plain sum, or the round did not commit")
    return dict(wall_s=wall, words=sec.words, bitwise=bitwise)


def phase_slice4a(gen: torch.Generator) -> dict:
    """Phase 18: the async scheduler (its path, the degenerate pin, the
    streaming-vs-drain pin, one commit card against CPU), the defended
    scheduler, and the async messaging FSM with one secure round; each
    part's seconds.  TF32 off for the f32 checks, restored after."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    rec, seconds = {}, {}
    try:
        for key, part in (("scheduler", async_scheduler_path),
                          ("stream_vs_drain",
                           lambda: async_stream_vs_drain(gen)),
                          ("degenerate", lambda: (f32_off(),
                                                  async_degenerate_f32())[1]),
                          ("card_cpu", async_card_cpu),
                          ("defended", async_defended_path),
                          ("messaging", async_messaging_path)):
            t0 = time.perf_counter()
            rec[key] = part()
            seconds[key] = time.perf_counter() - t0
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    rec["seconds"] = seconds
    print(f"[slice 4a] phase 18 took {sum(seconds.values()):.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
          + f" ({card_line()})")
    return rec


# ---------------------------------------------------------------------------
# phase 19: slice 4b and the one-card part of slice 6
# ---------------------------------------------------------------------------

STREAM_BLOCK = 2               # 19a-19b: clients a block (a chunk multiple)
CKPT_CLIENTS, CKPT_BATCHES = 4, 4       # 19c: phase 16's f32 shape
SERVE = dict(population=1_000_000, commits=8, warmup_commits=4, buffer_k=32,
             row_dim=4096, sampler_mode="stratified", dropout_prob=0.02,
             banned_frac=0.01, seed=0)   # bench.py's serve arm, cut to 8
SERVE_BYTES_PER_CLIENT_GATE = 100.0
INGEST = dict(n_clients=8, p=N_PARAMS, buffer_k=4, commits=3,
              warmup_commits=1, ingest_pool=4, decode_into=True,
              streaming=True, timeout_s=300)
SECURE_CLIENTS = 4
CONN = dict(n_connections=256, p=1024, buffer_k=32, commits=3,
            warmup_commits=1, timeout_s=120)


def deterministic(fn):
    """fn() under cuDNN's deterministic algorithms (restored after)."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return fn()
    finally:
        torch.backends.cudnn.deterministic = before


def main_recipe(samples: int = SAMPLES):
    """Phase 5's data, config and trainer (8 clients x 13 batches of 32,
    or `samples` a client; ResNet-18-GN at full width, bf16 compute)."""
    data = synthetic_data(MAIN_CLIENTS, samples, seed=0)
    cfg = FedConfig(model="resnet18_gn", dataset="cifar10",
                    client_num_in_total=MAIN_CLIENTS,
                    client_num_per_round=MAIN_CLIENTS, epochs=1,
                    batch_size=BATCH, lr=0.1, frequency_of_the_test=10_000)
    trainer = ClientTrainer(create_model("resnet18_gn", 10), lr=cfg.lr,
                            train_dtype=torch.bfloat16)
    return trainer, data, cfg


def one_round(eng, v0: dict, expected: dict, tag: str) -> dict:
    """eng.run for one round (one evaluation after it) from v0, its
    launches counted from zero and held to `expected`, the peak device
    memory of the round."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launch_counts()
    t0 = time.perf_counter()
    v = eng.run(variables=dict(v0), rounds=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    if counts != expected:
        raise AssertionError(f"{tag}: launches {counts} != expected "
                             f"{expected}")
    if not all(torch.isfinite(t).all() for t in v.values()):
        raise AssertionError(f"{tag}: a non-finite global model")
    return dict(variables=v, launches=counts, wall_s=wall,
                peak_bytes=torch.cuda.max_memory_allocated() - base)


def main_path_expected(rounds: int = 1, wsum: int = 0, sqnorm: int = 0,
                       clip_agg: int = 0) -> dict:
    """Phase 5's GroupNorm counts for `rounds` rounds and one evaluation."""
    steps = rounds * MAIN_CLIENTS * BATCHES
    return {"gn_forward": 20 * (steps + 2), "gn_backward": 20 * steps,
            "wsum": wsum, "sqnorm": sqnorm, "clip_agg": clip_agg}


def same_model(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in b)


def blockstream_main_path() -> dict:
    """19a: MeshFedAvgEngine(stream_block=2, chunk=2, local_dtype=bf16) on
    phase 5's clients, one round with the upload prefetch and one without,
    against the streaming round of the same cohort (cuDNN deterministic):
    all three bitwise, launches exact (wsum 4), at most two blocks
    resident; then one norm_clip block round (launches exact) and the same
    round in f32 on 4 one-batch clients card against CPU (phase 4's
    limits)."""
    trainer, data, cfg = main_recipe()
    kw = dict(chunk=MAIN_CHUNK, local_dtype=torch.bfloat16)
    stream = MeshFedAvgEngine(trainer, data, cfg, **kw)
    v0 = stream.init_variables()
    folds = MAIN_CLIENTS // MAIN_CHUNK
    runs = {}
    for tag, eng in (
            ("streaming", stream),
            ("block, prefetch", MeshFedAvgEngine(
                trainer, data, cfg, stream_block=STREAM_BLOCK, **kw)),
            ("block, no prefetch", MeshFedAvgEngine(
                trainer, data, cfg, stream_block=STREAM_BLOCK,
                prefetch=False, **kw))):
        runs[tag] = deterministic(lambda: one_round(
            eng, v0, main_path_expected(wsum=folds), f"19a {tag}"))
        runs[tag]["engine"] = eng
    want = runs["streaming"]["variables"]
    bitwise = {t: same_model(r["variables"], want) for t, r in runs.items()}
    pre = runs["block, prefetch"]["engine"]
    block_bytes = sum(np.asarray(v[:STREAM_BLOCK]).nbytes
                      for v in data.client_shards.values())
    stats = pre.transfer_stats.rounds[-1]
    print(f"[19a] {MAIN_CLIENTS} clients in blocks of {STREAM_BLOCK}, chunk "
          f"{MAIN_CHUNK}, bf16 masters: block rounds bitwise the streaming "
          f"round {bitwise}; s/round " + ", ".join(
              f"{t} {r['wall_s']:.3f}" for t, r in runs.items())
          + "; peak device memory " + ", ".join(
              f"{t} {r['peak_bytes'] / 2**20:.1f} MiB"
              for t, r in runs.items())
          + f"; cohort bytes resident at most {pre.peak_resident_block_bytes}"
          f" ({pre.peak_resident_block_bytes / block_bytes:.2f} blocks of "
          f"{block_bytes}); upload {stats['upload_wall_s']:.4f} s, wait "
          f"{stats['wait_wall_s']:.4f} s, overlap fraction "
          f"{stats['overlap_fraction']:.3f}; launches "
          f"{runs['block, prefetch']['launches']} == expected "
          f"({card_line()})")
    if not all(bitwise.values()):
        raise AssertionError(f"19a: the block rounds are not the streaming "
                             f"round bitwise: {bitwise}")
    for eng in (pre, runs["block, no prefetch"]["engine"]):
        if eng.peak_resident_block_bytes > 2 * block_bytes \
                or eng.resident_block_bytes != 0:
            raise AssertionError(
                f"19a: {eng.peak_resident_block_bytes} cohort bytes "
                f"resident, more than two blocks of {block_bytes}")
    clip = MeshRobustEngine(trainer, data, cfg, defense="norm_clip",
                            stream_block=STREAM_BLOCK, **kw)
    rec_clip = one_round(clip, v0, main_path_expected(
        sqnorm=folds, clip_agg=folds), "19a norm_clip block round")
    print(f"[19a] norm_clip block round (bound {cfg.norm_bound}): "
          f"{rec_clip['wall_s']:.3f} s, launches {rec_clip['launches']} == "
          f"expected ({card_line()})")
    small = small_clip_card_cpu()
    streaming = streaming_prefetch(trainer, data, cfg, v0)
    return dict(bitwise=bitwise, streaming_prefetch=streaming,
                s_per_round={t: r["wall_s"] for t, r in runs.items()},
                peak_bytes={t: r["peak_bytes"] for t, r in runs.items()},
                resident_bytes=pre.peak_resident_block_bytes,
                block_bytes=block_bytes, transfer=stats,
                launches=runs["block, prefetch"]["launches"],
                clip_launches=rec_clip["launches"],
                clip_s=rec_clip["wall_s"], clip_card_cpu=small)


def streaming_prefetch(trainer, data, cfg, v0: dict) -> dict:
    """19a: MeshFedAvgEngine(streaming=True) on phase 5's clients for 2
    rounds, round 2's cohort uploaded on the prefetch thread while round 1
    trains, against the same 2 rounds with prefetch=False (cuDNN
    deterministic): bitwise, launches exact."""
    kw = dict(chunk=MAIN_CHUNK, local_dtype=torch.bfloat16, streaming=True)
    runs = {}
    for tag, prefetch in (("prefetch", True), ("no prefetch", False)):
        eng = MeshFedAvgEngine(trainer, data, cfg, prefetch=prefetch, **kw)

        def two_rounds():
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            v = eng.run(variables=dict(v0), rounds=2)
            torch.cuda.synchronize()
            return v, time.perf_counter() - t0, launch_counts()
        v, wall, counts = deterministic(two_rounds)
        expected = main_path_expected(rounds=2,
                                      wsum=2 * MAIN_CLIENTS // MAIN_CHUNK)
        expected["gn_forward"] += 40          # the last round's evaluation
        if counts != expected:
            raise AssertionError(f"19a streaming {tag}: launches {counts} "
                                 f"!= expected {expected}")
        runs[tag] = dict(variables=v, wall_s=wall, launches=counts,
                         transfer=eng.transfer_stats.report(),
                         prefetched=eng._prefetched)
    bitwise = same_model(runs["prefetch"]["variables"],
                         runs["no prefetch"]["variables"])
    print(f"[19a] streaming=True, 2 rounds: prefetch on and off bitwise "
          f"{bitwise}; s for 2 rounds " + ", ".join(
              f"{t} {r['wall_s']:.3f}" for t, r in runs.items())
          + "; transfer " + ", ".join(
              f"{t} upload {r['transfer']['upload_wall_s']:.4f} s wait "
              f"{r['transfer']['wait_wall_s']:.4f} s overlap "
              f"{r['transfer']['overlap_fraction']:.3f}"
              for t, r in runs.items())
          + f"; launches {runs['prefetch']['launches']} == expected "
          f"({card_line()})")
    if not bitwise or any(r["prefetched"] is not None
                          for r in runs.values()):
        raise AssertionError("19a: the streaming rounds with and without "
                             "the prefetch differ, or a cohort was left "
                             "prefetched")
    return {t: dict(wall_s=r["wall_s"], transfer=r["transfer"],
                    launches=r["launches"]) for t, r in runs.items()}


def small_clip_card_cpu() -> dict:
    """19a: the norm_clip block round in f32 (TF32 off) on 4 clients of one
    batch, card against CPU: the update within 1e-3 of its norm, 1e-2 a
    leaf (phase 4's limits)."""
    f32_off()
    data = synthetic_data(4, BATCH, seed=6)
    cfg = FedConfig(model="resnet18_gn", dataset="cifar10",
                    client_num_in_total=4, client_num_per_round=4, epochs=1,
                    batch_size=BATCH, lr=0.1, frequency_of_the_test=10_000,
                    norm_bound=0.5)
    trainer = ClientTrainer(create_model("resnet18_gn", 10), lr=0.1)
    out = {}
    for device in ("cuda", "cpu"):
        eng = MeshRobustEngine(trainer, data, cfg, defense="norm_clip",
                               stream_block=STREAM_BLOCK, chunk=MAIN_CHUNK,
                               device=device)
        v0 = eng.init_variables()
        out[device] = (v0, eng.run(variables=dict(v0), rounds=1))
    torch.cuda.synchronize()
    (g0, g1), (c0, c1) = out["cuda"], out["cpu"]
    whole, worst = update_distance("19a norm_clip", g0, g1, c0, c1)
    print(f"[19a] f32 norm_clip block round, 4 clients x 1 batch: card vs CPU "
          f"update distance {whole:.3e} (limit 1e-3), worst leaves "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst) + " (limit 1e-2)")
    if whole > 1e-3 or worst[0][1] > 1e-2:
        raise AssertionError("19a: the f32 norm_clip block round differs "
                             "from the CPU's beyond phase 4's limits")
    return dict(distance=whole, worst=worst)


def two_phase_orderstat() -> dict:
    """19b: MeshRobustEngine(defense=median, krum; stream_block=2) one
    round each on 19a's clients against the resident round (cuDNN
    deterministic): median bitwise; krum the resident's client (bitwise
    its model), its scores from the Gram matrix printed beside the
    resident formula's on the same rows (TF32 off; both cancel, so only
    the selection is held)."""
    trainer, data, cfg = main_recipe()
    kw = dict(chunk=MAIN_CHUNK, local_dtype=torch.bfloat16)
    rec = {}
    select = robust_ops.krum_select_flat
    resident_scores = []

    def recording_select(flats, n_byzantine):
        resident_scores.append(robust_ops.krum_scores_flat(
            flats, n_byzantine).cpu().numpy())
        return select(flats, n_byzantine)

    for defense in ("median", "krum"):
        res = MeshRobustEngine(trainer, data, cfg, defense=defense,
                               n_byzantine=1, **kw)
        v0 = res.init_variables()
        blk = MeshRobustEngine(trainer, data, cfg, defense=defense,
                               n_byzantine=1, stream_block=STREAM_BLOCK,
                               **kw)
        robust_ops.krum_select_flat = recording_select
        try:
            r_res = deterministic(lambda: one_round(
                res, v0, main_path_expected(), f"19b resident {defense}"))
        finally:
            robust_ops.krum_select_flat = select
        r_blk = deterministic(lambda: one_round(
            blk, v0, main_path_expected(), f"19b two-phase {defense}"))
        bitwise = same_model(r_blk["variables"], r_res["variables"])
        out = dict(bitwise=bitwise, resident_s=r_res["wall_s"],
                   two_phase_s=r_blk["wall_s"],
                   host_matrix_bytes=blk.orderstat_host_bytes,
                   peak_bytes=(r_res["peak_bytes"], r_blk["peak_bytes"]),
                   launches=r_blk["launches"])
        if defense == "krum":
            got, want = blk.last_krum_scores, resident_scores[-1]
            rel = float(np.max(np.abs(got - want) / np.abs(want)))
            out.update(scores=[float(s) for s in got], scores_rel=rel,
                       selected=int(np.argmin(got)),
                       resident_selected=int(np.argmin(want)))
            print(f"[19b] krum scores from the Gram matrix vs the resident "
                  f"formula on the same rows: max relative {rel:.3e}; "
                  f"selected {out['selected']} (resident "
                  f"{out['resident_selected']})")
            if out["selected"] != out["resident_selected"]:
                raise AssertionError("19b: krum's two-phase round selects "
                                     "another client than the resident's")
        print(f"[19b] {defense}: two-phase round bitwise the resident round "
              f"{bitwise}; s/round resident {r_res['wall_s']:.3f}, two-phase "
              f"{r_blk['wall_s']:.3f}; pinned host [K, P] matrix "
              f"{blk.orderstat_host_bytes} bytes; peak device memory "
              f"resident {r_res['peak_bytes'] / 2**20:.1f} MiB, two-phase "
              f"{r_blk['peak_bytes'] / 2**20:.1f} MiB; launches "
              f"{r_blk['launches']} == expected ({card_line()})")
        if not bitwise:
            raise AssertionError(f"19b: the two-phase {defense} round is not "
                                 "the resident round bitwise")
        rec[defense] = out
    return rec


def f32_recipe(n_clients: int, batches: int, seed: int):
    """Phase 16's f32 recipe: ResNet-18-GN at full width, f32."""
    data = synthetic_data(n_clients, batches * BATCH, seed=seed)
    cfg = FedConfig(model="resnet18_gn", dataset="cifar10",
                    client_num_in_total=n_clients,
                    client_num_per_round=n_clients, epochs=1,
                    batch_size=BATCH, lr=0.1, comm_round=3,
                    frequency_of_the_test=10_000)
    return ClientTrainer(create_model("resnet18_gn", 10), lr=cfg.lr), data, cfg


def checkpoint_resume() -> dict:
    """19c: at phase 16's f32 shape (4 clients x 4 batches), cuDNN
    deterministic: FedAvgEngine.run for 2 rounds, then a fresh engine
    resumed for the third, bitwise the straight 3 rounds; the async
    scheduler saving after 2 commits (its restored async_state() bitwise
    the saved one, the resumed run committing to the budget); the async
    server's crash-resume over INPROC."""
    trainer, data, cfg = f32_recipe(CKPT_CLIENTS, CKPT_BATCHES, seed=4)
    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        def fedavg():
            straight = FedAvgEngine(trainer, data, cfg)
            v0 = straight.init_variables()
            want = straight.run(variables=dict(v0), rounds=3)
            ck = FedCheckpointManager(f"{tmp}/fedavg")
            FedAvgEngine(trainer, data, cfg).run(
                variables=dict(v0), rounds=2, ckpt=ck, ckpt_every=1)
            t0 = time.perf_counter()
            got = FedAvgEngine(trainer, data, cfg).run(
                variables=dict(v0), rounds=3, ckpt=ck, ckpt_every=1,
                resume=True)
            torch.cuda.synchronize()
            return same_model(got, want), time.perf_counter() - t0
        bitwise, resume_s = deterministic(fedavg)
        print(f"[19c] FedAvgEngine.run 2 rounds + a resumed third bitwise "
              f"the straight 3 rounds: {bitwise} (resumed round "
              f"{resume_s:.2f} s; {CKPT_CLIENTS} clients x {CKPT_BATCHES} "
              f"batches, f32) ({card_line()})")
        if not bitwise:
            raise AssertionError("19c: the resumed run is not the straight "
                                 "run bitwise")
        rec["fedavg"] = dict(bitwise=bitwise, resumed_round_s=resume_s)

        acfg = dataclasses.replace(cfg, comm_round=4)
        kw = dict(buffer_k=2, concurrency=CKPT_CLIENTS,
                  staleness="polynomial",
                  lifecycle_cfg=LifecycleConfig(**ASYNC_LIFECYCLE))
        ck = FedCheckpointManager(f"{tmp}/async")
        first = AsyncFedAvgEngine(trainer, data, acfg, **kw)
        v0 = first.init_variables()
        first.run(variables=dict(v0), rounds=2, ckpt=ck, ckpt_every=2)
        saved = first.async_state()
        fresh = AsyncFedAvgEngine(trainer, data, acfg, **kw)
        _r, _v, _s, extra = ck.restore(v0, (),
                                       extra_template=fresh.async_state())
        fresh.load_async_state(extra)
        again = fresh.async_state()
        same = all(np.array_equal(again[part][k], saved[part][k])
                   for part in ("buffer", "registry") for k in saved[part])
        resumed = AsyncFedAvgEngine(trainer, data, acfg, **kw)
        out = resumed.run(variables=dict(v0), rounds=4, ckpt=ck,
                          resume=True)
        torch.cuda.synchronize()
        print(f"[19c] async scheduler: saved after 2 commits, restored "
              f"async_state bitwise the saved one: {same}; resumed run "
              f"committed to version {resumed.version} of 4")
        if not same or resumed.version != 4 or not all(
                torch.isfinite(t).all() for t in out.values()):
            raise AssertionError("19c: the async scheduler's resume failed")
        rec["scheduler"] = dict(state_bitwise=same, version=resumed.version)
        rec["lifecycle"] = lifecycle_crash_resume(trainer, data,
                                                  f"{tmp}/server")
    return rec


def lifecycle_crash_resume(trainer, data, ckpt_dir: str) -> dict:
    """19c: the async server over INPROC with 2 reliable client threads,
    K 2, 4 commits, checkpointing every commit: crashed after its second
    commit, rebuilt with resume=True from the checkpoint (its model
    bitwise the saved one), the clients re-handshaked to the budget."""
    init = trainer.init(torch.Generator().manual_seed(0), "cuda")
    init = {k: init[k] for k in trainer.spec.names}
    router = InProcRouter()
    kw = dict(router=router)
    server1 = AsyncServerManager(init, 4, 2, 0, 3, "INPROC", deadline_s=30.0,
                                 reliable=True, checkpoint_dir=ckpt_dir,
                                 checkpoint_every=1, **kw)
    clients = [AsyncClientManager(trainer, data, 1, r, 3, "INPROC",
                                  reliable=True, **kw) for r in (1, 2)]
    server2 = None
    t0 = time.perf_counter()
    try:
        for c in clients:
            c.run_async()
        server1.run_async()
        server1.send_start()
        deadline = time.time() + 300
        while server1.version < 2 and time.time() < deadline:
            time.sleep(0.01)
        server1.crash()
        crashed_at = server1.version
        saved = FedCheckpointManager(ckpt_dir).latest_round()
        server2 = AsyncServerManager(init, 4, 2, 0, 3, "INPROC",
                                     deadline_s=30.0, reliable=True,
                                     checkpoint_dir=ckpt_dir,
                                     checkpoint_every=1, resume=True, **kw)
        _, want, _ = FedCheckpointManager(ckpt_dir).restore(
            init, (), round_idx=saved)
        restored = same_model(server2.variables, want)
        counters = (server2.registry.total_participation()
                    == server2.updates_committed)
        server2.run_async()
        server2.send_start()
        done = server2.done.wait(timeout=300)
        torch.cuda.synchronize()
    finally:
        for c in clients:
            c.finish()
        if server2 is not None:
            server2.finish()
        server1.finish()
    wall = time.perf_counter() - t0
    print(f"[19c] async server crash-resume over INPROC: crashed at version "
          f"{crashed_at}, resumed from checkpoint {saved} (model bitwise the "
          f"saved one: {restored}; registry counters agree: {counters}), "
          f"finished at version {server2.version} of 4 in {wall:.2f} s")
    if not (done and restored and counters and server2.version == 4
            and saved >= 2):
        raise AssertionError("19c: the async server's crash-resume failed")
    return dict(crashed_at=crashed_at, saved=saved, wall_s=wall,
                version=server2.version)


def serve_spine() -> dict:
    """19d: run_serve_sim at bench.py's serve settings (1,000,000 clients,
    K 32, row_dim 4096, stratified, diurnal arrivals at 2,000/s, dropout
    0.02, 1% banned, seed 0), cut to 8 commits (4 warm-up): one fold
    launch an admitted arrival, registry bytes/client within the bench's
    gate, the trace bitwise a CPU run's, the committed row within 1e-6."""
    arrival = ArrivalConfig(mode="diurnal", rate=2000.0, period_s=600.0,
                            amplitude=0.8, flash_at_s=5.0,
                            flash_duration_s=10.0, flash_boost=5.0, seed=0)
    torch.cuda.synchronize()
    reset_launch_counts()
    card = run_serve_sim(**SERVE, arrival=arrival, keep_variables=True)
    counts = launch_counts()
    cpu = run_serve_sim(**SERVE, arrival=arrival, device="cpu",
                        keep_variables=True)
    fields = ("trace_digest", "committed_updates", "distinct_contributors",
              "max_client_participation", "virtual_time_s", "crashed",
              "banned", "registry_bytes", "registry_shards_allocated",
              "sampler_peak_scratch_bytes")
    trace_same = all(card[f] == cpu[f] for f in fields)
    a, b = card.pop("variables")["w"].cpu(), cpu.pop("variables")["w"]
    rel = float((a.double() - b.double()).norm() / b.double().norm())
    expected = {"gn_forward": 0, "gn_backward": 0,
                "wsum": card["committed_updates"], "sqnorm": 0,
                "clip_agg": 0}
    print(f"[19d] serve spine, {SERVE['population']} clients, "
          f"{card['commits']} commits of K={SERVE['buffer_k']} "
          f"(row_dim {SERVE['row_dim']}): {card['committed_updates_per_sec']:.1f}"
          f" committed updates/s after {SERVE['warmup_commits']} warm-up "
          f"commits, RSS {card['rss_bytes'] / 2**20:.1f} MiB, registry "
          f"{card['registry_bytes_per_client']:.1f} bytes/client (gate "
          f"{SERVE_BYTES_PER_CLIENT_GATE}), {card['crashed']} crashed, "
          f"{card['banned']} banned; trace bitwise the CPU run's: "
          f"{trace_same}; committed row {rel:.3e} from the CPU's (bitwise "
          f"{bool(torch.equal(a, b))}); launches {counts} ({card_line()})")
    if (counts != expected or not trace_same or rel > 1e-6
            or card["registry_bytes_per_client"]
            > SERVE_BYTES_PER_CLIENT_GATE):
        raise AssertionError(f"19d: launches {counts} != {expected}, or the "
                             "trace, row or registry gate failed")
    return dict(report=card, launches=counts, row_rel=rel,
                trace_bitwise=trace_same)


def counting(cls, name: str, tally: dict):
    """Wrap cls.name to count its calls (and, for add_screened, the
    admitted ones) into `tally`; returns the restore callable."""
    orig = getattr(cls, name)

    def wrapped(self, *a, **k):
        out = orig(self, *a, **k)
        tally[name] = tally.get(name, 0) + 1
        if name == "add_screened" and out[0]:
            tally["admitted"] = tally.get("admitted", 0) + 1
        return out

    setattr(cls, name, wrapped)
    return lambda: setattr(cls, name, orig)


def ingest_full_width() -> dict:
    """19e: run_ingest_torture over TCP at ResNet-18-GN's flat width, 8
    clients, K 4, 1 warm-up + 3 commits, pool 4, decode-into and
    streaming: one fold launch an update folded; the defended arm: one
    squared distance an arrival and one clipped fold an admitted one; then
    one secure messaging round over INPROC (4 f32 clients at full width):
    the masked field sum folded on the card bitwise the plain fixed-point
    sum, the model within K * 2^-16 of the plain messaging round."""
    rec = {}
    for arm, defense in (("streaming", None),
                         ("defended", DefenseConfig(norm_bound=1e6))):
        tally: dict = {}
        restore = [counting(AsyncBuffer, "add", tally),
                   counting(AsyncBuffer, "add_screened", tally)]
        try:
            torch.cuda.synchronize()
            reset_launch_counts()
            r = run_ingest_torture(backend="TCP",
                                   base_port=free_base_port(1),
                                   defense=defense, **INGEST)
            torch.cuda.synchronize()
            counts = launch_counts()
        finally:
            for undo in restore:
                undo()
        if defense is None:
            expected = {"gn_forward": 0, "gn_backward": 0,
                        "wsum": tally.get("add", 0), "sqnorm": 0,
                        "clip_agg": 0}
        else:
            expected = {"gn_forward": 0, "gn_backward": 0, "wsum": 0,
                        "sqnorm": tally.get("add_screened", 0),
                        "clip_agg": tally.get("admitted", 0)}
        print(f"[19e] ingest torture over TCP, {arm}: {INGEST['n_clients']} "
              f"clients, p {r['p']}, K {INGEST['buffer_k']}, pool "
              f"{INGEST['ingest_pool']}: {r['committed_updates_per_sec']:.2f} "
              f"committed updates/s, decode p50 {r['decode_p50_s']:.4f} s p95 "
              f"{r['decode_p95_s']:.4f} s, {r['updates_committed']} updates "
              f"committed, {tally} buffer inserts; launches {counts} == "
              f"expected ({card_line()})")
        min_updates = INGEST["commits"] * INGEST["buffer_k"]
        if (counts != expected or r["updates_committed"] != min_updates
                or not r["finite"] or r["recv_thread_deaths"]):
            raise AssertionError(f"19e {arm}: launches {counts} != "
                                 f"{expected}, or the run failed")
        r.pop("slo", None)
        rec[arm] = dict(report=r, launches=counts, inserts=tally)
    rec["secure"] = secure_messaging_round()
    return rec


def secure_messaging_round() -> dict:
    """19e: run_messaging_fedavg(secure=...) one round over INPROC, 4 f32
    clients x 4 batches at full width, cuDNN deterministic, against the
    plain messaging round from the same init."""
    trainer, data, cfg = f32_recipe(SECURE_CLIENTS, CKPT_BATCHES, seed=7)
    cfg = dataclasses.replace(cfg, comm_round=1)
    v0 = trainer.init(torch.Generator().manual_seed(cfg.seed), "cuda")
    plain_rows, masked = {}, []
    client_row, commit = SecureAggregator.client_row, SecureAggregator.commit

    def recorded_row(self, cid, round_idx, flat, weight):
        plain_rows[cid] = (np.array(flat, np.float64), float(weight))
        return client_row(self, cid, round_idx, flat, weight)

    def recorded_commit(self, round_idx, survivors, reset=True):
        masked.append(self.field_sum(round_idx, survivors)[0])
        masked.append(self._acc.device.type)
        return commit(self, round_idx, survivors, reset)

    def both():
        SecureAggregator.client_row = recorded_row
        SecureAggregator.commit = recorded_commit
        try:
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            sec = run_messaging_fedavg(trainer, data, cfg, variables=dict(v0),
                                       secure=SecAggConfig(seed=3),
                                       timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
        finally:
            SecureAggregator.client_row = client_row
            SecureAggregator.commit = commit
        plain = run_messaging_fedavg(trainer, data, cfg, variables=dict(v0),
                                     timeout=600)
        torch.cuda.synchronize()
        return sec, plain, wall, counts

    sec, plain, wall, counts = deterministic(both)
    scfg = SecAggConfig(seed=3)
    want = None
    for flat, w in plain_rows.values():
        q = np.empty(flat.size + 1, np.int64)
        q[:-1] = mpc.quantize(flat * w, scfg.scale, scfg.prime)
        q[-1] = mpc.quantize(np.array([w]), scfg.scale, scfg.prime)[0]
        want = q if want is None else (want + q) % scfg.prime
    words, device = masked
    bitwise = bool(np.array_equal(words, want))
    dist = max(float((sec[k] - plain[k]).abs().max()) for k in plain)
    bound = SECURE_CLIENTS * 2.0 ** -16
    steps = SECURE_CLIENTS * CKPT_BATCHES
    expected = {"gn_forward": 20 * steps, "gn_backward": 20 * steps,
                "wsum": 0, "sqnorm": 0, "clip_agg": 0}
    print(f"[19e] secure messaging round over INPROC, {SECURE_CLIENTS} f32 "
          f"clients at full width: {wall:.2f} s; {words.size} field words a "
          f"client folded on {device}; field sum bitwise the plain "
          f"fixed-point sum: {bitwise}; model {dist:.3e} from the plain "
          f"round (bound K*2^-16 = {bound:.3e}); launches {counts} "
          f"({card_line()})")
    if (not bitwise or device != "cuda" or dist > bound
            or counts != expected):
        raise AssertionError("19e: the secure messaging round failed its "
                             f"checks (launches {counts} vs {expected})")
    return dict(wall_s=wall, words=int(words.size), bitwise=bitwise,
                distance=dist, launches=counts)


def connections() -> dict:
    """19f: run_connection_torture with 256 live connections on the
    reactor, p 1024, K 32, 1 warm-up + 3 commits: FD delta 0."""
    torch.cuda.synchronize()
    reset_launch_counts()
    r = run_connection_torture(base_port=free_base_port(1), **CONN)
    counts = launch_counts()
    print(f"[19f] connection torture, {CONN['n_connections']} connections: "
          f"peak open {r['open_connections_peak']}, "
          f"{r['committed_updates_per_sec']:.1f} committed updates/s, "
          f"admission p50 {r['admission_p50_s']:.5f} s p95 "
          f"{r['admission_p95_s']:.5f} s, FD delta {r['fd_leaked']}, "
          f"receive-thread deaths {r['recv_thread_deaths']}; launches "
          f"{counts} ({card_line()})")
    if r["fd_leaked"] != 0 or not r["finite"] or r["recv_thread_deaths"]:
        raise AssertionError("19f: the connection torture leaked FDs or "
                             "failed")
    r.pop("slo", None)
    r.pop("swarm", None)
    return dict(report=r, launches=counts)


def phase_slice4b() -> dict:
    """Phase 19: the block-streamed main path, the two-phase order
    statistics, checkpoint and resume, the serve spine, ingest at full
    width with the secure messaging round, and the connection torture;
    each part's seconds.  TF32 off throughout, restored after."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    rec, seconds = {}, {}
    f32_off()
    try:
        for key, part in (("19a block stream", blockstream_main_path),
                          ("19b two-phase", two_phase_orderstat),
                          ("19c checkpoint", checkpoint_resume),
                          ("19d serve", serve_spine),
                          ("19e ingest", ingest_full_width),
                          ("19f connections", connections)):
            t0 = time.perf_counter()
            rec[key] = part()
            seconds[key] = time.perf_counter() - t0
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    rec["seconds"] = seconds
    print(f"[slice 4b] phase 19 took {sum(seconds.values()):.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
          + f" ({card_line()})")
    return rec

# ---------------------------------------------------------------------------
# phase 20: slice 6a, the two-level multi-process runtime
# ---------------------------------------------------------------------------

MH_BLOCKS = 2                  # 20a-20b: blocks of 4 clients
MH_ROUNDS = 2                  # rounds an arm; rank 0 evaluates after each
# the main path's depth on the multi-process paths that compare with each
# other (20a, 22a, 24a): 4 batches a client (cut from 13 to hold the
# script's time once phase 24 joined it)
MH_BATCHES = 4
MH_SAMPLES = MH_BATCHES * BATCH
MH_ARMS = (("streaming", False), ("streaming", True), ("resident", False),
           ("resident", True))  # (residency, overlapped exchange)
MH_TIMEOUT_S = 420.0
MH_LR = dict(clients=16, spc=24, dim=16, classes=10, k_per_round=8,
             n_blocks=2, rounds=3, warmup=1, seed=0,
             modes=["streaming", "resident"], channel_timeout_s=120.0)


def rank20_main(cfg_path: str) -> int:
    """One rank of phase 20's cluster, started by the launcher as
    ``chip_smoke.py --rank20 CONFIG``: the main path's recipe through
    MultihostRunner for each arm of the config over one HostChannel
    (cuDNN deterministic), launches counted from zero just before each
    arm's run; prints one JSON line."""
    with open(cfg_path) as f:
        spec = json.load(f)
    ctx = MultihostContext.from_env()
    trainer, data, cfg = main_recipe(MH_SAMPLES)
    torch.backends.cudnn.deterministic = True
    channel = HostChannel(ctx, timeout_s=MH_TIMEOUT_S)
    out = {"rank": ctx.rank, "world": ctx.world, "arms": {}}
    v0 = None
    try:
        for arm in spec["arms"]:
            kw = dict(chunk=MAIN_CHUNK, local_dtype=torch.bfloat16,
                      streaming=arm["residency"] == "streaming")
            if arm["engine"] == "norm_clip":
                eng = MeshRobustEngine(trainer, data, dataclasses.replace(
                    cfg, stddev=1e-3), defense="norm_clip", **kw)
            else:
                eng = MeshFedAvgEngine(trainer, data, cfg, **kw)
            if v0 is None:
                v0 = eng.init_variables()
            runner = MultihostRunner(eng, ctx, n_blocks=MH_BLOCKS,
                                     channel=channel, timeout_s=MH_TIMEOUT_S,
                                     overlap_exchange=arm["overlap"])
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            v = runner.run(variables=dict(v0), rounds=MH_ROUNDS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            rep = runner.report(warmup_rounds=1)
            if spec.get("dump") and ctx.world == 1 and arm["tag"] in (
                    "streaming serial", "norm_clip"):
                # phase 24's reference: the 1-rank two-block models
                torch.save({k: t.to("cpu") for k, t in v.items()},
                           Path(spec["dump"]) / f"{arm['engine']}.pt")
            out["arms"][arm["tag"]] = dict(
                digest=variables_digest(v), launches=counts, wall_s=wall,
                round_walls=runner.round_walls,
                exchange_walls=runner.exchange_walls,
                overlap_fraction=rep["overlap_fraction"],
                carry_received=runner.carry_bytes,
                carry_raw=runner.carry_raw,
                finite=all(bool(torch.isfinite(t).all()) for t in v.values()))
        # the channel alone: an allgather of one block's f32 carry after a
        # barrier, without training (the serial exchange wall less this is
        # the ranks' skew at the barrier)
        payload = np.zeros(N_PARAMS + 2, np.float32).tobytes()
        out["channel_allgather_s"] = []
        for _ in range(3):
            channel.barrier()
            t0 = time.perf_counter()
            channel.allgather(payload)
            out["channel_allgather_s"].append(time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
    finally:
        channel.close()
    return 0


def spawn_json(cmd: list, procs: int) -> list:
    """spawn_cluster of `cmd` at `procs` ranks from the repo root; each
    rank's last stdout line, parsed."""
    root = str(Path(__file__).resolve().parent)
    env = {"PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    outs = spawn_cluster(cmd, procs, env=env, timeout_s=MH_TIMEOUT_S)
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def twolevel_expected(blocks: int, evals: int, norm_clip: bool) -> dict:
    """One rank's launches over MH_ROUNDS rounds of `blocks` blocks of 4
    clients (MH_BATCHES steps a client, 20 GroupNorm layers), `evals`
    evaluations: the fold kernel twice a block (chunk 2), or norm_clip's
    two kernels twice a block."""
    steps = MH_ROUNDS * blocks * (MAIN_CLIENTS // MH_BLOCKS) * MH_BATCHES
    folds = MH_ROUNDS * blocks * (MAIN_CLIENTS // MH_BLOCKS) // MAIN_CHUNK
    return {"gn_forward": 20 * (steps + 2 * evals), "gn_backward": 20 * steps,
            "wsum": 0 if norm_clip else folds,
            "sqnorm": folds if norm_clip else 0,
            "clip_agg": folds if norm_clip else 0}


def twolevel_main_path() -> dict:
    """20a-20b: the main path's recipe (8 clients of MH_BATCHES batches, bf16
    masters, chunk 2) through MultihostRunner with 2 blocks of 4, in real
    processes on this one card through the port's launcher: 1 rank (both
    blocks) and 2 ranks (a block each, sharing the card), streaming and
    resident, the f32 exchange serial and overlapped, then norm_clip
    (weak-DP noise on, so every rank must draw it identically).  Every
    FedAvg arm at both worlds commits one digest, norm_clip another;
    launches exact per rank."""
    arms = [dict(tag=f"{res} {'overlapped' if ov else 'serial'}",
                 engine="fedavg", residency=res, overlap=ov)
            for res, ov in MH_ARMS]
    arms.append(dict(tag="norm_clip", engine="norm_clip",
                     residency="streaming", overlap=False))
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mh_"))
    cfg_path = tmp / "arms.json"
    cfg_path.write_text(json.dumps({"arms": arms, "dump": str(tmp)}))
    cmd = [sys.executable, str(Path(__file__).resolve()), "--rank20",
           str(cfg_path)]
    docs, seconds, errs = {}, {}, []

    def cluster(procs):
        # the 1-rank and 2-rank clusters run at once (the script's time)
        try:
            t0 = time.perf_counter()
            docs[procs] = spawn_json(cmd, procs)
            seconds[procs] = time.perf_counter() - t0
        except Exception as e:       # re-raised below, after the joins
            errs.append(e)

    threads = [threading.Thread(target=cluster, args=(p,)) for p in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    docs = {p: docs[p] for p in (1, 2)}
    digests = {}
    for procs, ranks in docs.items():
        for doc in ranks:
            r = doc["rank"]
            for arm in arms:
                rec = doc["arms"][arm["tag"]]
                clip = arm["engine"] == "norm_clip"
                want = twolevel_expected(MH_BLOCKS // procs,
                                         MH_ROUNDS if r == 0 else 0, clip)
                if rec["launches"] != want or not rec["finite"]:
                    raise AssertionError(
                        f"20 {arm['tag']}, {procs} rank(s), rank {r}: "
                        f"launches {rec['launches']} != {want} or a "
                        f"non-finite model")
                digests.setdefault(arm["engine"], set()).add(rec["digest"])
                ewall = rec["exchange_walls"][-1]
                print(f"[20a] {arm['tag']}, {procs} rank(s), rank {r}: "
                      f"s/round {rec['round_walls']}, exchange wall "
                      f"{ewall:.4f} s, carry raw {rec['carry_raw'][-1]} B, "
                      f"received {rec['carry_received'][-1]} B, overlap "
                      f"fraction {rec['overlap_fraction']:.3f}; launches "
                      f"{rec['launches']} == expected; digest "
                      f"{rec['digest']}")
    for doc in docs[2]:
        print(f"[20a] the channel alone, 2 ranks, rank {doc['rank']}: an "
              f"allgather of {4 * (N_PARAMS + 2)} B a rank took "
              + ", ".join(f"{t:.4f}" for t in doc["channel_allgather_s"])
              + " s")
    bad = {k: v for k, v in digests.items() if len(v) != 1}
    print(f"[20a] two-level main path on one card: {len(arms) - 1} FedAvg "
          f"arms and norm_clip at 1 and 2 ranks, one digest each: "
          f"{ {k: len(v) == 1 for k, v in digests.items()} }; cluster walls "
          + ", ".join(f"{p} rank(s) {s:.1f} s" for p, s in seconds.items())
          + f" ({card_line()})")
    if bad:
        raise AssertionError(f"20a: the arms did not commit one model: {bad}")
    return dict(docs=docs, cluster_s=seconds, dump=str(tmp),
                channel_s={d["rank"]: d["channel_allgather_s"]
                           for d in docs[2]},
                launches={f"{p} rank(s), rank {d['rank']}":
                          d["arms"]["streaming serial"]["launches"]
                          for p, ds in docs.items() for d in ds},
                clip_launches={f"{p} rank(s), rank {d['rank']}":
                               d["arms"]["norm_clip"]["launches"]
                               for p, ds in docs.items() for d in ds})


def twolevel_card_cpu() -> dict:
    """20c: one 1-rank two-level f32 round (2 blocks of 1 client x 2
    batches, full width, TF32 off) on the card and on the CPU from the
    same weights: the update within phase 4's limits, launches exact."""
    f32_off()
    data = synthetic_data(2, 2 * BATCH, seed=1)
    cfg = FedConfig(model="resnet18_gn", dataset="cifar10",
                    client_num_in_total=2, client_num_per_round=2, epochs=1,
                    batch_size=BATCH, lr=0.1, frequency_of_the_test=10_000)
    trainer = ClientTrainer(create_model("resnet18_gn", 10), lr=0.1)
    out = {}
    for device in ("cuda", "cpu"):
        eng = MeshFedAvgEngine(trainer, data, cfg, chunk=MAIN_CHUNK,
                               streaming=True, device=device)
        v0 = eng.init_variables()
        runner = MultihostRunner(eng, MultihostContext.single(), n_blocks=2)
        reset_launch_counts()
        v1 = runner.run(variables=dict(v0), rounds=1)
        if device == "cuda":
            torch.cuda.synchronize()
            counts = launch_counts()
        out[device] = (v0, v1)
    want = {"gn_forward": 20 * (4 + 2), "gn_backward": 20 * 4, "wsum": 2,
            "sqnorm": 0, "clip_agg": 0}
    (g0, g1), (c0, c1) = out["cuda"], out["cpu"]
    whole, worst = update_distance("20c", g0, g1, c0, c1)
    print(f"[20c] f32 two-level round, 1 rank, 2 blocks of 1 client x 2 "
          f"batches: card vs CPU update distance {whole:.3e} (limit 1e-3), "
          f"worst leaves " + ", ".join(f"{k} {v:.3e}" for k, v in worst)
          + f" (limit 1e-2); launches {counts}")
    if counts != want:
        raise AssertionError(f"20c: launches {counts} != {want}")
    if whole > 1e-3 or worst[0][1] > 1e-2:
        raise AssertionError("20c: the card's two-level round differs from "
                             "the CPU's beyond phase 4's limits")
    return dict(distance=whole, worst=worst, launches=counts)


def twolevel_lr_worker() -> dict:
    """20d: the port's mh_worker (LR, 16 clients, 8 a round in 2 blocks,
    3 rounds, streaming then resident) on the card: int8_ef and topk_ef
    at 2 ranks bitwise 1 rank; then rank 1 dies at the end of round 0 and
    the failure is checked: rank 0's DeadRankError names rank 1 and the
    launcher blames rank 1."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_lr_"))
    cmd = [sys.executable, "-m", "fedml_tpu_torch.parallel.mh_worker"]
    root = str(Path(__file__).resolve().parent)
    (tmp / "die.json").write_text(
        json.dumps({**MH_LR, "die_rank": 1, "die_at_round": 0}))
    for codec in ("int8_ef", "topk_ef"):
        (tmp / f"{codec}.json").write_text(
            json.dumps({**MH_LR, "carry_codec": codec}))
    runs, errs = {}, []

    def run(key, fn):
        try:
            runs[key] = fn()
        except Exception as e:       # re-raised below, after the joins
            errs.append(e)

    # the LR clusters are tiny: all five run at once
    jobs = {(codec, procs): (lambda codec=codec, procs=procs: spawn_json(
        cmd + [str(tmp / f"{codec}.json")], procs))
        for codec in ("int8_ef", "topk_ef") for procs in (1, 2)}
    jobs["die"] = lambda: subprocess.run(
        [sys.executable, "-m", "fedml_tpu_torch.parallel.launch", "--procs",
         "2", "--timeout", str(MH_TIMEOUT_S), "--"] + cmd
        + [str(tmp / "die.json")], capture_output=True, text=True, cwd=root,
        timeout=MH_TIMEOUT_S + 60, env={**os.environ, "PYTHONPATH": root
                                        + os.pathsep
                                        + os.environ.get("PYTHONPATH", "")})
    threads = [threading.Thread(target=run, args=kv) for kv in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    die, err = runs["die"], runs["die"].stderr
    rec = {}
    for codec in ("int8_ef", "topk_ef"):
        one, two = runs[codec, 1][0], runs[codec, 2]
        same = all(d["digests"] == one["digests"] for d in two)
        rec[codec] = dict(one=one["digests"], same=same,
                          ratio=two[0]["carry_compression_ratio"],
                          bytes=two[0]["carry_allreduce_bytes_per_round"])
        print(f"[20d] LR mh_worker, {codec}: 2 ranks bitwise 1: {same}; "
              f"compression {two[0]['carry_compression_ratio']:.2f}x, "
              f"{two[0]['carry_allreduce_bytes_per_round']:.0f} B received "
              f"a round by rank 0")
        if not same or one["carry_allreduce_bytes_per_round"] != 0 \
                or two[0]["carry_allreduce_bytes_per_round"] <= 0:
            raise AssertionError(f"20d {codec}: 2 ranks {two} against 1 "
                                 f"rank {one}")
    named = bool(re.search(r"\[rank 0\].*DeadRankError.*rank\(s\) \[1\]", err))
    blamed = "rank 1/2 failed first" in err
    print(f"[20d] die_rank=1 at round 0: launcher rc {die.returncode}; "
          f"rank 0's DeadRankError names rank 1: {named}; the launcher "
          f"blames rank 1: {blamed}")
    if die.returncode == 0 or not named or not blamed:
        raise AssertionError(f"20d: the crash was not named: rc "
                             f"{die.returncode}\n{err[-3000:]}")
    rec["crash"] = dict(rc=die.returncode, named=named, blamed=blamed)
    return rec


def phase_slice6a() -> dict:
    """Phase 20: the two-level multi-process runtime on the card; each
    part's seconds.  TF32 settings restored after."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    rec, seconds = {}, {}
    try:
        for key, part in (("20a two-level main path", twolevel_main_path),
                          ("20c card vs cpu", twolevel_card_cpu),
                          ("20d lr worker", twolevel_lr_worker)):
            t0 = time.perf_counter()
            rec[key] = part()
            seconds[key] = time.perf_counter() - t0
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    rec["seconds"] = seconds
    print(f"[slice 6a] phase 20 took {sum(seconds.values()):.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
          + f" ({card_line()})")
    return rec


# ---------------------------------------------------------------------------
# phase 21: slice 6b, the elastic tier
# ---------------------------------------------------------------------------

EL_BLOCKS = 4                  # 21a: blocks of 2 clients; 3 ranks own 2, 1, 1
EL_ROUNDS = 3                  # rounds a FedAvg run
EL_CLIP_ROUNDS = 5             # rounds a norm_clip run
EL_TIMEOUT_S = 300.0
EL_HB = dict(hb_interval_s=0.25, hb_timeout_s=2.0)
EL_KILL_SLEEP_S = 3.0          # pacing of the FedAvg kill arm's rounds
EL_CLIP_SLEEP_S = 5.0          # pacing of the norm_clip kill arm's rounds
EL_HANG_S = 8.0                # the hung rank's silence (> hb_timeout_s)
EL_SERVE = dict(population=1_000_000, commits=6, warmup_commits=2,
                buffer_k=32, row_dim=4096, sampler_mode="stratified",
                dropout_prob=0.02, banned_frac=0.01, seed=0)
EL_CLUSTER = dict(population=4096, commits=4, warmup_commits=1, buffer_k=8,
                  row_dim=4096)
EL_WORKER = dict(channel_timeout_s=EL_TIMEOUT_S, **EL_HB)   # mh_worker keys


def el_engine(trainer, data, cfg, engine: str, residency: str):
    kw = dict(chunk=MAIN_CHUNK, local_dtype=torch.bfloat16,
              streaming=residency == "streaming")
    if engine == "norm_clip":
        return MeshRobustEngine(trainer, data, dataclasses.replace(
            cfg, stddev=1e-3), defense="norm_clip", **kw)
    return MeshFedAvgEngine(trainer, data, cfg, **kw)


def rank21_main(cfg_path: str) -> int:
    """One rank of a phase-21 cluster, started by the port's launcher as
    ``chip_smoke.py --rank21 CONFIG``: a training config drives the main
    path's recipe through ElasticRunner for each of its runs over one
    ElasticChannel (cuDNN deterministic, TF32 off), with the injected
    death, hang and pacing it names, launches counted from zero just
    before each run; a serve config drives run_serve_sim at
    partition=(rank, world).  Prints one JSON line (a killed or evicted
    rank prints none)."""
    with open(cfg_path) as f:
        spec = json.load(f)
    ctx = MultihostContext.from_env()
    if spec["kind"] == "serve":
        return rank21_serve(ctx, spec)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rejoining = (os.environ.get("FEDML_MH_REJOIN") == "1" and ctx.rank != 0)
    started = os.stat("/proc/self").st_ctime    # this process's start
    trainer, data, cfg = main_recipe()
    channel = ElasticChannel(
        ctx, n_items=EL_BLOCKS, timeout_s=EL_TIMEOUT_S, rejoin=rejoining,
        config_digest=hashlib.md5(json.dumps(spec, sort_keys=True).encode())
        .hexdigest(), **EL_HB)
    runs = list(spec["runs"])
    current = {"tag": None}
    rejoin_state = None

    def on_round_end(round_idx: int) -> None:
        if spec.get("sleep_s"):
            time.sleep(spec["sleep_s"])
        if rejoining:
            return
        if spec.get("die_rank") == ctx.rank and round_idx == spec["at_round"]:
            print(f"rank {ctx.rank}: injected SIGKILL-shaped exit at round "
                  f"{round_idx}", file=sys.stderr, flush=True)
            os._exit(3)
        if spec.get("hang_rank") == ctx.rank \
                and round_idx == spec["at_round"]:
            print(f"rank {ctx.rank}: injected hang at round {round_idx} "
                  f"(t={time.time():.3f})", file=sys.stderr, flush=True)
            channel.hb_paused = True
            time.sleep(EL_HANG_S)
            channel.hb_paused = False

    out = {"rank": ctx.rank, "world": ctx.world, "rejoined": rejoining,
           "runs": {}}
    try:
        # seconds from this process's start to a built trainer and channel
        # (the CUDA context comes with the first engine's upload)
        out["boot_s"] = time.time() - started
        if rejoining:
            blob, resume, tag = channel.rejoin_handshake()
            tags = [r["tag"] for r in runs]
            runs = runs[tags.index(tag):]
            rejoin_state = (blob, resume)
            out.update(rejoin_tag=tag, resume_round=resume,
                       admitted_s=time.time() - started)
        v0 = None
        for i, run in enumerate(runs):
            current["tag"] = run["tag"]
            eng = el_engine(trainer, data, cfg, run["engine"],
                            run["residency"])
            if v0 is None:
                v0 = eng.init_variables()
            runner = ElasticRunner(eng, ctx, n_blocks=EL_BLOCKS,
                                   channel=channel, timeout_s=EL_TIMEOUT_S,
                                   run_tag=run["tag"],
                                   on_round_end=on_round_end, **EL_HB)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            try:
                v = runner.run(variables=dict(v0), rounds=run["rounds"],
                               rejoin=False,
                               rejoin_state=rejoin_state if i == 0 else None)
            except DeadRankError as e:
                if spec.get("hang_rank") == ctx.rank:
                    print(f"rank {ctx.rank}: evicted after the injected "
                          f"hang: {e}", file=sys.stderr, flush=True)
                    return 4
                raise
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rep = runner.report()
            out["runs"][run["tag"]] = dict(
                digest=variables_digest(v), launches=launch_counts(),
                wall_s=wall, round_walls=runner.round_walls,
                computed=rep["computed"], readopted=rep["readopted"],
                readopt_s=rep["readopt_s"], evals=len(eng.metrics_history),
                epoch=rep["epoch"], members=rep["members"],
                view_changes=rep["view_changes"],
                view_events=rep["view_events"],
                view_change_latency_s=rep["view_change_latency_s"],
                rejoined_at_round=rep["rejoined_at_round"],
                resident_blocks=rep["resident_blocks"],
                peak_bytes=torch.cuda.max_memory_allocated(),
                finite=all(bool(torch.isfinite(t).all()) for t in v.values()))
        print(json.dumps(out), flush=True)
    finally:
        channel.close()
    return 0


def rank21_serve(ctx, spec: dict) -> int:
    """21b's serve rank: run_serve_sim at partition=(rank, world) over a
    HostChannel, or an ElasticChannel with rank `crash_rank` closing its
    channel after `crash_at` commits; wsum launches counted."""
    if spec.get("elastic"):
        ch = ElasticChannel(ctx, n_items=ctx.world, config_digest="serve21",
                            timeout_s=EL_TIMEOUT_S, **EL_HB)
    else:
        ch = HostChannel(ctx, timeout_s=EL_TIMEOUT_S)
    crash = (spec.get("crash_at") if spec.get("crash_rank") == ctx.rank
             else None)
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        rep = run_serve_sim(**EL_SERVE, partition=(ctx.rank, ctx.world),
                            channel=ch, elastic=bool(spec.get("elastic")),
                            crash_at_commit=crash)
        rep["launches"] = launch_counts()
    finally:
        ch.close()
    print(json.dumps({"rank": ctx.rank, "serve": rep}, default=str),
          flush=True)
    return 0


def el_launch(cfg: dict, procs: int, respawn: bool, tmp: Path) -> dict:
    """One phase-21 cluster through ``python -m
    fedml_tpu_torch.parallel.launch --elastic [--respawn]``: its exit
    code, stderr and each rank's JSON lines (a respawned rank's
    incarnations in order)."""
    path = tmp / f"{cfg['name']}.json"
    path.write_text(json.dumps(cfg))
    root = str(Path(__file__).resolve().parent)
    argv = [sys.executable, "-m", "fedml_tpu_torch.parallel.launch",
            "--procs", str(procs), "--timeout", str(EL_TIMEOUT_S),
            "--elastic"] + (["--respawn"] if respawn else []) + [
        "--", sys.executable, str(Path(__file__).resolve()), "--rank21",
        str(path)]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, cwd=root,
                          timeout=EL_TIMEOUT_S + 60,
                          env={**os.environ, "PYTHONPATH": root + os.pathsep
                               + os.environ.get("PYTHONPATH", "")})
    docs: dict = {}
    for line in proc.stdout.splitlines():
        m = re.match(r"\[rank (\d+)\] (\{.*\})$", line)
        if m:
            docs.setdefault(int(m.group(1)), []).append(json.loads(m.group(2)))
    return dict(rc=proc.returncode, stderr=proc.stderr, docs=docs,
                wall_s=time.perf_counter() - t0)


def el_expected(computed: list, evals: int, norm_clip: bool) -> dict:
    """One incarnation's launches from the blocks it computed (its owned
    blocks and the re-adopted ones, 2 clients of 13 steps each, chunk 2:
    one fold a block) and rank 0's evaluations, twolevel_expected's
    arithmetic."""
    blocks = len(computed)
    steps = blocks * (MAIN_CLIENTS // EL_BLOCKS) * BATCHES
    folds = blocks * (MAIN_CLIENTS // EL_BLOCKS) // MAIN_CHUNK
    return {"gn_forward": 20 * (steps + 2 * evals), "gn_backward": 20 * steps,
            "wsum": 0 if norm_clip else folds,
            "sqnorm": folds if norm_clip else 0,
            "clip_agg": folds if norm_clip else 0}


def elastic_main_path() -> dict:
    """21a: the main path's recipe through ElasticRunner (4 blocks of 2
    clients: at 3 ranks rank 0 owns two, ranks 1 and 2 one each), each
    cluster launched through the port's launcher with the ranks sharing
    this card: clean FedAvg at 1 rank and at 3 ranks (streaming and
    resident) at once; then, at once, clean norm_clip at 1 rank, a hang
    arm (rank 2's heartbeats stop after round 1 and it is silent for
    EL_HANG_S) and the kill arms (rank 1 exits abruptly after round 0, is
    respawned once and rejoins through the snapshot), FedAvg streaming
    and resident and norm_clip with its weak-DP noise.  Every FedAvg run of every
    reporting incarnation commits the clean 1-rank digest, norm_clip its
    own; the clean runs read 0 view changes at epoch 0; launches exact
    for every incarnation that reports."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_el_"))
    fed = [dict(tag="streaming", engine="fedavg", residency="streaming",
                rounds=EL_ROUNDS),
           dict(tag="resident", engine="fedavg", residency="resident",
                rounds=EL_ROUNDS)]
    clip = [dict(tag="norm_clip", engine="norm_clip", residency="streaming",
                 rounds=EL_CLIP_ROUNDS)]
    # the clean runs first (they must read no view change), then the
    # fault arms together: the kill arms sleep between rounds
    waves = [
        {"clean 1 rank": (dict(kind="train", runs=fed[:1]), 1, False),
         "clean 3 ranks": (dict(kind="train", runs=fed), 3, False)},
        {"clean 1 rank norm_clip": (dict(kind="train", runs=clip), 1, False),
         "hang": (dict(kind="train", runs=fed[:1], hang_rank=2, at_round=1),
                  3, False),
         "kill": (dict(kind="train", runs=fed, die_rank=1, at_round=0,
                       sleep_s=EL_KILL_SLEEP_S), 3, True),
         "norm_clip kill": (dict(kind="train", runs=clip, die_rank=1,
                                 at_round=0, sleep_s=EL_CLIP_SLEEP_S), 3,
                            True)}]
    arms, seconds = {}, {}
    for wave in waves:
        results, errs = {}, []

        def launch(name, cfg, procs, respawn):
            try:
                results[name] = el_launch({**cfg, "name": name.replace(
                    " ", "_")}, procs, respawn, tmp)
            except Exception as e:       # re-raised below, after the joins
                errs.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=launch, args=(n, *a))
                   for n, a in wave.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        seconds[" + ".join(wave)] = time.perf_counter() - t0
        if errs:
            raise errs[0]
        arms.update(results)
    for name, res in arms.items():
        if res["rc"] != 0:
            raise AssertionError(f"21a {name}: launcher rc {res['rc']}\n"
                                 f"{res['stderr'][-3000:]}")
    digests: dict = {}
    rows = []
    for name, res in arms.items():
        for r, incs in sorted(res["docs"].items()):
            for doc in incs:
                for tag, rec in doc["runs"].items():
                    clip_run = tag == "norm_clip"
                    want = el_expected(rec["computed"], rec["evals"], clip_run)
                    if rec["launches"] != want or not rec["finite"]:
                        raise AssertionError(
                            f"21a {name}, rank {r}, {tag}: launches "
                            f"{rec['launches']} != {want} or a non-finite "
                            f"model")
                    if r != 0 and rec["evals"]:
                        raise AssertionError(f"21a {name}: rank {r} "
                                             f"evaluated")
                    digests.setdefault("norm_clip" if clip_run else "fedavg",
                                       set()).add(rec["digest"])
                    walls = rec["round_walls"]
                    rows.append(dict(arm=name, rank=r, run=tag,
                                     rejoined=doc["rejoined"],
                                     boot_s=doc.get("boot_s"),
                                     s_per_round=walls,
                                     view_changes=rec["view_changes"],
                                     epoch=rec["epoch"],
                                     latency_s=rec["view_change_latency_s"],
                                     readopted=rec["readopted"],
                                     readopt_s=rec["readopt_s"],
                                     peak_gib=rec["peak_bytes"] / 2**30,
                                     launches=rec["launches"],
                                     resident_blocks=rec["resident_blocks"]))
                    print(f"[21a] {name}, rank {r}"
                          f"{' (rejoined)' if doc['rejoined'] else ''}, "
                          f"{tag}: s/round "
                          + ", ".join(f"{w:.3f}" for w in walls)
                          + f"; view changes {rec['view_changes']} (epoch "
                          f"{rec['epoch']}), view-change latency "
                          f"{rec['view_change_latency_s'] * 1e3:.2f} ms; "
                          f"re-adopted {rec['readopted']} in "
                          + ", ".join(f"{s:.3f}" for s in rec["readopt_s"])
                          + f" s; peak device memory "
                          f"{rec['peak_bytes'] / 2**30:.2f} GiB; resident "
                          f"blocks {rec['resident_blocks']}; launches "
                          f"{rec['launches']} == expected; digest "
                          f"{rec['digest']}")
    # the clean runs: no view change, epoch 0, no re-adoption
    for name in ("clean 1 rank", "clean 3 ranks", "clean 1 rank norm_clip"):
        for incs in arms[name]["docs"].values():
            for rec in incs[0]["runs"].values():
                if rec["view_changes"] or rec["epoch"] or rec["readopted"]:
                    raise AssertionError(
                        f"21a {name}: a clean run read {rec['view_changes']} "
                        f"view changes at epoch {rec['epoch']}: a healthy "
                        f"rank missed its heartbeats")
    checks = {}
    for name in ("kill", "norm_clip kill"):
        docs = arms[name]["docs"]
        rej = [d for d in docs.get(1, []) if d["rejoined"]]
        last = list(docs[0][0]["runs"].values())[-1]
        # the rejoiner must train after its admission, or its digest is
        # only the snapshot's
        trained = sum(len(rec["computed"]) for d in rej
                      for rec in d["runs"].values())
        checks[name] = dict(
            rejoined=bool(rej), rejoiner_blocks=trained,
            view_changes=last["view_changes"],
            respawned="respawning once" in arms[name]["stderr"],
            rejoin_boot_s=rej[0].get("boot_s") if rej else None,
            rejoin_admitted_s=rej[0].get("admitted_s") if rej else None,
            rejoin_tag=rej[0].get("rejoin_tag") if rej else None,
            resume_round=rej[0].get("resume_round") if rej else None)
        if not rej or not trained or last["view_changes"] < 2 \
                or not checks[name]["respawned"]:
            raise AssertionError(f"21a {name}: {checks[name]}\n"
                                 f"{arms[name]['stderr'][-3000:]}")
    hang0 = arms["hang"]["docs"][0][0]["runs"]["streaming"]
    evicted = [e for e in hang0["view_events"] if e.get("dead")]
    checks["hang"] = dict(evicted=evicted, rank2_reported=2 in
                          arms["hang"]["docs"])
    if [e["dead"] for e in evicted] != [[2]] \
            or "heartbeat" not in evicted[0]["reason"]:
        raise AssertionError(f"21a hang: evictions {evicted}")
    bad = {k: v for k, v in digests.items() if len(v) != 1}
    clean1 = arms["clean 1 rank"]["docs"][0][0]["runs"]
    print(f"[21a] elastic main path on one card: FedAvg one digest over "
          f"every run and incarnation: {len(digests['fedavg']) == 1} "
          f"({clean1['streaming']['digest']}); norm_clip one digest over "
          f"its clean and kill arms: {len(digests['norm_clip']) == 1}; "
          f"kill arm {checks['kill']}; norm_clip kill arm "
          f"{checks['norm_clip kill']}; hang arm evicted rank 2 "
          f"({evicted[0]['reason']}, {evicted[0]['latency_s'] * 1e3:.2f} ms "
          f"to re-task); waves "
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
          + f" ({card_line()})")
    if bad:
        raise AssertionError(f"21a: the arms did not commit one model: {bad}")
    return dict(rows=rows, checks=checks, seconds=seconds,
                launches={f"elastic {n} rank 0 {tag}": rec["launches"]
                          for n, res in arms.items()
                          for tag, rec in res["docs"][0][0]["runs"].items()})


def serve_sharded() -> dict:
    """21b: run_serve_sim at partition=(r, 2) over a HostChannel in two
    processes against the same in two threads of this process (the trace
    and committed digests equal), then the elastic variant in two
    processes with rank 1 closing its channel after 3 commits (rank 0
    re-adopts its range and finishes); wsum launches one an admitted
    row."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    root = str(Path(__file__).resolve().parent)
    env = {"PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    cmd = [sys.executable, str(Path(__file__).resolve()), "--rank21"]
    cfgs = {"host": dict(kind="serve"),
            "elastic": dict(kind="serve", elastic=True, crash_rank=1,
                            crash_at=3)}
    for k, v in cfgs.items():
        (tmp / f"{k}.json").write_text(json.dumps(v))
    procs: dict = {}

    def spawn(key):
        outs = spawn_cluster(cmd + [str(tmp / f"{key}.json")], 2, env=env,
                             timeout_s=EL_TIMEOUT_S, elastic=key == "elastic")
        procs[key] = {json.loads(o.strip().splitlines()[-1])["rank"]:
                      json.loads(o.strip().splitlines()[-1])["serve"]
                      for o in outs}

    threads = [threading.Thread(target=spawn, args=(k,)) for k in cfgs]
    for t in threads:
        t.start()
    # the same two ranks on threads of this process
    port = free_base_port(1)
    local: dict = {}

    def rank(r):
        ch = HostChannel(MultihostContext(r, 2, f"localhost:{port}"),
                         timeout_s=EL_TIMEOUT_S)
        try:
            local[r] = run_serve_sim(**EL_SERVE, partition=(r, 2), channel=ch)
        finally:
            ch.close()

    torch.cuda.synchronize()
    reset_launch_counts()
    ts = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    counts = launch_counts()
    for t in threads:
        t.join()
    if set(procs) != set(cfgs) or set(local) != {0, 1}:
        raise AssertionError(f"21b: a serve cluster did not report: "
                             f"{sorted(procs)}, {sorted(local)}")
    host = procs["host"]
    same = all(host[r][f] == local[r][f] for r in (0, 1)
               for f in ("trace_digest", "committed_digest",
                         "committed_updates", "crashed", "banned"))
    one = host[0]["committed_digest"] == host[1]["committed_digest"]
    exact = all(d["launches"]["wsum"] == d["committed_updates"]
                for p in procs.values() for d in p.values())
    exact &= counts["wsum"] == sum(local[r]["committed_updates"]
                                   for r in (0, 1))
    el = procs["elastic"]
    readopt = (el[0]["commits"] == EL_SERVE["commits"]
               and el[1]["elastic"]["crashed_at_commit"] == 3
               and 1 in el[0]["elastic"]["adopted_items"]
               and el[0]["elastic"]["view_changes"] >= 1)
    for key, p in procs.items():
        for r, d in sorted(p.items()):
            print(f"[21b] serve {key}, rank {r} of 2: {d['commits']} commits, "
                  f"{d['committed_updates']} updates "
                  f"({d['committed_updates_per_sec']:.1f}/s), lanes "
                  f"{d.get('elastic', {}).get('lanes', [r])}, wsum launches "
                  f"{d['launches']['wsum']}, trace {d['trace_digest']}, "
                  f"digest {d['committed_digest']}")
    print(f"[21b] host-sharded serve, {EL_SERVE['population']} clients in 2 "
          f"ranges: two processes equal two threads (traces and digests): "
          f"{same}; one digest across ranks: {one}; wsum launches one an "
          f"admitted row: {exact}; elastic re-adoption of rank 1's range "
          f"after its crash at commit 3: {readopt} ({card_line()})")
    if not (same and one and exact and readopt):
        raise AssertionError(f"21b serve: {procs} vs {local}")
    return dict(procs=procs, launches={
        f"serve sharded {k} rank {r}": d["launches"]
        for k, p in procs.items() for r, d in p.items()})


def feed_frames(port: int, frames: list, hold: threading.Event,
                deadline_s: float = 120.0) -> None:
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            send_uplinks("127.0.0.1", port, frames, hold_open=hold,
                         timeout_s=EL_TIMEOUT_S)
            return
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def serving_cluster() -> dict:
    """21b: the serve_cluster route of the port's mh_worker at 2 ranks
    under the elastic launcher, fed live frames from this process (equal
    committed digests, one wsum launch an admitted row); and at world 1
    the socket-fed lane against the synthetic serve simulation on the
    same rows (one digest)."""
    c = EL_CLUSTER
    k, dim, commits = c["buffer_k"], c["row_dim"], c["commits"]
    seed, pop = 7, 64
    torch.cuda.synchronize()
    reset_launch_counts()
    sim = run_serve_sim(pop, commits=commits, warmup_commits=1, buffer_k=k,
                        row_dim=dim, seed=seed,
                        arrival=ArrivalConfig(mode="constant", rate=1000.0,
                                              seed=seed))
    pool = np.random.default_rng([seed, 2]).standard_normal(
        (64, dim)).astype(np.float32)
    frames = [make_uplink_frame(pool[i % 64], sender=1)
              for i in range(commits * k)]
    port = free_base_port(1)
    hold = threading.Event()
    feeder = threading.Thread(target=feed_frames, args=(port, frames, hold),
                              daemon=True)
    feeder.start()
    try:
        one = run_cluster_serve(pop, commits=commits, warmup_commits=1,
                                buffer_k=k, row_dim=dim, port=port,
                                n_connections=4, ingest_pool=1,
                                window_deadline_s=EL_TIMEOUT_S,
                                timeout_s=EL_TIMEOUT_S,
                                backlog_cap=commits * k)
    finally:
        hold.set()
    counts1 = launch_counts()
    world1 = one["committed_digest"] == sim["committed_digest"]
    # 2 ranks through the port's mh_worker, fed from here
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cluster_"))
    ports = [free_base_port(1) for _ in range(2)]
    cfg = {"serve_cluster": {**c, "connections": 8, "ingest_pool": 1,
                             "window_deadline_s": 60.0,
                             "timeout_s": EL_TIMEOUT_S, "ports": ports},
           **EL_WORKER}
    (tmp / "cluster.json").write_text(json.dumps(cfg))
    rows = np.random.default_rng(3).standard_normal((64, dim)).astype(
        np.float32)
    hold = threading.Event()
    feeders = [threading.Thread(target=feed_frames, daemon=True, args=(
        ports[r], [make_uplink_frame(rows[(r * 16 + i) % 64], sender=1)
                   for i in range(commits * k)], hold)) for r in (0, 1)]
    for t in feeders:
        t.start()
    root = str(Path(__file__).resolve().parent)
    try:
        outs = spawn_cluster(
            [sys.executable, "-m", "fedml_tpu_torch.parallel.mh_worker",
             str(tmp / "cluster.json")], 2, timeout_s=EL_TIMEOUT_S,
            elastic=True, env={"PYTHONPATH": root + os.pathsep
                               + os.environ.get("PYTHONPATH", "")})
    finally:
        hold.set()
    docs = {r: json.loads(o.strip().splitlines()[-1])["serve_cluster"]
            for r, o in enumerate(outs)}
    agree = docs[0]["committed_digest"] == docs[1]["committed_digest"]
    exact = (all(d["launches"]["wsum"] == d["committed_updates"]
                 == commits * k for d in docs.values())
             and counts1["wsum"] == sim["committed_updates"]
             + one["committed_updates"])
    for r, d in docs.items():
        print(f"[21b] serve_cluster route, rank {r} of 2: {d['commits']} "
              f"commits, {d['committed_updates']} updates "
              f"({d['committed_updates_per_sec']:.1f}/s local, "
              f"{d['cluster_updates_per_sec']:.1f}/s cluster), admission "
              f"p50 {d['admission_p50_s'] * 1e3:.2f} ms, deadline windows "
              f"{d['deadline_windows']}, wsum launches "
              f"{d['launches']['wsum']}, digest {d['committed_digest']}")
    print(f"[21b] serving cluster: 2 ranks agree {agree}; world 1 socket-fed "
          f"lane equals the synthetic serve sim's digest {world1}; wsum "
          f"launches exact {exact} ({card_line()})")
    if not (agree and world1 and exact):
        raise AssertionError(f"21b cluster: {docs}, world 1 {one} vs {sim}")
    return dict(docs=docs, world1=one, launches={
        "serve cluster world 1": counts1,
        **{f"serve cluster rank {r}": d["launches"] for r, d in docs.items()}})


def phase_slice6b() -> dict:
    """Phase 21: the elastic tier on the card; each part's seconds.  TF32
    settings restored after."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    rec, seconds, errs = {}, {}, []

    def part(key, fn):
        try:
            t0 = time.perf_counter()
            rec[key] = fn()
            seconds[key] = time.perf_counter() - t0
        except Exception as e:       # re-raised below, after the join
            errs.append(e)

    # 21a's clusters are processes of their own: 21b runs meanwhile, its
    # parts one after another (each counts this process's launches)
    t_all = time.perf_counter()
    main = threading.Thread(target=part, args=("21a elastic main path",
                                               elastic_main_path))
    main.start()
    try:
        part("21b serve sharded", serve_sharded)
        part("21b serving cluster", serving_cluster)
    finally:
        main.join()
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    if errs:
        raise errs[0]
    seconds["phase (21b under 21a)"] = time.perf_counter() - t_all
    rec["seconds"] = seconds
    print(f"[slice 6b] phase 21 took "
          f"{seconds['phase (21b under 21a)']:.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
          + f" ({card_line()})")
    return rec


# ---------------------------------------------------------------------------
# phase 22: slice 6c-i, the client-axis mesh across ranks
# ---------------------------------------------------------------------------

MESH_ROUNDS = MH_ROUNDS        # 22a FedAvg and norm_clip rounds: phase 20's
MESH_SMALL_BATCHES = 4         # 22b and gossip: batches a client (cut depth)
MESH_TIMEOUT_S = 420.0
MESH_TOL = dict(rtol=5e-4, atol=5e-5)   # tests/test_parallel.py:93-95


def mesh_case(tmp: Path, name: str, data_paths: dict, arms: list) -> Path:
    """A mesh worker case on phase 5's recipe (ResNet-18-GN at full width,
    bf16 compute, cuDNN deterministic); `data_paths` maps a depth to its
    pickled data."""
    _, _, cfg = main_recipe()
    case = dict(data=data_paths["main"], out=str(tmp), deterministic=True,
                timeout_s=MESH_TIMEOUT_S,
                model={"name": "resnet18_gn", "output_dim": 10},
                trainer={"lr": cfg.lr, "train_dtype": "bfloat16"},
                cfg={k: getattr(cfg, k) for k in (
                    "model", "dataset", "client_num_in_total",
                    "client_num_per_round", "epochs", "batch_size", "lr",
                    "frequency_of_the_test")},
                arms=[{**{k: v for k, v in a.items() if k != "depth"},
                       "data": data_paths[a.get("depth", "main")]}
                      for a in arms])
    path = tmp / f"{name}.json"
    path.write_text(json.dumps(case))
    return path


def mesh_launch(path: Path, procs: int, tag: str = "22") -> dict:
    """One phase-22 (or `tag`) cluster through ``python -m
    fedml_tpu_torch.parallel.launch --jax-distributed``: each rank's JSON
    line, by rank.  Any rank's failure fails the phase."""
    root = str(Path(__file__).resolve().parent)
    argv = [sys.executable, "-m", "fedml_tpu_torch.parallel.launch",
            "--procs", str(procs), "--timeout", str(MESH_TIMEOUT_S),
            "--jax-distributed", "--", sys.executable, "-m",
            "fedml_tpu_torch.parallel.mesh_worker", str(path)]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, cwd=root,
                          timeout=MESH_TIMEOUT_S + 60,
                          env={**os.environ, "PYTHONPATH": root + os.pathsep
                               + os.environ.get("PYTHONPATH", "")})
    docs = {}
    for line in proc.stdout.splitlines():
        m = re.match(r"\[rank (\d+)\] (\{.*\})$", line)
        if m:
            docs[int(m.group(1))] = json.loads(m.group(2))
    if proc.returncode != 0 or sorted(docs) != list(range(procs)):
        raise AssertionError(f"{tag}: the {procs}-rank mesh cluster failed: "
                             f"rc {proc.returncode}\n{proc.stderr[-4000:]}")
    return dict(docs=docs, wall_s=time.perf_counter() - t0)


def mesh_expected(lanes: int, batches: int, rounds: int, evals: int,
                  chunk_kernel: Optional[str]) -> dict:
    """One rank's launches: `lanes` clients of `batches` steps a round,
    `evals` evaluations (2 batches each), and the chunk fold's kernel (one
    launch a chunk of 2; norm_clip's two)."""
    steps = rounds * lanes * batches
    folds = rounds * lanes // MAIN_CHUNK
    out = {"gn_forward": 20 * (steps + 2 * evals), "gn_backward": 20 * steps,
           "wsum": 0, "sqnorm": 0, "clip_agg": 0}
    if chunk_kernel == "norm_clip":
        out.update(sqnorm=folds, clip_agg=folds)
    elif chunk_kernel == "wsum":
        out["wsum"] = folds
    return out


def mesh_one_card(data_paths: dict) -> dict:
    """The parent's references on this card (cuDNN deterministic): phase
    5's MeshFedAvgEngine round with no mesh and on a mesh of one rank; the
    one-card median round; the gossip ring of one rank at 22b's depth."""
    trainer, data, cfg = main_recipe(MH_SAMPLES)
    kw = dict(chunk=MAIN_CHUNK, local_dtype=torch.bfloat16, streaming=True)
    out = {}

    def run(tag, eng, v0, rounds=1):
        t0 = time.perf_counter()
        v = eng.run(variables=dict(v0), rounds=rounds)
        torch.cuda.synchronize()
        out[tag] = dict(digest=variables_digest(v),
                        wall_s=time.perf_counter() - t0)

    def body():
        one = MeshFedAvgEngine(trainer, data, cfg, **kw)
        v0 = one.init_variables()
        run("one card", one, v0)
        run("mesh of one", MeshFedAvgEngine(trainer, data, cfg,
                                            mesh=make_mesh(1), **kw), v0)
        run("median one card", MeshRobustEngine(
            trainer, data, cfg, defense="median", **kw), v0)
        with open(data_paths["small"], "rb") as f:
            small = pickle.load(f)
        gossip = MeshGossipEngine(trainer, small, cfg, mesh=make_mesh(1))
        t0 = time.perf_counter()
        rows = gossip.run(rounds=1, variables=dict(v0))
        out["gossip ring of one"] = dict(
            digest=variables_digest(gossip.worker_variables(rows)),
            wall_s=time.perf_counter() - t0)

    deterministic(body)
    return out


def mesh_main_path(ref_digests: Optional[dict]) -> dict:
    """22a and 22b: the mesh worker's clusters on this card, started
    through the launcher at once with the parent's one-card references.
    22a (2 ranks, phase 5's 8 clients at MH_BATCHES batches, chunk 2, bf16
    masters, streaming): MeshFedAvgEngine and norm_clip with weak-DP noise
    2 rounds each, whose digests are phase 20's 1-rank two-block runs'
    (`ref_digests` by engine; run here when None), one median round
    bitwise the one-card round, and MeshGossipEngine's ring of 2 (22b's depth) bitwise
    the ring of one.  22b (4 ranks, 8 clients of 4 batches, 1 round):
    MeshHierarchicalEngine on 2 x 2 with one inner round, within f32
    tolerance of the flat mesh round of 4.  Launches exact per rank."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    trainer, data, cfg = main_recipe(MH_SAMPLES)
    small = synthetic_data(MAIN_CLIENTS, MESH_SMALL_BATCHES * BATCH, seed=2)
    data_paths = {"main": str(tmp / "main.pkl"), "small": str(tmp / "small.pkl")}
    for key, d in (("main", data), ("small", small)):
        with open(data_paths[key], "wb") as f:
            pickle.dump(d, f)
    bf16 = dict(chunk=MAIN_CHUNK, local_dtype="bfloat16")
    two = mesh_case(tmp, "two", data_paths, [
        dict(tag="fedavg", engine="fedavg", mesh={"kind": "1d"},
             rounds=MESH_ROUNDS, engine_kw={**bf16, "streaming": True}),
        dict(tag="norm_clip", engine="robust", mesh={"kind": "1d"},
             rounds=MESH_ROUNDS, cfg={"stddev": 1e-3},
             engine_kw={**bf16, "streaming": True, "defense": "norm_clip"}),
        dict(tag="median", engine="robust", mesh={"kind": "1d"}, rounds=1,
             engine_kw={**bf16, "streaming": True, "defense": "median"}),
        dict(tag="gossip", engine="gossip", mesh={"kind": "1d"}, rounds=1,
             depth="small")])
    four = mesh_case(tmp, "four", data_paths, [
        dict(tag="hierarchical", engine="hierarchical",
             mesh={"kind": "2d", "n_silos": 2, "per_silo": 2}, rounds=1,
             depth="small", save=True,
             engine_kw={**bf16, "group_comm_round": 1}),
        dict(tag="flat", engine="fedavg", mesh={"kind": "1d"}, rounds=1,
             depth="small", save=True, engine_kw={**bf16, "streaming": True})])
    runs, errs, seconds = {}, [], {}

    def job(key, fn):
        try:
            t0 = time.perf_counter()
            runs[key] = fn()
            seconds[key] = time.perf_counter() - t0
        except Exception as e:       # re-raised below, after the joins
            errs.append(e)

    jobs = {"22a 2 ranks": lambda: mesh_launch(two, 2),
            "22b 4 ranks": lambda: mesh_launch(four, 4)}
    if ref_digests is None:
        arms = [dict(tag="streaming serial", engine="fedavg",
                     residency="streaming", overlap=False),
                dict(tag="norm_clip", engine="norm_clip",
                     residency="streaming", overlap=False)]
        (tmp / "ref.json").write_text(json.dumps({"arms": arms}))
        jobs["phase 20 reference"] = lambda: spawn_json(
            [sys.executable, str(Path(__file__).resolve()), "--rank20",
             str(tmp / "ref.json")], 1)
    threads = [threading.Thread(target=job, args=kv) for kv in jobs.items()]
    for t in threads:
        t.start()
    job("22 one-card references", lambda: mesh_one_card(data_paths))
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    if ref_digests is None:
        ref_digests = phase20_digests(runs["phase 20 reference"][0])
    ref = runs["22 one-card references"]
    a, b = runs["22a 2 ranks"]["docs"], runs["22b 4 ranks"]["docs"]
    checks = {
        "fedavg 2 ranks == phase 20's 1 rank x 2 blocks":
            {d["arms"]["fedavg"]["digest"] for d in a.values()}
            == {ref_digests["fedavg"]},
        "mesh of one == one card": ref["mesh of one"]["digest"]
            == ref["one card"]["digest"],
        "norm_clip 2 ranks == phase 20's 1 rank x 2 blocks":
            {d["arms"]["norm_clip"]["digest"] for d in a.values()}
            == {ref_digests["norm_clip"]},
        "median 2 ranks == one card":
            {d["arms"]["median"]["digest"] for d in a.values()}
            == {ref["median one card"]["digest"]},
        "gossip ring of 2 == ring of one":
            {d["arms"]["gossip"]["digest"] for d in a.values()}
            == {ref["gossip ring of one"]["digest"]},
        "hierarchical 2 x 2: 4 ranks one digest":
            len({d["arms"]["hierarchical"]["digest"]
                 for d in b.values()}) == 1,
        "flat mesh of 4: 4 ranks one digest":
            len({d["arms"]["flat"]["digest"] for d in b.values()}) == 1}
    hier = torch.load(tmp / "hierarchical.rank0.pt")
    flat = torch.load(tmp / "flat.rank0.pt")
    worst = max(float((hier[k] - flat[k]).abs().max()) for k in flat)
    checks["hierarchical within f32 tolerance of flat"] = all(
        torch.allclose(hier[k], flat[k], **MESH_TOL) for k in flat)
    # launches exact per rank (rank 0 evaluates after the first and last
    # round)
    want = {
        "fedavg": lambda r: mesh_expected(4, MH_BATCHES, MESH_ROUNDS,
                                          2 * (r == 0), "wsum"),
        "norm_clip": lambda r: mesh_expected(4, MH_BATCHES, MESH_ROUNDS,
                                             2 * (r == 0), "norm_clip"),
        "median": lambda r: mesh_expected(4, MH_BATCHES, 1, r == 0, None),
        "gossip": lambda r: mesh_expected(4, MESH_SMALL_BATCHES, 1, r == 0,
                                          None),
        "hierarchical": lambda r: mesh_expected(2, MESH_SMALL_BATCHES, 1,
                                                r == 0, "wsum"),
        "flat": lambda r: mesh_expected(2, MESH_SMALL_BATCHES, 1, r == 0,
                                        "wsum")}
    launches, bad = {}, []
    for docs in (a, b):
        for r, d in docs.items():
            for tag, rec in d["arms"].items():
                launches[f"mesh {tag} r{r}"] = rec["launches"]
                if rec["launches"] != want[tag](r) or not rec["finite"]:
                    bad.append(f"{tag} rank {r}: {rec['launches']} != "
                               f"{want[tag](r)} or non-finite")
                walls, nbytes = rec["gather_walls"], rec["gather_bytes"]
                print(f"[22] {tag}, {len(docs)} ranks, rank {r}: s/round "
                      + ", ".join(f"{w:.3f}" for w in rec["round_walls"])
                      + f"; {len(walls)} gathers, wall "
                      + ", ".join(f"{w:.4f}" for w in walls) + " s, "
                      f"received {sum(nbytes)} B ({max(nbytes, default=0)} "
                      f"B the largest); peak device memory "
                      f"{rec['peak_bytes'] / 2**30:.3f} GiB; launches "
                      f"{rec['launches']}; digest {rec['digest']}")
    for k, v in ref.items():
        print(f"[22] one-card reference {k}: {v['wall_s']:.2f} s, digest "
              f"{v['digest']}")
    print(f"[22] phase 20's 1-rank two-block digests {ref_digests}; "
          f"hierarchical against flat: max abs difference {worst:.3e}")
    print(f"[22] checks: {checks}; launches exact: {not bad}; cluster "
          "walls " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
          + f" ({card_line()})")
    if bad or not all(checks.values()):
        raise AssertionError(f"22: {bad} {checks}")
    return dict(checks=checks, launches=launches, seconds=seconds,
                docs={k: v["docs"] for k, v in runs.items()
                      if k.startswith("22") and "docs" in v},
                references=ref, hier_flat_max_abs=worst)


def phase20_digests(doc: dict) -> dict:
    """A phase-20 rank's FedAvg (streaming, serial) and norm_clip digests."""
    return {"fedavg": doc["arms"]["streaming serial"]["digest"],
            "norm_clip": doc["arms"]["norm_clip"]["digest"]}


def phase_slice6c_i(slice6a: Optional[dict] = None) -> dict:
    """Phase 22: the client-axis mesh across ranks on the card; its
    seconds.  With phase 20's record, its 1-rank two-block FedAvg and
    norm_clip digests are the references of 22a's."""
    ref = None
    if slice6a is not None:
        ref = phase20_digests(slice6a["20a two-level main path"]["docs"][1][0])
    t0 = time.perf_counter()
    rec = mesh_main_path(ref)
    rec["seconds"]["phase"] = time.perf_counter() - t0
    print(f"[slice 6c-i] phase 22 took {rec['seconds']['phase']:.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in rec["seconds"].items())
          + f" ({card_line()})")
    return rec


# ---------------------------------------------------------------------------
# phase 23: slice 6c-ii, the batch axis across ranks
# ---------------------------------------------------------------------------

BX_CLIENTS = 2                 # 23a: the batch-split main path's clients
BX_BATCHES = 4                 # 23a's f32 arm, 23b, 23c: batches a client
BX_STREAM = dict(clients=8, block=4)     # 23c: the block-streamed cohort
BX_CKPT = dict(clients=4, batches=2, rounds=4, resume_after=1)
BX_GKT = dict(clients=4, batches=2)      # 23d: FedGKT at full width
BX_CENTRAL_BATCHES = 2         # 23d: ResNet-56 steps of 32 (16 a rank)
BX_STREAM_REL = 1e-6           # 23c: block stream against the streaming round
# 23d: the client-split variants against their one-device runs on the
# card at their CPU tests' tolerances (tests/test_torch_mesh_algorithms.py);
# FedGKT's server phase splits every step's batch, so its f32 sums regroup
# each step: held to phase 4's limits (the update within 1e-3 of its norm,
# 1e-2 in any leaf); ResNet-56's f32 BatchNorm step is ill-conditioned at
# init (f32 and f64 runs on the CPU differ by ~12 % of the update in two
# steps), so the centralized mesh run is held to the exact (f64, CPU)
# run: no further from it than twice the one-device f32 run, or 1e-3
BX_TOL = {"d_seg": dict(rtol=2e-4, atol=2e-5),
          "d_gan": dict(rtol=0.1, atol=0.01),
          "d_nas": dict(rtol=3e-4, atol=3e-5)}
BX_LO, BX_HI = [0, 1], [2, 3]  # the 2-rank sub-meshes of the 4-rank world


def gn_half_batch(gen: torch.Generator) -> list:
    """Both GroupNorm kernels at the main path's stage shapes with the
    batch split over 2 ranks (N = 16), bf16 x and bf16 gamma/beta as the
    main path holds them, against their plain versions (gn_check's
    tolerances), each with its device time beside its bound."""
    recs = []
    for shape in GN_STAGES:
        shape = (shape[0] // 2,) + tuple(shape[1:])
        N, H, W, C = shape
        x, dy, g16, b16 = stage_inputs(shape, gen)
        err_f, err_b = gn_check(x, dy, g16, b16, f"{shape} bf16, N=16")
        _, mean, rstd = gn_forward_plain(x, g16, b16, GROUPS, FLAX_EPS)
        elems, stats = x.numel(), 2 * N * GROUPS * 4
        rec = dict(
            shape=list(shape), groups=GROUPS, max_abs_err=[err_f, err_b],
            fwd_ms=cuda_ms(lambda: gn_forward(x, g16, b16, GROUPS, FLAX_EPS)),
            bwd_ms=cuda_ms(lambda: gn_backward(x, dy, g16, mean, rstd,
                                               GROUPS)),
            fwd_plain_ms=cuda_ms(lambda: gn_forward_plain(
                x, g16, b16, GROUPS, FLAX_EPS)),
            bwd_plain_ms=cuda_ms(lambda: gn_backward_plain(
                x, dy, g16, mean, rstd, GROUPS)),
            fwd_bound=bound_ms(2 * elems * 2 + 2 * C * 2 + stats, 8 * elems),
            bwd_bound=bound_ms(3 * elems * 2 + C * 2 + stats + 2 * C * 2,
                               12 * elems))
        recs.append(rec)
        print(f"[23] GroupNorm {list(shape)} bf16 G={GROUPS}: max abs err y "
              f"{err_f:.3e}, dx {err_b:.3e}; forward {rec['fwd_ms'] * 1e3:.2f}"
              f" us (plain {rec['fwd_plain_ms'] * 1e3:.2f}, bound "
              f"{rec['fwd_bound'][0] * 1e3:.2f}), backward "
              f"{rec['bwd_ms'] * 1e3:.2f} us (plain "
              f"{rec['bwd_plain_ms'] * 1e3:.2f}, bound "
              f"{rec['bwd_bound'][0] * 1e3:.2f}) ({card_line()})")
    return recs


def bx_expected(steps: int, evals: int, wsum: int = 0, sqnorm: int = 0,
                clip_agg: int = 0) -> dict:
    """One rank's ResNet-18-GN launches: `steps` training steps, `evals`
    evaluations of the 2 eval batches, and the chunk folds' kernels."""
    return {"gn_forward": 20 * (steps + 2 * evals), "gn_backward": 20 * steps,
            "wsum": wsum, "sqnorm": sqnorm, "clip_agg": clip_agg}


def bx_inputs(tmp: Path) -> tuple[dict, dict]:
    """Phase 23's data and initial weights, pickled and torch.saved for
    the ranks: (paths by key, the objects by key)."""
    trainer, _, _ = main_recipe()
    gw = lambda: torch.Generator().manual_seed(0)      # noqa: E731
    data = {
        "a": synthetic_data(BX_CLIENTS, SAMPLES, seed=0),
        "a4": synthetic_data(BX_CLIENTS, BX_BATCHES * BATCH, seed=1),
        "b": synthetic_data(4, BX_BATCHES * BATCH, seed=2),
        "c": synthetic_data(BX_STREAM["clients"], BX_BATCHES * BATCH, seed=3),
        "ck": synthetic_data(BX_CKPT["clients"], BX_CKPT["batches"] * BATCH,
                             seed=4),
        "gkt": synthetic_data(BX_GKT["clients"], BX_GKT["batches"] * BATCH,
                              seed=5),
        "seg": load_data("pascal_voc", client_num_in_total=4, batch_size=8,
                         seed=0),
        "gan": zoo_data("mnist", 2, BATCH, BATCH, seed=15),
        "nas": synthetic_data(NAS_CLIENTS, NAS_BATCHES * BATCH, seed=0)}
    cifar = synthetic_data(2, BX_CENTRAL_BATCHES * BATCH // 2, seed=6)
    data["central"] = dataclasses.replace(cifar, train_global={
        k: v.reshape((-1,) + v.shape[2:])
        for k, v in cifar.client_shards.items()})
    weights = {
        "main": trainer.init(gw(), "cpu"),
        "gkt": (FlatModel(ResNetClientGKT()).init(gw(), "cpu"),
                FlatModel(ResNetServerGKT()).init(gw(), "cpu")),
        "seg": ClientTrainer(create_model("segnet", 21)).init(gw(), "cpu"),
        "gan": FedGANEngine(Generator(), Discriminator(), data["gan"],
                            FedConfig(), device="cpu").init_params(gw()),
        "nas": nas_engine(data["nas"], "first_order", device="cpu",
                          lr=NAS_LR).init_state(gw()),
        "central": ClientTrainer(create_model("resnet56", 10)).init(gw(),
                                                                    "cpu")}
    paths = {}
    for key, d in data.items():
        paths[key] = str(tmp / f"bx_{key}.pkl")
        with open(paths[key], "wb") as f:
            pickle.dump(d, f)
    for key, w in weights.items():
        paths[f"w_{key}"] = str(tmp / f"bx_w_{key}.pt")
        torch.save(w, paths[f"w_{key}"])
    return paths, {"data": data, "weights": weights}


def bx_case(tmp: Path, paths: dict) -> Path:
    """Phase 23's mesh worker case: 23b on all 4 ranks, then 23a, the
    block stream and the FedGKT and centralized arms on ranks 0-1 while
    the checkpoint and the FedSeg, FedGAN and FedNAS arms run on ranks 2-3
    (disjoint sub-meshes run at the same time)."""
    _, _, cfg = main_recipe()
    base = {k: getattr(cfg, k) for k in (
        "model", "dataset", "epochs", "batch_size", "lr",
        "frequency_of_the_test")}
    def n(c):
        return {"client_num_in_total": c, "client_num_per_round": c}
    bf16 = dict(chunk=MAIN_CHUNK, local_dtype="bfloat16", streaming=True)
    lo = {"kind": "1d", "devices": BX_LO}
    hi = {"kind": "1d", "devices": BX_HI}
    split = {"kind": "batch", "n_clients": 1, "n_batch": 2, "devices": BX_LO}
    f32 = {"lr": cfg.lr, "train_dtype": "float32"}
    ck = dict(engine="fedopt", cfg={**n(BX_CKPT["clients"]),
                                    "server_optimizer": "adam",
                                    "server_lr": 0.05}, mesh=hi,
              data=paths["ck"], engine_kw=bf16)
    ck_dir = str(tmp / "bx_ckpt")
    nas = nas_engine(synthetic_data(1, BATCH, seed=0), "first_order",
                     device="cpu", lr=NAS_LR).cfg
    arms = [
        dict(tag="b_clip", engine="robust", rounds=1, data=paths["b"],
             cfg={**n(4), "stddev": 0.0},
             mesh={"kind": "batch", "n_clients": 2, "n_batch": 2},
             engine_kw={**bf16, "defense": "norm_clip"}),
        dict(tag="a_bf16", engine="fedavg", rounds=1, data=paths["a"],
             cfg=n(BX_CLIENTS), mesh=split, engine_kw=bf16),
        dict(tag="a_f32", engine="fedavg", rounds=1, data=paths["a4"],
             cfg=n(BX_CLIENTS), mesh=split, trainer=f32, save=True,
             engine_kw={"chunk": MAIN_CHUNK, "streaming": True}),
        *[dict(tag=tag, engine="fedavg", rounds=1, data=paths["c"],
               cfg=n(BX_STREAM["clients"]), mesh=lo, save=True,
               engine_kw={**bf16, **kw})
          for tag, kw in (("c_block", {"stream_block": BX_STREAM["block"]}),
                          ("c_block_again",
                           {"stream_block": BX_STREAM["block"]}),
                          ("c_stream", {}))],
        dict(tag="d_gkt", engine="fedgkt", rounds=1, data=paths["gkt"],
             weights=paths["w_gkt"], save=True, mesh=lo,
             cfg={**n(BX_GKT["clients"]), "lr": 0.05},
             gkt={"client": {"factory": "fedml_tpu_torch.models.resnet_gkt:"
                                        "ResNetClientGKT"},
                  "server": {"factory": "fedml_tpu_torch.models.resnet_gkt:"
                                        "ResNetServerGKT"}}),
        dict(tag="d_central", engine="centralized", rounds=1,
             data=paths["central"], weights=paths["w_central"], save=True,
             mesh=lo, cfg={**base, **n(2)},
             model={"name": "resnet56", "output_dim": 10}, trainer=f32),
        {**ck, "tag": "c_ckpt_full", "rounds": BX_CKPT["rounds"],
         "save": True},
        {**ck, "tag": "c_ckpt_first", "rounds": BX_CKPT["resume_after"] + 1,
         "ckpt": {"dir": ck_dir, "every": 1}},
        {**ck, "tag": "c_ckpt_resumed", "rounds": BX_CKPT["rounds"],
         "save": True, "ckpt": {"dir": ck_dir, "every": 1, "resume": True}},
        dict(tag="d_seg", engine="fedseg", rounds=1, data=paths["seg"],
             weights=paths["w_seg"], save=True, mesh=hi,
             cfg={**n(4), "batch_size": 8, "lr": 0.05,
                  "train_ignore_id": 255},
             model={"name": "segnet", "output_dim": 21},
             trainer={"lr": 0.05, "has_time_axis": True,
                      "train_ignore_id": 255, "train_dtype": "float32"}),
        dict(tag="d_gan", engine="fedgan", rounds=1, data=paths["gan"],
             weights=paths["w_gan"], save=True, mesh=hi,
             cfg={**n(2), "lr": 0.001}, gan={"out_dim": 784}),
        dict(tag="d_nas", engine="fednas", rounds=1, data=paths["nas"],
             weights=paths["w_nas"], save=True, mesh=hi,
             cfg={k: getattr(nas, k) for k in base if k not in (
                 "model", "dataset")} | n(NAS_CLIENTS),
             engine_kw={**NAS_FULL, "num_classes": 10})]
    case = dict(data=paths["a"], weights=paths["w_main"], out=str(tmp),
                deterministic=True, tf32=False, timeout_s=MESH_TIMEOUT_S,
                model={"name": "resnet18_gn", "output_dim": 10},
                trainer={"lr": cfg.lr, "train_dtype": "bfloat16"},
                cfg={**base, **n(BX_CLIENTS)}, arms=arms)
    path = tmp / "bx.json"
    path.write_text(json.dumps(case))
    return path


def bx_one_card(inputs: dict) -> dict:
    """The one-device runs on this card that phase 23's ranks are held
    against (cuDNN deterministic, TF32 off): 23a's two rounds (their
    launches and the f32 model), and every 23d algorithm from the same
    weights."""
    f32_off()
    torch.backends.cuda.matmul.allow_tf32 = False
    data, w = inputs["data"], inputs["weights"]
    trainer, _, cfg = main_recipe()
    cuda = lambda t: {k: v.cuda() for k, v in t.items()}     # noqa: E731
    out = {}

    def timed(tag, fn):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        v = fn()
        torch.cuda.synchronize()
        out[tag] = dict(variables={k: t.detach().cpu() for k, t in v.items()},
                        launches=launch_counts(),
                        wall_s=time.perf_counter() - t0)

    def fcfg(n, **kw):
        return FedConfig(**{**{k: getattr(cfg, k) for k in (
            "model", "dataset", "epochs", "batch_size", "lr",
            "frequency_of_the_test")}, "client_num_in_total": n,
            "client_num_per_round": n, **kw})

    def body():
        timed("a_bf16", lambda: MeshFedAvgEngine(
            trainer, data["a"], fcfg(BX_CLIENTS), chunk=MAIN_CHUNK,
            local_dtype=torch.bfloat16, streaming=True).run(
                variables=cuda(w["main"]), rounds=1))
        timed("a_f32", lambda: MeshFedAvgEngine(
            ClientTrainer(create_model("resnet18_gn", 10), lr=cfg.lr),
            data["a4"], fcfg(BX_CLIENTS), chunk=MAIN_CHUNK,
            streaming=True).run(variables=cuda(w["main"]), rounds=1))
        gkt = FedGKTEngine(ResNetClientGKT(), ResNetServerGKT(), data["gkt"],
                           fcfg(BX_GKT["clients"], lr=0.05))

        def run_gkt():
            cps, sp = gkt.run(rounds=1,
                              params=tuple(cuda(t) for t in w["gkt"]))
            return {**{f"client{i}.{k}": v for i, cp in enumerate(cps)
                       for k, v in cp.items()},
                    **{f"server.{k}": v for k, v in sp.items()}}
        timed("d_gkt", run_gkt)
        timed("d_central", lambda: CentralizedTrainer(
            ClientTrainer(create_model("resnet56", 10), lr=cfg.lr),
            data["central"], fcfg(2)).run(epochs=1,
                                          variables=cuda(w["central"])))
        seg_tr = ClientTrainer(create_model("segnet", 21), lr=0.05,
                               has_time_axis=True, train_ignore_id=255)
        timed("d_seg", lambda: FedSegEngine(
            seg_tr, data["seg"], fcfg(4, batch_size=8, lr=0.05,
                                      train_ignore_id=255)).run(
                variables=cuda(w["seg"]), rounds=1))
        timed("d_gan", lambda: FedGANEngine(
            Generator(), Discriminator(), data["gan"],
            fcfg(2, lr=0.001)).run(rounds=1, params=cuda(w["gan"])))
        nas = nas_engine(data["nas"], "first_order", lr=NAS_LR)

        def run_nas():
            p, a = nas.run(rounds=1, params=cuda(w["nas"][0]),
                           alphas=cuda(w["nas"][1]))
            return {**p, **{f"alpha.{k}": v for k, v in a.items()}}
        timed("d_nas", run_nas)

    deterministic(body)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    # the centralized run's exact yardstick: f64 on the CPU
    t0 = time.perf_counter()
    v = CentralizedTrainer(
        ClientTrainer(create_model("resnet56", 10).double(), lr=cfg.lr),
        data["central"], fcfg(2), device="cpu").run(
            epochs=1, variables={k: t.double() for k, t in
                                 w["central"].items()})
    out["d_central_f64"] = dict(variables=v, wall_s=time.perf_counter() - t0)
    return out


def bx_close(tag: str, got: dict, want: dict, rtol: float, atol: float):
    """(every leaf within rtol/atol, the worst |got - want| beyond atol +
    rtol |want| as a multiple of it, the max abs difference)."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"23 {tag}: leaves differ: {sorted(got)[:4]} "
                             f"against {sorted(want)[:4]}")
    worst = max_abs = 0.0
    for k in want:
        d = (got[k].double() - want[k].double()).abs()
        lim = atol + rtol * want[k].double().abs()
        worst = max(worst, float((d / lim).max()))
        max_abs = max(max_abs, float(d.max()))
    return worst <= 1.0, worst, max_abs


def bx_rel(a: dict, b: dict) -> float:
    """||a - b|| / ||b|| over the whole model."""
    num = sum(float((a[k].double() - b[k].double()).square().sum())
              for k in b)
    den = sum(float(b[k].double().square().sum()) for k in b)
    return math.sqrt(num / max(den, 1e-30))


def phase_slice6c_ii(gen: torch.Generator) -> dict:
    """Phase 23: the batch axis across ranks on the card, in ONE spawned
    cluster of 4 ranks sharing this card (the mesh worker through the
    launcher), against this process's one-device runs of the same work.

    23a: the main path (ResNet-18-GN at full width, bf16 compute and
    masters, chunk 2) on make_mesh_batch(1, 2): 2 ranks of 16 samples a
    step, 2 clients of 13 batches, 1 round; both ranks one digest;
    launches per rank equal to the one-device round's (rank 1 less the
    evaluation's forwards); the per-step fold's walls and bytes; an f32
    arm at 4 batches within phase 4's limits of the one-device f32 round
    (the update within 1e-3 of its norm); and both GroupNorm kernels
    against their plain versions at N = 16 (gn_half_batch).  23b: 4 ranks
    on make_mesh_batch(2, 2), norm_clip at 4 batches: one digest, one
    squared-distance and one clipped-fold launch a rank.  23c:
    stream_block over 2 ranks (8 clients in blocks of 4, 4 batches)
    within 1e-6 relative of the 2-rank streaming round, a second run
    bitwise the first, at most two blocks' share resident a rank; then
    FedOpt (adam) over 2 ranks, 4 rounds, and a fresh engine resuming
    after round 1 from the first rank's checkpoint: bitwise the
    uninterrupted run on both ranks.  23d: FedGKT (full width, 4 clients
    of 2 batches, 1 round), FedSeg, FedGAN and a first-order FedNAS search
    round at their phase-14/15 shapes (1 round each), and
    CentralizedTrainer(mesh=) on ResNet-56 (2 steps of 32, BatchNorm
    folded over the ranks), each at 2 ranks against its one-device run
    here (BX_TOL's comment says at what tolerance)."""
    t0 = time.perf_counter()
    seconds = {}
    gn16 = gn_half_batch(gen)
    seconds["gn at N=16"] = time.perf_counter() - t0
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_bx_"))
    paths, inputs = bx_inputs(tmp)
    case = bx_case(tmp, paths)
    runs, errs = {}, []

    def cluster():
        try:
            t1 = time.perf_counter()
            runs["cluster"] = mesh_launch(case, 4, tag="23")
            seconds["cluster"] = time.perf_counter() - t1
        except Exception as e:       # re-raised below, after the join
            errs.append(e)

    th = threading.Thread(target=cluster)
    th.start()
    t1 = time.perf_counter()
    ref = bx_one_card(inputs)
    seconds["one-device references"] = time.perf_counter() - t1
    th.join()
    if errs:
        raise errs[0]
    docs = runs["cluster"]["docs"]
    arm = lambda tag, r: docs[r]["arms"][tag]                # noqa: E731
    saved = lambda tag, r: torch.load(tmp / f"{tag}.rank{r}.pt")  # noqa: E731
    checks, bad, launches = {}, [], {}
    groups = {"b_clip": [0, 1, 2, 3], **{t: BX_LO for t in (
        "a_bf16", "a_f32", "c_block", "c_block_again", "c_stream", "d_gkt",
        "d_central")}, **{t: BX_HI for t in (
            "c_ckpt_full", "c_ckpt_first", "c_ckpt_resumed", "d_seg",
            "d_gan", "d_nas")}}
    for tag, ranks in groups.items():
        recs = [arm(tag, r) for r in ranks]
        checks[f"{tag}: one digest on ranks {ranks}"] = (
            len({r["digest"] for r in recs}) == 1
            and all(r["finite"] for r in recs))
        for r, rec in zip(ranks, recs):
            launches[f"{tag} r{r}"] = rec["launches"]
    # launches exact per rank; 23a's equal the one-device round's
    steps_a, steps_a4 = BX_CLIENTS * BATCHES, BX_CLIENTS * BX_BATCHES
    want = {
        "a_bf16": lambda r: bx_expected(steps_a, r == 0, wsum=1),
        "a_f32": lambda r: bx_expected(steps_a4, r == 0, wsum=1),
        "b_clip": lambda r: bx_expected(2 * BX_BATCHES, r == 0, sqnorm=1,
                                        clip_agg=1),
        "c_block": lambda r: bx_expected(4 * BX_BATCHES, r == 0, wsum=2),
        "c_block_again": lambda r: bx_expected(4 * BX_BATCHES, r == 0,
                                               wsum=2),
        "c_stream": lambda r: bx_expected(4 * BX_BATCHES, r == 0, wsum=2),
        # evaluations: the first round and the last (rank 2 evaluates)
        "c_ckpt_full": lambda r: bx_expected(
            2 * BX_CKPT["batches"] * BX_CKPT["rounds"], 2 * (r == 2),
            wsum=BX_CKPT["rounds"]),
        "c_ckpt_first": lambda r: bx_expected(
            2 * BX_CKPT["batches"] * 2, 2 * (r == 2), wsum=2),
        "c_ckpt_resumed": lambda r: bx_expected(
            2 * BX_CKPT["batches"] * 2, r == 2, wsum=2)}
    for tag, fn in want.items():
        for r in groups[tag]:
            if arm(tag, r)["launches"] != fn(r):
                bad.append(f"{tag} rank {r}: {arm(tag, r)['launches']} != "
                           f"{fn(r)}")
    one = ref["a_bf16"]["launches"]
    checks["23a: rank 0's launches == the one-device round's"] = \
        arm("a_bf16", 0)["launches"] == one
    # one fold a step, and one of a client's batch counts before its steps
    checks["23a: the batch split ran (one fold a step on each rank)"] = all(
        len(arm("a_bf16", r)["batch_fold_walls"]) == steps_a + BX_CLIENTS
        for r in BX_LO)
    a32 = saved("a_f32", 0)
    w0 = inputs["weights"]["main"]
    dist, worst = update_distance("23a f32", w0, a32, w0,
                                  ref["a_f32"]["variables"])
    checks["23a f32: within phase 4's limits of the one-device round"] = (
        dist <= 1e-3 and worst[0][1] <= 1e-2)
    # 23c
    blk, stream = saved("c_block", 0), saved("c_stream", 0)
    rel = bx_rel(blk, stream)
    checks[f"23c: block stream within {BX_STREAM_REL} of the streaming "
           "round"] = rel <= BX_STREAM_REL
    checks["23c: a second block-streamed run is bitwise the first"] = (
        same_model(saved("c_block_again", 1), blk)
        and arm("c_block_again", 0)["digest"] == arm("c_block", 0)["digest"])
    per_client = sum(np.asarray(v)[0].nbytes for v in
                     inputs["data"]["c"].client_shards.values())
    share = BX_STREAM["block"] // len(BX_LO) * per_client
    peaks = [arm("c_block", r)["peak_block_bytes"] for r in BX_LO]
    checks["23c: at most two blocks' share resident a rank"] = all(
        0 < p <= 2 * share for p in peaks)
    checks["23c: the resumed run is bitwise the uninterrupted one"] = (
        {arm("c_ckpt_resumed", r)["digest"] for r in BX_HI}
        == {arm("c_ckpt_full", r)["digest"] for r in BX_HI}
        and len(arm("c_ckpt_resumed", 2)["round_walls"])
        == BX_CKPT["rounds"] - BX_CKPT["resume_after"] - 1)
    # 23d
    d_rec = {}
    gkt0 = inputs["weights"]["gkt"]
    gkt_init = {**{f"client{i}.{k}": v for i in range(BX_GKT["clients"])
                   for k, v in gkt0[0].items()},
                **{f"server.{k}": v for k, v in gkt0[1].items()}}
    gd, gw_ = update_distance("23d d_gkt", gkt_init, saved("d_gkt", 0),
                              gkt_init, ref["d_gkt"]["variables"])
    checks["23d d_gkt: within phase 4's limits of the one-device run"] = (
        gd <= 1e-3 and gw_[0][1] <= 1e-2)
    c0 = {k: v.double() for k, v in inputs["weights"]["central"].items()}
    exact = ref["d_central_f64"]["variables"]
    d_mesh, _ = update_distance("23d d_central", c0, saved("d_central", 0),
                                c0, exact)
    d_one, _ = update_distance("23d d_central", c0,
                               ref["d_central"]["variables"], c0, exact)
    checks["23d d_central: no further from f64 than 2x one device or 1e-3"] \
        = d_mesh <= max(2 * d_one, 1e-3)
    d_rec["d_gkt"] = dict(update_distance=gd, worst_leaf=list(gw_[0]))
    d_rec["d_central"] = dict(from_f64=d_mesh, one_device_from_f64=d_one,
                              f64_cpu_s=ref["d_central_f64"]["wall_s"])
    print(f"[23] d_gkt: 2 ranks against one device: update distance "
          f"{gd:.3e} (limit 1e-3), worst leaf {gw_[0][0]} {gw_[0][1]:.3e} "
          f"(limit 1e-2); d_central: 2 ranks {d_mesh:.3e} from the f64 "
          f"CPU run, one device {d_one:.3e} (limit max(2x, 1e-3)); f64 "
          f"run {ref['d_central_f64']['wall_s']:.1f} s")
    for tag in ("d_gkt", "d_central"):
        d_rec[tag].update(one_device_s=ref[tag]["wall_s"],
                          ranks_s=[arm(tag, r)["arm_s"] for r in BX_LO],
                          one_device_launches=ref[tag]["launches"])
    for tag, tol in BX_TOL.items():
        r0 = BX_HI[0]
        ok, worst_x, max_abs = bx_close(tag, saved(tag, r0),
                                        ref[tag]["variables"], **tol)
        checks[f"23d {tag}: within {tol} of the one-device run"] = ok
        d_rec[tag] = dict(within=ok, worst_over_limit=worst_x,
                          max_abs=max_abs, one_device_s=ref[tag]["wall_s"],
                          ranks_s=[arm(tag, r)["arm_s"]
                                   for r in groups[tag]],
                          one_device_launches=ref[tag]["launches"])
        print(f"[23] {tag}: 2 ranks against one device: worst |diff| "
              f"{worst_x:.3f} of the limit {tol}, max abs {max_abs:.3e}; "
              f"ranks {d_rec[tag]['ranks_s']} s, one device "
              f"{ref[tag]['wall_s']:.2f} s; launches rank {r0} "
              f"{arm(tag, r0)['launches']}, one device "
              f"{ref[tag]['launches']}")
    for r in (0, 1, 2, 3):
        for tag in groups:
            if r not in groups[tag]:
                continue
            rec = arm(tag, r)
            fw, fb = rec["batch_fold_walls"], rec["batch_fold_bytes"]
            print(f"[23] {tag}, rank {r}: s/round "
                  + ", ".join(f"{w:.3f}" for w in rec["round_walls"])
                  + f"; arm {rec['arm_s']:.2f} s; {len(rec['gather_walls'])} "
                  f"gathers ({sum(rec['gather_bytes'])} B received); "
                  f"{len(fw)} per-step folds over 'batch', wall median "
                  f"{statistics.median(fw) if fw else 0.0:.4f} s, sum "
                  f"{sum(fw):.2f} s, {max(fb, default=0)} B received a "
                  f"fold; peak device memory {rec['peak_bytes'] / 2**30:.3f}"
                  f" GiB; launches {rec['launches']}; digest "
                  f"{rec['digest']}")
    print(f"[23] 23a one-device round: launches {one}, "
          f"{ref['a_bf16']['wall_s']:.2f} s; f32 arm update distance "
          f"{dist:.3e} (limit 1e-3), worst leaf {worst[0][0]} "
          f"{worst[0][1]:.3e}; 23c block stream against streaming "
          f"{rel:.3e} relative; peak block bytes {peaks} (two shares "
          f"{2 * share})")
    print(f"[23] checks: {checks}; launches exact: {not bad} "
          f"({card_line()})")
    if bad or not all(checks.values()):
        raise AssertionError(f"23: {bad} "
                             f"{[k for k, v in checks.items() if not v]}")
    seconds["phase"] = time.perf_counter() - t0
    print(f"[slice 6c-ii] phase 23 took {seconds['phase']:.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
          + f" ({card_line()})")
    fold = {r: arm("a_bf16", r) for r in BX_LO}
    return dict(checks=checks, launches=launches, seconds=seconds,
                gn_half_batch=gn16, algorithms=d_rec,
                main_fold={r: dict(walls=f["batch_fold_walls"],
                                   bytes=f["batch_fold_bytes"],
                                   round_walls=f["round_walls"])
                           for r, f in fold.items()},
                f32_update_distance=dist, block_vs_stream=rel,
                peak_block_bytes=peaks,
                digests={tag: arm(tag, groups[tag][0])["digest"]
                         for tag in groups})


# ---------------------------------------------------------------------------
# phase 24: slices 6c-iii and 7b, local groups and the entry points
# ---------------------------------------------------------------------------

LG_LOCAL = 2                   # 24a: ranks behind each host-channel member
# 24a: the committed models against phase 20's 1-rank two-block run, as
# update_distance (the L2 distance of the two updates relative to the
# reference update's norm): each block's lanes now fold as two per-rank
# sums (one chunk each) added on the host, where phase 20 folds the
# block's two chunks into one device accumulator; the f32 difference of
# round 0 flips a few bf16 local masters in round 1
LG_TOL = 5e-2
CLI_ARGS = ["--model", "resnet18_gn", "--dataset", "cifar10",
            "--client_num_in_total", "4", "--client_num_per_round", "4",
            "--comm_round", "2", "--batch_size", "32",
            "--max_batches_per_client", "4", "--partition_method", "homo",
            "--synthetic_scale", "0.02", "--lr", "0.1",
            "--train_dtype", "bfloat16", "--local_dtype", "bfloat16",
            "--mesh", "--streaming", "--cohort_chunk", "2",
            "--frequency_of_the_test", "100", "--no_local_test_eval"]
CLI_LR_ARGS = ["--algorithm", "fedavg", "--dataset", "mnist", "--model",
               "lr", "--synthetic_scale", "0.001", "--client_num_in_total",
               "8", "--client_num_per_round", "8", "--comm_round", "2",
               "--batch_size", "4", "--lr", "0.1", "--frequency_of_the_test",
               "1", "--mesh", "--agg_blocks", "2"]


def rank24_main(cfg_path: str) -> int:
    """One rank of phase 24a, started as ``chip_smoke.py --rank24 CONFIG``
    by the launcher (each member's first rank) or by its member's first
    rank (the second): the main path's recipe through MultihostRunner on
    the member's local mesh, FedAvg then norm_clip over one HostChannel
    (the first rank's), cuDNN deterministic, launches counted from zero
    just before each run; the member's first rank prints one JSON line
    with its second rank's under "local_ranks"."""
    with open(cfg_path) as f:
        spec = json.load(f)
    ctx, local = join_local_group(
        LG_LOCAL, [sys.executable, str(Path(__file__).resolve()), "--rank24",
                   cfg_path], timeout_s=4 * MH_TIMEOUT_S)
    leads = ctx.local_rank == 0
    channel = None
    try:
        trainer, data, cfg = main_recipe(MH_SAMPLES)
        torch.backends.cudnn.deterministic = True
        if leads:
            channel = HostChannel(ctx, timeout_s=MH_TIMEOUT_S)
        mesh = make_local_mesh()
        out = {"rank": ctx.rank, "local_rank": ctx.local_rank,
               "world": ctx.world, "group": mesh.size, "arms": {}}
        v0 = None
        for arm in ("fedavg", "norm_clip"):
            kw = dict(chunk=MAIN_CHUNK, local_dtype=torch.bfloat16,
                      streaming=True, mesh=mesh)
            eng = (MeshRobustEngine(trainer, data, dataclasses.replace(
                cfg, stddev=1e-3), defense="norm_clip", **kw)
                if arm == "norm_clip"
                else MeshFedAvgEngine(trainer, data, cfg, **kw))
            if v0 is None:
                v0 = eng.init_variables()
            runner = MultihostRunner(eng, ctx, n_blocks=MH_BLOCKS,
                                     channel=channel, timeout_s=MH_TIMEOUT_S)
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            v = runner.run(variables=dict(v0), rounds=MH_ROUNDS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            if spec.get("dump") and ctx.rank == 0 and leads:
                torch.save({k: t.to("cpu") for k, t in v.items()},
                           Path(spec["dump"]) / f"{arm}.pt")
            folds, fold_bytes = eng.exchange.log(eng.client_axes)
            out["arms"][arm] = dict(
                digest=variables_digest(v), launches=counts, wall_s=wall,
                round_walls=runner.round_walls,
                exchange_walls=runner.exchange_walls,
                group_fold_walls=folds, group_fold_bytes=fold_bytes,
                carry_received=runner.carry_bytes,
                finite=all(bool(torch.isfinite(t).all()) for t in v.values()))
        if local.procs:
            out["local_ranks"] = [json.loads(o.strip().splitlines()[-1])
                                  for o in local.collect(MH_TIMEOUT_S)]
        print(json.dumps(out), flush=True)
    except BaseException:
        local.kill()
        raise
    finally:
        if channel is not None:
            channel.close()
    return 0


def free_port_base(n: int) -> int:
    """A port p with p .. p + n - 1 free now, above the usual ephemeral
    range (the host channel, the launcher's + 1, a local group's + 2 +
    member)."""
    import random
    rng = random.Random()
    for _ in range(200):
        base = rng.randrange(61000, 65000 - n)
        socks = []
        try:
            for i in range(n):
                sk = socket.socket()
                socks.append(sk)
                sk.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
        finally:
            for sk in socks:
                sk.close()
    raise RuntimeError("no free port range")


def lg_expected(blocks: int, evals: int, norm_clip: bool) -> dict:
    """One rank's launches over MH_ROUNDS rounds: `blocks` blocks of 4
    clients a round, this rank training 4 / LG_LOCAL of each (MH_BATCHES
    steps a client, 20 GroupNorm layers, one chunk of 2: one fold), and
    `evals` evaluations (2 batches each)."""
    lanes = MAIN_CLIENTS // MH_BLOCKS // LG_LOCAL
    steps = MH_ROUNDS * blocks * lanes * MH_BATCHES
    folds = MH_ROUNDS * blocks * (-(-lanes // MAIN_CHUNK))
    return {"gn_forward": 20 * (steps + 2 * evals), "gn_backward": 20 * steps,
            "wsum": 0 if norm_clip else folds,
            "sqnorm": folds if norm_clip else 0,
            "clip_agg": folds if norm_clip else 0}


def local_group_main_path(ref_dir: Optional[str]) -> dict:
    """24a: 1 member x 2 ranks and 2 members x 2 ranks through the port's
    launcher (`--procs` counts members), against phase 20's 1-rank
    two-block models (`ref_dir`; computed here in this process when phase
    20 did not run)."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_lg_"))
    root = str(Path(__file__).resolve().parent)
    docs, seconds, errs = {}, {}, []

    def cluster(procs):
        # both clusters at once (the script's time): 6 processes
        try:
            dump = tmp / f"m{procs}"
            dump.mkdir()
            path = tmp / f"m{procs}.json"
            path.write_text(json.dumps({"dump": str(dump)}))
            argv = [sys.executable, "-m", "fedml_tpu_torch.parallel.launch",
                    "--procs", str(procs), "--timeout", str(MH_TIMEOUT_S),
                    "--port", str(free_port_base(2 + procs)), "--",
                    sys.executable, str(Path(__file__).resolve()),
                    "--rank24", str(path)]
            t0 = time.perf_counter()
            proc = subprocess.run(
                argv, capture_output=True, text=True, cwd=root,
                timeout=MH_TIMEOUT_S + 60, env={
                    **os.environ, "PYTHONPATH": root + os.pathsep
                    + os.environ.get("PYTHONPATH", "")})
            ranks = {}
            for line in proc.stdout.splitlines():
                m = re.match(r"\[rank (\d+)\] (\{.*\})$", line)
                if m:
                    ranks[int(m.group(1))] = json.loads(m.group(2))
            if proc.returncode != 0 or sorted(ranks) != list(range(procs)):
                raise AssertionError(
                    f"24a: the {procs} x {LG_LOCAL} cluster failed: rc "
                    f"{proc.returncode}\n{proc.stderr[-4000:]}")
            docs[procs] = ranks
            seconds[procs] = time.perf_counter() - t0
        except Exception as e:       # re-raised below, after the joins
            errs.append(e)

    threads = [threading.Thread(target=cluster, args=(p,)) for p in (1, 2)]
    for t in threads:
        t.start()
    if ref_dir is None:
        # phase 20's 1-rank two-block runs, in this process meanwhile
        ref_dir = str(tmp / "ref")
        os.makedirs(ref_dir)
        trainer, data, cfg = main_recipe(MH_SAMPLES)
        for arm in ("fedavg", "norm_clip"):
            kw = dict(chunk=MAIN_CHUNK, local_dtype=torch.bfloat16,
                      streaming=True)
            eng = (MeshRobustEngine(trainer, data, dataclasses.replace(
                cfg, stddev=1e-3), defense="norm_clip", **kw)
                if arm == "norm_clip"
                else MeshFedAvgEngine(trainer, data, cfg, **kw))
            v = deterministic(lambda: MultihostRunner(
                eng, MultihostContext.single(), n_blocks=MH_BLOCKS).run(
                variables=eng.init_variables(), rounds=MH_ROUNDS))
            torch.save({k: t.to("cpu") for k, t in v.items()},
                       Path(ref_dir) / f"{arm}.pt")
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    digests, launches = {}, {}
    for procs in (1, 2):
        for doc in docs[procs].values():
            for d in [doc, *doc.get("local_ranks", [])]:
                r, lr = d["rank"], d["local_rank"]
                if d["group"] != LG_LOCAL:
                    raise AssertionError(f"24a: rank {r}.{lr} trained on a "
                                         f"mesh of {d['group']}")
                for arm, rec in d["arms"].items():
                    want = lg_expected(MH_BLOCKS // procs,
                                       MH_ROUNDS if (r, lr) == (0, 0) else 0,
                                       arm == "norm_clip")
                    if rec["launches"] != want or not rec["finite"]:
                        raise AssertionError(
                            f"24a {arm}, {procs} x {LG_LOCAL}, rank {r}.{lr}"
                            f": launches {rec['launches']} != {want} or a "
                            f"non-finite model")
                    digests.setdefault(arm, set()).add(rec["digest"])
                    launches[f"local group {procs}x{LG_LOCAL} {arm} rank "
                             f"{r}.{lr}"] = rec["launches"]
                    folds = rec["group_fold_walls"]
                    print(f"[24a] {arm}, {procs} member(s) x {LG_LOCAL} "
                          f"ranks, rank {r}.{lr}: s/round "
                          f"{[round(w, 3) for w in rec['round_walls']]}, "
                          f"group folds {len(folds)} at "
                          f"{statistics.median(folds) if folds else 0:.4f} s"
                          f" median ({(rec['group_fold_bytes'] or [0])[0]} B"
                          f" received a fold), exchange walls "
                          f"{[round(w, 4) for w in rec['exchange_walls']]}; "
                          f"launches {rec['launches']} == expected; digest "
                          f"{rec['digest']}")
    bad = {k: v for k, v in digests.items() if len(v) != 1}
    trainer, data, cfg = main_recipe(MH_SAMPLES)
    v0 = MeshFedAvgEngine(trainer, data, cfg, chunk=MAIN_CHUNK,
                          local_dtype=torch.bfloat16,
                          streaming=True).init_variables()
    v0 = {k: t.to("cpu") for k, t in v0.items()}
    dist = {}
    for arm in ("fedavg", "norm_clip"):
        got = torch.load(tmp / "m1" / f"{arm}.pt")
        want = torch.load(Path(ref_dir) / f"{arm}.pt")
        dist[arm] = update_distance(f"24a {arm}", v0, got, v0, want)
        print(f"[24a] {arm}: the local-group commit against phase 20's "
              f"1-rank two-block run: update distance {dist[arm][0]:.3e} "
              f"(limit {LG_TOL:g}), worst leaves " + ", ".join(
                  f"{k} {e:.3e}" for k, e in dist[arm][1]))
    print(f"[24a] local groups on one card: FedAvg and norm_clip at 1 x "
          f"{LG_LOCAL} and 2 x {LG_LOCAL} ranks, one digest each: "
          f"{ {k: len(v) == 1 for k, v in digests.items()} }; cluster walls "
          + ", ".join(f"{p} x {LG_LOCAL} {s:.1f} s"
                      for p, s in seconds.items()) + f" ({card_line()})")
    if bad:
        raise AssertionError(f"24a: the ranks did not commit one model: "
                             f"{bad}")
    far = {k: d[0] for k, d in dist.items() if d[0] > LG_TOL}
    if far:
        raise AssertionError(f"24a: the local-group commit is further than "
                             f"{LG_TOL} from phase 20's run: {far}")
    return dict(docs=docs, cluster_s=seconds, launches=launches,
                digests={k: next(iter(v)) for k, v in digests.items()},
                distance={k: d[0] for k, d in dist.items()})


def _cli_checkpoint(ckpt_dir: Path, template: dict) -> dict:
    """The model a CLI run checkpointed last, on the card."""
    mgr = FedCheckpointManager(str(ckpt_dir))
    rnd, v, *_ = mgr.restore(template, (), round_idx=mgr.latest_round())
    return v


def cli_card_path() -> dict:
    """24b: the port's CLI in this process on the main path's model at
    full width (bf16 compute and local masters, the mesh engine of one
    rank, streaming, chunk 2, 4 clients of 4 batches, 2 rounds, cuDNN
    deterministic): its summary, its last checkpoint bitwise the engine
    built by hand from the same recipe, launches exact; then the robust
    CLI with norm_clip."""
    from fedml_tpu_torch.cli import main as cli_main
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    data = load_data("cifar10", client_num_in_total=4, batch_size=BATCH,
                     partition_method="homo", max_batches_per_client=4,
                     seed=0, synthetic_scale=0.02)
    cfg = FedConfig(model="resnet18_gn", dataset="cifar10",
                    client_num_in_total=4, client_num_per_round=4,
                    comm_round=2, batch_size=BATCH, lr=0.1,
                    train_dtype="bfloat16", frequency_of_the_test=100,
                    local_test_eval=False, max_batches_per_client=4,
                    partition_method="homo", synthetic_scale=0.02)
    steps = 2 * 4 * int(np.shape(data.client_shards["x"])[1])
    folds = 2 * 4 // MAIN_CHUNK
    # evaluations after round 0 and the last round, each a forward of
    # every batch of the global train and test shards
    evals = 2 * sum(int(np.shape(s["x"])[0])
                    for s in (data.train_global, data.test_global))
    out = {}
    for tag, extra, want in (
            ("fedavg", ["--algorithm", "fedavg"],
             {"wsum": folds, "sqnorm": 0, "clip_agg": 0}),
            ("fedavg_robust norm_clip",
             ["--algorithm", "fedavg_robust", "--defense", "norm_clip"],
             {"wsum": 0, "sqnorm": folds, "clip_agg": folds})):
        want = {"gn_forward": 20 * (steps + evals), "gn_backward": 20 * steps,
                **want}
        name = tag.replace(" ", "_")
        argv = [*CLI_ARGS, *extra, "--run_dir", str(tmp), "--run_name", name,
                "--ckpt_dir", str(tmp / f"ck_{name}"), "--ckpt_every", "2"]
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        rc = deterministic(lambda: cli_main(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        with open(tmp / "fedml_tpu_torch" / name / "summary.json") as f:
            summary = json.load(f)
        print(f"[24b] CLI {tag} at full width: rc {rc}, {wall:.1f} s, "
              f"summary {summary}, launches {counts}")
        if rc != 0 or "test_acc" not in summary or counts != want:
            raise AssertionError(f"24b {tag}: rc {rc}, summary {summary}, "
                                 f"launches {counts} != {want}")
        out[tag] = dict(summary=summary, launches=counts, wall_s=wall)
    # the engine built by hand from the same recipe, against the CLI's
    # FedAvg checkpoint
    trainer = ClientTrainer(create_model("resnet18_gn", data.class_num),
                            lr=0.1, train_dtype=torch.bfloat16)
    eng = MeshFedAvgEngine(trainer, data, cfg, mesh=make_mesh(),
                           streaming=True, chunk=MAIN_CHUNK,
                           local_dtype=torch.bfloat16)
    hand = deterministic(lambda: eng.run())
    got = _cli_checkpoint(tmp / "ck_fedavg", hand)
    same = same_model(got, hand)
    print(f"[24b] the CLI's FedAvg model bitwise the hand-built engine's: "
          f"{same} ({card_line()})")
    if not same:
        raise AssertionError("24b: the CLI's model is not the hand-built "
                             "engine's")
    out["bitwise_hand_built"] = same
    return out


def cli_cluster_path() -> dict:
    """24c: the CLI's self-spawned cluster (``--multihost_procs 2 --mesh
    --agg_blocks 2``: two rank processes on this card, a block each) and
    the one-process ``--mesh --agg_blocks 2`` run (one rank, both blocks)
    log the same summary, LR on the MNIST stand-in."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_mh_"))
    root = str(Path(__file__).resolve().parent)
    runs = {}
    for tag, extra in (("one process", []),
                       ("multihost_procs 2", ["--multihost_procs", "2"])):
        # both from a fresh process, as a user starts them (earlier phases
        # leave this process's matmuls in TF32)
        argv = [sys.executable, "-m", "fedml_tpu_torch", *CLI_LR_ARGS,
                *extra, "--run_dir", str(tmp / tag.split()[0]),
                "--run_name", "t"]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, capture_output=True, text=True, cwd=root,
                              timeout=MH_TIMEOUT_S, env={
                                  **os.environ, "PYTHONPATH": root
                                  + os.pathsep
                                  + os.environ.get("PYTHONPATH", "")})
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"24c {tag}: rc {proc.returncode}\n"
                                 f"{proc.stderr[-3000:]}")
        with open(tmp / tag.split()[0] / "fedml_tpu_torch" / "t"
                  / "summary.json") as f:
            runs[tag] = dict(rc=proc.returncode, summary=json.load(f),
                             wall_s=wall)
    one, two = (runs[t]["summary"] for t in runs)
    same = sorted(one) == sorted(two) and all(
        one[k] == two[k] for k in one if k != "round_time")
    print(f"[24c] CLI two-level LR run, one process against "
          f"--multihost_procs 2: the same summary {same} ({one}); walls "
          + ", ".join(f"{t} {r['wall_s']:.1f} s" for t, r in runs.items()))
    if not same or any(r["rc"] != 0 for r in runs.values()):
        raise AssertionError(f"24c: {runs}")
    return dict(runs=runs, same=same)


def phase_slice6c_iii_7b(slice6a: Optional[dict] = None) -> dict:
    """Phase 24: local groups and the entry points on the card; each
    part's seconds.  With phase 20's record, its 1-rank two-block models
    are 24a's reference."""
    ref = None
    if slice6a is not None:
        ref = slice6a["20a two-level main path"]["dump"]
    rec, seconds, errs = {}, {}, []

    def part(key, fn):
        t0 = time.perf_counter()
        try:
            rec[key] = fn()
        except Exception as e:       # re-raised below, after the join
            errs.append(e)
        seconds[key] = time.perf_counter() - t0

    # 24c's two CLI runs are processes of their own (no launches counted
    # here): they run beside 24a's clusters, mostly waiting on their boots
    side = threading.Thread(target=part,
                            args=("24c cli cluster", cli_cluster_path))
    side.start()
    part("24a local groups", lambda: local_group_main_path(ref))
    if not errs:
        part("24b cli", cli_card_path)
    side.join()
    if errs:
        raise errs[0]
    rec["seconds"] = seconds
    seconds["phase"] = sum(v for k, v in seconds.items()
                           if k != "24c cli cluster")
    print(f"[slices 6c-iii, 7b] phase 24 took {seconds['phase']:.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()
                      if k != "phase")
          + f" (24c beside 24a; {card_line()})")
    return rec


def phase24_paths(rec: dict) -> dict:
    """Phase 24's paths and their launch counts (each zeroed in its
    process just before its run)."""
    b = rec["24b cli"]
    return {**rec["24a local groups"]["launches"],
            "cli fedavg": b["fedavg"]["launches"],
            "cli fedavg_robust norm_clip":
                b["fedavg_robust norm_clip"]["launches"]}


def phase21_paths(rec: dict) -> dict:
    """Phase 21's paths and their launch counts (each zeroed in its
    process just before its run)."""
    return {**rec["21a elastic main path"]["launches"],
            **rec["21b serve sharded"]["launches"],
            **rec["21b serving cluster"]["launches"]}


def phase20_paths(rec: dict) -> dict:
    """Phase 20's paths and their launch counts per rank (each zeroed in
    the rank just before its arm ran)."""
    a = rec["20a two-level main path"]
    return {**{f"two-level {k}": v for k, v in a["launches"].items()},
            **{f"two-level norm_clip {k}": v
               for k, v in a["clip_launches"].items()}}


def kernel_line(gn_fwd: dict, gn_bwd: dict, fold_rec: dict, robust: dict,
                counts: dict, robust_counts: dict, resnet56: dict,
                paths: dict, gn_slice7a: list, gn_slice7a_ii: list,
                messaging_fold_rec: dict, async_folds: dict,
                gn_half: list) -> dict:
    """One entry per ported kernel.  GroupNorm's numbers are per training
    step: its 20 launches, five at each stage shape, summed, with bf16
    gamma/beta (ms_f32_gamma: with f32 gamma; layer_ms_per_step: the
    forward and backward of 20 layers with all device work they issue).
    The fold, squared-distance and clipped-fold numbers are one call at the mesh
    chunk's shape ([2, P] bf16); launches are those of the FedAvg main path
    (phase 5) for GroupNorm and the fold, of the robust main path (phase 8)
    for the two robust kernels; ``launches_by_path`` gives every path's
    count (each zeroed just before its path ran), and the GroupNorm
    entries carry phase 14's and phase 15's shapes (f32 device time and
    bound a call) and phase 23's batch-split shapes (N = 16, bf16, device
    and plain time and bound a call), and the fold's entry its finalize
    form at the messaging
    server's [8, P] bf16 rows.  The async server's arrival fold ([1, P]
    f32, accumulate) rides the fold's entry, its screened fold (the
    squared distance and the clipped fold at [1, P] f32) the two robust
    kernels' entries (phase 18)."""
    entries = []
    for name, rec in (("gn_forward", gn_fwd), ("gn_backward", gn_bwd)):
        sh = rec["shapes"]
        per_step = lambda key: GN_LAYERS_PER_STAGE * sum(s[key] for s in sh)
        entries.append(dict(
            name=name, route="cuda", source="fedml_tpu_torch/csrc/groupnorm.cu",
            replaces=TPU_KERNELS[name][0], function=TPU_KERNELS[name][1],
            status="ported",
            launches=counts[name],
            max_abs_err=max(s["max_abs_err"] for s in sh),
            ms=per_step("ms"), host_ms=per_step("host_ms"),
            plain_ms=per_step("plain_ms"),
            bound_ms=GN_LAYERS_PER_STAGE * sum(s["bound"][0] for s in sh),
            bound_by="bytes" if all(s["bound"][1] == "bytes" for s in sh)
            else "operations",
            library_ms=per_step("library_ms"),
            ms_f32_gamma=per_step("ms_f32_gamma"),
            unit="one training step: 20 launches, 5 at each stage shape, "
                 "bf16 x and bf16 gamma/beta",
            layer_ms_per_step=GN_LAYERS_PER_STAGE * sum(
                s["layer_ms"] for s in gn_fwd["shapes"]),
            shapes=[{k: v for k, v in s.items()} for s in sh],
            streaming=rec["streaming"]))
    entries.append(dict(
        name="wsum", route="cuda", source="fedml_tpu_torch/csrc/aggregate.cu",
        replaces=TPU_KERNELS["wsum"][0], function=TPU_KERNELS["wsum"][1],
        status="ported",
        launches=counts["wsum"],
        max_abs_err=max(fold_rec["max_abs_err"],
                        async_folds["fold"]["max_abs_err"]),
        ms=fold_rec["ms"], host_ms=fold_rec["host_ms"],
        plain_ms=fold_rec["plain_ms"],
        bound_ms=fold_rec["bound"][0], bound_by=fold_rec["bound"][1],
        library_ms=fold_rec["library_ms"],
        unit=f"one chunk fold: [{MAIN_CHUNK}, P] bf16 into f32 acc",
        finalize=fold_rec["finalize"],
        messaging_path={k: (v[0] if k == "bound" else v)
                        for k, v in messaging_fold_rec.items()},
        async_arrival={k: (v[0] if k == "bound" else v)
                       for k, v in async_folds["fold"].items()},
        resnet56_path={k: (v[0] if k == "bound" else v)
                       for k, v in resnet56["fold"].items()}))
    for name in ("sqnorm", "clip_agg"):
        main, other = robust[name]
        entries.append(dict(
            name=name, route="cuda", source="fedml_tpu_torch/csrc/robust.cu",
            replaces=TPU_KERNELS[name][0], function=TPU_KERNELS[name][1],
            status="ported", launches=robust_counts[name],
            max_abs_err=max(main["max_abs_err"], other["max_abs_err"],
                            async_folds["screened"][f"{name}_max_abs_err"]),
            ms=main["ms"], host_ms=main["host_ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound"][0], bound_by=main["bound"][1],
            library_ms=main["library_ms"], library=main["library"],
            unit=f"one call at the mesh chunk: [{MAIN_CHUNK}, P] bf16"
                 + (", accumulate form" if name == "clip_agg" else ""),
            fedavg_robust={k: v for k, v in other.items()},
            async_screened={
                "shape": [1, P_PADDED], "dtype": "float32",
                **{key: async_folds["screened"][f"{name}_{key}"]
                   for key in ("max_abs_err", "ms", "plain_ms",
                               "library_ms")},
                "bound_ms": async_folds["screened"][f"{name}_bound"][0]}))
    for e in entries:
        e["launches_by_path"] = {p: c[e["name"]] for p, c in paths.items()}
        if e["name"].startswith("gn_"):
            d = "fwd" if e["name"] == "gn_forward" else "bwd"
            for key, recs in (("slice7a_shapes", gn_slice7a),
                              ("slice7a_ii_shapes", gn_slice7a_ii),
                              ("slice6c_ii_shapes", gn_half)):
                e[key] = [dict(shape=r["shape"], groups=r["groups"],
                               ms=r[f"{d}_ms"], bound_ms=r[f"{d}_bound"][0],
                               **({"plain_ms": r[f"{d}_plain_ms"]}
                                  if f"{d}_plain_ms" in r else {}))
                          for r in recs]
    return {"kernels": entries, "still_to_port": STILL_TO_PORT}


def phase19_paths(rec: dict) -> dict:
    """Phase 19's paths and their launch counts (each zeroed just before
    its path ran)."""
    return {
        "blockstream main path": rec["19a block stream"]["launches"],
        "blockstream norm_clip": rec["19a block stream"]["clip_launches"],
        "two-phase median": rec["19b two-phase"]["median"]["launches"],
        "two-phase krum": rec["19b two-phase"]["krum"]["launches"],
        "serve spine": rec["19d serve"]["launches"],
        "ingest tcp": rec["19e ingest"]["streaming"]["launches"],
        "ingest defended": rec["19e ingest"]["defended"]["launches"],
        "secure messaging": rec["19e ingest"]["secure"]["launches"],
        "connection torture": rec["19f connections"]["launches"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--rank20"]:
        return rank20_main(sys.argv[2])
    if sys.argv[1:2] == ["--rank21"]:
        return rank21_main(sys.argv[2])
    if sys.argv[1:2] == ["--rank24"]:
        from fedml_tpu_torch.parallel.multihost import exit_rank
        exit_rank(rank24_main(sys.argv[2]))
    card = card_line()
    print(card)
    phase_build()
    if sys.argv[1:] == ["--phase", "19"]:
        print(json.dumps({"slice4b": phase_slice4b()}, default=str))
        return 0
    if sys.argv[1:] == ["--phase", "20"]:
        print(json.dumps({"slice6a": phase_slice6a()}, default=str))
        return 0
    if sys.argv[1:] == ["--phase", "21"]:
        print(json.dumps({"slice6b": phase_slice6b()}, default=str))
        return 0
    if sys.argv[1:] == ["--phase", "24"]:
        print(json.dumps({"slice6c_iii_7b": phase_slice6c_iii_7b()},
                         default=str))
        return 0
    if sys.argv[1:] == ["--phase", "22"]:
        print(json.dumps({"slice6c_i": phase_slice6c_i()}, default=str))
        return 0
    gen = torch.Generator(device="cuda").manual_seed(0)
    if sys.argv[1:] == ["--phase", "23"]:
        print(json.dumps({"slice6c_ii": phase_slice6c_ii(gen)}, default=str))
        return 0
    seconds = {}

    def clock(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"[timing] phase {name}: {seconds[name]:.1f} s", flush=True)
        return out

    gn_fwd, gn_bwd = clock("3 gn", phase_gn, gen)
    fold_rec = clock("3 fold", phase_fold, gen)
    robust_rec = clock("3 robust", phase_robust_kernels, gen)
    clock("4 f32 round", phase_f32_round)
    counts = clock("5 main path", phase_main_path)
    c1 = clock("6 robust f32 round", phase_robust_f32_round)
    clock("7 order statistics", phase_orderstat)
    robust_counts = clock("8 robust main path", phase_robust_main_path)
    clock("9 side engines", phase_side_engines)
    zoo = clock("10 zoo", phase_zoo)
    resnet56 = clock("11 resnet56", phase_resnet56_path, gen)
    word_lstm = clock("12 word lstm", phase_word_lstm)
    data_path = clock("13 data path", phase_data_path)
    slice7a = clock("14 slice 7a-i", phase_slice7a, gen)
    slice7a_ii = clock("15 slice 7a-ii", phase_slice7a_ii, gen)
    slice5b_i = clock("16 slice 5b-i", phase_slice5b_i)
    slice5b_ii = clock("17 slice 5b-ii", phase_slice5b_ii)
    slice4a = clock("18 slice 4a", phase_slice4a, gen)
    slice4b = clock("19 slice 4b", phase_slice4b)
    slice6a = clock("20 slice 6a", phase_slice6a)
    slice6b = clock("21 slice 6b", phase_slice6b)
    slice6c_i = clock("22 slice 6c-i", phase_slice6c_i, slice6a)
    slice6c_ii = clock("23 slice 6c-ii", phase_slice6c_ii, gen)
    slice6c_iii_7b = clock("24 slices 6c-iii and 7b", phase_slice6c_iii_7b,
                           slice6a)
    print(json.dumps({"zoo": zoo, "resnet56_path": {
        k: v for k, v in resnet56.items() if k != "fold"},
        "word_lstm": word_lstm, "c1": c1, "data_path": data_path,
        "slice7a": slice7a, "slice7a_ii": slice7a_ii,
        "slice5b_i": slice5b_i, "slice5b_ii": slice5b_ii,
        "slice4a": slice4a, "slice4b": slice4b, "slice6a": slice6a,
        "slice6b": slice6b, "slice6c_i": slice6c_i,
        "slice6c_ii": slice6c_ii, "slice6c_iii_7b": slice6c_iii_7b,
        "seconds": seconds}, default=str))
    print("[timing] seconds by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items())
        + f"; total {sum(seconds.values()):.1f} ({card})")
    paths = {"fedavg main path": counts, "robust main path": robust_counts,
             "data path": data_path["launches"],
             "fedgkt path": slice7a["fedgkt_path"]["launches"],
             "fedseg path": slice7a["fedseg_path"]["launches"],
             "fednas": slice7a_ii["fednas_path"]["launches"],
             **{f"messaging {b.lower()}": r["launches"] for b, r in
                slice5b_i["messaging_path"]["runs"].items()},
             "messaging tcp under chaos": slice5b_ii["chaos"]["chaos"][
                 "launches"],
             "mqtt": slice5b_ii["mqtt"]["mqtt"]["launches"],
             "async scheduler": slice4a["scheduler"]["launches"],
             "async defended": slice4a["defended"]["launches"],
             "async messaging": slice4a["messaging"]["launches"],
             **phase19_paths(slice4b), **phase20_paths(slice6a),
             **phase21_paths(slice6b), **slice6c_i["launches"],
             **{f"batch axis {k}": v
                for k, v in slice6c_ii["launches"].items()},
             **phase24_paths(slice6c_iii_7b)}
    print(json.dumps(kernel_line(gn_fwd, gn_bwd, fold_rec, robust_rec, counts,
                                 robust_counts, resnet56, paths,
                                 slice7a["gn_shapes"],
                                 slice7a_ii["gn_shapes"],
                                 slice5b_i["messaging_path"]["fold"],
                                 slice4a["stream_vs_drain"],
                                 slice6c_ii["gn_half_batch"])))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
