#!/usr/bin/env python3
"""Drive the PyTorch port's FedAvg, robust-aggregation, model-zoo,
data-layer, one-card-algorithm, FedNAS and message-driven FedAvg paths on
one CUDA card (the last also under injected faults and over MQTT, with
program timing and the observatory), and hold every hand-written kernel
against its plain PyTorch version.

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
   recipe (8 client threads, bf16 masters) for 2 rounds over INPROC, TCP
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
18. one JSON line of the zoo's, C.1's, the data path's and slices 7a-i's,
   7a-ii's, 5b-i's and 5b-ii's numbers, one listing every TPU kernel of
   the JAX package with its port's numbers and its launches on every
   path, then the last line {"ok": true, "device": {...}}.

It needs one card; it imports nothing of JAX or of fedml_tpu.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pickle
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path
from types import SimpleNamespace

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
from fedml_tpu_torch.core import robust as robust_ops
from fedml_tpu_torch.core.flatmodel import FlatModel
from fedml_tpu_torch.core.partition import partition_homo
from fedml_tpu_torch.core.pytree import clip_scale
from fedml_tpu_torch.core.topology import (AsymmetricTopologyManager,
                                           SymmetricTopologyManager)
from fedml_tpu_torch.core.trainer import ClientTrainer
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
from fedml_tpu_torch.utils.config import FedConfig

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 rate outside the tensor cores
GN_STREAMING_SHAPE = (2, 224, 224, 64)   # a group too large for 8 blocks' smem
N_PARAMS = 11_173_962          # ResNet-18-GN at num_filters=64, 10 classes
P_PADDED = N_PARAMS + (-N_PARAMS) % 512
BATCH, SAMPLES, BATCHES = 32, 390, 13
MAIN_CLIENTS, MAIN_CHUNK, MAIN_ROUNDS = 8, 2, 3
R56_ROUNDS = 2                 # phase 11 (cut from 3 to hold the script's time)
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
    for order in (("fedavg", "norm_clip"), ("norm_clip", "fedavg"),
                  ("fedavg", "norm_clip")):
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
    f64 on the host); and a profiled round of one chunk's 2 clients."""
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
    # the profile reads a round of one chunk's clients: a whole round's
    # trace (~300,000 events) takes minutes to read
    sub = {k: v[:MAIN_CHUNK] for k, v in cohort.items()}
    sub_round = lambda: engine.round_fn_streaming(variables, (), sub,
                                                  weights[:MAIN_CHUNK])
    sub_round()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sub_round()
    torch.cuda.synchronize()
    sub_s = time.perf_counter() - t0
    prof = profile_round(sub_round, sub_s,
                         tag=f"resnet56 path, {MAIN_CHUNK} clients")
    return dict(s_per_round=round_s, steady_s=steady, losses=losses,
                eval=stats, launches=counts, fold=fold_rec,
                stats_fold_max_abs_err=err, profile=prof,
                profiled_round_s=sub_s, profiled_clients=MAIN_CHUNK,
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
    for order in (("f32", "uint8+augment"), ("uint8+augment", "f32"),
                  ("f32", "uint8+augment")):
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
    GKT_PROFILED of the clients, timed and under the profiler."""
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
    # the busy share from a round of 1 of the 8 clients (the same steps per
    # client; a whole round's trace takes minutes of host time to read)
    for name in totals:
        delattr(engine, name)                      # the untimed methods again
    sub = {k: v[:GKT_PROFILED] for k, v in shards.items()}
    sub_round = lambda: engine.train_round(flats[:GKT_PROFILED], sp, opt,
                                           slog[:GKT_PROFILED], sub)
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
NAS_CLIENTS, NAS_BATCHES, NAS_LR = 4, 4, 0.025
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
# (mode, rounds, clients a round): one round of each mode, the second-order
# round on 1 of the 4 clients, to keep the script's time (its steps cost
# ~5x a first-order one)
NAS_PATH_ROUNDS = (("first_order", 1, NAS_CLIENTS), ("unrolled", 1, 1),
                   ("gdas", 1, NAS_CLIENTS))


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
    split: 2 train and 2 validation batches each), the published
    optimizers (w: clip 5, wd 3e-4, SGD lr 0.025 momentum 0.9; alphas:
    Adam 3e-4, b1 0.5, wd 1e-3): NAS_PATH_ROUNDS (1 first-order round, 1
    exact second-order round on 1 of the clients, 1 GDAS round), each with an
    evaluation; the derived genotype; then make_train_engine(genotype, C
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

MSG_ROUNDS = 2                 # rounds of each messaging backend
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


def kernel_line(gn_fwd: dict, gn_bwd: dict, fold_rec: dict, robust: dict,
                counts: dict, robust_counts: dict, resnet56: dict,
                paths: dict, gn_slice7a: list, gn_slice7a_ii: list,
                messaging_fold_rec: dict) -> dict:
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
    bound a call), and the fold's entry its finalize form at the messaging
    server's [8, P] bf16 rows."""
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
        launches=counts["wsum"], max_abs_err=fold_rec["max_abs_err"],
        ms=fold_rec["ms"], host_ms=fold_rec["host_ms"],
        plain_ms=fold_rec["plain_ms"],
        bound_ms=fold_rec["bound"][0], bound_by=fold_rec["bound"][1],
        library_ms=fold_rec["library_ms"],
        unit=f"one chunk fold: [{MAIN_CHUNK}, P] bf16 into f32 acc",
        finalize=fold_rec["finalize"],
        messaging_path={k: (v[0] if k == "bound" else v)
                        for k, v in messaging_fold_rec.items()},
        resnet56_path={k: (v[0] if k == "bound" else v)
                       for k, v in resnet56["fold"].items()}))
    for name in ("sqnorm", "clip_agg"):
        main, other = robust[name]
        entries.append(dict(
            name=name, route="cuda", source="fedml_tpu_torch/csrc/robust.cu",
            replaces=TPU_KERNELS[name][0], function=TPU_KERNELS[name][1],
            status="ported", launches=robust_counts[name],
            max_abs_err=max(main["max_abs_err"], other["max_abs_err"]),
            ms=main["ms"], host_ms=main["host_ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound"][0], bound_by=main["bound"][1],
            library_ms=main["library_ms"], library=main["library"],
            unit=f"one call at the mesh chunk: [{MAIN_CHUNK}, P] bf16"
                 + (", accumulate form" if name == "clip_agg" else ""),
            fedavg_robust={k: v for k, v in other.items()}))
    for e in entries:
        e["launches_by_path"] = {p: c[e["name"]] for p, c in paths.items()}
        if e["name"].startswith("gn_"):
            d = "fwd" if e["name"] == "gn_forward" else "bwd"
            for key, recs in (("slice7a_shapes", gn_slice7a),
                              ("slice7a_ii_shapes", gn_slice7a_ii)):
                e[key] = [dict(shape=r["shape"], groups=r["groups"],
                               ms=r[f"{d}_ms"], bound_ms=r[f"{d}_bound"][0])
                          for r in recs]
    return {"kernels": entries, "still_to_port": STILL_TO_PORT}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    seconds = {}

    def clock(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
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
    print(json.dumps({"zoo": zoo, "resnet56_path": {
        k: v for k, v in resnet56.items() if k != "fold"},
        "word_lstm": word_lstm, "c1": c1, "data_path": data_path,
        "slice7a": slice7a, "slice7a_ii": slice7a_ii,
        "slice5b_i": slice5b_i, "slice5b_ii": slice5b_ii,
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
             "mqtt": slice5b_ii["mqtt"]["mqtt"]["launches"]}
    print(json.dumps(kernel_line(gn_fwd, gn_bwd, fold_rec, robust_rec, counts,
                                 robust_counts, resnet56, paths,
                                 slice7a["gn_shapes"],
                                 slice7a_ii["gn_shapes"],
                                 slice5b_i["messaging_path"]["fold"])))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
