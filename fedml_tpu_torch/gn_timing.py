"""Device time of the GroupNorm kernels and of one whole GroupNorm layer at
the main path's four stage shapes, and a comparison of two trees of this
package timed in turns on one card.

    python3 fedml_tpu_torch/gn_timing.py --parent DIR [--out FILE]
    python3 fedml_tpu_torch/gn_timing.py --sweep
    python3 fedml_tpu_torch/gn_timing.py --stress SECONDS

runs, from the root of a checkout on a CUDA card, one process per turn in
the order parent, change, change, parent (DIR holds the parent's
checkout; the change is this file's checkout).  Each process imports
``fedml_tpu_torch`` from its own tree only and measures, with bf16 x and
bf16 gamma/beta as the main path holds them:

* ``gn_forward`` and ``gn_backward`` per call: device time of all the
  work the wrapper issues (CUDA events, the card held until the calls are
  queued), and each device kernel's own time under ``torch.profiler``;
* one layer, ``group_norm`` forward then ``torch.autograd.grad``: its
  device time and the device kernels it issues;
* then that tree's ``chip_smoke.py`` phases 2 and 5 (build, and the
  FedAvg main path with its profiled round), whose s/round is read from
  its output.

It prints one JSON line per turn and a summary, and writes them to FILE
if one is given.
``--sweep`` times this checkout's wrappers at each setting of the launch
plan's two knobs (bytes and threads a block aims for).
``--stress`` repeats chip_smoke.py's GroupNorm check (``gn_check``) at the
four stage shapes in the four pairings of bf16 and f32 x and gamma, on
fresh inputs, until SECONDS have passed, and prints one JSON line: the
rounds, the checks and every failure's message.  Run it in several fresh
processes to look for a failure that shows only now and then.
chip_smoke.py uses the same helpers for its phase 3.  Only torch is
imported at module level: the measuring process picks its tree first.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

GN_STAGES = ((32, 32, 32, 64), (32, 16, 16, 128), (32, 8, 8, 256),
             (32, 4, 4, 512))
GN_LAYERS_PER_STAGE = 5        # 20 GroupNorm layers, five at each stage shape
GROUPS, FLAX_EPS = 2, 1e-6
PROFILE_REPS = 5


def cuda_ms(fn, reps: int = 20, trials: int = 7) -> float:
    """Device time of one call: the median over `trials` of the mean time
    of `reps` back-to-back calls between two CUDA events, after a warm-up.
    A spin kernel ahead of the first event holds the card until the host
    has queued all `reps` calls, so host overhead between launches is not
    counted."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(50_000_000)          # ~30 ms of spinning
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def host_ms(fn, reps: int = 50) -> float:
    """Wall time of one call on the host, the card waited for at the end:
    where it exceeds cuda_ms, launching, not the card, sets the pace."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def device_kernels(fn, reps: int = PROFILE_REPS) -> list[dict]:
    """The device work one call of `fn` issues, under torch.profiler:
    each kernel, copy or fill by name, with its launches and device
    microseconds per call (averaged over `reps` calls, after a warm-up)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the tracer can miss the first and the last kernels of its
        # window: spin kernels take those places and are left out below
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    return [dict(name=e.key, launches=e.count / reps,
                 us=e.self_device_time_total / reps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count
            and "spin_kernel" not in e.key]


def layer_call(group_norm, x, gamma, beta, dy):
    """One GroupNorm layer's forward and backward, as autograd runs it in
    training: `x`, `gamma` and `beta` must require grad."""
    def run():
        y = group_norm(x, gamma, beta, GROUPS, FLAX_EPS)
        return torch.autograd.grad(y, (x, gamma, beta), dy)
    return run


def stage_inputs(shape, gen: torch.Generator, dtype=torch.bfloat16,
                 param_dtype=torch.bfloat16):
    """x, dy, gamma, beta at one stage shape, made on the card from `gen`
    (gamma near 1 and beta near 0, as trained GroupNorm layers hold)."""
    C = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    gamma = (1 + 0.1 * torch.randn(C, generator=gen, device="cuda")).to(param_dtype)
    beta = (0.1 * torch.randn(C, generator=gen, device="cuda")).to(param_dtype)
    return x, dy, gamma, beta


def _kernel_us(rows: list[dict], tag: str) -> float:
    return sum(r["us"] for r in rows if tag in r["name"])


def measure_tree(tree: Path) -> dict:
    """Everything one turn measures, with `tree`'s fedml_tpu_torch."""
    sys.path.insert(0, str(tree))
    from fedml_tpu_torch.ops import groupnorm as gn
    if not Path(gn.__file__).resolve().is_relative_to(tree.resolve()):
        raise RuntimeError(f"imported {gn.__file__}, not from {tree}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = []
    for shape in GN_STAGES:
        x, dy, gamma, beta = stage_inputs(shape, gen)
        _, mean, rstd = gn.gn_forward(x, gamma, beta, GROUPS, FLAX_EPS)
        fwd = lambda: gn.gn_forward(x, gamma, beta, GROUPS, FLAX_EPS)
        bwd = lambda: gn.gn_backward(x, dy, gamma, mean, rstd, GROUPS)
        layer = layer_call(gn.group_norm, *(t.detach().clone().requires_grad_()
                                            for t in (x, gamma, beta)), dy)
        fwd_rows, bwd_rows = device_kernels(fwd), device_kernels(bwd)
        layer_rows = device_kernels(layer)
        shapes.append(dict(
            shape=list(shape),
            fwd_ms=cuda_ms(fwd), bwd_ms=cuda_ms(bwd), layer_ms=cuda_ms(layer),
            layer_host_ms=host_ms(layer),
            fwd_kernel_us=_kernel_us(fwd_rows, "gn_fwd_kernel"),
            bwd_kernel_us=_kernel_us(bwd_rows, "gn_bwd_kernel"),
            layer_launches=sum(r["launches"] for r in layer_rows),
            layer_kernels=layer_rows))
    smoke = _load_smoke(tree)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        smoke.phase_build()
        smoke.phase_main_path()
    text = out.getvalue()
    found = re.search(r"-> ([0-9.]+) s/round", text)
    return dict(tree=str(tree), device=torch.cuda.get_device_name(0),
                shapes=shapes, s_per_round=float(found.group(1)) if found else None,
                main_path=[l for l in text.splitlines()
                           if l.startswith(("[main path] s/round", "[profile]"))])


def sweep_plan(block_bytes=(4096, 8192, 16384),
               threads=(64, 128, 256)) -> list[dict]:
    """The GroupNorm wrappers' device time at the stage shapes (bf16 x and
    gamma/beta) for each pairing of the launch plan's two knobs: the bytes
    of x a block aims to hold (which sets the cluster size) and the
    threads a block aims for."""
    from fedml_tpu_torch.ops import groupnorm as gn
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = [stage_inputs(shape, gen) for shape in GN_STAGES]
    default, out = (gn.BLOCK_BYTES, gn.BLOCK_THREADS), []
    try:
        for nbytes in block_bytes:
            for t in threads:
                gn.BLOCK_BYTES, gn.BLOCK_THREADS = nbytes, t
                for shape, (x, dy, gamma, beta) in zip(GN_STAGES, inputs):
                    _, mean, rstd = gn.gn_forward(x, gamma, beta, GROUPS, FLAX_EPS)
                    out.append(dict(
                        block_bytes=nbytes, block_threads=t, shape=list(shape),
                        fwd_ms=cuda_ms(lambda: gn.gn_forward(
                            x, gamma, beta, GROUPS, FLAX_EPS)),
                        bwd_ms=cuda_ms(lambda: gn.gn_backward(
                            x, dy, gamma, mean, rstd, GROUPS))))
    finally:
        gn.BLOCK_BYTES, gn.BLOCK_THREADS = default
    return out


def stress(seconds: float) -> dict:
    """chip_smoke.py's gn_check, again and again on new inputs from a new
    seed each round, for `seconds`; its failures are recorded, not
    raised."""
    smoke = _load_smoke(Path(__file__).resolve().parent.parent)
    t0, rounds, checks, failures = time.perf_counter(), 0, 0, []
    while time.perf_counter() - t0 < seconds:
        gen = torch.Generator(device="cuda").manual_seed(rounds)
        for shape in GN_STAGES:
            x, dy, gamma, beta = stage_inputs(shape, gen,
                                              param_dtype=torch.float32)
            g16, b16 = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
            for xx, dd in ((x, dy), (x.float(), dy.float())):
                for gg, bb in ((g16, b16), (gamma, beta)):
                    tag = f"{shape} x {xx.dtype}, gamma {gg.dtype}, round {rounds}"
                    checks += 1
                    try:
                        smoke.gn_check(xx, dd, gg, bb, tag)
                    except AssertionError as e:
                        failures.append(str(e))
        rounds += 1
    return dict(seconds=time.perf_counter() - t0, rounds=rounds,
                checks=checks, failures=failures)


def _load_smoke(tree: Path):
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke", tree / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def summarise(turns: list[dict]) -> dict:
    """Per tree, the mean of its two turns at each shape; whether the
    change's kernels beat the parent's at every shape, and whether its
    layer takes at most half the parent's device time over the shapes."""
    by = {"parent": [t for t in turns if t["role"] == "parent"],
          "change": [t for t in turns if t["role"] == "change"]}
    mean = lambda role, i, key: statistics.mean(t["shapes"][i][key] for t in by[role])
    rows = []
    for i, shape in enumerate(GN_STAGES):
        rows.append({"shape": list(shape), **{
            f"{role}_{key}": mean(role, i, key) for role in by
            for key in ("fwd_ms", "bwd_ms", "layer_ms", "fwd_kernel_us",
                        "bwd_kernel_us", "layer_launches", "layer_host_ms")}})
    layer = {role: sum(r[f"{role}_layer_ms"] for r in rows) for role in by}
    return dict(
        shapes=rows,
        kernels_faster_every_shape=all(
            r[f"change_{k}"] < r[f"parent_{k}"] for r in rows
            for k in ("fwd_ms", "bwd_ms", "fwd_kernel_us", "bwd_kernel_us")),
        layer_ms_sum=layer, layer_ratio=layer["change"] / layer["parent"],
        s_per_round={role: [t["s_per_round"] for t in by[role]] for role in by})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="the parent's checkout")
    ap.add_argument("--out", type=Path, help="also write the turns and the "
                    "summary to this JSON file")
    ap.add_argument("--sweep", action="store_true",
                    help="time the launch plan's knobs instead")
    ap.add_argument("--stress", type=float, metavar="SECONDS",
                    help="repeat chip_smoke.py's GroupNorm check instead")
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gn_timing: no CUDA device is available", file=sys.stderr)
        return 1
    if args.sweep:
        sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
        for row in sweep_plan():
            print(json.dumps(row))
        return 0
    if args.stress is not None:
        sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
        print(json.dumps(stress(args.stress)))
        return 0
    if args.measure:
        print(json.dumps(measure_tree(args.measure)))
        return 0
    if args.parent is None:
        ap.error("give --parent DIR (or --sweep)")
    change = Path(__file__).resolve().parent.parent
    turns = []
    for role, tree in (("parent", args.parent), ("change", change),
                       ("change", change), ("parent", args.parent)):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--measure",
             str(tree.resolve())], cwd=tree, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{role} turn failed:\n{proc.stdout}\n{proc.stderr}")
        turns.append({"role": role, **json.loads(proc.stdout.splitlines()[-1])})
        print(json.dumps(turns[-1]))
    summary = summarise(turns)
    print(json.dumps(summary))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"turns": turns, "summary": summary},
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
