"""One rank of a client-axis mesh: engines over a mesh of ranks from a
JSON case.

    python -m fedml_tpu_torch.parallel.launch --procs 2 --jax-distributed \\
        -- python -m fedml_tpu_torch.parallel.mesh_worker CASE.json

Each rank joins torch.distributed's gloo group (`init_multihost`, from
the launcher's env), runs the case's arms in order (every rank the same
arms: a mesh's groups are made collectively), and prints ONE JSON line:

    {"rank", "world", "arms": {tag: {"digest", "launches", "round_walls",
     "wall_s", "gather_walls", "gather_bytes", "peak_bytes", "finite",
     "train_loss", "grid", "virtual_silos"}}, "mh_worker": {...}}

CASE keys:
    data      path of a pickled FederatedData (the port's)
    model     {"name": ..., "output_dim": ..., other create_model kwargs}
    trainer   ClientTrainer kwargs besides the model ("train_dtype":
              "bfloat16" names a torch dtype)
    cfg       FedConfig kwargs
    weights   path of torch.save'd initial variables (else the engine's
              init)
    device    "cpu", or null for the card (a rank that asked for the card
              and finds none raises)
    deterministic  cuDNN's deterministic algorithms (bitwise runs)
    threads   torch threads a rank
    out       a directory for the arms that "save": {out}/{tag}.rank{r}.pt
    timeout_s the group's join and collective deadline
    arms      [{"tag", "engine": fedavg | fedprox | fedopt | fednova |
              robust | hierarchical | gossip, "mesh": {"kind": "1d", "n"}
              | {"kind": "2d", "n_silos", "per_silo"} | {"kind": "host",
              "silos"}, "rounds", "engine_kw" (dtype names as strings),
              "cfg" (overrides), "data" (another data path), "save"}]
    mh_worker a parallel/mh_worker.py config run after the arms, on the
              launcher's host channel (its JSON line under "mh_worker")

A gossip arm's model is every worker's ([W, ...] leaves, gathered); the
others' the global model.  Launches are counted from zero just before
each arm's run, peak device memory likewise.
"""
import contextlib
import io
import json
import logging
import os
import pickle
import sys
import time

DTYPE_KEYS = ("local_dtype", "stack_dtype", "train_dtype")


def _dtypes(kw: dict) -> dict:
    import torch
    return {k: (getattr(torch, v) if k in DTYPE_KEYS and isinstance(v, str)
                else v) for k, v in kw.items()}


def _mesh(spec: dict):
    from fedml_tpu_torch.parallel import mesh as pmesh
    from fedml_tpu_torch.parallel import multihost as mh
    kind = spec.get("kind", "1d")
    if kind == "1d":
        return pmesh.make_mesh(spec.get("n"))
    if kind == "2d":
        return pmesh.make_mesh_2d(spec["n_silos"], spec.get("per_silo"))
    if kind == "host":
        return mh.make_hierarchical_host_mesh(spec.get("silos"))
    raise ValueError(f"unknown mesh kind {kind!r}")


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def run_arm(case: dict, arm: dict, rank: int, data_cache: dict) -> dict:
    import torch

    from fedml_tpu_torch.core.trainer import ClientTrainer
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops import launch_counts, reset_launch_counts
    from fedml_tpu_torch.parallel import engine as peng
    from fedml_tpu_torch.parallel.gossip import MeshGossipEngine
    from fedml_tpu_torch.parallel.hierarchical import MeshHierarchicalEngine
    from fedml_tpu_torch.parallel.multihost import variables_digest
    from fedml_tpu_torch.utils.config import FedConfig

    path = arm.get("data", case["data"])
    if path not in data_cache:
        with open(path, "rb") as f:
            data_cache[path] = pickle.load(f)
    data = data_cache[path]
    cfg = FedConfig(**{**case["cfg"], **arm.get("cfg", {})})
    model_kw = dict(case["model"])
    model = create_model(model_kw.pop("name"), model_kw.pop("output_dim"),
                         **model_kw)
    trainer = ClientTrainer(model, **_dtypes(case.get("trainer", {})))
    warned = _Warnings()
    logging.getLogger("fedml_tpu_torch.parallel.multihost").addHandler(
        warned)
    try:
        mesh = _mesh(arm["mesh"])
    finally:
        logging.getLogger("fedml_tpu_torch.parallel.multihost") \
            .removeHandler(warned)
    kw = dict(_dtypes(arm.get("engine_kw", {})), device=case.get("device"),
              mesh=mesh)
    engines = {"fedavg": peng.MeshFedAvgEngine,
               "fedprox": peng.MeshFedProxEngine,
               "fedopt": peng.MeshFedOptEngine,
               "fednova": peng.MeshFedNovaEngine,
               "robust": peng.MeshRobustEngine,
               "hierarchical": MeshHierarchicalEngine,
               "gossip": MeshGossipEngine}
    eng = engines[arm["engine"]](trainer, data, cfg, **kw)
    if case.get("weights"):
        v0 = torch.load(case["weights"], weights_only=True)
        v0 = {k: v.to(eng.device) for k, v in v0.items()}
    else:
        v0 = eng.init_variables()
    cuda = eng.device.type == "cuda"
    walls, losses = [], []
    round_fn = eng.round_fn

    def timed(*args):
        t0 = time.perf_counter()
        out = round_fn(*args)
        losses.append(float(out[-1]["train_loss"]))    # waits for the round
        walls.append(time.perf_counter() - t0)
        return out

    eng.round_fn = timed
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if cuda else 0
    reset_launch_counts()
    t0 = time.perf_counter()
    if arm["engine"] == "gossip":
        rows = eng.run(rounds=arm["rounds"], variables=dict(v0))
        v = eng.worker_variables(rows)
    else:
        v = eng.run(variables=dict(v0), rounds=arm["rounds"])
    if cuda:
        torch.cuda.synchronize()
    rec = dict(
        digest=variables_digest(v), launches=launch_counts(),
        wall_s=time.perf_counter() - t0, round_walls=walls,
        train_loss=losses, gather_walls=eng.exchange.walls,
        gather_bytes=eng.exchange.bytes,
        peak_bytes=(torch.cuda.max_memory_allocated() - base) if cuda
        else 0,
        finite=all(bool(torch.isfinite(t).all()) for t in v.values()),
        grid=mesh.grid.tolist(), coords=mesh.coords,
        virtual_silos=any("VIRTUAL" in m for m in warned.messages))
    if arm.get("save"):
        torch.save({k: t.detach().cpu() for k, t in v.items()},
                   os.path.join(case["out"], f"{arm['tag']}.rank{rank}.pt"))
    return rec


def run_mh_worker(cfg: dict, out_dir: str, rank: int) -> dict:
    """parallel/mh_worker.py's run on this rank (its channel is the
    launcher's FEDML_MH_COORD); its JSON line."""
    from fedml_tpu_torch.parallel import mh_worker
    path = os.path.join(out_dir, f"mh_worker.rank{rank}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mh_worker.main([path])
    if rc != 0:
        raise RuntimeError(f"mh_worker exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("usage: python -m fedml_tpu_torch.parallel.mesh_worker "
              "CASE.json", file=sys.stderr)
        return 2
    with open(argv[0]) as f:
        case = json.load(f)
    import torch
    import torch.distributed as dist

    from fedml_tpu_torch.parallel.multihost import (MultihostContext,
                                                    init_multihost)
    if case.get("threads"):
        torch.set_num_threads(int(case["threads"]))
    if case.get("deterministic"):
        torch.backends.cudnn.deterministic = True
    ctx = MultihostContext.from_env() or MultihostContext.single()
    init_multihost(required=ctx.world > 1,
                   timeout_s=float(case.get("timeout_s", 300.0)))
    out = {"rank": ctx.rank, "world": ctx.world, "arms": {}}
    data_cache: dict = {}
    try:
        for arm in case["arms"]:
            out["arms"][arm["tag"]] = run_arm(case, arm, ctx.rank,
                                              data_cache)
        if case.get("mh_worker"):
            out["mh_worker"] = run_mh_worker(case["mh_worker"], case["out"],
                                             ctx.rank)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
