"""One rank of a mesh of ranks: engines over the mesh from a JSON case.

    python -m fedml_tpu_torch.parallel.launch --procs 2 --jax-distributed \\
        -- python -m fedml_tpu_torch.parallel.mesh_worker CASE.json

Each rank joins torch.distributed's gloo group (`init_multihost`, from
the launcher's env), builds every arm's mesh up front (a mesh's groups
are made collectively over the world), runs the arms of the meshes it
belongs to in order (arms on disjoint sub-meshes run at the same time;
an arm it is not a rank of reads {"skipped": true}), and prints ONE JSON
line:

    {"rank", "world", "arms": {tag: {"digest", "launches", "round_walls",
     "wall_s", "gather_walls", "gather_bytes", "batch_fold_walls",
     "batch_fold_bytes", "peak_bytes", "peak_block_bytes", "finite",
     "train_loss", "metrics", "grid", "virtual_silos"}}, "mh_worker":
     {...}}

CASE keys:
    data      path of a pickled FederatedData (the port's)
    model     {"name": ..., "output_dim": ..., other create_model kwargs},
              or {"factory": "package.module:callable", "kw": {...}}
    trainer   ClientTrainer kwargs besides the model ("train_dtype":
              "bfloat16" names a torch dtype)
    cfg       FedConfig kwargs
    weights   path of torch.save'd initial variables (else the engine's
              init)
    device    "cpu", or null for the card (a rank that asked for the card
              and finds none raises)
    deterministic  cuDNN's deterministic algorithms (bitwise runs)
    tf32      false: TF32 off for cuDNN and matmuls (f32 comparisons)
    threads   torch threads a rank
    out       a directory for the arms that "save": {out}/{tag}.rank{r}.pt
    timeout_s the group's join and collective deadline
    arms      [{"tag", "engine": fedavg | fedprox | fedopt | fednova |
              robust | hierarchical | gossip | fedseg | fedgan | fedgkt |
              fednas | fednas_train | centralized, "mesh": {"kind": "1d",
              "n"} | {"kind": "2d", "n_silos", "per_silo"} | {"kind":
              "host", "silos"} | {"kind": "batch", "n_clients",
              "n_batch"} (each with "devices": the ranks of a sub-mesh;
              the others skip the arm), "rounds", "engine_kw" (dtype
              names as strings),
              "cfg", "model", "trainer" (overrides), "data" (another data
              path), "weights" (another weights path), "save", "ckpt"
              ({"dir", "every", "resume"}: FedCheckpointManager on the
              FedAvg family), "gan" ({"latent_dim", "out_dim"}), "gkt"
              ({"client": model spec, "server": model spec}), "genotype"
              (a name in models/darts.py, fednas_train)}]
    mh_worker a parallel/mh_worker.py config run after the arms, on the
              launcher's host channel (its JSON line under "mh_worker")

A gossip arm's model is every worker's ([W, ...] leaves, gathered); a
GAN's the {"gen.", "disc."} pair, FedNAS's the weights and "alpha.*",
FedGKT's "client<i>.*" for every real client and "server.*"; the others'
the global model.  Launches are counted from zero just before each arm's
run, peak device memory likewise.
"""
import contextlib
import importlib
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
    """The arm's mesh, over the ranks `spec["devices"]` names (default:
    the world); None on a rank outside it, which skips the arm."""
    from fedml_tpu_torch.parallel import mesh as pmesh
    from fedml_tpu_torch.parallel import multihost as mh
    kind = spec.get("kind", "1d")
    devs = spec.get("devices")
    if kind == "1d":
        return pmesh.make_mesh(spec.get("n"), devices=devs)
    if kind == "2d":
        return pmesh.make_mesh_2d(spec["n_silos"], spec.get("per_silo"),
                                  devices=devs)
    if kind == "host":
        return mh.make_hierarchical_host_mesh(spec.get("silos"))
    if kind == "batch":
        return pmesh.make_mesh_batch(spec["n_clients"], spec["n_batch"],
                                     devices=devs)
    raise ValueError(f"unknown mesh kind {kind!r}")


def _model(spec: dict):
    """A model from a case's spec: a zoo name, or an importable factory."""
    from fedml_tpu_torch.models import create_model
    spec = dict(spec)
    if "factory" in spec:
        mod, attr = spec["factory"].split(":")
        return getattr(importlib.import_module(mod), attr)(
            **spec.get("kw", {}))
    return create_model(spec.pop("name"), spec.pop("output_dim"), **spec)


def _to(tree, device):
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def _prefixed(**trees) -> dict:
    return {f"{p}.{k}": v for p, t in trees.items() for k, v in t.items()}


def _algorithm(kind: str, arm: dict, case: dict, data, cfg, mesh, device):
    """(engine, run(v0) -> variables dict) of the algorithm arms."""
    from fedml_tpu_torch.algorithms import fedgan, fedgkt, fednas
    from fedml_tpu_torch.algorithms.centralized import CentralizedTrainer
    from fedml_tpu_torch.algorithms.fedseg import make_mesh_fedseg_engine
    from fedml_tpu_torch.models import darts
    from fedml_tpu_torch.models.gan import Discriminator, Generator
    kw = _dtypes(arm.get("engine_kw", {}))
    rounds = arm["rounds"]
    if kind == "fedgan":
        gan = arm.get("gan", {})
        eng = fedgan.make_mesh_fedgan_engine(
            Generator(latent_dim=gan.get("latent_dim", 64),
                      out_dim=gan["out_dim"]), Discriminator(), data, cfg,
            latent_dim=gan.get("latent_dim", 64), mesh=mesh, device=device,
            **kw)
        return eng, lambda v0: eng.run(rounds=rounds, params=v0)
    if kind == "fedgkt":
        eng = fedgkt.MeshFedGKTEngine(_model(arm["gkt"]["client"]),
                                      _model(arm["gkt"]["server"]), data,
                                      cfg, mesh=mesh, device=device, **kw)

        def run_gkt(v0):
            cps, sp = eng.run(rounds=rounds, params=v0)
            return _prefixed(**{f"client{i}": cp for i, cp in enumerate(cps)},
                             server=sp)
        return eng, run_gkt
    if kind == "fednas":
        eng = fednas.make_mesh_fednas_engine(data, cfg, mesh=mesh,
                                             device=device, **kw)

        def run_nas(v0):
            p, a = eng.run(rounds=rounds, params=v0[0], alphas=v0[1])
            return {**p, **_prefixed(alpha=a)}
        return eng, run_nas
    if kind == "fednas_train":
        eng = fednas.make_train_engine(
            getattr(darts, arm["genotype"]), data, cfg, mesh=mesh,
            device=device, **kw)
        return eng, lambda v0: eng.run(variables=v0, rounds=rounds)
    trainer = _trainer(case, arm)
    if kind == "fedseg":
        eng = make_mesh_fedseg_engine(trainer, data, cfg, mesh=mesh,
                                      device=device, **kw)
        return eng, lambda v0: eng.run(variables=v0, rounds=rounds)
    if kind == "centralized":
        eng = CentralizedTrainer(trainer, data, cfg, mesh=mesh, device=device)
        return eng, lambda v0: eng.run(epochs=rounds, variables=v0)
    raise ValueError(f"unknown engine {kind!r}")


def _init(eng):
    """An engine's own initial state, in the form its run takes."""
    for name in ("init_variables", "init_params", "init_state"):
        if hasattr(eng, name):
            return getattr(eng, name)()
    raise ValueError(f"{type(eng).__name__} arms need \"weights\"")


def _trainer(case: dict, arm: dict):
    from fedml_tpu_torch.core.trainer import ClientTrainer
    spec = arm.get("model", case.get("model"))
    return ClientTrainer(_model(spec), **_dtypes(
        {**case.get("trainer", {}), **arm.get("trainer", {})}))


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


ALGORITHMS = ("fedseg", "fedgan", "fedgkt", "fednas", "fednas_train",
              "centralized")


def build_meshes(arms: list) -> list:
    """Every arm's mesh, built up front in the arms' order on every rank
    (group creation is collective over the world): the arms then run
    without a world-wide step between them, so arms on disjoint sub-meshes
    run at the same time.  Arms with one mesh spec share one mesh (and its
    process groups: each group holds sockets for its run).  Warnings of
    virtual silos are noted per mesh."""
    built: dict = {}
    for arm in arms:
        key = json.dumps(arm["mesh"], sort_keys=True)
        if key in built:
            continue
        warned = _Warnings()
        logger = logging.getLogger("fedml_tpu_torch.parallel.multihost")
        logger.addHandler(warned)
        try:
            built[key] = (_mesh(arm["mesh"]), any(
                "VIRTUAL" in m for m in warned.messages))
        finally:
            logger.removeHandler(warned)
    return [built[json.dumps(arm["mesh"], sort_keys=True)] for arm in arms]


def run_arm(case: dict, arm: dict, rank: int, data_cache: dict,
            mesh_rec: tuple) -> dict:
    import torch

    from fedml_tpu_torch.ops import launch_counts, reset_launch_counts
    from fedml_tpu_torch.parallel import engine as peng
    from fedml_tpu_torch.parallel.gossip import MeshGossipEngine
    from fedml_tpu_torch.parallel.hierarchical import MeshHierarchicalEngine
    from fedml_tpu_torch.parallel.multihost import variables_digest
    from fedml_tpu_torch.utils.checkpoint import FedCheckpointManager
    from fedml_tpu_torch.utils.config import FedConfig

    path = arm.get("data", case["data"])
    if path not in data_cache:
        with open(path, "rb") as f:
            data_cache[path] = pickle.load(f)
    data = data_cache[path]
    cfg = FedConfig(**{**case["cfg"], **arm.get("cfg", {})})
    mesh, virtual = mesh_rec
    walls, losses = [], []
    if arm["engine"] in ALGORITHMS:
        eng, run = _algorithm(arm["engine"], arm, case, data, cfg, mesh,
                              case.get("device"))
    else:
        kw = dict(_dtypes(arm.get("engine_kw", {})),
                  device=case.get("device"), mesh=mesh)
        engines = {"fedavg": peng.MeshFedAvgEngine,
                   "fedprox": peng.MeshFedProxEngine,
                   "fedopt": peng.MeshFedOptEngine,
                   "fednova": peng.MeshFedNovaEngine,
                   "robust": peng.MeshRobustEngine,
                   "hierarchical": MeshHierarchicalEngine,
                   "gossip": MeshGossipEngine}
        eng = engines[arm["engine"]](_trainer(case, arm), data, cfg, **kw)
        round_fn = eng.round_fn

        def timed(*args):
            t0 = time.perf_counter()
            out = round_fn(*args)
            losses.append(float(out[-1]["train_loss"]))  # waits for the round
            walls.append(time.perf_counter() - t0)
            return out

        eng.round_fn = timed
        ck = arm.get("ckpt")
        ckpt_kw = {} if not ck else dict(
            ckpt=FedCheckpointManager(ck["dir"]),
            ckpt_every=ck.get("every", 1),
            resume=ck.get("resume", False))
        if arm["engine"] == "gossip":
            def run(v0):
                return eng.worker_variables(eng.run(rounds=arm["rounds"],
                                                    variables=dict(v0)))
        else:
            def run(v0):
                return eng.run(variables=dict(v0), rounds=arm["rounds"],
                               **ckpt_kw)
    weights = arm.get("weights", case.get("weights"))
    if weights:
        v0 = _to(torch.load(weights, weights_only=True), eng.device)
    else:
        v0 = _init(eng)
    cuda = eng.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if cuda else 0
    reset_launch_counts()
    t0 = time.perf_counter()
    v = run(v0)
    if cuda:
        torch.cuda.synchronize()
    fold_walls, fold_bytes = eng.exchange.log(("batch",))
    rec = dict(
        digest=variables_digest(v), launches=launch_counts(),
        wall_s=time.perf_counter() - t0, round_walls=walls,
        train_loss=losses, gather_walls=eng.exchange.walls,
        gather_bytes=eng.exchange.bytes, batch_fold_walls=fold_walls,
        batch_fold_bytes=fold_bytes,
        peak_block_bytes=getattr(eng, "peak_resident_block_bytes", 0),
        metrics=getattr(eng, "metrics_history", [])[-1:],
        peak_bytes=(torch.cuda.max_memory_allocated() - base) if cuda
        else 0,
        finite=all(bool(torch.isfinite(t).all()) for t in v.values()),
        grid=mesh.grid.tolist(), coords=mesh.coords,
        virtual_silos=virtual)
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

    from fedml_tpu_torch.parallel.multihost import (MultihostContext,
                                                    init_multihost)
    if case.get("threads"):
        torch.set_num_threads(int(case["threads"]))
    if case.get("deterministic"):
        torch.backends.cudnn.deterministic = True
    ctx = MultihostContext.from_env() or MultihostContext.single()
    init_multihost(required=ctx.world > 1,
                   timeout_s=float(case.get("timeout_s", 300.0)))
    if case.get("tf32") is False:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    out = {"rank": ctx.rank, "world": ctx.world, "arms": {}}
    data_cache: dict = {}
    meshes = build_meshes(case["arms"])
    for arm, mesh_rec in zip(case["arms"], meshes):
        if mesh_rec[0] is None:             # not a rank of this arm's mesh
            out["arms"][arm["tag"]] = {"skipped": True}
            continue
        t0 = time.perf_counter()
        out["arms"][arm["tag"]] = run_arm(case, arm, ctx.rank,
                                          data_cache, mesh_rec)
        out["arms"][arm["tag"]]["arm_s"] = time.perf_counter() - t0
    if case.get("mh_worker"):
        out["mh_worker"] = run_mh_worker(case["mh_worker"], case["out"],
                                         ctx.rank)
    # the gloo world ends with the process (exit_rank), not through a
    # teardown in it
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    from fedml_tpu_torch.parallel.multihost import exit_rank
    exit_rank(main())
