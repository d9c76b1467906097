"""The PyTorch port's engines over a client-axis mesh of two ranks
(fedml_tpu_torch/parallel/mesh.py and engine.py's `mesh=`), in ONE
spawned 2-rank gloo cluster of the port's mesh worker
(`python -m fedml_tpu_torch.parallel.mesh_worker`, launched with
`jax_distributed=True`) that runs every case, against the JAX package's
engines on `make_mesh(2)` of the 8 forced CPU devices and against the
port's own one-process runs.

Cases: LR on 8x8x3, 16 clients of uneven shards, chunk 2, 2 rounds from
JAX's init (carried across with `convert`): FedAvg at full and partial
participation (10 of 16, as tests/test_parallel.py:45), FedProx, FedOpt
with adam, FedNova, norm_clip (and norm_clip with weak-DP noise, whose
generator every rank draws identically), median and krum.  Each case is
held three ways:

* against JAX's engine on `make_mesh(2)`, rtol 2e-4 / atol 2e-5 (the
  tolerance of tests/test_parallel.py:41-43; the noise case has no JAX
  counterpart: its draws are the port's);
* the two ranks commit the same bits;
* FedAvg at full participation and norm_clip (with and without the
  noise) are bitwise the port's 1-rank MultihostRunner over 2 blocks
  (the same lanes and the same left fold of two partials; one noise
  draw a commit), the order statistics bitwise the one-card engine,
  and a second run of the FedAvg case commits the first run's bits.

The cluster's last step runs the port's mh_worker with
``jax_distributed: true`` over the launcher's host channel: its digests
are the ones the worker gives without the key.
"""
import contextlib
import io
import json
import os
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core.trainer import ClientTrainer as JaxClientTrainer
from fedml_tpu.data import federated as jfed
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.parallel import engine as jengine
from fedml_tpu.parallel.mesh import make_mesh
from fedml_tpu.utils.config import FedConfig as JaxFedConfig
from fedml_tpu_torch.convert import flax_to_torch
from fedml_tpu_torch.core.trainer import ClientTrainer
from fedml_tpu_torch.data import federated as tfed
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.parallel import engine as tengine
from fedml_tpu_torch.parallel import mh_worker
from fedml_tpu_torch.parallel import multihost as tmh
from fedml_tpu_torch.utils.config import FedConfig
from tests.test_torch_stream import _data
from tests.test_torch_transports import free_base_port

REPO = Path(__file__).resolve().parent.parent
N_CLIENTS, HW, ROUNDS = 16, 8, 2
BASE_CFG = dict(client_num_in_total=N_CLIENTS,
                client_num_per_round=N_CLIENTS, comm_round=ROUNDS, epochs=1,
                batch_size=4, lr=0.1, frequency_of_the_test=100)

# tag: (port engine, JAX class, cfg overrides, engine kwargs)
CASES = {
    "fedavg": ("fedavg", "MeshFedAvgEngine", {}, {}),
    "fedavg_partial": ("fedavg", "MeshFedAvgEngine",
                       {"client_num_per_round": 10}, {}),
    "fedprox": ("fedprox", "MeshFedProxEngine", {"prox_mu": 0.1}, {}),
    "fedopt": ("fedopt", "MeshFedOptEngine",
               {"server_optimizer": "adam", "server_lr": 0.05}, {}),
    "fednova": ("fednova", "MeshFedNovaEngine", {}, {}),
    "norm_clip": ("robust", "MeshRobustEngine", {"norm_bound": 0.3},
                  {"defense": "norm_clip"}),
    "median": ("robust", "MeshRobustEngine", {}, {"defense": "median"}),
    "krum": ("robust", "MeshRobustEngine", {}, {"defense": "krum"}),
}
EXTRA = {
    # port only: the weak-DP noise is drawn from the port's generator
    "norm_clip_noise": ("robust", None, {"norm_bound": 0.3, "stddev": 0.01},
                        {"defense": "norm_clip"}),
    # the FedAvg case again: a run is the same bits every time
    "fedavg_again": CASES["fedavg"],
}
MH_CFG = {"device": "cpu", "n_blocks": 2}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def run_mesh_cluster(tmp: Path, case: dict, procs: int) -> list:
    """`procs` ranks of the mesh worker on `case`, in one spawned gloo
    cluster (the host channel's port and the rendezvous's above the
    ephemeral range); each rank's JSON line."""
    path = tmp / "case.json"
    path.write_text(json.dumps(case))
    env = {**os.environ, "OMP_NUM_THREADS": "2",
           "PYTHONPATH": str(REPO) + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    env.pop("FEDML_OBS_DIR", None)
    outs = tmh.spawn_cluster(
        [sys.executable, "-m", "fedml_tpu_torch.parallel.mesh_worker",
         str(path)], procs, env=env, timeout_s=240,
        coordinator_port=free_base_port(2), jax_distributed=True)
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def write_inputs(tmp: Path, data, v0: dict) -> dict:
    """The pickled port data and torch.save'd weights a case names."""
    with open(tmp / "data.pkl", "wb") as f:
        pickle.dump(data, f)
    torch.save(v0, tmp / "v0.pt")
    return {"data": str(tmp / "data.pkl"), "weights": str(tmp / "v0.pt"),
            "device": "cpu", "threads": 2, "out": str(tmp)}


def _jax_v0():
    eng = jengine.MeshFedAvgEngine(
        JaxClientTrainer(jax_create_model("lr", 10), lr=0.1),
        _data(jfed, n_clients=N_CLIENTS, hw=HW),
        JaxFedConfig(**BASE_CFG), mesh=make_mesh(1), donate=False, chunk=2)
    return eng.init_variables()


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_ranks")
    jv0 = _jax_v0()
    v0 = flax_to_torch(jax.tree.map(np.asarray, jv0))
    arms = [dict(tag=tag, engine=eng, mesh={"kind": "1d"}, rounds=ROUNDS,
                 cfg=cfg, engine_kw={"chunk": 2, **kw}, save=True)
            for tag, (eng, _, cfg, kw) in {**CASES, **EXTRA}.items()]
    case = {**write_inputs(tmp, _data(tfed, n_clients=N_CLIENTS, hw=HW), v0),
            "model": {"name": "lr", "output_dim": 10,
                      "input_dim": HW * HW * 3},
            "trainer": {"lr": 0.1}, "cfg": BASE_CFG, "arms": arms,
            "mh_worker": {**MH_CFG, "jax_distributed": True}}
    docs = run_mesh_cluster(tmp, case, 2)
    saved = {(tag, r): torch.load(tmp / f"{tag}.rank{r}.pt")
             for tag in case_tags() for r in (0, 1)}
    return dict(docs=docs, saved=saved, jv0=jv0, v0=v0)


def case_tags():
    return list(CASES) + list(EXTRA)


def _bitwise(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _port_engine(name: str, **kw):
    eng, _, cfg, eng_kw = {**CASES, **EXTRA}[name]
    cls = {"fedavg": "MeshFedAvgEngine", "robust": "MeshRobustEngine"}[eng]
    return getattr(tengine, cls)(
        ClientTrainer(create_model("lr", 10, input_dim=HW * HW * 3), lr=0.1),
        _data(tfed, n_clients=N_CLIENTS, hw=HW),
        FedConfig(**{**BASE_CFG, **cfg}), chunk=2, device="cpu",
        **eng_kw, **kw)


@pytest.mark.parametrize("tag", sorted(CASES))
def test_two_ranks_match_jax_mesh_of_two(cluster, tag):
    _, cls, cfg, kw = CASES[tag]
    jeng = getattr(jengine, cls)(
        JaxClientTrainer(jax_create_model("lr", 10), lr=0.1),
        _data(jfed, n_clients=N_CLIENTS, hw=HW),
        JaxFedConfig(**{**BASE_CFG, **cfg}), mesh=make_mesh(2),
        donate=False, chunk=2, **kw)
    want = flax_to_torch(jax.tree.map(np.asarray, jeng.run(
        variables=jax.tree.map(jnp.copy, cluster["jv0"]), rounds=ROUNDS)))
    got = cluster["saved"][tag, 0]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("tag", case_tags())
def test_two_ranks_commit_one_model_bitwise(cluster, tag):
    d0, d1 = (d["arms"][tag] for d in cluster["docs"])
    assert d0["digest"] == d1["digest"]
    _bitwise(cluster["saved"][tag, 0], cluster["saved"][tag, 1])
    assert d0["finite"] and d0["train_loss"] == d1["train_loss"]
    # the exchange went through the host: one P + 2 (P + 3 for FedNova)
    # f32 carry received from the other rank a round
    assert len(d0["gather_walls"]) >= ROUNDS and min(d0["gather_bytes"]) > 0
    assert d0["grid"] == [0, 1] and [d["arms"][tag]["coords"]
                                     for d in cluster["docs"]] == [
        {"clients": 0}, {"clients": 1}]


def test_fedavg_two_ranks_is_one_rank_two_blocks_bitwise(cluster):
    eng = _port_engine("fedavg", streaming=True)
    runner = tmh.MultihostRunner(eng, tmh.MultihostContext.single(),
                                 n_blocks=2)
    want = runner.run(variables=dict(cluster["v0"]), rounds=ROUNDS)
    _bitwise(cluster["saved"]["fedavg", 0], want)


@pytest.mark.parametrize("tag", ["norm_clip", "norm_clip_noise"])
def test_norm_clip_two_ranks_is_one_rank_two_blocks_bitwise(cluster, tag):
    eng = _port_engine(tag, streaming=True)
    runner = tmh.MultihostRunner(eng, tmh.MultihostContext.single(),
                                 n_blocks=2)
    want = runner.run(variables=dict(cluster["v0"]), rounds=ROUNDS)
    _bitwise(cluster["saved"][tag, 0], want)


def test_fold_order_is_fixed_two_runs_one_model(cluster):
    for d in cluster["docs"]:
        assert d["arms"]["fedavg_again"]["digest"] == \
            d["arms"]["fedavg"]["digest"]
    _bitwise(cluster["saved"]["fedavg_again", 0],
             cluster["saved"]["fedavg", 1])


@pytest.mark.parametrize("tag", ["median", "krum"])
def test_order_statistics_are_the_one_card_engine_bitwise(cluster, tag):
    want = _port_engine(tag).run(variables=dict(cluster["v0"]),
                                 rounds=ROUNDS)
    _bitwise(cluster["saved"][tag, 0], want)


def test_mh_worker_jax_distributed_keeps_its_digests(cluster, tmp_path,
                                                     monkeypatch):
    for key in (tmh.ENV_RANK, tmh.ENV_WORLD, tmh.ENV_COORD,
                tmh.ENV_JAX_COORD):
        monkeypatch.delenv(key, raising=False)
    path = tmp_path / "mh.json"
    path.write_text(json.dumps(MH_CFG))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mh_worker.main([str(path)]) == 0
    one = json.loads(buf.getvalue().strip().splitlines()[-1])
    for d in cluster["docs"]:
        assert d["mh_worker"]["world"] == 2
        assert d["mh_worker"]["digests"] == one["digests"]
