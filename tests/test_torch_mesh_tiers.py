"""The port's two-tier and ring engines over a mesh of four ranks
(fedml_tpu_torch/parallel/hierarchical.py::MeshHierarchicalEngine and
gossip.py::MeshGossipEngine), in ONE spawned 4-rank gloo cluster of the
port's mesh worker that runs every case, against the JAX package's
engines on the 8 forced CPU devices and against the port's own runs.

LR on 8x8x3, 16 clients of uneven shards, from JAX's init:

* MeshHierarchicalEngine on a 2 x 2 (silo, clients) mesh, 4 of each
  silo's 8 clients sampled per inner round, 2 inner rounds, 2 global
  rounds; and at full participation with one inner round: both against
  JAX's engine on `make_mesh_2d(2, 2)` at rtol 5e-4 / atol 5e-5 (the
  tolerance of tests/test_parallel.py:93-95), and the one-inner-round
  run against the flat MeshFedAvgEngine on a 1-D mesh of 4 at the same
  tolerance (grouping invariance);
* `make_hierarchical_host_mesh(silos=2)` across the four processes
  groups the silos as JAX's device grid (ranks 0-1 and 2-3, one machine
  holding both silos, which it warns about) and commits the
  `make_mesh_2d(2, 2)` run's bits (the counterpart of
  tests/multihost_case.py::build_hier_case);
* MeshGossipEngine on a ring of 4, 2 rounds: against JAX's on
  `make_mesh(4)` at rtol 1e-5 / atol 1e-6 (f32), and bitwise the port's
  ring of one rank;
* every rank commits the same bits in every case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core.trainer import ClientTrainer as JaxClientTrainer
from fedml_tpu.data import federated as jfed
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.parallel import MeshGossipEngine as JaxGossip
from fedml_tpu.parallel import MeshHierarchicalEngine as JaxHier
from fedml_tpu.parallel.mesh import make_mesh, make_mesh_2d
from fedml_tpu.utils.config import FedConfig as JaxFedConfig
from fedml_tpu_torch.convert import flax_to_torch
from fedml_tpu_torch.core.trainer import ClientTrainer
from fedml_tpu_torch.data import federated as tfed
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.parallel import mesh as tmesh
from fedml_tpu_torch.parallel.gossip import MeshGossipEngine
from fedml_tpu_torch.utils.config import FedConfig
from tests.test_torch_mesh_ranks import (BASE_CFG, HW, N_CLIENTS, _bitwise,
                                         _jax_v0, run_mesh_cluster,
                                         write_inputs)
from tests.test_torch_stream import _data

# tag: (port engine, mesh, cfg overrides, engine kwargs, rounds)
CASES = {
    "hier": ("hierarchical", {"kind": "2d", "n_silos": 2, "per_silo": 2},
             {"client_num_per_round": 4}, {"group_comm_round": 2}, 2),
    "hier_full": ("hierarchical", {"kind": "2d", "n_silos": 2,
                                   "per_silo": 2}, {},
                  {"group_comm_round": 1}, 1),
    "hier_host": ("hierarchical", {"kind": "host", "silos": 2}, {},
                  {"group_comm_round": 1}, 1),
    "flat": ("fedavg", {"kind": "1d"}, {}, {}, 1),
    "gossip": ("gossip", {"kind": "1d"}, {}, {}, 2),
}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_tiers")
    jv0 = _jax_v0()
    v0 = flax_to_torch(jax.tree.map(np.asarray, jv0))
    arms = [dict(tag=tag, engine=eng, mesh=mesh, rounds=rounds, cfg=cfg,
                 engine_kw=({"chunk": 2, **kw} if eng != "gossip" else kw),
                 save=True)
            for tag, (eng, mesh, cfg, kw, rounds) in CASES.items()]
    case = {**write_inputs(tmp, _data(tfed, n_clients=N_CLIENTS, hw=HW), v0),
            "model": {"name": "lr", "output_dim": 10,
                      "input_dim": HW * HW * 3},
            "trainer": {"lr": 0.1}, "cfg": BASE_CFG, "arms": arms}
    docs = run_mesh_cluster(tmp, case, 4)
    saved = {tag: torch.load(tmp / f"{tag}.rank0.pt") for tag in CASES}
    return dict(docs=docs, saved=saved, jv0=jv0, v0=v0)


def _close(got: dict, want: dict, rtol: float, atol: float):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


def _jax_data_cfg(tag):
    return (_data(jfed, n_clients=N_CLIENTS, hw=HW),
            JaxFedConfig(**{**BASE_CFG, **CASES[tag][2]}))


@pytest.mark.parametrize("tag", sorted(CASES))
def test_every_rank_commits_one_model(cluster, tag):
    digests = {d["arms"][tag]["digest"] for d in cluster["docs"]}
    assert len(digests) == 1
    assert all(d["arms"][tag]["finite"] for d in cluster["docs"])


@pytest.mark.parametrize("tag", ["hier", "hier_full"])
def test_hierarchical_2x2_matches_jax(cluster, tag):
    data, cfg = _jax_data_cfg(tag)
    jeng = JaxHier(JaxClientTrainer(jax_create_model("lr", 10), lr=0.1),
                   data, cfg, mesh=make_mesh_2d(2, 2), donate=False, chunk=2,
                   **CASES[tag][3])
    want = flax_to_torch(jax.tree.map(np.asarray, jeng.run(
        variables=jax.tree.map(jnp.copy, cluster["jv0"]),
        rounds=CASES[tag][4])))
    _close(cluster["saved"][tag], want, rtol=5e-4, atol=5e-5)


def test_hierarchical_one_inner_round_is_flat_fedavg(cluster):
    _close(cluster["saved"]["hier_full"], cluster["saved"]["flat"],
           rtol=5e-4, atol=5e-5)
    assert not torch.equal(cluster["saved"]["flat"]["Dense_0.kernel"],
                           cluster["v0"]["Dense_0.kernel"])


def test_host_mesh_groups_silos_as_jax(cluster):
    jax_grid = [[d.id for d in row]
                for row in make_mesh_2d(2, 2).devices.tolist()]
    for d in cluster["docs"]:
        host = d["arms"]["hier_host"]
        assert host["grid"] == jax_grid == d["arms"]["hier_full"]["grid"]
        assert host["coords"] == {"silo": d["rank"] // 2,
                                  "clients": d["rank"] % 2}
        assert host["virtual_silos"]        # one machine holds both silos
        assert host["digest"] == d["arms"]["hier_full"]["digest"]


def test_gossip_ring_of_four_matches_jax(cluster):
    data, cfg = _jax_data_cfg("gossip")
    jeng = JaxGossip(JaxClientTrainer(jax_create_model("lr", 10), lr=0.1),
                     data, cfg, mesh=make_mesh(4), donate=False)
    want = flax_to_torch(jax.tree.map(np.asarray, jeng.run(rounds=2)))
    _close(cluster["saved"]["gossip"], want, rtol=1e-5, atol=1e-6)


def test_gossip_ring_of_four_is_the_ring_of_one_bitwise(cluster):
    eng = MeshGossipEngine(
        ClientTrainer(create_model("lr", 10, input_dim=HW * HW * 3), lr=0.1),
        _data(tfed, n_clients=N_CLIENTS, hw=HW), FedConfig(**BASE_CFG),
        mesh=tmesh.make_mesh(1), device="cpu")
    rows = eng.run(rounds=2, variables=dict(cluster["v0"]))
    assert rows.shape[0] == N_CLIENTS
    _bitwise(eng.worker_variables(rows), cluster["saved"]["gossip"])
