"""The port's client-axis mesh (fedml_tpu_torch/parallel/mesh.py and the
mesh helpers of parallel/multihost.py), in process, against the JAX
package's parallel/mesh.py on the 8 forced CPU devices:

* `pad_cohort` and the engines' `pad_ids` are bitwise JAX's, and the two
  policies stay apart (zero rows against repeats of client 0);
* each rank's row range is the index range JAX's `client_sharding` and
  `stack_leaf_sharding` give device r, on 1-D meshes of 1, 2, 4 and 8
  and on 2 x 2 and 2 x 4 meshes; `client_axes` matches; the hierarchical
  engine's `sample_inner_rounds` is JAX's draws bitwise;
* `make_mesh_batch` lays ranks out as JAX's (clients x batch) grid and
  refuses a grid larger than the world; the mesh helpers behave on a
  single process (the counterpart of tests/test_parallel.py:496), and
  the host layout warns about virtual silos;
* a mesh of one rank is bitwise the one-card engine for FedAvg,
  FedNova, norm_clip and median (ResNet-18-GN at num_filters 4, 2
  rounds), and launches no collective;
* the refusals: MultihostRunner refuses MeshHierarchicalEngine and an
  engine whose mesh reaches another host-channel member's rank, naming
  it; `stream_block` over ranks needs a block that splits over the
  client shards (the two-phase order statistics refuse a mesh of ranks),
  and mh_worker accepts `local_devices` > 1.
"""
import logging

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.core.trainer import ClientTrainer as JaxClientTrainer
from fedml_tpu.data import federated as jfed
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.parallel import MeshHierarchicalEngine as JaxHier
from fedml_tpu.parallel import engine as jengine
from fedml_tpu.parallel import mesh as jmesh
from fedml_tpu.utils.config import FedConfig as JaxFedConfig
from fedml_tpu_torch.core.trainer import ClientTrainer
from fedml_tpu_torch.data import federated as tfed
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.parallel import engine as tengine
from fedml_tpu_torch.parallel import mesh as tmesh
from fedml_tpu_torch.parallel import mh_worker
from fedml_tpu_torch.parallel import multihost as tmh
from fedml_tpu_torch.parallel.gossip import MeshGossipEngine
from fedml_tpu_torch.parallel.hierarchical import MeshHierarchicalEngine
from fedml_tpu_torch.utils.config import FedConfig
from tests.test_torch_stream import _data

N_CLIENTS = 8


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def no_cluster_env(monkeypatch):
    for key in (tmh.ENV_RANK, tmh.ENV_WORLD, tmh.ENV_COORD,
                tmh.ENV_JAX_COORD):
        monkeypatch.delenv(key, raising=False)


# ---------------------------------------------------------------------------
# padding and row ranges against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,multiple", [(5, 4), (8, 4), (1, 8), (10, 8),
                                        (6, 1)])
def test_pad_cohort_and_pad_ids_bitwise_jax(k, multiple):
    rs = np.random.RandomState(k * 10 + multiple)
    cohort = {"x": rs.rand(k, 2, 3, 4).astype(np.float32),
              "y": rs.randint(0, 10, (k, 2, 3)).astype(np.int64),
              "mask": np.ones((k, 2, 3), np.float32)}
    w = rs.rand(k).astype(np.float32)
    got, got_w = tmesh.pad_cohort(cohort, w, multiple)
    want, want_w = jmesh.pad_cohort(cohort, w, multiple)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got_w, want_w)
    ids = rs.permutation(20)[:k]
    for a, b in zip(tengine.pad_ids(ids, multiple),
                    jengine.pad_ids(ids, multiple)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the engines' policy repeats client 0 with weight 0; pad_cohort's
    # rows are zeros
    pad = (-k) % multiple
    if pad:
        assert (tengine.pad_ids(ids, multiple)[0][k:] == 0).all()
        assert (got["mask"][k:] == 0).all()


MESHES = [("1d", (1,)), ("1d", (2,)), ("1d", (4,)), ("1d", (8,)),
          ("2d", (2, 2)), ("2d", (2, 4))]


def _jax_mesh(kind, shape):
    return (jmesh.make_mesh(shape[0]) if kind == "1d"
            else jmesh.make_mesh_2d(*shape))


def _port_layout(kind, shape, rank):
    axes = (("clients",) if kind == "1d" else ("silo", "clients"))
    return tmesh.Mesh.layout(axes, shape, rank)


@pytest.mark.parametrize("kind,shape", MESHES)
def test_row_ranges_are_jax_device_indices(kind, shape):
    jm = _jax_mesh(kind, shape)
    n = int(np.prod(shape))
    K = 3 * n
    leaf = np.zeros((K, 2, 4, 5), np.float32)
    cohort_map = jmesh.client_sharding(jm).devices_indices_map((K,))
    leaf_map = jmesh.stack_leaf_sharding(jm, leaf).devices_indices_map(
        leaf.shape)
    assert tmesh.client_axes(_port_layout(kind, shape, 0)) == \
        jmesh.client_axes(jm)
    for dev in jm.devices.reshape(-1):
        r = dev.id               # rank r sits where JAX's device r does
        pm = _port_layout(kind, shape, r)
        assert pm.shape == dict(jm.shape)
        assert tuple(pm.grid.reshape(-1)) == tuple(
            d.id for d in jm.devices.reshape(-1))
        rows = tmesh.client_sharding(pm).rows(K)
        # as index ranges: JAX writes a whole axis as slice(None)
        assert range(K)[rows] == range(K)[cohort_map[dev][0]]
        assert range(K)[tmesh.stack_leaf_sharding(pm, leaf).rows(K)] == \
            range(K)[leaf_map[dev][0]]
        assert tmesh.replicated_sharding(pm).rows(K) == slice(0, K)
        share = tmesh.shard_cohort(pm, {"x": leaf}, device="cpu")["x"]
        assert torch.equal(share, torch.from_numpy(leaf[rows]))
        assert tmesh.stack_leaf_spec(pm, leaf) == (jmesh.client_axes(jm),)
    if n > 1:
        with pytest.raises(ValueError, match="evenly"):
            tmesh.client_sharding(_port_layout(kind, shape, 0)).rows(K + 1)


def test_mesh_layout_coordinates_and_axis_groups():
    m = tmesh.Mesh.layout(("silo", "clients"), (2, 2), 3)
    assert m.coords == {"silo": 1, "clients": 1} and not m.is_first
    assert m.axis_ranks(("clients",)) == [2, 3]
    assert m.axis_ranks(("silo",)) == [1, 3]
    assert m.axis_ranks(("silo", "clients")) == [0, 1, 2, 3]
    assert m.index(("silo", "clients")) == 3 and m.size == 4
    with pytest.raises(RuntimeError, match="no process group"):
        m.all_gather(np.ones(2), ("clients",))
    with pytest.raises(ValueError, match="not in this mesh"):
        tmesh.Mesh(("clients",), [0, 1], 5)


def test_sample_inner_rounds_bitwise_jax():
    tcfg = FedConfig(client_num_in_total=N_CLIENTS, client_num_per_round=3,
                     epochs=1, batch_size=4, lr=0.1)
    jcfg = JaxFedConfig(client_num_in_total=N_CLIENTS,
                        client_num_per_round=3, epochs=1, batch_size=4,
                        lr=0.1)
    port = MeshHierarchicalEngine(
        ClientTrainer(create_model("lr", 10, input_dim=192), lr=0.1),
        _data(tfed, n_clients=N_CLIENTS), tcfg, group_comm_round=2,
        mesh=tmesh.Mesh.layout(("silo", "clients"), (2, 2), 0),
        device="cpu")
    ref = JaxHier(JaxClientTrainer(jax_create_model("lr", 10), lr=0.1),
                  _data(jfed, n_clients=N_CLIENTS), jcfg, group_comm_round=2,
                  mesh=jmesh.make_mesh_2d(2, 2), donate=False)
    for r in range(4):
        for a, b in zip(port.sample_inner_rounds(r),
                        ref.sample_inner_rounds(r)):
            b = np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape == (2, 2, 4)
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# refusals and the single-process helpers
# ---------------------------------------------------------------------------

def test_make_mesh_batch_refuses_naming_6c_ii():
    # make_mesh_batch is ported: it refuses only a grid the world cannot
    # hold, and a layout's cells are JAX's device order
    with pytest.raises(ValueError, match="2 x 2 grid"):
        tmesh.make_mesh_batch(2, 2)
    one = tmesh.make_mesh_batch(1, 1)
    assert one.axis_names == ("clients", "batch") and one.size == 1
    lay = tmesh.Mesh.layout(("clients", "batch"), (2, 2), 3)
    assert lay.coords == {"clients": 1, "batch": 1}
    assert tmesh.client_sharding(lay).rows(4) == slice(2, 4)
    assert tmesh.batch_sharding(lay).rows(8) == slice(4, 8)
    with pytest.raises(ValueError, match="one process a device"):
        tmesh.make_mesh(2)


def test_mesh_helpers_on_a_single_process(no_cluster_env, caplog):
    tmh.init_multihost()                  # safe on a single process
    assert not torch.distributed.is_initialized()
    g = tmh.make_global_mesh()
    assert g.size == 1 and g.axis_names == ("clients",) and g.is_first
    assert tmh.make_local_mesh().size == 1
    h = tmh.make_hierarchical_host_mesh(silos=1)
    assert h.shape == {"silo": 1, "clients": 1}
    with pytest.raises(ValueError, match="not divisible into 2 silos"):
        tmh.make_hierarchical_host_mesh(silos=2)
    # explicit arguments, or required=True, never degrade silently
    with pytest.raises(RuntimeError, match="initialization failed"):
        tmh.init_multihost(required=True)
    with pytest.raises(RuntimeError, match="initialization failed"):
        tmh.init_multihost(coordinator_address="localhost:1")
    assert not torch.distributed.is_initialized()
    # the host layout: ranks sorted by (machine, rank), a silo per
    # machine by default; one machine holding every silo is warned about
    order, silos = tmh.host_mesh_layout(["b", "a", "b", "a"])
    assert (order, silos) == ([1, 3, 0, 2], 2)
    with caplog.at_level(logging.WARNING,
                         logger="fedml_tpu_torch.parallel.multihost"):
        order, silos = tmh.host_mesh_layout(["a"] * 4, silos=2)
    assert (order, silos) == ([0, 1, 2, 3], 2)
    assert "VIRTUAL silos" in caplog.text


def test_spawn_cluster_exports_the_rendezvous_only_when_asked():
    import sys
    prog = ("import os; print(os.environ.get('FEDML_MH_JAX_COORD'), "
            "os.environ['FEDML_MH_COORD'])")
    outs = tmh.spawn_cluster([sys.executable, "-c", prog], 1, timeout_s=60,
                             coordinator_port=61000, jax_distributed=True)
    assert outs[0].split() == ["localhost:61001", "localhost:61000"]
    outs = tmh.spawn_cluster([sys.executable, "-c", prog], 1, timeout_s=60,
                             coordinator_port=61000)
    assert outs[0].split()[0] == "None"


def _engine(cls, mesh=None, n=N_CLIENTS, **kw):
    fields = {"norm_bound", "stddev", "client_num_per_round"}
    cfg_kw = {k: kw.pop(k) for k in list(kw) if k in fields}
    cfg = FedConfig(**{**dict(client_num_in_total=n, client_num_per_round=n,
                              epochs=1, batch_size=4, lr=0.1,
                              frequency_of_the_test=100), **cfg_kw})
    return getattr(tengine, cls)(
        ClientTrainer(create_model("resnet18_gn", 10, num_filters=4),
                      lr=0.1), _data(tfed, n_clients=n, per=6), cfg,
        chunk=2, device="cpu", mesh=mesh, **kw)


MESH_OF_ONE = {
    "fedavg": ("MeshFedAvgEngine", {}),
    "fednova": ("MeshFedNovaEngine", {}),
    "norm_clip": ("MeshRobustEngine", {"defense": "norm_clip",
                                       "norm_bound": 0.3, "stddev": 0.01}),
    "median": ("MeshRobustEngine", {"defense": "median"}),
}


@pytest.mark.parametrize("name", sorted(MESH_OF_ONE))
def test_mesh_of_one_rank_is_the_one_card_engine_bitwise(name):
    cls, kw = MESH_OF_ONE[name]
    ref = _engine(cls, n=4, **kw)
    v0 = ref.init_variables()
    want = ref.run(variables=dict(v0), rounds=2)
    eng = _engine(cls, mesh=tmesh.make_mesh(1), n=4, **kw)
    assert eng.n_shards == 1
    got = eng.run(variables=dict(v0), rounds=2)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert eng.exchange.walls == [] and not torch.distributed.is_initialized()


def test_what_waits_for_6c_ii_and_the_runner_refuse_by_name():
    two = tmesh.Mesh.layout(("clients",), (2,), 0)
    # stream_block over ranks: a block splits evenly over the shards
    with pytest.raises(ValueError, match="multiple of the mesh's client"):
        _engine("MeshFedAvgEngine", mesh=two, stream_block=3)
    blk = _engine("MeshFedAvgEngine", mesh=tmesh.Mesh.layout(
        ("clients",), (2,), 1), stream_block=4)
    assert blk._rank_spans([(0, 4), (4, 8)]) == [(2, 4), (6, 8)]
    with pytest.raises(ValueError, match="two-phase order statistics"):
        _engine("MeshRobustEngine", mesh=two, defense="median",
                stream_block=2)
    eng = _engine("MeshFedAvgEngine", mesh=two)
    assert eng.n_shards == 2 and eng.shard.rows(8) == slice(0, 4)
    with pytest.raises(ValueError, match="make_local_mesh"):
        tmh.MultihostRunner(eng, tmh.MultihostContext.single())
    with pytest.raises(ValueError, match="divide evenly over the mesh"):
        _engine("MeshRobustEngine", mesh=tmesh.Mesh.layout(
            ("clients",), (3,), 0), defense="median")
    hier = MeshHierarchicalEngine(
        ClientTrainer(create_model("lr", 10, input_dim=192), lr=0.1),
        _data(tfed, n_clients=4), FedConfig(client_num_in_total=4,
                                            client_num_per_round=4),
        mesh=tmesh.make_mesh_2d(1, 1), device="cpu")
    with pytest.raises(ValueError, match="MeshHierarchicalEngine"):
        tmh.MultihostRunner(hier, tmh.MultihostContext.single())
    with pytest.raises(ValueError, match="silo, clients"):
        MeshHierarchicalEngine(hier.trainer, hier.data, hier.cfg,
                               mesh=tmesh.make_mesh(1), device="cpu")
    with pytest.raises(ValueError, match="1-D"):
        MeshGossipEngine(hier.trainer, hier.data, hier.cfg,
                         mesh=tmesh.make_mesh_2d(1, 1), device="cpu")
    base = {**mh_worker.DEFAULTS}
    mh_worker.check_config({**base, "jax_distributed": True})
    mh_worker.check_config({**base, "local_devices": 2})
    # the runner refuses a mesh reaching another member's rank, by name
    with pytest.raises(ValueError, match="belongs to host-channel member 1"):
        tmh.MultihostRunner(eng, tmh.MultihostContext.single())
