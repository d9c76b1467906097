"""The batch axis across ranks in the PyTorch port (make_mesh_batch,
ClientTrainer(batch_axes=), the mesh engines over a (clients x batch)
mesh, sync_batch_norm(sync=True)) against the JAX package.

One spawned 4-rank gloo cluster of the port's mesh worker runs every
engine case of tests/test_batch_axis.py on ``make_mesh_batch(2, 2)``
(FedProx on ``(1, 4)``), LR on MNIST stand-ins with the hetero partition
(ragged clients: some batch shards are all padding), weights from JAX's
init through ``convert.flax_to_torch``.  Each is held against the JAX
engine on ``make_mesh_batch(2, 4)`` of the 8 forced CPU devices at JAX's
own tolerances: rtol 2e-4 / atol 2e-5, and 5e-4 / 5e-5 for the
synchronized BatchNorm.  Port against port: a batch axis of one rank
(``make_mesh_batch(4, 1)``) commits the client mesh's bits, and every
rank of the cluster commits one digest for every case.

In process: the refusals (order statistics and plain BatchNorm under a
batch axis, a batch axis that does not divide the batch), the mesh's
layout and stack sharding, how the per-step fold rounds a bf16 gradient
(the f32 fold rounded once: what JAX's CPU psum of bf16 does on 2 and 4
shards), and tests/test_norms.py's two cases with the ranks simulated by
threads.
"""
import json
import os
import pickle
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from fedml_tpu.core.trainer import ClientTrainer as JaxClientTrainer
from fedml_tpu.data.loaders import load_data as jax_load_data
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.parallel import engine as jengine
from fedml_tpu.parallel.mesh import make_mesh_batch as jax_make_mesh_batch
from fedml_tpu.utils.config import FedConfig as JaxFedConfig
from fedml_tpu_torch.convert import flax_to_torch
from fedml_tpu_torch.core.trainer import ClientTrainer
from fedml_tpu_torch.data.loaders import load_data
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.layers import Dense
from fedml_tpu_torch.models.norms import BatchNorm, sync_batch_norm
from fedml_tpu_torch.parallel import engine as tengine
from fedml_tpu_torch.parallel import mesh as tmesh
from fedml_tpu_torch.parallel import multihost as tmh
from fedml_tpu_torch.utils import axes as mesh_axes
from fedml_tpu_torch.utils.config import FedConfig
from tests.test_torch_transports import free_base_port

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-4, atol=2e-5)           # tests/test_batch_axis.py:50
SYNC_BN_TOL = dict(rtol=5e-4, atol=5e-5)   # tests/test_batch_axis.py:196


def base_cfg(**kw):
    """tests/test_batch_axis.py::_cfg."""
    base = dict(model="lr", dataset="mnist", client_num_in_total=8,
                client_num_per_round=8, comm_round=3, epochs=2,
                batch_size=16, lr=0.1, partition_method="hetero",
                frequency_of_the_test=100)
    base.update(kw)
    return base


def mnist(load, n_clients: int):
    return load("mnist", client_num_in_total=n_clients, batch_size=16,
                synthetic_scale=0.02, partition_method="hetero", seed=0)


class BNNet(nn.Module):
    """tests/test_batch_axis.py's BNNet: Dense(16), BatchNorm bound to the
    "batch" axis (synchronized or not), ReLU, Dense(10)."""

    def __init__(self, sync: bool = False, in_features: int = 784):
        super().__init__()
        self.Dense_0 = Dense(in_features, 16)
        self.BatchNorm_0 = sync_batch_norm(16, sync=sync, axis_name="batch")
        self.Dense_1 = Dense(16, 10)

    def forward(self, x, train: bool = False, rng=None):
        h = self.Dense_0(x.reshape(x.shape[0], -1))
        return self.Dense_1(torch.relu(self.BatchNorm_0(h, train=train)))


def jax_bnnet(sync: bool):
    import flax.linen as fnn

    from fedml_tpu.models.norms import sync_batch_norm as jax_sync_bn

    class Net(fnn.Module):
        @fnn.compact
        def __call__(self, x, train=False):
            h = fnn.Dense(16)(x.reshape((x.shape[0], -1)))
            h = jax_sync_bn(use_running_average=not train, sync=sync,
                            axis_name="batch")(h)
            return fnn.Dense(10)(fnn.relu(h))

    return Net()


# tag: (port engine, JAX class, mesh (n_clients, n_batch), rounds, clients,
#       cfg overrides, trainer kwargs, engine kwargs)
CASES = {
    "plain": ("fedavg", "MeshFedAvgEngine", (2, 2), 3, 8, {}, {}, {}),
    "momentum": ("fedavg", "MeshFedAvgEngine", (2, 2), 2, 6,
                 {"client_num_in_total": 6, "client_num_per_round": 6},
                 {"momentum": 0.9}, {}),
    "streaming": ("fedavg", "MeshFedAvgEngine", (2, 2), 2, 8,
                  {"client_num_per_round": 4}, {}, {"streaming": True}),
    "fedopt": ("fedopt", "MeshFedOptEngine", (2, 2), 2, 8,
               {"server_optimizer": "adam", "server_lr": 0.05},
               {"prox_mu": 0.1}, {}),
    "fedprox": ("fedprox", "MeshFedProxEngine", (1, 4), 2, 8,
                {"prox_mu": 0.1}, {"prox_mu": 0.1}, {}),
    "fednova": ("fednova", "MeshFedNovaEngine", (2, 2), 2, 8, {}, {}, {}),
    "norm_clip": ("robust", "MeshRobustEngine", (2, 2), 2, 8,
                  {"norm_bound": 0.5, "stddev": 0.0}, {},
                  {"defense": "norm_clip"}),
    "sync_bn": ("fedavg", "MeshFedAvgEngine", (2, 2), 2, 8, {"epochs": 1},
                {}, {"allow_batch_stats": True}),
}
# port only: a batch axis of one rank against the client mesh of four
EXTRA = {
    "batch_of_one": ("fedavg", None, (4, 1), 2, 8, {}, {}, {}),
    "client_mesh": ("fedavg", None, None, 2, 8, {}, {}, {}),
}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def jax_init(model, n_clients: int):
    eng = jengine.MeshFedAvgEngine(
        JaxClientTrainer(model, lr=0.1), mnist(jax_load_data, n_clients),
        JaxFedConfig(**base_cfg(client_num_in_total=n_clients,
                                client_num_per_round=n_clients)),
        mesh=jax_make_mesh_batch(8, 1), donate=False)
    return eng.init_variables()


def run_cluster(tmp: Path, case: dict, procs: int) -> list:
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


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("batch_axis")
    inits = {"lr8": jax_init(jax_create_model("lr", 10), 8),
             "lr6": jax_init(jax_create_model("lr", 10), 6),
             "bn": jax_init(jax_bnnet(True), 8)}
    paths = {}
    for n in (8, 6):
        paths[f"data{n}"] = str(tmp / f"data{n}.pkl")
        with open(paths[f"data{n}"], "wb") as f:
            pickle.dump(mnist(load_data, n), f)
    for key, jv in inits.items():
        paths[key] = str(tmp / f"{key}.pt")
        torch.save(flax_to_torch(jax.tree.map(np.asarray, jv)), paths[key])
    arms = []
    for tag, (eng, _, mesh, rounds, n, cfg, tr, kw) in {**CASES,
                                                         **EXTRA}.items():
        arm = dict(tag=tag, engine=eng, rounds=rounds, save=True,
                   cfg=base_cfg(**cfg), trainer={"lr": 0.1, **tr},
                   engine_kw={"chunk": 2, **kw}, data=paths[f"data{n}"],
                   weights=paths["bn" if tag == "sync_bn" else f"lr{n}"],
                   mesh={"kind": "1d"} if mesh is None else
                   {"kind": "batch", "n_clients": mesh[0],
                    "n_batch": mesh[1]})
        if tag == "sync_bn":
            arm["model"] = {"factory": "tests.test_torch_batch_axis:BNNet",
                            "kw": {"sync": True}}
        arms.append(arm)
    case = {"data": paths["data8"], "device": "cpu", "threads": 2,
            "out": str(tmp), "model": {"name": "lr", "output_dim": 10},
            "cfg": base_cfg(), "arms": arms}
    docs = run_cluster(tmp, case, 4)
    saved = {(tag, r): torch.load(tmp / f"{tag}.rank{r}.pt")
             for tag in {**CASES, **EXTRA} for r in range(4)}
    return dict(docs=docs, saved=saved, inits=inits)


@pytest.mark.parametrize("tag", sorted(CASES))
def test_batch_axis_matches_jax_mesh_batch(cluster, tag):
    _, cls, mesh, rounds, n, cfg, tr, kw = CASES[tag]
    model = jax_bnnet(True) if tag == "sync_bn" else jax_create_model(
        "lr", 10)
    jeng = getattr(jengine, cls)(
        JaxClientTrainer(model, lr=0.1, **tr), mnist(jax_load_data, n),
        JaxFedConfig(**base_cfg(**cfg)), mesh=jax_make_mesh_batch(2, 4),
        donate=False, chunk=2, **kw)
    assert jeng.batch_axes == ("batch",)
    init = cluster["inits"]["bn" if tag == "sync_bn" else f"lr{n}"]
    want = flax_to_torch(jax.tree.map(np.asarray, jeng.run(
        variables=jax.tree.map(jnp.copy, init), rounds=rounds)))
    got = cluster["saved"][tag, 0]
    assert sorted(got) == sorted(want)
    tol = SYNC_BN_TOL if tag == "sync_bn" else TOL
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **tol)


@pytest.mark.parametrize("tag", sorted({**CASES, **EXTRA}))
def test_every_rank_commits_one_digest(cluster, tag):
    recs = [d["arms"][tag] for d in cluster["docs"]]
    assert len({r["digest"] for r in recs}) == 1
    assert all(r["finite"] for r in recs)
    for r in range(1, 4):
        for k, v in cluster["saved"][tag, 0].items():
            assert torch.equal(v, cluster["saved"][tag, r][k]), (r, k)
    mesh = CASES.get(tag, EXTRA.get(tag))[2]
    if mesh is not None and mesh[1] > 1:
        # one fold of [gradient | loss] a step over the batch group: LR's
        # 7,850 parameters (padded to 7,936) and the loss, in f32
        assert recs[0]["batch_fold_bytes"] and recs[0]["batch_fold_walls"]


def test_batch_axis_of_one_is_the_client_mesh_bitwise(cluster):
    docs = cluster["docs"]
    assert {d["arms"]["batch_of_one"]["digest"] for d in docs} == \
        {d["arms"]["client_mesh"]["digest"] for d in docs}
    assert docs[0]["arms"]["batch_of_one"]["batch_fold_bytes"] == []
    assert [d["arms"]["plain"]["grid"] for d in docs][0] == [[0, 1], [2, 3]]


# ---------------------------------------------------------------------------
# in process: refusals, layout, the fold's rounding, sync BatchNorm
# ---------------------------------------------------------------------------

def _port(model=None, n=8, **cfg):
    data = mnist(load_data, n)
    return (ClientTrainer(model or create_model("lr", 10), lr=0.1), data,
            FedConfig(**base_cfg(client_num_in_total=n,
                                 client_num_per_round=n, **cfg)))


def test_order_statistics_refuse_a_batch_axis_and_norm_clip_does_not():
    trainer, data, cfg = _port(norm_bound=0.5)
    mesh = tmesh.Mesh.layout(("clients", "batch"), (2, 2), 0)
    eng = tengine.MeshRobustEngine(trainer, data, cfg, defense="norm_clip",
                                   mesh=mesh, device="cpu")
    assert eng.batch_axes == ("batch",) and eng.n_shards == 2
    assert eng.trainer.batch_axes == ("batch",) and not trainer.batch_axes
    with pytest.raises(ValueError, match="batch"):
        tengine.MeshRobustEngine(trainer, data, cfg, defense="median",
                                 mesh=mesh, device="cpu")


def test_plain_batchnorm_under_a_batch_axis_is_refused():
    trainer, data, cfg = _port(BNNet(sync=False), epochs=1)
    eng = tengine.MeshFedAvgEngine(
        trainer, data, cfg, mesh=tmesh.Mesh.layout(("clients", "batch"),
                                                   (2, 2), 0), device="cpu")
    with pytest.raises(ValueError, match="batch_stats"):
        eng.run(rounds=1)


def test_batch_axis_indivisible_raises():
    trainer, data, cfg = _port()
    with pytest.raises(ValueError, match="divide"):
        tengine.MeshFedAvgEngine(trainer, data, cfg, mesh=tmesh.Mesh.layout(
            ("clients", "batch"), (2, 3), 0), device="cpu")


def test_mesh_batch_layout_and_stack_sharding():
    stack = {"x": np.arange(4 * 2 * 8 * 3).reshape(4, 2, 8, 3),
             "mask": np.ones((4, 2, 8)), "w": np.arange(4.0)}
    for rank in range(4):
        mesh = tmesh.Mesh.layout(("clients", "batch"), (2, 2), rank)
        c, b = divmod(rank, 2)
        assert mesh.coords == {"clients": c, "batch": b}
        assert mesh.axis_ranks(("batch",)) == [2 * c, 2 * c + 1]
        assert tmesh.client_axes(mesh) == ("clients",)
        assert tmesh.stack_leaf_spec(mesh, stack["x"]) == (
            ("clients",), None, "batch")
        assert tmesh.stack_leaf_spec(mesh, stack["w"]) == (("clients",),)
        got = tmesh.shard_stack(mesh, stack, device="cpu")
        np.testing.assert_array_equal(
            got["x"].numpy(), stack["x"][2 * c:2 * c + 2, :, 4 * b:4 * b + 4])
        np.testing.assert_array_equal(got["w"].numpy(),
                                      stack["w"][2 * c:2 * c + 2])
    with pytest.raises(ValueError, match="4 x 2 grid"):
        tmesh.make_mesh_batch(4, 2)


class FakeEnv:
    """A bound environment whose fold folds given per-rank parts: the
    first part is this rank's."""

    def __init__(self, parts):
        self.parts = parts

    def size(self, axes):
        return len(self.parts)

    def fold(self, array, axes):
        parts = [np.asarray(array, np.float32)] + [
            np.asarray(p, np.float32) for p in self.parts[1:]]
        return tmh.fold_block_partials(dict(enumerate(parts)), len(parts))


@pytest.mark.parametrize("n", [2, 4])
def test_bf16_gradient_fold_rounds_as_jax_psum(n):
    """The per-step fold sums bf16 gradients in f32, left in mesh order,
    and rounds once to bf16: bitwise what JAX's CPU psum of bf16 gives on
    2 and 4 shards (a bf16 running sum differs on 4)."""
    from jax.sharding import Mesh, PartitionSpec as P

    rs = np.random.RandomState(n)
    x = (rs.randn(n, 4096) * np.exp(rs.randn(n, 4096) * 3)).astype(
        np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    mesh = Mesh(np.array(jax.devices()[:n]), ("batch",))
    psum = jax.jit(jax.shard_map(lambda a: jax.lax.psum(a, "batch"),
                                 mesh=mesh, in_specs=P("batch"),
                                 out_specs=P()))
    want = np.asarray(psum(xb).astype(jnp.float32)).reshape(-1)
    parts = [torch.from_numpy(np.array(xb[i].astype(jnp.float32))).to(
        torch.bfloat16) for i in range(n)]
    trainer = ClientTrainer(create_model("lr", 10), batch_axes=("batch",))
    env = FakeEnv([torch.cat([p.float(), torch.zeros(1)]).numpy()
                   for p in parts])
    g, loss, _ = trainer._fold_step(env, parts[0], torch.zeros(()), None)
    assert g.dtype == torch.bfloat16
    np.testing.assert_array_equal(g.float().numpy(), want)


class ThreadRanks:
    """`n` ranks of one mesh axis simulated by threads: each rank's
    exchange all-gathers through a barrier (in-process stand-in for the
    gloo group, for the BatchNorm statistics fold)."""

    def __init__(self, n: int, axis: str):
        self.n, self.axis = n, axis
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n

    def exchange(self, rank: int):
        ranks = self

        class Exchange:
            mesh = tmesh.Mesh.layout((ranks.axis,), (ranks.n,), rank)

            def fold(self, array, axes):
                ranks.slots[rank] = np.array(array, np.float32)
                ranks.barrier.wait()
                parts = list(ranks.slots)
                ranks.barrier.wait()
                return tmh.fold_block_partials(dict(enumerate(parts)),
                                               ranks.n)

        return Exchange()

    def run(self, fn):
        out, errs = [None] * self.n, []

        def body(r):
            try:
                with mesh_axes.bound(self.exchange(r)):
                    out[r] = fn(r)
            except Exception as e:        # re-raised below
                errs.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        return out


def test_sync_bn_uses_global_stats():
    """tests/test_norms.py::test_sync_bn_uses_global_stats: 8 ranks of 4
    rows each, statistics folded over "clients" (the default axis): the
    output has the GLOBAL batch's mean 0 and std 1, which per-rank
    BatchNorm on these differently distributed shards cannot give; the
    backward's dx is the unsplit batch's."""
    x = np.random.RandomState(0).rand(32, 6).astype(np.float32)
    x[16:] *= 3.0
    dy = np.random.RandomState(1).randn(32, 6).astype(np.float32)

    def rank(r):
        bn = sync_batch_norm(6)
        xr = torch.tensor(x[4 * r:4 * r + 4], requires_grad=True)
        y = bn(xr, train=True)
        (y * torch.tensor(dy[4 * r:4 * r + 4])).sum().backward()
        return y.detach(), xr.grad

    outs = ThreadRanks(8, "clients").run(rank)
    out = torch.cat([o[0] for o in outs]).numpy()
    assert np.abs(out.mean(0)).max() < 1e-4
    assert np.abs(out.std(0) - 1).max() < 1e-2
    whole = BatchNorm(6)
    xw = torch.tensor(x, requires_grad=True)
    yw = whole(xw, train=True)
    (yw * torch.tensor(dy)).sum().backward()
    np.testing.assert_allclose(out, yw.detach().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(torch.cat([o[1] for o in outs]).numpy(),
                               xw.grad.numpy(), rtol=1e-4, atol=1e-5)


def test_sync_and_plain_share_param_tree():
    """tests/test_norms.py::test_sync_and_plain_share_param_tree, and the
    unbound axis raises as flax's does at trace time."""
    shapes = lambda m: [(k, tuple(v.shape)) for k, v in m.state_dict().items()]
    assert shapes(sync_batch_norm(6, sync=True)) == \
        shapes(sync_batch_norm(6, sync=False))
    assert sync_batch_norm(6).axis_name == "clients"
    with pytest.raises(NameError, match="unbound axis name"):
        sync_batch_norm(6)(torch.zeros(4, 6), train=True)


def test_batch_shards_draw_their_own_augmentation_and_dropout():
    """JAX folds the batch axis index into a split client's key
    (trainer.py:244-253); the port keys the client's host generator on
    (seed, round, lane, batch shard), and an unsplit client keeps its
    (seed, round, lane) key."""
    from fedml_tpu_torch.core.trainer import client_generator
    draw = lambda *shard: torch.rand(8, generator=client_generator(  # noqa
        3, 1, 5, "cpu", *shard))
    assert not torch.equal(draw(0), draw(1))
    assert not torch.equal(draw(0), draw())
    assert torch.equal(draw(), draw(None)) and torch.equal(draw(1), draw(1))
