"""The mesh variants of the PyTorch port's algorithms over a mesh of two
ranks: make_mesh_fedseg_engine, make_mesh_fedgan_engine, MeshFedGKTEngine,
make_mesh_fednas_engine with make_train_engine(mesh=), and
CentralizedTrainer(mesh=), in ONE spawned 2-rank gloo cluster of the
port's mesh worker (`python -m fedml_tpu_torch.parallel.mesh_worker`).

Each mesh run is held, as tests/test_advanced_algorithms.py:194-330,
tests/test_fednas.py:158 and tests/test_fedavg.py:245 hold the JAX mesh
variants, against the one-device engine at those tests' tolerances (the
port's one-device engine, given the same initial weights; FedGAN and
FedNAS draw z and the GDAS noise from the port's host generators, keyed
on the global lane, so the mesh and the one-device run see the same
draws), and, where the draws allow, against the JAX package's
one-device engine from JAX's init (``convert.flax_to_torch``) at the
tolerance of the port's one-device parity test of that engine.  The two
ranks commit the same bits.

Sizes: FedSeg on SegEncoderDecoder(width 8), 8 clients of 8 16x16
images; FedGAN on the MNIST stand-in, 8 clients, latent 16; FedGKT on
ResNetClientGKT(n_blocks=1) / ResNetServerGKT(n_per_stage=1), 3 clients
on 2 ranks (a zero-mask pad client), at batch 4 and at batch 5 (which the
ranks do not divide: mask-0 samples pad it); the FedNAS search round at
C 4, 1 layer, 8 clients and the DARTS_V2 retrain at C 4, 2 layers;
centralized LR on MNIST (tests/test_fedavg.py:245) and ResNet-20 with
BatchNorm, whose statistics fold over the ranks.
"""
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

from fedml_tpu.algorithms.centralized import CentralizedTrainer as JaxCentral
from fedml_tpu.algorithms.fedgkt import FedGKTEngine as JaxFedGKT
from fedml_tpu.algorithms.fedseg import FedSegEngine as JaxFedSeg
from fedml_tpu.core.trainer import ClientTrainer as JaxClientTrainer
from fedml_tpu.data import federated as jfed
from fedml_tpu.data.loaders import load_data as jax_load_data
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models import resnet_gkt as jgkt
from fedml_tpu.models.segnet import SegEncoderDecoder as JaxSegNet
from fedml_tpu.utils.config import FedConfig as JaxFedConfig
from fedml_tpu_torch.algorithms.centralized import CentralizedTrainer
from fedml_tpu_torch.algorithms.fedgan import FedGANEngine
from fedml_tpu_torch.algorithms.fedgkt import FedGKTEngine
from fedml_tpu_torch.algorithms.fednas import (FedNASSearchEngine,
                                               make_train_engine)
from fedml_tpu_torch.algorithms.fedseg import FedSegEngine
from fedml_tpu_torch.convert import flax_to_torch
from fedml_tpu_torch.core.trainer import ClientTrainer
from fedml_tpu_torch.data import federated as tfed
from fedml_tpu_torch.data.loaders import load_data
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.darts import DARTS_V2
from fedml_tpu_torch.models.gan import Discriminator, Generator
from fedml_tpu_torch.models.norms import BatchNorm
from fedml_tpu_torch.models.resnet_gkt import ResNetClientGKT, ResNetServerGKT
from fedml_tpu_torch.models.segnet import SegEncoderDecoder
from fedml_tpu_torch.parallel import mesh as tmesh
from fedml_tpu_torch.parallel import multihost as tmh
from fedml_tpu_torch.utils.config import FedConfig
from tests.test_torch_transports import free_base_port

REPO = Path(__file__).resolve().parent.parent
MESH_TOL = dict(rtol=2e-4, atol=2e-5)     # test_advanced_algorithms.py:237
GKT_TOL = dict(rtol=2e-3, atol=2e-4)      # test_advanced_algorithms.py:286
GAN_TOL = dict(rtol=0.1, atol=0.01)       # test_advanced_algorithms.py:322
NAS_TOL = dict(rtol=3e-4, atol=3e-5)      # test_fednas.py:190
PORT_JAX_TOL = dict(rtol=1e-3, atol=1e-4)  # test_torch_fedseg/fedgkt parity
SEG = dict(C=8, per=8, hw=16, ncls=3)
GKT_CLIENTS, GKT_HW = 3, 8


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def seg_data(mod):
    """tests/test_advanced_algorithms.py:206-219."""
    rs = np.random.RandomState(0)
    C, n_per, hw = SEG["C"], SEG["per"], SEG["hw"]
    n = C * n_per
    x = rs.rand(n, hw, hw, 3).astype(np.float32)
    y = (x[..., 0] > 0.5).astype(np.int64) + (x[..., 1] > 0.5).astype(
        np.int64)
    idx = {i: np.arange(i * n_per, (i + 1) * n_per) for i in range(C)}
    return mod.FederatedData(
        train_data_num=n, test_data_num=n,
        train_global=mod.build_eval_shard(x, y, 8),
        test_global=mod.build_eval_shard(x, y, 8),
        client_shards=mod.build_client_shards(x, y, idx, 8),
        client_num_samples=np.full(C, n_per, np.float32),
        test_client_shards=None, class_num=SEG["ncls"], synthetic=True)


def gkt_data(mod, bs: int):
    """3 clients of 10, 7 and 5 8x8 images (a ragged last batch)."""
    rs = np.random.RandomState(1)
    sizes = (10, 7, 5)
    n = sum(sizes)
    x = rs.rand(n, GKT_HW, GKT_HW, 3).astype(np.float32)
    y = rs.randint(0, 10, n).astype(np.int64)
    ends = np.cumsum(sizes)
    idx = {i: np.arange(e - s, e) for i, (s, e) in enumerate(zip(sizes, ends))}
    ev = mod.build_eval_shard(x[:8], y[:8], bs)
    return mod.FederatedData(
        train_data_num=n, test_data_num=8, train_global=ev, test_global=ev,
        client_shards=mod.build_client_shards(x, y, idx, bs),
        client_num_samples=np.asarray(sizes, np.float32),
        test_client_shards=None, class_num=10)


def cfg_kw(**kw):
    base = dict(client_num_in_total=8, client_num_per_round=8, comm_round=2,
                epochs=1, batch_size=8, lr=0.05, frequency_of_the_test=100)
    base.update(kw)
    return base


CFG = {
    "fedseg": cfg_kw(),
    "fedgan": cfg_kw(lr=0.01),
    "gkt4": cfg_kw(client_num_in_total=3, client_num_per_round=3,
                   batch_size=4, lr=0.1),
    "gkt5": cfg_kw(client_num_in_total=3, client_num_per_round=3,
                   batch_size=5, lr=0.1),
    "fednas": cfg_kw(comm_round=1, batch_size=4),
    "fednas_train": cfg_kw(comm_round=1, batch_size=4),
    "central_lr": cfg_kw(client_num_in_total=4, client_num_per_round=4,
                         comm_round=4, batch_size=10, lr=0.1),
    "central_bn": cfg_kw(client_num_in_total=4, client_num_per_round=4,
                         comm_round=1, batch_size=8, lr=0.1),
}
ROUNDS = {"fedseg": 2, "fedgan": 2, "gkt4": 2, "gkt5": 2, "fednas": 1,
          "fednas_train": 1, "central_lr": 4, "central_bn": 1}
NAS = dict(C=4, layers=1, steps=2, multiplier=2)


def datasets():
    cifar = lambda bs: load_data("cifar10", client_num_in_total=8,
                                 batch_size=bs, synthetic_scale=0.002, seed=0)
    return {
        "fedseg": seg_data(tfed),
        "fedgan": load_data("mnist", client_num_in_total=8, batch_size=8,
                            synthetic_scale=0.005, seed=0),
        "gkt4": gkt_data(tfed, 4), "gkt5": gkt_data(tfed, 5),
        "fednas": cifar(4), "fednas_train": cifar(4),
        "central_lr": load_data("mnist", client_num_in_total=4,
                                batch_size=10, synthetic_scale=0.01, seed=0),
        "central_bn": load_data("cifar10", client_num_in_total=4,
                                batch_size=8, synthetic_scale=0.0015,
                                seed=0)}


def port_engine(tag: str, data, mesh=None):
    """The one-device engine of a case (mesh None), or its mesh variant."""
    cfg = FedConfig(**CFG[tag])
    if tag == "fedseg":
        tr = ClientTrainer(SegEncoderDecoder(SEG["ncls"], width=8), lr=0.05,
                           has_time_axis=True)
        return FedSegEngine(tr, data, cfg, device="cpu")
    if tag == "fedgan":
        out_dim = int(np.prod(data.client_shards["x"].shape[3:]))
        return FedGANEngine(Generator(latent_dim=16, out_dim=out_dim),
                            Discriminator(), data, cfg, latent_dim=16,
                            device="cpu")
    if tag.startswith("gkt"):
        return FedGKTEngine(ResNetClientGKT(n_blocks=1),
                            ResNetServerGKT(n_per_stage=1), data, cfg,
                            device="cpu")
    if tag == "fednas":
        return FedNASSearchEngine(data, cfg, device="cpu", **NAS)
    if tag == "fednas_train":
        return make_train_engine(DARTS_V2, data, cfg, C=4, layers=2,
                                 device="cpu")
    model = (create_model("lr", 10) if tag == "central_lr"
             else create_model("resnet20", 10))
    return CentralizedTrainer(ClientTrainer(model, lr=0.1), data, cfg,
                              mesh=mesh, device="cpu")


def port_run(tag: str, eng, v0):
    """The one-device run of a case, in the mesh worker's output form."""
    r = ROUNDS[tag]
    if tag == "fedgan":
        return eng.run(rounds=r, params=dict(v0))
    if tag.startswith("gkt"):
        cps, sp = eng.run(rounds=r, params=v0)
        out = {f"client{i}.{k}": v for i, cp in enumerate(cps)
               for k, v in cp.items()}
        return {**out, **{f"server.{k}": v for k, v in sp.items()}}
    if tag == "fednas":
        p, a = eng.run(rounds=r, params=v0[0], alphas=v0[1])
        return {**p, **{f"alpha.{k}": v for k, v in a.items()}}
    if tag.startswith("central"):
        return eng.run(epochs=r, variables=dict(v0))
    return eng.run(variables=dict(v0), rounds=r)


def initial(tag: str, eng):
    if tag == "fedgan":
        return eng.init_params()
    if tag.startswith("gkt"):
        return flax_to_torch(jax.tree.map(np.asarray, jax_gkt(tag)[1]))
    if tag == "fednas":
        return eng.init_state()
    if tag == "fedseg":
        return flax_to_torch(jax.tree.map(np.asarray, jax_seg()[1]))
    if tag == "central_lr":
        return flax_to_torch(jax.tree.map(np.asarray, jax_central()[1]))
    gen = torch.Generator().manual_seed(0)
    return eng.trainer.init(gen, "cpu")


def jax_seg():
    tr = JaxClientTrainer(JaxSegNet(num_classes=SEG["ncls"], width=8),
                          lr=0.05, has_time_axis=True)
    eng = JaxFedSeg(tr, seg_data(jfed), JaxFedConfig(**CFG["fedseg"]),
                    donate=False)
    return eng, eng.init_variables()


def jax_gkt(tag: str):
    bs = CFG[tag]["batch_size"]
    eng = JaxFedGKT(jgkt.ResNetClientGKT(n_blocks=1),
                    jgkt.ResNetServerGKT(n_per_stage=1), gkt_data(jfed, bs),
                    JaxFedConfig(**CFG[tag]))
    return eng, eng.init_params()


def jax_central():
    data = jax_load_data("mnist", client_num_in_total=4, batch_size=10,
                         synthetic_scale=0.01, seed=0)
    tr = JaxCentral(JaxClientTrainer(jax_create_model("lr", 10), lr=0.1),
                    data, JaxFedConfig(**CFG["central_lr"]))
    return tr, tr.trainer.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 784), jnp.float32))


ARMS = {
    "fedseg": dict(engine="fedseg", trainer={"lr": 0.05,
                                             "has_time_axis": True},
                   model={"factory": "fedml_tpu_torch.models.segnet:"
                                     "SegEncoderDecoder",
                          "kw": {"num_classes": SEG["ncls"], "width": 8}}),
    "fedgan": dict(engine="fedgan", gan={"latent_dim": 16, "out_dim": 784}),
    "gkt4": dict(engine="fedgkt"), "gkt5": dict(engine="fedgkt"),
    "fednas": dict(engine="fednas", engine_kw=NAS),
    "fednas_train": dict(engine="fednas_train", genotype="DARTS_V2",
                         engine_kw={"C": 4, "layers": 2}),
    "central_lr": dict(engine="centralized", trainer={"lr": 0.1},
                       model={"name": "lr", "output_dim": 10}),
    "central_bn": dict(engine="centralized", trainer={"lr": 0.1},
                       model={"name": "resnet20", "output_dim": 10}),
}
GKT_MODELS = {"client": {"factory": "fedml_tpu_torch.models.resnet_gkt:"
                                    "ResNetClientGKT", "kw": {"n_blocks": 1}},
              "server": {"factory": "fedml_tpu_torch.models.resnet_gkt:"
                                    "ResNetServerGKT",
                         "kw": {"n_per_stage": 1}}}


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
    tmp = tmp_path_factory.mktemp("mesh_algorithms")
    data = datasets()
    arms, v0s = [], {}
    for tag, arm in ARMS.items():
        eng = port_engine(tag, data[tag])
        v0s[tag] = initial(tag, eng)
        dpath, wpath = tmp / f"{tag}.pkl", tmp / f"{tag}.pt"
        with open(dpath, "wb") as f:
            pickle.dump(data[tag], f)
        torch.save(v0s[tag], wpath)
        arms.append({**arm, "tag": tag, "rounds": ROUNDS[tag], "save": True,
                     "cfg": CFG[tag], "data": str(dpath),
                     "weights": str(wpath), "mesh": {"kind": "1d"},
                     **({"gkt": GKT_MODELS} if tag.startswith("gkt")
                        else {})})
    case = {"data": arms[0]["data"], "device": "cpu", "threads": 2,
            "out": str(tmp), "model": {"name": "lr", "output_dim": 10},
            "cfg": CFG["fedseg"], "arms": arms}
    docs = run_cluster(tmp, case, 2)
    saved = {(tag, r): torch.load(tmp / f"{tag}.rank{r}.pt")
             for tag in ARMS for r in (0, 1)}
    return dict(docs=docs, saved=saved, data=data, v0s=v0s)


def one_device(cluster, tag: str):
    eng = port_engine(tag, cluster["data"][tag])
    return eng, port_run(tag, eng, cluster["v0s"][tag])


def assert_close(got: dict, want: dict, **tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(),
                                   want[k].float().numpy(), err_msg=k, **tol)


@pytest.mark.parametrize("tag", sorted(ARMS))
def test_two_ranks_commit_one_model_bitwise(cluster, tag):
    d0, d1 = (d["arms"][tag] for d in cluster["docs"])
    assert d0["digest"] == d1["digest"] and d0["finite"]
    for k, v in cluster["saved"][tag, 0].items():
        assert torch.equal(v, cluster["saved"][tag, 1][k]), k
    assert d0["gather_bytes"] and min(d0["gather_bytes"]) > 0


def test_mesh_fedseg_matches_one_device_and_jax(cluster):
    eng, want = one_device(cluster, "fedseg")
    got = cluster["saved"]["fedseg", 0]
    assert_close(got, want, **MESH_TOL)
    jeng, jv0 = jax_seg()
    jwant = flax_to_torch(jax.tree.map(np.asarray, jeng.run(
        variables=jv0, rounds=ROUNDS["fedseg"])))
    assert_close(got, jwant, **PORT_JAX_TOL)
    m = cluster["docs"][0]["arms"]["fedseg"]["metrics"][0]
    assert 0.0 <= m["test_mIoU"] <= 1.0 and 0.0 <= m["test_acc"] <= 1.0
    assert cluster["docs"][1]["arms"]["fedseg"]["metrics"] == []


def test_mesh_fedgan_matches_one_device(cluster):
    eng, want = one_device(cluster, "fedgan")
    assert_close(cluster["saved"]["fedgan", 0], want, **GAN_TOL)
    m = cluster["docs"][0]["arms"]["fedgan"]["metrics"][0]
    assert abs(m["d_loss"] - eng.metrics_history[-1]["d_loss"]) < 2e-2
    assert abs(m["g_loss"] - eng.metrics_history[-1]["g_loss"]) < 2e-2


@pytest.mark.parametrize("tag", ["gkt4", "gkt5"])
def test_mesh_fedgkt_matches_one_device_and_jax(cluster, tag):
    eng, want = one_device(cluster, tag)
    got = cluster["saved"][tag, 0]
    # the pad client is sliced off; every real client comes back
    assert {k.split(".")[0] for k in got} == {
        f"client{i}" for i in range(GKT_CLIENTS)} | {"server"}
    assert_close(got, want, **GKT_TOL)
    jeng, _ = jax_gkt(tag)
    j_cps, j_sp = jeng.run(rounds=ROUNDS[tag])
    jwant = {f"client{i}.{k}": v for i, cp in enumerate(
        flax_to_torch(tuple(jax.tree.map(np.asarray, c) for c in j_cps)))
        for k, v in cp.items()}
    jwant.update({f"server.{k}": v for k, v in flax_to_torch(
        jax.tree.map(np.asarray, j_sp)).items()})
    assert_close(got, jwant, **GKT_TOL)
    m = cluster["docs"][0]["arms"][tag]["metrics"][0]
    for key in ("server_loss", "client_loss"):
        assert abs(m[key] - eng.metrics_history[-1][key]) < 1e-2, key


def test_mesh_fednas_search_matches_one_device(cluster):
    eng, want = one_device(cluster, "fednas")
    got = cluster["saved"]["fednas", 0]
    assert_close(got, want, **NAS_TOL)
    m = cluster["docs"][0]["arms"]["fednas"]["metrics"][0]
    assert abs(m["train_loss"] - eng.metrics_history[-1]["train_loss"]) < 1e-3
    alphas = lambda t: {k: got[f"alpha.{k}"] if t else want[f"alpha.{k}"]
                        for k in ("normal", "reduce")}
    assert eng.genotype(alphas(True)) == eng.genotype(alphas(False))


def test_mesh_retrain_engine_matches_one_device(cluster):
    _, want = one_device(cluster, "fednas_train")
    assert_close(cluster["saved"]["fednas_train", 0], want, **MESH_TOL)
    eng = make_train_engine(DARTS_V2, cluster["data"]["fednas_train"],
                            FedConfig(**CFG["fednas_train"]), C=4, layers=2,
                            mesh=tmesh.make_mesh(1), device="cpu")
    assert type(eng).__name__ == "MeshFedAvgEngine" and eng.n_shards == 1


def test_centralized_mesh_matches_one_device_and_jax(cluster):
    eng, want = one_device(cluster, "central_lr")
    got = cluster["saved"]["central_lr", 0]
    assert_close(got, want, **MESH_TOL)
    jtr, jv0 = jax_central()
    jwant = flax_to_torch(jax.tree.map(np.asarray, jtr.run(
        epochs=ROUNDS["central_lr"], variables=jv0)))
    assert_close(got, jwant, **MESH_TOL)
    m = cluster["docs"][0]["arms"]["central_lr"]["metrics"][0]
    assert abs(m["test_acc"] - eng.metrics_history[-1]["test_acc"]) < 1e-6


def test_centralized_mesh_batchnorm_folds_its_statistics(cluster):
    """Every BatchNorm layer of ResNet-20 normalizes by the statistics of
    the batch both ranks hold together: the mesh run is the one-device
    run's, running statistics included."""
    _, want = one_device(cluster, "central_bn")
    got = cluster["saved"]["central_bn", 0]
    assert_close(got, want, rtol=2e-3, atol=2e-4)
    rec = cluster["docs"][0]["arms"]["central_bn"]
    # a step folds twice in every BatchNorm layer (forward, backward) and
    # once for the gradient; the epoch once for the batches' counts
    n_bn = sum(isinstance(m, BatchNorm)
               for m in create_model("resnet20", 10).modules())
    batches = cluster["data"]["central_bn"].train_global["mask"].shape[0]
    assert len(rec["gather_walls"]) == batches * (2 * n_bn + 1) + 1


def test_centralized_mesh_refuses_padded_batchnorm_batches():
    data = load_data("cifar10", client_num_in_total=4, batch_size=8,
                     synthetic_scale=0.0015, seed=0)
    bs = data.train_global["mask"].shape[1]
    assert bs % 3                      # three ranks need a zero-mask pad
    tr = CentralizedTrainer(
        ClientTrainer(create_model("resnet20", 10), lr=0.1), data,
        FedConfig(**CFG["central_bn"]),
        mesh=tmesh.Mesh.layout(("clients",), (3,), 0), device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        tr.run(epochs=1)
