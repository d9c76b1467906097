"""The FedAvg slice of the PyTorch port against the JAX package: sampler,
shards and cohorts (bitwise), the chunked engine over two rounds, the
FedAvg = centralized-GD oracle, and the package's import boundary.

Engine parity runs full ResNet-18-GN depth at num_filters=4 on 8x8
images, 5 clients of unequal size, 3 sampled per round, chunk 2 (so the
zero-weight pad lane is on the path).  Tolerances: f32 rounds agree to
atol 1e-4 / rtol 1e-3 per leaf (f32 sums of 20 conv and GroupNorm layers
in another order, compounded over the SGD steps of two rounds); bf16
local masters are held to the distance bf16 rounding itself puts between
JAX's bf16 and f32 rounds (within 2x, L2 over the model).
"""
import ast
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgEngine as JaxFedAvgEngine
from fedml_tpu.core.sampling import ClientSampler as JaxSampler
from fedml_tpu.core.trainer import ClientTrainer as JaxClientTrainer
from fedml_tpu.data import federated as jfed
from fedml_tpu.models.resnet_gn import ResNet18GN as JaxResNet18GN
from fedml_tpu.parallel.engine import MeshFedAvgEngine as JaxMeshEngine
from fedml_tpu.parallel.engine import pad_and_chunk as jax_pad_and_chunk
from fedml_tpu.parallel.mesh import make_mesh
from fedml_tpu.utils.config import FedConfig as JaxFedConfig
from fedml_tpu_torch.algorithms.fedavg import FedAvgEngine
from fedml_tpu_torch.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.core.sampling import ClientSampler
from fedml_tpu_torch.core.trainer import ClientTrainer
from fedml_tpu_torch.data import federated as tfed
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.parallel.engine import MeshFedAvgEngine, pad_and_chunk
from fedml_tpu_torch.utils.config import FedConfig

REPO = Path(__file__).resolve().parent.parent
NF, HW, BS = 4, 8, 4
SIZES = (8, 5, 3, 7, 6)          # unequal clients: ragged last batches


def _raw(seed=0, n=sum(SIZES)):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, HW, HW, 3).astype(np.float32),
            rs.randint(0, 10, n).astype(np.int64))


def _idx_map(sizes=SIZES):
    ends = np.cumsum(sizes)
    return {i: np.arange(e - s, e) for i, (s, e) in enumerate(zip(sizes, ends))}


def _data(mod, seed=0, test_clients=False):
    """FederatedData of either package from the same numpy arrays."""
    x, y = _raw(seed)
    shards = mod.build_client_shards(x, y, _idx_map(), BS)
    test = (mod.build_client_shards(x[::-1].copy(), y[::-1].copy(),
                                    _idx_map(), BS) if test_clients else None)
    ev = mod.build_eval_shard(x[:10], y[:10], BS)
    return mod.FederatedData(
        train_data_num=len(x), test_data_num=10, train_global=ev,
        test_global=ev, client_shards=shards,
        client_num_samples=np.asarray(SIZES, np.float32),
        test_client_shards=test, class_num=10)


def _cfg(cls, **kw):
    base = dict(model="resnet18_gn", dataset="cifar10", client_num_in_total=5,
                client_num_per_round=3, comm_round=2, epochs=1, batch_size=BS,
                lr=0.1, frequency_of_the_test=100)
    return cls(**{**base, **kw})


# ---------------------------------------------------------------------------
# host side: bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(10, 4), (100, 10), (5, 8), (7, 7)])
def test_sampler_matches_jax_bitwise(n, k):
    ours, ref = ClientSampler(n, k), JaxSampler(n, k)
    for r in range(4):
        a = ours.sample(r)
        after_ours = np.random.get_state()[1].copy()
        b = ref.sample(r)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.int64
        # sample() reseeds the global numpy RNG exactly as the reference
        np.testing.assert_array_equal(after_ours, np.random.get_state()[1])
        np.testing.assert_array_equal(ours.sample_fast(r), ref.sample_fast(r))
        np.testing.assert_array_equal(ours.sample_fast(r, k=3),
                                      ref.sample_fast(r, k=3))


def test_sampler_for_data_uses_the_datas_client_count():
    data = _data(tfed)
    s = ClientSampler.for_data(data, _cfg(FedConfig, client_num_in_total=99))
    assert (s.client_num_in_total, s.client_num_per_round) == (5, 3)


@pytest.mark.parametrize("shuffle_seed,max_batches", [(None, None), (3, None),
                                                      (None, 1), (5, 2)])
def test_client_shards_match_jax_bitwise(shuffle_seed, max_batches):
    x, y = _raw(1)
    a = tfed.build_client_shards(x, y, _idx_map(), BS, max_batches=max_batches,
                                 shuffle_seed=shuffle_seed)
    b = jfed.build_client_shards(x, y, _idx_map(), BS, max_batches=max_batches,
                                 shuffle_seed=shuffle_seed)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("n,n_batches", [(9, None), (8, None), (3, 4)])
def test_pad_and_eval_shards_match_jax_bitwise(n, n_batches):
    x, y = _raw(2, n)
    for a, b in zip(tfed.pad_to_batches(x, y, BS, n_batches),
                    jfed.pad_to_batches(x, y, BS, n_batches)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    a, b = tfed.build_eval_shard(x, y, BS), jfed.build_eval_shard(x, y, BS)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])


def test_cohort_and_device_shards_match_jax_bitwise():
    ours, ref = _data(tfed), _data(jfed)
    ids = np.array([3, 0, 4], np.int64)
    (tc, tw), (jc, jw) = ours.cohort(ids, "cpu"), ref.cohort(ids)
    for k in jc:
        assert tc[k].device.type == "cpu"
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert ours.device_shards("cpu")[0] is ours.device_shards("cpu")[0]


def test_config_is_a_copy_of_the_jax_config():
    ours = {f.name: f.default for f in dataclasses.fields(FedConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxFedConfig)}
    assert ours == ref


@pytest.mark.parametrize("k,cap", [(3, 2), (12, 8), (8, 2), (5, 8)])
def test_pad_and_chunk_matches_jax(k, cap):
    rs = np.random.RandomState(k)
    cohort = {"x": rs.rand(k, 2, 3).astype(np.float32)}
    w = rs.rand(k).astype(np.float32)
    tc, tw = pad_and_chunk({"x": torch.tensor(cohort["x"])}, torch.tensor(w), cap)
    jc, jw, _ = jax_pad_and_chunk(cohort, jnp.asarray(w),
                                  jax.random.split(jax.random.PRNGKey(0), k), cap)
    np.testing.assert_array_equal(tc["x"].numpy(), np.asarray(jc["x"]))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


# ---------------------------------------------------------------------------
# the round: the port's engines against the JAX mesh engine
# ---------------------------------------------------------------------------

def _jax_run(local_dtype):
    cfg = _cfg(JaxFedConfig)
    trainer = JaxClientTrainer(JaxResNet18GN(num_classes=10, num_filters=NF),
                               lr=0.1, train_dtype=local_dtype or jnp.float32)
    eng = JaxMeshEngine(trainer, _data(jfed), cfg, mesh=make_mesh(1), chunk=2,
                        donate=False, local_dtype=local_dtype)
    v0 = jax.tree.map(np.asarray, eng.init_variables())
    v = jax.tree.map(np.asarray, eng.run(variables=v0, rounds=2))
    return v0, v, eng.metrics_history[-1]


@pytest.fixture(scope="module")
def jax_rounds():
    """Two JAX mesh rounds from one init, in f32 and on bf16 local masters."""
    return {"f32": _jax_run(None), "bf16": _jax_run(jnp.bfloat16)}


def _port_run(engine_cls, v0, local_dtype=None):
    cfg = _cfg(FedConfig)
    trainer = ClientTrainer(create_model("resnet18_gn", 10, num_filters=NF),
                            lr=0.1, train_dtype=local_dtype or torch.float32)
    kw = ({"chunk": 2, "local_dtype": local_dtype}
          if engine_cls is MeshFedAvgEngine else {})
    eng = engine_cls(trainer, _data(tfed), cfg, device="cpu", **kw)
    v = eng.run(variables=flax_to_torch(v0), rounds=2)
    assert all(t.dtype == torch.float32 for t in v.values())
    return torch_to_flax(v), eng.metrics_history[-1]


def _leaves(tree):
    return [np.asarray(a, np.float32) for a in jax.tree.leaves(tree)]


@pytest.mark.parametrize("engine_cls", [MeshFedAvgEngine, FedAvgEngine])
def test_two_f32_rounds_match_jax_mesh_engine(jax_rounds, engine_cls):
    v0, want, want_m = jax_rounds["f32"]
    got, got_m = _port_run(engine_cls, v0)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            _leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    assert got_m["train_loss"] == pytest.approx(want_m["train_loss"], rel=1e-4)
    assert got_m["test_loss"] == pytest.approx(want_m["test_loss"], rel=1e-4)
    assert got_m["test_acc"] == want_m["test_acc"]


def test_two_bf16_master_rounds_match_jax_within_bf16_noise(jax_rounds):
    v0, want, _ = jax_rounds["bf16"]
    _, ref32, _ = jax_rounds["f32"]
    got, _ = _port_run(MeshFedAvgEngine, v0, local_dtype=torch.bfloat16)
    flat = lambda t: np.concatenate([a.ravel() for a in _leaves(t)])
    noise = np.linalg.norm(flat(want) - flat(ref32))
    assert noise < np.linalg.norm(flat(ref32) - flat(v0))
    assert np.linalg.norm(flat(got) - flat(want)) <= 2 * noise


def test_evaluate_local_matches_jax():
    cfg = _cfg(JaxFedConfig)
    jeng = JaxFedAvgEngine(
        JaxClientTrainer(JaxResNet18GN(num_classes=10, num_filters=NF)),
        _data(jfed, test_clients=True), cfg, donate=False)
    v = jax.tree.map(np.asarray, jeng.init_variables())
    teng = FedAvgEngine(ClientTrainer(create_model("resnet18_gn", 10,
                                                   num_filters=NF)),
                        _data(tfed, test_clients=True), _cfg(FedConfig),
                        device="cpu")
    want, got = jeng.evaluate(v), teng.evaluate(flax_to_torch(v))
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


def test_fedavg_equals_centralized_gd():
    """FedAvg with 4 equal clients, one full batch each and E=1 is
    full-batch GD on their union, round for round (tests/test_fedavg.py's
    oracle, on the port alone): GroupNorm normalises per sample, so the
    mean of the client steps is the global step."""
    n_clients, per = 4, 6
    rs = np.random.RandomState(3)
    x = rs.rand(n_clients * per, HW, HW, 3).astype(np.float32)
    y = rs.randint(0, 10, n_clients * per).astype(np.int64)
    shards = tfed.build_client_shards(
        x, y, {i: np.arange(i * per, (i + 1) * per) for i in range(n_clients)},
        per)
    ev = tfed.build_eval_shard(x, y, len(x))
    data = tfed.FederatedData(len(x), len(x), ev, ev, shards,
                              np.full(n_clients, per, np.float32), None, 10)
    cfg = _cfg(FedConfig, client_num_in_total=n_clients,
               client_num_per_round=n_clients, batch_size=per, comm_round=3)
    trainer = ClientTrainer(create_model("resnet18_gn", 10, num_filters=NF),
                            lr=0.1)
    eng = MeshFedAvgEngine(trainer, data, cfg, chunk=3, device="cpu")
    v0 = eng.init_variables(torch.Generator().manual_seed(0))
    v_fed = eng.run(variables=dict(v0), rounds=3)

    flat = trainer.flatten(v0)
    union = {k: torch.tensor(v[0]) for k, v in ev.items()}
    for _ in range(3):
        flat, _, _ = trainer.train_step(flat, union)
    v_cen = trainer.unflatten(flat)
    for k in v_fed:
        np.testing.assert_allclose(v_fed[k].numpy(), v_cen[k].numpy(),
                                   atol=2e-4, rtol=1e-3, err_msg=k)


# ---------------------------------------------------------------------------
# boundaries
# ---------------------------------------------------------------------------

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chex", "fedml_tpu")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "fedml_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    scanned = {f.relative_to(REPO).as_posix() for f in files}
    zoo = {f"fedml_tpu_torch/models/{m}.py" for m in (
        "layers", "norms", "lr", "cnn", "vgg", "resnet_cifar", "mobilenet",
        "mobilenet_v3", "efficientnet", "rnn", "transformer")}
    assert zoo <= scanned and len(files) > 25
    bad = [(f.relative_to(REPO).as_posix(), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trainer = ClientTrainer(create_model("resnet18_gn", 10, num_filters=NF))
    data, cfg = _data(tfed), _cfg(FedConfig)
    for make in (lambda: MeshFedAvgEngine(trainer, data, cfg),
                 lambda: FedAvgEngine(trainer, data, cfg),
                 lambda: trainer.init(torch.Generator().manual_seed(0))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_chip_smoke_refuses_without_a_card(monkeypatch, capsys):
    """chip_smoke.py exits non-zero and prints no result off the card."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert smoke.main() != 0
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
