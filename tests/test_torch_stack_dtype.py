"""The mesh engine's `stack_dtype` (uint8 and bf16 cohort storage) in the
PyTorch port, against the port's own f32 round and the JAX package.

* As JAX's ``test_stack_dtype_bf16_close_to_f32`` and
  ``test_stack_dtype_uint8_close_to_f32`` (tests/test_parallel.py:313-420):
  three rounds with the input leaf stored in bf16 or uint8 stay within
  rtol 0.05 / atol 0.02 of the f32-stack rounds; only x changes dtype;
  ``data`` is left untouched; integer inputs are never cast or quantized.
* From copied weights, the port's uint8 round matches the JAX
  MeshFedAvgEngine's uint8 round at tests/test_torch_fedavg.py's f32
  tolerance (per leaf rtol 1e-3 / atol 1e-4, train loss rel 1e-4), each
  round started from JAX's model (ROADMAP C.3).
* A loader-quantized stack (``load_data(store_uint8=True)``) passes
  through with its spec, and every engine on the chunk loop (FedAvg,
  norm clip, the order statistics, FedNova, FedOpt, FedProx) and
  ``evaluate_local`` dequantize it: each gives bitwise the round it gives
  on the same stack dequantized on the host.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core.trainer import ClientTrainer as JaxClientTrainer
from fedml_tpu.data import federated as jfed
from fedml_tpu.models.resnet_gn import ResNet18GN as JaxResNet18GN
from fedml_tpu.parallel.engine import MeshFedAvgEngine as JaxMeshEngine
from fedml_tpu.parallel.mesh import make_mesh
from fedml_tpu.utils.config import FedConfig as JaxFedConfig
from fedml_tpu_torch.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.core.trainer import ClientTrainer
from fedml_tpu_torch.data import federated as tfed
from fedml_tpu_torch.data import quant
from fedml_tpu_torch.data.loaders import load_data
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.parallel.engine import (MeshFedAvgEngine,
                                             MeshFedNovaEngine,
                                             MeshFedOptEngine,
                                             MeshFedProxEngine,
                                             MeshRobustEngine)
from fedml_tpu_torch.utils.config import FedConfig
from tests.test_torch_robust import few_torch_threads  # noqa: F401 (autouse)

NF, HW, BS = 4, 8, 4
SIZES = (8, 5, 3, 7, 6)          # unequal clients: ragged last batches


def _data(mod, x_dtype=np.float32):
    rs = np.random.RandomState(0)
    n = sum(SIZES)
    x = (rs.rand(n, HW, HW, 3) * 2 - 0.5).astype(x_dtype)
    y = rs.randint(0, 10, n).astype(np.int64)
    ends = np.cumsum(SIZES)
    idx = {i: np.arange(e - s, e) for i, (s, e) in enumerate(zip(SIZES, ends))}
    ev = mod.build_eval_shard(x[:10], y[:10], BS)
    return mod.FederatedData(
        train_data_num=n, test_data_num=10, train_global=ev, test_global=ev,
        client_shards=mod.build_client_shards(x, y, idx, BS),
        client_num_samples=np.asarray(SIZES, np.float32),
        test_client_shards=None, class_num=10)


def _cfg(cls, **kw):
    base = dict(model="resnet18_gn", dataset="cifar10",
                client_num_in_total=len(SIZES),
                client_num_per_round=len(SIZES), comm_round=3, epochs=1,
                batch_size=BS, lr=0.1, frequency_of_the_test=100,
                norm_bound=1.0, server_optimizer="adam", server_lr=0.01,
                prox_mu=0.1)
    return cls(**{**base, **kw})


def _trainer(**kw):
    return ClientTrainer(create_model("resnet18_gn", 10, num_filters=NF),
                         lr=0.1, **kw)


def _engine(data, cls=MeshFedAvgEngine, **kw):
    return cls(_trainer(), data, _cfg(FedConfig), chunk=2, device="cpu", **kw)


def _snapshot(data):
    return {k: v.copy() for k, v in data.client_shards.items()}


# ---------------------------------------------------------------------------
# closeness to the f32 round (JAX's two stack_dtype tests)
# ---------------------------------------------------------------------------

def _mnist_like():
    """JAX's closeness setting (tests/parallel_case.py): LR on the synthetic
    MNIST stand-in, 16 clients in full participation, batches of 16, lr
    0.1."""
    data = load_data("mnist", client_num_in_total=16, batch_size=16,
                     synthetic_scale=0.02, seed=0)
    cfg = FedConfig(model="lr", dataset="mnist", client_num_in_total=16,
                    client_num_per_round=16, comm_round=3, epochs=1,
                    batch_size=16, lr=0.1, partition_method="homo",
                    frequency_of_the_test=100)
    return ClientTrainer(create_model("lr", 10), lr=0.1), data, cfg


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.uint8],
                         ids=["bf16", "uint8"])
def test_stack_dtype_rounds_close_to_f32(dtype):
    trainer, data, cfg = _mnist_like()
    before = _snapshot(data)
    ref = MeshFedAvgEngine(trainer, data, cfg, device="cpu")
    v0 = ref.init_variables()
    v_f32 = ref.run(variables=dict(v0), rounds=3)
    eng = MeshFedAvgEngine(trainer, data, cfg, stack_dtype=dtype, device="cpu")
    cohort, _ = eng.stream_cohort(0)
    assert cohort["x"].dtype == dtype
    assert cohort["y"].dtype == torch.int64
    assert cohort["mask"].dtype == torch.float32
    assert (eng._x_dequant is not None) == (dtype == torch.uint8)
    v = eng.run(variables=dict(v0), rounds=3)
    for k in v_f32:
        assert v[k].dtype == torch.float32          # the globals stay f32
        assert not torch.equal(v[k], v_f32[k])      # the inputs did change
        np.testing.assert_allclose(v[k].numpy(), v_f32[k].numpy(), rtol=0.05,
                                   atol=0.02, err_msg=k)
    # the shared data object keeps its float stack, bit for bit
    for k, arr in before.items():
        assert data.client_shards[k].dtype == arr.dtype
        assert data.client_shards[k].tobytes() == arr.tobytes()
    assert data.x_dequant is None


def test_uint8_view_is_quantized_once_with_a_minmax_spec():
    data = _data(tfed)
    eng = _engine(data, stack_dtype=torch.uint8)
    x = data.client_shards["x"]
    spec = quant.spec_from_minmax(x)
    assert eng._x_dequant.scale.tobytes() == spec.scale.tobytes()
    assert eng._x_dequant.offset.tobytes() == spec.offset.tobytes()
    host = eng._host_shards()
    assert host["x"].tobytes() == quant.quantize_uint8(x, spec).tobytes()
    assert host["mask"] is data.client_shards["mask"]


def test_dequantize_runs_per_chunk_on_the_chunk_only():
    """The dequantize sees one chunk at a time (O(chunk) f32 memory), as the
    first operation before the chunk's clients train."""
    eng = _engine(_data(tfed), stack_dtype=torch.uint8)
    seen = []
    restore = eng._restore_chunk_x

    def record(shards):
        seen.append((shards["x"].dtype, tuple(shards["x"].shape)))
        out = restore(shards)
        assert out["x"].dtype == torch.float32
        return out

    eng._restore_chunk_x = record
    v0 = eng.init_variables(torch.Generator().manual_seed(0))
    eng.round_fn(v0, (), *eng._round_args(0))
    # 5 clients at cap 2 -> 3 chunks of 2 lanes (one zero-weight pad lane)
    assert [s for s in seen] == [(torch.uint8, (2, 2, BS, HW, HW, 3))] * 3


# ---------------------------------------------------------------------------
# the uint8 round against the JAX package's uint8 round
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_uint8_chain():
    """Three JAX MeshFedAvgEngine rounds on a uint8 stack (full
    participation, so each round's cohort is the same), each one round of
    the JAX engine's own run from the model before."""
    trainer = JaxClientTrainer(JaxResNet18GN(num_classes=10, num_filters=NF),
                               lr=0.1)
    eng = JaxMeshEngine(trainer, _data(jfed), _cfg(JaxFedConfig),
                        mesh=make_mesh(1), chunk=2, donate=False,
                        stack_dtype=jnp.uint8)
    assert eng._x_dequant is not None
    v = jax.tree.map(np.asarray, eng.init_variables())
    chain = [(v, None)]
    for _ in range(3):
        v = jax.tree.map(np.asarray, eng.run(variables=v, rounds=1))
        chain.append((v, eng.metrics_history[-1]["train_loss"]))
    return chain


def test_uint8_rounds_match_jax_from_copied_weights(jax_uint8_chain):
    eng = _engine(_data(tfed), stack_dtype=torch.uint8)
    for r in range(3):
        start, _ = jax_uint8_chain[r]
        want, want_loss = jax_uint8_chain[r + 1]
        got, _, m = eng.round_fn(flax_to_torch(start), (),
                                 *eng._round_args(r))
        for (path, a), b in zip(
                jax.tree_util.tree_leaves_with_path(torch_to_flax(got)),
                jax.tree.leaves(want)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-3, atol=1e-4,
                                       err_msg=f"round {r} "
                                               f"{jax.tree_util.keystr(path)}")
        assert float(m["train_loss"]) == pytest.approx(want_loss, rel=1e-4)


# ---------------------------------------------------------------------------
# a loader-quantized stack, through every engine on the chunk loop
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def loader_u8():
    """(uint8 data from load_data, the same data with x dequantized on the
    host)."""
    u8 = load_data("cifar10", client_num_in_total=4, batch_size=BS,
                   synthetic_scale=0.0008, max_batches_per_client=2,
                   partition_method="homo", store_uint8=True)
    assert u8.client_shards["x"].dtype == np.uint8 and u8.x_dequant is not None
    assert u8.test_global["x"].dtype == np.float32       # eval stays float
    f32 = tfed.FederatedData(**{**vars(u8), "client_shards": {
        **u8.client_shards,
        "x": quant.dequantize(u8.client_shards["x"], u8.x_dequant)},
        "x_dequant": None, "_device_cache": {}})
    return u8, f32


ENGINES = {
    "fedavg": (MeshFedAvgEngine, {}),
    "norm_clip": (MeshRobustEngine, {"defense": "norm_clip"}),
    "median": (MeshRobustEngine, {"defense": "median"}),
    "krum": (MeshRobustEngine, {"defense": "krum"}),
    "fednova": (MeshFedNovaEngine, {}),
    "fedopt": (MeshFedOptEngine, {}),
    "fedprox": (MeshFedProxEngine, {}),
}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_every_chunked_engine_dequantizes_a_loader_stack(name, loader_u8):
    """stack_dtype left unset: the loader's uint8 stack still dequantizes
    (a correctness requirement), and the round is bitwise the round on
    the host-dequantized stack."""
    u8, f32 = loader_u8
    cls, kw = ENGINES[name]
    cfg = _cfg(FedConfig, client_num_in_total=4, client_num_per_round=4)
    out = []
    for data in (u8, f32):
        eng = cls(_trainer(), data, cfg, chunk=2, device="cpu", **kw)
        if data is u8:
            assert eng._host_shards() is u8.client_shards
            assert eng._x_dequant is u8.x_dequant
            assert eng.stream_cohort(0)[0]["x"].dtype == torch.uint8
        v0 = eng.init_variables(torch.Generator().manual_seed(1))
        state = eng.server_init(v0)
        out.append(eng.round_fn(v0, state, *eng._round_args(0)))
    (a, _, ma), (b, _, mb) = out
    assert torch.equal(ma["train_loss"], mb["train_loss"])
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_evaluate_local_train_dequantizes(loader_u8):
    out = []
    for data in loader_u8:
        eng = _engine(data)
        out.append(eng.evaluate_local(
            eng.init_variables(torch.Generator().manual_seed(2)),
            split="train"))
    assert out[0] == out[1]


def test_bf16_knob_leaves_a_loader_uint8_stack_in_uint8(loader_u8):
    u8, _ = loader_u8
    eng = _engine(u8, stack_dtype=torch.bfloat16)
    assert eng.stream_cohort(0)[0]["x"].dtype == torch.uint8


def test_uint8_stack_without_its_spec_is_refused(loader_u8):
    u8, _ = loader_u8
    bare = tfed.FederatedData(**{**vars(u8), "x_dequant": None,
                                 "_device_cache": {}})
    for dtype in (None, torch.uint8):
        with pytest.raises(ValueError, match="x_dequant is unset"):
            _engine(bare, stack_dtype=dtype)


# ---------------------------------------------------------------------------
# integer inputs and bad dtypes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.uint8],
                         ids=["bf16", "uint8"])
def test_integer_inputs_are_never_cast_or_quantized(dtype, caplog):
    data = _data(tfed)
    data.client_shards["x"] = (np.abs(data.client_shards["x"][..., :1])
                               * 1000).astype(np.int32)
    with caplog.at_level(logging.WARNING):
        eng = _engine(data, stack_dtype=dtype)
        cohort, _ = eng.stream_cohort(0)
    assert eng._x_dequant is None and eng._host_shards() is data.client_shards
    assert cohort["x"].dtype == torch.int32
    assert torch.equal(cohort["x"], torch.from_numpy(
        data.client_shards["x"][eng.sampler.sample(0)]))
    assert "ignored" in caplog.text and "int32" in caplog.text


def test_stack_dtype_must_be_uint8_or_a_float_dtype():
    with pytest.raises(ValueError, match="stack_dtype"):
        _engine(_data(tfed), stack_dtype=torch.int32)
    with pytest.raises(ValueError, match="stack_dtype"):
        _engine(_data(tfed), stack_dtype="uint8")
