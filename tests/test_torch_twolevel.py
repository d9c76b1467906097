"""The PyTorch port's two-level round (fedml_tpu_torch/parallel/
multihost.py::MultihostRunner over the engines' `_twolevel_partial` and
`_twolevel_commit`), against the JAX package's MultihostRunner and
against the port's own rounds.

* One rank, LR on 8x8x3 (16 clients of uneven shards, 8 a round in 2
  blocks, f32), from JAX's init carried across with `convert`: the port's
  runner against JAX's, streaming and resident, over 2 rounds.
  Tolerance: rtol 1e-5 / atol 1e-6, f32 summation-order noise (the JAX
  side vmaps a chunk's lanes, the port runs them one after another).
* 2 thread-ranks bitwise 1 rank for FedAvg, FedProx, FedOpt, FedNova
  and norm_clip (with weak-DP noise, whose generator every rank draws
  identically), under every carry codec, serial and overlapped (4
  blocks, 2 a rank, so the pipelined gather ships a block while the
  next one trains).
* The degenerate pin, port against port: with one block on one rank
  the two-level round is bitwise the engine's `round_fn_streaming` on
  the same cohort (LR for every family; ResNet-18-GN at num_filters 4
  for FedAvg and norm_clip).
* The handshake rejects a rank with another codec, naming it; the
  runner refuses what JAX's refuses, with its messages.
* With observability on, rank 1's metric deltas ride its allgather
  payloads as a sidecar that rank 0 strips and folds: the 2-rank round is
  still the 1-rank round bitwise, and the runner's spans, counters and
  barrier ledger are there.
"""
import copy
import json
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core.trainer import ClientTrainer as JaxClientTrainer
from fedml_tpu.data import federated as jfed
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.parallel import engine as jengine
from fedml_tpu.parallel import multihost as jmh
from fedml_tpu.parallel.mesh import make_mesh
from fedml_tpu.utils.config import FedConfig as JaxFedConfig
from fedml_tpu_torch import obs
from fedml_tpu_torch.convert import flax_to_torch
from fedml_tpu_torch.core.trainer import ClientTrainer
from fedml_tpu_torch.data import federated as tfed
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.parallel import engine as tengine
from fedml_tpu_torch.parallel import multihost as tmh
from fedml_tpu_torch.obs import cluster
from fedml_tpu_torch.parallel.carry_codec import CARRY_CODECS
from fedml_tpu_torch.utils.config import FedConfig
from tests.test_torch_multihost import _run_ranks
from tests.test_torch_stream import _data
from tests.test_torch_transports import free_base_port

N_CLIENTS, PER_ROUND, HW = 16, 8, 8

ENGINES = {
    "fedavg": ("MeshFedAvgEngine", {}, {}),
    "fedprox": ("MeshFedProxEngine", {"prox_mu": 0.1}, {}),
    "fedopt": ("MeshFedOptEngine", {"server_optimizer": "adam",
                                    "server_lr": 0.05}, {}),
    "fednova": ("MeshFedNovaEngine", {}, {}),
    "norm_clip": ("MeshRobustEngine", {"norm_bound": 0.3, "stddev": 0.01},
                  {"defense": "norm_clip"}),
}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfg(cls, **kw):
    return cls(client_num_in_total=N_CLIENTS, client_num_per_round=PER_ROUND,
               comm_round=2, epochs=1, batch_size=4, lr=0.1,
               frequency_of_the_test=100, **kw)


def _engine(name, model="lr", streaming=True, **kw):
    """A fresh port engine (its own model: ranks on threads must not
    share a module) on the CPU."""
    cls, cfg_kw, eng_kw = ENGINES[name]
    net = (create_model("lr", 10, input_dim=HW * HW * 3) if model == "lr"
           else create_model("resnet18_gn", 10, num_filters=4))
    return getattr(tengine, cls)(
        ClientTrainer(net, lr=0.1), _data(tfed, n_clients=N_CLIENTS, hw=HW),
        _cfg(FedConfig, **cfg_kw), chunk=2, streaming=streaming,
        device="cpu", **{**eng_kw, **kw})


def _bitwise(a, b):
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _one_rank(name, n_blocks, rounds=2, **runner_kw):
    eng = _engine(name)
    v0 = eng.init_variables()
    runner = tmh.MultihostRunner(eng, tmh.MultihostContext.single(),
                                 n_blocks=n_blocks, **runner_kw)
    return v0, runner.run(variables=dict(v0), rounds=rounds), runner


def _two_ranks(name, v0, n_blocks, rounds=2, **runner_kw):
    port = free_base_port(1)

    def rank(r):
        def fn():
            ctx = tmh.MultihostContext(rank=r, world=2,
                                       coordinator=f"localhost:{port}")
            runner = tmh.MultihostRunner(_engine(name), ctx,
                                         n_blocks=n_blocks, timeout_s=60,
                                         **runner_kw)
            try:
                return (runner.run(variables=copy.deepcopy(v0),
                                   rounds=rounds), runner.report())
            finally:
                runner.close()
        return fn

    return _run_ranks([rank(0), rank(1)], timeout=120)


# ---------------------------------------------------------------------------
# one rank against JAX's runner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("streaming", [True, False])
def test_one_rank_matches_jax_runner(streaming):
    jeng = jengine.MeshFedAvgEngine(
        JaxClientTrainer(jax_create_model("lr", 10), lr=0.1),
        _data(jfed, n_clients=N_CLIENTS, hw=HW), _cfg(JaxFedConfig),
        mesh=make_mesh(1), donate=False, chunk=2, streaming=streaming)
    v0 = jeng.init_variables()
    jrun = jmh.MultihostRunner(jeng, jmh.MultihostContext.single(),
                               n_blocks=2)
    want = flax_to_torch(jax.tree.map(
        np.asarray, jrun.run(variables=jax.tree.map(jnp.copy, v0),
                             rounds=2)))
    teng = _engine("fedavg", streaming=streaming)
    trun = tmh.MultihostRunner(teng, tmh.MultihostContext.single(),
                               n_blocks=2)
    got = trun.run(variables=flax_to_torch(jax.tree.map(np.asarray, v0)),
                   rounds=2)
    assert sorted(got) == sorted(want)
    start = flax_to_torch(jax.tree.map(np.asarray, v0))
    for k in want:
        assert not torch.equal(got[k], start[k]), f"{k} never moved"
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # the same config document as JAX's, up to the engine family's name
    # (the port has no resident round program: its engines are streaming)
    jdoc = json.loads(jrun._config_doc())
    tdoc = json.loads(trun._config_doc())
    jdoc.pop("family"), tdoc.pop("family")
    assert tdoc == jdoc
    # the carry is JAX's length: P + 2 f32 a block
    P = sum(int(np.prod(np.shape(a))) for a in jax.tree.leaves(v0))
    assert trun.carry_raw == [2 * (P + 2) * 4] * 2 == jrun.carry_raw
    assert len(teng.metrics_history) == 2 and \
        abs(teng.metrics_history[-1]["test_acc"]
            - jeng.metrics_history[-1]["test_acc"]) < 1e-6


# ---------------------------------------------------------------------------
# two ranks bitwise one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", CARRY_CODECS)
@pytest.mark.parametrize("name", sorted(ENGINES))
def test_two_ranks_bitwise_one_rank(name, codec):
    kw = dict(carry_codec=codec, carry_chunk=256)
    v0, want, one = _one_rank(name, n_blocks=4, **kw)
    assert one.report()["carry_allreduce_bytes_per_round"] == 0
    for overlap in (False, True):
        out = _two_ranks(name, v0, n_blocks=4, overlap_exchange=overlap,
                         **kw)
        for r in (0, 1):
            got, rep = out[r]
            _bitwise(got, want)
            assert rep["carry_allreduce_bytes_per_round"] > 0
            assert rep["carry_codec"] == codec
            assert rep["carry_payload_bytes_per_round"] == \
                one.report()["carry_payload_bytes_per_round"] / 2
    if codec in ("int8_ef", "topk_ef"):
        state = one.carry_state()["residual"]
        assert sorted(state) == ["0", "1", "2", "3"]
        fresh = tmh.MultihostRunner(_engine(name), n_blocks=4, **kw)
        fresh.load_carry_state(one.carry_state())
        assert fresh.carry_state().keys() == one.carry_state().keys()


# ---------------------------------------------------------------------------
# the degenerate pin: one block is the streaming round
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,model", [(n, "lr") for n in sorted(ENGINES)]
                         + [("fedavg", "resnet18_gn"),
                            ("norm_clip", "resnet18_gn")])
def test_one_block_is_the_streaming_round_bitwise(name, model):
    two = _engine(name, model=model)
    v0 = two.init_variables()
    runner = tmh.MultihostRunner(two, n_blocks=1)
    got = runner.run(variables=dict(v0), rounds=2)
    eng = _engine(name, model=model)
    v, state = dict(v0), eng.server_init(v0)
    for r in range(2):
        cohort, w = eng._stream_gather(runner.sampler.sample_block(r, 0))
        v, state, m = eng.round_fn_streaming(v, state, cohort, w, r)
    _bitwise(got, v)
    assert two.metrics_history[-1]["train_loss"] == float(m["train_loss"])


# ---------------------------------------------------------------------------
# handshake and refusals
# ---------------------------------------------------------------------------

def test_handshake_rejects_a_mismatched_codec():
    port = free_base_port(1)
    errs = {}

    def rank(r):
        def fn():
            ctx = tmh.MultihostContext(rank=r, world=2,
                                       coordinator=f"localhost:{port}")
            runner = tmh.MultihostRunner(
                _engine("fedavg"), ctx, timeout_s=30,
                carry_codec=("f32", "int8")[r])
            try:
                runner.run(rounds=1)
            except RuntimeError as e:
                errs[r] = str(e)
            finally:
                runner.close()
        return fn

    _run_ranks([rank(0), rank(1)], timeout=60)
    for r in (0, 1):
        assert "config mismatch: rank 1" in errs[r]
        assert '"carry_codec": "int8"' in errs[r]


@pytest.mark.parametrize("case", ["stream_block", "krum", "median",
                                  "blocks", "cohort", "engine"])
def test_refusals_match_jax(case):
    """What JAX's runner refuses, the port's refuses with its message."""
    jkw, tkw, runner_kw, match = {}, {}, {}, None
    if case == "stream_block":
        jkw = tkw = {"stream_block": 4}
        match = "does not drive block-streamed rounds"
    elif case in ("krum", "median"):
        jkw = tkw = {"defense": case}
        match = "order-statistic defense"
    elif case == "blocks":
        runner_kw = {"n_blocks": 3, "ctx_world": 2}
        match = "multiple of the process count"
    elif case == "cohort":
        runner_kw = {"n_blocks": 3}
        match = "must divide evenly into 3 blocks"
    name = "norm_clip" if case in ("krum", "median") else "fedavg"
    world = runner_kw.pop("ctx_world", 1)
    cls, cfg_kw, _ = ENGINES[name]
    if case == "engine":
        from fedml_tpu_torch.algorithms.fedavg import FedAvgEngine
        eng = FedAvgEngine(ClientTrainer(create_model(
            "lr", 10, input_dim=HW * HW * 3)), _data(tfed), _cfg(FedConfig),
            device="cpu")
        with pytest.raises(ValueError, match="flat FedAvg-family"):
            tmh.MultihostRunner(eng)
        return
    jeng = getattr(jengine, cls)(
        JaxClientTrainer(jax_create_model("lr", 10), lr=0.1),
        _data(jfed, n_clients=N_CLIENTS, hw=HW), _cfg(JaxFedConfig, **cfg_kw),
        mesh=make_mesh(1), donate=False, chunk=2, **jkw)
    teng = _engine(name, **tkw)
    for mod, eng in ((jmh, jeng), (tmh, teng)):
        ctx = mod.MultihostContext(rank=0, world=world,
                                   coordinator="localhost:0")
        with pytest.raises(ValueError, match=match):
            mod.MultihostRunner(eng, ctx, **runner_kw)


def test_variables_digest_is_bitwise_identity():
    eng = _engine("fedavg")
    v = eng.init_variables()
    w = {k: t.clone() for k, t in v.items()}
    assert tmh.variables_digest(v) == tmh.variables_digest(w)
    k0 = next(iter(w))
    w[k0].view(-1)[0] = torch.nextafter(w[k0].view(-1)[0],
                                        torch.tensor(np.inf))
    assert tmh.variables_digest(v) != tmh.variables_digest(w)


def test_observed_two_ranks_are_bitwise_and_traced(tmp_path, monkeypatch):
    for var in (obs.ENV_VAR, obs.ENV_HTTP, obs.ENV_SPILL):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(obs, "_prev_sigusr1", None)
    prev = signal.getsignal(signal.SIGUSR1)
    obs.reset()
    try:
        v0, want, _ = _one_rank("fedavg", n_blocks=2)
        obs.configure(str(tmp_path / "obs"))
        out = _two_ranks("fedavg", v0, n_blocks=2, overlap_exchange=True)
        for r in (0, 1):
            _bitwise(out[r][0], want)
        names = {e["name"] for e in obs.tracer().events()}
        assert {"round.twolevel", "multihost.encode_carry",
                "multihost.overlap_wait", "eval"} <= names
        reg = obs.registry()
        assert reg.counter("multihost_rounds_committed_total",
                           rank="1").value == 2
        # rank 1's deltas, folded on rank 0 under its origin
        assert reg.counter("multihost_rounds_committed_total", rank="1",
                           origin="host1").value >= 1
        assert reg.counter("multihost_bytes_sent_total",
                           rank="1").value > 0
        summary = cluster.straggler_summary()
        assert summary["barriers"] >= 3 and set(
            summary["per_rank_wait_s"]) == {"0", "1"}
    finally:
        obs.reset()
        signal.signal(signal.SIGUSR1, prev)
