"""Round-level checkpoint and resume in the PyTorch port.

* FedCheckpointManager: the round trip of (round, variables,
  server_state, extra_state) bitwise, `max_to_keep`, the temporary-name
  write, restore onto the template's device, and the refusals.
* FedAvgEngine.run(ckpt=, ckpt_every=, resume=): 2 rounds, then a fresh
  engine resumed for the third, bitwise the straight 3 rounds, on the
  chunked engine (streaming and block-streamed), FedOpt (the Adam moments
  ride server_state) and norm_clip with weak-DP noise (the generator's
  state rides extra_state).  LR and ResNet-18-GN num_filters 4, CPU.
* AsyncFedAvgEngine.run(ckpt=, ckpt_every=, resume=): the restored
  async_state() bitwise the saved one; the degenerate config (FedAvg
  waves) resumed bitwise the straight run; a lifecycle run resumed to the
  budget; the legacy per-client arrays migrate into the registry.
* AsyncServerManager(checkpoint_dir=, resume=): crash the server
  mid-run over INPROC, rebuild it from the checkpoint, and the clients
  re-handshake to the full commit budget.
"""
import os
import time

import numpy as np
import pytest
import torch

from fedml_tpu_torch.async_ import (AsyncClientManager, AsyncFedAvgEngine,
                                    AsyncServerManager, LifecycleConfig)
from fedml_tpu_torch.comm.inproc import InProcRouter
from fedml_tpu_torch.core.trainer import ClientTrainer
from fedml_tpu_torch.data import federated as tfed
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.parallel.engine import (MeshFedAvgEngine,
                                             MeshFedOptEngine,
                                             MeshRobustEngine)
from fedml_tpu_torch.utils.checkpoint import FedCheckpointManager
from fedml_tpu_torch.utils.config import FedConfig


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _data(n_clients=4, per=8, bs=4, hw=8, seed=0):
    rs = np.random.RandomState(seed)
    n = n_clients * per
    x = rs.rand(n, hw, hw, 3).astype(np.float32)
    y = rs.randint(0, 10, n).astype(np.int64)
    idx = {i: np.arange(i * per, (i + 1) * per) for i in range(n_clients)}
    ev = tfed.build_eval_shard(x[:bs], y[:bs], bs)
    return tfed.FederatedData(
        train_data_num=n, test_data_num=bs, train_global=ev, test_global=ev,
        client_shards=tfed.build_client_shards(x, y, idx, bs),
        client_num_samples=np.full(n_clients, per, np.float32),
        test_client_shards=None, class_num=10, synthetic=True)


def _cfg(n=4, per_round=4, rounds=3, **kw):
    return FedConfig(client_num_in_total=n, client_num_per_round=per_round,
                     comm_round=rounds, epochs=1, batch_size=4, lr=0.1,
                     frequency_of_the_test=100, **kw)


def _trainer(model):
    if model == "lr":
        return ClientTrainer(create_model("lr", 10, input_dim=8 * 8 * 3),
                             lr=0.1)
    return ClientTrainer(create_model("resnet18_gn", 10, num_filters=4),
                         lr=0.1)


def _bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

def test_manager_round_trip_and_max_to_keep(tmp_path):
    mgr = FedCheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.latest_round() is None
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        mgr.latest_step_or_raise()
    g = torch.Generator().manual_seed(5)
    v = {"a": torch.randn(3, 4, generator=g),
         "b": torch.randn(2, generator=g).bfloat16()}
    ss = {"count": 3, "mu": {"a": torch.randn(3, 4, generator=g)}}
    extra = {"buffer": {"weights": np.arange(4, dtype=np.float32)},
             "version": np.asarray(7, np.int64)}
    for r in range(4):
        mgr.save(r, {k: t + r for k, t in v.items()}, ss, extra_state=extra)
    assert mgr.rounds() == [2, 3] and mgr.latest_round() == 3
    assert not [f for f in os.listdir(mgr.directory) if ".tmp" in f]
    step, v2, ss2, extra2 = mgr.restore(v, ss, extra_template=extra)
    assert step == 3
    _bitwise(v2, {k: t + 3 for k, t in v.items()})
    assert v2["b"].dtype == torch.bfloat16
    assert ss2["count"] == 3 and torch.equal(ss2["mu"]["a"], ss["mu"]["a"])
    np.testing.assert_array_equal(extra2["buffer"]["weights"],
                                  extra["buffer"]["weights"])
    step, v2, _ = mgr.restore(v, ss, round_idx=2)
    assert step == 2 and torch.equal(v2["a"], v["a"] + 2)
    mgr.save(9, v, ())
    with pytest.raises(ValueError, match="extra_state"):
        mgr.restore(v, (), extra_template=extra)
    with pytest.raises(ValueError, match="max_to_keep"):
        FedCheckpointManager(str(tmp_path / "x"), max_to_keep=0)
    mgr.close()


# ---------------------------------------------------------------------------
# FedAvgEngine.run
# ---------------------------------------------------------------------------

RESUME_CASES = {
    "mesh_resnet": (MeshFedAvgEngine, "resnet", {}, {"chunk": 2}),
    "mesh_blockstream": (MeshFedAvgEngine, "lr", {},
                         {"chunk": 2, "stream_block": 2}),
    "mesh_streaming": (MeshFedAvgEngine, "lr", {},
                       {"chunk": 2, "streaming": True}),
    "fedopt_adam": (MeshFedOptEngine, "lr",
                    {"server_optimizer": "adam", "server_lr": 0.05},
                    {"chunk": 2}),
    "norm_clip_dp": (MeshRobustEngine, "lr",
                     {"norm_bound": 0.5, "stddev": 0.01},
                     {"chunk": 2, "defense": "norm_clip"}),
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resumed_run_is_the_straight_run_bitwise(case, tmp_path):
    cls, model, cfg_kw, eng_kw = RESUME_CASES[case]
    make = lambda: cls(_trainer(model), _data(n_clients=6),
                       _cfg(n=6, per_round=4, **cfg_kw), device="cpu",
                       **eng_kw)
    straight = make()
    v0 = straight.init_variables()
    want = straight.run(variables=dict(v0), rounds=3)
    ck = FedCheckpointManager(str(tmp_path / case))
    first = make()
    first.run(variables=dict(v0), rounds=2, ckpt=ck, ckpt_every=1)
    assert ck.rounds() == [0, 1]
    resumed = make()
    got = resumed.run(variables=dict(v0), rounds=3, ckpt=ck, ckpt_every=1,
                      resume=True)
    _bitwise(got, want)
    assert ck.latest_round() == 2
    # a resume at the budget trains nothing and returns the saved model
    again = make().run(variables=dict(v0), rounds=3, ckpt=ck, resume=True)
    _bitwise(again, want)


# ---------------------------------------------------------------------------
# the async scheduler
# ---------------------------------------------------------------------------

def _async_engine(commits, **kw):
    return AsyncFedAvgEngine(_trainer("lr"), _data(n_clients=6),
                             _cfg(n=6, per_round=6, rounds=commits),
                             device="cpu", **kw)


def test_scheduler_degenerate_resume_is_the_straight_run(tmp_path):
    """Zero latency, no dropout, buffer = cohort: the waves are FedAvg
    rounds, and a resume after 2 commits is the straight 4 bitwise."""
    kw = dict(buffer_k=6, concurrency=6)
    straight = _async_engine(4, **kw)
    v0 = straight.init_variables()
    want = straight.run(variables=dict(v0), rounds=4)
    ck = FedCheckpointManager(str(tmp_path / "sched"))
    first = _async_engine(4, **kw)
    first.run(variables=dict(v0), rounds=2, ckpt=ck, ckpt_every=1)
    saved = first.async_state()
    resumed = _async_engine(4, **kw)
    got = resumed.run(variables=dict(v0), rounds=4, ckpt=ck, ckpt_every=2,
                      resume=True)
    _bitwise(got, want)
    assert resumed.version == 4
    assert [e for e in resumed.trace if e[0] == "commit"][0][3] == 3
    assert int(saved["version"]) == 2


def test_scheduler_restored_state_is_the_saved_state(tmp_path):
    kw = dict(buffer_k=3, concurrency=6, staleness="polynomial",
              lifecycle_cfg=LifecycleConfig(latency="lognormal",
                                            dropout_prob=0.2, seed=7))
    ck = FedCheckpointManager(str(tmp_path / "sched2"))
    first = _async_engine(4, **kw)
    v0 = first.init_variables()
    first.run(variables=dict(v0), rounds=2, ckpt=ck, ckpt_every=2)
    saved = first.async_state()
    resumed = _async_engine(4, **kw)
    _step, _v, _s, extra = ck.restore(v0, (),
                                      extra_template=resumed.async_state())
    resumed.load_async_state(extra)
    again = resumed.async_state()
    for part in ("buffer", "registry"):
        assert sorted(again[part]) == sorted(saved[part])
        for k in saved[part]:
            np.testing.assert_array_equal(again[part][k], saved[part][k])
    assert int(again["version"]) == 2
    fresh = _async_engine(4, **kw)
    out = fresh.run(variables=dict(v0), rounds=4, ckpt=ck, resume=True)
    assert fresh.version == 4
    assert all(torch.isfinite(t).all() for t in out.values())


def test_scheduler_migrates_the_legacy_per_client_arrays():
    eng = _async_engine(2, buffer_k=3)
    state = eng.async_state()
    legacy = {"buffer": state["buffer"], "version": np.asarray(5, np.int64),
              "client_contribs": np.asarray([0, 2, 0, 1, 0, 0], np.int64),
              "client_last_staleness": np.asarray([0, 1.5, 0, 0.5, 0, 0],
                                                  np.float32)}
    eng.load_async_state(legacy)
    assert eng.version == 5
    np.testing.assert_array_equal(eng.registry.participation(
        np.arange(6)), [0, 2, 0, 1, 0, 0])
    np.testing.assert_array_equal(eng.registry.last_staleness(
        np.arange(6)), np.asarray([0, 1.5, 0, 0.5, 0, 0], np.float32))
    with pytest.raises(ValueError, match="not an async server state"):
        eng.load_async_state({"buffer": state["buffer"],
                              "version": np.asarray(0)})


# ---------------------------------------------------------------------------
# the lifecycle server's crash-resume
# ---------------------------------------------------------------------------

def test_async_server_crash_resume_over_inproc(tmp_path):
    trainer, data = _trainer("lr"), _data(n_clients=2)
    init = trainer.init(torch.Generator().manual_seed(0), "cpu")
    init = {k: init[k] for k in trainer.spec.names}
    router = InProcRouter()
    ck = str(tmp_path / "srv")
    kw = dict(router=router, device="cpu")
    server1 = AsyncServerManager(init, 6, 2, 0, 3, "INPROC", deadline_s=2.0,
                                 reliable=True, checkpoint_dir=ck,
                                 checkpoint_every=1, **kw)
    clients = [AsyncClientManager(trainer, data, 1, r, 3, "INPROC",
                                  reliable=True, **kw) for r in (1, 2)]
    for c in clients:
        c.run_async()
    server1.run_async()
    server1.send_start()
    server2 = None
    try:
        deadline = time.time() + 30
        while server1.version < 2 and time.time() < deadline:
            time.sleep(0.01)
        assert server1.version >= 2, "server never reached the crash point"
        server1.crash()
        saved = FedCheckpointManager(ck).latest_round()
        server2 = AsyncServerManager(init, 6, 2, 0, 3, "INPROC",
                                     deadline_s=2.0, reliable=True,
                                     checkpoint_dir=ck, checkpoint_every=1,
                                     resume=True, **kw)
        assert server2.version == saved >= 2
        # at a commit boundary the buffer is empty: every admitted uplink
        # was committed, and the restored counters agree
        assert (server2.registry.total_participation()
                == server2.updates_committed)
        _, want, _ = FedCheckpointManager(ck).restore(init, (),
                                                      round_idx=saved)
        _bitwise(server2.variables, want)
        server2.run_async()
        server2.send_start()
        assert server2.done.wait(timeout=60), server2.version
        assert server2.version == 6 and server2.updates_committed > 0
        assert all(torch.isfinite(t).all()
                   for t in server2.variables.values())
    finally:
        for c in clients:
            c.finish()
        if server2 is not None:
            server2.finish()
        server1.finish()
