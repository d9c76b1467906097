"""The port's async scheduler, lifecycle server and client registry
(fedml_tpu_torch/async_/scheduler.py, lifecycle.py, scale/registry.py)
against the JAX package's, on the CPU.

* AsyncFedAvgEngine against JAX's from JAX's init, on LR (five configs:
  churn with crashes and rejoins, a deadline commit, FedAsync at K = 1,
  the attacked and defended run, a duck-typed shard store) and on
  ResNet-18-GN at 4 filters on 8x8 images (one commit): the event trace
  exactly, and the model after every commit within rtol 1e-5 (absolute
  floor 1e-5 of the leaf's largest element).
* The degenerate config (zero latency and dropout, buffer_k = cohort,
  constant λ, mix 1) equals the port's FedAvgEngine bitwise.
* The scheduler's deadlock raises with one flight dump; async_state
  round-trips; checkpoints to disk refuse by name (slices 6b, 6c).
* The registry and the lifecycle's draws are bitwise JAX's.
* The server fed the same rows in the same order commits JAX's model
  (drain, streaming, defended); run_async_messaging over INPROC commits
  as JAX's does (streaming, the decode pool, the drain path, defended,
  secure).
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.async_ import (AsyncFedAvgEngine as JaxAsyncEngine,
                              AsyncServerManager as JaxServer,
                              AttackConfig as JaxAttack,
                              DefenseConfig as JaxDefense,
                              LifecycleConfig as JaxLifecycle,
                              run_async_messaging as jax_run_async)
from fedml_tpu.async_ import lifecycle as jlife
from fedml_tpu.async_ import staleness as jst
from fedml_tpu.comm.inproc import InProcRouter as JaxRouter
from fedml_tpu.core.trainer import ClientTrainer as JaxClientTrainer
from fedml_tpu.data import federated as jfed
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.scale import registry as jreg
from fedml_tpu.utils.config import FedConfig as JaxFedConfig
from fedml_tpu_torch import obs
from fedml_tpu_torch.algorithms.centralized import CentralizedTrainer
from fedml_tpu_torch.algorithms.fedavg import FedAvgEngine
from fedml_tpu_torch.async_ import (AsyncBuffer, AsyncFedAvgEngine,
                                    AsyncServerManager, AttackConfig,
                                    DefenseConfig, LifecycleConfig,
                                    UpdateAdmission, run_async_messaging)
from fedml_tpu_torch.async_ import lifecycle as tlife
from fedml_tpu_torch.async_ import staleness as tst
from fedml_tpu_torch.async_.scheduler import AsyncSchedulerDeadlock
from fedml_tpu_torch.comm.inproc import InProcRouter
from fedml_tpu_torch.convert import flax_to_torch
from fedml_tpu_torch.core.trainer import ClientTrainer
from fedml_tpu_torch.data import federated as tfed
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.scale import registry as treg
from fedml_tpu_torch.scale import run_serve_sim
from fedml_tpu_torch.secure import SecAggConfig, SecureAggregator
from fedml_tpu_torch.utils.checkpoint import FedCheckpointManager
from fedml_tpu_torch.utils.config import FedConfig

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-5
WAIT = 60.0


def _data(mod, n_clients, per=8, bs=4, hw=28, ch=1, seed=3):
    """FederatedData of either package from the same numpy arrays."""
    rs = np.random.RandomState(seed)
    n = n_clients * per
    x = rs.rand(n, hw, hw, ch).astype(np.float32)
    y = rs.randint(0, 10, n).astype(np.int64)
    idx = {i: np.arange(i * per, (i + 1) * per) for i in range(n_clients)}
    ev = mod.build_eval_shard(x[:bs], y[:bs], bs)
    return mod.FederatedData(
        train_data_num=n, test_data_num=bs, train_global=ev, test_global=ev,
        client_shards=mod.build_client_shards(x, y, idx, bs),
        client_num_samples=np.full(n_clients, per, np.float32),
        test_client_shards=None, class_num=10, synthetic=True)


def _cfg(cls, n, rounds=3, bs=4):
    return cls(client_num_in_total=n, client_num_per_round=n,
               comm_round=rounds, epochs=1, batch_size=bs, lr=0.1,
               frequency_of_the_test=100)


def _to_torch(tree):
    return flax_to_torch(jax.tree.map(np.asarray, tree))


def _assert_model_close(got: dict, want: dict, err=""):
    want = _to_torch(want)
    assert sorted(got) == sorted(want)
    for k in want:
        w = want[k].numpy()
        np.testing.assert_allclose(
            got[k].numpy(), w, rtol=RTOL,
            atol=RTOL * max(float(np.abs(w).max()), 1.0),
            err_msg=f"{err} {k}")


def _recorded(fn, out: list):
    """A commit program that also records every committed model."""
    def commit(*a, **k):
        new, stats = fn(*a, **k)
        port = isinstance(next(iter(new.values())), torch.Tensor)
        out.append({kk: v.clone() for kk, v in new.items()} if port
                   else jax.tree.map(np.asarray, new))
        return new, stats
    return commit


LR_CASES = {
    "churn": dict(n=8, buffer_k=4, concurrency=8, staleness="polynomial",
                  commits=5, lc=dict(latency="lognormal", latency_scale=1.0,
                                     latency_sigma=0.8, heterogeneity=0.5,
                                     dropout_prob=0.2, rejoin_prob=1.0,
                                     rejoin_delay_s=2.0, seed=7)),
    "deadline": dict(n=4, buffer_k=4, commits=3, round_deadline_s=2.0,
                     lc=dict(latency="lognormal", latency_scale=1.0,
                             dropout_prob=0.5, rejoin_prob=1.0,
                             rejoin_delay_s=10.0, seed=3)),
    "fedasync": dict(n=8, buffer_k=1, concurrency=8, staleness="hinge",
                     staleness_a=1.0, staleness_b=1.0, mix=0.5, commits=6,
                     lc=dict(latency="lognormal", latency_scale=1.0,
                             latency_sigma=0.6, seed=5)),
    "defended": dict(n=8, buffer_k=4, concurrency=8, commits=4,
                     staleness="polynomial",
                     attack=dict(mode="boost", frac=0.25, boost=20.0, seed=1),
                     defense=dict(norm_bound=1.0, screen=True, z_max=3.0,
                                  screen_warmup=3, buckets=2,
                                  combine="median", seed=4),
                     lc=dict(latency="lognormal", latency_scale=1.0,
                             seed=2)),
}


def _engines(model, case, hw=28, ch=1, nf=None):
    c = dict(case)
    n, commits = c.pop("n"), c.pop("commits")
    lc = c.pop("lc")
    attack, defense = c.pop("attack", None), c.pop("defense", None)
    mk = dict(num_filters=nf) if nf else {}
    jdata = _data(jfed, n, hw=hw, ch=ch)
    jcfg = _cfg(JaxFedConfig, n, rounds=commits)
    jtrainer = JaxClientTrainer(jax_create_model(model, 10, **mk), lr=0.1)
    jeng = JaxAsyncEngine(
        jtrainer, jdata, jcfg, lifecycle_cfg=JaxLifecycle(**lc),
        attack=JaxAttack(**attack) if attack else None,
        defense=JaxDefense(**defense) if defense else None, donate=False,
        **c)
    init = jax.tree.map(np.asarray, jeng.init_variables())
    teng = AsyncFedAvgEngine(
        ClientTrainer(create_model(model, 10, **mk), lr=0.1),
        _data(tfed, n, hw=hw, ch=ch), _cfg(FedConfig, n, rounds=commits),
        lifecycle_cfg=LifecycleConfig(**lc),
        attack=AttackConfig(**attack) if attack else None,
        defense=DefenseConfig(**defense) if defense else None,
        device="cpu", **c)
    return jeng, teng, init, commits


def _record_commits(jeng, teng, init):
    """Pre-build both engines' commit programs wrapped to record every
    committed model (run() only builds one when none is set)."""
    jrec, trec = [], []
    v = _to_torch(init)
    v = {k: v[k] for k in teng.trainer.spec.names}
    if jeng.defense is not None:
        d = jeng.defense
        jfn = jst.make_bucket_commit_fn(init, d.combine, d.trim_k,
                                        donate=False)
        tfn = tst.make_bucket_commit_fn(v, d.combine, d.trim_k)
    else:
        kw = dict(mode=jeng.staleness_mode, a=jeng.staleness_a,
                  b=jeng.staleness_b)
        jfn = jst.make_commit_fn(init, donate=False, **kw)
        tfn = tst.make_commit_fn(v, **kw)
    jeng._commit_fn, teng._commit_fn = _recorded(jfn, jrec), _recorded(
        tfn, trec)
    return jrec, trec


@pytest.mark.parametrize("case", sorted(LR_CASES))
def test_scheduler_matches_jax_on_lr(case):
    jeng, teng, init, commits = _engines("lr", LR_CASES[case])
    jrec, trec = _record_commits(jeng, teng, init)
    jeng.run(variables=jax.tree.map(jnp.asarray, init), rounds=commits)
    teng.run(variables=_to_torch(init), rounds=commits)
    assert teng.trace == jeng.trace
    assert len(trec) == len(jrec) == commits
    for i, (got, want) in enumerate(zip(trec, jrec)):
        _assert_model_close(got, want, f"commit {i}")
    assert teng.async_report() == jeng.async_report()
    kinds = {t[0] for t in teng.trace}
    if case == "churn":
        assert {"dispatch", "arrive", "crash", "rejoin", "commit"} <= kinds
    if case == "deadline":
        assert teng.commits_deadline > 0
        assert min(teng.occupancy_at_commit) < 4
    if case == "fedasync":
        assert set(teng.occupancy_at_commit) == {1}
        assert teng.async_report()["staleness_p95"] > 0.0
    if case == "defended":
        assert "quarantine" in kinds and "attack" in kinds
        assert teng.quarantine_attribution() == jeng.quarantine_attribution()


def test_scheduler_matches_jax_on_resnet18_gn():
    case = dict(n=4, buffer_k=2, concurrency=4, staleness="polynomial",
                commits=1, lc=dict(latency="lognormal", latency_scale=1.0,
                                   seed=1))
    jeng, teng, init, commits = _engines("resnet18_gn", case, hw=8, ch=3,
                                         nf=4)
    jrec, trec = _record_commits(jeng, teng, init)
    jeng.run(variables=jax.tree.map(jnp.asarray, init), rounds=1)
    teng.run(variables=_to_torch(init), rounds=1)
    assert teng.trace == jeng.trace
    _assert_model_close(trec[0], jrec[0], "commit 0")


def test_degenerate_config_is_fedavg_bitwise():
    """THE equivalence pin: zero latency and dropout, buffer_k = cohort,
    constant λ, mix 1 — the waves are FedAvgEngine's rounds (same cohorts,
    generators and rows) and the drain commit its finalize launch."""
    data, cfg = _data(tfed, 4, hw=8, ch=3), _cfg(FedConfig, 4, rounds=3)

    def trainer():
        return ClientTrainer(create_model("resnet18_gn", 10, num_filters=4),
                             lr=0.1)
    sync = FedAvgEngine(trainer(), data, cfg, device="cpu")
    v0 = sync.init_variables()
    want = sync.run(variables=dict(v0), rounds=3)
    eng = AsyncFedAvgEngine(trainer(), data, cfg, buffer_k=4, device="cpu")
    got = eng.run(variables=dict(v0), rounds=3)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    rep = eng.async_report()
    assert rep["committed_updates"] == 3 and rep["staleness_p95"] == 0.0
    assert rep["buffer_occupancy_mean"] == 4.0


def test_shardstore_cohorts_and_async_state_round_trip(tmp_path):
    """A duck-typed shard store (.cohort(ids)) gives the run the data's
    own cohorts; async_state() round-trips into a fresh engine, in memory
    and through a checkpoint on disk."""
    case = dict(LR_CASES["defended"], commits=2)
    _, teng, init, _ = _engines("lr", case)
    data = teng.data

    class Store:
        calls = 0

        def cohort(self, ids):
            Store.calls += 1
            return ({k: v[ids] for k, v in data.client_shards.items()},
                    data.client_num_samples[ids])

    _, other, _, _ = _engines("lr", case)
    other._shardstore = Store()
    a = teng.run(variables=_to_torch(init), rounds=2)
    b = other.run(variables=_to_torch(init), rounds=2)
    assert Store.calls > 0 and teng.trace == other.trace
    for k in a:
        assert torch.equal(a[k], b[k]), k
    state = teng.async_state()
    assert set(state) == {"buffer", "version", "registry", "defense"}
    _, fresh, _, _ = _engines("lr", case)
    fresh.load_async_state(state)
    again = fresh.async_state()
    for part in ("buffer", "registry", "defense"):
        for k in state[part]:
            np.testing.assert_array_equal(again[part][k], state[part][k])
    assert int(again["version"]) == 2
    ck = FedCheckpointManager(str(tmp_path / "async"))
    ck.save(1, a, (), extra_state=state)
    _, disk, _, _ = _engines("lr", case)
    _r, v, _s, extra = ck.restore(a, (), extra_template=disk.async_state())
    disk.load_async_state(extra)
    restored = disk.async_state()
    for part in ("buffer", "registry", "defense"):
        for k in state[part]:
            np.testing.assert_array_equal(restored[part][k], state[part][k])
    for k in a:
        assert torch.equal(v[k], a[k]), k


def test_scheduler_deadlock_dumps_once_and_raises(tmp_path):
    case = dict(n=4, buffer_k=4, commits=2,
                lc=dict(dropout_prob=1.0, rejoin_prob=0.0, seed=1))
    _, teng, init, _ = _engines("lr", case)
    obs.reset()
    obs.configure(str(tmp_path), install_signal=False, export_at_exit=False)
    try:
        with pytest.raises(AsyncSchedulerDeadlock,
                           match="async scheduler deadlock"):
            teng.run(variables=_to_torch(init), rounds=2)
        reasons = [json.load(open(d))["reason"] for d in obs.flight().dumps]
        assert reasons == ["async_scheduler_deadlock"]
    finally:
        obs.reset()


# -- the registry and the lifecycle draws -------------------------------------

def _registry_ops(mod):
    r = mod.ClientRegistry(10, shard_size=4, quarantine_ban_threshold=2)
    r.note_dispatch([0, 1, 5, 9], version=3)
    r.note_dispatch_one(2, 4)
    out = [r.note_return(1), r.note_return(7)]
    r.note_contribution(1, 2.0, 5)
    r.note_push(8, 1.0, 6)
    out.append(r.note_quarantine(5))
    out.append(r.note_quarantine(5))           # crosses the ban threshold
    r.note_crash(0, rejoins=True)
    r.note_crash(9, rejoins=False)
    r.note_dispatch([5], version=7)            # banned stays banned
    r.note_rejoin(0)
    r.ban([3])
    r.unban([3])
    out += [r.count_in_flight, r.count_crashed, r.count_dead,
            r.count_banned, r.count_free, r.nbytes]
    out += [r.status_of(np.arange(10)), r.outstanding_of(np.arange(10)),
            r.participation(np.arange(10)), r.quarantines(np.arange(10)),
            r.last_staleness(np.arange(10)), r.outstanding_ids(),
            r.free_ids(5), r.eligible_per_shard(), r.eligible_mask(1),
            r.total_participation()]
    st = r.state()
    fresh = mod.ClientRegistry(10, shard_size=4, quarantine_ban_threshold=2)
    fresh.load_state(st)
    fresh.reset_transient()
    out += [fresh.state(), len(fresh._shards), fresh.count_free]
    return out, st


def test_registry_is_jax_bitwise():
    got, st = _registry_ops(treg)
    want, jst_ = _registry_ops(jreg)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
                assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
        else:
            np.testing.assert_array_equal(a, b)
    for k in st:
        np.testing.assert_array_equal(st[k], jst_[k])
    assert treg.BYTES_PER_CLIENT == jreg.BYTES_PER_CLIENT == 29
    with pytest.raises(ValueError, match="shape mismatch"):
        treg.ClientRegistry(11, shard_size=4).load_state(st)


def test_lifecycle_draws_are_jax_bitwise():
    for kw in (dict(latency="lognormal", heterogeneity=0.5, dropout_prob=0.3,
                    seed=4),
               dict(latency="pareto", pareto_alpha=1.5, rejoin_prob=0.5,
                    seed=9)):
        t = tlife.ClientLifecycle(tlife.LifecycleConfig(**kw), 6)
        j = jlife.ClientLifecycle(jlife.LifecycleConfig(**kw), 6)
        np.testing.assert_array_equal(t.speed, j.speed)
        for i in range(30):
            c = i % 6
            assert t.draw_latency(c) == j.draw_latency(c)
            assert t.draw_crash(c) == j.draw_crash(c)
            assert t.draw_rejoin_delay(c) == j.draw_rejoin_delay(c)
    with pytest.raises(ValueError, match="latency mode"):
        tlife.LifecycleConfig(latency="uniform")


# -- the server and the messaging FSM -----------------------------------------

@pytest.mark.parametrize("mode", ["drain", "streaming", "defended"])
def test_server_fed_the_same_rows_commits_jax_model(mode):
    rs = np.random.RandomState(8)
    w, b = rs.randn(6, 5).astype(np.float32), rs.randn(3).astype(np.float32)
    n = 33
    rows = np.zeros((8, 512), np.float32)
    rows[:, :n] = rs.randn(8, n)
    rows[5, :n] *= 60.0                             # an outlier uplink
    dispatched = [0, 0, 0, 1, 0, 1, 1, 2]
    kw = dict(total_commits=3, buffer_k=3, rank=0, size=1, backend="INPROC",
              streaming=mode != "drain", redispatch=False,
              staleness_mode="polynomial")
    dkw = dict(norm_bound=30.0, screen=True, z_max=2.0, screen_warmup=2,
               buckets=3, combine="trimmed_mean", trim_k=1, seed=2)
    srv = AsyncServerManager(
        {"b": torch.tensor(b), "w": torch.tensor(w)}, router=InProcRouter(),
        defense=DefenseConfig(**dkw) if mode == "defended" else None,
        device="cpu", **kw)
    jsrv = JaxServer({"params": {"b": b, "w": w}}, router=JaxRouter(),
                     defense=JaxDefense(**dkw) if mode == "defended"
                     else None, **kw)
    try:
        for i in range(8):
            srv._ingest_row(1, rows[i], float(5 + i), dispatched[i])
            jsrv._ingest_row(1, rows[i, :n].copy(), float(5 + i),
                             dispatched[i])
            assert srv.version == jsrv.version
            assert srv.buffer.count == jsrv.buffer.count
        assert srv.staleness_seen == jsrv.staleness_seen
        assert srv.commit_sizes == jsrv.commit_sizes
        _assert_model_close(srv.variables, jsrv.variables)
        if mode == "defended":
            assert srv._admission.report() == jsrv._admission.report()
    finally:
        srv.finish()
        jsrv.finish()


def _lr_run(**kw):
    data = _data(tfed, 4)
    trainer = ClientTrainer(create_model("lr", 10), lr=0.1)
    return run_async_messaging(trainer, data, _cfg(FedConfig, 4),
                               worker_num=4, device="cpu", timeout_s=WAIT,
                               **kw)


@pytest.mark.parametrize("mode", ["streaming", "pool", "drain", "defended"])
def test_async_messaging_commits_as_jax(mode):
    kw = dict(buffer_k=2, total_commits=3, streaming=mode != "drain",
              ingest_pool=2 if mode == "pool" else 0)
    v, srv = _lr_run(defense=DefenseConfig(buckets=2) if mode == "defended"
                     else None, **kw)
    jdata = _data(jfed, 4)
    jv, jsrv = jax_run_async(
        JaxClientTrainer(jax_create_model("lr", 10), lr=0.1), jdata,
        _cfg(JaxFedConfig, 4), worker_num=4, timeout_s=WAIT,
        defense=JaxDefense(buckets=2) if mode == "defended" else None, **kw)
    for s in (srv, jsrv):
        assert s.version == 3 and s.commit_sizes == [2, 2, 2]
        assert s.updates_committed == 6 == len(s.staleness_seen)
        assert all(0.0 <= x <= 2.0 for x in s.staleness_seen)
    assert all(torch.isfinite(t).all() for t in v.values())
    assert srv.buffer.count <= 2
    if mode == "pool":
        assert obs.gauge("async_ingest_pool_depth").value == 0


def test_async_messaging_secure_rounds_commit():
    v, srv = _lr_run(buffer_k=4, total_commits=2, secure=SecAggConfig(seed=3))
    assert srv.version == 2 and srv.updates_committed == 8
    assert srv.secure_below_threshold == 0
    assert srv._secure.report()["below_threshold_rounds"] == 0
    assert all(torch.isfinite(t).all() for t in v.values())


def test_entry_points_refuse_what_waits_for_slice_6_and_default_to_cuda(
        monkeypatch, tmp_path):
    """The data-parallel centralized trainer (slice 6c-ii, ported) takes
    only a mesh of ranks, and the host-sharded serve simulation (slice
    6b, ported) names the channel it needs;
    saving to disk now works (an empty checkpoint directory resumes
    nothing); the entry points and the building blocks that hold state
    default to the card and raise without one."""
    with pytest.raises(ValueError, match="HostChannel"):
        run_serve_sim(100, commits=3, buffer_k=4, partition=(0, 2),
                      device="cpu")
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        CentralizedTrainer(ClientTrainer(create_model("lr", 10)),
                           _data(tfed, 2), _cfg(FedConfig, 2),
                           mesh=object(), device="cpu")
    srv = AsyncServerManager({"w": torch.zeros(2)}, 1, 1, size=1,
                             router=InProcRouter(), resume=True,
                             checkpoint_dir=str(tmp_path / "ck"),
                             device="cpu")
    assert srv.version == 0 and srv._ckpt.latest_round() is None
    srv.finish()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AsyncFedAvgEngine(ClientTrainer(create_model("lr", 10)),
                          _data(tfed, 2), _cfg(FedConfig, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_async_messaging(ClientTrainer(create_model("lr", 10)),
                            _data(tfed, 2), _cfg(FedConfig, 2), buffer_k=2)
    for make in (lambda: AsyncBuffer(2, 8),
                 lambda: UpdateAdmission(DefenseConfig(), 8),
                 lambda: SecureAggregator(SecAggConfig(), [1, 2], 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_import_scan_covers_the_new_modules():
    from tests.test_torch_fedavg import FORBIDDEN, _imported_modules
    files = [REPO / "fedml_tpu_torch" / p for p in (
        "async_/__init__.py", "async_/staleness.py", "async_/defense.py",
        "async_/adversary.py", "async_/lifecycle.py", "async_/scheduler.py",
        "async_/torture.py", "secure/__init__.py", "secure/secagg.py",
        "scale/__init__.py", "scale/registry.py", "scale/sampler.py",
        "scale/shardstore.py", "scale/serve.py", "parallel/prefetch.py",
        "utils/checkpoint.py", "utils/profiling.py")]
    assert set(files) <= set((REPO / "fedml_tpu_torch").rglob("*.py"))
    assert [(f.name, m) for f in files for m in _imported_modules(f)
            if m.split(".")[0] in FORBIDDEN] == []
