"""The serving spine of the PyTorch port against the JAX package.

* StreamingCohortSampler: host numpy draws, bitwise the JAX sampler's in
  the uniform, reservoir and stratified modes, on a registry with banned,
  in-flight and dead clients, across rounds and cohort sizes; the uniform
  mode on a fully eligible registry is ClientSampler's cohort.
* The shard stores: Materialized, Mmap (built by the port, and a
  directory the JAX package's `build` wrote) and Generator stores hand
  back cohorts bitwise the JAX stores' (values and weights), through the
  cache and through `prefetcher()`; the async scheduler on a store is
  bitwise its run on the resident stack.
* run_serve_sim at 5,000 clients and row_dim 64 (stratified, diurnal
  arrivals, dropout and bans): every report field of the trace (commits,
  contributors, crashes, bans, registry bytes, virtual time, sampler
  scratch) bitwise the JAX simulation's, and the committed row within
  rtol 1e-6 of JAX's (it is the same float32 arithmetic on the CPU).
* What waits for the multi-process slice refuses by name.
"""
import numpy as np
import pytest
import torch

import fedml_tpu.async_.staleness as jax_staleness
from fedml_tpu.data import federated as jfed
from fedml_tpu.scale import (GeneratorShardStore as JaxGeneratorStore,
                             MaterializedShardStore as JaxMaterializedStore,
                             MmapShardStore as JaxMmapStore)
from fedml_tpu.scale import ClientRegistry as JaxRegistry
from fedml_tpu.scale import StreamingCohortSampler as JaxSampler
from fedml_tpu.scale import run_serve_sim as jax_serve
from fedml_tpu.scale.arrivals import ArrivalConfig as JaxArrivalConfig
from fedml_tpu_torch.algorithms.centralized import CentralizedTrainer
from fedml_tpu_torch.async_ import AsyncFedAvgEngine
from fedml_tpu_torch.core.sampling import ClientSampler
from fedml_tpu_torch.core.trainer import ClientTrainer
from fedml_tpu_torch.data import federated as tfed
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.scale import (ArrivalConfig, ClientRegistry,
                                   GeneratorShardStore,
                                   MaterializedShardStore, MmapShardStore,
                                   StreamingCohortSampler, fold_partials,
                                   pack_partial, run_serve_sim, zero_partial)
from fedml_tpu_torch.utils.config import FedConfig


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

def _registries(n=3000, shard=256):
    regs = (JaxRegistry(n, shard_size=shard),
            ClientRegistry(n, shard_size=shard))
    for reg in regs:
        reg.ban(np.arange(0, n, 7))
        reg.note_dispatch(np.asarray([1, 2, 3, 500, 1500]), 0)
        for d in (10, 1000, 2999):
            reg.note_crash(d, rejoins=False)
    return regs


@pytest.mark.parametrize("mode", ["uniform", "reservoir", "stratified"])
@pytest.mark.parametrize("k", [16, 128])
def test_sampler_is_jax_bitwise(mode, k):
    jreg, treg = _registries()
    js = JaxSampler(jreg, k, seed=4, mode=mode)
    ts = StreamingCohortSampler(treg, k, seed=4, mode=mode)
    for r in range(5):
        a, b = js.sample(r), ts.sample(r)
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)
        # dispatching the draw moves both registries the same way
        jreg.note_dispatch(a, r)
        treg.note_dispatch(b, r)
    assert js.peak_scratch_bytes == ts.peak_scratch_bytes
    np.testing.assert_array_equal(jreg.eligible_per_shard(),
                                  treg.eligible_per_shard())


def test_sampler_uniform_on_a_full_registry_is_client_sampler():
    samp = StreamingCohortSampler(ClientRegistry(1000), 16, seed=9,
                                  mode="uniform")
    ref = ClientSampler(1000, 16)
    for r in range(6):
        np.testing.assert_array_equal(samp.sample(r), ref.sample_fast(r))
    with pytest.raises(ValueError, match="unknown sampler mode"):
        StreamingCohortSampler(ClientRegistry(10), 2, mode="bogus")


# ---------------------------------------------------------------------------
# the shard stores
# ---------------------------------------------------------------------------

def _data(mod, n_clients=12, per=8, bs=4, seed=0):
    rs = np.random.RandomState(seed)
    n = n_clients * per
    x = rs.rand(n, 8, 8, 3).astype(np.float32)
    y = rs.randint(0, 10, n).astype(np.int64)
    idx = {i: np.arange(i * per, i * per + per - i % 3)
           for i in range(n_clients)}
    ev = mod.build_eval_shard(x[:bs], y[:bs], bs)
    return mod.FederatedData(
        train_data_num=n, test_data_num=bs, train_global=ev, test_global=ev,
        client_shards=mod.build_client_shards(x, y, idx, bs),
        client_num_samples=np.asarray([len(v) for v in idx.values()],
                                      np.float32),
        test_client_shards=None, class_num=10, synthetic=True)


def _assert_cohort_is_jax(got, want):
    (gc, gw), (wc, ww) = got, want
    assert sorted(gc) == sorted(wc)
    for k in wc:
        assert gc[k].device.type == "cpu"
        np.testing.assert_array_equal(gc[k].numpy(), np.asarray(wc[k]))
    np.testing.assert_array_equal(gw.numpy(), np.asarray(ww))


COHORTS = ([0, 3, 7], [11, 2], [5], [0, 3])


def test_mmap_and_materialized_stores_are_jax_bitwise(tmp_path):
    jdata, tdata = _data(jfed), _data(tfed)
    jstore = JaxMmapStore.build(jdata, str(tmp_path / "jax"),
                                cache_clients=2)
    tstore = MmapShardStore.build(tdata, str(tmp_path / "port"),
                                  cache_clients=2, device="cpu")
    # the directory the JAX package wrote opens in the port unchanged
    from_jax = MmapShardStore(str(tmp_path / "jax"), device="cpu")
    tmat = MaterializedShardStore(tdata, device="cpu")
    jmat = JaxMaterializedStore(jdata)
    for ids in COHORTS:
        ids = np.asarray(ids)
        want = jstore.cohort(ids)
        _assert_cohort_is_jax(tstore.cohort(ids), want)
        _assert_cohort_is_jax(from_jax.cohort(ids), want)
        _assert_cohort_is_jax(tmat.cohort(ids), jmat.cohort(ids))
    for name in ("x", "y", "mask", "weights"):
        assert (open(tmp_path / "jax" / f"{name}.npy", "rb").read()
                == open(tmp_path / "port" / f"{name}.npy", "rb").read())


def test_generator_store_is_jax_bitwise_and_feeds_the_prefetcher():
    jstore = JaxGeneratorStore(1_000_000, seed=3, cache_clients=2)
    tstore = GeneratorShardStore(1_000_000, seed=3, cache_clients=2,
                                 device="cpu")
    cohorts = [np.asarray([999_999, 5]), np.asarray([123_456]),
               np.asarray([5, 7, 999_999])]
    with tstore.prefetcher(cohorts) as pf:
        got = [pf.get() for _ in cohorts]
    for ids, g in zip(cohorts, got):
        _assert_cohort_is_jax(g, jstore.cohort(ids))
    assert tstore._weight(42) == jstore._weight(42)
    with pytest.raises(IndexError, match="out of range"):
        tstore.client_shard(1_000_000)


def test_async_scheduler_on_a_store_is_its_resident_run(tmp_path):
    cfg = FedConfig(client_num_in_total=12, client_num_per_round=4,
                    comm_round=2, epochs=1, batch_size=4, lr=0.1,
                    frequency_of_the_test=100)
    data = _data(tfed)

    def run(store):
        eng = AsyncFedAvgEngine(
            ClientTrainer(create_model("lr", 10, input_dim=8 * 8 * 3),
                          lr=0.1), data, cfg, buffer_k=4, concurrency=4,
            shardstore=store, device="cpu")
        return eng.run(rounds=2), eng.trace

    v_stack, t_stack = run(None)
    v_store, t_store = run(MmapShardStore.build(
        data, str(tmp_path / "sched"), device="cpu"))
    assert t_stack == t_store
    for k in v_stack:
        assert torch.equal(v_stack[k], v_store[k]), k


# ---------------------------------------------------------------------------
# the serve simulation
# ---------------------------------------------------------------------------

TRACE_FIELDS = ("population", "local_population", "partition", "commits",
                "committed_updates", "distinct_contributors",
                "max_client_participation", "buffer_k", "concurrency",
                "row_dim", "sampler_mode", "sampler_peak_scratch_bytes",
                "arrival_mode", "virtual_time_s", "mean_arrival_rate",
                "registry_bytes", "registry_bytes_per_client",
                "registry_shards_allocated", "crashed", "banned", "seed")


@pytest.mark.parametrize("mode,arrival", [("stratified", "diurnal"),
                                          ("reservoir", "constant")])
def test_serve_sim_trace_is_jax_bitwise(mode, arrival, monkeypatch):
    committed = {}
    make = jax_staleness.make_stream_commit_fn

    def recording(template, donate=False):
        fn = make(template, donate=donate)

        def commit(*a):
            out = fn(*a)
            committed["w"] = np.asarray(out[0]["w"])
            return out
        return commit

    monkeypatch.setattr(jax_staleness, "make_stream_commit_fn", recording)
    kw = dict(commits=6, warmup_commits=2, buffer_k=8, row_dim=64,
              sampler_mode=mode, dropout_prob=0.05, banned_frac=0.01,
              seed=3)
    want = jax_serve(5000, arrival=JaxArrivalConfig(mode=arrival,
                                                    rate=200.0, seed=3),
                     **kw)
    got = run_serve_sim(5000, arrival=ArrivalConfig(mode=arrival,
                                                    rate=200.0, seed=3),
                        device="cpu", keep_variables=True, **kw)
    for f in TRACE_FIELDS:
        assert got[f] == want[f], f
    assert set(want) - {"elastic"} <= set(got)
    assert got["crashed"] > 0 and got["banned"] == 50
    np.testing.assert_allclose(got["variables"]["w"].numpy(),
                               committed["w"], rtol=1e-6, atol=0)
    # one seed, one trace: a second port run hashes the same events
    again = run_serve_sim(5000, arrival=ArrivalConfig(mode=arrival,
                                                      rate=200.0, seed=3),
                          device="cpu", **kw)
    assert again["trace_digest"] == got["trace_digest"]
    assert again["committed_digest"] == got["committed_digest"]


def test_partials_pack_and_fold_in_item_order():
    rs = np.random.RandomState(0)
    accs = [rs.randn(16).astype(np.float32) for _ in range(3)]
    docs = [pack_partial(torch.from_numpy(a), 2.0 + i)
            for i, a in enumerate(accs)]
    acc, wsum = fold_partials(docs + [zero_partial(16)], 16, device="cpu")
    want = np.zeros(16, np.float32)
    for a in accs:
        want += a
    np.testing.assert_array_equal(acc.numpy(), want)
    assert float(wsum) == 9.0


def test_multi_process_serving_and_mesh_refuse_by_name():
    # host-sharded serving is ported: a world above 1 needs its channel,
    # named; the elastic report block rides a one-process run too
    with pytest.raises(ValueError, match="HostChannel"):
        run_serve_sim(100, commits=3, buffer_k=4, partition=(0, 2),
                      device="cpu")
    rep = run_serve_sim(100, commits=3, buffer_k=4, elastic=True,
                        device="cpu")
    assert rep["elastic"]["lanes"] == [0] and rep["elastic"]["epoch"] == 0
    with pytest.raises(ValueError, match="warmup_commits"):
        run_serve_sim(100, commits=2, warmup_commits=2, device="cpu")
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        CentralizedTrainer(ClientTrainer(create_model("lr", 10)),
                           _data(tfed), FedConfig(), mesh=object(),
                           device="cpu")
