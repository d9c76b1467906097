"""Upload prefetch, block-streamed rounds and the two-phase order
statistics of the PyTorch port, against the JAX package and against the
port's own streaming and resident rounds.

* Prefetcher, InlineFetcher and AsyncValue: ordering, the depth bound,
  error propagation and the close-mid-stream join (the JAX package's
  ``tests/test_prefetch.py`` cases).
* Two rounds of the block-streamed MeshFedAvg, FedProx, FedOpt, FedNova
  and norm_clip engines (LR on 8x8x3, 6 clients in blocks of 4, so the
  last block carries two zero-weight pad lanes) against the JAX engines'
  block-streamed rounds on a one-device mesh.  Tolerance: rtol 2e-4 /
  atol 2e-5, the JAX package's own block-vs-streaming tolerance.
* Port against port, ResNet-18-GN num_filters 4: with the block a
  multiple of the chunk the block-streamed round is bitwise the
  streaming round (FedAvg, FedOpt, FedProx, norm_clip; FedNova within
  1e-6, its sum of w*tau is summed per block); prefetch on and off are
  bitwise; a padded last block is bitwise the streaming round too.
* Two-phase order statistics: median and trimmed mean bitwise the port's
  resident defense (several parameter slices); krum's scores from the
  Gram matrix within rtol 2e-5 of the resident scores and its selection
  equal to the resident round's and to JAX's two-phase round's.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core.trainer import ClientTrainer as JaxClientTrainer
from fedml_tpu.data import federated as jfed
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.parallel import engine as jengine
from fedml_tpu.parallel.mesh import make_mesh
from fedml_tpu.utils import profiling as jax_profiling
from fedml_tpu.utils.config import FedConfig as JaxFedConfig
from fedml_tpu_torch.convert import flax_to_torch
from fedml_tpu_torch.core import robust as robust_ops
from fedml_tpu_torch.core.trainer import ClientTrainer
from fedml_tpu_torch.data import federated as tfed
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.parallel import engine as tengine
from fedml_tpu_torch.parallel.prefetch import (AsyncValue, InlineFetcher,
                                               Prefetcher)
from fedml_tpu_torch.utils import profiling
from fedml_tpu_torch.utils.config import FedConfig


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("h2d-prefetch") and t.is_alive()]


# ---------------------------------------------------------------------------
# the pipeline's contract
# ---------------------------------------------------------------------------

def test_prefetcher_order_and_depth_bound():
    produced, consumed = [], [0]

    def produce(i):
        produced.append((i, consumed[0]))
        return i * 10

    with Prefetcher(produce, range(6)) as pf:
        for i in range(6):
            assert pf.get() == i * 10
            consumed[0] += 1
    assert [p[0] for p in produced] == list(range(6))
    assert all(i - c <= 1 for i, c in produced), produced
    assert not _prefetch_threads()


def test_prefetcher_producer_error_propagates_and_joins():
    def produce(i):
        if i == 2:
            raise ValueError("boom-upload")
        return i

    pf = Prefetcher(produce, range(5))
    assert pf.get() == 0 and pf.get() == 1
    with pytest.raises(ValueError, match="boom-upload"):
        pf.get()
    pf.close()
    assert not _prefetch_threads()


def test_prefetcher_close_mid_stream_joins_and_drops():
    produced = []
    pf = Prefetcher(lambda i: produced.append(i) or i, range(100))
    assert pf.get() == 0
    pf.close()
    assert not _prefetch_threads()
    assert len(produced) <= 3, produced
    with pytest.raises(ValueError, match="double buffer"):
        Prefetcher(lambda i: i, range(2), depth=1)


def test_inline_fetcher_and_async_value():
    produced = []
    f = InlineFetcher(lambda i: produced.append(i) or i, range(3))
    assert produced == []
    assert f.get() == 0 and produced == [0]
    assert f.get() == 1 and produced == [0, 1]
    f.close()
    v = AsyncValue(lambda a, b: {"x": torch.full((2,), a + b)}, 1, 2)
    assert torch.equal(v.result()["x"], torch.full((2,), 3))
    assert v.result()["x"] is v.result()["x"]        # fenced once
    bad = AsyncValue(lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        bad.result()


def test_transfer_stats_and_step_timer_are_jax(tmp_path):
    for up in (0.0, 0.5, 1.0, 2.0):
        for wait in (0.0, 0.25, 1.0, 3.0):
            assert profiling._overlap_fraction(up, wait) == \
                jax_profiling._overlap_fraction(up, wait)
    stats, jstats = (profiling.TransferOverlapStats(),
                     jax_profiling.TransferOverlapStats())
    for st in (stats, jstats):
        st.round_start()
        with st.uploading():
            st.add_h2d_bytes(1024)
        with st.waiting():
            pass
        st.round_start()              # closes the open window
        st.round_end()
    assert sorted(stats.report()) == sorted(jstats.report())
    assert sorted(stats.rounds[0]) == sorted(jstats.rounds[0])
    assert stats.h2d_bytes == 1024 and len(stats.rounds) == 2
    assert stats.rounds[1]["h2d_bytes"] == 0
    assert stats.round_end() is None
    timer = profiling.StepTimer()
    with timer.phase("train"):
        pass
    assert list(timer.report()) == ["train_mean_s"]
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.annotate("fedml_step"):
            torch.ones(4).sum()
    assert "fedml_step" in (tmp_path / "prof" / "trace.chrome.json"
                            ).read_text()


# ---------------------------------------------------------------------------
# block-streamed rounds against the JAX package
# ---------------------------------------------------------------------------

def _data(mod, n_clients=6, per=8, bs=4, hw=8, seed=0):
    rs = np.random.RandomState(seed)
    n = n_clients * per
    x = rs.rand(n, hw, hw, 3).astype(np.float32)
    y = rs.randint(0, 10, n).astype(np.int64)
    # uneven shards: per-client sample counts (and FedNova's tau) differ
    idx = {i: np.arange(i * per, i * per + per - (i % 3))
           for i in range(n_clients)}
    ev = mod.build_eval_shard(x[:bs], y[:bs], bs)
    return mod.FederatedData(
        train_data_num=n, test_data_num=bs, train_global=ev, test_global=ev,
        client_shards=mod.build_client_shards(x, y, idx, bs),
        client_num_samples=np.asarray([len(v) for v in idx.values()],
                                      np.float32),
        test_client_shards=None, class_num=10, synthetic=True)


def _cfg(cls, n=6, per_round=6, **kw):
    return cls(client_num_in_total=n, client_num_per_round=per_round,
               comm_round=2, epochs=1, batch_size=4, lr=0.1,
               frequency_of_the_test=100, **kw)


ENGINES = {
    "fedavg": ("MeshFedAvgEngine", {}, {}),
    "fedprox": ("MeshFedProxEngine", {"prox_mu": 0.1}, {}),
    "fedopt": ("MeshFedOptEngine", {"server_optimizer": "adam",
                                    "server_lr": 0.05}, {}),
    "fednova": ("MeshFedNovaEngine", {}, {}),
    "norm_clip": ("MeshRobustEngine", {"norm_bound": 0.3},
                  {"defense": "norm_clip"}),
}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_blockstream_rounds_match_jax(name):
    cls, cfg_kw, eng_kw = ENGINES[name]
    jcfg, tcfg = _cfg(JaxFedConfig, **cfg_kw), _cfg(FedConfig, **cfg_kw)
    jeng = getattr(jengine, cls)(
        JaxClientTrainer(jax_create_model("lr", 10), lr=0.1), _data(jfed),
        jcfg, mesh=make_mesh(1), donate=False, chunk=2, stream_block=4,
        **eng_kw)
    v0 = jeng.init_variables()
    want = flax_to_torch(jax.tree.map(
        np.asarray, jeng.run(variables=jax.tree.map(jnp.copy, v0),
                             rounds=2)))
    teng = getattr(tengine, cls)(
        ClientTrainer(create_model("lr", 10, input_dim=8 * 8 * 3), lr=0.1),
        _data(tfed), tcfg, chunk=2, stream_block=4, device="cpu", **eng_kw)
    assert teng.program_family.endswith("_blockstream")
    assert teng.round_fn.inner == teng._blockstream_round_fn()
    got = teng.run(variables=flax_to_torch(jax.tree.map(np.asarray, v0)),
                   rounds=2)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    rec = teng.transfer_stats.rounds
    assert len(rec) == 2 and rec[-1]["h2d_bytes"] > 0
    assert 0.0 <= rec[-1]["overlap_fraction"] <= 1.0
    # the double buffer: never more than two blocks uploaded at once
    one_block = max(rec[-1]["h2d_bytes"] // 2, 1)
    assert teng.peak_resident_block_bytes <= 2 * one_block
    assert teng.resident_block_bytes == 0
    assert not _prefetch_threads()


# ---------------------------------------------------------------------------
# port against port: block == streaming, prefetch on == off
# ---------------------------------------------------------------------------

def _resnet_engine(cls, n=4, per_round=4, **kw):
    fields = {f.name for f in dataclasses.fields(FedConfig)}
    cfg_kw = {k: kw.pop(k) for k in list(kw) if k in fields}
    return getattr(tengine, cls)(
        ClientTrainer(create_model("resnet18_gn", 10, num_filters=4),
                      lr=0.1), _data(tfed, n_clients=n, per=6),
        _cfg(FedConfig, n=n, per_round=per_round, **cfg_kw), chunk=2,
        device="cpu", **kw)


def _bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", ["fedavg", "fedopt", "fedprox", "norm_clip",
                                  "fednova"])
def test_blockstream_is_the_streaming_round_bitwise(name):
    cls, cfg_kw, eng_kw = ENGINES[name]
    stream = _resnet_engine(cls, **cfg_kw, **eng_kw)
    v0 = stream.init_variables()
    want = stream.run(variables=dict(v0), rounds=1)
    block = _resnet_engine(cls, stream_block=2, **cfg_kw, **eng_kw)
    got = block.run(variables=dict(v0), rounds=1)
    if name == "fednova":
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    else:
        _bitwise(got, want)


def test_padded_last_block_is_the_streaming_round():
    """3 clients in blocks of 2: the last block pads with a zero-weight
    repeat of the first client, which adds +-0."""
    stream = _resnet_engine("MeshFedAvgEngine", n=3, per_round=3)
    v0 = stream.init_variables()
    want = stream.run(variables=dict(v0), rounds=1)
    block = _resnet_engine("MeshFedAvgEngine", n=3, per_round=3,
                           stream_block=2)
    ids, wmask, spans = block._pad_to_block(np.arange(3), np.ones(3,
                                                                np.float32))
    assert ids.tolist() == [0, 1, 2, 0] and wmask.tolist() == [1, 1, 1, 0]
    assert spans == [(0, 2), (2, 4)]
    _bitwise(block.run(variables=dict(v0), rounds=1), want)


@pytest.mark.parametrize("mode", ["stream_block", "streaming"])
def test_prefetch_on_and_off_are_bitwise(mode):
    kw = {"stream_block": 2} if mode == "stream_block" else {
        "streaming": True}
    on = _resnet_engine("MeshFedAvgEngine", n=6, per_round=4, **kw)
    v0 = on.init_variables()
    off = _resnet_engine("MeshFedAvgEngine", n=6, per_round=4,
                         prefetch=False, **kw)
    _bitwise(on.run(variables=dict(v0), rounds=2),
             off.run(variables=dict(v0), rounds=2))
    assert on._prefetched is None and off._prefetched is None
    assert on.transfer_stats.h2d_bytes == off.transfer_stats.h2d_bytes > 0
    assert not _prefetch_threads()


def test_streaming_is_the_plain_round_bitwise():
    plain = _resnet_engine("MeshFedAvgEngine", n=6, per_round=4)
    v0 = plain.init_variables()
    stream = _resnet_engine("MeshFedAvgEngine", n=6, per_round=4,
                            streaming=True)
    _bitwise(plain.run(variables=dict(v0), rounds=2),
             stream.run(variables=dict(v0), rounds=2))
    assert stream.program_family == plain.program_family == \
        "fedavg_streaming"


def test_blockstream_error_mid_round_joins_the_worker(monkeypatch):
    eng = _resnet_engine("MeshFedAvgEngine", stream_block=2)
    v0 = eng.init_variables()

    def boom(*a, **k):
        raise RuntimeError("block step failed")

    monkeypatch.setattr(eng, "_accumulate", boom)
    with pytest.raises(RuntimeError, match="block step failed"):
        eng.run(variables=dict(v0), rounds=1)
    assert not _prefetch_threads()
    assert eng.transfer_stats.rounds        # the window closed


# ---------------------------------------------------------------------------
# two-phase order statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("defense", ["median", "trimmed_mean", "krum",
                                     "multi_krum"])
def test_two_phase_orderstat_is_the_resident_defense(defense):
    res = _resnet_engine("MeshRobustEngine", defense=defense, n_byzantine=1)
    v0 = res.init_variables()
    want = res.run(variables=dict(v0), rounds=1)
    blk = _resnet_engine("MeshRobustEngine", defense=defense, n_byzantine=1,
                         stream_block=2, param_block_bytes=4 * 4 * 1000)
    assert blk.program_family == "robust_blockstream"
    got = blk.run(variables=dict(v0), rounds=1)
    r = blk.trainer.train_len
    assert blk.orderstat_host_bytes == 4 * r * 4
    assert -(-r // 1000) >= 3                    # several param slices
    if defense in ("median", "trimmed_mean", "krum"):
        _bitwise(got, want)
    else:
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)


def test_two_phase_krum_scores_and_selection_match_jax():
    """Krum's scores from G = sum_b X_b X_b^T against the resident scores
    (rtol 2e-5), and the selected client against JAX's two-phase round."""
    jcfg, tcfg = _cfg(JaxFedConfig, n=4, per_round=4), _cfg(FedConfig, n=4,
                                                           per_round=4)
    jeng = jengine.MeshRobustEngine(
        JaxClientTrainer(jax_create_model("lr", 10), lr=0.1),
        _data(jfed, n_clients=4), jcfg, defense="krum", n_byzantine=1,
        mesh=make_mesh(1), donate=False, chunk=2, stream_block=2,
        param_block_bytes=4 * 4 * 256)
    v0 = jeng.init_variables()
    want = flax_to_torch(jax.tree.map(np.asarray, jeng.run(
        variables=jax.tree.map(jnp.copy, v0), rounds=1)))
    teng = tengine.MeshRobustEngine(
        ClientTrainer(create_model("lr", 10, input_dim=8 * 8 * 3), lr=0.1),
        _data(tfed, n_clients=4), tcfg, defense="krum", n_byzantine=1,
        chunk=2, stream_block=2, param_block_bytes=4 * 4 * 256,
        device="cpu")
    tv0 = flax_to_torch(jax.tree.map(np.asarray, v0))
    got = teng.run(variables=dict(tv0), rounds=1)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    # the resident matrix the scores come from
    res = tengine.MeshRobustEngine(
        ClientTrainer(create_model("lr", 10, input_dim=8 * 8 * 3), lr=0.1),
        _data(tfed, n_clients=4), tcfg, defense="krum", n_byzantine=1,
        chunk=2, device="cpu")
    cohort, w = res.stream_cohort(0)
    *_, flats = res._chunked(res._local_flat(tv0), cohort, w, 0,
                             fold_fn=None, emit_flat_params=True)
    flats = flats[:, :res.trainer.train_len]
    want_scores = robust_ops.krum_scores_flat(flats, 1).numpy()
    np.testing.assert_allclose(teng.last_krum_scores, want_scores,
                               rtol=2e-5)
    assert int(np.argmin(teng.last_krum_scores)) == int(np.argmin(
        want_scores))


def test_two_phase_orderstat_refuses_a_padded_cohort():
    with pytest.raises(ValueError, match="padded lanes"):
        _resnet_engine("MeshRobustEngine", n=3, per_round=3,
                       defense="median", stream_block=2)
    # norm_clip is linear: a padded last block is fine
    eng = _resnet_engine("MeshRobustEngine", n=3, per_round=3,
                         defense="norm_clip", norm_bound=0.3,
                         stream_block=2)
    assert eng.round_fn.inner == eng._round_blockstream_orderstat
