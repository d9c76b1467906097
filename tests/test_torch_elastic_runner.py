"""The port's ElasticRunner (fedml_tpu_torch/parallel/multihost.py) against
the JAX package's, and against its own clean runs, bitwise.

* One rank, from JAX's init carried across with `convert`: one elastic
  round of LR (streaming and resident) and of ResNet-18-GN at
  num_filters 4 (f32) against `fedml_tpu`'s ElasticRunner, within the
  tolerances of tests/test_torch_twolevel.py (LR rtol 1e-5 / atol 1e-6;
  ResNet rtol 1e-3 / atol 1e-4), and bitwise the port's fail-fast
  MultihostRunner on the same blocks.
* 3 thread ranks over 4 blocks (unequal shares): rank 1 closes its
  channel in the middle of a round, the survivors re-adopt its block, a
  fresh rank 1 rejoins through the snapshot, and every rank that
  finishes commits the clean 1-rank run's bits.  FedAvg streaming and
  resident (where a rank's resident stacks follow ownership), norm_clip
  with weak-DP noise (the noise generator's state rides the snapshot;
  without it the rejoiner's draw would differ), and FedOpt (its Adam
  state rides the snapshot).
* The topk_ef reconstruction mirror rides the snapshot.
* One spawned LR mh_worker cluster, 3 ranks under the launcher's elastic
  respawn policy with rank 1 killed after round 0: the survivors and the
  rejoined rank commit the clean run's digest.
"""
import copy
import json
import logging
import os
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core.trainer import ClientTrainer as JaxClientTrainer
from fedml_tpu.data import federated as jfed
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models.resnet_gn import ResNet18GN as JaxResNet18GN
from fedml_tpu.parallel import engine as jengine
from fedml_tpu.parallel import multihost as jmh
from fedml_tpu.parallel.mesh import make_mesh
from fedml_tpu.utils.config import FedConfig as JaxFedConfig
from fedml_tpu_torch.convert import flax_to_torch
from fedml_tpu_torch.parallel import mh_worker
from fedml_tpu_torch.parallel import multihost as tmh
from fedml_tpu_torch.parallel.carry_codec import TopKEFCarryCodec
from tests.test_torch_stream import _data
from tests.test_torch_transports import free_base_port
from tests.test_torch_twolevel import N_CLIENTS, HW, _cfg, _engine

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _bitwise(a, b):
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# one rank against JAX's ElasticRunner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,streaming", [("lr", True), ("lr", False),
                                             ("resnet", True)])
def test_one_rank_elastic_round_matches_jax(model, streaming):
    jnet = (jax_create_model("lr", 10) if model == "lr"
            else JaxResNet18GN(num_classes=10, num_filters=4))
    jeng = jengine.MeshFedAvgEngine(
        JaxClientTrainer(jnet, lr=0.1),
        _data(jfed, n_clients=N_CLIENTS, hw=HW), _cfg(JaxFedConfig),
        mesh=make_mesh(1), donate=False, chunk=2, streaming=streaming)
    v0 = jeng.init_variables()
    jrun = jmh.ElasticRunner(jeng, jmh.MultihostContext.single(),
                             n_blocks=2)
    want = flax_to_torch(jax.tree.map(
        np.asarray, jrun.run(variables=jax.tree.map(jnp.copy, v0),
                             rounds=1)))
    start = flax_to_torch(jax.tree.map(np.asarray, v0))
    teng = _engine("fedavg", model=model, streaming=streaming)
    trun = tmh.ElasticRunner(teng, tmh.MultihostContext.single(),
                             n_blocks=2)
    got = trun.run(variables=copy.deepcopy(start), rounds=1)
    trun.close()
    tol = (dict(rtol=1e-5, atol=1e-6) if model == "lr"
           else dict(rtol=1e-3, atol=1e-4))
    assert sorted(got) == sorted(want)
    for k in want:
        if "kernel" in k or "weight" in k:
            assert not torch.equal(got[k], start[k]), f"{k} never moved"
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **tol)
    jdoc, tdoc = json.loads(jrun._config_doc()), json.loads(trun._config_doc())
    jdoc.pop("family"), tdoc.pop("family")
    assert tdoc == jdoc
    rep = trun.report()
    assert rep["elastic"] and rep["epoch"] == 0 and rep["view_changes"] == 0
    assert rep["computed"] == [[0, 0], [0, 1]] and rep["readopted"] == []
    # the elastic round is the fail-fast round on the same blocks, bitwise
    ff = tmh.MultihostRunner(_engine("fedavg", model=model,
                                     streaming=streaming),
                             tmh.MultihostContext.single(), n_blocks=2)
    _bitwise(got, ff.run(variables=copy.deepcopy(start), rounds=1))


def test_runner_refusals():
    with pytest.raises(ValueError, match="ElasticChannel"):
        tmh.ElasticRunner(_engine("fedavg"), tmh.MultihostContext.single(),
                          channel=object())
    ch = tmh.ElasticChannel(tmh.MultihostContext.single(), n_items=3)
    with pytest.raises(ValueError, match="n_items"):
        tmh.ElasticRunner(_engine("fedavg"), tmh.MultihostContext.single(),
                          n_blocks=2, channel=ch)
    # the elastic runner owns blocks through the view: 4 blocks over 3
    # ranks is allowed, the fail-fast runner's tiling is not
    with pytest.raises(ValueError, match="multiple of the process count"):
        tmh.MultihostRunner(_engine("fedavg"),
                            tmh.MultihostContext(1, 3, "localhost:1"),
                            n_blocks=4)
    r = tmh.ElasticRunner(_engine("fedavg"),
                          tmh.MultihostContext(1, 3, "localhost:1"),
                          n_blocks=4, channel=tmh.ElasticChannel(
                              tmh.MultihostContext.single(), n_items=4))
    assert r.n_blocks == 4


# ---------------------------------------------------------------------------
# 3 thread ranks: a death mid-round and a rejoin, bitwise the clean run
# ---------------------------------------------------------------------------

class _Died(Exception):
    pass


def _kill_and_rejoin(name, streaming, v0, rounds=4, n_blocks=4):
    """Ranks 0-2 on threads; rank 1 closes its channel in round 1 after
    computing its block, and a fresh rank 1 rejoins.  Returns each
    finishing runner's (variables, report)."""
    port = free_base_port(1)
    out, errs = {}, []
    joined = threading.Event()

    def runner(r, rejoin=False, on_round_end=None):
        ctx = tmh.MultihostContext(rank=r, world=3,
                                   coordinator=f"localhost:{port}")
        run = tmh.ElasticRunner(
            _engine(name, streaming=streaming), ctx, n_blocks=n_blocks,
            timeout_s=60, connect_timeout_s=30, hb_interval_s=0.1,
            hb_timeout_s=5.0, on_round_end=on_round_end)
        run._channel = tmh.ElasticChannel(
            ctx, n_items=n_blocks, config_digest=run.config_digest(),
            timeout_s=60, connect_timeout_s=30, hb_interval_s=0.1,
            hb_timeout_s=5.0, rejoin=rejoin)
        run._owns_channel = True
        return run

    def pace(rnd):
        time.sleep(0.4)

    def survivor(r):
        def fn():
            run = runner(r, on_round_end=pace)
            try:
                out[r] = (run.run(variables=copy.deepcopy(v0),
                                  rounds=rounds), run.report())
            finally:
                run.close()
        return fn

    def mortal():
        run = runner(1)
        real = run.channel.exchange

        def exchange(rnd, *a, **kw):
            if rnd == 1:                # its block is computed: die now
                run.channel.close()
                raise _Died()
            return real(rnd, *a, **kw)

        run.channel.exchange = exchange
        try:
            run.run(variables=copy.deepcopy(v0), rounds=rounds)
        except _Died:
            out["mortal"] = run.report()
        finally:
            joined.set()

    def rejoiner():
        joined.wait(60)
        time.sleep(0.3)
        run = runner(1, rejoin=True, on_round_end=pace)
        try:
            out["rejoiner"] = (run.run(rounds=rounds, rejoin=True),
                               run.report())
        finally:
            run.close()

    fns = [survivor(0), mortal, survivor(2), rejoiner]

    def wrap(fn):
        def go():
            try:
                fn()
            except BaseException as e:          # noqa: BLE001 - reported
                errs.append(e)
        return go

    ts = [threading.Thread(target=wrap(f), daemon=True) for f in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    assert not any(t.is_alive() for t in ts), "a rank hung"
    assert not errs, errs
    return out


@pytest.mark.parametrize("name,streaming", [("fedavg", True),
                                            ("fedavg", False),
                                            ("norm_clip", True),
                                            ("fedopt", True)])
def test_kill_and_rejoin_commit_the_clean_bits(name, streaming):
    eng = _engine(name, streaming=streaming)
    v0 = eng.init_variables()
    clean = tmh.ElasticRunner(eng, tmh.MultihostContext.single(),
                              n_blocks=4)
    want = clean.run(variables=copy.deepcopy(v0), rounds=4)
    out = _kill_and_rejoin(name, streaming, v0)
    for who in (0, 2, "rejoiner"):
        _bitwise(out[who][0], want)
    rep0, rep2 = out[0][1], out[2][1]
    rej = out["rejoiner"][1]
    # the death and the readmission each moved the epoch
    assert rep0["view_changes"] >= 2 and rep0["epoch"] >= 2
    assert [e["dead"] for e in rep0["view_events"] if "dead" in e] == [[1]]
    assert rep0["view_change_latency_s"] > 0
    # block 2 (rank 1's) was recomputed by rank 2 in round 1; the mortal
    # computed it too, but never shipped it
    assert rep2["readopted"] == [[1, 2]] and rep0["readopted"] == []
    assert [1, 2] in out["mortal"]["computed"]
    assert 1 < rej["rejoined_at_round"] < 4
    # after the rejoin, ownership is the 3-rank view again
    assert rej["members"] == [0, 1, 2]
    assert [b for rnd, b in rej["computed"]] == [2] * (
        4 - rej["rejoined_at_round"])
    if not streaming:
        # resident stacks follow ownership: rank 2 adopted block 2 and
        # dropped it when rank 1 came back
        assert rep2["resident_blocks"] == [3]
        assert rep0["resident_blocks"] == [0, 1]
        assert rej["resident_blocks"] == [2]


def test_norm_clip_rejoiner_needs_the_noise_generator_state():
    """The norm_clip snapshot carries the weak-DP noise generator: a
    rejoiner that installed the model but kept its fresh generator would
    add different noise than the survivors (this pins that the state is
    needed, so the snapshot cannot drop it silently)."""
    eng = _engine("norm_clip")
    v0 = eng.init_variables()
    run = tmh.ElasticRunner(eng, tmh.MultihostContext.single(), n_blocks=4)
    run.run(variables=copy.deepcopy(v0), rounds=2)
    state = eng.server_init(v0)
    blob = run._snapshot_blob(2, v0, state)
    fresh = tmh.ElasticRunner(_engine("norm_clip"),
                              tmh.MultihostContext.single(), n_blocks=4)
    _v, _s, rnd = fresh._install_snapshot(blob)
    assert rnd == 2
    assert torch.equal(fresh.engine.noise_generator.get_state(),
                       eng.noise_generator.get_state())
    assert not torch.equal(
        _engine("norm_clip").noise_generator.get_state(),
        eng.noise_generator.get_state())


def test_rejoin_snapshot_carries_topk_ef_mirror():
    coord = object.__new__(tmh.ElasticRunner)
    coord.codec = TopKEFCarryCodec()
    coord.engine = _engine("fedavg")
    rng = np.random.default_rng(7)
    vec = (3.0 * rng.standard_normal(96)).astype(np.float32)
    for _ in range(5):
        vec = (vec + 0.05 * rng.standard_normal(96)).astype(np.float32)
        for b in (0, 1):
            coord.codec.integrate(b, coord.codec.encode(b, vec))
    blob = coord._snapshot_blob(5, {"w": torch.zeros(2)}, ())
    rejoiner = object.__new__(tmh.ElasticRunner)
    rejoiner.codec = TopKEFCarryCodec()
    rejoiner.engine = _engine("fedavg")
    _v, _s, rnd = rejoiner._install_snapshot(blob)
    assert rnd == 5
    nxt = (vec + 0.05 * rng.standard_normal(96)).astype(np.float32)
    for b in (0, 1):
        buf = coord.codec.encode(b, nxt)
        assert rejoiner.codec.encode(b, nxt) == buf
        np.testing.assert_array_equal(
            rejoiner.codec.integrate(b, buf).view(np.uint32),
            coord.codec.integrate(b, buf).view(np.uint32))


# ---------------------------------------------------------------------------
# the spawned LR cluster: kill, respawn, rejoin
# ---------------------------------------------------------------------------

MH_ELASTIC = {"clients": 16, "spc": 24, "dim": 8, "classes": 4,
              "k_per_round": 8, "n_blocks": 4, "rounds": 6, "warmup": 0,
              "seed": 0, "modes": ["streaming", "resident"],
              "device": "cpu", "elastic": True, "channel_timeout_s": 60.0,
              "hb_timeout_s": 5.0}


def test_spawned_elastic_cluster_kill_respawn_bitwise(tmp_path, capsys,
                                                      caplog):
    clean = tmp_path / "clean.json"
    clean.write_text(json.dumps(MH_ELASTIC))
    assert mh_worker.main([str(clean)]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert want["digests"]["streaming"] == want["digests"]["resident"]
    cfg = tmp_path / "kill.json"
    cfg.write_text(json.dumps({**MH_ELASTIC, "die_rank": 1,
                               "die_at_round": 0, "round_sleep_s": 1.0}))
    env = {"OMP_NUM_THREADS": "2",
           "PYTHONPATH": str(REPO) + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    with caplog.at_level(logging.WARNING):
        outs, rep = tmh.spawn_cluster_report(
            [sys.executable, "-m", "fedml_tpu_torch.parallel.mh_worker",
             str(cfg)], 3, env=env, timeout_s=240, elastic=True,
            respawn=True, coordinator_port=free_base_port(1))
    assert "respawning once" in caplog.text
    assert rep["ranks"][1]["respawned"] and \
        rep["ranks"][1]["all_rcs"] == [3, 0], rep
    docs = {r: json.loads(o.strip().splitlines()[-1])
            for r, o in enumerate(outs)}
    for r in (0, 2):
        assert docs[r]["digests"] == want["digests"], r
    assert docs[1]["rejoined"] is True and docs[1]["digests"]
    for mode, digest in docs[1]["digests"].items():
        assert digest == want["digests"][mode], mode
    first = docs[0]["per_mode"]["streaming"]
    assert first["view_changes"] >= 1 and first["epoch"] >= 1
    slo = docs[0]["cluster_slo"]
    assert "cluster_no_rank_deaths" in slo["breached"]
    assert "1" in slo["attribution"]["dead_ranks"]
