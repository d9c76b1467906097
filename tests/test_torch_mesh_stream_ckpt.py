"""Block streaming and checkpoint/resume across the ranks of a mesh in
the PyTorch port (parallel/engine.py's `stream_block` over a client mesh,
algorithms/fedavg.py's `run(ckpt=...)` over ranks), in ONE spawned 2-rank
gloo cluster of the port's mesh worker.

* `stream_block` over 2 ranks on tests/multihost_case.py's
  build_blockstream_case (LR on 32 features, 16 clients of 24 samples,
  the cohort of 16 in blocks of 8: two block steps a round, each rank
  streaming 4 clients of every block) against the JAX engine of that
  case on its 8 forced CPU devices (rtol 2e-4 / atol 2e-5, the mesh
  tests' tolerance), against the port's 2-rank streaming round of the
  same cohort within 1e-6 relative (the same lanes, folded in another
  grouping), and a second run commits the first run's bits; a rank's
  resident blocks never exceed two blocks' share.
* Checkpoint and resume (tests/test_multihost_spmd.py:192-213 with
  build_ckpt_case's FedOpt adam, and norm_clip with weak-DP noise, whose
  generator rides along): the mesh's first rank writes, every rank
  restores, and a run that resumes after round 1 of 4 in a fresh engine
  commits the uninterrupted 4-round run's bits on every rank.
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

from fedml_tpu_torch.convert import flax_to_torch
from fedml_tpu_torch.data import federated as tfed
from fedml_tpu_torch.parallel import multihost as tmh
from tests.multihost_case import _case_data_cfg, build_blockstream_case
from tests.test_torch_transports import free_base_port

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def port_data():
    """_case_data_cfg's data as the port's FederatedData (the same
    arrays)."""
    jdata, cfg = _case_data_cfg(comm_round=2)
    fields = ("train_data_num", "test_data_num", "train_global",
              "test_global", "client_shards", "client_num_samples",
              "test_client_shards", "class_num")
    return tfed.FederatedData(**{f: getattr(jdata, f) for f in fields}), cfg


def base_cfg(cfg, **kw) -> dict:
    out = {k: getattr(cfg, k) for k in (
        "client_num_in_total", "client_num_per_round", "comm_round",
        "epochs", "batch_size", "lr", "frequency_of_the_test")}
    out.update(kw)
    return out


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


CKPT = {"fedopt": ("fedopt", {"server_optimizer": "adam",
                              "server_lr": 0.05}, {}),
        "norm_clip": ("robust", {"norm_bound": 0.3, "stddev": 0.01},
                      {"defense": "norm_clip"})}


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_stream_ckpt")
    jeng = build_blockstream_case()
    jv0 = jeng.init_variables()
    data, cfg = port_data()
    with open(tmp / "data.pkl", "wb") as f:
        pickle.dump(data, f)
    torch.save(flax_to_torch(jax.tree.map(np.asarray, jv0)), tmp / "v0.pt")
    stream = base_cfg(cfg, client_num_per_round=16)
    arms = [dict(tag=tag, engine="fedavg", mesh={"kind": "1d"}, rounds=2,
                 save=True, cfg=stream, engine_kw=kw)
            for tag, kw in (("block", {"stream_block": 8}),
                            ("block_again", {"stream_block": 8}),
                            ("block_sync", {"stream_block": 8,
                                            "prefetch": False}),
                            ("streaming", {"streaming": True}))]
    for name, (eng, cfg_kw, kw) in CKPT.items():
        ck = str(tmp / f"ckpt_{name}")
        c4 = base_cfg(cfg, comm_round=4, **cfg_kw)
        arms += [
            dict(tag=f"{name}_full", engine=eng, rounds=4, save=True,
                 cfg=c4, engine_kw=kw, mesh={"kind": "1d"}),
            dict(tag=f"{name}_first", engine=eng, rounds=2, cfg=c4,
                 engine_kw=kw, mesh={"kind": "1d"},
                 ckpt={"dir": ck, "every": 1}),
            dict(tag=f"{name}_resumed", engine=eng, rounds=4, save=True,
                 cfg=c4, engine_kw=kw, mesh={"kind": "1d"},
                 ckpt={"dir": ck, "every": 1, "resume": True})]
    case = {"data": str(tmp / "data.pkl"), "weights": str(tmp / "v0.pt"),
            "device": "cpu", "threads": 2, "out": str(tmp),
            "model": {"name": "lr", "output_dim": 10, "input_dim": 32},
            "trainer": {"lr": cfg.lr}, "cfg": base_cfg(cfg), "arms": arms}
    docs = run_cluster(tmp, case, 2)
    saved = {(a["tag"], r): torch.load(tmp / f"{a['tag']}.rank{r}.pt")
             for a in arms if a.get("save") for r in (0, 1)}
    return dict(docs=docs, saved=saved, jeng=jeng, jv0=jv0, tmp=tmp)


def test_block_stream_over_ranks_matches_jax_blockstream_case(cluster):
    want = flax_to_torch(jax.tree.map(np.asarray, cluster["jeng"].run(
        variables=jax.tree.map(jnp.copy, cluster["jv0"]), rounds=2)))
    got = cluster["saved"]["block", 0]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **TOL)


def test_block_stream_over_ranks_is_the_streaming_round(cluster):
    block, stream = (cluster["saved"][t, 0] for t in ("block", "streaming"))
    for k in stream:
        np.testing.assert_allclose(block[k].numpy(), stream[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("tag", ["block_again", "block_sync"])
def test_block_stream_over_ranks_is_one_set_of_bits(cluster, tag):
    """A second run, and the synchronous upload path, commit the first
    run's bits, on both ranks."""
    digests = {d["arms"][t]["digest"] for d in cluster["docs"]
               for t in ("block", tag)}
    assert len(digests) == 1
    for k, v in cluster["saved"]["block", 0].items():
        assert torch.equal(v, cluster["saved"][tag, 1][k]), k


def test_block_stream_residency_is_two_blocks_share(cluster):
    """Each rank holds at most two of its 4-client block shares on the
    device: the double buffer's bound, per rank."""
    _, cfg = _case_data_cfg(comm_round=2)
    data, _ = port_data()
    per_client = sum(np.asarray(v)[0].nbytes
                     for v in data.client_shards.values())
    for d in cluster["docs"]:
        peak = d["arms"]["block"]["peak_block_bytes"]
        assert 0 < peak <= 2 * 4 * per_client
        assert d["arms"]["block_sync"]["peak_block_bytes"] <= 4 * per_client


@pytest.mark.parametrize("name", sorted(CKPT))
def test_resume_across_ranks_is_the_uninterrupted_run_bitwise(cluster, name):
    ck = cluster["tmp"] / f"ckpt_{name}"
    assert sorted(p.name for p in ck.iterdir()) == [
        "round-1.pt", "round-2.pt", "round-3.pt"]
    docs = cluster["docs"]
    full = {d["arms"][f"{name}_full"]["digest"] for d in docs}
    assert len(full) == 1
    assert {d["arms"][f"{name}_resumed"]["digest"] for d in docs} == full
    # the resumed run trained only rounds 2 and 3
    assert [len(d["arms"][f"{name}_resumed"]["round_walls"])
            for d in docs] == [2, 2]
    for r in (0, 1):
        for k, v in cluster["saved"][f"{name}_full", 0].items():
            assert torch.equal(v, cluster["saved"][f"{name}_resumed", r][k])
