"""Several ranks behind one host-channel member (`local_devices` > 1):
the port's local groups (fedml_tpu_torch/parallel/multihost.py::
join_local_group, make_local_mesh, MultihostRunner and ElasticRunner over a
member's local mesh; parallel/mh_worker.py's `local_devices`).

* Through the real launcher on the mh_worker LR case at `local_devices: 2`:
  1 member (2 ranks), then 2 members (4 ranks, exchange overlapped).  Each
  run carries every (algorithm, codec, residency) arm: FedAvg, FedProx,
  FedOpt, FedNova and norm_clip under f32, int8, int8_ef, topk and
  topk_ef, streaming and resident.  2 x 2 commits 1 x 2's bits on every
  rank of every arm, and both residency modes commit one set of bits.
* The 1-member, 2-rank commit against JAX's MultihostRunner (world 1,
  n_blocks 2) over a 2-device JAX mesh, from JAX's init: FedAvg streaming
  and resident, FedProx, FedOpt and FedNova streaming.  Tolerance rtol
  1e-5 / atol 1e-6, f32 summation-order noise (JAX psums a block's two
  shards on the device, the port folds the ranks' sums on the host).
* Elastic at 2 x 2: a clean run (one gloo world over both members,
  `jax_distributed`) commits the fail-fast digest, and a run whose member
  1 dies after round 0 commits the clean run's bits, its blocks
  re-adopted by member 0's group.
* In process: which ranks sit behind a member (`member_ranks`) in each
  world layout, and the runner's refusal of a mesh reaching another
  member's rank, by name.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fedml_tpu_torch.convert import flax_to_torch
from fedml_tpu_torch.parallel import mh_worker
from fedml_tpu_torch.parallel import multihost as tmh
from tests.test_torch_transports import free_base_port

REPO = Path(__file__).resolve().parents[1]

ALGOS = ["fedavg", "fedprox", "fedopt", "fednova", "norm_clip"]
CODECS = ["f32", "int8", "int8_ef", "topk", "topk_ef"]
CASE = {"clients": 16, "spc": 24, "dim": 16, "classes": 10,
        "k_per_round": 8, "n_blocks": 2, "rounds": 2, "warmup": 0,
        "seed": 0, "modes": ["streaming", "resident"], "device": "cpu",
        "local_devices": 2, "eval": True, "channel_timeout_s": 60.0,
        "algorithms": ALGOS, "carry_codecs": CODECS}
# the mh_worker case's FedConfig knobs of the other algorithms
ALGO_CFG = {"prox_mu": 0.1, "server_optimizer": "adam", "server_lr": 0.01,
            "norm_bound": 1.0, "stddev": 1e-3}


def _launch(procs: int, cfg: dict, tmp: Path, flags=(), timeout=240):
    """`python -m fedml_tpu_torch.parallel.launch --procs N -- python -m
    fedml_tpu_torch.parallel.mh_worker CFG`: ({member: JSON doc}, run)."""
    path = tmp / f"case_{procs}_{len(os.listdir(tmp))}.json"
    path.write_text(json.dumps(cfg))
    env = {**os.environ, "OMP_NUM_THREADS": "2",
           "PYTHONPATH": str(REPO) + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    env.pop("FEDML_OBS_DIR", None)
    # the channel's port, the launcher's + 1, and a local group's + 2 + m
    port = free_base_port(2 + procs)
    r = subprocess.run(
        [sys.executable, "-m", "fedml_tpu_torch.parallel.launch",
         "--procs", str(procs), "--port", str(port), "--timeout", "200",
         *flags, "--", sys.executable, "-m",
         "fedml_tpu_torch.parallel.mh_worker", str(path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    docs = {}
    for line in r.stdout.splitlines():
        m = re.match(r"\[rank (\d+)\] (\{.*)", line)
        if m:
            d = json.loads(m.group(2))
            docs[d["rank"]] = d
    return docs, r


def _jax_case(algo: str, streaming: bool):
    """The mh_worker case in the JAX package (the same RandomState(7)
    numbers) on a 2-device JAX mesh."""
    from fedml_tpu.core.trainer import ClientTrainer
    from fedml_tpu.data.federated import (FederatedData,
                                          build_client_shards,
                                          build_eval_shard)
    from fedml_tpu.models import create_model
    from fedml_tpu.parallel import engine as E
    from fedml_tpu.parallel.mesh import make_mesh
    from fedml_tpu.utils.config import FedConfig
    C, spc, dim, classes = 16, 24, 16, 10
    rs = np.random.RandomState(7)
    n = C * spc
    w = rs.randn(dim, classes)
    x = rs.randn(n, dim).astype(np.float32)
    y = np.argmax(x @ w + 0.2 * rs.randn(n, classes), axis=1).astype(np.int64)
    idx = {i: np.arange(i * spc, (i + 1) * spc) for i in range(C)}
    data = FederatedData(
        train_data_num=n, test_data_num=n,
        train_global=build_eval_shard(x, y, n),
        test_global=build_eval_shard(x, y, n),
        client_shards=build_client_shards(x, y, idx, 8),
        client_num_samples=np.full(C, spc, np.float32),
        test_client_shards=None, class_num=classes)
    cfg = FedConfig(client_num_in_total=C, client_num_per_round=8,
                    comm_round=2, epochs=1, batch_size=8, lr=0.1, seed=0,
                    frequency_of_the_test=10_000, **ALGO_CFG)
    cls = {"fedavg": E.MeshFedAvgEngine, "fedprox": E.MeshFedProxEngine,
           "fedopt": E.MeshFedOptEngine,
           "fednova": E.MeshFedNovaEngine}[algo]
    return cls(ClientTrainer(create_model("lr", output_dim=classes),
                             lr=0.1), data, cfg, mesh=make_mesh(2),
               donate=False, streaming=streaming)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The launcher's 1 x 2 and 2 x 2 runs of every arm, from JAX's
    init, member 0 dumping each arm's model."""
    tmp = tmp_path_factory.mktemp("local_devices")
    v0 = _jax_case("fedavg", True).init_variables()
    np.savez(tmp / "init.npz", **{k: v.numpy() for k, v in flax_to_torch(
        jax.tree.map(np.asarray, v0)).items()})
    out = {"v0": v0, "init": str(tmp / "init.npz")}
    for procs, extra in ((1, {}), (2, {"overlap_exchange": True})):
        dump = tmp / f"dump{procs}"
        dump.mkdir()
        docs, r = _launch(procs, {**CASE, **extra,
                                  "init_npz": str(tmp / "init.npz"),
                                  "dump_dir": str(dump)}, tmp)
        assert r.returncode == 0, r.stderr[-3000:]
        assert sorted(docs) == list(range(procs)), r.stdout[-2000:]
        out[procs] = (docs, dump)
    return out


def _every_rank(docs: dict) -> list:
    return [d for doc in docs.values()
            for d in [doc, *doc.get("local_ranks", [])]]


def test_two_members_commit_one_members_bits_on_every_rank(runs):
    one, _ = runs[1]
    two, _ = runs[2]
    want = one[0]["digests"]
    keys = {("streaming" if (a, c) == ("fedavg", "f32") else f"{a}/{c}/")
            for a in ALGOS for c in CODECS}
    assert len(want) == 2 * len(keys) == 50
    ranks = _every_rank(one) + _every_rank(two)
    assert len(ranks) == 6
    assert sorted((d["rank"], d["local_rank"]) for d in ranks) == [
        (0, 0), (0, 0), (0, 1), (0, 1), (1, 0), (1, 1)]
    for d in ranks:
        assert d["digests"] == want, (d["rank"], d["local_rank"])
    # both residency modes commit one set of bits, arm by arm
    for key, dig in want.items():
        if key.endswith("resident"):
            assert dig == want[key[:-len("resident")] + "streaming"], key
    # the carry crossed members at 2, never at 1; only leaders ship
    assert two[0]["carry_allreduce_bytes_per_round"] > 0
    assert one[0]["carry_allreduce_bytes_per_round"] == 0
    assert two[0]["local_ranks"][0]["carry_raw_bytes_per_round"] == 0
    assert two[0]["carry_raw_bytes_per_round"] == (16 * 10 + 10 + 2) * 4
    assert two[0]["per_mode"]["streaming"]["overlap_fraction"] >= 0
    assert two[0]["eval"] == one[0]["eval"]
    assert "eval" not in two[1] and "eval" not in two[0]["local_ranks"][0]


@pytest.mark.parametrize("algo,streaming", [
    ("fedavg", True), ("fedavg", False), ("fedprox", True),
    ("fedopt", True), ("fednova", True)])
def test_one_member_two_ranks_matches_jax_two_device_mesh(runs, algo,
                                                          streaming):
    jeng = _jax_case(algo, streaming)
    from fedml_tpu.parallel import multihost as jmh
    runner = jmh.MultihostRunner(jeng, jmh.MultihostContext.single(),
                                 n_blocks=2)
    want = flax_to_torch(jax.tree.map(np.asarray, runner.run(
        variables=jax.tree.map(jnp.copy, runs["v0"]), rounds=2)))
    key = ("streaming" if streaming else "resident") if algo == "fedavg" \
        else f"{algo}/f32/streaming"
    _, dump = runs[1]
    with np.load(dump / (key.replace("/", "_") + ".npz")) as z:
        got = {k: z[k] for k in z.files}
    start = flax_to_torch(jax.tree.map(np.asarray, runs["v0"]))
    assert sorted(got) == sorted(want)
    for k in want:
        assert not np.array_equal(got[k], start[k].numpy()), k
        np.testing.assert_allclose(got[k], want[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=f"{algo} {k}")
    assert json.loads(runner._config_doc())["n_shards"] == 2


def test_elastic_local_groups_clean_and_after_a_member_dies(runs, tmp_path):
    base = {**CASE, "algorithms": ["fedavg"], "carry_codecs": ["f32"],
            "eval": False, "elastic": True, "channel_timeout_s": 30.0,
            "init_npz": runs["init"]}
    # the clean run in one gloo world over both members' ranks (the
    # launcher's --jax-distributed), the killed run in a world a member
    clean, r = _launch(2, {**base, "jax_distributed": True}, tmp_path,
                       flags=("--elastic", "--jax-distributed"))
    assert r.returncode == 0, r.stderr[-3000:]
    want = {m: runs[1][0][0]["digests"][m] for m in ("streaming",
                                                     "resident")}
    for d in _every_rank(clean):
        assert d["digests"] == want, (d["rank"], d["local_rank"])
        assert all(p["view_changes"] == 0 for p in d["per_mode"].values())
    killed, r = _launch(2, {**base, "die_rank": 1, "die_at_round": 0},
                        tmp_path, flags=("--elastic",))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "injected crash at round 0" in r.stderr
    assert sorted(killed) == [0]
    for d in _every_rank(killed):
        assert d["digests"] == want, d["local_rank"]
    lead = killed[0]["per_mode"]["streaming"]
    assert lead["view_changes"] == 1 and lead["readopted"] == [[1, 1]]
    # the leader's group computed the re-adopted block with it
    assert [1, 1] in killed[0]["local_ranks"][0]["per_mode"]["streaming"][
        "computed"]


def test_member_ranks_and_the_runner_refuses_a_mesh_across_members(
        monkeypatch):
    from fedml_tpu_torch.core.trainer import ClientTrainer
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.parallel.engine import MeshFedAvgEngine
    from fedml_tpu_torch.parallel.mesh import Mesh
    from fedml_tpu_torch.utils.config import FedConfig
    from tests.test_torch_stream import _data
    from fedml_tpu_torch.data import federated as tfed
    ctx = tmh.MultihostContext(rank=1, world=2, coordinator="localhost:1",
                               local_rank=0, local_world=2)
    # a world of the member's group alone, of every member's, of one rank
    for n_world, rank, want in ((2, 1, [0, 1]), (4, 2, [2, 3]),
                                (4, 3, [2, 3])):
        monkeypatch.setattr(tmh, "mesh_world", lambda: (n_world, rank))
        assert tmh.member_ranks(ctx) == want
    monkeypatch.setattr(tmh, "mesh_world", lambda: (3, 0))
    with pytest.raises(ValueError, match="neither one member's"):
        tmh.member_ranks(ctx)
    monkeypatch.setattr(tmh, "mesh_world", lambda: (4, 0))
    single = tmh.MultihostContext(rank=0, world=4, coordinator="x:1")
    assert tmh.member_ranks(single) == [0]

    def engine(grid, rank):
        mesh = Mesh(("clients",), grid, rank)
        return MeshFedAvgEngine(
            ClientTrainer(create_model("lr", 10, input_dim=192), lr=0.1),
            _data(tfed, n_clients=8), FedConfig(client_num_in_total=8,
                                                client_num_per_round=4),
            mesh=mesh, device="cpu")
    ctx0 = tmh.MultihostContext(rank=0, world=2, coordinator="x:1",
                                local_rank=0, local_world=2)
    with pytest.raises(ValueError, match="rank 2 belongs to host-channel "
                                         "member 1"):
        tmh.MultihostRunner(engine([0, 1, 2, 3], 0), ctx0, n_blocks=2)
    runner = tmh.MultihostRunner(engine([0, 1], 0), ctx0, n_blocks=2)
    assert runner.group is not None and runner.leads
    assert json.loads(runner._config_doc())["n_shards"] == 2
    follower = tmh.MultihostRunner(
        engine([0, 1], 1), tmh.MultihostContext(
            rank=0, world=2, coordinator="x:1", local_rank=1,
            local_world=2), n_blocks=2)
    assert not follower.leads
    # a block's lanes over the group: equal shares, padded with the
    # block's first client at zero weight
    ids, wmask, rows = follower._block_ids(0, 1)
    assert len(ids) == 2 and rows == slice(1, 2)
    assert follower._share_bounds(1) == [4, 6, 8]


def test_mh_worker_accepts_local_devices():
    base = {**mh_worker.DEFAULTS}
    mh_worker.check_config({**base, "local_devices": 2})
    mh_worker.check_config({**base, "local_devices": 2,
                            "jax_distributed": True, "elastic": True})
    with pytest.raises(ValueError, match="local_devices"):
        mh_worker.check_config({**base, "local_devices": 0})
    with pytest.raises(ValueError, match="unknown algorithm"):
        mh_worker.check_config({**base, "algorithms": ["krum"]})
    arms = mh_worker._arms({**base, "algorithms": ["fedavg", "norm_clip"],
                            "carry_codecs": ["f32", "int8"],
                            "modes": ["streaming"]})
    assert [a[0] for a in arms] == [
        "streaming", "fedavg/int8/streaming", "norm_clip/f32/streaming",
        "norm_clip/int8/streaming"]

