"""The PyTorch port's multi-process runtime (fedml_tpu_torch/parallel/
multihost.py, launch.py, mh_worker.py) against the JAX package's
(fedml_tpu/parallel/multihost.py).

* The block math is numpy on both sides, so it is bitwise: the block
  cohort sampler's ids, the dense left fold in block order and the
  sparse scatter fold.
* The channel's frames are the JAX channel's byte for byte: a JAX
  HostChannel and a port HostChannel complete one allgather and one
  pipelined gather together, as rank 0 and rank 1 either way round.
* Every wait is bounded and names the rank at fault: a silent peer, a
  dead dial; the pipelined gather returns what allgather returns and
  aborts cleanly.
* The launcher blames the first rank that fails and names every rank's
  outcome (tiny ``python -c`` ranks that import no torch).
* One test spawns the port's mh_worker: 2 ranks against 1 on the LR
  case, streaming and resident, digests bitwise equal.

Ranks in one process are threads; sockets bind ports above the kernel's
ephemeral range (tests/test_torch_transports.py::free_base_port).
"""
import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from fedml_tpu.parallel import multihost as jmh
from fedml_tpu_torch.parallel import carry_codec as tcc
from fedml_tpu_torch.parallel import launch as tlaunch
from fedml_tpu_torch.parallel import multihost as tmh
from tests.test_torch_transports import free_base_port

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _ctx(mod, rank, world, port):
    return mod.MultihostContext(rank=rank, world=world,
                                coordinator=f"localhost:{port}")


def _run_ranks(fns, timeout=30):
    """Run one callable per rank on threads; returns their results and
    re-raises the first error."""
    out, errs = {}, []

    def run(r, fn):
        try:
            out[r] = fn()
        except BaseException as e:       # noqa: BLE001 - re-raised below
            errs.append((r, e))

    ts = [threading.Thread(target=run, args=(r, fn))
          for r, fn in enumerate(fns)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    assert not any(t.is_alive() for t in ts), "a rank hung"
    if errs:
        raise errs[0][1]
    return out


# ---------------------------------------------------------------------------
# block math, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pop,n_blocks,k", [(64, 4, 6), (64, 4, 16),
                                            (16, 2, 4), (30, 3, 1),
                                            (8, 1, 8)])
def test_block_sampler_ids_bitwise_jax(pop, n_blocks, k):
    for seed in (0, 3):
        t = tmh.BlockCohortSampler(pop, n_blocks, k, seed)
        j = jmh.BlockCohortSampler(pop, n_blocks, k, seed)
        for rnd in range(5):
            for b in range(n_blocks):
                got, want = t.sample_block(rnd, b), j.sample_block(rnd, b)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
                lo = b * (pop // n_blocks)
                assert got.min() >= lo and got.max() < lo + pop // n_blocks


def test_block_sampler_refusals_match_jax():
    for args, match in (((65, 4, 6, 0), "divide evenly"),
                        ((64, 4, 17, 0), "k_per_block"),
                        ((64, 0, 1, 0), "n_blocks")):
        for mod in (tmh, jmh):
            with pytest.raises(ValueError, match=match):
                mod.BlockCohortSampler(*args)
    with pytest.raises(ValueError, match="outside"):
        tmh.BlockCohortSampler(8, 2, 2, 0).sample_block(0, 2)


@pytest.mark.parametrize("n_blocks", [1, 2, 5])
def test_dense_and_sparse_folds_bitwise_jax(n_blocks):
    rs = np.random.RandomState(n_blocks)
    parts = {b: (rs.randn(333) * 10 ** rs.randint(-3, 4)).astype(np.float32)
             for b in range(n_blocks)}
    got = tmh.fold_block_partials(parts, n_blocks)
    assert got.tobytes() == jmh.fold_block_partials(parts, n_blocks).tobytes()
    want = parts[0].copy()
    for b in range(1, n_blocks):
        want = want + parts[b]
    assert got.tobytes() == want.tobytes()
    codec = tcc.TopKCarryCodec(topk_ratio=8)
    pairs, dense = {}, {}
    for b, v in parts.items():
        dim, idx, vals = codec.decode_pairs(codec.encode(b, v))
        pairs[b], dense[b] = (idx, vals), codec.decode(codec.encode(b, v))
    sp = tmh.fold_sparse_partials(pairs, n_blocks, 333)
    assert sp.tobytes() == jmh.fold_sparse_partials(pairs, n_blocks,
                                                    333).tobytes()
    assert sp.tobytes() == tmh.fold_block_partials(dense, n_blocks).tobytes()
    if n_blocks > 1:
        with pytest.raises(tmh.DeadRankError, match=r"\[1\]"):
            tmh.fold_block_partials({b: parts[b] for b in parts if b != 1},
                                    n_blocks)
        with pytest.raises(tmh.DeadRankError, match=r"\[1\]"):
            tmh.fold_sparse_partials(
                {b: pairs[b] for b in pairs if b != 1}, n_blocks, 333)


# ---------------------------------------------------------------------------
# the channel: interop with JAX's, bounded waits, the pipelined gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("root", ["jax", "port"])
def test_jax_and_port_channels_share_one_allgather(root):
    """One rank each: a JAX HostChannel and a port HostChannel allgather
    and gather together; both receive the same rank-ordered payloads."""
    port = free_base_port(1)
    mods = (jmh, tmh) if root == "jax" else (tmh, jmh)
    rs = np.random.RandomState(1)
    pay = [rs.bytes(1000 + 7 * r) for r in range(2)]
    frames = [[rs.bytes(64) for _ in range(3)] for _ in range(2)]

    def rank(r):
        def fn():
            ch = mods[r].HostChannel(_ctx(mods[r], r, 2, port),
                                     timeout_s=20, connect_timeout_s=10)
            try:
                ch.mark_round()
                docs = ch.allgather(pay[r])
                delta = ch.round_wire_delta()
                h = ch.gather_begin(3, timeout_s=20)
                for f in frames[r]:
                    ch.gather_push(h, f)
                gathered = ch.gather_finish(h)
                ch.barrier()
                return docs, gathered, delta
            finally:
                ch.close()
        return fn

    out = _run_ranks([rank(0), rank(1)])
    for r in (0, 1):
        docs, gathered, delta = out[r]
        assert docs == pay, f"rank {r}: allgather payloads differ"
        assert gathered == [b"".join(frames[0]), b"".join(frames[1])]
        assert delta["sent"] > 0 and delta["received"] > 0


def test_bounded_timeout_names_the_stalled_rank():
    """A rank that handshakes and then goes silent is named within
    timeout_s instead of hanging the allgather."""
    port = free_base_port(1)
    errs = []

    def rank0():
        try:
            with tmh.HostChannel(_ctx(tmh, 0, 2, port), timeout_s=1.5,
                                 connect_timeout_s=10) as ch:
                ch.allgather(b"payload")
        except Exception as e:
            errs.append(e)

    t = threading.Thread(target=rank0)
    t.start()
    s = tmh._dial_with_backoff("localhost", port, time.monotonic() + 10,
                               "stalled rank 1")
    s.sendall(struct.pack("<I", 1))
    t.join(15)
    s.close()
    assert not t.is_alive(), "allgather hung past its bounded timeout"
    assert len(errs) == 1 and isinstance(errs[0], tmh.DeadRankError), errs
    assert "rank(s) [1]" in str(errs[0])


def test_setup_names_the_rank_that_never_connected():
    port = free_base_port(1)
    t0 = time.monotonic()
    with pytest.raises(tmh.DeadRankError, match=r"rank\(s\) \[1, 2\] "
                                               r"never connected"):
        tmh.HostChannel(_ctx(tmh, 0, 3, port), connect_timeout_s=0.5)
    assert time.monotonic() - t0 < 5


def test_dial_backoff_reaches_a_late_listener_and_names_a_dead_one():
    port = free_base_port(1)

    def late_listener():
        time.sleep(0.4)                 # refuse first, accept later
        srv = socket.create_server(("localhost", port))
        conn, _ = srv.accept()
        conn.close()
        srv.close()

    t = threading.Thread(target=late_listener)
    t.start()
    tmh._dial_with_backoff("localhost", port, time.monotonic() + 10,
                           "late dial").close()
    t.join(10)
    dead = free_base_port(1)
    t0 = time.monotonic()
    with pytest.raises(tmh.DeadRankError) as ei:
        tmh._dial_with_backoff("localhost", dead, time.monotonic() + 0.6,
                               "worker 7 dialing the coordinator")
    assert time.monotonic() - t0 < 5
    assert "worker 7 dialing the coordinator" in str(ei.value)
    assert "ConnectionRefusedError" in str(ei.value)


def test_gather_is_allgather_and_aborts_cleanly():
    """The pipelined gather returns exactly allgather(b"".join(frames));
    a short push count is a named error on rank 0, and gather_abort
    leaves the channel usable for the next collective."""
    port = free_base_port(1)
    frames = {r: [bytes([65 + r]) * 7 + bytes([i]) for i in range(3)]
              for r in range(2)}

    def rank(r):
        def fn():
            with tmh.HostChannel(_ctx(tmh, r, 2, port), timeout_s=20,
                                 connect_timeout_s=10) as ch:
                h = ch.gather_begin(3)
                for f in frames[r]:
                    ch.gather_push(h, f)
                g = ch.gather_finish(h)
                a = ch.allgather(b"".join(frames[r]))
                h = ch.gather_begin(2)
                ch.gather_push(h, b"only-one")
                if r == 0:
                    with pytest.raises(ValueError, match="1 frames pushed"):
                        ch.gather_finish(h)
                ch.gather_abort(h)
                return g, a
        return fn

    out = _run_ranks([rank(0), rank(1)])
    want = [b"".join(frames[0]), b"".join(frames[1])]
    for r in (0, 1):
        assert out[r] == (want, want)


def test_one_rank_channel_and_context():
    ch = tmh.HostChannel(tmh.MultihostContext.single())
    assert ch.allgather(b"x") == [b"x"]
    h = ch.gather_begin(2)
    ch.gather_push(h, b"a")
    ch.gather_push(h, b"b")
    assert ch.gather_finish(h) == [b"ab"]
    ch.close()


def test_context_env_roundtrip(monkeypatch):
    for k in (tmh.ENV_RANK, tmh.ENV_WORLD, tmh.ENV_COORD):
        monkeypatch.delenv(k, raising=False)
    assert tmh.MultihostContext.from_env() is None
    monkeypatch.setenv("FEDML_MH_RANK", "1")
    monkeypatch.setenv("FEDML_MH_WORLD", "3")
    monkeypatch.setenv("FEDML_MH_COORD", "localhost:123")
    ctx = tmh.MultihostContext.from_env()
    assert (ctx.rank, ctx.world, ctx.coordinator) == (1, 3, "localhost:123")
    monkeypatch.setenv("FEDML_MH_RANK", "3")
    with pytest.raises(ValueError, match="outside world"):
        tmh.MultihostContext.from_env()
    assert (tmh.ENV_RANK, tmh.ENV_WORLD, tmh.ENV_COORD) == (
        jmh.ENV_RANK, jmh.ENV_WORLD, jmh.ENV_COORD)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_spawn_cluster_blames_the_first_failure_and_names_every_rank():
    prog = ("import os, sys, time\n"
            "r = int(os.environ['FEDML_MH_RANK'])\n"
            "if r == 1:\n"
            "    time.sleep(0.3); sys.exit(7)\n"
            "time.sleep(30)\n")
    t0 = time.monotonic()
    with pytest.raises(tmh.MultihostLaunchError) as ei:
        tmh.spawn_cluster([sys.executable, "-c", prog], 3, timeout_s=25,
                          kill_grace_s=0.3)
    msg = str(ei.value)
    assert time.monotonic() - t0 < 20
    assert "rank 1/3 failed first" in msg and "rc=7" in msg
    assert "rank 1: exit rc=7" in msg
    assert ("rank 0: killed by SIGKILL by launcher cleanup after the "
            "first failure") in msg
    # a clean cluster returns every rank's stdout, rank-ordered
    outs, rep = tmh.spawn_cluster_report(
        [sys.executable, "-c",
         "import os; print('r' + os.environ['FEDML_MH_RANK'] + "
         "os.environ['FEDML_MH_WORLD'])"], 2, timeout_s=25)
    assert outs == ["r02\n", "r12\n"]
    assert rep["first_failed"] is None
    assert rep["ranks"][1] == {"rc": 0, "outcome": "ok", "respawned": False,
                               "incarnations": 1, "all_rcs": [0]}


def test_spawn_cluster_deadline_and_refusals():
    with pytest.raises(tmh.MultihostLaunchError,
                       match=r"timed out after 1s: rank\(s\) \[0\]"):
        tmh.spawn_cluster([sys.executable, "-c",
                           "import time; time.sleep(30)"], 1, timeout_s=1)
    with pytest.raises(ValueError, match="elastic"):
        tmh.spawn_cluster([sys.executable, "-c", "pass"], 1, respawn=True)
    # the elastic policy: a dead worker does not fail the launch
    outs = tmh.spawn_cluster(
        [sys.executable, "-c", "import os, sys; print('ok'); "
         "sys.exit(3 if os.environ['FEDML_MH_RANK'] == '1' else 0)"], 2,
        timeout_s=25, elastic=True)
    assert outs == ["ok\n", "ok\n"]
    with pytest.raises(ValueError, match="procs must be >= 1"):
        tmh.spawn_cluster(["true"], 0)
    assert tmh._rank_outcome(-9) == jmh._rank_outcome(-9) == \
        "killed by SIGKILL"
    assert tmh._rank_outcome(3) == jmh._rank_outcome(3) == "exit rc=3"


@pytest.mark.parametrize("argv,err", [
    (["--procs", "0", "--", "true"], "--procs must be >= 1"),
    (["--procs", "2"], "missing worker command"),
    (["--procs", "2", "--respawn", "--", "true"], "--respawn needs"),
    (["--procs", "2", "--elastic", "--", "true"], None),
    (["--procs", "2", "--timeout", "0", "--", "true"], "--timeout"),
])
def test_launcher_validates_args(argv, err, capsys):
    if err is None:                      # a valid command line
        args = tlaunch.parse_args(argv)
        assert args.elastic and args.cmd == ["true"]
        return
    with pytest.raises(SystemExit) as ei:
        tlaunch.parse_args(argv)
    assert ei.value.code == 2
    assert err in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the spawned worker: 2 ranks bitwise 1
# ---------------------------------------------------------------------------

MH_CASE = {"clients": 16, "spc": 24, "dim": 16, "classes": 10,
           "k_per_round": 8, "n_blocks": 2, "rounds": 3, "warmup": 1,
           "seed": 0, "modes": ["streaming", "resident"], "device": "cpu",
           "eval": True}


def test_mh_worker_two_ranks_bitwise_one_rank(tmp_path):
    cfg_path = tmp_path / "mh.json"
    cfg_path.write_text(json.dumps(MH_CASE))
    env = {**os.environ, "OMP_NUM_THREADS": "2",
           "PYTHONPATH": str(REPO) + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    env.pop("FEDML_OBS_DIR", None)
    cmd = [sys.executable, "-m", "fedml_tpu_torch.parallel.mh_worker",
           str(cfg_path)]
    docs = {}
    for procs in (1, 2):
        outs = tmh.spawn_cluster(cmd, procs, env=env, timeout_s=240,
                                 coordinator_port=free_base_port(1))
        docs[procs] = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    one = docs[1][0]
    assert one["digests"]["streaming"] == one["digests"]["resident"]
    for d in docs[2]:
        assert d["digests"] == one["digests"], d["rank"]
        assert d["carry_allreduce_bytes_per_round"] > 0
    assert one["carry_allreduce_bytes_per_round"] == 0
    # each rank encodes one block a round: the LR model's P + 2 f32
    assert docs[2][0]["carry_raw_bytes_per_round"] == (16 * 10 + 10 + 2) * 4
    assert docs[2][0]["eval"] == one["eval"]
    assert docs[2][0]["straggler"]["barriers"] > 0


def test_mh_worker_refuses_later_slices():
    from fedml_tpu_torch.parallel import mh_worker
    base = {**mh_worker.DEFAULTS}
    # the elastic keys, the serving cluster and jax_distributed (slice
    # 6c-i) are ported; a hang needs the elastic channel's heartbeats
    for key, val in (("elastic", True), ("serve_cluster", {"commits": 3}),
                     ("jax_distributed", True)):
        mh_worker.check_config({**base, key: val})
    mh_worker.check_config({**base, "elastic": True, "hang_rank": 2})
    with pytest.raises(ValueError, match="elastic"):
        mh_worker.check_config({**base, "hang_rank": 2})
    # several ranks behind one member (local_devices > 1) are ported
    mh_worker.check_config({**base, "local_devices": 2})
    with pytest.raises(ValueError, match="local_devices"):
        mh_worker.check_config({**base, "local_devices": 0})
    with pytest.raises(ValueError, match="residency mode"):
        mh_worker.check_config({**base, "modes": ["mesh"]})
    proc = subprocess.run([sys.executable, "-m",
                           "fedml_tpu_torch.parallel.mh_worker"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 2 and "usage" in proc.stderr
