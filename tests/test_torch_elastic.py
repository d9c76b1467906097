"""The port's elastic channel (fedml_tpu_torch/parallel/multihost.py:
ClusterView, the elastic wire, ElasticChannel, the launcher's elastic
policy) against the JAX package's.

* `ClusterView` is a pure function of (members, n_items): the port's
  owner map is JAX's on every member subset.
* The elastic frames are JAX's byte for byte, and a JAX coordinator with
  port workers (and the other way round) completes exchanges, through a
  view change that re-tasks a survivor with a dead rank's items.
* The in-process elastic cases of tests/test_multihost_spmd.py on the
  port: death and double death with strictly monotone epochs, a death
  during a view change, a hung rank evicted by heartbeat well inside the
  round's timeout, rejoin with a snapshot and a stale digest rejected by
  name, dial backoff, the launcher's blame and its respawn, early
  contributions equal to the inline exchange.
* The observatory over the elastic channel (tests/test_cluster_obs.py):
  the heartbeat piggyback, a cluster SLO breach naming the dead rank,
  the coordinated dump fanning out, and wire bytes identical with obs off.

Ranks are threads over real sockets on ports above the ephemeral range
(tests/test_torch_transports.py::free_base_port); the launcher cases run
tiny ``python -c`` ranks that import no torch.
"""
import glob
import json
import signal
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

from fedml_tpu.parallel import multihost as jmh
from fedml_tpu_torch import obs
from fedml_tpu_torch.obs import cluster
from fedml_tpu_torch.parallel import multihost as tmh
from tests.test_torch_transports import free_base_port


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def clean_obs():
    prev = signal.getsignal(signal.SIGUSR1)
    obs.reset()
    yield
    obs.reset()
    signal.signal(signal.SIGUSR1, prev)


def _evec(item: int, rnd: int) -> bytes:
    return np.full(3, 100 * item + rnd, np.float32).tobytes()


def _chan(mod, rank, world, port, *, n_items, digest="cfg", timeout_s=30.0,
          connect_timeout_s=10.0, hb_timeout_s=3.0, rejoin=False):
    ctx = mod.MultihostContext(rank=rank, world=world,
                               coordinator=f"localhost:{port}")
    return mod.ElasticChannel(ctx, n_items=n_items, config_digest=digest,
                              timeout_s=timeout_s,
                              connect_timeout_s=connect_timeout_s,
                              hb_interval_s=0.1, hb_timeout_s=hb_timeout_s,
                              rejoin=rejoin)


def _threads(fns, timeout=60):
    """Run the callables on threads; return their errors (each join has
    its own timeout, and a thread still alive is an error)."""
    errs = []

    def wrap(fn):
        def run():
            try:
                fn()
            except BaseException as e:      # noqa: BLE001 - reported
                errs.append(e)
        return run

    ts = [threading.Thread(target=wrap(f), daemon=True) for f in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    if any(t.is_alive() for t in ts):
        errs.append(AssertionError("a rank hung"))
    return errs


def _rounds(ch, r, rounds, results, start=0):
    for rnd in range(start, rounds):
        parts = {b: _evec(b, rnd) for b in ch.view.assigned(r)}
        allp, view = ch.exchange(
            rnd, parts, lambda need, rnd=rnd: {b: _evec(b, rnd)
                                               for b in need})
        assert set(allp) == set(range(ch.n_items))
        assert all(bytes(allp[b]) == _evec(b, rnd)
                   for b in range(ch.n_items))
        results.setdefault(r, []).append((view.epoch, view.members))


# ---------------------------------------------------------------------------
# the view and the wire
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_items", [8, 4, 3])
def test_cluster_view_is_jax_on_every_member_subset(n_items):
    full = tmh.ClusterView(0, (0, 1, 2, 3), 8)
    assert [full.assigned(r) for r in range(4)] == [
        (0, 1), (2, 3), (4, 5), (6, 7)]
    for members in [(0, 1, 2, 3), (0,), (0, 2), (1, 3), (0, 1, 3), (2,),
                    (0, 1, 2)]:
        t = tmh.ClusterView(1, members, n_items)
        j = jmh.ClusterView(1, members, n_items)
        owners = [t.owner_of(i) for i in range(n_items)]
        assert owners == [j.owner_of(i) for i in range(n_items)]
        assert [t.assigned(m) for m in members] == \
            [j.assigned(m) for m in members]
        covered = sorted(i for m in members for i in t.assigned(m))
        assert covered == list(range(n_items))
        assert owners == [tmh.ClusterView(9, members, n_items).owner_of(i)
                          for i in range(n_items)]
    for mod in (tmh, jmh):
        with pytest.raises(ValueError, match="outside"):
            mod.ClusterView(0, (0,), 4).owner_of(4)


def test_elastic_frames_are_jax_byte_for_byte():
    cases = [("hello", {"rank": 2, "role": "data", "digest": "d"}, b""),
             ("contrib", {"epoch": 1, "round": 7, "blocks": [3, 1]},
              b"\x00\x01" * 9),
             ("view", {"epoch": 2, "round": 3, "members": [0, 2],
                       "need": [1]}, b""),
             ("hb", {}, b""), ("result", {"epoch": 0, "round": 0,
                                          "members": [0, 1]},
                               bytes(range(256)))]
    for mtype, hdr, payload in cases:
        got = {}
        for name, mod in (("jax", jmh), ("port", tmh)):
            a, b = socket.socketpair()
            with a, b:
                n = mod._send_msg(a, mtype, dict(hdr), payload)
                a.shutdown(socket.SHUT_WR)
                raw = b.recv(1 << 20)
                while len(raw) < n:
                    raw += b.recv(1 << 20)
                got[name] = (raw, n)
        assert got["port"] == got["jax"], mtype
        # the port reads the JAX frame, and a payload given in pieces is
        # the joined payload's frame
        a, b = socket.socketpair()
        with a, b:
            jmh._send_msg(a, mtype, dict(hdr), payload)
            t, h, p, n = tmh._recv_msg(b)
            assert (t, h, bytes(p), n) == (mtype, hdr, payload,
                                           got["jax"][1])
            half = len(payload) // 2
            tmh._send_msg(a, mtype, dict(hdr),
                          [payload[:half], memoryview(payload)[half:]])
            assert jmh._recv_msg(b)[2] == payload


@pytest.mark.parametrize("root", ["jax", "port"])
def test_jax_and_port_ranks_share_an_elastic_exchange(root):
    """A coordinator of one package and two workers of the other: round 0
    with everyone, then rank 1 closes and round 1 completes through a
    view change that re-tasks rank 2 with rank 1's items."""
    coord_mod, work_mod = (jmh, tmh) if root == "jax" else (tmh, jmh)
    port = free_base_port(1)
    n_items, results = 4, {}

    def coord():
        ch = _chan(coord_mod, 0, 3, port, n_items=n_items)
        try:
            ch.wait_members()
            _rounds(ch, 0, 2, results)
            results["events"] = list(ch.view_events)
        finally:
            ch.close()

    def worker(r):
        def run():
            ch = _chan(work_mod, r, 3, port, n_items=n_items)
            try:
                _rounds(ch, r, 1 if r == 1 else 2, results)
            finally:
                ch.close()
        return run

    errs = _threads([coord, worker(1), worker(2)])
    assert not errs, errs
    assert results[0] == [(0, (0, 1, 2)), (1, (0, 2))]
    assert results[2][-1] == (1, (0, 2))
    assert [e["dead"] for e in results["events"]] == [[1]]


# ---------------------------------------------------------------------------
# the in-process elastic cases
# ---------------------------------------------------------------------------

def test_elastic_death_and_double_death_epochs_monotone(clean_obs):
    port = free_base_port(1)
    n_items, world, rounds = 6, 3, 4
    results = {}

    def rank(r, die_after=None):
        def run():
            ch = _chan(tmh, r, world, port, n_items=n_items)
            try:
                if r == 0:
                    ch.wait_members()
                _rounds(ch, r, rounds if die_after is None else die_after,
                        results)
                if r == 0:
                    results["events"] = list(ch.view_events)
            finally:
                ch.close()
        return run

    errs = _threads([rank(0), rank(1, die_after=2), rank(2, die_after=3)])
    assert not errs, errs
    assert len(results[0]) == rounds
    assert results[0][-1] == (2, (0,))
    epochs = [e["epoch"] for e in results["events"]]
    assert epochs == sorted(epochs) and len(set(epochs)) == len(epochs)
    assert obs.counter("multihost_view_changes_total").value >= 2
    assert obs.gauge("multihost_epoch", rank="0").value == 2.0


def test_elastic_death_during_view_change():
    """Rank 1 dies, the VIEW re-asks rank 2, and rank 2 (a hand-rolled
    worker speaking the raw wire) dies instead of re-contributing: the
    coordinator chains a second view change and finishes alone."""
    port = free_base_port(1)
    n_items, out = 4, {}

    def coord():
        ch = _chan(tmh, 0, 3, port, n_items=n_items, timeout_s=15)
        try:
            ch.wait_members()
            _rounds(ch, 0, 2, out)
            out["events"] = list(ch.view_events)
        finally:
            ch.close()

    def rank1():
        ch = _chan(tmh, 1, 3, port, n_items=n_items)
        ch.exchange(0, {b: _evec(b, 0) for b in ch.view.assigned(1)}, None)
        ch.close()

    def rank2_raw():
        data = tmh._dial_with_backoff("localhost", port,
                                      time.monotonic() + 10, "rank 2")
        tmh._send_msg(data, "hello", {"rank": 2, "role": "data",
                                      "digest": "cfg"})
        mtype, _, _, _ = tmh._recv_msg(data)
        assert mtype == "hello_ok"
        hb = socket.create_connection(("localhost", port), timeout=5.0)
        tmh._send_msg(hb, "hello", {"rank": 2, "role": "hb"})
        stop = threading.Event()

        def beat():
            while not stop.is_set():
                try:
                    tmh._send_msg(hb, "hb", {})
                except OSError:
                    return
                time.sleep(0.1)
        threading.Thread(target=beat, daemon=True).start()
        mine = [b for b in range(n_items) if b * 3 // n_items == 2]
        for rnd in range(2):
            tmh._send_msg(data, "contrib", {"epoch": 0, "round": rnd,
                                            "blocks": mine},
                          b"".join(_evec(b, rnd) for b in mine))
            while True:
                mtype, _, _, _ = tmh._recv_msg(data)
                if mtype == "view":      # die instead of re-contributing
                    stop.set()
                    data.close()
                    hb.close()
                    return
                if mtype == "result":
                    break

    errs = _threads([coord, rank1, rank2_raw], timeout=40)
    assert not errs, errs
    assert out[0][1][1] == (0,)
    assert [e["epoch"] for e in out["events"]] == [1, 2]


def test_elastic_heartbeat_evicts_a_hung_rank_within_its_timeout():
    port = free_base_port(1)
    out, timeout_s = {}, 30.0

    def coord():
        ch = _chan(tmh, 0, 2, port, n_items=2, timeout_s=timeout_s,
                   hb_timeout_s=1.0)
        try:
            ch.wait_members()
            t0 = time.monotonic()
            _allp, view = ch.exchange(0, {0: _evec(0, 0)},
                                      lambda need: {b: _evec(b, 0)
                                                    for b in need})
            out["elapsed"] = time.monotonic() - t0
            out["view"] = (view.epoch, view.members)
            out["events"] = list(ch.view_events)
        finally:
            ch.close()

    def hung():
        ch = _chan(tmh, 1, 2, port, n_items=2)
        ch.hb_paused = True              # the process "stops"
        time.sleep(3.0)                  # hung, not dead: the socket open
        ch.close()

    errs = _threads([coord, hung], timeout=25)
    assert not errs, errs
    assert out["view"] == (1, (0,))
    assert out["elapsed"] < timeout_s / 2
    assert out["events"][0]["dead"] == [1]
    assert "heartbeat" in out["events"][0]["reason"] \
        or "hung" in out["events"][0]["reason"]


def test_elastic_rejoin_snapshot_and_stale_digest_rejected():
    port = free_base_port(1)
    n_items, rounds, out = 2, 6, {}

    def coord():
        ch = _chan(tmh, 0, 2, port, n_items=n_items, timeout_s=20)
        try:
            ch.wait_members()
            for rnd in range(rounds):
                _rounds(ch, 0, rnd + 1, out, start=rnd)
                if ch.admit_rejoins(rnd + 1,
                                    lambda: b"snapshot@%d" % (rnd + 1),
                                    tag="streaming"):
                    out["admitted_at"] = rnd + 1
                time.sleep(0.3)
            out["events"] = list(ch.view_events)
        finally:
            ch.close()

    def mortal():
        ch = _chan(tmh, 1, 2, port, n_items=n_items)
        ch.exchange(0, {b: _evec(b, 0) for b in ch.view.assigned(1)}, None)
        ch.close()

    def stale():
        time.sleep(0.6)
        ch = _chan(tmh, 1, 2, port, n_items=n_items, digest="STALE-DIGEST",
                   rejoin=True)
        with pytest.raises(tmh.DeadRankError) as ei:
            ch.rejoin_handshake()
        ch.close()
        msg = str(ei.value)
        assert "STALE-DIGEST" in msg and "cfg" in msg and "rank 1" in msg
        out["stale_named"] = True

    def rejoiner():
        time.sleep(1.0)
        ch = _chan(tmh, 1, 2, port, n_items=n_items, rejoin=True)
        try:
            blob, resume, tag = ch.rejoin_handshake()
            out.update(snapshot=blob, resume=resume, tag=tag)
            _rounds(ch, 1, rounds, out, start=resume)
        finally:
            ch.close()

    errs = _threads([coord, mortal, stale, rejoiner])
    assert not errs, errs
    assert out["stale_named"]
    assert out["snapshot"] == b"snapshot@%d" % out["resume"]
    assert out["tag"] == "streaming"
    assert len(out[1]) == rounds - out["resume"] >= 1
    epochs = [e["epoch"] for e in out["events"]]
    assert epochs == sorted(epochs) and len(epochs) >= 2
    assert any("rejoined" in e for e in out["events"])


def _big(item: int, rnd: int) -> bytes:
    """A 16 MB item: larger than the loopback socket buffers, so a
    contribution nobody reads blocks its writer."""
    return np.full(4_000_000, 100 * item + rnd, np.float32).tobytes()


def test_elastic_reads_a_rejoiners_contrib_its_stale_incumbent_covered():
    """After a rejoin, an incumbent that has not yet read the new view
    computes the rejoiner's block under the old one and ships it first.
    The coordinator then holds every item, but must still read the
    rejoiner's own contribution before it writes the result: both
    writing to each other with full socket buffers would stall until the
    round's deadline (a stall phase 21 showed on the card under load)."""
    port = free_base_port(1)
    n_items, out = 4, {}
    dialing = threading.Event()
    big = lambda need, rnd: {b: _big(b, rnd) for b in need}   # noqa: E731

    def exchange(ch, r, rnd):
        allp, view = ch.exchange(rnd, big(ch.view.assigned(r), rnd),
                                 lambda need: big(need, rnd))
        assert all(bytes(allp[b]) == _big(b, rnd) for b in range(n_items))
        out.setdefault(r, []).append((rnd, view.epoch))

    def coord():
        ch = _chan(tmh, 0, 3, port, n_items=n_items, timeout_s=20)
        try:
            ch.wait_members()
            exchange(ch, 0, 0)
            exchange(ch, 0, 1)            # rank 1 dies: epoch 1
            assert dialing.wait(20)
            time.sleep(0.5)               # its rejoin hello is pending
            assert ch.admit_rejoins(2, lambda: b"snap", tag="t") == [1]
            exchange(ch, 0, 2)            # epoch 2: rank 1 owns block 2
        finally:
            ch.close()

    def mortal():
        ch = _chan(tmh, 1, 3, port, n_items=n_items)
        exchange(ch, 1, 0)
        ch.close()

    def incumbent():
        ch = _chan(tmh, 2, 3, port, n_items=n_items)
        try:
            for rnd in range(3):
                exchange(ch, 2, rnd)      # round 2 under epoch 1: {2, 3}
        finally:
            ch.close()

    def rejoiner():
        time.sleep(1.0)
        ch = _chan(tmh, 1, 3, port, n_items=n_items, rejoin=True)
        try:
            dialing.set()
            _, resume, _ = ch.rejoin_handshake()
            time.sleep(1.0)               # the incumbent's copy lands first
            exchange(ch, 1, resume)
        finally:
            ch.close()

    errs = _threads([coord, mortal, incumbent, rejoiner], timeout=60)
    assert not errs, errs
    assert out[0][-1] == (2, 2) and out[1][-1] == (2, 2)
    assert out[2][-1] == (2, 2)


def test_elastic_rejoin_under_overlap_reads_every_frame_before_result():
    """ROADMAP C.19's open case: the overlapped exchange ships a frame a
    block.  After a rejoin the rejoiner owns two blocks and pushes them
    one frame each; the stale incumbent already covered the second, so
    rank 0 holds every item after the rejoiner's FIRST frame.  Writing
    the 6 x 16 MB result then, while the rejoiner still writes its second
    16 MB frame, would stall both on full socket buffers until the
    result send's deadline; the round must finish well inside it."""
    port = free_base_port(1)
    n_items, out, timeout_s = 6, {}, 20.0
    dialing = threading.Event()
    big = lambda need, rnd: {b: _big(b, rnd) for b in need}   # noqa: E731

    def check(allp, rnd):
        assert all(bytes(allp[b]) == _big(b, rnd) for b in range(n_items))

    def overlapped(ch, r, rnd):
        h = ch.contrib_begin(rnd)
        for b in ch.view.assigned(r):
            ch.contrib_push(h, b, _big(b, rnd))
        allp, view = ch.exchange(rnd, {}, lambda need: big(need, rnd),
                                 pending=h)
        check(allp, rnd)
        out.setdefault(r, []).append((rnd, view.epoch))

    def serial(ch, r, rnd):
        allp, view = ch.exchange(rnd, big(ch.view.assigned(r), rnd),
                                 lambda need: big(need, rnd))
        check(allp, rnd)
        out.setdefault(r, []).append((rnd, view.epoch))

    def coord():
        ch = _chan(tmh, 0, 3, port, n_items=n_items, timeout_s=timeout_s)
        try:
            ch.wait_members()
            serial(ch, 0, 0)
            serial(ch, 0, 1)              # rank 1 dies: epoch 1
            assert dialing.wait(20)
            time.sleep(0.5)               # its rejoin hello is pending
            assert ch.admit_rejoins(2, lambda: b"snap", tag="t") == [1]
            t0 = time.monotonic()
            serial(ch, 0, 2)              # epoch 2: rank 1 owns {2, 3}
            out["round2_s"] = time.monotonic() - t0
        finally:
            ch.close()

    def mortal():
        ch = _chan(tmh, 1, 3, port, n_items=n_items, timeout_s=timeout_s)
        serial(ch, 1, 0)
        ch.close()

    def incumbent():
        ch = _chan(tmh, 2, 3, port, n_items=n_items, timeout_s=timeout_s)
        try:
            serial(ch, 2, 0)
            serial(ch, 2, 1)
            overlapped(ch, 2, 2)          # under epoch 1: blocks {3, 4, 5}
        finally:
            ch.close()

    def rejoiner():
        time.sleep(1.0)
        ch = _chan(tmh, 1, 3, port, n_items=n_items, timeout_s=timeout_s,
                   rejoin=True)
        try:
            dialing.set()
            _, resume, _ = ch.rejoin_handshake()
            time.sleep(1.0)               # the incumbent's copy lands first
            overlapped(ch, 1, resume)
        finally:
            ch.close()

    errs = _threads([coord, mortal, incumbent, rejoiner], timeout=60)
    assert not errs, errs
    assert out[0][-1] == (2, 2) and out[1][-1] == (2, 2)
    assert out[2][-1] == (2, 2)
    assert out["round2_s"] < timeout_s / 2


def test_elastic_early_contrib_matches_inline_exchange():
    port = free_base_port(1)
    n_items, res = 4, {}

    def rank(r):
        def run():
            ch = _chan(tmh, r, 2, port, n_items=n_items)
            try:
                if r == 0:
                    ch.wait_members()
                ch.mark_round()
                h = ch.contrib_begin(0)
                for b in ch.view.assigned(r):
                    ch.contrib_push(h, b, _evec(b, 0))
                allp0, _ = ch.exchange(
                    0, {}, lambda need: {b: _evec(b, 0) for b in need},
                    pending=h)
                delta = ch.round_wire_delta()
                allp1, _ = ch.exchange(
                    1, {b: _evec(b, 1) for b in ch.view.assigned(r)},
                    lambda need: {b: _evec(b, 1) for b in need})
                res[r] = (allp0, allp1, delta)
            finally:
                ch.close()
        return run

    errs = _threads([rank(0), rank(1)])
    assert not errs, errs
    for r in (0, 1):
        allp0, allp1, delta = res[r]
        assert all(bytes(allp0[b]) == _evec(b, 0) for b in range(n_items))
        assert all(bytes(allp1[b]) == _evec(b, 1) for b in range(n_items))
        assert delta["sent"] > 0 and delta["received"] > 0


def test_dial_backoff_reaches_a_late_listener_and_names_a_dead_one():
    port, dead_port = free_base_port(1), free_base_port(1)

    def late_listener():
        time.sleep(0.4)
        srv = socket.create_server(("localhost", port))
        conn, _ = srv.accept()
        conn.close()
        srv.close()

    t = threading.Thread(target=late_listener, daemon=True)
    t.start()
    tmh._dial_with_backoff("localhost", port, time.monotonic() + 10.0,
                           "late").close()
    t.join(10)
    t0 = time.monotonic()
    with pytest.raises(tmh.DeadRankError) as ei:
        tmh._dial_with_backoff("localhost", dead_port,
                               time.monotonic() + 0.6,
                               "worker 7 dialing the coordinator")
    assert time.monotonic() - t0 < 5.0
    assert "worker 7 dialing the coordinator" in str(ei.value)
    assert "ConnectionRefusedError" in str(ei.value)


# ---------------------------------------------------------------------------
# the launcher's elastic policy
# ---------------------------------------------------------------------------

def test_launcher_blames_every_rank_and_respawns_once():
    prog = ("import os, sys, time\n"
            "r = int(os.environ['FEDML_MH_RANK'])\n"
            "if r == 1:\n"
            "    time.sleep(0.3); sys.exit(7)\n"
            "time.sleep(30)\n")
    with pytest.raises(tmh.MultihostLaunchError) as ei:
        tmh.spawn_cluster([sys.executable, "-c", prog], 3, timeout_s=25,
                          kill_grace_s=0.3)
    msg = str(ei.value)
    assert "rank 1/3 failed first" in msg and "exit rc=7" in msg
    assert "SIGKILL" in msg and "per-rank:" in msg
    # elastic: rank 1 dies once, is started again with FEDML_MH_REJOIN=1,
    # and the survivors and the rejoiner all finish; the launcher does not
    # fail
    prog = ("import os, sys, time\n"
            "r = os.environ['FEDML_MH_RANK']\n"
            "rej = os.environ.get('FEDML_MH_REJOIN', '0')\n"
            "if r == '1' and rej != '1':\n"
            "    sys.exit(3)\n"
            "time.sleep(0.5)\n"
            "print('rank', r, 'rejoin', rej)\n")
    outs, rep = tmh.spawn_cluster_report([sys.executable, "-c", prog], 3,
                                         timeout_s=25, elastic=True,
                                         respawn=True)
    assert outs[1] == "rank 1 rejoin 1\n" and outs[2] == "rank 2 rejoin 0\n"
    assert rep["ranks"][1] == {"rc": 0, "outcome": "ok", "respawned": True,
                               "incarnations": 2, "all_rcs": [3, 0]}
    assert rep["first_failed"] == 1
    # elastic without respawn: a dead worker is survived; rank 0's death
    # is fatal and named
    outs, rep = tmh.spawn_cluster_report(
        [sys.executable, "-c", "import os, sys; "
         "sys.exit(5 if os.environ['FEDML_MH_RANK'] == '1' else 0)"], 2,
        timeout_s=25, elastic=True)
    assert rep["ranks"][1]["all_rcs"] == [5] and rep["ranks"][0]["rc"] == 0
    with pytest.raises(tmh.MultihostLaunchError, match="rank 0/2"):
        tmh.spawn_cluster([sys.executable, "-c", "import os, sys; "
                           "sys.exit(6 if os.environ['FEDML_MH_RANK'] == "
                           "'0' else 0)"], 2, timeout_s=25, elastic=True)


# ---------------------------------------------------------------------------
# the observatory over the elastic channel
# ---------------------------------------------------------------------------

def _series_with_origin(name: str, origin: str) -> bool:
    return any(m.name == name and dict(m.labels).get("origin") == origin
               for m in obs.registry().metrics())


def _build_pair(port):
    chans = {}
    errs = _threads([lambda r=r: chans.__setitem__(
        r, _chan(tmh, r, 2, port, n_items=2, timeout_s=20.0,
                 hb_timeout_s=5.0)) for r in (0, 1)], timeout=30)
    assert not errs, errs
    return chans


def _one_round(chans):
    res = {}

    def rnd(r):
        parts = {b: b"r%d" % r for b in chans[r].view.assigned(r)}
        res[r] = chans[r].exchange(0, parts, lambda need: {})

    errs = _threads([lambda r=r: rnd(r) for r in (0, 1)], timeout=20)
    assert not errs and set(res) == {0, 1}, errs


def test_hb_piggyback_folds_into_the_coordinator_live(clean_obs, tmp_path):
    obs.configure(str(tmp_path), install_signal=False, export_at_exit=False)
    chans = _build_pair(free_base_port(1))
    try:
        obs.counter("piggy_probe_total").inc()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not _series_with_origin(
                "piggy_probe_total", "host1"):
            time.sleep(0.05)
        assert _series_with_origin("piggy_probe_total", "host1")
        rep = cluster.cluster_report()
        assert rep["scope"] == "cluster" and rep["world"] == 2
        assert rep["ranks"]["1"]["alive"] is True
        json.dumps(rep)
    finally:
        for ch in chans.values():
            ch.close()


def test_cluster_slo_breach_names_the_dead_rank(clean_obs):
    cluster.set_role(0, 3, elastic=True)
    obs.counter("multihost_rounds_committed_total", rank="0").inc()
    cluster.note_barrier("exchange", 0, 0, {0: 1.0, 1: 1.2, 2: 1.1})
    rep = cluster.cluster_slo_report()
    assert rep["scope"] == "cluster" and rep["healthy"], rep
    obs.counter("multihost_rank_deaths_total", rank="1").inc()
    rep = cluster.cluster_slo_report()
    assert rep["healthy"] is False
    assert "cluster_no_rank_deaths" in rep["breached"]
    assert rep["attribution"]["dead_ranks"] == ["1"]
    assert rep["attribution"]["gating_rank"] == 1
    obs.reset()
    cluster.set_role(2, 3)
    assert cluster.cluster_slo_report() is None


def test_coordinated_dump_fans_out_and_throttles(clean_obs, tmp_path):
    obs.configure(str(tmp_path), install_signal=False, export_at_exit=False)
    chans = _build_pair(free_base_port(1))
    try:
        assert cluster.maybe_coordinated_dump("test_incident") is True
        assert cluster.maybe_coordinated_dump("storm") is False
        assert obs.counter("multihost_coordinated_dumps_total").value == 1
        _one_round(chans)            # the worker reads DUMP in its exchange
        dumps = []
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and len(dumps) < 2:
            dumps = [p for p in glob.glob(str(tmp_path / "flight-*.json"))
                     if json.load(open(p))["reason"]
                     == "coordinated:test_incident"]
            time.sleep(0.05)
        assert len(dumps) == 2
    finally:
        for ch in chans.values():
            ch.close()


def test_wire_bytes_identical_with_obs_off(clean_obs, monkeypatch):
    assert not cluster.telemetry_enabled()
    assert cluster.maybe_coordinated_dump("nope") is False
    sent = []
    real = tmh._send_msg

    def spy(sock, mtype, header, payload=b""):
        sent.append((mtype, dict(header)))
        return real(sock, mtype, header, payload)

    monkeypatch.setattr(tmh, "_send_msg", spy)
    chans = _build_pair(free_base_port(1))
    try:
        _one_round(chans)
        time.sleep(0.35)             # a few heartbeats
    finally:
        for ch in chans.values():
            ch.close()
    hbs = [h for m, h in sent if m == "hb"]
    assert hbs and all(h == {} for h in hbs)
    assert not [m for m, _ in sent if m == "dump"]
