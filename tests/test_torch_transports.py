"""The port's byte transports (fedml_tpu_torch/comm/): a loopback round
trip on each of INPROC, TCP with threads, TCP with the reactor, the native
C++ transport and gRPC; a TCP and a gRPC exchange between a JAX-package
peer and a port peer, bitwise; the managers' backend names and refusals;
the native library's build; and the kernels' thread-safe build and launch
counting.

Every socket test takes free ports from above the kernel's ephemeral range
(where neither the JAX tests' fixed ports nor any socket bound to port 0
can lie), checked by binding and retaken when a race loses them; every
wait is bounded.
"""
import ast
import errno
import random
import socket
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from fedml_tpu_torch.comm import ClientManager, Message, ServerManager
from fedml_tpu_torch.comm.inproc import InProcBackend, InProcRouter
from fedml_tpu_torch.comm.managers import _build_backend

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
WAIT = 20.0


def _port_band() -> tuple[int, int]:
    """Ports no test of the suite can be using: above the kernel's
    ephemeral range (the JAX tests' fixed ports, 23456-57700, and every
    port-0 bind lie below it), else a band below it."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            lo, hi = map(int, f.read().split())
    except (OSError, ValueError):
        lo, hi = 32768, 60999
    return (hi + 1, 65535) if hi < 64000 else (58000, lo)


def free_base_port(n: int, tries: int = 200) -> int:
    """A base port p with p .. p + n - 1 all free right now, from the band
    of _port_band, checked by binding each."""
    lo, hi = _port_band()
    rng = random.Random()
    for _ in range(tries):
        base = rng.randrange(lo, hi - n)
        socks = []
        try:
            for r in range(n):
                s = socket.socket()
                socks.append(s)
                s.bind(("0.0.0.0", base + r))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no {n} consecutive free ports in {lo}-{hi}")


def _port_taken(e: Exception) -> bool:
    return (getattr(e, "errno", None) == errno.EADDRINUSE
            or any(m in str(e) for m in ("cannot listen", "Failed to bind",
                                         "Address already in use")))


def with_free_ports(n: int, fn, attempts: int = 5):
    """fn(base) on n free ports; if another process takes one between the
    check and fn's bind (fn must release what it bound before raising),
    again on new ports."""
    for i in range(attempts):
        try:
            return fn(free_base_port(n))
        except (OSError, RuntimeError) as e:
            if not _port_taken(e) or i == attempts - 1:
                raise


def _payload(seed=0):
    rs = np.random.RandomState(seed)
    return {"w": torch.from_numpy(rs.rand(128, 16).astype(np.float32)),
            "h": torch.from_numpy(rs.randn(300).astype(np.float32)).to(
                torch.bfloat16),
            "i": np.arange(7, dtype=np.int64)}


def _check(got, want):
    for k in want:
        assert torch.equal(torch.as_tensor(got[k]), torch.as_tensor(want[k])), k


def _pair(kind: str):
    ip = {0: "127.0.0.1", 1: "127.0.0.1"}
    if kind == "INPROC":
        router = InProcRouter()
        return InProcBackend(0, router), InProcBackend(1, router)
    if kind.startswith("TCP"):
        from fedml_tpu_torch.comm.tcp_backend import TcpBackend
        make = lambda r, base: TcpBackend(r, ip, base,
                                          reactor=kind == "TCP_REACTOR")
    elif kind == "NATIVE_TCP":
        from fedml_tpu_torch.comm.native_tcp import NativeTcpBackend
        make = lambda r, base: NativeTcpBackend(r, ip, base)
    else:
        from fedml_tpu_torch.comm.grpc_backend import GrpcBackend
        make = lambda r, base: GrpcBackend(r, ip, base)
    return with_free_ports(2, lambda base: _both(lambda: make(0, base),
                                                 lambda: make(1, base)))


def _both(make_a, make_b):
    """Two backends, or none: the first is closed if the second fails."""
    a = make_a()
    try:
        return a, make_b()
    except BaseException:
        _close(a)
        raise


def _close(*backends):
    for b in backends:
        b.stop_receive_message()
        close = getattr(b, "close", None)
        if close is not None:
            close()


@pytest.mark.parametrize("kind", ["INPROC", "TCP_THREADS", "TCP_REACTOR",
                                  "NATIVE_TCP", "GRPC"])
def test_loopback_round_trip(kind):
    a, b = _pair(kind)
    try:
        want = _payload(1)
        msg = Message(3, 0, 1)
        msg.add_params("model_params", want)
        msg.add_params("num_samples", 17.0)
        a.send_message(msg)
        got = b._inbox.get(timeout=WAIT)
        assert got.get_type() == 3 and got.get("num_samples") == 17.0
        _check(got.get("model_params"), want)
        # and back, on the v2 wire (bf16 transport + zlib head)
        rsp = Message(4, 1, 0)
        rsp.add_params("model_params", {"w": want["w"]})
        rsp.set_wire_transport("model_params", "bf16")
        rsp.wire_compress = True
        b.send_message(rsp)
        back = a._inbox.get(timeout=WAIT).get("model_params")["w"]
        assert torch.equal(back, want["w"].to(torch.bfloat16).float())
        assert b._m_sent_bytes.value > 0 and a._m_recv_bytes.value > 0
    finally:
        _close(a, b)


@pytest.mark.parametrize("port_sends", [True, False])
@pytest.mark.parametrize("kind", ["TCP", "GRPC"])
def test_jax_and_port_peers_exchange_bitwise(kind, port_sends):
    """A JAX-package backend and a port backend of the same transport talk
    to each other: plain arrays cross bitwise in both directions."""
    from fedml_tpu.comm.message import Message as JMessage
    if kind == "TCP":
        from fedml_tpu.comm.tcp_backend import TcpBackend as JBackend
        from fedml_tpu_torch.comm.tcp_backend import TcpBackend as PBackend
    else:
        from fedml_tpu.comm.grpc_backend import GrpcBackend as JBackend
        from fedml_tpu_torch.comm.grpc_backend import GrpcBackend as PBackend
    ip = {0: "127.0.0.1", 1: "127.0.0.1"}
    port_rank = 0 if port_sends else 1
    p, j = with_free_ports(2, lambda base: _both(
        lambda: PBackend(port_rank, ip, base_port=base),
        lambda: JBackend(1 - port_rank, ip, base_port=base)))
    try:
        rs = np.random.RandomState(4)
        w = rs.rand(128, 16).astype(np.float32)
        b = rs.randn(64).astype(np.float64)
        cls, sender, receiver = ((Message, p, j) if port_sends
                                 else (JMessage, j, p))
        msg = cls(3, sender.rank, receiver.rank)
        msg.add_params("model_params", {"w": w, "b": b})
        msg.add_params("round_idx", 2)
        sender.send_message(msg)
        got = receiver._inbox.get(timeout=WAIT)
        leaves = got.get("model_params")
        assert got.get("round_idx") == 2
        np.testing.assert_array_equal(np.asarray(leaves["w"]), w)
        np.testing.assert_array_equal(np.asarray(leaves["b"]), b)
        assert np.asarray(leaves["b"]).dtype == np.float64
    finally:
        _close(p, j)


def test_native_library_builds_into_the_package_build_dir():
    from fedml_tpu_torch import native
    lib = native.load_library()
    assert lib is not None and native.library_built()
    assert native._SO.parent == REPO / "fedml_tpu_torch" / "_build"


# ---------------------------------------------------------------------------
# managers
# ---------------------------------------------------------------------------

def test_manager_fsm_ping_pong():
    router = InProcRouter()
    log = []

    class Server(ServerManager):
        def register_message_receive_handlers(self):
            self.register_message_receive_handler("pong", self._on_pong)

        def _on_pong(self, msg):
            log.append(msg.get("hops"))
            if msg.get("hops") < 3:
                out = Message("ping", 0, 1)
                out.add_params("hops", msg.get("hops") + 1)
                self.send_message(out)
            else:
                self.finish()

    class Client(ClientManager):
        def register_message_receive_handlers(self):
            self.register_message_receive_handler("ping", self._on_ping)

        def _on_ping(self, msg):
            out = Message("pong", 1, 0)
            out.add_params("hops", msg.get("hops"))
            self.send_message(out)

    server = Server(0, 2, "INPROC", router=router)
    client = Client(1, 2, "INPROC", router=router)
    client.run_async()
    st = server.run_async()
    first = Message("ping", 0, 1)
    first.add_params("hops", 0)
    server.send_message(first)
    st.join(timeout=WAIT)
    client.finish()
    assert log == [0, 1, 2, 3]


def test_backend_names_and_the_mqtt_refusal():
    ip = {0: "127.0.0.1"}
    for name, cls in (("tcp", "TcpBackend"), ("native_tcp",
                                               "NativeTcpBackend")):
        be = with_free_ports(1, lambda base: _build_backend(
            name, 0, 1, ip_config=ip, base_port=base, force_python_tcp=True))
        try:
            assert type(be).__name__ == cls
        finally:
            _close(be)
    # MQTT is built now (a broker client); with no broker it refuses
    with pytest.raises(ConnectionRefusedError):
        _build_backend("MQTT", 0, 2, port=free_base_port(1))
    with pytest.raises(ValueError, match="unknown comm backend"):
        _build_backend("MPI", 0, 2)


def test_tcp_upgrades_to_native_only_when_built(monkeypatch):
    from fedml_tpu_torch import native
    ip = {0: "127.0.0.1"}
    monkeypatch.setattr(native, "library_built", lambda: False)
    be = with_free_ports(1, lambda base: _build_backend(
        "TCP", 0, 1, ip_config=ip, base_port=base))
    try:
        assert type(be).__name__ == "TcpBackend"
    finally:
        _close(be)
    native.load_library()
    monkeypatch.setattr(native, "library_built", lambda: True)
    be = with_free_ports(1, lambda base: _build_backend(
        "TCP", 0, 1, ip_config=ip, base_port=base))
    try:
        assert type(be).__name__ == "NativeTcpBackend"
    finally:
        _close(be)


def test_comm_imports_no_grpc_ml_dtypes_or_jax():
    """Only grpc_backend.py may import grpc, and only inside the backend
    (the card's machine has no grpcio); nothing imports ml_dtypes."""
    files = sorted((REPO / "fedml_tpu_torch").rglob("*.py"))
    bad = []
    for f in files:
        tree = ast.parse(f.read_text(), str(f))
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for m in names:
                top = m.split(".")[0]
                if top in ("ml_dtypes", "jax", "fedml_tpu"):
                    bad.append((f.name, m))
                if top == "grpc" and (f.name != "grpc_backend.py"
                                      or node.col_offset == 0):
                    bad.append((f.name, m))
    assert bad == []
    assert (REPO / "fedml_tpu_torch" / "comm" / "grpc_backend.py").exists()


# ---------------------------------------------------------------------------
# the kernels' library and launch counters under threads
# ---------------------------------------------------------------------------

def test_kernel_library_builds_once_under_eight_threads(monkeypatch,
                                                        tmp_path):
    """Eight threads reach library() at once; the (slow) build runs once
    and every thread gets the one loaded library."""
    from fedml_tpu_torch.ops import build
    built, loaded = [], []

    def slow_build():
        built.append(threading.get_ident())
        time.sleep(0.3)
        return tmp_path / "libfedml_kernels.so"

    class Entry:                      # takes argtypes/restype like ctypes'
        pass

    def fake_cdll(path):
        loaded.append(path)
        lib = type("Lib", (), {})()
        for name in list(build.SIGNATURES) + ["fedml_error_string"]:
            setattr(lib, name, Entry())
        return lib

    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "build", slow_build)
    monkeypatch.setattr(build.ctypes, "CDLL", fake_cdll)
    got = []
    threads = [threading.Thread(target=lambda: got.append(build.library()))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert len(built) == 1 and len(loaded) == 1
    assert len(got) == 8 and all(g is got[0] for g in got)


def test_launch_counts_are_exact_under_threads():
    """More threads than cores count launches with the interpreter switching
    threads every microsecond: no increment is lost."""
    import sys

    from fedml_tpu_torch.ops import (build, gn_forward, launch_counts,
                                     reset_launch_counts)
    reset_launch_counts()

    def hammer():
        for _ in range(2000):
            build.count_launch(gn_forward)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert launch_counts()["gn_forward"] == 32_000
    reset_launch_counts()
    assert set(launch_counts().values()) == {0}


def test_groupnorm_counters_serve_one_stream(monkeypatch):
    """The backward's arrival counters are per device and claimed by the
    first stream that launches on it; a launch from another stream of that
    device raises instead of sharing them."""
    import fedml_tpu_torch.ops.groupnorm as gn
    monkeypatch.setattr(gn, "_FINISH_COUNTERS", {})
    monkeypatch.setattr(gn, "_FINISH_STREAMS", {})
    stream = {"id": 0x10}
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: type(
        "S", (), {"cuda_stream": stream["id"]})())
    dev = torch.device("cpu")
    first = gn._finish_counter(dev, 2)
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        gn._finish_counter(dev, 2))) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert len(got) == 8 and all(g is first for g in got)
    assert int(first.abs().sum()) == 0
    stream["id"] = 0x20
    with pytest.raises(RuntimeError, match="one stream"):
        gn._finish_counter(dev, 2)
