"""The port's wire codec (fedml_tpu_torch/comm/message.py), reliability
envelope and trace propagation against the JAX package's.

Frames are held byte for byte: the same numpy message encodes to the same
bytes in both packages (v1, and v2 with each transport and with zlib), and
each package decodes the other's frames bitwise.  The bf16 leaves and the
bf16 transport are held against ml_dtypes without the port importing it.
Pure host, no sockets.
"""
import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

from fedml_tpu.comm import reliability as jrel
from fedml_tpu.comm.message import Message as JMessage
from fedml_tpu.comm.message import MessageCodec as JCodec
from fedml_tpu_torch import obs
from fedml_tpu_torch.comm import reliability
from fedml_tpu_torch.comm.inproc import InProcBackend, InProcRouter
from fedml_tpu_torch.comm.message import (BF16, Message, MessageCodec,
                                          bf16_bits)
from fedml_tpu_torch.comm.reliability import BackoffPolicy, ReliableEndpoint
from fedml_tpu_torch.obs import propagate

torch.set_num_threads(2)

TRANSPORTS = [None, "bf16", "int8", "sparse_topk"]


def _tree(seed: int) -> dict:
    """A params-shaped numpy tree mixing every leaf kind the payloads carry
    (bf16 through ml_dtypes, as a JAX sender holds it)."""
    rs = np.random.RandomState(seed)
    return {
        "dense": {"kernel": rs.randn(40, 16).astype(np.float32),
                  "bias": rs.randn(5).astype(np.float64)},
        "half": rs.randn(300).astype(np.float16),
        "bf16_w": rs.randn(4, 3).astype(ml_dtypes.bfloat16),
        "pixels": rs.randint(0, 256, (2, 8, 8)).astype(np.uint8),
        "q": rs.randint(-128, 128, (11,)).astype(np.int8),
        "flags": np.array([True, False, True]),
        "nested": [rs.randint(0, 9, (3,)).astype(np.int32), "a string",
                   7, 3.5, None, True],
        "tup": (rs.randn(2, 2).astype(np.float32), 42),
        "scalar": np.float32(1.25),
        "zero_d": np.asarray(np.int64(9)),
    }


def _pair(seed=0, kind=None, compress=False, **meta):
    """The same message built in both packages."""
    out = []
    for cls in (JMessage, Message):
        m = cls(3, 2, 0)
        m.add_params("model_params", _tree(seed))
        m.add_params("num_samples", 17.0)
        m.add_params("model_version", 5)
        if kind:
            m.set_wire_transport("model_params", kind, **meta)
        m.wire_compress = compress
        out.append(m)
    return out


def _as_numpy(leaf):
    """A decoded leaf as numpy, bf16 as its bit patterns (int16)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy(), BF16
        return leaf.numpy(), str(leaf.numpy().dtype)
    if leaf.dtype == np.dtype(ml_dtypes.bfloat16):
        return leaf.view(np.int16), BF16
    return leaf, str(leaf.dtype)


def _assert_same(a, b):
    """A JAX-decoded tree (numpy leaves) against a port-decoded one (torch
    leaves), bitwise."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, (np.ndarray, torch.Tensor)):
        (x, dx), (y, dy) = _as_numpy(a), _as_numpy(b)
        assert dx == dy and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    else:
        assert a == b


# ---------------------------------------------------------------------------
# frames byte for byte, and decoding across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("kind", TRANSPORTS)
def test_frames_byte_identical_and_cross_decode_bitwise(kind, compress):
    jm, pm = _pair(1, kind, compress)
    jf, pf = JCodec.encode(jm), MessageCodec.encode(pm)
    assert pf == jf
    assert pf[:4] == (b"FML1" if kind is None and not compress else b"FML2")
    # each package decodes the other's frame to what it decodes its own to
    _assert_same(JCodec.decode(jf).get_params(),
                 MessageCodec.decode(jf).get_params())
    _assert_same(JCodec.decode(pf).get_params(),
                 MessageCodec.decode(pf).get_params())
    # the chunked encoder's parts join to the frame
    total, parts = MessageCodec.encode_parts(pm)
    assert b"".join(parts) == pf and total == len(pf)


def test_secagg_frames_byte_identical():
    words = np.random.RandomState(0).randint(0, 2**31, 64).astype(np.uint32)
    frames = []
    for cls, codec in ((JMessage, JCodec), (Message, MessageCodec)):
        m = cls(3, 1, 0)
        m.add_params("model_params", words)
        m.set_wire_transport("model_params", "secagg", scale=1024, p=2**31 - 1)
        frames.append(codec.encode(m))
    assert frames[0] == frames[1]
    got = MessageCodec.decode(frames[0]).get("model_params")
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), words)
    msg, w, enc = MessageCodec.decode_secagg(frames[0], "model_params", 64)
    jmsg, jw, jenc = JCodec.decode_secagg(frames[0], "model_params", 64)
    np.testing.assert_array_equal(w.numpy(), jw)
    assert enc == jenc and msg.get("model_params") is None


def test_torch_leaves_encode_as_their_numpy_twins():
    """A message of torch tensors (bf16 included) encodes to the bytes of
    the same message of numpy / ml_dtypes arrays."""
    rs = np.random.RandomState(2)
    x32 = rs.randn(33, 7).astype(np.float32)
    xb = rs.randn(50).astype(np.float32)
    jm = JMessage(1, 0, 1)
    jm.add_params("w", {"a": x32, "b": xb.astype(ml_dtypes.bfloat16),
                        "i": np.arange(5), "s": np.asarray(np.float32(2))})
    pm = Message(1, 0, 1)
    pm.add_params("w", {"a": torch.from_numpy(x32),
                        "b": torch.from_numpy(xb).to(torch.bfloat16),
                        "i": torch.arange(5),
                        "s": torch.tensor(2.0)})
    assert MessageCodec.encode(pm) == JCodec.encode(jm)
    back = MessageCodec.decode(JCodec.encode(jm)).get("w")
    assert back["b"].dtype == torch.bfloat16
    assert torch.equal(back["b"], torch.from_numpy(xb).to(torch.bfloat16))
    assert back["s"].shape == (1,)          # 0-d leaves ride as [1]


def _bf16_inputs(dtype):
    rs = np.random.RandomState(3)
    f32 = np.float32
    special = np.array([0.0, -0.0, np.inf, -np.inf, 1.0, -1.0,
                        np.finfo(f32).max, -np.finfo(f32).max,
                        np.finfo(f32).tiny, 1e-40, -1e-40, 3e-45, 1e-39,
                        1.00390625, 1.01171875, 1.0078125,   # ties
                        9.18e-39, 1.1754942e-38], f32)
    bits = rs.randint(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    finite = bits.view(f32)
    finite = finite[np.isfinite(finite)]
    vals = np.concatenate([special, finite, rs.randn(4096).astype(f32) * 1e3])
    with np.errstate(over="ignore"):
        return vals.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16])
def test_bf16_transport_equals_ml_dtypes_on_finite_values(dtype):
    """torch's round-to-nearest-even cast against ml_dtypes' on ±0,
    subnormals (in and out), ties, the f32 range edges, ±inf and random
    bit patterns: bitwise on every non-NaN value."""
    a = _bf16_inputs(dtype)
    want = a.astype(ml_dtypes.bfloat16).view(np.int16)
    np.testing.assert_array_equal(bf16_bits(a), want)


def test_bf16_transport_nan_is_a_nan():
    """A NaN stays a NaN.  The bit patterns differ: torch's CPU cast writes
    0xffff for every NaN, ml_dtypes the quiet NaN 0x7fc0 with the input's
    sign (0xffc0 for -NaN).  The one difference, and never on model
    weights."""
    a = np.array([np.nan, -np.nan], np.float32)
    got = bf16_bits(a).view(np.uint16)
    assert all((g & 0x7F80) == 0x7F80 and (g & 0x007F) for g in got)
    back = MessageCodec.decode(_bf16_msg(a)).get("w")
    assert torch.isnan(back).all()


def _bf16_msg(a):
    m = Message(1, 0, 1)
    m.add_params("w", a)
    m.set_wire_transport("w", "bf16")
    return MessageCodec.encode(m)


# ---------------------------------------------------------------------------
# decode modes, decode_into, decode_sparse
# ---------------------------------------------------------------------------

def test_decode_copy_modes():
    m = Message(1, 0, 1)
    m.add_params("w", np.arange(4096, dtype=np.float32))
    payload = bytearray(MessageCodec.encode(m))
    never = MessageCodec.decode(payload, copy="never").get("w")
    always = MessageCodec.decode(payload).get("w")
    payload[-4:] = np.float32(-1.0).tobytes()
    assert float(never[-1]) == -1.0            # a view of the frame
    assert float(always[-1]) == 4095.0         # its own copy
    always += 1                                # and mutable
    with pytest.raises(ValueError, match="copy mode"):
        MessageCodec.decode(bytes(payload), copy="sometimes")


@dataclasses.dataclass
class Layout:
    """The duck-typed row layout decode_into takes (the fields of the JAX
    package's async_/staleness.py::RowLayout)."""
    key: str
    p: int
    offsets: dict


def _layout(tree: dict, key="model_params") -> Layout:
    off, offsets = 0, {}
    for name, a in tree.items():
        offsets[f"/{key}/{name}"] = (off, a.size, tuple(a.shape))
        off += a.size
    return Layout(key, off, offsets)


def _row_tree(seed, bf16=False):
    rs = np.random.RandomState(seed)
    tree = {"kernel": rs.randn(48, 16).astype(np.float32),
            "bias": rs.randn(16).astype(np.float32),
            "head": rs.randn(33).astype(np.float32)}
    if bf16:
        tree["kernel"] = tree["kernel"].astype(ml_dtypes.bfloat16)
    return tree


@pytest.mark.parametrize("wire", [
    {}, {"wire_compress": True}, {"kind": "bf16"},
    {"kind": "int8", "wire_compress": True}, {"kind": "sparse_topk"},
    {"bf16_leaf": True},
])
def test_decode_into_matches_decode_flatten_and_jax_bitwise(wire):
    tree = _row_tree(7, bf16=wire.get("bf16_leaf", False))
    m = JMessage(12, 3, 0)
    m.add_params("model_params", tree)
    m.add_params("num_samples", 17.0)
    if "kind" in wire:
        m.set_wire_transport("model_params", wire["kind"])
    m.wire_compress = wire.get("wire_compress", False)
    payload = JCodec.encode(m)
    layout = _layout(tree)
    row = torch.full((layout.p,), float("nan"))
    out = MessageCodec.decode_into(payload, row, layout)
    leaves = MessageCodec.decode(payload).get("model_params")
    ref = torch.cat([leaves[k].reshape(-1).float() for k in tree])
    assert torch.equal(row, ref)
    jrow = np.full((layout.p,), np.nan, np.float32)
    JCodec.decode_into(payload, jrow, layout)
    np.testing.assert_array_equal(row.numpy(), jrow)
    assert out.get("model_params") is None and out.get("num_samples") == 17.0


def test_decode_sparse_matches_jax():
    tree = _row_tree(4)
    m = JMessage(12, 3, 0)
    m.add_params("model_params", tree)
    m.set_wire_transport("model_params", "sparse_topk")
    payload = JCodec.encode(m)
    layout = _layout(tree)
    msg, idx, vals = MessageCodec.decode_sparse(payload, layout)
    _, jidx, jvals = JCodec.decode_sparse(payload, layout)
    assert idx.dtype == torch.int64 and vals.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(vals.numpy(), jvals)
    assert msg.get("model_params") is None


# ---------------------------------------------------------------------------
# hardening: the same errors by the same names
# ---------------------------------------------------------------------------

def _frames():
    m = JMessage(1, 0, 1)
    m.add_params("w", np.arange(32, dtype=np.float32))
    v1 = JCodec.encode(m)
    m.wire_compress = True
    v2 = JCodec.encode(m)
    return v1, v2


def _alien_kind():
    m = JMessage(1, 0, 1)
    m.add_params("model_params", {"w": np.arange(300, dtype=np.float32)})
    m.set_wire_transport("model_params", "int8")
    frame = JCodec.encode(m)
    return frame.replace(b'"kind": "int8"', b'"kind": "fp4x"')


BAD = {
    "magic": lambda: b"XXXX" + _frames()[0][4:],
    "envelope": lambda: b"FMLR" + _frames()[0][4:],
    "truncated_header": lambda: _frames()[0][:20],
    "truncated_buffer": lambda: _frames()[0][:-8],
    "truncated_v2": lambda: _frames()[1][:-8],
    "short_v2": lambda: _frames()[1][:6],
    "corrupt_zlib": lambda: _frames()[1][:13] + b"\x00" * 40,
    "version_skew": _alien_kind,
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_decode_hardening_matches_jax(case):
    payload = BAD[case]()
    with pytest.raises(ValueError) as jerr:
        JCodec.decode(payload)
    with pytest.raises(ValueError) as perr:
        MessageCodec.decode(payload)
    assert str(perr.value) == str(jerr.value)


def test_decode_into_refusals_by_name():
    tree = _row_tree(1)
    layout = _layout(tree)
    m = Message(12, 3, 0)
    m.add_params("model_params", tree)
    payload = MessageCodec.encode(m)
    with pytest.raises(ValueError, match="f32 CPU tensor"):
        MessageCodec.decode_into(payload, torch.zeros(layout.p,
                                                      dtype=torch.float64),
                                 layout)
    short = Layout("model_params", layout.p,
                   {k: v for k, v in layout.offsets.items() if "head" not in k})
    with pytest.raises(ValueError, match="not in the row layout"):
        MessageCodec.decode_into(payload, torch.zeros(layout.p), short)
    masked = Message(12, 3, 0)
    masked.add_params("model_params", np.zeros(layout.p, np.uint32))
    masked.set_wire_transport("model_params", "secagg", scale=8, p=97)
    with pytest.raises(ValueError, match="masked secagg frame"):
        MessageCodec.decode_into(MessageCodec.encode(masked),
                                 torch.zeros(layout.p),
                                 Layout("model_params", layout.p, {}))
    with pytest.raises(ValueError, match="unknown wire transport"):
        Message().set_wire_transport("w", "fp4x")


# ---------------------------------------------------------------------------
# the reliability envelope and trace propagation
# ---------------------------------------------------------------------------

def _variants():
    out = {}
    for kind in TRANSPORTS:
        for compress in (False, True):
            out[f"{kind}-{compress}"] = _pair(5, kind, compress)[1]
    return out


def test_reliability_envelope_carries_every_codec_flavour():
    """The envelope wraps each frame unchanged (wire == header + frame),
    its bytes are the JAX package's, and unwrapping gives the frame back
    bitwise."""
    tx = ReliableEndpoint(5, lambda p, w: None,
                          policy=BackoffPolicy(base_s=60.0))
    jtx = jrel.ReliableEndpoint(5, lambda p, w: None,
                                policy=jrel.BackoffPolicy(base_s=60.0))
    rx = ReliableEndpoint(0, lambda p, w: None)
    try:
        for name, msg in _variants().items():
            frame = MessageCodec.encode(msg)
            wire = tx.wrap(0, frame)
            assert wire[:4] == reliability.MAGIC
            assert wire[reliability.HEADER_LEN:] == frame, name
            assert wire == jtx.wrap(0, frame), name
            assert rx.on_wire(wire, reply=lambda w: None) == frame, name
    finally:
        for ep in (tx, jtx, rx):
            ep.close()


def test_reliable_inproc_pair_delivers_every_flavour():
    router = InProcRouter()
    a, b = InProcBackend(0, router), InProcBackend(1, router)
    assert a.enable_reliability()
    try:
        for name, msg in _variants().items():
            msg.receiver_id = 1
            msg.msg_params[Message.MSG_ARG_KEY_RECEIVER] = 1
            want = MessageCodec.decode(MessageCodec.encode(msg)).get_params()
            a.send_message(msg)
            got = b._inbox.get(timeout=10)
            _assert_same({k: _tonp(v) for k, v in want.items()},
                         got.get_params())
    finally:
        a.stop_receive_message()
        b.stop_receive_message()


def _tonp(v):
    """Port leaves as numpy (bf16 as ml_dtypes), so _assert_same can take
    a port tree on its JAX side."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return v.numpy()
    if isinstance(v, dict):
        return {k: _tonp(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_tonp(x) for x in v)
    return v


@pytest.fixture
def clean_obs():
    obs.reset()
    yield
    obs.reset()


def test_obs_off_frames_byte_identical_and_on_stamps_one_block(clean_obs,
                                                               tmp_path):
    for name, msg in _variants().items():
        base = MessageCodec.encode(msg)
        propagate.stamp(msg, rank=2)                 # obs off: a no-op
        assert propagate.TRACE_KEY not in msg.msg_params, name
        assert MessageCodec.encode(msg) == base, name
    obs.configure(str(tmp_path), install_signal=False, export_at_exit=False)
    for name, msg in _variants().items():
        keys = set(msg.msg_params)
        propagate.stamp(msg, rank=2)
        assert set(msg.msg_params) == keys | {propagate.TRACE_KEY}, name
        blk = MessageCodec.decode(MessageCodec.encode(msg)).get(
            propagate.TRACE_KEY)
        assert blk["r"] == 2 and "t" in blk and "d" in blk, name


def test_propagate_note_strips_the_block_and_feeds_the_clock(clean_obs,
                                                             tmp_path):
    obs.configure(str(tmp_path), install_signal=False, export_at_exit=False)
    router = InProcRouter()
    a, b = InProcBackend(0, router), InProcBackend(1, router)
    try:
        for hop in range(3):
            m = Message("ping", 0, 1)
            m.add_params("round_idx", hop)
            a.send_message(m)
            got = b._inbox.get(timeout=10)
            assert propagate.TRACE_KEY not in got.msg_params
            r = Message("pong", 1, 0)
            b.send_message(r)
            a._inbox.get(timeout=10)
        assert 0 in b._clock.offsets() and 1 in a._clock.offsets()
        recv = [e for e in obs.tracer().events() if e["name"] == "trace.recv"]
        assert len(recv) == 6 and {e["args"]["peer"] for e in recv} == {0, 1}
        assert obs.registry().counter("trace_frames_total",
                                      backend="inproc").value == 6
        assert "clock_offsets" in obs.export()
    finally:
        a.stop_receive_message()
        b.stop_receive_message()


def test_obs_off_backend_send_is_byte_identical(clean_obs):
    seen = {}

    class Capture(InProcRouter):
        def route(self, msg):
            seen["frame"] = MessageCodec.encode(msg)
            return len(seen["frame"])

    be = InProcBackend(0, Capture())
    for name, msg in _variants().items():
        ref = MessageCodec.encode(msg)
        be.send_message(msg)
        assert seen["frame"] == ref, name
