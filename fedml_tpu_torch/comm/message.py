"""Message envelope + wire codecs (port of fedml_tpu/comm/message.py).

Parity: fedml_core/distributed/communication/message.py:5-74 — a typed
key→value bag with sender/receiver ids and JSON serialization.  The
reference JSON-encodes model weights as nested Python lists on the mobile
path (fedml_api/distributed/fedavg/utils.py:7-16) and pickles state dicts
through MPI otherwise; here the default codec is a compact self-describing
binary frame (JSON header + raw little-endian array buffers), and
`to_json` keeps the mobile-parity list form.

The frames are the JAX package's, byte for byte: the same message built
from numpy arrays encodes to the same bytes in both packages, and each
decodes the other's frames.  What differs is the array boundary:

* a leaf may be a numpy array or a torch tensor on any device; a tensor
  on the card is copied to the host once, at encode;
* bfloat16 needs no ml_dtypes: a bf16 tensor rides as its 16-bit
  patterns (``t.view(torch.int16)``) under the dtype name "bfloat16",
  exactly the bytes and name an ml_dtypes bf16 array gives;
* decoded leaves are torch CPU tensors (bf16 included).

Wire codec v2 (transfer-compression layer): the FedAvg round's dominant
wire cost is raw f32 model buffers (the reference pays the same cost
through MPI pickles/JSON — FedML arXiv:2007.13518).  v2 adds, all OPT-IN
per message key:

* per-array transport dtypes — f32→bf16 (2x; torch's round-to-nearest-
  even cast, which equals ml_dtypes' on every finite value) or int8 +
  per-tensor affine scale (4x; f64 numpy math on the host, as the JAX
  package), restored to the original dtype on decode.  Aggregation-
  critical payloads simply stay un-opted (exact, bitwise round trip);
* sparse_topk: only the k = max(1, n // SPARSE_TOPK_RATIO) largest-
  |value| entries of a float array ship, as u32 idx[k] ‖ f32 val[k] in
  one u8 wire blob (~8x fewer bytes at the default ratio 16, LOSSY).
  decode() densifies; decode_into() scatters the pairs straight into the
  preallocated flat row; decode_sparse() returns the (global-index,
  value) pairs without ever densifying;
* secagg: masked fixed-point field words that pass through opaque;
* zlib compression of the header + small-array section;
* a chunked streaming encoder (`encode_parts`) that hands the frame to
  the socket as a prefix + per-buffer parts instead of one joined buffer.

Frames with no v2 feature active still encode as v1 ("FML1") — decode
accepts both magics.  FEDML_WIRE_V1=1 is the escape hatch: it forces v1
frames (features ignored) process-wide.
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Any, Optional

import numpy as np
import torch

from fedml_tpu_torch import obs

# the v2 per-array wire transports this build can encode AND decode —
# named in the version-skew rejection so an old server tells the operator
# WHICH codec it is missing instead of dying in a thread.  "secagg" is
# special: not lossy but OPAQUE — masked fixed-point field words that only
# a secure commit barrier can turn back into floats, so plain decode hands
# the raw words through and decode_into refuses them by name.
WIRE_TRANSPORTS = ("bf16", "int8", "sparse_topk", "secagg")

# ship 1-in-16 entries on the sparse_topk wire (8 B per kept entry)
SPARSE_TOPK_RATIO = 16

# the wire name of bfloat16, and the numpy dtype its 16-bit patterns are
# carried in on the host
BF16 = "bfloat16"
_BF16_BITS = np.dtype(np.int16)


class Message:
    """Typed message with params; mirrors the reference's constant names."""

    MSG_ARG_KEY_OPERATION = "operation"
    MSG_ARG_KEY_TYPE = "msg_type"
    MSG_ARG_KEY_SENDER = "sender"
    MSG_ARG_KEY_RECEIVER = "receiver"

    MSG_OPERATION_SEND = "send"
    MSG_OPERATION_RECEIVE = "receive"
    MSG_OPERATION_BROADCAST = "broadcast"
    MSG_OPERATION_REDUCE = "reduce"

    def __init__(self, type: Any = 0, sender_id: int = 0,
                 receiver_id: int = 0):
        self.type = type
        self.sender_id = sender_id
        self.receiver_id = receiver_id
        # send-side wire hints (NOT serialized; decode never restores
        # them): per-key transport dtypes + frame compression, consumed
        # by MessageCodec.encode_parts.  Default empty/off = v1 frame,
        # bitwise-exact arrays.
        self.wire_transport: dict[str, str] = {}
        self.wire_transport_meta: dict[str, dict] = {}
        self.wire_compress: bool = False
        self.msg_params: dict[str, Any] = {
            Message.MSG_ARG_KEY_TYPE: type,
            Message.MSG_ARG_KEY_SENDER: sender_id,
            Message.MSG_ARG_KEY_RECEIVER: receiver_id,
        }

    def set_wire_transport(self, key: str, kind: Optional[str],
                           **meta) -> None:
        """Opt this message key's float arrays into a lossy wire dtype:
        "bf16" (2x), "int8" (4x, per-tensor affine scale), or
        "sparse_topk" (~8x, top-k index/value pairs).  None/"none" clears
        the opt-in.  Keys never opted in ride exact — keep aggregation-
        critical payloads (e.g. model averages) that way unless the caller
        accepts the precision tradeoff.

        "secagg" marks the key's array as MASKED fixed-point field words;
        it requires `scale=` and `p=` meta kwargs because the codec cannot
        recover the quantization parameters from masked words — they ride
        in the frame's enc header so the unmask barrier is
        self-describing."""
        if kind in (None, "none"):
            self.wire_transport.pop(key, None)
            self.wire_transport_meta.pop(key, None)
            return
        if kind not in WIRE_TRANSPORTS:
            raise ValueError(f"unknown wire transport {kind!r} "
                             f"(choose one of {WIRE_TRANSPORTS})")
        if kind == "secagg" and not {"scale", "p"} <= set(meta):
            raise ValueError(
                "secagg transport needs scale= and p= meta (the codec "
                "cannot infer quantization parameters from masked words)")
        self.wire_transport[key] = kind
        if meta:
            self.wire_transport_meta[key] = dict(meta)

    # -- reference API (message.py:23-61) -----------------------------------
    def init(self, msg_params):
        self.msg_params = dict(msg_params)
        self.type = self.msg_params.get(Message.MSG_ARG_KEY_TYPE)
        self.sender_id = self.msg_params.get(Message.MSG_ARG_KEY_SENDER, 0)
        self.receiver_id = self.msg_params.get(Message.MSG_ARG_KEY_RECEIVER, 0)
        return self

    def get_sender_id(self) -> int:
        return int(self.msg_params[Message.MSG_ARG_KEY_SENDER])

    def get_receiver_id(self) -> int:
        return int(self.msg_params[Message.MSG_ARG_KEY_RECEIVER])

    def add_params(self, key: str, value: Any) -> None:
        self.msg_params[key] = value

    def add(self, key: str, value: Any) -> None:
        self.add_params(key, value)

    def get(self, key: str, default: Any = None) -> Any:
        return self.msg_params.get(key, default)

    def get_params(self) -> dict:
        return self.msg_params

    def get_type(self):
        return self.msg_params[Message.MSG_ARG_KEY_TYPE]

    def to_string(self) -> str:
        return (f"Message(type={self.type}, sender={self.sender_id}, "
                f"receiver={self.receiver_id}, "
                f"keys={sorted(self.msg_params)})")

    __repr__ = to_string

    # -- mobile-parity JSON (lists) -----------------------------------------
    def to_json(self) -> str:
        """JSON with tensor/ndarray leaves as nested lists (the reference's
        --is_mobile transform, fedavg/utils.py:7-16, applied at the
        envelope instead of per call site)."""
        def conv(v):
            if isinstance(v, torch.Tensor):
                return v.detach().cpu().tolist()
            if isinstance(v, np.ndarray):
                return v.tolist()
            if hasattr(v, "__array__") and not isinstance(v, (int, float,
                                                              bool, str)):
                return np.asarray(v).tolist()
            if isinstance(v, dict):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [conv(x) for x in v]
            return v
        return json.dumps({k: conv(v) for k, v in self.msg_params.items()})

    @classmethod
    def from_json(cls, payload: str) -> "Message":
        return cls().init(json.loads(payload))


# -- the array boundary -------------------------------------------------------

def _np_dtype(name: str) -> np.dtype:
    """The host numpy dtype a wire dtype name's bytes are read as:
    bfloat16's 16-bit patterns ride in int16."""
    if name == BF16:
        return _BF16_BITS
    try:
        return np.dtype(name)
    except TypeError:
        raise TypeError(f"undecodable array dtype {name!r}") from None


def _host_array(obj) -> tuple[np.ndarray, str]:
    """(contiguous host numpy array, wire dtype name) of one array leaf.  A
    tensor on another device is copied to the host here, once; a bf16
    tensor gives its bit patterns as int16 under the name "bfloat16"."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            return np.ascontiguousarray(t.view(torch.int16).numpy()), BF16
        a = np.ascontiguousarray(t.resolve_conj().resolve_neg().numpy())
        return a, str(a.dtype)
    a = np.ascontiguousarray(np.asarray(obj))
    return a, str(a.dtype)


def _to_tensor(a: np.ndarray, name: str) -> torch.Tensor:
    """A decoded host array as a torch CPU tensor (shares its memory)."""
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if name == BF16 else t


def _is_float(a: np.ndarray, name: str) -> bool:
    """Float arrays take the lossy transports; bfloat16 (not a numpy
    floating type, as in the JAX package) and integers ride exact."""
    return name != BF16 and np.issubdtype(a.dtype, np.floating)


def _writable(a: np.ndarray) -> np.ndarray:
    return a if a.flags.writeable else a.copy()


def bf16_bits(a: np.ndarray) -> np.ndarray:
    """float16/32/64 host array -> bfloat16 bit patterns (int16), by torch's
    round-to-nearest-even cast."""
    return torch.from_numpy(_writable(a)).to(torch.bfloat16).view(
        torch.int16).numpy()


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns -> float32, exactly (the upper half-word)."""
    return (bits.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


# -- the v2 int8/affine fixed-point discipline -------------------------------
# One definition of the quantization math (host numpy in f64, as the JAX
# package), so every decoder agrees bit for bit with the encoder.
# scale/min may be scalars (per-tensor) or arrays broadcast per element.

def affine_int8_scale(mn, mx):
    """Affine scale for [mn, mx] → 255 int8 steps; 1.0 for a degenerate
    (constant) range so encode/decode stay finite."""
    return (mx - mn) / 255.0 or 1.0


def affine_int8_encode(a: np.ndarray, mn, scale) -> np.ndarray:
    """q = round((x - min)/scale) - 128, clipped to int8 — f64 math so
    every host quantizes identically regardless of simd path."""
    return np.clip(np.rint((a.astype(np.float64) - mn) / scale) - 128,
                   -128, 127).astype(np.int8)


def affine_int8_decode(q: np.ndarray, mn, scale, dtype=np.float32):
    """Exact inverse placement: x̂ = (q + 128)·scale + min, f64 math."""
    return ((q.astype(np.float64) + 128.0) * scale + mn).astype(dtype)


def _skew_error(kind) -> ValueError:
    return ValueError(
        f"unknown wire transport encoding {kind!r} — this peer decodes "
        f"{list(WIRE_TRANSPORTS)}; a newer sender (version skew)? upgrade "
        f"this server or clear the sender's set_wire_transport opt-in")


class MessageCodec:
    """Binary wire format: magic ‖ header length ‖ JSON header ‖ buffers.

    Tree leaves that are tensors or numpy arrays are flattened into
    contiguous little-endian buffers referenced from the header by (path,
    dtype, shape, offset).  Everything else must be JSON-serializable.

    v1 ("FML1"): 4B magic ‖ u64 LE header length ‖ JSON header ‖ raw
    buffers, in array order.

    v2 ("FML2"): 4B magic ‖ 1B flags ‖ u64 LE head length ‖ head ‖ big
    buffers.  `head` is (zlib-compressed iff flags&1): u64 LE JSON
    length ‖ JSON header ‖ small-array buffers (arrays ≤ SMALL_LIMIT
    bytes ride inside the head so header+small arrays compress
    together).  Array meta may carry an "enc" record describing a lossy
    transport dtype ({"kind": "bf16"|"int8", "orig": dtype[, "scale",
    "min"]}); decode restores the original dtype.  encode emits v1
    whenever no v2 feature is active; decode accepts both magics.
    """

    MAGIC = b"FML1"
    MAGIC_V2 = b"FML2"
    FLAG_ZLIB = 0x01
    SMALL_LIMIT = 1024          # arrays ≤ this ride in the head section
    ENV_FORCE_V1 = "FEDML_WIRE_V1"   # escape hatch: ignore v2 features

    @staticmethod
    def _flatten(obj, path, arrays, meta, paths):
        if isinstance(obj, dict):
            return {k: MessageCodec._flatten(v, f"{path}/{k}", arrays,
                                             meta, paths)
                    for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            out = [MessageCodec._flatten(v, f"{path}/{i}", arrays, meta,
                                         paths)
                   for i, v in enumerate(obj)]
            return out if isinstance(obj, list) else {"__tuple__": out}
        if isinstance(obj, (torch.Tensor, np.ndarray)) or (
                hasattr(obj, "__array__")
                and not isinstance(obj, (int, float, bool, str, bytes))):
            a, name = _host_array(obj)
            ref = len(arrays)
            arrays.append(a)
            meta.append({"dtype": name, "shape": list(a.shape)})
            paths.append(path)
            return {"__array__": ref}
        if isinstance(obj, (np.integer,)):
            return int(obj)
        if isinstance(obj, (np.floating,)):
            return float(obj)
        return obj

    @staticmethod
    def _unflatten(obj, buffers):
        if isinstance(obj, dict):
            if "__array__" in obj and len(obj) == 1:
                return buffers[obj["__array__"]]
            if "__tuple__" in obj and len(obj) == 1:
                return tuple(MessageCodec._unflatten(v, buffers)
                             for v in obj["__tuple__"])
            return {k: MessageCodec._unflatten(v, buffers)
                    for k, v in obj.items()}
        if isinstance(obj, list):
            return [MessageCodec._unflatten(v, buffers) for v in obj]
        return obj

    # -- transport dtypes ----------------------------------------------------
    @staticmethod
    def _transport_kind(path: str, transport: dict) -> Optional[str]:
        for key, kind in transport.items():
            pre = "/" + key
            if path == pre or path.startswith(pre + "/"):
                return kind
        return None

    @staticmethod
    def _encode_transport(a: np.ndarray, kind: str, m: dict,
                          extra: Optional[dict] = None) -> np.ndarray:
        """Lossy wire encoding of one float array; updates its meta
        record in place.  Non-float (and non-finite int8 candidates)
        stay exact — a silent fallback beats a corrupt quantization."""
        if kind == "secagg":
            # masked field words (uint32 residues mod p): the payload is
            # already its own wire form — pass through and stamp the
            # self-describing enc header.  This branch MUST precede the
            # float guard: the array is integer by design.
            if not extra or not {"scale", "p"} <= set(extra):
                raise ValueError(
                    "secagg transport needs scale=/p= meta from "
                    "set_wire_transport (unrecoverable from masked words)")
            w = np.ascontiguousarray(a, np.uint32)
            orig = m["dtype"]
            m["dtype"] = "uint32"
            m["shape"] = list(w.shape)
            m["enc"] = {"kind": "secagg", "orig": orig,
                        "oshape": list(a.shape),
                        "scale": int(extra["scale"]), "p": int(extra["p"])}
            return w
        if not _is_float(a, m["dtype"]):
            return a
        if kind == "bf16":
            w = bf16_bits(a)
            m["dtype"] = BF16
            m["enc"] = {"kind": "bf16", "orig": str(a.dtype)}
            return w
        if kind == "sparse_topk":
            # top-k magnitude pairs: u32 idx[k] ‖ f32 val[k] in one u8
            # blob.  Index-sorted so the wire form is deterministic.
            if a.size == 0 or not np.all(np.isfinite(a)):
                return a
            flat = np.ascontiguousarray(a, dtype=np.float32).ravel()
            k = max(1, flat.size // SPARSE_TOPK_RATIO)
            if k >= flat.size:
                return a               # nothing to drop; ride exact
            sel = np.argpartition(np.abs(flat), flat.size - k)[-k:]
            sel = np.sort(sel).astype("<u4")
            w = np.frombuffer(
                sel.tobytes() + flat[sel].astype("<f4").tobytes(),
                dtype=np.uint8)
            m["dtype"] = "uint8"
            m["shape"] = [int(w.size)]
            m["enc"] = {"kind": "sparse_topk", "orig": str(a.dtype),
                        "oshape": list(a.shape), "k": int(k)}
            return w
        # int8 + per-tensor affine: q = round((x - min)/scale) - 128
        if a.size == 0 or not np.all(np.isfinite(a)):
            return a
        mn = float(np.min(a))
        mx = float(np.max(a))
        scale = affine_int8_scale(mn, mx)
        q = affine_int8_encode(a, mn, scale)
        m["dtype"] = "int8"
        m["enc"] = {"kind": "int8", "orig": str(a.dtype),
                    "scale": scale, "min": mn}
        return q

    @staticmethod
    def _sparse_pairs(a: np.ndarray, enc: dict):
        """(idx u32[k], vals f32[k]) views of one sparse_topk wire blob."""
        k = int(enc["k"])
        blob = np.ascontiguousarray(a, dtype=np.uint8)
        if blob.size != 8 * k:
            raise ValueError(
                f"sparse_topk blob is {blob.size} B, k={k} needs {8 * k}")
        idx = blob[:4 * k].view("<u4")
        vals = blob[4 * k:].view("<f4")
        return idx, vals

    @staticmethod
    def _decode_transport(a: np.ndarray, enc: Optional[dict],
                          name: str) -> torch.Tensor:
        """One array off the wire (`name` its wire dtype) as a torch CPU
        tensor in its original dtype."""
        if not enc:
            return _to_tensor(a, name)
        orig_name = enc.get("orig", "float32")
        if enc["kind"] == "bf16":
            return _to_tensor(bf16_bits_to_f32(a).astype(
                _np_dtype(orig_name), copy=False), orig_name)
        if enc["kind"] == "int8":
            return _to_tensor(affine_int8_decode(
                a, enc["min"], enc["scale"], _np_dtype(orig_name)), orig_name)
        if enc["kind"] == "secagg":
            # masked fixed-point words CANNOT be dequantized per-array —
            # the pairwise masks only cancel in the cohort SUM.  Hand the
            # raw u32 residues through (a fresh, mutable copy to keep
            # decode's leaf contract); every other consumer quarantines
            # the uplink by its secagg marker.
            return torch.from_numpy(np.array(a, dtype=np.uint32))
        if enc["kind"] == "sparse_topk":
            idx, vals = MessageCodec._sparse_pairs(a, enc)
            oshape = tuple(enc.get("oshape", ()))
            n = int(np.prod(oshape, dtype=np.int64)) if oshape else 1
            if idx.size and int(idx.max()) >= n:
                raise ValueError(
                    f"sparse_topk index {int(idx.max())} outside "
                    f"original shape {oshape} (corrupt frame)")
            dense = np.zeros(n, dtype=np.float32)
            dense[idx] = vals
            return _to_tensor(dense.reshape(oshape).astype(
                _np_dtype(orig_name)), orig_name)
        raise _skew_error(enc.get("kind"))

    # -- encode --------------------------------------------------------------
    @staticmethod
    def _buf(a: np.ndarray):
        """Byte view of a contiguous array for the socket — zero-copy
        when the buffer protocol allows, tobytes() otherwise (extension
        dtypes refuse the memoryview cast)."""
        try:
            return a.data.cast("B")
        except (TypeError, ValueError, BufferError):
            return a.tobytes()

    @classmethod
    def encode_parts(cls, msg: Message) -> tuple[int, list]:
        """Chunked streaming encoder: returns (total_len, parts) where
        `parts` is a list of bytes-like objects whose concatenation is
        the frame.  Stream-capable backends (tcp) sendall() each part —
        the frame never exists as one contiguous buffer; the others join.
        Emits a v1 frame when no v2 feature is active (or FEDML_WIRE_V1=1
        forces it)."""
        arrays: list[np.ndarray] = []
        meta: list[dict] = []
        paths: list[str] = []
        tree = cls._flatten(msg.msg_params, "", arrays, meta, paths)
        raw_bytes = sum(a.nbytes for a in arrays)

        force_v1 = os.environ.get(cls.ENV_FORCE_V1, "") not in ("", "0")
        transport = {} if force_v1 else getattr(msg, "wire_transport", {})
        compress = (not force_v1) and getattr(msg, "wire_compress", False)

        if transport:
            tmeta = getattr(msg, "wire_transport_meta", {})
            for i, (a, m, p) in enumerate(zip(arrays, meta, paths)):
                kind = cls._transport_kind(p, transport)
                if kind is not None:
                    arrays[i] = cls._encode_transport(
                        a, kind, m, cls._transport_kind(p, tmeta))

        if not transport and not compress:       # plain v1 frame
            header = json.dumps({"tree": tree, "arrays": meta}).encode()
            parts = [cls.MAGIC + len(header).to_bytes(8, "little")
                     + header]
            parts += [cls._buf(a) for a in arrays]
            total = sum(len(p) if isinstance(p, (bytes, bytearray))
                        else p.nbytes for p in parts)
            cls._account(raw_bytes + len(header) + 12, total)
            return total, parts

        small = [a.nbytes <= cls.SMALL_LIMIT for a in arrays]
        for m, s in zip(meta, small):
            if s:
                m["small"] = True
        header = json.dumps({"tree": tree, "arrays": meta}).encode()
        head = b"".join(
            [len(header).to_bytes(8, "little"), header]
            + [a.tobytes() for a, s in zip(arrays, small) if s])
        flags = 0
        if compress:
            head = zlib.compress(head)
            flags |= cls.FLAG_ZLIB
        parts = [cls.MAGIC_V2 + bytes([flags])
                 + len(head).to_bytes(8, "little") + head]
        parts += [cls._buf(a) for a, s in zip(arrays, small) if not s]
        total = sum(len(p) if isinstance(p, (bytes, bytearray))
                    else p.nbytes for p in parts)
        cls._account(raw_bytes + len(header) + 13, total)
        return total, parts

    @staticmethod
    def _account(raw: int, wire: int) -> None:
        """Compression accounting (always-on metrics, fedml_tpu_torch/obs):
        raw = what the arrays+header would weigh uncompressed, wire =
        actual frame bytes; comm_compression_ratio is the cumulative
        raw/wire quotient."""
        c_raw = obs.counter("comm_raw_bytes_total")
        c_wire = obs.counter("comm_compressed_bytes_total")
        c_raw.inc(raw)
        c_wire.inc(wire)
        wired = c_wire.value
        if wired > 0:
            obs.gauge("comm_compression_ratio").set(c_raw.value / wired)

    @classmethod
    def encode(cls, msg: Message) -> bytes:
        """One contiguous frame.  Backends that need a single buffer (gRPC
        unary, native fh_send, inproc) call THIS — frame assembly has
        exactly one definition."""
        return b"".join(cls.encode_parts(msg)[1])

    # -- decode --------------------------------------------------------------
    @classmethod
    def _frame_header(cls, payload):
        """Shared v1/v2 frame parse: validates magic + lengths,
        decompresses the v2 head, and returns

            (header, small_src, small_off, big_off)

        where `header` is the JSON header dict, `small_src`/`small_off`
        locate the v2 head's small-array section (None/0 for v1), and
        `big_off` is the big-buffer section's offset into `payload`.
        Arrays then lie consecutively per section in meta order."""
        magic = bytes(payload[:4])
        if magic == cls.MAGIC:
            hoff, flags = 4, 0
        elif magic == cls.MAGIC_V2:
            hoff, flags = 5, payload[4]
        elif magic == b"FMLR":
            # a reliability envelope (comm/reliability.py) reached the
            # codec un-unwrapped — the receive chokepoint normally
            # strips it; name the layer so the misroute is debuggable
            raise ValueError(
                "bad frame magic b'FMLR': reliability envelope not "
                "unwrapped (route the frame through "
                "BaseCommManager._deliver_frame or "
                "ReliableEndpoint.on_wire before decode)")
        else:
            raise ValueError(f"bad frame magic {magic!r} (expected "
                             f"{cls.MAGIC!r} or {cls.MAGIC_V2!r})")
        if len(payload) < hoff + 8:
            raise ValueError("truncated frame: missing header length")
        hlen = int.from_bytes(payload[hoff:hoff + 8], "little")
        off = hoff + 8
        if off + hlen > len(payload):
            raise ValueError(
                f"truncated frame: header declares {hlen} bytes, payload "
                f"has {len(payload) - off} after the length field")
        if magic == cls.MAGIC:
            header = json.loads(bytes(payload[off:off + hlen]).decode())
            return header, None, 0, off + hlen
        head = payload[off:off + hlen]
        if flags & cls.FLAG_ZLIB:
            try:
                head = zlib.decompress(head)
            except zlib.error as e:
                raise ValueError(f"corrupt compressed head: {e}") from None
        if len(head) < 8:
            raise ValueError("truncated frame: head too short")
        jlen = int.from_bytes(head[:8], "little")
        if 8 + jlen > len(head):
            raise ValueError("truncated frame: head JSON overruns")
        header = json.loads(bytes(head[8:8 + jlen]).decode())
        return header, head, 8 + jlen, off + hlen

    @classmethod
    def _each_array(cls, header, payload, small_src, small_off, big_off):
        """Yield (index, meta, src, offset, dtype, count) for every
        array in the frame, walking the small (head) and big (payload)
        sections in meta order with bounds checks."""
        for i, m in enumerate(header["arrays"]):
            dt = _np_dtype(m["dtype"])
            count = (int(np.prod(m["shape"], dtype=np.int64))
                     if m["shape"] else 1)
            nbytes = count * dt.itemsize
            if m.get("small"):
                if small_src is None:
                    raise ValueError(
                        "corrupt frame: v1 frames have no small-array "
                        "head section but the header flags a small array")
                src, off = small_src, small_off
                small_off += nbytes
            else:
                src, off = payload, big_off
                big_off += nbytes
            if off + nbytes > len(src):
                raise ValueError(
                    f"truncated frame: array needs {nbytes} bytes at "
                    f"offset {off}, payload has {len(src)}")
            yield i, m, src, off, dt, count

    @staticmethod
    def _array_paths(tree, path="", out=None) -> dict:
        """Array ref → codec path ("/key/sub/leaf") from the header
        tree — the inverse of _flatten's path bookkeeping, so
        decode_into can place each buffer without paths on the wire."""
        if out is None:
            out = {}
        if isinstance(tree, dict):
            if "__array__" in tree and len(tree) == 1:
                out[tree["__array__"]] = path
            elif "__tuple__" in tree and len(tree) == 1:
                for i, v in enumerate(tree["__tuple__"]):
                    MessageCodec._array_paths(v, f"{path}/{i}", out)
            else:
                for k, v in tree.items():
                    MessageCodec._array_paths(v, f"{path}/{k}", out)
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                MessageCodec._array_paths(v, f"{path}/{i}", out)
        return out

    @classmethod
    def _plain_leaf(cls, m, src, off, dt, count) -> torch.Tensor:
        """A non-row array decoded to a fresh, mutable tensor."""
        a = np.frombuffer(src, dtype=dt, count=count,
                          offset=off).reshape(m["shape"])
        if not m.get("enc"):
            a = a.copy()              # metadata arrays stay mutable
        return cls._decode_transport(a, m.get("enc"), m["dtype"])

    @classmethod
    def decode(cls, payload: bytes, writable: bool = True,
               copy: Optional[str] = None) -> Message:
        """Decode a v1 or v2 frame; array leaves come back as torch CPU
        tensors.  `copy="always"` (the default; `writable=True`) copies
        each array out of the frame, so leaves are mutable;
        `copy="never"` (`writable=False`) keeps the v1/big-buffer arrays
        as zero-copy views into `payload`: the cheapest form, for a caller
        that never writes them (torch warns once per process that such a
        tensor's buffer is read-only; writing one is undefined).  v2
        small-in-head arrays and transport-decoded arrays are always
        fresh."""
        if copy is not None:
            if copy not in ("always", "never"):
                raise ValueError(f"unknown copy mode {copy!r} "
                                 "(choose always or never)")
            writable = copy == "always"
        header, small_src, small_off, big_off = cls._frame_header(payload)
        buffers: list = [None] * len(header["arrays"])
        for i, m, src, off, dt, count in cls._each_array(
                header, payload, small_src, small_off, big_off):
            a = np.frombuffer(src, dtype=dt, count=count,
                              offset=off).reshape(m["shape"])
            if (writable or m.get("small")) and not m.get("enc"):
                a = a.copy()
            buffers[i] = cls._decode_transport(a, m.get("enc"), m["dtype"])
        params = cls._unflatten(header["tree"], buffers)
        return Message().init(params)

    @classmethod
    def decode_into(cls, payload: bytes, out_row: torch.Tensor,
                    layout) -> Message:
        """Decode-into fast path: validate the frame and write the
        `layout.key` subtree's leaves — dequantized and cast to f32 —
        DIRECTLY into the caller's flat f32 CPU row `out_row` at the
        layout's precomputed offsets, skipping the intermediate tree.

        `layout` is duck-typed with the fields of the JAX package's
        ``async_/staleness.py::RowLayout``: ``key`` (the message key),
        ``p`` (the row length) and ``offsets`` ({codec path: (offset,
        size, shape)}).  A same-dtype f32 leaf is a straight memcpy into
        the row, other dtypes cast-into (bf16 exactly, from its bit
        patterns), int8 dequantizes through the same f64 affine as
        decode, so the row is bitwise what decode + flatten would build.

        Every param OUTSIDE the layout key decodes normally into the
        returned Message; the layout key itself comes back as None (its
        values live in `out_row`).  Raises ValueError on malformed
        frames (decode's hardening) and on template mismatch — a frame
        whose `layout.key` arrays don't exactly tile the row.  On a
        raise, `out_row`'s contents are UNDEFINED."""
        if (not isinstance(out_row, torch.Tensor)
                or out_row.dtype != torch.float32 or out_row.dim() != 1
                or out_row.shape[0] != layout.p
                or out_row.device.type != "cpu"
                or not out_row.is_contiguous()):
            got = (f"{out_row.dtype}{tuple(out_row.shape)} on "
                   f"{out_row.device}" if isinstance(out_row, torch.Tensor)
                   else type(out_row).__name__)
            raise ValueError(
                f"decode_into row must be a contiguous [{layout.p}] f32 CPU "
                f"tensor, got {got}")
        row = out_row.numpy()
        header, small_src, small_off, big_off = cls._frame_header(payload)
        paths = cls._array_paths(header["tree"])
        prefix = "/" + layout.key
        buffers: list = [None] * len(header["arrays"])
        filled = 0
        for i, m, src, off, dt, count in cls._each_array(
                header, payload, small_src, small_off, big_off):
            path = paths.get(i, "")
            if not (path == prefix or path.startswith(prefix + "/")):
                buffers[i] = cls._plain_leaf(m, src, off, dt, count)
                continue
            enc = m.get("enc")
            kind = enc.get("kind") if enc else None
            if kind == "secagg":
                # masked field words can never fill a float row — fail by
                # NAME so a non-secure server reads this as config/version
                # skew, not a template mismatch
                raise ValueError(
                    f"masked secagg frame under {path!r}: decode_into "
                    f"cannot dequantize masked field words — secure "
                    f"uplinks route through MessageCodec.decode_secagg on "
                    f"a --secure_agg server (sender/server config or "
                    f"version skew)")
            if kind not in (None, "bf16", "int8", "sparse_topk"):
                # an alien kind must fail as VERSION SKEW, not as the
                # shape mismatch its opaque wire blob would otherwise trip
                raise _skew_error(kind)
            ent = layout.offsets.get(path)
            if ent is None:
                raise ValueError(
                    f"decode_into: frame array {path!r} is not in the "
                    f"row layout (model template mismatch)")
            dst_off, size, shape = ent
            shape = tuple(shape)
            sparse = kind == "sparse_topk"
            # a sparse wire array is a u8 blob — validate the ORIGINAL
            # (pre-sparsification) shape against the layout
            wire_shape = (tuple(enc.get("oshape", ()))
                          if sparse else tuple(m["shape"]))
            wire_count = (int(np.prod(wire_shape, dtype=np.int64))
                          if wire_shape else 1)
            if wire_count != size or wire_shape != shape:
                raise ValueError(
                    f"decode_into: frame array {path!r} has shape "
                    f"{wire_shape}, layout expects {shape}")
            view = np.frombuffer(src, dtype=dt, count=count, offset=off)
            dst = row[dst_off:dst_off + size]
            if sparse:
                # scatter the k (index, value) pairs straight into the flat
                # row slot — zero the slot first, dropped entries are zero
                k = int(enc["k"])
                if count != 8 * k:
                    raise ValueError(
                        f"decode_into: sparse_topk blob for {path!r} "
                        f"is {count} B, k={k} needs {8 * k}")
                idx = np.frombuffer(src, dtype="<u4", count=k, offset=off)
                vals = np.frombuffer(src, dtype="<f4", count=k,
                                     offset=off + 4 * k)
                if k and int(idx.max()) >= size:
                    raise ValueError(
                        f"decode_into: sparse_topk index "
                        f"{int(idx.max())} outside [{size}] leaf "
                        f"{path!r} (corrupt frame)")
                dst[:] = 0.0
                dst[idx] = vals
            elif m["dtype"] == BF16:
                # bf16 leaves and the bf16 transport: exact widening
                np.copyto(dst, bf16_bits_to_f32(view))
            elif enc is None:
                # straight memcpy for f32, single-pass cast-into for
                # f64/f16/int leaves
                np.copyto(dst, view, casting="unsafe")
            else:
                # int8: the same f64 affine as decode, so the row matches
                # decode + flatten bitwise
                np.copyto(dst, (view.astype(np.float64) + 128.0)
                          * enc["scale"] + enc["min"], casting="unsafe")
            filled += size
        if filled != layout.p:
            raise ValueError(
                f"decode_into: frame covered {filled} of {layout.p} row "
                f"elements under {prefix!r} (model template mismatch)")
        params = cls._unflatten(header["tree"], buffers)
        params[layout.key] = None
        return Message().init(params)

    @classmethod
    def decode_sparse(cls, payload: bytes, layout):
        """Sparse twin of decode_into: for a frame whose `layout.key`
        subtree rides ENTIRELY on the sparse_topk transport, return

            (msg, idx, vals)

        where `idx` (int64 tensor) / `vals` (f32 tensor) are the
        concatenated (global row index, value) pairs of every leaf — each
        leaf's wire indices shifted by its layout offset — and `msg` is
        the decoded envelope with the layout key set to None, so a
        streaming sparse fold never materializes the dense row.  Raises
        ValueError if any layout-key leaf is NOT sparse (mixed/dense frame
        — fall back to decode_into), on template mismatch, and on decode's
        malformed-frame hardening."""
        header, small_src, small_off, big_off = cls._frame_header(payload)
        paths = cls._array_paths(header["tree"])
        prefix = "/" + layout.key
        buffers: list = [None] * len(header["arrays"])
        idx_parts: list = []
        val_parts: list = []
        covered = 0
        for i, m, src, off, dt, count in cls._each_array(
                header, payload, small_src, small_off, big_off):
            path = paths.get(i, "")
            if not (path == prefix or path.startswith(prefix + "/")):
                buffers[i] = cls._plain_leaf(m, src, off, dt, count)
                continue
            ent = layout.offsets.get(path)
            if ent is None:
                raise ValueError(
                    f"decode_sparse: frame array {path!r} is not in "
                    f"the row layout (model template mismatch)")
            enc = m.get("enc")
            if not enc or enc.get("kind") != "sparse_topk":
                raise ValueError(
                    f"decode_sparse: frame array {path!r} is not "
                    f"sparse_topk (mixed frame — use decode_into)")
            dst_off, size, shape = ent
            oshape = tuple(enc.get("oshape", ()))
            ocount = (int(np.prod(oshape, dtype=np.int64))
                      if oshape else 1)
            if ocount != size or oshape != tuple(shape):
                raise ValueError(
                    f"decode_sparse: frame array {path!r} has shape "
                    f"{oshape}, layout expects {tuple(shape)}")
            k = int(enc["k"])
            if count != 8 * k:
                raise ValueError(
                    f"decode_sparse: sparse_topk blob for {path!r} "
                    f"is {count} B, k={k} needs {8 * k}")
            idx = np.frombuffer(src, dtype="<u4", count=k, offset=off)
            vals = np.frombuffer(src, dtype="<f4", count=k,
                                 offset=off + 4 * k)
            if k and int(idx.max()) >= size:
                raise ValueError(
                    f"decode_sparse: sparse_topk index "
                    f"{int(idx.max())} outside [{size}] leaf "
                    f"{path!r} (corrupt frame)")
            idx_parts.append(idx.astype(np.int64) + dst_off)
            val_parts.append(np.array(vals, dtype=np.float32))
            covered += size
        if covered != layout.p:
            raise ValueError(
                f"decode_sparse: frame covered {covered} of {layout.p} "
                f"row elements under {prefix!r} (model template "
                f"mismatch)")
        params = cls._unflatten(header["tree"], buffers)
        params[layout.key] = None
        gi = (np.concatenate(idx_parts) if idx_parts
              else np.zeros(0, dtype=np.int64))
        gv = (np.concatenate(val_parts) if val_parts
              else np.zeros(0, dtype=np.float32))
        return Message().init(params), torch.from_numpy(gi), \
            torch.from_numpy(gv)

    @classmethod
    def decode_secagg(cls, payload: bytes, key: str, n_words: int):
        """Masked twin of decode_into: for a frame whose `key` param is
        ONE transport=secagg array, return

            (msg, words, enc)

        where `words` is the masked row as a fresh uint32 [n_words]
        tensor, `enc` its self-describing header ({"kind", "orig",
        "oshape", "scale", "p"}), and `msg` the decoded envelope with
        `key` set to None.  Raises ValueError if the key's array is NOT a
        secagg frame (plain uplink — the caller falls back to
        decode_into/decode), if the word count disagrees with the
        server's row (model template mismatch), and on decode's
        malformed-frame hardening."""
        header, small_src, small_off, big_off = cls._frame_header(payload)
        paths = cls._array_paths(header["tree"])
        prefix = "/" + key
        buffers: list = [None] * len(header["arrays"])
        words = None
        enc_out = None
        for i, m, src, off, dt, count in cls._each_array(
                header, payload, small_src, small_off, big_off):
            path = paths.get(i, "")
            if not (path == prefix or path.startswith(prefix + "/")):
                buffers[i] = cls._plain_leaf(m, src, off, dt, count)
                continue
            enc = m.get("enc")
            if not enc or enc.get("kind") != "secagg":
                raise ValueError(
                    f"decode_secagg: frame array {path!r} is not a "
                    f"secagg frame (plain uplink — fall back to "
                    f"decode_into/decode)")
            if words is not None:
                raise ValueError(
                    f"decode_secagg: multiple arrays under "
                    f"{prefix!r} — a secagg uplink is ONE flat row")
            if count != int(n_words):
                raise ValueError(
                    f"decode_secagg: masked row has {count} field "
                    f"words, server layout expects {n_words} "
                    f"(model template mismatch)")
            words = torch.from_numpy(np.frombuffer(
                src, dtype=dt, count=count,
                offset=off).astype(np.uint32, copy=True))
            enc_out = dict(enc)
        if words is None:
            raise ValueError(
                f"decode_secagg: no secagg array under {prefix!r} "
                f"(plain uplink — fall back to decode_into/decode)")
        params = cls._unflatten(header["tree"], buffers)
        params[key] = None
        return Message().init(params), words, enc_out
