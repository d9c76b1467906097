"""Carry wire codecs: the compressed inter-process tier (port of
fedml_tpu/parallel/carry_codec.py, the same numpy code).

The two-level round ships each process's flat f32 carry partials (the
unpadded model-sized sum vector followed by the engine's scalar sums)
across processes at every commit barrier.  These codecs trade that
4 B/element for ~1 B/element on the wire:

* ``f32``: the identity codec and the default.  The bytes on the wire
  are exactly ``vec.tobytes()``, so every bitwise pin (1 process against
  2, serial against overlapped) holds on this path.  It is the escape
  hatch: a compressed-tier bug is debugged by flipping back to ``f32``.
* ``int8``: per-chunk int8/affine fixed point with the comm layer's
  affine helpers (comm.message.affine_int8_*): each CHUNK-sized slice of
  the carry stores an f32 (min, scale) pair, then 1 B an element.
  ~3.9x fewer bytes at ``chunk >> 2``; the error is bounded by
  scale/2 = (chunk range)/510 an element.
* ``int8_ef``: int8/affine plus per-block error-feedback residuals: the
  quantization error of round r is added back into round r+1's carry
  before encoding, so the sum over rounds tracks the true sum within a
  single round's error.  The residuals are runner state: they ride
  ``state_dict()`` / ``load_state_dict()`` and the port's checkpoint
  (utils/checkpoint.py) as extra_state.
* ``topk``: fixed-k magnitude sparsification: only the
  k = max(1, dim // ratio) largest-|value| entries ship, as k u32
  indices and k f32 values.  ~(4*dim)/(8 + 8k) fewer bytes (7.5x at the
  default ratio 16), and lossy: the dropped mass is gone.  The values
  are exact f32, so a vector with at most k nonzeros round-trips
  bitwise.
* ``topk_ef``: top-k delta encoding against a replicated
  reconstruction mirror.  The carry is a snapshot stream (each round's
  vector is a weighted model sum, not an increment), so the error
  feedback lives in the difference domain: the encoder ships the top-k
  of ``vec - rec``, where ``rec`` is the receivers' integrated
  reconstruction, and every rank, the encoder included, advances
  ``rec`` by integrating the identical allgathered bytes.  The mirror
  is replicated by construction and never synchronized.

Wire layout (int8 flavors), per block:

    u32 dim | f32 min[n_chunks] | f32 scale[n_chunks] | int8 q[dim]

Wire layout (topk flavors), per block:

    u32 dim | u32 k | u32 idx[k] | f32 val[k]

k is a pure function of dim, so the payload size is a pure function of
(dim, chunk): equal-length vectors encode to equal-length bytes
(``encoded_nbytes`` is the contract the allgather splits by).  The
header (min, scale) values are stored as f32 and the encoder quantizes
against the f32-rounded values, so every rank reconstructs bit-identical
f32 carries from the same bytes.  Decoding is deterministic f64 math on
the host, so the fold over decoded partials commits replicated results:
a compressed tier changes accuracy, never replica agreement.

The top-k selection is numpy (the JAX package runs ``lax.top_k``): the
k largest |values|, in descending order, ties to the lower index, which
is XLA's order, so the bytes are the JAX codec's bitwise.
"""
from __future__ import annotations

import struct

import numpy as np

from fedml_tpu_torch.comm.message import affine_int8_decode, affine_int8_encode

CARRY_CODECS = ("f32", "int8", "int8_ef", "topk", "topk_ef")

# ~16 KiB of f32 per (min, scale) pair: coarse enough to amortize the
# 8 B header, fine enough that one outlier only poisons its own chunk
DEFAULT_CHUNK = 4096

# ship 1-in-16 entries by default: 8 B a kept entry, 7.5x fewer wire
# bytes than f32 at dim >> 1
DEFAULT_TOPK_RATIO = 16


class CarryCodec:
    """Identity f32 codec, the default bitwise escape hatch: ``encode``
    is byte-identical to ``vec.tobytes()`` of a little-endian f32
    vector."""

    name = "f32"

    def __init__(self, chunk: int = DEFAULT_CHUNK):
        self.chunk = int(chunk)
        if self.chunk <= 0:
            raise ValueError(f"carry chunk must be positive, got {chunk}")

    def encoded_nbytes(self, dim: int) -> int:
        return 4 * int(dim)

    def encode(self, block: int, vec: np.ndarray) -> bytes:
        return np.ascontiguousarray(vec, dtype="<f4").tobytes()

    def decode(self, buf: bytes) -> np.ndarray:
        return np.frombuffer(buf, dtype="<f4")

    def retain_blocks(self, blocks) -> None:
        """Keep per-block codec state only for `blocks` (ownership
        changes); stateless codecs have nothing to do."""

    # residual state (empty for stateless codecs): the runner
    # checkpoints this dict as extra_state
    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        if state:
            raise ValueError(f"codec {self.name!r} carries no state, "
                             f"got keys {sorted(state)}")


class Int8CarryCodec(CarryCodec):
    """Per-chunk int8/affine fixed point (the v2 wire discipline)."""

    name = "int8"

    def _n_chunks(self, dim: int) -> int:
        return -(-int(dim) // self.chunk)

    def encoded_nbytes(self, dim: int) -> int:
        return 4 + 8 * self._n_chunks(dim) + int(dim)

    def _qparams(self, vec: np.ndarray):
        """Per-chunk f32 (min, scale) and the per-element f64 broadcasts
        the affine math runs against.  reduceat handles the ragged tail
        chunk exactly; scales that round to 0.0 in f32 (a degenerate or
        subnormal range) fall back to 1.0 so encode and decode stay
        finite."""
        dim = vec.size
        idx = np.arange(0, dim, self.chunk)
        mn32 = np.minimum.reduceat(vec, idx).astype(np.float32)
        mx = np.maximum.reduceat(vec, idx).astype(np.float64)
        sc32 = ((mx - mn32.astype(np.float64)) / 255.0).astype(np.float32)
        sc32[sc32 == 0] = np.float32(1.0)
        per_mn = np.repeat(mn32.astype(np.float64), self.chunk)[:dim]
        per_sc = np.repeat(sc32.astype(np.float64), self.chunk)[:dim]
        return mn32, sc32, per_mn, per_sc

    def _encode_vec(self, block: int, vec: np.ndarray) -> bytes:
        vec = np.ascontiguousarray(vec, dtype=np.float32)
        if vec.size and not np.all(np.isfinite(vec)):
            raise ValueError(
                f"non-finite carry for block {block}: the int8 tier "
                f"cannot represent it; rerun with carry_codec f32 (the "
                f"escape hatch) to debug the divergence")
        mn32, sc32, per_mn, per_sc = self._qparams(vec)
        q = affine_int8_encode(vec, per_mn, per_sc)
        return (struct.pack("<I", vec.size) + mn32.tobytes()
                + sc32.tobytes() + q.tobytes())

    def encode(self, block: int, vec: np.ndarray) -> bytes:
        return self._encode_vec(block, vec)

    def decode(self, buf: bytes) -> np.ndarray:
        (dim,) = struct.unpack_from("<I", buf, 0)
        nc = self._n_chunks(dim)
        if len(buf) != self.encoded_nbytes(dim):
            raise ValueError(
                f"carry payload is {len(buf)} B but dim={dim} chunk="
                f"{self.chunk} encodes to {self.encoded_nbytes(dim)} B "
                f"(a mixed-codec cluster?)")
        mn32 = np.frombuffer(buf, dtype="<f4", count=nc, offset=4)
        sc32 = np.frombuffer(buf, dtype="<f4", count=nc, offset=4 + 4 * nc)
        q = np.frombuffer(buf, dtype=np.int8, count=dim, offset=4 + 8 * nc)
        per_mn = np.repeat(mn32.astype(np.float64), self.chunk)[:dim]
        per_sc = np.repeat(sc32.astype(np.float64), self.chunk)[:dim]
        return affine_int8_decode(q, per_mn, per_sc, np.float32)


class _BlockResidualState:
    """Per-block f64 error-feedback residuals of the stateful (`*_ef`)
    codecs: retention on ownership changes, the checkpoint dict."""

    _residual: dict

    def retain_blocks(self, blocks) -> None:
        """Forget the residuals of blocks this rank no longer owns: a
        re-adopting rank starts that block's residual at zero (only the
        compression-error trajectory shifts, never replica agreement:
        every rank decodes the same bytes)."""
        keep = {int(b) for b in blocks}
        for b in list(self._residual):
            if b not in keep:
                del self._residual[b]

    def state_dict(self) -> dict:
        return {"residual": {str(b): np.asarray(v, dtype=np.float64)
                             for b, v in sorted(self._residual.items())}}

    def load_state_dict(self, state: dict) -> None:
        if not state:
            self._residual = {}
            return
        res = state.get("residual", state)
        self._residual = {int(b): np.asarray(v, dtype=np.float64)
                          for b, v in res.items()}


class Int8EFCarryCodec(_BlockResidualState, Int8CarryCodec):
    """int8/affine with per-block error-feedback residuals: encode ships
    q(vec + residual[block]) and keeps the new quantization error for
    the next round."""

    name = "int8_ef"

    def __init__(self, chunk: int = DEFAULT_CHUNK):
        super().__init__(chunk)
        self._residual: dict[int, np.ndarray] = {}

    def encode(self, block: int, vec: np.ndarray) -> bytes:
        vec = np.ascontiguousarray(vec, dtype=np.float32)
        res = self._residual.get(block)
        if res is not None and res.size != vec.size:
            res = None                 # block re-partitioned; start clean
        # f64 carry + residual so the fed-back error does not itself round
        fed = (vec.astype(np.float64)
               + (res if res is not None else 0.0))
        buf = self._encode_vec(block, fed.astype(np.float32))
        self._residual[block] = fed - self.decode(buf).astype(np.float64)
        return buf


def topk_select(vec: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(indices u32, values f32) of the k largest |vec| entries, in
    descending |value| order with ties to the lower index: the order of
    XLA's top_k, so the selection is the JAX codec's bitwise.  A
    partition finds the k-th magnitude in O(dim); only the k selected
    entries are sorted."""
    a = np.abs(vec)
    n = a.size
    if k >= n:
        idx = np.arange(n)
    else:
        thr = np.partition(a, n - k)[n - k]
        above = np.flatnonzero(a > thr)
        ties = np.flatnonzero(a == thr)[:k - above.size]
        idx = np.concatenate([above, ties])
    idx = idx[np.lexsort((idx, -a[idx]))]
    return idx.astype(np.uint32), vec[idx]


class TopKCarryCodec(CarryCodec):
    """Fixed-k magnitude top-k sparsification (lossy without the `_ef`
    flavor: the dropped (dim - k) mass never ships)."""

    name = "topk"
    sparse = True

    def __init__(self, chunk: int = DEFAULT_CHUNK,
                 topk_ratio: int = DEFAULT_TOPK_RATIO):
        super().__init__(chunk)
        self.topk_ratio = int(topk_ratio)
        if self.topk_ratio <= 0:
            raise ValueError(
                f"topk ratio must be positive, got {topk_ratio}")

    def k_for(self, dim: int) -> int:
        """k is a pure function of dim: the equal-length-bytes contract
        the allgather splits by."""
        dim = int(dim)
        return 0 if dim == 0 else max(1, dim // self.topk_ratio)

    def encoded_nbytes(self, dim: int) -> int:
        return 8 + 8 * self.k_for(dim)

    def _encode_vec(self, block: int, vec: np.ndarray) -> bytes:
        vec = np.ascontiguousarray(vec, dtype=np.float32)
        if vec.size and not np.all(np.isfinite(vec)):
            raise ValueError(
                f"non-finite carry for block {block}: NaN poisons the "
                f"top-k magnitude ordering; rerun with carry_codec f32 "
                f"(the escape hatch) to debug the divergence")
        k = self.k_for(vec.size)
        if k == 0:
            return struct.pack("<II", 0, 0)
        idx, vals = topk_select(vec, k)
        return (struct.pack("<II", vec.size, k)
                + np.ascontiguousarray(idx, dtype="<u4").tobytes()
                + np.ascontiguousarray(vals, dtype="<f4").tobytes())

    def encode(self, block: int, vec: np.ndarray) -> bytes:
        return self._encode_vec(block, vec)

    def decode_pairs(self, buf: bytes):
        """(dim, idx u32[k], vals f32[k]) without densifying: the runner
        fold scatter-adds these straight into the flat carry."""
        dim, k = struct.unpack_from("<II", buf, 0)
        if len(buf) != self.encoded_nbytes(dim):
            raise ValueError(
                f"carry payload is {len(buf)} B but dim={dim} ratio="
                f"{self.topk_ratio} encodes to {self.encoded_nbytes(dim)}"
                f" B (a mixed-codec cluster?)")
        idx = np.frombuffer(buf, dtype="<u4", count=k, offset=8)
        vals = np.frombuffer(buf, dtype="<f4", count=k, offset=8 + 4 * k)
        return dim, idx, vals

    def decode(self, buf: bytes) -> np.ndarray:
        dim, idx, vals = self.decode_pairs(buf)
        arr = np.zeros(dim, dtype=np.float32)
        arr[idx] = vals                # top-k indices are unique
        return arr


class TopKEFCarryCodec(_BlockResidualState, TopKCarryCodec):
    """top-k delta encoding with a replicated reconstruction mirror:
    ``encode`` ships the k largest-|.| entries of ``vec - rec`` (exact
    f32 values), ``integrate`` scatter-adds a block's wire pairs into
    that block's ``rec`` and returns the reconstruction.  Every rank
    integrates the identical allgathered bytes for every block, the
    encoder included, so the mirror agrees bitwise across the cluster
    without being synchronized.  Unsent coordinates have ``|vec - rec|``
    below the round's selection threshold: the reconstruction error is
    bounded by a single round's truncation threshold."""

    name = "topk_ef"

    def __init__(self, chunk: int = DEFAULT_CHUNK,
                 topk_ratio: int = DEFAULT_TOPK_RATIO):
        super().__init__(chunk, topk_ratio)
        # block -> f32 reconstruction mirror (kept under the "residual"
        # state key of the checkpoint convention: here the state IS the
        # reconstruction, the error vec - rec implicit)
        self._residual: dict[int, np.ndarray] = {}

    def _rec(self, block: int, dim: int) -> np.ndarray:
        rec = self._residual.get(block)
        if rec is None or rec.size != dim:
            # an unseen or re-partitioned block: the mirror restarts at
            # zero on every rank at once (all ranks see one partition)
            rec = np.zeros(dim, dtype=np.float32)
            self._residual[block] = rec
        return rec

    def encode(self, block: int, vec: np.ndarray) -> bytes:
        vec = np.ascontiguousarray(vec, dtype=np.float32)
        # no state update here: the mirror advances only in integrate(),
        # on the allgathered bytes, identically on every rank
        return self._encode_vec(block, vec - self._rec(block, vec.size))

    def integrate(self, block: int, buf: bytes) -> np.ndarray:
        """Advance the block's reconstruction by one wire frame and
        return it (f32, the runner fold's input).  The scatter-add is
        well defined (top-k indices are unique) and pure f32, so every
        rank's mirror stays byte-identical given identical bytes."""
        dim, idx, vals = self.decode_pairs(buf)
        rec = self._rec(block, dim)
        rec[idx] += vals
        return rec

    def retain_blocks(self, blocks) -> None:
        """Keep every block's mirror: rec is replicated decode state
        (every rank integrates every block), so an ownership change must
        not drop it."""

    def state_dict(self) -> dict:
        return {"residual": {str(b): np.asarray(v, dtype=np.float32)
                             for b, v in sorted(self._residual.items())}}

    def load_state_dict(self, state: dict) -> None:
        if not state:
            self._residual = {}
            return
        res = state.get("residual", state)
        self._residual = {int(b): np.ascontiguousarray(v, np.float32)
                          for b, v in res.items()}


def make_carry_codec(name: str, *, chunk: int = DEFAULT_CHUNK,
                     topk_ratio: int = DEFAULT_TOPK_RATIO) -> CarryCodec:
    """Codec by name (f32 | int8 | int8_ef | topk | topk_ef)."""
    try:
        cls = {"f32": CarryCodec, "int8": Int8CarryCodec,
               "int8_ef": Int8EFCarryCodec, "topk": TopKCarryCodec,
               "topk_ef": TopKEFCarryCodec}[name]
    except KeyError:
        raise ValueError(f"unknown carry codec {name!r}; "
                         f"expected one of {CARRY_CODECS}") from None
    if name in ("topk", "topk_ef"):
        return cls(chunk=chunk, topk_ratio=topk_ratio)
    return cls(chunk=chunk)
