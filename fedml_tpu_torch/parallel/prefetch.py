"""Double-buffered host-to-device prefetch (port of
fedml_tpu/parallel/prefetch.py).

The streaming and block-streamed rounds gather each client block on the
host, cast it and upload it, and only then train on it.  `Prefetcher`
moves production to a background thread with a depth-bounded handoff:
while the card trains on block k, the host prepares and uploads block
k+1.  At the default depth 2 this is double buffering (the item the
consumer holds plus one in flight), so device data memory keeps the
synchronous loop's O(2 * block) bound.

`InlineFetcher` is the ``prefetch=False`` path: the same contract with
production inlined into `get()`, strictly synchronous, kept for bitwise
comparison against the pipelined path.  `AsyncValue` is the one-shot
variant the per-round streaming path uses (round r+1's cohort uploads
while round r trains).

On the card (``device`` a CUDA device) the producer thread runs
`produce` under a CUDA stream of its own: its copies come from pinned
host memory with ``non_blocking=True`` (`upload`), and an event recorded
after them is the fence.  `get()` makes the consumer's current stream
wait on that event and marks every delivered CUDA tensor with
``record_stream``, so the caching allocator never hands the memory to
another user before the consumer's kernels are done with it.  The
producer gathers, casts and copies only: it launches no kernel (the
GroupNorm backward claims its device's stream, and a dequantize stays on
the compute stream).

Every upload lands in the engine's TransferOverlapStats from whichever
thread runs it, and the consumer's blocking waits are recorded, so the
overlap fraction is measurable.
"""
from __future__ import annotations

import contextlib
import logging
import queue
import threading
from typing import Any, Callable, Optional, Sequence

import torch

from fedml_tpu_torch.utils.profiling import TransferOverlapStats

log = logging.getLogger(__name__)
_SENTINEL = object()


def upload(t: torch.Tensor, device) -> torch.Tensor:
    """One host tensor onto `device`: from pinned memory and asynchronous
    on the card (pageable memory would make ``non_blocking`` a silent
    synchronous copy), a plain ``to`` elsewhere."""
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _cuda_tensors(out):
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _cuda_tensors(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _cuda_tensors(v)


class _Fence:
    """The producer's CUDA stream and the consumer-side wait; a no-op off
    the card."""

    def __init__(self, device):
        device = torch.device(device) if device is not None else None
        self.stream = (torch.cuda.Stream(device) if device is not None
                       and device.type == "cuda" else None)

    def produce(self, fn: Callable, *args):
        if self.stream is None:
            return fn(*args), None
        with torch.cuda.stream(self.stream):
            out = fn(*args)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        return out, ev

    def adopt(self, out, ev):
        if ev is None:
            return out
        cur = torch.cuda.current_stream(self.stream.device)
        cur.wait_event(ev)
        for t in _cuda_tensors(out):
            t.record_stream(cur)
        return out


class Prefetcher:
    """Run `produce(item)` for each work item on a background thread,
    delivering results in order through `get()`, with at most `depth`
    results materialized at once (the one the consumer last took plus
    `depth - 1` queued or in flight).  A producer exception is re-raised
    from the next `get()`.  `close()` (also on leaving a ``with`` block)
    stops the worker, joins it and drops undelivered results: an aborted
    round never leaks a thread or hands a stale buffer to the next one."""

    def __init__(self, produce: Callable[[Any], Any], items: Sequence,
                 depth: int = 2, stats: Optional[TransferOverlapStats] = None,
                 name: str = "h2d-prefetch", device=None):
        if depth < 2:
            raise ValueError(f"depth must be >= 2 (double buffer), got "
                             f"{depth}")
        self._produce = produce
        self._items = list(items)
        self._stats = stats
        self._fence = _Fence(device)
        self._q: queue.Queue = queue.Queue()
        # how far the producer may run ahead: acquired before each
        # produce, released on each get
        self._slots = threading.Semaphore(depth - 1)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._work, name=name,
                                        daemon=True)
        self._thread.start()

    def _work(self) -> None:
        try:
            for item in self._items:
                self._slots.acquire()
                if self._stop.is_set():
                    return
                out = self._fence.produce(self._produce, item)
                if self._stop.is_set():
                    # closed mid-produce: drop the result, never park a
                    # stale block past the drain
                    return
                self._q.put(out)
        except BaseException as e:          # surfaced from get()
            self._err = e
            self._q.put(_SENTINEL)

    def get(self):
        """The next result, blocking until the worker has produced it (the
        block recorded as wait wall in `stats`)."""
        wait = (self._stats.waiting() if self._stats is not None
                else contextlib.nullcontext())
        with wait:
            while True:
                try:
                    out = self._q.get(timeout=5.0)
                    break
                except queue.Empty:
                    if not self._thread.is_alive():
                        # the worker may have put its last result and
                        # exited between the timeout and the check
                        try:
                            out = self._q.get_nowait()
                            break
                        except queue.Empty:
                            raise RuntimeError(
                                "prefetch worker died without a result"
                            ) from self._err
        if out is _SENTINEL:
            raise self._err
        self._slots.release()
        return self._fence.adopt(*out)

    def close(self) -> None:
        """Stop the worker, join it, drop undelivered buffers."""
        self._stop.set()
        # unblock a worker parked in acquire (it checks _stop right after)
        self._slots.release()
        self._slots.release()
        self._thread.join(timeout=60.0)
        if self._thread.is_alive():
            log.warning("prefetch worker still mid-upload after close() "
                        "join timeout; it will discard its result")
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class InlineFetcher:
    """The ``prefetch=False`` path: `get()` runs `produce(item)` inline, on
    the caller's stream.  The inline produce is consumer blocking, so it is
    recorded as wait wall: the synchronous path reports an overlap
    fraction near 0 (nothing hidden)."""

    def __init__(self, produce: Callable[[Any], Any], items: Sequence,
                 depth: int = 2, stats: Optional[TransferOverlapStats] = None,
                 name: str = "h2d-inline", device=None):
        self._produce = produce
        self._it = iter(list(items))
        self._stats = stats

    def get(self):
        item = next(self._it)
        wait = (self._stats.waiting() if self._stats is not None
                else contextlib.nullcontext())
        with wait:
            return self._produce(item)

    def close(self) -> None:
        pass

    def __enter__(self) -> "InlineFetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class AsyncValue:
    """One value computed on a background thread (the streaming path's
    next-round cohort upload).  `result()` joins and re-raises, recorded as
    a consumer wait in `stats` when the value is not ready yet; on the card
    it fences like `Prefetcher.get`."""

    def __init__(self, fn: Callable, *args,
                 stats: Optional[TransferOverlapStats] = None,
                 name: str = "h2d-prefetch-round", device=None):
        self._out = None
        self._err: Optional[BaseException] = None
        self._stats = stats
        self._fence = _Fence(device)

        def work():
            try:
                self._out = self._fence.produce(fn, *args)
            except BaseException as e:
                self._err = e

        self._thread = threading.Thread(target=work, name=name, daemon=True)
        self._thread.start()

    def result(self):
        if self._thread.is_alive() and self._stats is not None:
            with self._stats.waiting():
                self._thread.join()
        else:
            self._thread.join()
        if self._err is not None:
            raise self._err
        if self._out is not None:           # fence once, on the first read
            self._value = self._fence.adopt(*self._out)
            self._out = None
        return self._value
