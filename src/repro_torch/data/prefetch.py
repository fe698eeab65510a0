"""Background prefetch of BatchStream batches to the GPU (port of
src/repro/data/prefetch.py; the transfer is rewritten for CUDA).

A producer thread pulls batches from the wrapped stream and parks them in a
bounded queue (depth 2 = double buffering), so host-side tokenize/pack and
the host-to-device copy overlap the previous training step.

The copy to a CUDA `device`: the producer (with the device set in its own
thread) turns each numpy leaf into an int64 tensor in pinned host memory
and copies it `non_blocking` on its own `torch.cuda.Stream`, then records
an event there. The consumer makes its current stream wait on that event
and calls `record_stream` on each device tensor: the tensors were
allocated on the copy stream, and without it the caching allocator could
hand their memory out again while the compute stream still reads them.
Each pinned buffer stays referenced until its batch is consumed, and the
CUDA caching host allocator records the copy's stream on it, so it is not
reused before the copy ends. A CUDA error in the producer reaches the
consumer as an exception; there is no synchronous fallback. Without a
CUDA device the batches pass through unchanged (there is no copy to hide).

Checkpoint semantics, retries and `close` are the reference's: each queue
item carries the stream's `state_dict()` snapshot taken after that batch
was produced, and `state_dict()` returns the snapshot of the last batch
the consumer took, so a resume never skips the read-ahead. `retries`
gives the producer a consecutive-failure budget (a crash mid-pull
re-`iter()`s the wrapped stream, which resumes from its own cursor).
`close()` stops the producer even when it is blocked on a full queue; a
fresh `__iter__()` after close re-arms it (train_loop's rollback: close ->
load_state_dict -> iter).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

_SENTINEL = object()


def batch_to_torch(batch: Dict, device=None) -> Dict[str, torch.Tensor]:
    """A batch of numpy (or torch) id arrays -> int64 tensors, moved to
    `device` when one is given (tokens, labels and segments are all ids)."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        t = t.to(torch.int64)
        out[k] = t if device is None else t.to(device)
    return out


class Prefetcher:
    """Wrap a BatchStream with a depth-bounded background producer that
    copies each batch to `device` (a CUDA device) ahead of its step."""

    def __init__(self, stream, depth: int = 2, device=None, retries: int = 0):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.stream = stream
        self.depth = depth
        dev = None if device is None else torch.device(device)
        if dev is not None and dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())  # the producer sets it by index
        self.device = dev if dev is not None and dev.type == "cuda" else None
        self.retries = max(0, retries)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._last_state: Optional[Dict] = None
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self.n_producer_retries = 0

    # ------------------------------------------------------------ producer

    def _to_device(self, batch, copy_stream):
        """Pinned host tensors, copied non_blocking on the copy stream.
        Returns (device batch, event recorded after the copies, the pinned
        buffers, kept alive with the batch)."""
        host = {k: t.pin_memory() for k, t in batch_to_torch(batch).items()}
        with torch.cuda.stream(copy_stream):
            dev = {k: t.to(self.device, non_blocking=True) for k, t in host.items()}
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return dev, ready, host

    def _produce(self):
        try:
            copy_stream = None
            if self.device is not None:
                torch.cuda.set_device(self.device)  # this thread has no current device
                copy_stream = torch.cuda.Stream(self.device)
            budget = self.retries
            it = iter(self.stream)
            while True:
                try:
                    batch = next(it)
                except StopIteration:
                    return  # clean end of stream: finally parks the sentinel
                except Exception:
                    # producer crash: streams with a cursor resume from it on
                    # re-iteration, and a wrapped fault stream only advances
                    # its index on an actual yield, so the failed batch is
                    # re-attempted, not dropped
                    if budget <= 0 or self._stop.is_set():
                        raise
                    budget -= 1
                    self.n_producer_retries += 1
                    it = iter(self.stream)
                    continue
                budget = self.retries  # consecutive-failure budget
                ready = pinned = None
                if copy_stream is not None:
                    batch, ready, pinned = self._to_device(batch, copy_stream)
                snap = self.stream.state_dict() if hasattr(self.stream, "state_dict") else None
                while not self._stop.is_set():
                    try:
                        self._q.put((batch, snap, ready, pinned), timeout=0.05)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # surfaced to the consumer on next()
            self._err = e
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(_SENTINEL, timeout=0.05)
                    break
                except queue.Full:
                    continue

    # ------------------------------------------------------------ consumer

    def __iter__(self) -> Iterator[Dict]:
        if self._thread is None:
            # fresh start OR re-arm after close(): the old Event/Queue are
            # poisoned (stop set, queue drained), so rebuild both
            self._stop = threading.Event()
            self._q = queue.Queue(maxsize=self.depth)
            self._err = None
            self._closed = False
            self._thread = threading.Thread(
                target=self._produce, name="repro-torch-prefetch", daemon=True
            )
            self._thread.start()
        try:
            while True:
                if self._closed:
                    raise RuntimeError(
                        "Prefetcher is closed; iterate it again (a fresh "
                        "__iter__ re-arms the producer) instead of calling "
                        "next() on an iterator that outlived close()"
                    )
                try:
                    item = self._q.get(timeout=0.05)
                except queue.Empty:
                    continue  # poll so a concurrent close() can't wedge us
                if item is _SENTINEL:
                    if self._err is not None:
                        raise self._err
                    return
                batch, snap, ready, _pinned = item
                if ready is not None:
                    compute = torch.cuda.current_stream(self.device)
                    compute.wait_event(ready)
                    for t in batch.values():
                        t.record_stream(compute)
                self._last_state = snap
                yield batch
        finally:
            self.close()

    def close(self) -> None:
        """Stop the producer (even mid-put) and join it. Idempotent; a
        later fresh `__iter__()` re-arms the prefetcher."""
        self._closed = True
        self._stop.set()
        if self._thread is not None:
            while True:  # unblock a producer stuck on a full queue
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
            self._thread.join(timeout=5.0)
            if self._thread.is_alive():
                # keep _thread set: the stream may still be mutating, so
                # load_state_dict / re-iteration must stay refused
                raise RuntimeError(
                    "prefetch producer did not stop within 5s "
                    "(blocked inside the wrapped stream?)"
                )
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # --------------------------------------------------------------- state

    def state_dict(self) -> Dict:
        """Cursor of the last *consumed* batch (read-ahead not counted)."""
        if self._last_state is not None:
            return self._last_state
        return self.stream.state_dict()

    def load_state_dict(self, state: Dict) -> None:
        if self._thread is not None:
            raise RuntimeError("load_state_dict must come before iteration starts")
        self.stream.load_state_dict(state)
        # the snapshot of the last pre-rewind batch is now stale; without
        # this a post-rollback checkpoint would persist the OLD cursor
        self._last_state = None
