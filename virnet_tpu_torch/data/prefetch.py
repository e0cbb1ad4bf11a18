"""Asynchronous host-to-device input prefetch (counterpart of
virnet_tpu/data/prefetch.py).

The reference overlaps input work with compute through DataLoader worker
processes and ``prefetch_factor`` (configs/denoising_syn.json:2-17).  Here
one background thread samples batch N+1, pins it and starts its copy to
the card on a side CUDA stream while step N runs.  The consumer's stream
waits on that copy's event before the step reads the batch, and each
tensor is marked as used by the consumer's stream (``record_stream``), so
the allocator does not hand its memory out again before the step is done
with it.  On the CPU the worker only turns arrays into tensors.

Order: batches flow through a FIFO queue filled by exactly one worker, so
the consumer sees them in the iterator's order; the trainers seed each
step's generator from the step counter, so the batch-to-draws pairing is
the same with and without the prefetcher.  A worker error reaches the
consumer at the batch where it happened.  In a data-parallel run
(train/mesh.py) the iterator yields global batches and ``rows`` picks
this rank's rows: only they are pinned and copied.

Usage::

    with DevicePrefetcher(batch_iter, trainer.device, depth=2) as it:
        for batch in it:
            trainer.run_step(batch, epoch)
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

_SENTINEL = object()


def _map(fn, tree):
    """``fn`` over the arrays of a batch: an array, or a tuple, list,
    NamedTuple or dict of them (nested), the structure kept."""
    if isinstance(tree, tuple):
        out = [_map(fn, t) for t in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    if isinstance(tree, list):
        return [_map(fn, t) for t in tree]
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


class DevicePrefetcher:
    """Wraps a batch iterable; yields the same batches in the same order
    as tensors on ``device``, with up to ``depth`` batches in flight ahead
    of the consumer; ``rows`` (a slice of the leading axis), when given,
    keeps those rows of every array of a batch.  ``stats``: the worker's seconds spent sampling
    (``sample_s``), pinning and starting the copy (``put_s``) and waiting
    for room in the queue (``block_s``), and the batches it made."""

    def __init__(self, batch_iter: Iterable, device, depth: int = 2,
                 rows: Optional[slice] = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._iter = iter(batch_iter)
        self._rows = rows
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = (torch.cuda.Stream(self.device) if self._cuda
                        else None)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._done = False
        self.stats = {"sample_s": 0.0, "put_s": 0.0, "block_s": 0.0,
                      "batches": 0}
        self._thread = threading.Thread(
            target=self._worker, name="virnet-torch-prefetch", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- worker

    def _copy(self, a):
        t = torch.as_tensor(np.ascontiguousarray(a)
                            if isinstance(a, np.ndarray) else a)
        if not self._cuda:
            return t.to(self.device)
        if t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _transfer(self, batch):
        if self._rows is not None:
            batch = _map(lambda a: a[self._rows], batch)
        if not self._cuda:
            return _map(self._copy, batch), None
        with torch.cuda.stream(self._stream):
            out = _map(self._copy, batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        st = self.stats
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                try:
                    batch = next(self._iter)
                except StopIteration:
                    break
                t1 = time.perf_counter()
                item = self._transfer(batch)
                t2 = time.perf_counter()
                if not self._put(item):
                    return
                st["sample_s"] += t1 - t0
                st["put_s"] += t2 - t1
                st["block_s"] += time.perf_counter() - t2
                st["batches"] += 1
        except BaseException as exc:   # handed to the consumer
            self._err = exc
        self._put(_SENTINEL)

    # ----------------------------------------------------------- consumer

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is _SENTINEL:
            self._done = True
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            _map(lambda t: t.record_stream(stream), batch)
        return batch

    def close(self):
        """Stop the worker without draining (an early exit from the loop)."""
        self._stop.set()
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
