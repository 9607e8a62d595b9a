"""Host-to-device prefetching: overlap host work (reading, batching) with device
compute (port of sparse_vision_tpu/data/prefetch.py).

A background thread pulls the next items from an iterator and stages them onto
the device while the consumer computes on the current one. An item is a tensor,
a numpy array, a dataclass of them (a ``Batch``) or a tuple or list of them;
other leaves (None, numbers) pass through.

On a CUDA device the staging goes through pinned host buffers. The thread copies
each host array into a pinned buffer, issues the host-to-device copy from it on
a side stream (``non_blocking=True``) and records one event per item after the
item's copies. The consumer makes its current stream wait on that event before
it yields the item, and calls ``record_stream`` on each tensor, so the caching
allocator keeps the memory until the consumer's work on it is done. A pinned
buffer is reused only once the event of its last copy has completed. On device
"cpu" the items pass through as CPU tensors (numpy arrays wrapped, not copied):
the caller asked for the CPU.

Producer exceptions are re-raised on the consumer: a silently truncated epoch
would corrupt the metrics and the dead-latent statistics. A consumer that
abandons the generator sets a stop event, which releases the thread.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from sparse_vision_tpu_torch.device import resolve_device


def _map_arrays(fn, item):
    """``item`` with ``fn`` applied to every tensor and numpy array in it (through
    dataclasses, tuples and lists); other leaves are kept."""
    if isinstance(item, (torch.Tensor, np.ndarray)):
        return fn(item)
    if dataclasses.is_dataclass(item) and not isinstance(item, type):
        return dataclasses.replace(item, **{f.name: _map_arrays(fn, getattr(item, f.name))
                                            for f in dataclasses.fields(item)})
    if isinstance(item, (tuple, list)):
        return type(item)(_map_arrays(fn, v) for v in item)
    return item


def _as_tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a


def device_put_batch(batch, device=None):
    """Every array of one item on ``device`` (None means CUDA): a synchronous
    copy each, the one-item form of what ``prefetch`` stages ahead."""
    device = resolve_device(device)
    return _map_arrays(lambda a: _as_tensor(a).to(device), batch)


class _PinnedStager:
    """The pinned buffers and the side stream of one prefetch on a CUDA device.
    Buffers are kept per (dtype, size) in the order they were last used. The
    oldest is reused once its copy's event has completed; while it has not, a
    new buffer is made up to ``depth`` of that size, and past that the thread
    waits for the event."""

    def __init__(self, device: torch.device, depth: int):
        self.device = device
        self.depth = depth
        self.stream = torch.cuda.Stream(device)
        self.pool: dict = collections.defaultdict(collections.deque)  # [buffer, event]
        self.made: collections.Counter = collections.Counter()

    def _buffer(self, dtype, numel: int) -> list:
        key = (dtype, numel)
        free = self.pool[key]
        if free and free[0][1].query():
            return free.popleft()
        if not free or self.made[key] < self.depth:  # none free, or room for one more
            self.made[key] += 1
            return [torch.empty(numel, dtype=dtype, pin_memory=True), None]
        slot = free.popleft()
        slot[1].synchronize()  # its last copy has landed: the buffer is free
        return slot

    def stage(self, item):
        """(item on the device, the event after its copies)."""
        used = []

        def put(a):
            src = _as_tensor(a)
            if src.device == self.device:
                return src
            src = src.contiguous()
            slot = self._buffer(src.dtype, src.numel())
            buf = slot[0].view(src.shape)
            buf.copy_(src)
            used.append(slot)
            with torch.cuda.stream(self.stream):
                dst = torch.empty(src.shape, dtype=src.dtype, device=self.device)
                dst.copy_(buf, non_blocking=True)
            return dst

        staged = _map_arrays(put, item)
        event = torch.cuda.Event()
        event.record(self.stream)
        for slot in used:
            slot[1] = event
            self.pool[(slot[0].dtype, slot[0].numel())].append(slot)
        return staged, event


def prefetch(it: Iterator, device=None, buffer_size: int = 2) -> Iterator:
    """Stage up to ``buffer_size`` items of ``it`` ahead of the consumer onto
    ``device`` (None means CUDA; "cpu" passes the items through). Yields the
    items in order, as tensors on the device."""
    device = resolve_device(device)
    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    sentinel = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            if device.type == "cuda":
                with torch.cuda.device(device):
                    stager = _PinnedStager(device, buffer_size + 2)
                    for item in it:
                        if not put(stager.stage(item)):
                            return
            else:
                for item in it:
                    if not put((device_put_batch(item, device), None)):
                        return
            put(sentinel)
        except BaseException as e:  # noqa: BLE001 — surfaced on the consumer
            put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            got = q.get()
            if got is sentinel:
                break
            if isinstance(got, BaseException):
                raise got
            item, event = got
            if event is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(event)
                _map_arrays(lambda a: a.record_stream(stream), item)
            yield item
    finally:
        stop.set()
