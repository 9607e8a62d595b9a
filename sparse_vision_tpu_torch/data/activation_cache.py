"""Activation cache: dump a frozen backbone's tapped activations once, then train
SAEs from the cached token shards (port of sparse_vision_tpu/data/activation_cache.py).

Format, byte-compatible with the JAX package in both directions: a directory of
fixed-size token shards ``acts_00000.npy`` ([tokens, C]) + ``meta.json``. bfloat16
does not round-trip through the .npy header, so bf16 shards store a uint16 bitcast
and meta.json records the logical dtype; int8 shards carry a per-shard
per-channel scale sidecar ``scales_00000.npy``. The reader yields torch CPU
tensors (bf16 caches as torch.bfloat16); an int8 cache is dequantized on the
host, or yields (int8 block, scale) pairs for the train step to dequantize on
the device.

The dump stages image batches onto the device one step ahead (data/prefetch.py)
and drains each batch's tokens one batch behind, their device-to-host copies in
flight while the next batch's forward runs. With shard queues it publishes each
shard's path as its atomic write completes, and ``stream_stacks`` trains on
those shards while later ones are still being written (the dump/train overlap).
The reader reads the next shard on a thread while the current one trains.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch


def _scale_path(shard_path: str) -> str:
    """Sidecar per-channel scale file of an int8 shard (acts_N.npy -> scales_N.npy)."""
    d, b = os.path.split(shard_path)
    return os.path.join(d, b.replace("acts_", "scales_", 1))


def quantize_int8(arr: np.ndarray):
    """Symmetric per-channel int8 quantization of a [T, C] token block:
    scale[c] = absmax / 127 (floored at 1e-12); q = round(arr / scale) in [-127, 127]."""
    a = np.asarray(arr, np.float32)
    scale = np.abs(a).max(axis=0) / 127.0
    scale = np.maximum(scale, 1e-12).astype(np.float32)
    q = np.clip(np.rint(a / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_int8(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * scale


def _bf16_bits(tok: torch.Tensor) -> np.ndarray:
    return tok.view(torch.int16).numpy().view(np.uint16)


def _bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns -> the float32 values they denote (exact)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _bf16_tensor(bits: np.ndarray) -> torch.Tensor:
    """bf16 bit patterns (uint16) as a torch.bfloat16 tensor sharing their memory."""
    return torch.from_numpy(bits.view(np.uint16)).view(torch.bfloat16)


class _ShardWriter:
    """Accumulates token rows (CPU tensors, float32 or bfloat16) and publishes
    fixed-size ``acts_NNNNN.npy`` shards atomically (temp file + os.replace),
    then puts each shard's path on ``shard_queue`` when one is given."""

    def __init__(self, out_dir: str, shard_tokens: int,
                 shard_queue: Optional[queue.Queue] = None, quantize: bool = False):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.shard_tokens = shard_tokens
        self.shard_queue = shard_queue
        self.quantize = quantize
        self.buf: list = []
        self.buffered = 0
        self.shard_idx = 0
        self.total = 0
        self.dim: Optional[int] = None
        self.storage: Optional[str] = None  # "float32" | "bfloat16"
        self.sumsq = 0.0  # running sum of squares -> meta["token_rms"]
        self.sumsq_n = 0

    def add(self, tok: torch.Tensor) -> None:
        if tok.dtype == torch.bfloat16:
            arr, storage = _bf16_bits(tok.contiguous()), "bfloat16"
            flat = _bits_to_f32(arr).ravel()
        elif tok.dtype == torch.float32:
            arr = np.ascontiguousarray(tok.numpy())
            storage, flat = "float32", arr.ravel()
        else:
            raise ValueError(f"cache tokens must be float32 or bfloat16, got {tok.dtype}")
        self.storage = storage
        self.dim = arr.shape[1]
        # token RMS of the TRUE values (before int8 quantization), as a float32
        # dot product, exactly as the JAX package computes it
        self.sumsq += float(np.dot(flat, flat))
        self.sumsq_n += flat.size
        self.buf.append(arr)
        self.buffered += arr.shape[0]
        self._flush(final=False)

    def _flush(self, final: bool) -> None:
        while self.buffered >= self.shard_tokens or (final and self.buffered > 0):
            take = min(self.shard_tokens, self.buffered)
            chunk, rest, got = [], [], 0
            for a in self.buf:
                if got + a.shape[0] <= take:
                    chunk.append(a)
                    got += a.shape[0]
                else:
                    chunk.append(a[: take - got])
                    rest.append(a[take - got :])
                    got = take
            arr = np.ascontiguousarray(np.concatenate(chunk, axis=0))
            path = os.path.join(self.out_dir, f"acts_{self.shard_idx:05d}.npy")
            if self.quantize:
                vals = _bits_to_f32(arr) if self.storage == "bfloat16" else arr
                q, scale = quantize_int8(vals)
                spath = _scale_path(path)
                with open(spath + ".tmp", "wb") as f:
                    np.save(f, scale)
                os.replace(spath + ".tmp", spath)  # the scale lands before its shard
                arr = q
            with open(path + ".tmp", "wb") as f:
                np.save(f, arr)
            os.replace(path + ".tmp", path)  # atomic: readers never see part of a shard
            if self.shard_queue is not None:
                self.shard_queue.put(path)
            self.shard_idx += 1
            self.total += arr.shape[0]
            self.buf = rest
            self.buffered = sum(a.shape[0] for a in self.buf)
            if final and self.buffered == 0:
                break

    def finish(self, layer: str) -> dict:
        self._flush(final=True)
        if self.dim is None:
            raise ValueError(
                f"activation dump for {layer!r} received ZERO batches: the dataset "
                "has fewer samples than one batch (drop_last); nothing to cache")
        meta = {
            "layer": layer,
            "dim": int(self.dim),
            "num_shards": self.shard_idx,
            "total_tokens": int(self.total),
            "shard_tokens": int(self.shard_tokens),
            "dtype": "int8" if self.quantize else self.storage,
            "token_rms": float(np.sqrt(self.sumsq / max(self.sumsq_n, 1))),
        }
        with open(os.path.join(self.out_dir, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
        return meta


def dump_activations(net, params: dict, state: Optional[dict], dataset, layer: str,
                     out_dir: str, batch_size: int = 64, shard_tokens: int = 1 << 16,
                     dtype: str = "float32", device=None,
                     shard_queue: Optional[queue.Queue] = None,
                     workers: Optional[int] = None) -> dict:
    """Run the frozen backbone over ``dataset`` on ``device`` (default CUDA), flatten
    the tapped layer to tokens ([B, H, W, C] -> [B*H*W, C]) and write fixed-size
    shards. ``dtype``: "float32", "bfloat16" (cast on the device) or "int8"
    (bf16 to the host, quantized per shard at flush). ``shard_queue`` receives
    each shard's path once its atomic write completes (the dump/train overlap;
    the bytes are the same as without it). ``workers``: the dataset's decode
    threads (datasets._auto_workers). Returns the meta dict: the one-layer
    case of dump_activations_multi."""
    return dump_activations_multi(net, params, state, dataset, [layer], {layer: out_dir},
                                  batch_size=batch_size, shard_tokens=shard_tokens,
                                  dtype=dtype, device=device, workers=workers,
                                  shard_queues=None if shard_queue is None
                                  else {layer: shard_queue})[layer]


@torch.no_grad()
def dump_activations_multi(net, params: dict, state: Optional[dict], dataset, layers: list,
                           out_dirs: dict, batch_size: int = 64, shard_tokens: int = 1 << 16,
                           dtype: str = "float32", device=None,
                           shard_queues: Optional[dict] = None,
                           workers: Optional[int] = None) -> dict:
    """Write the caches of every layer in ``layers`` from ONE backbone pass: the
    forward stops at the deepest requested stage and one shard writer per layer
    shards its token stream. Each layer's shards and meta are byte-identical to a
    dump_activations of that layer alone, so the caches are aligned: the same
    shard geometry and token order (the paired caches of train/paired_caches.py).

    Image batches are decoded by ``workers`` threads (a file-backed dataset's;
    datasets._auto_workers) and staged onto the device one step ahead
    (data/prefetch.py).
    Each batch's tokens leave the device one batch behind: their copies into
    pinned host buffers are queued with the batch (``non_blocking``, one event),
    and the batch is drained into the writers only after the next batch's
    forward has been queued, so the copies overlap that forward. ``shard_queues``
    maps a layer to a queue that receives its shard paths (see
    dump_activations); the caller owns the end-of-stream item. Returns {layer:
    meta}."""
    from sparse_vision_tpu_torch.data.prefetch import prefetch
    from sparse_vision_tpu_torch.device import resolve_device
    from sparse_vision_tpu_torch.models.sae import tokens_from_act

    device = resolve_device(device)
    if dtype not in ("float32", "bfloat16", "int8"):
        raise ValueError(f"cache dtype must be float32, bfloat16 or int8, got {dtype!r}")
    layers = list(dict.fromkeys(layers))
    missing = [l for l in layers if l not in out_dirs]
    if missing:
        raise ValueError(f"out_dirs missing entries for layers {missing}")
    stop = max(layers, key=net.index_of)  # one forward serves all layers
    acc_dtype = torch.float32 if dtype == "float32" else torch.bfloat16
    writers = {l: _ShardWriter(out_dirs[l], shard_tokens, (shard_queues or {}).get(l),
                               quantize=dtype == "int8")
               for l in layers}

    def to_host(toks: dict):
        """The batch's tokens on their way to the host: (tensors, event or None)."""
        if device.type != "cuda":
            return {l: t.cpu() for l, t in toks.items()}, None
        host = {}
        for l, t in toks.items():
            host[l] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host[l].copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def drain(pending) -> None:
        host, event = pending
        if event is not None:
            event.synchronize()  # the copies have landed
        for l in layers:
            writers[l].add(host[l])

    pending = None
    for batch in prefetch(dataset.batches(batch_size, shuffle=False, workers=workers), device):
        _, taps, _ = net.apply(params, batch.images, state=state, stop_at=stop)
        toks = to_host({l: tokens_from_act(taps[l])[0].to(acc_dtype) for l in layers})
        if pending is not None:
            drain(pending)
        pending = toks
    if pending is not None:
        drain(pending)
    return {l: writers[l].finish(l) for l in layers}


def _stream_block(arr: np.ndarray, logical_dtype: str) -> torch.Tensor:
    """A block of a streamed shard (storage dtype) as a CPU tensor of its
    logical dtype, copied out of the shard's memory map."""
    arr = np.array(arr)
    return _bf16_tensor(arr) if logical_dtype == "bfloat16" else torch.from_numpy(arr)


def stream_stacks(shard_queue: queue.Queue, tokens_per_step: int, k: int,
                  logical_dtype: str = "float32") -> Iterator[torch.Tensor]:
    """Yield [k', tokens_per_step, C] stacks from shard paths arriving on
    ``shard_queue`` while the dump is still writing later shards: the dump/train
    overlap consumer.

    Queue items: a shard path (complete, published atomically by the dump),
    ``None`` = the dump finished, a BaseException = the dump failed (re-raised
    here). Remainder tokens carry across shards; a trailing partial step is
    dropped. Order is dump order: the streamed first epoch has no shuffle. int8
    shards are dequantized on the host (their scale sidecar is published before
    the shard)."""
    block = tokens_per_step * k
    kind = "float32" if logical_dtype == "int8" else logical_dtype  # what is yielded
    rem: Optional[np.ndarray] = None
    while True:
        item = shard_queue.get()
        if item is None:
            break
        if isinstance(item, BaseException):
            raise item
        arr = np.load(item, mmap_mode="r")
        if logical_dtype == "int8":
            arr = dequantize_int8(np.asarray(arr), np.load(_scale_path(item)))
        if rem is not None and rem.shape[0]:
            # only a short last shard leaves a remainder when shard_tokens is a
            # multiple of the block, so this copy is rare
            arr = np.concatenate([rem, np.asarray(arr)], axis=0)
        n_full = arr.shape[0] // block
        for s in range(0, n_full * block, block):
            yield _stream_block(arr[s : s + block], kind).reshape(k, tokens_per_step, -1)
        rem = np.array(arr[n_full * block :])
    if rem is not None and rem.shape[0] >= tokens_per_step:
        n_steps = rem.shape[0] // tokens_per_step
        yield _stream_block(rem[: n_steps * tokens_per_step], kind).reshape(
            n_steps, tokens_per_step, -1)


def overlapped_multi_dump(net, params, state, dataset, layers: list, out_dirs: dict,
                          **dump_kwargs) -> tuple:
    """Start dump_activations_multi on a background thread with one overlap queue
    per layer; returns ({layer: queue}, thread). Each queue receives its layer's
    shard paths in dump order, then ``None`` when the dump finished, or the
    exception (put on every queue, so any blocked consumer wakes) when it failed.
    On a CUDA device the thread runs the backbone on a stream of its own; only
    file paths cross to the consumer, no tensor. The caches on disk are
    byte-identical to the sequential dump's."""
    from sparse_vision_tpu_torch.device import resolve_device

    device = resolve_device(dump_kwargs.pop("device", None))
    qs = {l: queue.Queue() for l in layers}

    def producer():
        try:
            if device.type == "cuda":
                with torch.cuda.device(device), torch.cuda.stream(torch.cuda.Stream(device)):
                    dump_activations_multi(net, params, state, dataset, layers, out_dirs,
                                           device=device, shard_queues=qs, **dump_kwargs)
            else:
                dump_activations_multi(net, params, state, dataset, layers, out_dirs,
                                       device=device, shard_queues=qs, **dump_kwargs)
            for q in qs.values():
                q.put(None)
        except BaseException as e:  # noqa: BLE001 — forwarded to every stream consumer
            for q in qs.values():
                q.put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    return qs, t


def stream_stacks_zip(shard_queues: list, tokens_per_step: int, k: int,
                      logical_dtype: str = "float32") -> Iterator[tuple]:
    """stream_stacks over L aligned overlap queues, zipped: tuples of [k',
    tokens_per_step, C_l] stacks, one per layer, while the multi-layer dump is
    still writing. The caches of one pass share shard geometry and token order,
    so the L streams yield the same block counts and the zip cannot deadlock."""
    its = [stream_stacks(q, tokens_per_step, k, logical_dtype=logical_dtype)
           for q in shard_queues]
    yield from zip(*its)


class ActivationCache:
    """Shard reader yielding torch CPU tensors: a synchronous memory map, or a
    thread that reads the next shard ahead."""

    def __init__(self, cache_dir: str):
        with open(os.path.join(cache_dir, "meta.json")) as f:
            self.meta = json.load(f)
        self.dir = cache_dir
        self.shard_paths = [
            os.path.join(cache_dir, f"acts_{i:05d}.npy")
            for i in range(self.meta["num_shards"])
        ]
        self.dim = self.meta["dim"]
        self.total_tokens = self.meta["total_tokens"]
        self.quantized = self.meta["dtype"] == "int8"
        self._scales: dict = {}

    def scale(self, i: int) -> np.ndarray:
        """Shard ``i``'s per-channel dequantization scale ([C] float32)."""
        if i not in self._scales:
            self._scales[i] = np.load(_scale_path(self.shard_paths[i]))
        return self._scales[i]

    @property
    def token_rms(self) -> float:
        """sqrt(mean(x^2)) over the cached tokens: the per-layer input scale that
        sae_input_norm="rms" training divides by. The dump records it in
        meta.json; for a cache without the field it is computed once from the
        first shard (dequantized) and written back."""
        if "token_rms" not in self.meta:
            a = self._read(0, dequant=True)
            flat = (a.float() if a.dtype == torch.bfloat16 else a).numpy().ravel()
            self.meta["token_rms"] = float(np.sqrt(np.dot(flat, flat) / max(flat.size, 1)))
            tmp = os.path.join(self.dir, "meta.json.tmp")
            with open(tmp, "w") as f:
                json.dump(self.meta, f, indent=1)
            os.replace(tmp, os.path.join(self.dir, "meta.json"))
        return float(self.meta["token_rms"])

    def _read(self, i: int, dequant: bool) -> torch.Tensor:
        """Shard ``i`` read in full (the copy faults the memory map's pages in) as a
        [tokens, C] CPU tensor: float32, bfloat16, int8 (``dequant`` False) or
        float32 dequantized from int8."""
        raw = np.array(np.load(self.shard_paths[i], mmap_mode="r"))
        dtype = self.meta["dtype"]
        if dtype == "bfloat16":
            return _bf16_tensor(raw)
        if dtype == "int8" and dequant:
            return torch.from_numpy(dequantize_int8(raw, self.scale(i)))
        return torch.from_numpy(raw)

    def _iter_shards(self, order, prefetch, dequant: bool = True) -> Iterator[tuple]:
        """Yield ``(shard_index, shard tensor)`` in ``order``. ``prefetch=False``
        reads each shard on the consumer; True reads the next shard on a thread
        (the copy out of the memory map and the int8 host dequantization run
        there) while the consumer works on the current one. A producer error is
        re-raised on the consumer; abandoning the generator releases the thread
        (stop event). "native" (the JAX package's C++ ring-buffer reader) is not
        ported and raises. ``dequant`` False yields an int8 cache's raw shards,
        for the device dequantization (pair them with ``scale``)."""
        if prefetch == "native":
            raise NotImplementedError(
                "prefetch='native' (the C++ ring-buffer reader) is not ported; use "
                "prefetch=True (the read-ahead thread) or False")
        if not prefetch:
            for i in order:
                yield int(i), self._read(int(i), dequant)
            return

        q: queue.Queue = queue.Queue(maxsize=1)
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
                for i in order:
                    if not put((int(i), self._read(int(i), dequant))):
                        return
            except BaseException as e:  # noqa: BLE001 — forwarded, not swallowed
                put(e)
            else:
                put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    t.join()
                    raise item
                yield item
            t.join()
        finally:
            stop.set()

    def _scale_tensor(self, i: int) -> torch.Tensor:
        return torch.from_numpy(self.scale(i))

    def batches(self, tokens_per_step: int, shuffle: bool = False, seed: int = 0,
                prefetch=True, dequantize: str = "host") -> Iterator:
        """Yield [tokens_per_step, C] blocks; shards in (optionally shuffled) order
        and, when shuffling, shuffled block offsets within each shard; trailing
        partial steps dropped. Same order as the JAX package for the same seed.
        An int8 cache with ``dequantize="device"`` yields (int8 block, scale [C])
        pairs instead of float32 blocks."""
        dev_q = self.quantized and dequantize == "device"
        rng = np.random.default_rng(seed)
        order = np.arange(len(self.shard_paths))
        if shuffle:
            rng.shuffle(order)
        for i, shard in self._iter_shards(order, prefetch, dequant=not dev_q):
            starts = np.arange(0, shard.shape[0] - tokens_per_step + 1, tokens_per_step)
            if shuffle:
                rng.shuffle(starts)
            for s in starts:
                blk = shard[s : s + tokens_per_step]
                yield (blk, self._scale_tensor(i)) if dev_q else blk

    def stacks(self, tokens_per_step: int, k: int, shuffle: bool = False, seed: int = 0,
               prefetch=True, dequantize: str = "host") -> Iterator:
        """Yield [k', tokens_per_step, C] stacks of microbatches; the last stack of
        the epoch may have k' < k. When k*tokens_per_step divides the shard size a
        full stack is a view of one contiguous shard slice (shuffle granularity is
        then the stack); otherwise stacks assemble from ``batches``. Same blocks in
        the same order as the JAX package for the same seed.

        An int8 cache with ``dequantize="device"`` yields (int8 stack, scale [C])
        pairs; a stack then never spans shards (the scale is per shard: a short
        shard's tail steps are flushed as a short stack), which needs the aligned
        shard size: otherwise it raises."""
        dev_q = self.quantized and dequantize == "device"
        block = tokens_per_step * k
        shard_tokens = int(self.meta["shard_tokens"])
        if shard_tokens % block == 0:
            rng = np.random.default_rng(seed)
            order = np.arange(len(self.shard_paths))
            if shuffle:
                rng.shuffle(order)
            tail: list = []
            for i, shard in self._iter_shards(order, prefetch, dequant=not dev_q):
                scale = self._scale_tensor(i) if dev_q else None
                n_full = shard.shape[0] // block
                starts = np.arange(0, n_full * block, block)
                if shuffle:
                    rng.shuffle(starts)
                for s in starts:
                    stk = shard[s : s + block].reshape(k, tokens_per_step, -1)
                    yield (stk, scale) if dev_q else stk
                # leftover whole steps at the shard tail (short last shard)
                for s in range(n_full * block, shard.shape[0] - tokens_per_step + 1,
                               tokens_per_step):
                    tail.append(shard[s : s + tokens_per_step])
                    if len(tail) == k:
                        yield (torch.stack(tail), scale) if dev_q else torch.stack(tail)
                        tail = []
                if dev_q and tail:  # scales must not mix: flush before the next shard
                    yield torch.stack(tail), scale
                    tail = []
            if tail:
                yield torch.stack(tail)
            return
        if dev_q:
            raise ValueError(
                "dequantize='device' needs shard_tokens to be a multiple of "
                f"k*tokens_per_step (shard {shard_tokens}, block {block}); the "
                "unaligned assembly crosses shard (and so scale) boundaries; use "
                "dequantize='host'")
        buf: list = []
        for tok in self.batches(tokens_per_step, shuffle, seed, prefetch):
            buf.append(tok)
            if len(buf) == k:
                yield torch.stack(buf)
                buf = []
        if buf:
            yield torch.stack(buf)
