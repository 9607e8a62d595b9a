"""Activation cache: dump a frozen backbone's tapped activations once, then train
SAEs from the cached token shards (port of sparse_vision_tpu/data/activation_cache.py:
the sequential one- and multi-layer dumps and the host-side reader; the
overlapped dump is not ported).

Format, byte-compatible with the JAX package in both directions: a directory of
fixed-size token shards ``acts_00000.npy`` ([tokens, C]) + ``meta.json``. bfloat16
does not round-trip through the .npy header, so bf16 shards store a uint16 bitcast
and meta.json records the logical dtype; int8 shards carry a per-shard
per-channel scale sidecar ``scales_00000.npy`` and are dequantized on the host.
The reader yields torch CPU tensors (bf16 caches as torch.bfloat16).
"""

from __future__ import annotations

import json
import os
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


class _ShardWriter:
    """Accumulates token rows (CPU tensors, float32 or bfloat16) and publishes
    fixed-size ``acts_NNNNN.npy`` shards atomically (temp file + os.replace)."""

    def __init__(self, out_dir: str, shard_tokens: int, quantize: bool = False):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.shard_tokens = shard_tokens
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
            os.replace(path + ".tmp", path)
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
                     dtype: str = "float32", device=None) -> dict:
    """Run the frozen backbone over ``dataset`` on ``device`` (default CUDA), flatten
    the tapped layer to tokens ([B, H, W, C] -> [B*H*W, C]) and write fixed-size
    shards. ``dtype``: "float32", "bfloat16" (cast on the device) or "int8"
    (bf16 to the host, quantized per shard at flush). Returns the meta dict: the
    one-layer case of dump_activations_multi."""
    return dump_activations_multi(net, params, state, dataset, [layer], {layer: out_dir},
                                  batch_size=batch_size, shard_tokens=shard_tokens,
                                  dtype=dtype, device=device)[layer]


@torch.no_grad()
def dump_activations_multi(net, params: dict, state: Optional[dict], dataset, layers: list,
                           out_dirs: dict, batch_size: int = 64, shard_tokens: int = 1 << 16,
                           dtype: str = "float32", device=None) -> dict:
    """Write the caches of every layer in ``layers`` from ONE backbone pass: the
    forward stops at the deepest requested stage and one shard writer per layer
    shards its token stream. Each layer's shards and meta are byte-identical to a
    dump_activations of that layer alone, so the caches are aligned: the same
    shard geometry and token order (the paired caches of train/paired_caches.py).
    Returns {layer: meta}."""
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
    writers = {l: _ShardWriter(out_dirs[l], shard_tokens, quantize=dtype == "int8")
               for l in layers}
    for batch in dataset.batches(batch_size, shuffle=False):
        images = torch.from_numpy(batch.images).to(device)
        _, taps, _ = net.apply(params, images, state=state, stop_at=stop)
        for l in layers:
            writers[l].add(tokens_from_act(taps[l])[0].to(acc_dtype).cpu())
    return {l: writers[l].finish(l) for l in layers}


class ActivationCache:
    """Shard reader (synchronous memmap) yielding torch CPU tensors."""

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
        self._scales: dict = {}

    def scale(self, i: int) -> np.ndarray:
        """Shard ``i``'s per-channel dequantization scale ([C] float32)."""
        if i not in self._scales:
            self._scales[i] = np.load(_scale_path(self.shard_paths[i]))
        return self._scales[i]

    def shard(self, i: int) -> torch.Tensor:
        """Shard ``i`` as a [tokens, C] CPU tensor: float32, bfloat16, or float32
        dequantized from int8."""
        raw = np.array(np.load(self.shard_paths[i], mmap_mode="r"))  # read it all once
        dtype = self.meta["dtype"]
        if dtype == "bfloat16":
            return torch.from_numpy(raw.view(np.uint16)).view(torch.bfloat16)
        if dtype == "int8":
            return torch.from_numpy(dequantize_int8(raw, self.scale(i)))
        return torch.from_numpy(raw)

    def batches(self, tokens_per_step: int, shuffle: bool = False,
                seed: int = 0) -> Iterator[torch.Tensor]:
        """Yield [tokens_per_step, C] blocks; shards in (optionally shuffled) order
        and, when shuffling, shuffled block offsets within each shard; trailing
        partial steps dropped. Same order as the JAX package for the same seed."""
        rng = np.random.default_rng(seed)
        order = np.arange(len(self.shard_paths))
        if shuffle:
            rng.shuffle(order)
        for i in order:
            shard = self.shard(int(i))
            starts = np.arange(0, shard.shape[0] - tokens_per_step + 1, tokens_per_step)
            if shuffle:
                rng.shuffle(starts)
            for s in starts:
                yield shard[s : s + tokens_per_step]

    def stacks(self, tokens_per_step: int, k: int, shuffle: bool = False,
               seed: int = 0) -> Iterator[torch.Tensor]:
        """Yield [k', tokens_per_step, C] stacks of microbatches; the last stack of
        the epoch may have k' < k. When k*tokens_per_step divides the shard size a
        full stack is a view of one contiguous shard slice (shuffle granularity is
        then the stack); otherwise stacks assemble from ``batches``. Same blocks in
        the same order as the JAX package for the same seed."""
        block = tokens_per_step * k
        if int(self.meta["shard_tokens"]) % block == 0:
            rng = np.random.default_rng(seed)
            order = np.arange(len(self.shard_paths))
            if shuffle:
                rng.shuffle(order)
            tail: list = []
            for i in order:
                shard = self.shard(int(i))
                n_full = shard.shape[0] // block
                starts = np.arange(0, n_full * block, block)
                if shuffle:
                    rng.shuffle(starts)
                for s in starts:
                    yield shard[s : s + block].reshape(k, tokens_per_step, -1)
                # leftover whole steps at the shard tail (short last shard)
                for s in range(n_full * block, shard.shape[0] - tokens_per_step + 1,
                               tokens_per_step):
                    tail.append(shard[s : s + tokens_per_step])
                    if len(tail) == k:
                        yield torch.stack(tail)
                        tail = []
            if tail:
                yield torch.stack(tail)
            return
        buf: list = []
        for tok in self.batches(tokens_per_step, shuffle, seed):
            buf.append(tok)
            if len(buf) == k:
                yield torch.stack(buf)
                buf = []
        if buf:
            yield torch.stack(buf)
