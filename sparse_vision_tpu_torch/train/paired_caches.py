"""Cache preparation for trainers that zip several aligned activation caches
(transcoders: 2, crosscoders: L); port of the sequential parts of
sparse_vision_tpu/train/paired_caches.py (the dump/train overlap is not ported).

The caches of all layers come from one backbone pass
(data/activation_cache.dump_activations_multi), so they share shard geometry
and token order, and shuffled readers under one seed visit the same rows.
"""

from __future__ import annotations

import os

from sparse_vision_tpu_torch.data.activation_cache import ActivationCache, dump_activations_multi


def open_validated(dirs: dict, layers: tuple) -> list:
    """Open every layer's cache and enforce identical shard geometry. Token pairing
    depends on it, not only on counts: the shuffled order is a function of shard
    count and size, so a cache left by a run with another cache_tokens_per_step
    would pair tokens with the wrong rows."""
    caches = [ActivationCache(dirs[layer]) for layer in layers]
    for field in ("total_tokens", "shard_tokens", "num_shards"):
        vals = [c.meta[field] for c in caches]
        if len(set(vals)) != 1:
            raise ValueError(
                f"Cache {field} differs across {layers}: {vals}: all layers must share "
                "spatial dims and all caches must come from the same dump geometry "
                "(delete stale ones to re-dump)")
    return caches


def prepare_caches(pipe, layers: tuple, dirs: dict) -> list:
    """Dump the caches that are missing, in one backbone pass, and return the
    validated readers in ``layers`` order."""
    missing = [l for l in layers if not os.path.exists(os.path.join(dirs[l], "meta.json"))]
    if missing:
        print(f"Building aligned activation caches for {missing} in one pass ...")
        dump_activations_multi(pipe.net, pipe.frozen_params, pipe.net_state, pipe.train_ds,
                               missing, dirs, device=pipe.device, **pipe._cache_dump_kwargs())
    return open_validated(dirs, layers)


def epoch_stacks(pipe, caches: list, epoch: int):
    """Aligned tuples of [k, T, C_l] stacks for one epoch: the caches' shuffled
    readers zipped under one seed."""
    cfg = pipe.cfg
    its = [c.stacks(cfg.cache_tokens_per_step, pipe.CACHE_SCAN_K, shuffle=True,
                    seed=cfg.seed + epoch) for c in caches]
    return zip(*its)
