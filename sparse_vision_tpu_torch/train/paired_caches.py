"""Cache preparation for trainers that zip several aligned activation caches
(transcoders: 2, crosscoders: L), sequential or overlapped with training (port
of sparse_vision_tpu/train/paired_caches.py).

The caches of all layers come from one backbone pass
(data/activation_cache.dump_activations_multi), so they share shard geometry
and token order, and shuffled readers under one seed visit the same rows. When
every cache is missing and ``cfg.overlap_dump_train`` is set, the pass runs on a
dump thread and the first epoch trains on aligned shard tuples as their atomic
writes complete (data/activation_cache.stream_stacks_zip); later epochs read the
finished caches shuffled. The bytes on disk are the sequential dump's. When only
some caches are missing, the overlap is skipped (a fresh stream cannot zip
against an existing cache's shuffled reader) and the missing ones dump first.
On a mesh of ranks (Pipeline's ``mesh``) rank 0 alone dumps, and the others
wait for it at a barrier, as Pipeline.train_sae_cached does; the overlap is
refused there (train/pipeline.validate_mesh_mode).
"""

from __future__ import annotations

import os
from typing import Optional

from sparse_vision_tpu_torch.data.activation_cache import (
    ActivationCache,
    dump_activations_multi,
    overlapped_multi_dump,
    stream_stacks_zip,
)


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


def prepare_caches(pipe, layers: tuple, dirs: dict) -> tuple:
    """Dump what is missing and return ``(stream_qs, dump_thread, caches)``: in
    overlap mode the per-layer queues of the running dump and its thread, with
    ``caches`` None; otherwise None, None and the validated readers in
    ``layers`` order. In overlap mode the caller joins the thread and opens the
    caches before the second epoch (epoch_stacks does)."""
    cfg = pipe.cfg
    missing = [l for l in layers if not os.path.exists(os.path.join(dirs[l], "meta.json"))]
    kwargs = dict(device=pipe.device, **pipe._cache_dump_kwargs())
    if pipe.mesh is not None:
        if missing and pipe.is_main:
            print(f"Building aligned activation caches for {missing} in one pass ...")
            dump_activations_multi(pipe.net, pipe.frozen_params, pipe.net_state,
                                   pipe.train_ds, missing, dirs, **kwargs)
        pipe.mesh.barrier()
        return None, None, open_validated(dirs, layers)
    if (cfg.overlap_dump_train and cfg.sae_epochs > cfg.sae_checkpoint_epoch
            and len(missing) == len(layers)):
        print(f"Building aligned activation caches for {list(layers)} in one pass "
              "(overlapped) ...")
        qs, thread = overlapped_multi_dump(pipe.net, pipe.frozen_params, pipe.net_state,
                                           pipe.train_ds, list(layers), dirs, **kwargs)
        return qs, thread, None
    if missing:
        if cfg.overlap_dump_train:
            print(f"overlap_dump_train: caches partially exist; dumping {missing} "
                  "sequentially (a fresh stream cannot zip against an existing cache)")
        print(f"Building aligned activation caches for {missing} in one pass ...")
        dump_activations_multi(pipe.net, pipe.frozen_params, pipe.net_state, pipe.train_ds,
                               missing, dirs, **kwargs)
    return None, None, open_validated(dirs, layers)


def epoch_stacks(pipe, layers: tuple, dirs: dict, epoch: int, start: int,
                 stream_qs: Optional[dict], dump_thread, caches):
    """(iterator of aligned tuples of [k, T, C_l] stacks for one epoch, the
    caches, opened here once the dump of the streamed epoch has finished). The
    streamed first epoch runs in dump order; later epochs zip the caches'
    shuffled readers under one seed, which visit the same token rows."""
    cfg = pipe.cfg
    tps, k = cfg.cache_tokens_per_step, pipe.CACHE_SCAN_K
    if stream_qs is not None and epoch == start:
        return stream_stacks_zip([stream_qs[l] for l in layers], tps, k,
                                 logical_dtype=cfg.cache_dtype), caches
    if caches is None:  # the dump finished during the streamed epoch
        dump_thread.join()
        caches = open_validated(dirs, layers)
    its = [c.stacks(tps, k, shuffle=True, seed=cfg.seed + epoch) for c in caches]
    return zip(*its), caches
