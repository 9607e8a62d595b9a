"""Per-epoch checkpoints of a training state (the port's counterpart of
sparse_vision_tpu/train/checkpoint.py, with torch files in place of Orbax).

A checkpoint is the file ``<ckpt_dir>/epoch_{e}``, written by ``torch.save``,
of a tree of dicts whose leaves are tensors and Python ints: the SAE's is
``{"params", "opt_state": {"mu", "nu", "count"}, "step", "dead_acc"}``, the
JAX package's tree. It loads with ``torch.load(weights_only=True)``.

``save_checkpoint(..., blocking=False)`` copies every tensor to the host on the
calling thread (one snapshot of the state as it is at the call, complete before
the call returns) and hands the copies to a writer thread, so the write
overlaps the next epoch and the next epoch's updates cannot reach the file.
Every write goes to a temporary file in the same folder, named so that
``latest_epoch`` never sees it, and is published with ``os.replace``. Call
``wait_for_saves()`` before reading a checkpoint just saved, or exiting; it
raises the first error of a write.
"""

from __future__ import annotations

import atexit
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import torch

_writer: Optional[ThreadPoolExecutor] = None
_pending: list = []
_lock = threading.Lock()


def _get_writer() -> ThreadPoolExecutor:
    global _writer
    if _writer is None:
        _writer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="checkpoint")
        atexit.register(wait_for_saves)
    return _writer


def _to_host(tree):
    """A host copy of every tensor leaf (shares no storage with ``tree``)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, bool) or not isinstance(tree, int):
        raise TypeError(f"checkpoint leaves are tensors and ints, not {type(tree).__name__}")
    return int(tree)


def _write(path: str, tree) -> str:
    folder, name = os.path.split(path)
    tmp = os.path.join(folder, f".{name}.tmp{os.getpid()}")
    torch.save(tree, tmp)
    os.replace(tmp, path)
    return path


def _path(ckpt_dir: str, epoch: int) -> str:
    return os.path.abspath(os.path.join(ckpt_dir, f"epoch_{epoch}"))


def save_checkpoint(ckpt_dir: str, epoch: int, tree: Any, blocking: bool = True) -> str:
    """Save ``tree`` for ``epoch`` as ``<ckpt_dir>/epoch_{epoch}``; with
    ``blocking=False`` only the host snapshot happens before the return."""
    path = _path(ckpt_dir, epoch)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    snapshot = _to_host(tree)
    if blocking:
        return _write(path, snapshot)
    with _lock:
        _pending.append(_get_writer().submit(_write, path, snapshot))
    return path


def wait_for_saves() -> None:
    """Block until every asynchronous write has landed; raise the first error."""
    with _lock:
        pending = list(_pending)
        _pending.clear()
    errors = [f.exception() for f in pending]
    for e in errors:
        if e is not None:
            raise e


def load_checkpoint(ckpt_dir: str, epoch: int, like: Optional[Any] = None) -> Any:
    """The tree saved for ``epoch``, its tensors on the device of ``like``'s
    tensors (the CPU without ``like``), whose keys, shapes and dtypes it must
    match."""
    device = _first_device(like) if like is not None else "cpu"
    tree = torch.load(_path(ckpt_dir, epoch), map_location=device, weights_only=True)
    if like is not None:
        _check_like(tree, like, "")
    return tree


def _first_device(tree):
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        for v in tree.values():
            d = _first_device(v)
            if d is not None:
                return d
    return None


def _check_like(tree, like, where: str) -> None:
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"checkpoint{where}: keys {got} != {sorted(like)}")
        for k in like:
            _check_like(tree[k], like[k], f"{where}[{k!r}]")
    elif isinstance(like, torch.Tensor):
        if (not isinstance(tree, torch.Tensor) or tree.shape != like.shape
                or tree.dtype != like.dtype):
            got = (tuple(tree.shape), tree.dtype) if isinstance(tree, torch.Tensor) else tree
            raise ValueError(f"checkpoint{where}: {got} != {(tuple(like.shape), like.dtype)}")
    elif not isinstance(tree, int):
        raise ValueError(f"checkpoint{where}: expected an int, got {type(tree).__name__}")


def latest_epoch(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    epochs = [
        int(d.split("_", 1)[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("epoch_") and d.split("_", 1)[1].isdigit()
    ]
    return max(epochs) if epochs else None
