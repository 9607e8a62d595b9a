"""The process model of the port's mesh (port of
sparse_vision_tpu/parallel/distributed.py).

JAX drives every device of a mesh from one process. PyTorch needs one process
per rank, so here a mesh is a torch.distributed world of prod(mesh_shape)
ranks, ``rank = d·m + k`` row-major as JAX's
``np.asarray(devices).reshape(mesh_shape)`` (parallel/mesh.py).

- ``initialize`` joins the calling process to the world as one rank and builds
  its mesh (parallel/mesh.make_mesh). Rank r computes on ``cuda:(r % cards)``.
- ``spawn`` starts the whole world: ``fn(rank, mesh, *args)`` in one process
  per rank (the ``spawn`` start method), joined with a timeout. The first
  rank that raises fails the call with its traceback, and a world that
  outlives the timeout fails it too; either way the ranks still running are
  killed, so a hung collective fails the run instead of hanging it.

The backend is the caller's choice: "nccl" (one card per rank) or "gloo",
which also takes CUDA tensors for the two collectives the port uses,
all_reduce and broadcast, so several ranks can share one card. NCCL refuses
two ranks on one device: asking for it with more ranks than cards raises a
ValueError that names gloo, and the backend is never switched silently.
"""

from __future__ import annotations

import math
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from sparse_vision_tpu_torch.device import resolve_device
from sparse_vision_tpu_torch.parallel.mesh import Mesh, make_mesh

BACKENDS = ("nccl", "gloo")
# seconds a finished rank's siblings get to exit on their own before they are killed
_EXIT_GRACE_S = 30.0


class RankError(RuntimeError):
    """A rank of a spawned world raised (the message holds its traceback), or
    exited without a result."""


def world_size(mesh_shape: tuple, device) -> int:
    """The ranks of ``mesh_shape``: its product; ``()`` means one rank per card
    on CUDA (JAX's "every device on 'data'") and one rank on the CPU."""
    mesh_shape = tuple(mesh_shape)
    if mesh_shape:
        if len(mesh_shape) > 2 or any(int(n) < 1 for n in mesh_shape):
            raise ValueError(f"mesh_shape must be (), (d,) or (d, m) of positive sizes, "
                             f"got {mesh_shape}")
        return math.prod(int(n) for n in mesh_shape)
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def check_backend(backend: str, world: int, device) -> None:
    """Raise a ValueError for a backend that cannot run ``world`` ranks on
    ``device``: NCCL needs CUDA and one card per rank."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend != "nccl":
        return
    if torch.device(device).type != "cuda":
        raise ValueError(f'backend="nccl" needs CUDA; on {device} pass backend="gloo"')
    cards = torch.cuda.device_count()
    if world > cards:
        raise ValueError(f'backend="nccl" takes one rank per card: {world} ranks on {cards} '
                         f'card(s); pass backend="gloo" to let ranks share a card')


def initialize(mesh_shape: tuple, rank: int, init_method: str, backend: str = "nccl",
               device=None, timeout_s: float = 3600.0) -> Mesh:
    """Join the world of ``mesh_shape`` as ``rank`` (``init_method`` as
    torch.distributed takes it, e.g. ``file://<dir>/store`` or
    ``tcp://localhost:<port>``) and return this rank's mesh. On CUDA the rank
    computes on ``cuda:(rank % cards)``; ``device`` None means CUDA and raises
    without a GPU, as every entry point of the port does."""
    dev = resolve_device(device)
    world = world_size(mesh_shape, dev)
    check_backend(backend, world, dev)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    return make_mesh(tuple(mesh_shape) or (world,), device=dev)


def process_local_batch_slice(global_batch: int, ranks: int | None = None) -> int:
    """Each rank's share of a global batch over ``ranks`` (default: the world's
    size; Pipeline passes the 'data' axis's); a remainder raises, so the
    sharded means stay exact."""
    n = ranks if ranks is not None else (dist.get_world_size() if dist.is_initialized() else 1)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} ranks")
    return global_batch // n


def _to_cpu(tree):
    """``tree`` with every tensor moved to the CPU (a rank's result crosses the
    process boundary by pickle, never by CUDA IPC)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_to_cpu(v) for v in tree)
    if isinstance(tree, tuple):  # a NamedTuple
        return type(tree)(*(_to_cpu(v) for v in tree))
    return tree


def _rank_main(rank, fn, mesh_shape, args, device, backend, init_method, timeout_s, results):
    """One rank of ``spawn``: join, run ``fn``, report (rank, ok, result or
    traceback) on ``results``. A failure is reported before anything that could
    wait on the other ranks."""
    try:
        mesh = initialize(mesh_shape, rank, init_method, backend, device, timeout_s)
        out = _to_cpu(fn(rank, mesh, *args))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        results.close()
        results.join_thread()
        os._exit(1)  # the parent kills the ranks this one leaves waiting
    # pickled here, by value: the queue's own pickler would share the tensors'
    # memory by file descriptor, which dies with this process
    results.put((rank, True, pickle.dumps(out)))
    dist.destroy_process_group()


def spawn(fn, mesh_shape: tuple, *args, device=None, backend: str = "nccl",
          timeout_s: float = 3600.0) -> list:
    """Run ``fn(rank, mesh, *args)`` on every rank of the world of
    ``mesh_shape`` (``world_size``), one process each; return the ranks'
    results in rank order, their tensors on the CPU. ``fn``, ``args`` and the
    results travel by pickle, so ``fn`` is a module-level function.

    ``device`` None means CUDA and raises without a GPU; "cpu" runs the ranks
    on the CPU (gloo). On CUDA every kernel is built here first
    (ops/native.build), so the ranks load the libraries instead of running
    nvcc each. The ranks meet through a file store in a fresh temporary
    directory, so concurrent worlds never collide on a port.

    The first rank to raise fails the call with a RankError holding its
    traceback; a world still running after ``timeout_s`` seconds raises a
    TimeoutError. The ranks still running are then killed."""
    dev = resolve_device(device)
    world = world_size(mesh_shape, dev)
    check_backend(backend, world, dev)
    if dev.type == "cuda":
        from sparse_vision_tpu_torch.ops import native

        native.build()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="svt_world_")
    init_method = "file://" + os.path.join(store_dir, "store")
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(r, fn, tuple(mesh_shape), args, str(dev), backend, init_method,
                               timeout_s, results))
             for r in range(world)]
    done: dict = {}
    ok = False
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(done) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                running = [r for r in range(world) if r not in done]
                raise TimeoutError(f"world {tuple(mesh_shape)} still running after {timeout_s} "
                                   f"s (ranks {running} gave no result); killed")
            try:
                rank, good, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                lost = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if lost:
                    raise RankError(f"rank {lost[0]} exited with code "
                                    f"{procs[lost[0]].exitcode} and no result") from None
                continue
            if not good:
                raise RankError(f"rank {rank} of world {tuple(mesh_shape)} raised:\n{payload}")
            done[rank] = pickle.loads(payload)
        ok = True
    finally:
        for p in procs:
            if p.pid is None:
                continue
            p.join(timeout=_EXIT_GRACE_S if ok else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(store_dir, ignore_errors=True)
    return [done[r] for r in range(world)]
