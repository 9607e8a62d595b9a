"""Profiling and timing (port of sparse_vision_tpu/utils/profiling.py).

``maybe_profile`` wraps a region in ``torch.profiler`` when a directory is
given and writes one Chrome-trace JSON per region there (open it in Perfetto
or chrome://tracing); ``timeit_device`` measures the steady-state time of a
call, synchronizing the device after each trial. The Pipeline wraps each
training epoch's steps in ``maybe_profile(cfg.profile_dir, ...)``, not its
evals, as the JAX package wraps them in ``jax.profiler.trace``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str], device=None, name: str = "trace"):
    """torch.profiler over the block when ``trace_dir`` is set, a no-op
    otherwise. Records the CPU activity, and the CUDA activity (CUPTI) when
    ``device`` is a CUDA device; no stacks, shapes or memory, to keep traces
    small. Writes ``<trace_dir>/<name>_<pid>_<ns>.json`` when the block ends.
    Raises when CUDA tracing is asked for and this PyTorch cannot give it, or
    when the trace of such a block holds no device event, rather than leave
    a trace without the device."""
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("torch.profiler cannot trace CUDA in this PyTorch build "
                               "(no CUPTI); unset profile_dir or use a CUDA build with CUPTI")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities, record_shapes=False, profile_memory=False,
                 with_stack=False) as prof:
        yield prof
    if cuda and not any(e.device_type == torch.autograd.DeviceType.CUDA
                        for e in prof.events()):
        raise RuntimeError(f"the trace of {name!r} recorded no CUDA event: is CUPTI "
                           "missing from this machine?")
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"{name}_{os.getpid()}_{time.time_ns()}.json"))


def timeit_device(fn: Callable, *args, iters: int = 20, trials: int = 5,
                  warmup: int = 1) -> dict:
    """Median-of-trials wall time per call of ``fn(*args)``: {"median_s",
    "min_s", "all_s"}. Each trial runs ``iters`` calls and ends in a
    synchronize of the device of the first tensor it returns (the CPU runs
    eagerly)."""

    def sync(out):
        leaf = _first_tensor(out)
        if leaf is not None and leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)

    for _ in range(warmup):
        sync(fn(*args))
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = fn(*args)
        sync(out)
        times.append((time.perf_counter() - t0) / iters)
    times.sort()
    return {"median_s": times[len(times) // 2], "min_s": times[0], "all_s": times}


def _first_tensor(tree) -> Optional[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return tree
    leaves = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (tuple, list)) else ())
    for v in leaves:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None
