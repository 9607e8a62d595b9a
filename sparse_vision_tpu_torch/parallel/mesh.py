"""The (data, model) mesh of a torch.distributed world and its collectives (port
of sparse_vision_tpu/parallel/mesh.py).

- 'data' shards the tokens of a step: every rank of a data column holds its
  own token rows.
- 'model' (optional) shards the SAE latent axis. A latent's whole decoder row
  lives on one rank, so the decoder-norm constraint stays local.

Rank ``r = d·m + k`` sits at data index d and model index k, row-major as
JAX's ``np.asarray(devices).reshape(mesh_shape)``. Its 'data' group holds the
ranks with the same k, its 'model' group the ranks with the same d; every rank
creates every group in the same order, as torch.distributed requires.

The collectives are built from the two that gloo also takes on CUDA tensors,
all_reduce and broadcast: ``psum`` / ``pmean`` / ``pmin`` over an axis or over
both, ``gather`` (a zeroed full tensor into which each rank writes its shard,
summed over the axis: adding zeros is exact), ``broadcast_`` from rank 0.
A mesh of one rank, or an axis of size 1, runs no collective at all.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

AXES = ("data", "model")
BOTH = ("data", "model")


def _param_axis(name: str):
    """The latent axis of an SAE parameter (JAX's sae_param_sharding): 1 for
    the encoders, 0 for the decoders and the per-latent vectors, None for the
    replicated rest (b_dec, batch_topk's threshold)."""
    if name in ("W_enc", "W_gate") or name.startswith("W_enc_"):
        return 1
    if name in ("W_dec", "b_enc", "b_gate", "b_mag", "r_mag", "log_threshold") \
            or name.startswith("W_dec_"):
        return 0
    return None


class Mesh:
    """One rank's view of the mesh: ``shape`` (d,) or (d, m), ``sizes`` per
    axis ('model' 1 on a (d,) mesh), this rank's ``rank`` and ``coords`` (d
    index, k index), its process ``groups`` per axis, and ``device``, where
    its collectives' scratch tensors live."""

    def __init__(self, shape: tuple, rank: int, groups: dict, device):
        self.shape = tuple(shape)
        self.sizes = {"data": self.shape[0], "model": self.shape[1] if len(self.shape) > 1 else 1}
        self.rank = rank
        m = self.sizes["model"]
        self.coords = (rank // m, rank % m)
        self.groups = groups
        self.device = torch.device(device)

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, rank={self.rank}, coords={self.coords})"

    @property
    def world(self) -> int:
        return math.prod(self.shape)

    def size(self, axis) -> int:
        """The ranks along ``axis`` ("data", "model" or both)."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        return math.prod(self.sizes[a] for a in axes)

    def index(self, axis: str) -> int:
        return self.coords[AXES.index(axis)]

    def _reduce_(self, out: torch.Tensor, axis, op) -> torch.Tensor:
        """``out`` reduced in place over ``axis``: one all_reduce on the world
        when the axis spans it, else one per axis group."""
        if self.size(axis) == 1:
            return out
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        if self.size(axes) == self.world:
            dist.all_reduce(out, op=op)
        else:
            for a in axes:
                if self.sizes[a] > 1:
                    dist.all_reduce(out, op=op, group=self.groups[a])
        return out

    def psum(self, t: torch.Tensor, axis) -> torch.Tensor:
        """The sum of ``t`` over ``axis`` ("data", "model" or BOTH), a new
        tensor on every rank of the axis."""
        return self._reduce_(t.detach().clone(), axis, dist.ReduceOp.SUM)

    def pmean(self, t: torch.Tensor, axis) -> torch.Tensor:
        return self.psum(t, axis) / self.size(axis)

    def pmin(self, t: torch.Tensor, axis) -> torch.Tensor:
        return self._reduce_(t.detach().clone(), axis, dist.ReduceOp.MIN)

    def psum_many(self, tensors, axis) -> list:
        """Each of ``tensors`` (one dtype) summed over ``axis``, through one
        all_reduce of their concatenation."""
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        self._reduce_(flat, axis, dist.ReduceOp.SUM)
        return [part.view(t.shape) for part, t in
                zip(flat.split([t.numel() for t in tensors]), tensors)]

    def gather(self, shard: torch.Tensor, dim: int, axis: str = "model") -> torch.Tensor:
        """The full tensor whose ``dim`` the ranks along ``axis`` hold in
        index order: a zeroed full tensor, this rank's shard written in, summed
        over the axis. A bool shard comes back bool."""
        n = self.size(axis)
        if n == 1:
            return shard.clone()
        work = shard.to(torch.int32) if shard.dtype == torch.bool else shard
        shape = list(work.shape)
        shape[dim] *= n
        full = work.new_zeros(shape)
        full.narrow(dim, self.index(axis) * work.shape[dim], work.shape[dim]).copy_(work)
        full = self.psum(full, axis)
        return full != 0 if shard.dtype == torch.bool else full

    def shard(self, full: torch.Tensor, dim: int, axis: str = "model") -> torch.Tensor:
        """This rank's contiguous slice of ``full`` along ``dim``."""
        n = self.size(axis)
        if full.shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {full.shape[dim]} not divisible by "
                             f"the {axis} axis of {n}")
        step = full.shape[dim] // n
        return full.narrow(dim, self.index(axis) * step, step).clone()

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` overwritten in place by rank ``src``'s values."""
        if self.world > 1:
            dist.broadcast(t, src=src)
        return t

    def barrier(self) -> None:
        """Wait for every rank (an all_reduce of one element)."""
        if self.world > 1:
            dist.all_reduce(torch.zeros(1, device=self.device))


def make_mesh(mesh_shape: tuple = (), device=None) -> Mesh:
    """This rank's mesh: ``()`` puts every rank of the world on 'data', ``(d,)``
    is d-way data parallel, ``(d, m)`` data x model. Without an initialized
    torch.distributed world the mesh has one rank; with one, its size must be
    the mesh's (parallel/distributed.initialize or spawn set it up).
    ``device`` holds the collectives' scratch tensors: the ranks' compute
    device (NCCL reduces CUDA tensors only)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    shape = tuple(int(n) for n in mesh_shape) or (world,)
    if len(shape) > 2 or any(n < 1 for n in shape):
        raise ValueError(f"mesh_shape must be (), (d,) or (d, m) of positive sizes, "
                         f"got {mesh_shape}")
    if math.prod(shape) != world:
        raise ValueError(
            f"mesh {shape} needs {math.prod(shape)} ranks, the torch.distributed world has "
            f"{world}: start the world with parallel.distributed.spawn (or the CLI's "
            "--mesh_shape)")
    d = shape[0]
    m = shape[1] if len(shape) > 1 else 1
    groups: dict = {"data": None, "model": None}
    if world > 1:
        # every rank creates every group, in the same order
        for k in range(m):
            g = dist.new_group([i * m + k for i in range(d)]) if 1 < d < world else None
            if rank % m == k:
                groups["data"] = g
        for i in range(d):
            g = dist.new_group([i * m + k for k in range(m)]) if 1 < m < world else None
            if rank // m == i:
                groups["model"] = g
    return Mesh(shape, rank, groups, "cpu" if device is None else device)


def param_axes(params: dict) -> dict:
    """Each parameter's latent axis on a mesh with a 'model' axis (None:
    replicated), from JAX's sae_param_sharding table."""
    return {k: _param_axis(k) for k in params}


def shard_params(params: dict, mesh: Mesh) -> dict:
    """This rank's shard of every parameter: the latent axis of each (param_axes)
    sliced at the rank's model index, the rest copied."""
    out = {}
    for k, v in params.items():
        axis = _param_axis(k)
        out[k] = v.clone() if axis is None else mesh.shard(v, axis)
    return out


def gather_params(local: dict, mesh: Mesh) -> dict:
    """The full parameters from every rank's shard (collective: every rank of
    the mesh calls it and gets them)."""
    out = {}
    for k, v in local.items():
        axis = _param_axis(k)
        out[k] = v.clone() if axis is None else mesh.gather(v, axis)
    return out
