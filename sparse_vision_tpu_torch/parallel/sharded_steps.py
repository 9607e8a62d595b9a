"""Data-parallel SAE training (port of sparse_vision_tpu/parallel/sharded_steps.py).

Every rank holds the whole (replicated) train state and its own token shard of
each step, and runs the single-device step of train/steps.py on it: the
variant's fused op (the CUDA kernels of PERF.md rows 1-10 on the card, their
plain versions on the CPU) or the TopK fast paths. DataSync then makes the
replicas take the same update:
- the gradients are pmean'd over 'data' (one all_reduce of all of them): with
  equal shards the mean of the local-mean gradients is the global gradient;
- a latent is dead in the batch when no shard saw it fire: psum_data(¬dead)
  == 0, so the dead accumulator stays replicated;
- the metrics are pmean'd; perc_dead is read from the replicated accumulator;
- the resample schedule and its draws come from the replicated step counter
  and a generator seeded alike on every rank, so every rank makes the same
  surgery; the variants that do not resample use the rolling dead window;
- batch_topk selects against the global batch's cutoff and observes the
  least positive kept value over the ranks (ops/fast_batch_topk.py); AuxK
  runs on each shard against the replicated accumulator.
The replicated state is broadcast from rank 0 (put_replicated_state), and each
rank takes its token rows with put_tokens_sharded.
"""

from __future__ import annotations

import torch

from sparse_vision_tpu_torch.train.steps import (
    LocalSync,
    SAETrainState,
    make_sae_train_step_from_acts,
)


class DataSync(LocalSync):
    """train/steps.make_update's reductions over the 'data' axis of ``mesh``
    (module docstring); the dead fraction is LocalSync's, of the replicated
    accumulator."""

    def __init__(self, mesh):
        self.mesh = mesh

    def grads(self, grads: dict) -> dict:
        n = self.mesh.size("data")
        summed = self.mesh.psum_many(list(grads.values()), "data")
        return {k: g / n for k, g in zip(grads, summed)}

    def dead(self, dead: torch.Tensor) -> torch.Tensor:
        return self.mesh.psum((~dead).to(torch.int32), "data") == 0

    def metrics(self, m: dict) -> dict:
        means = self.mesh.pmean(torch.stack([v.float() for v in m.values()]), "data")
        return dict(zip(m, means.unbind()))


def make_sharded_fused_train_step(mesh, lambda_sparse: float, tx, dead_neurons_steps: int,
                                  expansion_factor: int, fused_opts: dict | None = None,
                                  fused: bool = True, sae_model_name: str = "sae_mlp",
                                  topk: int = 32, topk_approx: bool = False,
                                  jumprelu_bandwidth: float = 1e-3,
                                  matryoshka_prefixes: tuple = (0.0625, 0.25, 1.0),
                                  aux_k: int = 0, aux_alpha: float = 0.03125):
    """The data-parallel train step ``step(ts, act_local) -> (ts, metrics)`` for
    every variant of the single-device cached step, on ``mesh``'s 'data' axis
    (module docstring): ``ts`` replicated (put_replicated_state), ``act_local``
    the rank's [T/d, C] token rows (put_tokens_sharded). The arguments are
    train/steps.make_sae_train_step_from_acts'; ``fused=False`` runs the
    stock math on each shard. This is where the step gets its DataSync."""
    if mesh.size("model") > 1:
        raise ValueError(f"data-parallel step on mesh {mesh.shape}: a 'model' axis trains "
                         "through parallel/tensor_parallel.make_tp_fused_train_step")
    return make_sae_train_step_from_acts(
        sae_model_name, lambda_sparse, tx, dead_neurons_steps, expansion_factor, fused=fused,
        fused_opts=fused_opts, topk=topk, topk_approx=topk_approx,
        jumprelu_bandwidth=jumprelu_bandwidth, matryoshka_prefixes=matryoshka_prefixes,
        aux_k=aux_k, aux_alpha=aux_alpha, sync=DataSync(mesh))


def _broadcast_tree(tree, mesh):
    """``tree``'s tensors overwritten by rank 0's (one broadcast each)."""
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.bool:
        return mesh.broadcast_(tree.to(torch.uint8)) != 0
    if isinstance(tree, torch.Tensor):
        return mesh.broadcast_(tree.clone())
    if isinstance(tree, dict):
        return {k: _broadcast_tree(v, mesh) for k, v in tree.items()}
    return tree


def put_replicated_state(mesh, ts: SAETrainState) -> SAETrainState:
    """The train state replicated: rank 0's params, Adam moments and dead
    accumulator broadcast to every rank (the step count and the generator's
    seed are alike on every rank already)."""
    return ts._replace(params=_broadcast_tree(ts.params, mesh),
                       opt_state=_broadcast_tree(ts.opt_state, mesh),
                       dead_acc=_broadcast_tree(ts.dead_acc, mesh))


def put_tokens_sharded(mesh, acts: torch.Tensor, token_axis: int = 0) -> torch.Tensor:
    """This rank's token rows of ``acts`` along ``token_axis`` (1 for stacked
    [K, T, C] steps): the data index's contiguous 1/d of them, a view. The
    TP step takes its tokens so too (whole rows on every rank of a data
    index: the JAX package's put_tokens_tp)."""
    n = mesh.size("data")
    t = acts.shape[token_axis]
    if t % n:
        raise ValueError(f"token count {t} not divisible by data={n}")
    return acts.narrow(token_axis, mesh.index("data") * (t // n), t // n)

