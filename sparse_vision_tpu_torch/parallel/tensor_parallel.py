"""Tensor-parallel SAE training over a (data, model) mesh (port of the fused
engine of sparse_vision_tpu/parallel/tensor_parallel.py).

The latent axis shards over 'model', the tokens over 'data'. Each rank runs the
variant's TP op on its shard: sae_mlp, gated_sae, jumprelu_sae and
matryoshka_sae on ops/fused_sae_tp.py (the single-device fused bodies, PERF.md
rows 1-2, 6-7, 4-5 and 8-9, with partial reconstructions psummed over
'model' before the MSE and latent-local gradients psummed over 'data'), and
topk_sae on ops/fast_topk_sae.py's two-stage selection (no kernel: JAX's op is
stock XLA). The op's gradients are global, so the update applies them as they
are: Adam's moments follow their parameters, and ConstrainedAdam's
renormalization is row-local on W_dec [H/m, C]. sae_mlp resamples with
resample_dead_neurons_tp (every rank draws the full global matrices from the
replicated generator and keeps its latents; the live statistics psum over
'model').

The dead accumulator follows the SINGLE-DEVICE step (ROADMAP C1): the
variants that do not resample (all but sae_mlp) restart it every
dead_neurons_steps steps (the rolling window of train/steps.make_update),
where the JAX package's TP step resets it only when it can resample.
perc_dead is psum_model(Σ dead_acc) / H.

The transcoder and the crosscoder build their TP steps in train/transcoder.py
and train/crosscoder.py from the same parts: ModelSync, put_tp_state /
gather_tp_state (the crosscoder's W_enc_i / W_dec_i shard like W_enc / W_dec,
each b_dec_i is replicated) and, for the transcoder, resample_sae_tp.

JAX's second engine, the GSPMD placement of the stock step for any variant,
has no counterpart here (train/pipeline.validate_mesh_mode refuses what it
would run).

Layouts (parallel/mesh.param_axes, JAX's sae_param_sharding):
  W_enc, W_gate [C, H]: axis 1      b_enc, b_gate, b_mag, r_mag,
  W_dec [H, C]: axis 0                log_threshold [H]: axis 0
  b_dec [C]: replicated
  Adam mu / nu follow their params, count is replicated; dead_acc [H]: axis 0;
  step and the generator replicated.
"""

from __future__ import annotations

import functools

import torch

from sparse_vision_tpu_torch.models.sae import DEFAULT_MATRYOSHKA_PREFIXES
from sparse_vision_tpu_torch.ops.fast_topk_sae import fast_topk_sae_tp_loss_terms
from sparse_vision_tpu_torch.ops.fused_sae_tp import (
    fused_gated_sae_tp_loss_terms,
    fused_jumprelu_sae_tp_loss_terms,
    fused_matryoshka_sae_tp_loss_terms,
    fused_sae_tp_loss_terms,
)
from sparse_vision_tpu_torch.ops.resample import kaiming_draws, resample_dead_neurons_tp
from sparse_vision_tpu_torch.parallel.mesh import gather_params, param_axes, shard_params
from sparse_vision_tpu_torch.train.steps import LocalSync, SAETrainState, make_train_step

TP_VARIANTS = ("sae_mlp", "gated_sae", "jumprelu_sae", "matryoshka_sae", "topk_sae")


class ModelSync(LocalSync):
    """train/steps.make_update's reductions for the TP step: the op's
    gradients, dead mask and loss scalars are global already (LocalSync's
    identities); the dead fraction sums the latent shards' accumulators over
    'model'."""

    def __init__(self, mesh):
        self.mesh = mesh

    def dead_fraction(self, dead_acc: torch.Tensor) -> torch.Tensor:
        n_dead = self.mesh.psum(dead_acc.sum().float(), "model")
        return n_dead / (dead_acc.shape[0] * self.mesh.size("model"))


def sae_opt_state_sharding(opt_state: dict, axes: dict) -> dict:
    """The latent axis of each leaf of an optimizer state: Adam's mu and nu
    follow their parameters' ``axes`` (param_axes), everything else (the
    count) is replicated (None)."""
    return {k: dict(axes) if k in ("mu", "nu") else None for k in opt_state}


def _shard_tree(tree, axes, mesh):
    if isinstance(tree, dict):
        return {k: _shard_tree(v, None if axes is None else axes[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.clone() if axes is None else mesh.shard(tree, axes)
    return tree


def _gather_tree(tree, axes, mesh):
    if isinstance(tree, dict):
        return {k: _gather_tree(v, None if axes is None else axes[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.clone() if axes is None else mesh.gather(tree, axes)
    return tree


def put_tp_state(mesh, ts: SAETrainState) -> SAETrainState:
    """This rank's shard of a full train state: the params, Adam's moments and
    the dead accumulator sliced on the latent axis; step and generator as
    they are (alike on every rank)."""
    if mesh.size("model") == 1:
        raise ValueError(f"mesh {mesh.shape} has no 'model' axis")
    axes = param_axes(ts.params)
    return ts._replace(params=shard_params(ts.params, mesh),
                       opt_state=_shard_tree(ts.opt_state,
                                             sae_opt_state_sharding(ts.opt_state, axes), mesh),
                       dead_acc=mesh.shard(ts.dead_acc, 0))


def gather_tp_state(mesh, ts: SAETrainState) -> SAETrainState:
    """The full train state from every rank's shard (a collective: every rank
    calls it and gets the whole state)."""
    axes = param_axes(ts.params)
    return ts._replace(params=gather_params(ts.params, mesh),
                       opt_state=_gather_tree(ts.opt_state,
                                              sae_opt_state_sharding(ts.opt_state, axes), mesh),
                       dead_acc=mesh.gather(ts.dead_acc, 0))


def resample_sae_tp(params: dict, opt_state: dict, dead: torch.Tensor,
                    rng: torch.Generator, draws=None, *, mesh):
    """resample_dead_neurons_tp with the full global Kaiming draws from ``rng``
    (seeded alike on every rank) unless ``draws`` = (enc [H, C], dec [C_out,
    H]) is given (tests hand in the JAX package's)."""
    if draws is None:
        d, h_l = params["W_enc"].shape
        draws = kaiming_draws(rng, d, h_l * mesh.size("model"), params["W_dec"].shape[1])
    return resample_dead_neurons_tp(params, opt_state, dead, *draws, mesh)


def make_tp_fused_train_step(mesh, lambda_sparse: float, tx, dead_neurons_steps: int,
                             expansion_factor: int, fused_opts: dict | None = None,
                             sae_model_name: str = "sae_mlp",
                             matryoshka_prefixes: tuple = DEFAULT_MATRYOSHKA_PREFIXES,
                             topk: int = 32, topk_approx: bool = False):
    """The tensor-parallel fused train step ``step(ts, act_local,
    resample_draws=None) -> (ts, metrics)`` (module docstring): ``ts`` the
    rank's shard (put_tp_state), ``act_local`` its [T/d, C] token rows
    (parallel/sharded_steps.put_tokens_sharded). ``fused_opts`` may set
    ``compute_dtype``, and ``bandwidth`` for jumprelu_sae;
    ``matryoshka_prefixes`` are matryoshka_sae's GLOBAL dictionary fractions,
    ``topk`` / ``topk_approx`` topk_sae's k and selection flag. The metrics are
    global and alike on every rank. JAX's ``ts_placed`` argument, whose
    shardings give its shard_map specs, has no counterpart: the layouts are
    fixed (parallel/mesh.param_axes)."""
    if sae_model_name not in TP_VARIANTS:
        raise ValueError(f"TP fused step supports {TP_VARIANTS}, not {sae_model_name!r}")
    terms = {"sae_mlp": fused_sae_tp_loss_terms,
             "gated_sae": fused_gated_sae_tp_loss_terms,
             "jumprelu_sae": fused_jumprelu_sae_tp_loss_terms,
             "matryoshka_sae": functools.partial(fused_matryoshka_sae_tp_loss_terms,
                                                 prefixes=tuple(matryoshka_prefixes)),
             "topk_sae": functools.partial(fast_topk_sae_tp_loss_terms, k=topk,
                                           approx=topk_approx)}[sae_model_name]
    opts = dict(fused_opts or {})

    def loss_fn(params, act):
        return terms(params, act, lambda_sparse, expansion_factor, mesh, **opts)

    resample = functools.partial(resample_sae_tp, mesh=mesh) \
        if sae_model_name == "sae_mlp" else None
    return make_train_step(loss_fn, tx, dead_neurons_steps, expansion_factor, True,
                           resample=resample, sync=ModelSync(mesh))
