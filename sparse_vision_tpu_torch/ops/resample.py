"""Dead-neuron resampling and its schedule (port of
sparse_vision_tpu/ops/resample.py: the sae_mlp surgery, which the transcoder's
rectangular decoder reuses, the crosscoder's, and the latent-sharded form of
each for the tensor-parallel steps).

Reference semantics (sae_mlp.py:79-184 reset_encoder_weights +
model_pipeline.py:771-794): with n = dead_neurons_steps and i = the 1-based train
step, resample at i = 2n+1, 4n+1, ...; reset the dead-neuron measurement without
resampling at i = n, 3n, 5n, ... So the SAE alternates n measured steps ->
resample -> n burn-in steps -> ...

The step counter is a host integer here, so the schedule is plain Python. The
Kaiming draws of a resample are arguments: the train step makes them with a
torch.Generator on the device, and tests hand in the JAX package's draws.
"""

from __future__ import annotations

import torch

from sparse_vision_tpu_torch.models.sae import kaiming_uniform


def should_resample(step: int, dead_neurons_steps: int) -> bool:
    """1-based train step i: true at i = 2n+1, 4n+1, ... (model_pipeline.py:771-775)."""
    i, n = step, dead_neurons_steps
    return (i - 1) % n == 0 and ((i - 1) // n) % 2 == 0 and i - 1 != 0


def should_reset_measurement(step: int, dead_neurons_steps: int) -> bool:
    """True at i = n, 3n, 5n, ... (model_pipeline.py:786-788)."""
    i, n = step, dead_neurons_steps
    return i == n or (i > n and i % n == 0 and (i // n) % 2 == 1)


def kaiming_draws(generator: torch.Generator, d: int, h: int, d_out: int):
    """The two draws of one resample: encoder rows in torch layout [h, d] (fan_in d)
    and decoder entries in torch layout [d_out, h] (fan_in h)."""
    enc = kaiming_uniform(generator, (h, d), fan_in=d)
    dec = kaiming_uniform(generator, (d_out, h), fan_in=h)
    return enc, dec


def resample_dead_neurons(params: dict, opt_state: dict, dead_mask: torch.Tensor,
                          enc_draw: torch.Tensor, dec_draw: torch.Tensor):
    """Re-initialize the dead latents of an sae_mlp and zero their Adam moments.

    Faithful to reference sae_mlp.py:103-176, quirks included:
    - new encoder rows: ``enc_draw`` [h, d], row-normalized to the mean L2 norm of
      the LIVE encoder rows (torch rows [h, d] are our W_enc columns [d, h]);
    - new decoder entries: ``dec_draw`` [d_out, h] with its rows normalized to the
      mean over act dims of ``norm(W_dec[:, live], dim=1)`` (the reference norms
      the act-axis rows ACROSS live latents, sae_mlp.py:118-120); dead columns are
      spliced in and ALL directions renormalized to unit norm;
    - b_enc[dead] = mean(|b_enc[live]|);
    - Adam mu / nu slices of dead latents are zeroed for W_enc, b_enc, W_dec; the
      step count is kept.
    With no live latents the norms fall back to 1. Returns (params, opt_state),
    both new dicts."""
    w_enc, b_enc, w_dec = params["W_enc"], params["b_enc"], params["W_dec"]
    live = ~dead_mask
    any_live = live.any()  # stays on the device: no host sync
    n_live = live.sum().clamp(min=1)
    zero = torch.zeros((), dtype=w_enc.dtype, device=w_enc.device)
    one = torch.ones((), dtype=w_enc.dtype, device=w_enc.device)

    enc_norms = torch.linalg.vector_norm(w_enc, dim=0)  # [h]
    avg_l2_enc = torch.where(any_live, torch.where(live, enc_norms, zero).sum() / n_live, one)
    new_enc_t = enc_draw / torch.linalg.vector_norm(enc_draw, dim=1, keepdim=True) * avg_l2_enc
    new_w_enc = torch.where(dead_mask[None, :], new_enc_t.T, w_enc)

    avg_abs_b = torch.where(any_live, torch.where(live, b_enc.abs(), zero).sum() / n_live, zero)
    new_b_enc = torch.where(dead_mask, avg_abs_b, b_enc)

    dec_live = torch.where(live[:, None], w_dec, zero)  # [h, d_out]
    quirk_norms = torch.linalg.vector_norm(dec_live, dim=0)  # [d_out]
    avg_l2_dec = torch.where(any_live, quirk_norms.mean(), one)
    new_dec_t = dec_draw / torch.linalg.vector_norm(dec_draw, dim=1, keepdim=True) * avg_l2_dec
    new_w_dec = torch.where(dead_mask[:, None], new_dec_t.T, w_dec)
    new_w_dec = new_w_dec / torch.linalg.vector_norm(new_w_dec, dim=1, keepdim=True)

    new_params = dict(params)
    new_params.update(W_enc=new_w_enc, b_enc=new_b_enc, W_dec=new_w_dec)
    return new_params, _zero_dead_moments(opt_state, dead_mask)


def resample_dead_neurons_tp(params: dict, opt_state: dict, dead_mask: torch.Tensor,
                             enc_draw: torch.Tensor, dec_draw: torch.Tensor, mesh):
    """resample_dead_neurons on a latent shard of ``mesh`` (port of the JAX
    package's resample_dead_neurons_tp): ``params``, ``opt_state`` and
    ``dead_mask`` [h/m] are the rank's shard, ``enc_draw`` [h, d] and
    ``dec_draw`` [d_out, h] the FULL global draws, made alike on every rank
    (kaiming_draws from a generator seeded the same everywhere). The decoder
    draw's rows are normalized across the whole latent axis, a global
    operation, so each rank normalizes the full draws and slices its own
    latents; the live-latent statistics (counts, mean norms, mean |b_enc| and
    the decoder's per-act-dim quirk norms) are psummed over 'model' in one
    all_reduce. With the same draws and dead mask this is the single-device
    surgery on each shard, up to the order of the sums."""
    w_enc, b_enc, w_dec = params["W_enc"], params["b_enc"], params["W_dec"]
    h_l = b_enc.shape[0]
    live = ~dead_mask
    zero = torch.zeros((), dtype=w_enc.dtype, device=w_enc.device)
    one = torch.ones((), dtype=w_enc.dtype, device=w_enc.device)
    dec_live = torch.where(live[:, None], w_dec, zero)  # [h_l, d_out]
    n_live, sum_enc, sum_b, quirk_sq = mesh.psum_many([
        live.sum().to(w_enc.dtype),
        torch.where(live, torch.linalg.vector_norm(w_enc, dim=0), zero).sum(),
        torch.where(live, b_enc.abs(), zero).sum(),
        dec_live.square().sum(0)], "model")
    any_live = n_live > 0
    n_live = n_live.clamp(min=1)
    lo = mesh.index("model") * h_l

    avg_l2_enc = torch.where(any_live, sum_enc / n_live, one)
    new_enc_t = enc_draw / torch.linalg.vector_norm(enc_draw, dim=1, keepdim=True) * avg_l2_enc
    new_w_enc = torch.where(dead_mask[None, :], new_enc_t[lo:lo + h_l].T, w_enc)

    new_b_enc = torch.where(dead_mask, torch.where(any_live, sum_b / n_live, zero), b_enc)

    avg_l2_dec = torch.where(any_live, quirk_sq.sqrt().mean(), one)
    new_dec_t = dec_draw / torch.linalg.vector_norm(dec_draw, dim=1, keepdim=True) * avg_l2_dec
    new_w_dec = torch.where(dead_mask[:, None], new_dec_t[:, lo:lo + h_l].T, w_dec)
    new_w_dec = new_w_dec / torch.linalg.vector_norm(new_w_dec, dim=1, keepdim=True)

    new_params = dict(params)
    new_params.update(W_enc=new_w_enc, b_enc=new_b_enc, W_dec=new_w_dec)
    return new_params, _zero_dead_moments(opt_state, dead_mask)


def _zero_dead_moments(opt_state: dict, dead_mask: torch.Tensor) -> dict:
    """Adam mu / nu of the dead latents zeroed in every encoder weight (``W_enc``,
    ``W_enc_i``: columns), decoder weight (``W_dec``, ``W_dec_i``: rows) and
    ``b_enc``; the step count is kept."""
    def zero_dead(m: dict) -> dict:
        out = dict(m)
        for k, v in m.items():
            if k.startswith("W_enc"):
                out[k] = torch.where(dead_mask[None, :], 0.0, v)
            elif k.startswith("W_dec"):
                out[k] = torch.where(dead_mask[:, None], 0.0, v)
            elif k == "b_enc":
                out[k] = torch.where(dead_mask, 0.0, v)
        return out

    return {**opt_state, "mu": zero_dead(opt_state["mu"]), "nu": zero_dead(opt_state["nu"])}


def crosscoder_kaiming_draws(generator: torch.Generator, dims: tuple, h: int) -> list:
    """The draws of one crosscoder resample, per layer in order: encoder rows
    [h, d_l] (fan_in d_l) and decoder columns [d_l, h] (fan_in h)."""
    return [kaiming_draws(generator, d, h, d) for d in dims]


def resample_dead_neurons_crosscoder(params: dict, opt_state: dict, dead_mask: torch.Tensor,
                                     draws: list):
    """Dead-latent surgery for the crosscoder's flat layout (models/crosscoder.py),
    ``draws`` as crosscoder_kaiming_draws gives them. Per layer the sae_mlp
    recipe applies to that layer's slices, with the JAX package's two
    differences: dead decoder rows are drawn at the LIVE rows' mean norm of that
    layer, and there is no final unit renormalization (decoder norms are free
    parameters that carry the per-layer signal and weight the L1 term).
    b_enc[dead] = mean(|b_enc[live]|); Adam moments of every dead slice are
    zeroed. Returns (params, opt_state), both new dicts."""
    live = ~dead_mask
    any_live = live.any()  # stays on the device: no host sync
    n_live = live.sum().clamp(min=1)
    b_enc = params["b_enc"]
    zero = torch.zeros((), dtype=b_enc.dtype, device=b_enc.device)
    one = torch.ones((), dtype=b_enc.dtype, device=b_enc.device)

    def live_mean(v):
        return torch.where(live, v, zero).sum() / n_live

    new_params = dict(params)
    new_params["b_enc"] = torch.where(dead_mask, torch.where(any_live, live_mean(b_enc.abs()),
                                                             zero), b_enc)
    for i, (enc_draw, dec_draw) in enumerate(draws):
        w_enc, w_dec = params[f"W_enc_{i}"], params[f"W_dec_{i}"]
        avg_enc = torch.where(any_live, live_mean(torch.linalg.vector_norm(w_enc, dim=0)), one)
        new_enc_t = enc_draw / torch.linalg.vector_norm(enc_draw, dim=1, keepdim=True) * avg_enc
        new_params[f"W_enc_{i}"] = torch.where(dead_mask[None, :], new_enc_t.T, w_enc)
        avg_dec = torch.where(any_live, live_mean(torch.linalg.vector_norm(w_dec, dim=1)), one)
        new_dec_t = dec_draw / torch.linalg.vector_norm(dec_draw, dim=0, keepdim=True) * avg_dec
        new_params[f"W_dec_{i}"] = torch.where(dead_mask[:, None], new_dec_t.T, w_dec)
    return new_params, _zero_dead_moments(opt_state, dead_mask)


def resample_dead_neurons_crosscoder_tp(params: dict, opt_state: dict, dead_mask: torch.Tensor,
                                        draws: list, mesh):
    """resample_dead_neurons_crosscoder on a latent shard of ``mesh`` (port of
    the JAX package's resample_dead_neurons_crosscoder_tp): ``params``,
    ``opt_state`` and ``dead_mask`` [h/m] are the rank's shard, ``draws`` the
    FULL global per-layer draws (crosscoder_kaiming_draws at h, alike on every
    rank). Each rank normalizes the whole draws (their per-latent norms slice
    cleanly) and keeps its own latents; the live statistics (the count, Σ|b_enc|
    and each layer's Σ encoder and decoder norms over the live latents) are
    psummed over 'model' in one all_reduce. No unit renormalization, as the
    single-device surgery."""
    b_enc = params["b_enc"]
    h_l = b_enc.shape[0]
    live = ~dead_mask
    zero = torch.zeros((), dtype=b_enc.dtype, device=b_enc.device)
    one = torch.ones((), dtype=b_enc.dtype, device=b_enc.device)

    def live_sum(v):
        return torch.where(live, v, zero).sum()

    n_layers = len(draws)
    sums = [live.sum().to(b_enc.dtype), live_sum(b_enc.abs())]
    for i in range(n_layers):
        sums += [live_sum(torch.linalg.vector_norm(params[f"W_enc_{i}"], dim=0)),
                 live_sum(torch.linalg.vector_norm(params[f"W_dec_{i}"], dim=1))]
    n_live, sum_b, *layer_sums = mesh.psum_many(sums, "model")
    any_live = n_live > 0
    n_live = n_live.clamp(min=1)
    lo = mesh.index("model") * h_l

    new_params = dict(params)
    new_params["b_enc"] = torch.where(dead_mask, torch.where(any_live, sum_b / n_live, zero),
                                      b_enc)
    for i, (enc_draw, dec_draw) in enumerate(draws):
        w_enc, w_dec = params[f"W_enc_{i}"], params[f"W_dec_{i}"]
        avg_enc = torch.where(any_live, layer_sums[2 * i] / n_live, one)
        new_enc_t = enc_draw / torch.linalg.vector_norm(enc_draw, dim=1, keepdim=True) * avg_enc
        new_params[f"W_enc_{i}"] = torch.where(dead_mask[None, :], new_enc_t[lo:lo + h_l].T,
                                               w_enc)
        avg_dec = torch.where(any_live, layer_sums[2 * i + 1] / n_live, one)
        new_dec_t = dec_draw / torch.linalg.vector_norm(dec_draw, dim=0, keepdim=True) * avg_dec
        new_params[f"W_dec_{i}"] = torch.where(dead_mask[:, None], new_dec_t[:, lo:lo + h_l].T,
                                               w_dec)
    return new_params, _zero_dead_moments(opt_state, dead_mask)
