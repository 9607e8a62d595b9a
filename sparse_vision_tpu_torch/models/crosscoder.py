"""Crosscoder: one sparse latent space shared across several layers (port of
sparse_vision_tpu/models/crosscoder.py; Lindsey et al. 2024, "Sparse
Crosscoders for Cross-Layer Features and Model Diffing").

    z    = ReLU( Σ_l x_l W_enc^l + b_enc )          z: [T, h]
    y_l  = z W_dec^l + b_dec^l                       per layer
    loss = Σ_l MSE(y_l, x_l) + λ · mean_T Σ_j z_j n_j / h
    n_j  = Σ_l ‖W_dec^l[j]‖₂   (per-latent decoder-norm weight)

The per-layer decoder-norm profile is the model-diffing readout
(crosscoder_decoder_norms), so crosscoders train with plain Adam: ConstrainedAdam's
unit-norm decoder rows would erase it (train/crosscoder.py rejects it).

Parameters stay flat (``W_enc_i [d_i, h]``, ``b_enc [h]``, ``W_dec_i [h, d_i]``,
``b_dec_i [d_i]``), the JAX package's layout, so convert.sae_params_from_jax
carries them over unchanged. All layers share the token geometry (the same
spatial dims).
"""

from __future__ import annotations

import torch

from sparse_vision_tpu_torch.models.sae import act_from_tokens, kaiming_uniform, tokens_from_act


def crosscoder_num_layers(params: dict) -> int:
    return sum(1 for k in params if k.startswith("W_enc_"))


def init_crosscoder(generator: torch.Generator, dims: tuple, expansion_factor: int) -> dict:
    """Flat parameters for ``len(dims)`` layers, f32 on the generator's device.
    h = dims[0]·expansion_factor (the anchor layer sets the dictionary size).
    Per layer, in order: the encoder's Kaiming draw [h, d] scaled by 1/L, then
    the decoder's [d, h], its rows (latents) normalized to 1/L."""
    h = int(dims[0] * expansion_factor)
    n = len(dims)
    params = {"b_enc": torch.zeros((h,), device=generator.device)}
    for i, d in enumerate(dims):
        w_enc = kaiming_uniform(generator, (h, d), fan_in=d).T.contiguous()
        w_dec = kaiming_uniform(generator, (d, h), fan_in=h).T.contiguous()
        w_dec = w_dec / torch.linalg.vector_norm(w_dec, dim=1, keepdim=True) / n
        params[f"W_enc_{i}"] = w_enc / n
        params[f"W_dec_{i}"] = w_dec
        params[f"b_dec_{i}"] = torch.zeros((d,), device=generator.device)
    return params


def crosscoder_apply(params: dict, xs: tuple):
    """(encoded [T, h], decoded tuple of [T, d_l], pre [T, h]) on per-layer token
    inputs: one ReLU code from the sum of the layers' encoder projections."""
    n = crosscoder_num_layers(params)
    if len(xs) != n:
        raise ValueError(f"crosscoder with {n} layers got {len(xs)} inputs")
    pre = params["b_enc"]
    for i, x in enumerate(xs):
        pre = pre + x @ params[f"W_enc_{i}"]
    z = torch.relu(pre)
    return z, tuple(z @ params[f"W_dec_{i}"] + params[f"b_dec_{i}"] for i in range(n)), pre


def crosscoder_decoder_norms(params: dict) -> torch.Tensor:
    """Per-layer per-latent decoder row norms [L, h]: row l says how much latent
    j writes into layer l."""
    n = crosscoder_num_layers(params)
    return torch.stack([torch.linalg.vector_norm(params[f"W_dec_{i}"], dim=1)
                        for i in range(n)])


def crosscoder_loss_terms(params: dict, encoded: torch.Tensor, decoded: tuple,
                          targets: tuple, lambda_sparse: float) -> dict:
    """Summed per-layer MSE + decoder-norm-weighted L1; RMSE/NRMSE on the anchor
    layer."""
    from sparse_vision_tpu_torch.ops import losses

    rec = sum(torch.square(y - t).mean() for y, t in zip(decoded, targets))
    weight = crosscoder_decoder_norms(params).sum(0)  # n_j
    l1 = (encoded * weight[None, :]).mean()
    rmse, nrmse = losses.rmse_nrmse(decoded[0], targets[0])
    return {
        "loss": rec + lambda_sparse * l1,
        "rec_loss": rec,
        "l1_loss": l1,
        "nrmse_loss": nrmse,
        "rmse_loss": rmse,
        "aux_loss": torch.zeros((), dtype=encoded.dtype, device=encoded.device),
    }


def crosscoder_inference_and_loss(params: dict, acts: tuple, lambda_sparse: float) -> dict:
    """Per-layer taps -> tokens -> shared code -> per-layer reconstructions and
    loss terms. ``encoded``/``encoded_pre`` take the anchor layer's layout;
    ``decoded`` is the per-layer tuple in tap order."""
    toks = []
    for i, act in enumerate(acts):
        tok, _ = tokens_from_act(act)
        if toks and tok.shape[0] != toks[0].shape[0]:
            raise ValueError(
                f"Crosscoder taps disagree on token count: layer 0 {tuple(acts[0].shape)}"
                f" -> {toks[0].shape[0]} tokens, layer {i} {tuple(act.shape)} -> "
                f"{tok.shape[0]} tokens (all layers must share spatial dims)")
        toks.append(tok)
    encoded, decoded, pre = crosscoder_apply(params, tuple(toks))
    terms = crosscoder_loss_terms(params, encoded, decoded, tuple(toks), lambda_sparse)
    if acts[0].ndim > 2:
        encoded = act_from_tokens(encoded, acts[0].shape)
        pre = act_from_tokens(pre, acts[0].shape)
        decoded = tuple(act_from_tokens(y, a.shape) for y, a in zip(decoded, acts))
    terms.update(encoded=encoded, encoded_pre=pre, decoded=decoded)
    return terms
