"""ReLU-MLP sparse autoencoder as functions over a parameter dict (port of the
sae_mlp subset of sparse_vision_tpu/models/sae.py).

Parameter layout (math convention, not torch's transposed nn.Linear storage):
  W_enc [d, h]   encode: pre = (x - b_dec) @ W_enc + b_enc
  W_dec [h, d]   decode: recon = relu(pre) @ W_dec + b_dec; row j of W_dec is
                 latent j's direction, initialized and kept at unit norm.

Token convention: NHWC feature maps [B, H, W, C] flatten to [B*H*W, C] tokens in
(b, h, w) order, as in the JAX package.
"""

from __future__ import annotations

import torch

from sparse_vision_tpu_torch.ops import losses


def kaiming_uniform(generator: torch.Generator, shape: tuple, fan_in: int) -> torch.Tensor:
    """torch.nn.init.kaiming_uniform_ default (a=0, fan_in, leaky_relu):
    U(-sqrt(6/fan_in), sqrt(6/fan_in)), f32 on the generator's device."""
    bound = (6.0 / fan_in) ** 0.5
    return torch.empty(shape, device=generator.device).uniform_(
        -bound, bound, generator=generator)


def _unit_rows(w: torch.Tensor) -> torch.Tensor:
    return w / torch.linalg.vector_norm(w, dim=-1, keepdim=True)


def init_sae_mlp(generator: torch.Generator, d: int, expansion_factor: int) -> dict:
    """Kaiming-uniform encoder, zero biases, unit-norm decoder rows (reference
    sae_mlp.py:26-40), f32 on the generator's device."""
    h = int(d * expansion_factor)
    device = generator.device
    # torch encoder weight is [h, d] with fan_in=d; ours is its transpose
    w_enc = kaiming_uniform(generator, (h, d), fan_in=d).T.contiguous()
    # torch decoder weight is [d, h] with fan_in=h, column-normalized; ours is its transpose
    w_dec = _unit_rows(kaiming_uniform(generator, (d, h), fan_in=h).T.contiguous())
    return {
        "W_enc": w_enc,
        "b_enc": torch.zeros((h,), device=device),
        "W_dec": w_dec,
        "b_dec": torch.zeros((d,), device=device),
    }


def sae_mlp_apply(params: dict, x: torch.Tensor):
    """Returns (encoded, decoded, pre_relu) on token input [T, d]."""
    x_cent = x - params["b_dec"]
    pre = x_cent @ params["W_enc"] + params["b_enc"]
    post = torch.relu(pre)
    recon = post @ params["W_dec"] + params["b_dec"]
    return post, recon, pre


def tokens_from_act(act: torch.Tensor):
    """[B, H, W, C] -> [B*H*W, C] tokens; 3-D [B, N, D] flattens the same way.
    Returns (tokens, transformed)."""
    if act.ndim in (3, 4):
        return act.reshape(-1, act.shape[-1]), True
    return act, False


def act_from_tokens(tok: torch.Tensor, like_shape: tuple) -> torch.Tensor:
    return tok.reshape(*like_shape[:-1], tok.shape[-1])


def sae_inference_and_loss(sae_model_name: str, params: dict, act: torch.Tensor,
                           lambda_sparse: float) -> dict:
    """Reshape taps to tokens, run the SAE, compute every loss term, reshape the
    outputs back. Returns the loss terms plus 'encoded', 'encoded_pre' and
    'decoded' (NHWC when the input was 4-D)."""
    if sae_model_name != "sae_mlp":
        raise NotImplementedError(f"SAE {sae_model_name!r} is not ported (sae_mlp)")
    tok, transformed = tokens_from_act(act)
    encoded, decoded, pre = sae_mlp_apply(params, tok)
    terms = losses.sae_loss_terms(encoded, decoded, tok, lambda_sparse)
    if transformed:
        encoded = act_from_tokens(encoded, act.shape)
        decoded = act_from_tokens(decoded, act.shape)
        pre = act_from_tokens(pre, act.shape)
    terms.update(encoded=encoded, encoded_pre=pre, decoded=decoded)
    return terms


def sae_encode(sae_model_name: str, params: dict, tok: torch.Tensor) -> torch.Tensor:
    """Post-activation encoder output on token input [T, d]."""
    if sae_model_name != "sae_mlp":
        raise NotImplementedError(f"SAE {sae_model_name!r} is not ported (sae_mlp)")
    return sae_mlp_apply(params, tok)[0]


def sae_decode(sae_model_name: str, params: dict, encoded: torch.Tensor) -> torch.Tensor:
    """Decoder applied to a (possibly ablated) encoder output."""
    if sae_model_name != "sae_mlp":
        raise NotImplementedError(f"SAE {sae_model_name!r} is not ported (sae_mlp)")
    return encoded @ params["W_dec"] + params["b_dec"]
