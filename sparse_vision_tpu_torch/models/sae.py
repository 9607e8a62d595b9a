"""Sparse autoencoders as functions over a parameter dict (port of the sae_mlp,
gated_sae, jumprelu_sae, matryoshka_sae and transcoder parts of
sparse_vision_tpu/models/sae.py).

Parameter layout (math convention, not torch's transposed nn.Linear storage):
  W_enc [d, h]   encode: pre = (x - b_dec) @ W_enc + b_enc
  W_dec [h, d]   decode: recon = relu(pre) @ W_dec + b_dec; row j of W_dec is
                 latent j's direction, initialized and kept at unit norm.
Gated SAE (Rajamanoharan et al.): W_gate [d, h] with b_gate, b_mag, r_mag [h];
the magnitude path shares the gate weights, W_mag = W_gate * exp(r_mag).
JumpReLU SAE (Rajamanoharan et al. 2024): the ReLU layout plus a per-latent
log_threshold [h], trained through straight-through estimators.
Matryoshka SAE (Bussmann et al. 2024): the ReLU layout; the nesting lives in
the loss, which averages the reconstruction error of nested latent prefixes.
Transcoder (Dunefsky et al. 2024): the ReLU layout with W_dec [h, d_out] into
another layer's space and no input centring (b_dec is an output-space bias).

Token convention: NHWC feature maps [B, H, W, C] flatten to [B*H*W, C] tokens in
(b, h, w) order, as in the JAX package.
"""

from __future__ import annotations

import torch

from sparse_vision_tpu_torch.ops import losses

# STE bandwidth ε, the paper's default: sized for normalized activations; raw
# vision activations need it scaled to their spread (RunConfig.jumprelu_bandwidth)
JUMPRELU_BANDWIDTH = 1e-3
# prefix fractions of the dictionary (RunConfig.sae_matryoshka_prefixes)
DEFAULT_MATRYOSHKA_PREFIXES = (0.0625, 0.25, 1.0)
PORTED = ("sae_mlp", "gated_sae", "jumprelu_sae", "matryoshka_sae")


def _not_ported(name: str) -> NotImplementedError:
    return NotImplementedError(f"SAE {name!r} is not ported {PORTED}")


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


# ---------------------------------------------------------------------------
# Gated SAE
# ---------------------------------------------------------------------------

def init_gated_sae(generator: torch.Generator, d: int, expansion_factor: int) -> dict:
    """Kaiming W_gate, zero b_gate/b_mag/r_mag, unit-norm decoder rows
    (reference gated_sae.py:8-30)."""
    h = int(d * expansion_factor)
    device = generator.device
    w_gate = kaiming_uniform(generator, (h, d), fan_in=d).T.contiguous()
    w_dec = _unit_rows(kaiming_uniform(generator, (d, h), fan_in=h).T.contiguous())
    return {
        "W_gate": w_gate,
        "b_gate": torch.zeros((h,), device=device),
        "b_mag": torch.zeros((h,), device=device),
        "r_mag": torch.zeros((h,), device=device),
        "W_dec": w_dec,
        "b_dec": torch.zeros((d,), device=device),
    }


def heaviside_gate(pi_gate: torch.Tensor) -> torch.Tensor:
    """1 / 0.5 / 0 where ``pi_gate`` is > 0 / == 0 / < 0 (reference
    gated_sae.py:39), f32, without a gradient."""
    return torch.where(pi_gate > 0, 1.0, torch.where(pi_gate == 0, 0.5, 0.0))


def gated_sae_apply(params: dict, x: torch.Tensor):
    """Returns (encoded, decoded, relu_pi_gate, via_gate) on token input [T, d]
    (reference gated_sae.py:33-56). ``via_gate`` decodes relu(pi_gate) through a
    detached W_dec and b_dec."""
    x_cent = x - params["b_dec"]
    pi_gate = x_cent @ params["W_gate"] + params["b_gate"]
    f_gate = heaviside_gate(pi_gate).to(x.dtype)
    w_mag = params["W_gate"] * torch.exp(params["r_mag"])[None, :]
    f_mag = torch.relu(x_cent @ w_mag + params["b_mag"])
    encoded = f_gate * f_mag
    decoded = encoded @ params["W_dec"] + params["b_dec"]
    relu_pi_gate = torch.relu(pi_gate)
    via_gate = relu_pi_gate @ params["W_dec"].detach() + params["b_dec"].detach()
    return encoded, decoded, relu_pi_gate, via_gate


# ---------------------------------------------------------------------------
# JumpReLU SAE
# ---------------------------------------------------------------------------

def _in_window(pre, threshold, bandwidth):
    """The STE's rectangle kernel: 1[|pre - θ| <= ε/2], inclusive."""
    return (torch.abs(pre - threshold) <= bandwidth / 2).to(pre.dtype)


def _save_pre_threshold(ctx, inputs, output):
    pre, threshold, bandwidth = inputs
    ctx.save_for_backward(pre, threshold)
    ctx.bandwidth = bandwidth


class JumpReLU(torch.autograd.Function):
    """pre * 1[pre > θ]. Backward (paper eq. 11): d/dpre = 1[pre > θ] exactly;
    d/dθ = -(θ/ε)·1[|pre-θ| <= ε/2], summed over tokens. Written with
    ``setup_context`` and a generated vmap rule, so ``torch.func`` transforms it
    (the circuit passes differentiate through the encoder)."""

    generate_vmap_rule = True
    setup_context = staticmethod(_save_pre_threshold)

    @staticmethod
    def forward(pre, threshold, bandwidth):
        return pre * (pre > threshold)

    @staticmethod
    def backward(ctx, ct):
        pre, threshold = ctx.saved_tensors
        eps = ctx.bandwidth
        win = _in_window(pre, threshold, eps).to(ct.dtype)
        d_pre = ct * (pre > threshold)
        d_thr = (ct * (-threshold / eps) * win).sum(0)
        return d_pre, d_thr, None


class JumpReLUL0(torch.autograd.Function):
    """Mean over tokens of the per-token count 1[pre > θ]. Backward (paper eq.
    12): d/dθ = -Σ_t 1[|pre-θ| <= ε/2] / (ε·T); ``pre`` gets no gradient (the
    L0 penalty moves only the thresholds)."""

    generate_vmap_rule = True
    setup_context = staticmethod(_save_pre_threshold)

    @staticmethod
    def forward(pre, threshold, bandwidth):
        return (pre > threshold).to(pre.dtype).sum(-1).mean()

    @staticmethod
    def backward(ctx, ct):
        pre, threshold = ctx.saved_tensors
        eps = ctx.bandwidth
        win = _in_window(pre, threshold, eps)
        d_thr = ct * (-win / eps).sum(0) / pre.shape[0]
        return torch.zeros_like(pre), d_thr, None


def jumprelu(pre, threshold, bandwidth: float = JUMPRELU_BANDWIDTH):
    return JumpReLU.apply(pre, threshold, bandwidth)


def jumprelu_l0(pre, threshold, bandwidth: float = JUMPRELU_BANDWIDTH):
    return JumpReLUL0.apply(pre, threshold, bandwidth)


def init_jumprelu_sae(generator: torch.Generator, d: int, expansion_factor: int,
                      threshold_init: float = 1e-3) -> dict:
    """The ReLU SAE's layout plus log_threshold = log(threshold_init) per latent
    (the log taken in f32, as the JAX package does)."""
    params = init_sae_mlp(generator, d, expansion_factor)
    h = params["b_enc"].shape[0]
    log_thr = torch.log(torch.tensor(threshold_init, dtype=torch.float32))
    params["log_threshold"] = log_thr.expand(h).clone().to(generator.device)
    return params


def jumprelu_sae_apply(params: dict, x: torch.Tensor,
                       bandwidth: float = JUMPRELU_BANDWIDTH):
    """Returns (encoded, decoded, pre) on token input [T, d]; the thresholds are
    exp(log_threshold) and train through the STE autograd Functions."""
    x_cent = x - params["b_dec"]
    pre = x_cent @ params["W_enc"] + params["b_enc"]
    threshold = torch.exp(params["log_threshold"])
    post = jumprelu(pre, threshold, bandwidth)
    recon = post @ params["W_dec"] + params["b_dec"]
    return post, recon, pre


# ---------------------------------------------------------------------------
# Matryoshka SAE
# ---------------------------------------------------------------------------

def matryoshka_prefix_counts(h: int, fractions: tuple) -> tuple:
    """Latent-prefix sizes from fractions of the dictionary (strictly increasing;
    the last prefix is always the full dictionary)."""
    if not fractions:
        raise ValueError("matryoshka needs at least one prefix fraction")
    counts = []
    for f in fractions:
        if not 0.0 < f <= 1.0:
            raise ValueError(f"prefix fraction {f} outside (0, 1]")
        counts.append(max(1, round(f * h)))
    counts[-1] = h
    if sorted(set(counts)) != counts:
        raise ValueError(f"prefix fractions {fractions} -> non-increasing counts {counts}")
    return tuple(counts)


def init_matryoshka_sae(generator: torch.Generator, d: int, expansion_factor: int) -> dict:
    """The ReLU SAE's parameter layout and init."""
    return init_sae_mlp(generator, d, expansion_factor)


def matryoshka_sae_apply(params: dict, x: torch.Tensor, prefixes: tuple):
    """Returns (encoded, decoded, pre, prefix_recons) on token input [T, d]: the
    ReLU encoder, and one reconstruction per latent prefix m through the
    matching decoder rows; ``decoded`` is the full-dictionary one."""
    post, _, pre = sae_mlp_apply(params, x)
    recons = [post[:, :m] @ params["W_dec"][:m] + params["b_dec"] for m in prefixes]
    return post, recons[-1], pre, recons


# ---------------------------------------------------------------------------
# Transcoder
# ---------------------------------------------------------------------------

def init_transcoder(generator: torch.Generator, d_in: int, expansion_factor: int,
                    d_out: int) -> dict:
    """sae_mlp's recipe with the decoder into ``d_out``: Kaiming encoder [d_in, h],
    zero biases, unit-norm decoder rows [h, d_out]."""
    h = int(d_in * expansion_factor)
    device = generator.device
    w_enc = kaiming_uniform(generator, (h, d_in), fan_in=d_in).T.contiguous()
    w_dec = _unit_rows(kaiming_uniform(generator, (d_out, h), fan_in=h).T.contiguous())
    return {
        "W_enc": w_enc,
        "b_enc": torch.zeros((h,), device=device),
        "W_dec": w_dec,
        "b_dec": torch.zeros((d_out,), device=device),
    }


def transcoder_apply(params: dict, x: torch.Tensor):
    """Returns (encoded, predicted_target, pre_relu) on token input [T, d_in]."""
    pre = x @ params["W_enc"] + params["b_enc"]
    post = torch.relu(pre)
    return post, post @ params["W_dec"] + params["b_dec"], pre


def transcoder_inference_and_loss(params: dict, act_in: torch.Tensor, act_tgt: torch.Tensor,
                                  lambda_sparse: float) -> dict:
    """Encode the input layer's tokens, predict the target layer's, and compute
    sae_mlp's loss terms with the target as the reference. Both taps must give
    the same number of tokens (the same spatial dims)."""
    tok_in, transformed = tokens_from_act(act_in)
    tok_tgt, _ = tokens_from_act(act_tgt)
    if tok_in.shape[0] != tok_tgt.shape[0]:
        raise ValueError(
            f"Transcoder taps disagree on token count: input {tuple(act_in.shape)} -> "
            f"{tok_in.shape[0]} tokens, target {tuple(act_tgt.shape)} -> "
            f"{tok_tgt.shape[0]} tokens (layers must share spatial dims)")
    encoded, y_hat, pre = transcoder_apply(params, tok_in)
    terms = losses.sae_loss_terms(encoded, y_hat, tok_tgt, lambda_sparse)
    if transformed:
        encoded = act_from_tokens(encoded, act_in.shape)
        pre = act_from_tokens(pre, act_in.shape)
        y_hat = act_from_tokens(y_hat, act_tgt.shape)
    terms.update(encoded=encoded, encoded_pre=pre, decoded=y_hat)
    return terms


def init_sae(name: str, generator: torch.Generator, d: int, expansion_factor: int,
             jumprelu_threshold_init: float = 1e-3) -> dict:
    """Initial parameters of the SAE variant ``name``, f32 on the generator's device."""
    if name == "sae_mlp":
        return init_sae_mlp(generator, d, expansion_factor)
    if name == "matryoshka_sae":
        return init_matryoshka_sae(generator, d, expansion_factor)
    if name == "gated_sae":
        return init_gated_sae(generator, d, expansion_factor)
    if name == "jumprelu_sae":
        return init_jumprelu_sae(generator, d, expansion_factor,
                                 threshold_init=jumprelu_threshold_init)
    raise _not_ported(name)


# ---------------------------------------------------------------------------
# token helpers and the splice entry points
# ---------------------------------------------------------------------------

def tokens_from_act(act: torch.Tensor):
    """[B, H, W, C] -> [B*H*W, C] tokens; 3-D [B, N, D] flattens the same way.
    Returns (tokens, transformed)."""
    if act.ndim in (3, 4):
        return act.reshape(-1, act.shape[-1]), True
    return act, False


def act_from_tokens(tok: torch.Tensor, like_shape: tuple) -> torch.Tensor:
    return tok.reshape(*like_shape[:-1], tok.shape[-1])


def sae_inference_and_loss(sae_model_name: str, params: dict, act: torch.Tensor,
                           lambda_sparse: float,
                           jumprelu_bandwidth: float = JUMPRELU_BANDWIDTH,
                           matryoshka_prefixes: tuple = DEFAULT_MATRYOSHKA_PREFIXES) -> dict:
    """Reshape taps to tokens, run the SAE, compute every loss term, reshape the
    outputs back. Returns the loss terms plus 'encoded', 'encoded_pre' (None for
    gated_sae) and 'decoded' (NHWC when the input was 4-D)."""
    tok, transformed = tokens_from_act(act)
    if sae_model_name == "sae_mlp":
        encoded, decoded, pre = sae_mlp_apply(params, tok)
        terms = losses.sae_loss_terms(encoded, decoded, tok, lambda_sparse)
    elif sae_model_name == "jumprelu_sae":
        encoded, decoded, pre = jumprelu_sae_apply(params, tok, jumprelu_bandwidth)
        terms = losses.jumprelu_loss_terms(
            encoded, decoded, tok, pre, params["log_threshold"], lambda_sparse,
            bandwidth=jumprelu_bandwidth)
    elif sae_model_name == "matryoshka_sae":
        counts = matryoshka_prefix_counts(params["b_enc"].shape[0], tuple(matryoshka_prefixes))
        encoded, decoded, pre, recons = matryoshka_sae_apply(params, tok, counts)
        terms = losses.matryoshka_loss_terms(encoded, recons, tok, lambda_sparse)
    elif sae_model_name == "gated_sae":
        encoded, decoded, relu_pi_gate, via_gate = gated_sae_apply(params, tok)
        pre = None
        terms = losses.gated_sae_loss_terms(relu_pi_gate, via_gate, decoded, tok,
                                            lambda_sparse)
    else:
        raise _not_ported(sae_model_name)
    if transformed:
        encoded = act_from_tokens(encoded, act.shape)
        decoded = act_from_tokens(decoded, act.shape)
        if pre is not None:
            pre = act_from_tokens(pre, act.shape)
    terms.update(encoded=encoded, encoded_pre=pre, decoded=decoded)
    return terms


def sae_encode(sae_model_name: str, params: dict, tok: torch.Tensor) -> torch.Tensor:
    """Post-activation encoder output on token input [T, d]."""
    if sae_model_name in ("sae_mlp", "matryoshka_sae"):
        return sae_mlp_apply(params, tok)[0]
    if sae_model_name == "gated_sae":
        return gated_sae_apply(params, tok)[0]
    if sae_model_name == "jumprelu_sae":
        return jumprelu_sae_apply(params, tok)[0]
    raise _not_ported(sae_model_name)


def sae_decode(sae_model_name: str, params: dict, encoded: torch.Tensor) -> torch.Tensor:
    """Decoder applied to a (possibly ablated) encoder output."""
    if sae_model_name not in PORTED:
        raise _not_ported(sae_model_name)
    return encoded @ params["W_dec"] + params["b_dec"]
