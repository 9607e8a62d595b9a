"""Sparse autoencoders as functions over a parameter dict (port of
sparse_vision_tpu/models/sae.py: every SAE variant and the transcoder).

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
TopK SAE (Gao et al. 2024): the ReLU layout; each token keeps its k largest
pre-activations (through ReLU). BatchTopK SAE (Bussmann et al. 2024): the ReLU
layout plus a scalar inference ``threshold``; training keeps the T·k largest
pre-activations of the whole batch, inference gates relu(pre) at the threshold.
Both train without an L1 term and may add the AuxK loss (topk_aux_loss).
Conv SAE: 3x3 SAME convolutions in NHWC, W_enc [3, 3, c, c·k] and W_dec [3, 3,
c·k, c] (HWIO), ReLU after both.
Transcoder (Dunefsky et al. 2024): the ReLU layout with W_dec [h, d_out] into
another layer's space and no input centring (b_dec is an output-space bias).

Token convention: NHWC feature maps [B, H, W, C] flatten to [B*H*W, C] tokens in
(b, h, w) order, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sparse_vision_tpu_torch.ops import losses

# STE bandwidth ε, the paper's default: sized for normalized activations; raw
# vision activations need it scaled to their spread (RunConfig.jumprelu_bandwidth)
JUMPRELU_BANDWIDTH = 1e-3
# prefix fractions of the dictionary (RunConfig.sae_matryoshka_prefixes)
DEFAULT_MATRYOSHKA_PREFIXES = (0.0625, 0.25, 1.0)
SAE_VARIANTS = ("sae_mlp", "gated_sae", "jumprelu_sae", "matryoshka_sae", "topk_sae",
                "batch_topk_sae", "sae_conv")
# sparsity from the selection, not from an L1 term; AuxK applies to these
TOPK_FAMILY = ("topk_sae", "batch_topk_sae")
# the variants whose code decodes token by token (every one but sae_conv)
TOKEN_DECODERS = tuple(v for v in SAE_VARIANTS if v != "sae_conv")
# EMA decay of batch_topk's inference-threshold estimate (each batch's minimum
# positive selected activation, seeded by the first observation)
BATCH_TOPK_THRESHOLD_EMA = 0.99


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
# Conv SAE (NHWC)
# ---------------------------------------------------------------------------

def init_sae_conv(generator: torch.Generator, c: int, expansion_factor: int) -> dict:
    """3x3 conv encoder c -> c·k and decoder c·k -> c, weights HWIO; torch's
    Conv2d init: weights and biases U(±1/sqrt(fan_in)), fan_in = 9·c_in."""
    ck = c * expansion_factor

    def conv_init(cin, cout):
        bound = 1.0 / (cin * 9) ** 0.5
        w = torch.empty((3, 3, cin, cout), device=generator.device).uniform_(
            -bound, bound, generator=generator)
        b = torch.empty((cout,), device=generator.device).uniform_(
            -bound, bound, generator=generator)
        return w, b

    w_enc, b_enc = conv_init(c, ck)
    w_dec, b_dec = conv_init(ck, c)
    return {"W_enc": w_enc, "b_enc": b_enc, "W_dec": w_dec, "b_dec": b_dec}


def _conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 convolution of NHWC ``x`` by HWIO ``w``, then ``+ b``; the
    operands promoted to a common dtype first, as the JAX package does."""
    dt = torch.promote_types(x.dtype, w.dtype)
    y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), w.to(dt).permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1) + b


def sae_conv_apply(params: dict, x: torch.Tensor):
    """Returns (encoded, decoded) on NHWC input, with a ReLU after both convs
    (reference sae_conv.py:37-42)."""
    encoded = torch.relu(_conv3x3(x, params["W_enc"], params["b_enc"]))
    decoded = torch.relu(_conv3x3(encoded, params["W_dec"], params["b_dec"]))
    return encoded, decoded


# ---------------------------------------------------------------------------
# TopK and BatchTopK SAEs
# ---------------------------------------------------------------------------

def _check_k(k: int, h: int) -> None:
    if k > h:
        raise ValueError(f"sae_topk={k} exceeds the latent count {h}")


def init_topk_sae(generator: torch.Generator, d: int, expansion_factor: int) -> dict:
    """The ReLU SAE's layout and init: the sparsity comes from the activation."""
    return init_sae_mlp(generator, d, expansion_factor)


def topk_sae_apply(params: dict, x: torch.Tensor, k: int, approx: bool = False):
    """Returns (encoded, decoded, pre) on token input [T, d]: each token keeps
    its k largest pre-activations through ReLU. The selected INDICES are
    scattered, so L0 <= k holds exactly under ties (a value threshold would
    keep every latent tied at the k-th value); which of several tied latents is
    kept may differ from the JAX package's lax.top_k. ``approx`` (the JAX
    package's lax.approx_max_k, exact off the TPU) selects exactly here too."""
    del approx
    _check_k(k, params["b_enc"].shape[0])
    pre = (x - params["b_dec"]) @ params["W_enc"] + params["b_enc"]
    vals, idx = torch.topk(pre, k, dim=-1)
    post = torch.zeros_like(pre).scatter(1, idx, torch.relu(vals))
    return post, post @ params["W_dec"] + params["b_dec"], pre


def init_batch_topk_sae(generator: torch.Generator, d: int, expansion_factor: int) -> dict:
    """The ReLU SAE's layout plus a scalar inference ``threshold`` (0), which the
    train step overwrites with its EMA estimate instead of a gradient step."""
    params = init_sae_mlp(generator, d, expansion_factor)
    params["threshold"] = torch.zeros((), device=generator.device)
    return params


def _min_positive(kept: torch.Tensor) -> torch.Tensor:
    """The smallest positive entry of ``kept``, 0 when there is none."""
    m = torch.where(kept > 0, kept, torch.full_like(kept, float("inf"))).min()
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def batch_topk_sae_apply(params: dict, x: torch.Tensor, k: int, training: bool = True):
    """Returns (encoded, decoded, pre, batch_min_pos) on token input [T, d].
    Training keeps the T·k largest pre-activations of the whole flattened batch
    (through ReLU), so a token may use more or fewer than k latents;
    ``batch_min_pos`` is the smallest positive kept value (0 if none), the
    threshold EMA's observation. Inference (``training=False``) is the
    deployment form ``relu(pre) * (relu(pre) > threshold)``, and
    ``batch_min_pos`` is None."""
    h = params["b_enc"].shape[0]
    pre = (x - params["b_dec"]) @ params["W_enc"] + params["b_enc"]
    relu = torch.relu(pre)
    if training:
        _check_k(k, h)
        flat = pre.reshape(-1)
        vals, idx = torch.topk(flat, pre.shape[0] * k)
        kept = torch.relu(vals)
        post = torch.zeros_like(flat).scatter(0, idx, kept).reshape(pre.shape)
        batch_min_pos = _min_positive(kept)
    else:
        post = relu * (relu > params["threshold"])
        batch_min_pos = None
    return post, post @ params["W_dec"] + params["b_dec"], pre, batch_min_pos


def batch_topk_threshold_update(threshold: torch.Tensor, batch_min_pos: torch.Tensor,
                                ema: float = BATCH_TOPK_THRESHOLD_EMA) -> torch.Tensor:
    """One step of the threshold EMA: the first positive observation seeds it,
    later ones average in; a batch with no positive selected keeps it."""
    seeded = torch.where(threshold == 0, batch_min_pos,
                         ema * threshold + (1.0 - ema) * batch_min_pos)
    return torch.where(batch_min_pos > 0, seeded, threshold).to(threshold.dtype)


def calibrate_batch_topk_threshold(params: dict, tok: torch.Tensor, k: int) -> torch.Tensor:
    """The inference threshold at the given parameters from one token block:
    the T·k-th largest pre-activation (ops/fast_batch_topk.kth_largest),
    clamped at 0 (the paper's BatchTopK -> JumpReLU conversion). The EMA
    averages cutoffs from across training and lags a cutoff that drifts."""
    from sparse_vision_tpu_torch.ops.fast_batch_topk import kth_largest

    pre = (tok - params["b_dec"]) @ params["W_enc"] + params["b_enc"]
    cutoff = kth_largest(pre.reshape(-1).float(), tok.shape[0] * k)
    return torch.clamp(cutoff, min=0.0).to(params["threshold"].dtype)


def topk_aux_loss(params: dict, act: torch.Tensor, residual: torch.Tensor,
                  dead_mask: torch.Tensor, k_aux: int, approx: bool = False) -> torch.Tensor:
    """AuxK (Gao et al. 2024 §A.2): reconstruct the main reconstruction's
    residual ``x - x_hat`` (gradient stopped) with the top-``k_aux`` dead
    latents of each token, post-ReLU and without b_dec, normalized by the
    residual's variance; 0 when no latent is dead. ``act`` and ``residual``
    may be token matrices or maps; ``dead_mask`` [h] is the train state's
    dead accumulator. ``approx`` selects exactly, as topk_sae_apply's."""
    del approx
    tok, _ = tokens_from_act(act)
    res_tok, _ = tokens_from_act(residual)
    h = params["b_enc"].shape[0]
    pre = (tok - params["b_dec"]) @ params["W_enc"] + params["b_enc"]
    neg = torch.finfo(pre.dtype).min
    masked = torch.where(dead_mask[None, :], pre, torch.full_like(pre, neg))
    vals, idx = torch.topk(masked, min(k_aux, h), dim=-1)
    kept = torch.where(vals > neg / 2, torch.relu(vals), torch.zeros_like(vals))
    aux_recon = torch.zeros_like(pre).scatter(1, idx, kept) @ params["W_dec"]
    e = res_tok.detach()
    num = torch.square(e - aux_recon).sum()
    den = torch.clamp(torch.square(e - e.mean(0, keepdim=True)).sum(), min=1e-9)
    return torch.where(dead_mask.any(), num / den, torch.zeros_like(num))


def intervene_on_decoder_weights(params: dict, unit_index: int, value) -> dict:
    """``params`` with latent ``unit_index``'s decoder direction set to
    ``value`` (reference sae_mlp.py:187-199); the input dict is not changed."""
    w = params["W_dec"].clone()
    w[unit_index, :] = torch.as_tensor(value, dtype=w.dtype, device=w.device)
    return {**params, "W_dec": w}


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
    """Initial parameters of the SAE variant ``name``, f32 on the generator's
    device (``d`` is the channel count of sae_conv)."""
    if name == "sae_mlp":
        return init_sae_mlp(generator, d, expansion_factor)
    if name == "gated_sae":
        return init_gated_sae(generator, d, expansion_factor)
    if name == "sae_conv":
        return init_sae_conv(generator, d, expansion_factor)
    if name == "jumprelu_sae":
        return init_jumprelu_sae(generator, d, expansion_factor,
                                 threshold_init=jumprelu_threshold_init)
    if name == "topk_sae":
        return init_topk_sae(generator, d, expansion_factor)
    if name == "batch_topk_sae":
        return init_batch_topk_sae(generator, d, expansion_factor)
    if name == "matryoshka_sae":
        return init_matryoshka_sae(generator, d, expansion_factor)
    raise ValueError(f"Unknown SAE model name {name}.")


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
                           lambda_sparse: float, topk: int = 32, topk_approx: bool = False,
                           jumprelu_bandwidth: float = JUMPRELU_BANDWIDTH,
                           matryoshka_prefixes: tuple = DEFAULT_MATRYOSHKA_PREFIXES,
                           training: bool = True) -> dict:
    """Reshape taps to tokens, run the SAE, compute every loss term, reshape the
    outputs back. Returns the loss terms plus 'encoded', 'encoded_pre' (None for
    gated_sae and sae_conv) and 'decoded' (NHWC when the input was 4-D). The
    TopK family trains without L1 (the term is reported, not added); batch_topk
    also returns 'batch_topk_min_pos' when ``training``, and runs its
    deployment form (the scalar threshold) when not. sae_conv runs on the map
    itself and compares it flattened per image."""
    if sae_model_name == "sae_conv":
        encoded, decoded = sae_conv_apply(params, act)
        terms = losses.sae_loss_terms(encoded, decoded.reshape(decoded.shape[0], -1),
                                      act.reshape(act.shape[0], -1), lambda_sparse)
        terms.update(encoded=encoded, encoded_pre=None, decoded=decoded)
        return terms
    tok, transformed = tokens_from_act(act)
    if sae_model_name == "sae_mlp":
        encoded, decoded, pre = sae_mlp_apply(params, tok)
        terms = losses.sae_loss_terms(encoded, decoded, tok, lambda_sparse)
    elif sae_model_name == "topk_sae":
        encoded, decoded, pre = topk_sae_apply(params, tok, topk, approx=topk_approx)
        terms = losses.sae_loss_terms(encoded, decoded, tok, 0.0)
    elif sae_model_name == "batch_topk_sae":
        encoded, decoded, pre, min_pos = batch_topk_sae_apply(params, tok, topk,
                                                              training=training)
        terms = losses.sae_loss_terms(encoded, decoded, tok, 0.0)
        if min_pos is not None:
            terms["batch_topk_min_pos"] = min_pos.detach()
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
        raise ValueError(f"Unknown SAE model name {sae_model_name}.")
    if transformed:
        encoded = act_from_tokens(encoded, act.shape)
        decoded = act_from_tokens(decoded, act.shape)
        if pre is not None:
            pre = act_from_tokens(pre, act.shape)
    terms.update(encoded=encoded, encoded_pre=pre, decoded=decoded)
    return terms


def sae_encode(sae_model_name: str, params: dict, tok: torch.Tensor) -> torch.Tensor:
    """Post-activation encoder output on token input [T, d]; batch_topk_sae's is
    its deployment form (the scalar threshold). topk_sae and sae_conv have
    none, as in the JAX package."""
    if sae_model_name in ("sae_mlp", "matryoshka_sae"):
        return sae_mlp_apply(params, tok)[0]
    if sae_model_name == "gated_sae":
        return gated_sae_apply(params, tok)[0]
    if sae_model_name == "jumprelu_sae":
        return jumprelu_sae_apply(params, tok)[0]
    if sae_model_name == "batch_topk_sae":
        return batch_topk_sae_apply(params, tok, k=1, training=False)[0]
    raise ValueError(f"SAE {sae_model_name!r} has no token encoder.")


def sae_decode(sae_model_name: str, params: dict, encoded: torch.Tensor) -> torch.Tensor:
    """Decoder applied to a (possibly ablated) encoder output."""
    if sae_model_name not in TOKEN_DECODERS:
        raise ValueError(f"SAE {sae_model_name!r} has no token decoder.")
    return encoded @ params["W_dec"] + params["b_dec"]
