"""Vision Transformer and CLIP vision towers as SeqNets (port of
sparse_vision_tpu/models/vit.py).

Every encoder block is a named stage whose [B, N+1, D] output can be tapped,
spliced with an SAE or circuit-analysed like a conv map (tokens_from_act
flattens [B, N, D] -> [B*N, D]). With ``split_blocks`` each block is two
stages, ``block{i}_attn`` (x + attn(ln1(x))) and ``block{i}_mlp`` (x +
mlp(ln2(x))), exposing the attention output as a tap of its own.

The math follows HuggingFace's: ViTModel (pre-LN blocks, separate q/k/v
projections, exact GELU, LN eps 1e-12) and CLIPVisionModel (a bias-free patch
conv, a pre-layernorm before the encoder, quick GELU x * sigmoid(1.702 x), LN
eps 1e-5, pooled output post_layernorm(CLS)). Attention is the plain form,
softmax(q k^T / sqrt(d_h)) v, as the JAX package computes it.

The patch embedding takes the internal NCHW image and emits tokens [B, N+1, D]
(the patches in row-major order, after the class token); nothing after it
permutes. Weights in torch layout: linear [out, in], the patch conv OIHW.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from sparse_vision_tpu_torch.models.layers import SeqNet, Stage, state_dict_reader, uniform

_LN_EPS = 1e-12  # HF ViTConfig.layer_norm_eps default
_CLIP_LN_EPS = 1e-5

# depth, dim, heads, mlp hidden (standard ViT shapes; _test is test-sized)
VIT_SPECS = {
    "vit_test": (2, 64, 2, 128),
    "vit_tiny": (12, 192, 3, 768),
    "vit_small": (12, 384, 6, 1536),
    "vit_base": (12, 768, 12, 3072),
}

# depth, dim, heads, mlp hidden, patch (None -> per-side _PATCH_FOR_SIDE)
CLIP_SPECS = {
    "clip_vit_test": (2, 64, 2, 128, None),
    "clip_vit_b32": (12, 768, 12, 3072, 32),
    "clip_vit_b16": (12, 768, 12, 3072, 16),
    "clip_vit_l14": (24, 1024, 16, 4096, 14),
}

# image side -> patch size (must divide the side)
_PATCH_FOR_SIDE = {28: 7, 32: 4, 64: 8, 224: 16}

_ATTN_KEYS = ("ln1_scale", "ln1_bias", "q_w", "q_b", "k_w", "k_b", "v_w", "v_b", "o_w", "o_b")


def _linear_init(gen, d_in: int, d_out: int) -> tuple:
    bound = 1.0 / math.sqrt(d_in)
    return uniform(gen, (d_out, d_in), bound), uniform(gen, (d_out,), bound)


def _ln_params(dim: int, device, prefix: str) -> dict:
    return {f"{prefix}scale": torch.ones(dim, device=device),
            f"{prefix}bias": torch.zeros(dim, device=device)}


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _act(act: str):
    return _quick_gelu if act == "quick_gelu" else F.gelu  # F.gelu: the exact (erf) form


def patch_embed_stage(name: str, dim: int, patch: int, bias: bool = True) -> Stage:
    """Patch conv (stride ``patch``; CLIP's has no bias), a learned class token
    and position embeddings. A side that ``patch`` does not divide raises a
    ValueError: a VALID conv would silently crop the remainder (a 229 px image
    through patch 16, ROADMAP C7)."""

    def out_shape(in_shape):
        h, w, _ = in_shape
        if h % patch or w % patch:
            raise ValueError(f"Image side {(h, w)} not divisible by patch {patch}.")
        return (h // patch) * (w // patch) + 1, dim

    def init(gen, in_shape):
        n = out_shape(in_shape)[0]
        c = in_shape[-1]
        bound = 1.0 / math.sqrt(c * patch * patch)
        params = {"proj_w": uniform(gen, (dim, c, patch, patch), bound)}
        if bias:
            params["proj_b"] = uniform(gen, (dim,), bound)
        # HF init is trunc-normal(0.02); the exact init only matters untrained
        params["cls"] = 0.02 * torch.randn(dim, device=gen.device, generator=gen)
        params["pos"] = 0.02 * torch.randn(n, dim, device=gen.device, generator=gen)
        return params, None

    def apply(params, state, x, train):
        if x.shape[2] % patch or x.shape[3] % patch:
            raise ValueError(f"Input side {tuple(x.shape[2:4])} not divisible by patch "
                             f"{patch}; ViT/CLIP towers take 224px HF-convention inputs "
                             "on ImageNet (data/datasets.py vit_decode/clip_decode).")
        y = F.conv2d(x, params["proj_w"], params.get("proj_b"), stride=patch)
        tokens = y.flatten(2).transpose(1, 2)  # [B, gh*gw, D], row-major patches
        cls = params["cls"].expand(x.shape[0], 1, -1)
        return torch.cat([cls, tokens], dim=1) + params["pos"], state, None

    return Stage(name, init, apply, out_shape)


def _attn(p: dict, x: torch.Tensor, heads: int, ln_eps: float) -> torch.Tensor:
    """x + o(softmax(q k^T / sqrt(d_h)) v) on ln1(x), in the JAX package's form."""
    b, t, d = x.shape
    dh = d // heads
    h = F.layer_norm(x, (d,), p["ln1_scale"], p["ln1_bias"], ln_eps)
    q = F.linear(h, p["q_w"], p["q_b"]).reshape(b, t, heads, dh)
    k = F.linear(h, p["k_w"], p["k_b"]).reshape(b, t, heads, dh)
    v = F.linear(h, p["v_w"], p["v_b"]).reshape(b, t, heads, dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    ctx = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v).reshape(b, t, d)
    return x + F.linear(ctx, p["o_w"], p["o_b"])


def _mlp(p: dict, x: torch.Tensor, act, ln_eps: float) -> torch.Tensor:
    """x + mlp2(act(mlp1(ln2(x))))."""
    h = F.layer_norm(x, (x.shape[-1],), p["ln2_scale"], p["ln2_bias"], ln_eps)
    return x + F.linear(act(F.linear(h, p["mlp1_w"], p["mlp1_b"])), p["mlp2_w"], p["mlp2_b"])


def _attn_init(gen, dim: int) -> dict:
    p = _ln_params(dim, gen.device, "ln1_")
    for k in "qkvo":
        p[f"{k}_w"], p[f"{k}_b"] = _linear_init(gen, dim, dim)
    return p


def _mlp_init(gen, dim: int, mlp_dim: int) -> dict:
    p = _ln_params(dim, gen.device, "ln2_")
    p["mlp1_w"], p["mlp1_b"] = _linear_init(gen, dim, mlp_dim)
    p["mlp2_w"], p["mlp2_b"] = _linear_init(gen, mlp_dim, dim)
    return p


def _check_heads(dim: int, heads: int) -> None:
    if dim % heads:
        raise ValueError(f"dim {dim} not divisible by heads {heads}")


def vit_block_stage(name: str, dim: int, heads: int, mlp_dim: int, act: str = "gelu",
                    ln_eps: float = _LN_EPS) -> Stage:
    _check_heads(dim, heads)
    fn = _act(act)
    return Stage(name,
                 lambda gen, s: ({**_attn_init(gen, dim), **_mlp_init(gen, dim, mlp_dim)}, None),
                 lambda p, st, x, train: (_mlp(p, _attn(p, x, heads, ln_eps), fn, ln_eps), st,
                                          None),
                 lambda s: s)


def vit_attn_stage(name: str, dim: int, heads: int, ln_eps: float = _LN_EPS) -> Stage:
    """The block's attention sublayer alone: ``x + attn(ln1(x))``."""
    _check_heads(dim, heads)
    return Stage(name, lambda gen, s: (_attn_init(gen, dim), None),
                 lambda p, st, x, train: (_attn(p, x, heads, ln_eps), st, None), lambda s: s)


def vit_mlp_stage(name: str, dim: int, mlp_dim: int, act: str = "gelu",
                  ln_eps: float = _LN_EPS) -> Stage:
    """The block's MLP sublayer alone: ``x + mlp(ln2(x))``."""
    fn = _act(act)
    return Stage(name, lambda gen, s: (_mlp_init(gen, dim, mlp_dim), None),
                 lambda p, st, x, train: (_mlp(p, x, fn, ln_eps), st, None), lambda s: s)


def _block_stages(i: int, dim: int, heads: int, mlp_dim: int, act: str, ln_eps: float,
                  split: bool) -> list:
    if split:
        return [vit_attn_stage(f"block{i}_attn", dim, heads, ln_eps),
                vit_mlp_stage(f"block{i}_mlp", dim, mlp_dim, act, ln_eps)]
    return [vit_block_stage(f"block{i}", dim, heads, mlp_dim, act, ln_eps)]


def split_converted_blocks(params: dict, depth: int) -> dict:
    """Re-key fused-block params for a ``split_blocks`` net: block{i} ->
    block{i}_attn + block{i}_mlp (the two sublayers compose to the fused block)."""
    out = {k: v for k, v in params.items() if not k.startswith("block")}
    for i in range(depth):
        block = params[f"block{i}"]
        out[f"block{i}_attn"] = {k: block[k] for k in _ATTN_KEYS}
        out[f"block{i}_mlp"] = {k: v for k, v in block.items() if k not in _ATTN_KEYS}
    return out


def _ln_stage(name: str, dim: int, ln_eps: float) -> Stage:
    return Stage(name, lambda gen, s: (_ln_params(dim, gen.device, ""), None),
                 lambda p, st, x, train: (F.layer_norm(x, (dim,), p["scale"], p["bias"], ln_eps),
                                          st, None),
                 lambda s: s)


def _cls_select_stage(name: str) -> Stage:
    return Stage(name, lambda gen, s: (None, None),
                 lambda p, st, x, train: (x[:, 0], st, None), lambda s: (s[-1],))


def _head_stage(name: str, dim: int, num_classes: int) -> Stage:
    def init(gen, in_shape):
        w, b = _linear_init(gen, dim, num_classes)
        return {"w": w, "b": b}, None

    return Stage(name, init, lambda p, st, x, train: (F.linear(x, p["w"], p["b"]), st, None),
                 lambda s: (num_classes,))


def _patch_for(img_side: int) -> int:
    if img_side not in _PATCH_FOR_SIDE:
        raise ValueError(
            f"No patch size for {img_side}px input (supported: {sorted(_PATCH_FOR_SIDE)}; "
            "the 229px InceptionV1 ImageNet crop is a CNN-pipeline convention — use 224px "
            "data for ViT).")
    return _PATCH_FOR_SIDE[img_side]


def make_vit(spec_name: str, num_classes: int, img_side: int,
             split_blocks: bool = False) -> SeqNet:
    depth, dim, heads, mlp_dim = VIT_SPECS[spec_name]
    stages = [patch_embed_stage("patch_embed", dim, _patch_for(img_side))]
    for i in range(depth):
        stages += _block_stages(i, dim, heads, mlp_dim, "gelu", _LN_EPS, split_blocks)
    stages += [_ln_stage("ln_final", dim, _LN_EPS), _cls_select_stage("cls"),
               _head_stage("head", dim, num_classes)]
    return SeqNet(stages)


def make_clip_vision(spec_name: str, num_classes: int, img_side: int,
                     split_blocks: bool = False) -> SeqNet:
    """The CLIP vision tower; the head stands where CLIP's visual_projection
    does (convert_hf_clip_vision maps it when present)."""
    depth, dim, heads, mlp_dim, patch = CLIP_SPECS[spec_name]
    patch = patch or _patch_for(img_side)
    stages = [patch_embed_stage("patch_embed", dim, patch, bias=False),
              _ln_stage("pre_ln", dim, _CLIP_LN_EPS)]
    for i in range(depth):
        stages += _block_stages(i, dim, heads, mlp_dim, "quick_gelu", _CLIP_LN_EPS,
                                split_blocks)
    stages += [_cls_select_stage("cls"), _ln_stage("post_ln", dim, _CLIP_LN_EPS),
               _head_stage("head", dim, num_classes)]
    return SeqNet(stages)


# ---------------------------------------------------------------------------
# HF converters: torch's layout is the port's, so only the keys change
# ---------------------------------------------------------------------------

def convert_hf_clip_vision(state_dict: dict, depth: int) -> dict:
    """HF ``CLIPVisionModel`` / ``CLIPVisionModelWithProjection`` state_dict ->
    SeqNet params. ``visual_projection`` (bias-free) maps onto the head when
    present; otherwise no head is returned (it keeps its own init)."""
    t = state_dict_reader(state_dict)
    e = "vision_model.embeddings."
    params = {
        "patch_embed": {"proj_w": t(e + "patch_embedding.weight"),
                        "cls": t(e + "class_embedding"),
                        "pos": t(e + "position_embedding.weight")},
        # HF's attribute really is spelled 'pre_layrnorm' (modeling_clip.py)
        "pre_ln": {"scale": t("vision_model.pre_layrnorm.weight"),
                   "bias": t("vision_model.pre_layrnorm.bias")},
        "post_ln": {"scale": t("vision_model.post_layernorm.weight"),
                    "bias": t("vision_model.post_layernorm.bias")},
    }
    if "visual_projection.weight" in state_dict:
        w = t("visual_projection.weight")
        params["head"] = {"w": w, "b": torch.zeros(w.shape[0])}
    for i in range(depth):
        p = f"vision_model.encoder.layers.{i}."
        a = p + "self_attn."
        params[f"block{i}"] = {
            "ln1_scale": t(p + "layer_norm1.weight"), "ln1_bias": t(p + "layer_norm1.bias"),
            **{f"{k}_{s}": t(f"{a}{k}_proj.{n}")
               for k in "qkv" for s, n in (("w", "weight"), ("b", "bias"))},
            "o_w": t(a + "out_proj.weight"), "o_b": t(a + "out_proj.bias"),
            "ln2_scale": t(p + "layer_norm2.weight"), "ln2_bias": t(p + "layer_norm2.bias"),
            "mlp1_w": t(p + "mlp.fc1.weight"), "mlp1_b": t(p + "mlp.fc1.bias"),
            "mlp2_w": t(p + "mlp.fc2.weight"), "mlp2_b": t(p + "mlp.fc2.bias"),
        }
    return params


def convert_hf_vit(state_dict: dict, depth: int) -> dict:
    """HF ``ViTForImageClassification`` state_dict -> SeqNet params."""
    t = state_dict_reader(state_dict)
    e = "vit.embeddings."
    params = {
        "patch_embed": {"proj_w": t(e + "patch_embeddings.projection.weight"),
                        "proj_b": t(e + "patch_embeddings.projection.bias"),
                        "cls": t(e + "cls_token")[0, 0],
                        "pos": t(e + "position_embeddings")[0]},
        "ln_final": {"scale": t("vit.layernorm.weight"), "bias": t("vit.layernorm.bias")},
        "head": {"w": t("classifier.weight"), "b": t("classifier.bias")},
    }
    for i in range(depth):
        p = f"vit.encoder.layer.{i}."
        a = p + "attention.attention."
        params[f"block{i}"] = {
            "ln1_scale": t(p + "layernorm_before.weight"),
            "ln1_bias": t(p + "layernorm_before.bias"),
            **{f"{k}_{s}": t(f"{a}{name}.{n}")
               for k, name in (("q", "query"), ("k", "key"), ("v", "value"))
               for s, n in (("w", "weight"), ("b", "bias"))},
            "o_w": t(p + "attention.output.dense.weight"),
            "o_b": t(p + "attention.output.dense.bias"),
            "ln2_scale": t(p + "layernorm_after.weight"),
            "ln2_bias": t(p + "layernorm_after.bias"),
            "mlp1_w": t(p + "intermediate.dense.weight"),
            "mlp1_b": t(p + "intermediate.dense.bias"),
            "mlp2_w": t(p + "output.dense.weight"), "mlp2_b": t(p + "output.dense.bias"),
        }
    return params
