"""Transcoder feature circuits: latent-to-latent edges without backward passes
(port of sparse_vision_tpu/interp/transcoder_circuit.py; Dunefsky et al. 2024,
"Transcoders find interpretable LLM feature circuits", §4).

A transcoder is linear from its latents to its prediction (y_hat = z W_dec +
b_dec), so for a chain of transcoders T_k: A_k -> A_{k+1} the influence of
upstream latent i on downstream latent j's pre-activation factorises as

    d pre_{k+1,j} / d z_{k,i} = (W_dec_k @ W_enc_{k+1})_{ij} =: C_k[i, j],

an input-invariant connection matrix, and the edge attribution over a token
batch is a second product:

    edge_k[i, j] = mean_t z_{k,i}(t) C_k[i, j] gate_{k+1,j}(t)
                 = C_k ⊙ (Z_kᵀ G_{k+1}) / T,

with Z_k [T, h_k] the upstream latents and G_{k+1} [T, h_{k+1}] the downstream
ReLU gate from the real forward's taps (``gate="active"``) or the downstream
latent value (``gate="value"``). Two products per pair and batch, on the
frozen backbone's forward alone: no vjp, no cotangent chunks. The JAX package
computes them as plain products outside any Pallas kernel, and so does this
module (``torch.matmul``, f32).

The batch functions take images as tensors or numpy arrays and run on the
device of the parameters they are given; sums stay there until one readback.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from sparse_vision_tpu_torch.models.sae import act_from_tokens, tokens_from_act


def _on(a, device) -> torch.Tensor:
    return (torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray)
            else a).to(device)


def _device_of(params: dict) -> torch.device:
    return params["W_enc"].device


def transcoder_connection_matrix(p_up: dict, p_down: dict) -> torch.Tensor:
    """C = W_dec_up @ W_enc_down [h_up, h_down]: C[i, j] is exactly d pre_down_j
    / d z_up_i when the upstream prediction feeds the downstream encoder (the
    chain splice), for every input. The pairs must share the middle layer."""
    d_out_up = p_up["W_dec"].shape[1]
    d_in_down = p_down["W_enc"].shape[0]
    if d_out_up != d_in_down:
        raise ValueError(f"Chain mismatch: upstream decodes to {d_out_up} dims, downstream "
                         f"encodes from {d_in_down} (pairs must share the middle layer)")
    return p_up["W_dec"] @ p_down["W_enc"]


def transcoder_chains(pairs: Sequence[tuple]) -> list:
    """Maximal chains of consecutive (in, out) pairs: pair k+1 extends the chain
    when its input layer is pair k's output layer. GoogLeNet's 5 pairs
    (train/multilayer.transcoder_pairs) form [3a->3b], [4b->4c->4d->4e],
    [5a->5b]."""
    chains: list = []
    for pair in pairs:
        if chains and chains[-1][-1][1] == pair[0]:
            chains[-1].append(pair)
        else:
            chains.append([pair])
    return chains


def _latents(tok: torch.Tensor, params: dict) -> torch.Tensor:
    return torch.relu(tok @ params["W_enc"] + params["b_enc"])


def make_chain_edge_fn(net, chain: Sequence[tuple], params_list: Sequence[dict],
                       gate: str = "active") -> Callable:
    """The per-batch edge pass of a chain of two or more transcoders:
    ``fn(frozen_params, frozen_state, images) -> (edge_sums, token_count)`` with
    ``edge_sums[k]`` [h_k, h_{k+1}] the sum over the batch's tokens of z_up_i ·
    C_k[i, j] · gate_down_j (compute_transcoder_edges divides by the tokens).
    ``gate="active"`` takes the downstream 0/1 activity, ``"value"`` the
    downstream latent value."""
    if len(chain) < 2:
        raise ValueError("a chain edge pass needs at least 2 transcoders")
    if gate not in ("active", "value"):
        raise ValueError(f"unknown gate {gate!r} (use 'active' or 'value')")
    in_layers = [a for a, _ in chain]
    conns = [transcoder_connection_matrix(params_list[k], params_list[k + 1])
             for k in range(len(chain) - 1)]
    deepest = max(in_layers, key=net.index_of)

    @torch.no_grad()
    def edge_fn(frozen_params: dict, frozen_state: dict, images: torch.Tensor):
        _, taps, _ = net.apply(frozen_params, images, state=frozen_state, stop_at=deepest)
        zs = [_latents(tokens_from_act(taps[layer])[0], params)
              for layer, params in zip(in_layers, params_list)]
        sums = []
        for k, conn in enumerate(conns):
            g = (zs[k + 1] > 0).to(zs[k].dtype) if gate == "active" else zs[k + 1]
            sums.append(conn * (zs[k].T @ g))
        return tuple(sums), zs[0].shape[0]

    return edge_fn


def compute_transcoder_edges(net, frozen_params: dict, frozen_state: dict,
                             chain: Sequence[tuple], params_list: Sequence[dict], batches,
                             gate: str = "active") -> list:
    """Mean edge matrices over ``batches`` for one chain: [edge_k] with edge_k
    [h_k, h_{k+1}] = the mean over all tokens of z_up_i · C_ij · gate_down_j,
    as f32 numpy arrays. ``batches`` yields objects with ``.images``
    (data/datasets.Batch) or image arrays; the sums stay on the device and
    are read back once."""
    edge_fn = make_chain_edge_fn(net, chain, params_list, gate=gate)
    device = _device_of(params_list[0])
    sums, tokens = None, 0
    for b in batches:
        batch_sums, t = edge_fn(frozen_params, frozen_state, _on(getattr(b, "images", b), device))
        sums = list(batch_sums) if sums is None else [a + s for a, s in zip(sums, batch_sums)]
        tokens += int(t)
    if sums is None:
        raise ValueError("compute_transcoder_edges got an empty batch iterator")
    return [s.cpu().numpy() / tokens for s in sums]


def loss_node_edges(net, frozen_params: dict, frozen_state: dict, pair: tuple, params: dict,
                    batches, criterion: Callable) -> np.ndarray:
    """Loss-node attribution of each latent of the chain's terminal transcoder:
    edge_j = Σ_t z_j(t) · (dL/da_out(t) · W_dec_j), the first-order effect on
    the batch loss of scaling latent j's contribution to the predicted target.
    One backward for the tap gradient (interp/patching.loss_and_tap_grads),
    then one product; the mean over batches of the per-batch attribution [h],
    read back once."""
    from sparse_vision_tpu_torch.interp.patching import loss_and_tap_grads

    in_layer, out_layer = pair
    device = _device_of(params)
    total, n = None, 0
    for b in batches:
        _, taps, grads = loss_and_tap_grads(net, frozen_params, frozen_state,
                                            _on(b.images, device), _on(b.labels, device),
                                            criterion, [out_layer])
        g, _ = tokens_from_act(grads[out_layer])
        with torch.no_grad():
            z = _latents(tokens_from_act(taps[in_layer])[0], params)
            e = torch.sum(z * (g @ params["W_dec"].T), dim=0)
        total = e if total is None else total + e
        n += 1
    if total is None:
        raise ValueError("loss_node_edges got an empty batch iterator")
    return total.cpu().numpy() / n


def make_chain_splice_fn(net, chain: Sequence[tuple], params_list: Sequence[dict],
                         criterion: Callable, last_stage: Optional[str] = None) -> Callable:
    """``fn(frozen_params, frozen_state, images, labels, masks) -> (m_orig,
    m_spliced)``: the segment (chain[0].in, chain[-1].out] replaced by the
    chain, the first transcoder reading the real tap and each later one the
    previous prediction, each transcoder's latents multiplied by its ``masks``
    entry ([h_k], 0/1); the circuit-ablation forward of Dunefsky et al. 2024."""
    in0 = chain[0][0]
    out_k = chain[-1][1]
    last = last_stage or net.stage_names[-1]

    @torch.no_grad()
    def fn(frozen_params, frozen_state, images, labels, masks):
        logits_orig, taps, _ = net.apply(frozen_params, images, state=frozen_state)
        y, _ = tokens_from_act(taps[in0])
        for params, mask in zip(params_list, masks):
            y = (_latents(y, params) * mask) @ params["W_dec"] + params["b_dec"]
        tgt = taps[out_k]
        act = act_from_tokens(y, tgt.shape) if tgt.ndim > 2 else y
        logits_mod = net.apply_segment(frozen_params, act, after=out_k, upto=last,
                                       state=frozen_state)
        return criterion(logits_orig, labels), criterion(logits_mod, labels)

    return fn


def chain_faithfulness(net, frozen_params: dict, frozen_state: dict, chain: Sequence[tuple],
                       params_list: Sequence[dict], masks: Sequence, batches,
                       criterion: Callable) -> dict:
    """Faithfulness of a transcoder-latent circuit, (m(C) - m(empty)) / (m(M) -
    m(empty)) with m the criterion through the chain splice: m(C) keeps the
    ``masks`` latents, m(empty) none (the chain's bias cascade), m(M) is the
    unmodified model. Batch losses averaged with equal weight."""
    device = _device_of(params_list[0])
    fn = make_chain_splice_fn(net, chain, params_list, criterion)
    masks = tuple(_on(np.asarray(m, np.float32), device) for m in masks)
    zeros = tuple(torch.zeros_like(m) for m in masks)
    acc = {"m_M": [], "m_C": [], "m_empty": []}
    for b in batches:
        images, labels = _on(b.images, device), _on(b.labels, device)
        m_orig, m_c = fn(frozen_params, frozen_state, images, labels, masks)
        _, m_empty = fn(frozen_params, frozen_state, images, labels, zeros)
        for k, v in (("m_M", m_orig), ("m_C", m_c), ("m_empty", m_empty)):
            acc[k].append(v)
    if not acc["m_M"]:
        raise ValueError("chain_faithfulness got an empty batch iterator")
    # one readback; the batch losses summed in order as host floats
    m = {k: sum(torch.stack(v).cpu().tolist()) / len(v) for k, v in acc.items()}
    denom = m["m_M"] - m["m_empty"]
    m["faithfulness"] = (m["m_C"] - m["m_empty"]) / denom if denom else float("nan")
    m["kept_latents"] = [int((mk > 0).sum()) for mk in masks]
    return m


def top_edges(edge: np.ndarray, k: int = 20, threshold: float = 0.0) -> list:
    """The k strongest (upstream latent, downstream latent, attribution)
    triples of one edge matrix by |attribution|, strongest first."""
    flat = np.abs(edge).ravel()
    k = min(k, flat.size)
    idx = np.argpartition(flat, -k)[-k:]
    idx = idx[np.argsort(-flat[idx])]
    out = []
    for ij in idx:
        i, j = divmod(int(ij), edge.shape[1])
        val = float(edge[i, j])
        if abs(val) > threshold:
            out.append((i, j, val))
    return out


def load_pair_params(base_cfg, pairs: Sequence[tuple], use_registry: bool = True,
                     **pipeline_kwargs) -> list:
    """The trained transcoder of each pair, restored from its final checkpoint
    (``Pipeline._restore_sae`` at ``sae_epochs``) in the run layout that
    train/multilayer.train_transcoders_multilayer writes; a list of parameter
    dicts on the Pipelines' device. ``pipeline_kwargs`` (``device``,
    ``datasets``, ``backbone``) go to each Pipeline."""
    import dataclasses

    from sparse_vision_tpu_torch.train.multilayer import pair_config
    from sparse_vision_tpu_torch.train.pipeline import Pipeline

    params_list = []
    for a, b in pairs:
        cfg = pair_config(base_cfg, a, b, use_registry)
        cfg = dataclasses.replace(cfg, training=False, sae_checkpoint_epoch=cfg.sae_epochs)
        params_list.append(Pipeline(cfg, **pipeline_kwargs).ts.params)
    return params_list
