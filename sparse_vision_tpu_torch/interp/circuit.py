"""Feature-circuit discovery engine: dataset averages, node IE, edge IE,
faithfulness (port of sparse_vision_tpu/interp/circuit.py).

A frozen backbone with one frozen SAE per circuit layer:

- interventions are splices on ``SeqNet`` (plain functions of the tap);
- the clean-model layer gradients come from one backward over injected zero
  perturbations (interp/patching.py ``loss_and_tap_grads``);
- node IE is a decoder vjp: with the SAE error detached and the clean gradient
  passed through at the spliced output, the encoder-output gradient is exactly
  the clean layer gradient chained through the decoder;
- edge IE differentiates every downstream feature's product at once: one
  ``torch.func.vjp`` of the vector of products, applied under ``torch.func.vmap``
  to a one-hot cotangent stack, chunk by chunk, each chunk reduced to its IE
  columns before the next is built;
- faithfulness evaluates every ablation variant of a batch in one call.

Averages and node IE are sample-weighted running means; edges and faithfulness
give each batch equal weight. Data arguments are iterables of ``(images,
labels)`` tensors on the device of the weights.
"""

from __future__ import annotations

from typing import Callable, Iterable, NamedTuple, Optional, Sequence

import torch

from sparse_vision_tpu_torch.interp.ie_math import (
    broadcast_average,
    ie_all_channels,
    ie_channel_wise,
    running_mean,
)
from sparse_vision_tpu_torch.interp.patching import loss_and_tap_grads, splice_with_error
from sparse_vision_tpu_torch.models.layers import SeqNet
from sparse_vision_tpu_torch.models.sae import (
    act_from_tokens,
    sae_decode,
    sae_encode,
    tokens_from_act,
)
from sparse_vision_tpu_torch.ops import metrics

# Faithfulness threshold sweep grid; compute_ie "4<i>" indexes this list.
FAITHFULNESS_THRESHOLDS = (
    1e-10, 1e-9, 1e-8, 1e-7, 1e-6, 1e-5, 3e-5, 6e-5, 9e-5, 1e-4,
    3e-4, 6e-4, 9e-4, 1e-3, 3e-3, 6e-3, 9e-3, 1e-2, 1e-1, 1.0,
)


class FrozenSAE(NamedTuple):
    """A frozen, trained SAE spliced at one backbone layer."""

    model_name: str  # an SAE variant of models/sae.py
    params: dict
    expansion_factor: int


class Averages(NamedTuple):
    """Dataset averages per layer. Conv layers: enc [H, W, C*K], err/out
    [H, W, C]; 2-D layers: [C*K] / [C]."""

    enc: dict
    err: dict
    out: dict
    dead: dict  # bool [C*K]: dead across the whole dataset (AND over batches)
    sparsity: dict  # float


class NodeIE(NamedTuple):
    """Node indirect effects per layer: SAE features [C*K], SAE error (scalar),
    raw model neurons [C]."""

    features: dict
    error: dict
    model_neurons: dict


class CircuitEngine:
    """Drives the four circuit-discovery passes over a frozen backbone and
    frozen SAEs (weights and data on one device)."""

    def __init__(
        self,
        net: SeqNet,
        params: dict,
        saes: dict,
        criterion: Callable,
        state: Optional[dict] = None,
    ):
        self.net = net
        self.params = params
        self.state = state or {}
        self.saes = saes
        self.criterion = criterion
        # layer order follows the network
        self.layers = [n for n in net.stage_names if n in saes]

    def _enc(self, name: str, tok: torch.Tensor) -> torch.Tensor:
        sae = self.saes[name]
        return sae_encode(sae.model_name, sae.params, tok)

    def _dec(self, name: str, enc: torch.Tensor) -> torch.Tensor:
        sae = self.saes[name]
        return sae_decode(sae.model_name, sae.params, enc)

    # -- 1) dataset averages ---------------------------------------------------

    @torch.no_grad()
    def _avg_batch(self, images: torch.Tensor) -> dict:
        _, taps, _ = self.net.apply(self.params, images, state=self.state)
        per_layer = {}
        for name in self.layers:
            act = taps[name]
            tok, transformed = tokens_from_act(act)
            enc = self._enc(name, tok)
            err = tok - self._dec(name, enc)
            # the statistics are per token of the [T, C*K] code, not per sample
            # as in training
            dead, sparsity, _ = metrics.measure_inactive_units(
                enc, self.saes[name].expansion_factor)
            if transformed:
                enc, err = act_from_tokens(enc, act.shape), act_from_tokens(err, act.shape)
            per_layer[name] = {"enc": enc.mean(0), "err": err.mean(0), "out": act.mean(0),
                               "dead": dead, "sparsity": sparsity}
        return per_layer

    def compute_averages(self, data: Iterable) -> Averages:
        enc, err, out, dead, spars = {}, {}, {}, {}, {}
        n = 0
        for images, _ in data:
            b = images.shape[0]
            for name, v in self._avg_batch(images).items():
                enc[name] = running_mean(enc.get(name), v["enc"], n, b)
                err[name] = running_mean(err.get(name), v["err"], n, b)
                out[name] = running_mean(out.get(name), v["out"], n, b)
                dead[name] = v["dead"] if name not in dead else dead[name] & v["dead"]
                spars[name] = running_mean(spars.get(name), v["sparsity"], n, b)
            n += b
        return Averages(enc, err, out, dead, spars)

    # -- 2) node IE ------------------------------------------------------------

    def _node_batch(self, images, labels, averages: Averages) -> dict:
        _, taps, grads = loss_and_tap_grads(self.net, self.params, self.state, images,
                                            labels, self.criterion, self.layers)
        res = {}
        with torch.no_grad():
            for name in self.layers:
                b = images.shape[0]
                tok, _ = tokens_from_act(taps[name])
                gtok, _ = tokens_from_act(grads[name])
                enc = self._enc(name, tok)
                # pass-through and a detached error make the encoder-output
                # gradient the clean layer gradient chained through the decoder
                dec, vjp_dec = torch.func.vjp(lambda e, name=name: self._dec(name, e), enc)
                (enc_grad,) = vjp_dec(gtok)
                res[name] = {
                    "features": ie_channel_wise(enc, averages.enc[name], enc_grad, b),
                    "error": ie_all_channels(tok - dec, averages.err[name], gtok, b),
                    "model_neurons": ie_channel_wise(tok, averages.out[name], gtok, b),
                }
        return res

    def compute_node_ie(self, data: Iterable, averages: Averages) -> NodeIE:
        feats, errs, neurons = {}, {}, {}
        n = 0
        for images, labels in data:
            b = images.shape[0]
            for name, v in self._node_batch(images, labels, averages).items():
                feats[name] = running_mean(feats.get(name), v["features"], n, b)
                errs[name] = running_mean(errs.get(name), v["error"], n, b)
                neurons[name] = running_mean(neurons.get(name), v["model_neurons"], n, b)
            n += b
        return NodeIE(feats, errs, neurons)

    # -- 3) edge IE ------------------------------------------------------------

    def _edge_pair(self, name_u: str, name_d: str, idx_u: torch.Tensor,
                   idx_d: torch.Tensor, act_u, act_d, grad_d, enc_avg_u, err_avg_u,
                   cotangent_chunk: int) -> torch.Tensor:
        """Edge IE of one batch for the consecutive pair (u, d): [len(idx_u)+1,
        len(idx_d)+1], rows the upstream features and error node, columns the
        downstream features and error node.

        Every downstream product ``mean_t(grad_m_d[:, j] * enc_d[:, j])`` (and
        the error node's) is one output of ``prods``; the vjp of ``prods`` under
        a vmapped one-hot cotangent stack gives each product's gradient w.r.t.
        the upstream encoder and decoder outputs. The stack is built and reduced
        ``cotangent_chunk`` rows at a time: the whole [n_out, T, C*K] gradient
        stack would not fit in device memory at production widths."""
        b = act_u.shape[0]
        gd_tok, _ = tokens_from_act(grad_d)
        with torch.no_grad():
            # grad of the loss w.r.t. enc_d under the standard intervention at d
            tok_d0, _ = tokens_from_act(act_d)
            _, vjp_dec_d = torch.func.vjp(lambda e: self._dec(name_d, e),
                                          self._enc(name_d, tok_d0))
            (grad_m_d,) = vjp_dec_d(gd_tok)
            tok_u, transformed_u = tokens_from_act(act_u)
            enc_u0 = self._enc(name_u, tok_u)
            err_u = tok_u - self._dec(name_u, enc_u0)

        def prods(eps_enc, eps_dec):
            # upstream: detached SAE error, no pass-through; the eps injections
            # expose the encoder and decoder outputs as differentiable inputs
            dec_u = self._dec(name_u, enc_u0 + eps_enc) + eps_dec
            spliced = splice_with_error(tok_u, dec_u)
            act_sp = act_from_tokens(spliced, act_u.shape) if transformed_u else spliced
            act_d2 = self.net.apply_segment(self.params, act_sp, after=name_u, upto=name_d,
                                            state=self.state)
            tok_d, _ = tokens_from_act(act_d2)
            # downstream: no detach, no pass-through
            enc_d = self._enc(name_d, tok_d)
            err_d = tok_d - self._dec(name_d, enc_d)
            pf = (grad_m_d * enc_d).mean(0)[idx_d]
            pe = (gd_tok * err_d).sum(-1).mean()
            return torch.cat([pf, pe[None]])

        _, vjp_fn = torch.func.vjp(prods, torch.zeros_like(enc_u0), torch.zeros_like(tok_u))
        enc_u_sel = enc_u0[:, idx_u]
        enc_avg_u_sel = enc_avg_u[..., idx_u]

        def col(g_e, g_d):
            fe = ie_channel_wise(enc_u_sel, enc_avg_u_sel, g_e[:, idx_u], b)
            er = ie_all_channels(err_u, err_avg_u, g_d, b)
            return torch.cat([fe, er[None]])

        n_out = idx_d.shape[0] + 1
        eye = torch.eye(n_out, dtype=enc_u0.dtype, device=enc_u0.device)
        cols = []
        for i in range(0, n_out, cotangent_chunk):
            g_enc, g_dec = torch.func.vmap(vjp_fn)(eye[i:i + cotangent_chunk])
            with torch.no_grad():
                cols.append(torch.func.vmap(col)(g_enc, g_dec))
            del g_enc, g_dec
        return torch.cat(cols).T

    def _edge_loss(self, name_u: str, idx_u: torch.Tensor, act_u, labels, enc_avg_u,
                   err_avg_u) -> torch.Tensor:
        """Edges from the model-loss node to the last layer's features and error
        [len(idx_u)+1, 1]: grad_m_d is identically 1, so an edge's gradient is the
        loss gradient w.r.t. the upstream encoder / decoder outputs under the
        standard upstream intervention (detached error, no pass-through). The
        segment after ``name_u`` starts from the clean tap."""
        b = act_u.shape[0]
        last = self.net.stage_names[-1]
        with torch.no_grad():
            tok_u, transformed_u = tokens_from_act(act_u)
            enc_u0 = self._enc(name_u, tok_u)
            err_u = tok_u - self._dec(name_u, enc_u0)

        def loss_fn(eps_enc, eps_dec):
            dec = self._dec(name_u, enc_u0 + eps_enc) + eps_dec
            out = splice_with_error(tok_u, dec)
            act_sp = act_from_tokens(out, act_u.shape) if transformed_u else out
            logits = self.net.apply_segment(self.params, act_sp, after=name_u, upto=last,
                                            state=self.state)
            return self.criterion(logits, labels)

        g_enc, g_dec = torch.func.grad(loss_fn, argnums=(0, 1))(
            torch.zeros_like(enc_u0), torch.zeros_like(tok_u))
        with torch.no_grad():
            fe = ie_channel_wise(enc_u0[:, idx_u], enc_avg_u[..., idx_u], g_enc[:, idx_u], b)
            er = ie_all_channels(err_u, err_avg_u, g_dec, b)
        return torch.cat([fe, er[None]])[:, None]

    def compute_edge_ie(
        self,
        data: Iterable,
        averages: Averages,
        feature_indices: dict,
        custom_layers: Optional[Sequence[str]] = None,
        cotangent_chunk: int = 64,
    ) -> dict:
        """Edge IE matrices per upstream layer over consecutive pairs of
        ``custom_layers`` (default: the engine's layers); the last layer's
        downstream node is the model loss. One clean forward and multi-tap
        backward per batch feeds every pair; batches weighted equally."""
        layers = list(custom_layers) if custom_layers is not None else self.layers
        edges: dict = {}
        batch_idx = 0
        for images, labels in data:
            idx = {n: torch.as_tensor(list(feature_indices[n]), dtype=torch.long,
                                      device=images.device) for n in layers}
            batch_idx += 1
            _, taps, grads = loss_and_tap_grads(self.net, self.params, self.state, images,
                                                labels, self.criterion, layers)
            for u, d in zip(layers[:-1], layers[1:]):
                mat = self._edge_pair(u, d, idx[u], idx[d], taps[u], taps[d], grads[d],
                                      averages.enc[u], averages.err[u], cotangent_chunk)
                edges[u] = running_mean(edges.get(u), mat, batch_idx - 1, 1)
            last = layers[-1]
            mat = self._edge_loss(last, idx[last], taps[last], labels, averages.enc[last],
                                  averages.err[last])
            edges[last] = running_mean(edges.get(last), mat, batch_idx - 1, 1)
        return edges

    # -- 4) faithfulness -------------------------------------------------------

    def circuit_masks(self, node_ie: NodeIE, threshold: float) -> tuple:
        """Boolean node filters |IE| > threshold, for the features, the error
        nodes and the model neurons alike."""
        feat = {n: node_ie.features[n].abs() > threshold for n in self.layers}
        err = {n: node_ie.error[n].abs() > threshold for n in self.layers}
        neurons = {n: node_ie.model_neurons[n].abs() > threshold for n in self.layers}
        return feat, err, neurons

    def _sae_splice(self, name, mask, enc_avg, err_avg, variant: str, err_keep=None):
        """One layer's faithfulness intervention. Variants:
          zero:    circuit features, SAE error zero-ablated
          mean:    circuit features, SAE error mean-ablated
          circuit: circuit features, SAE error kept iff its node is in the
                   circuit (the error computed from the original decoder output)
        """

        def sp(act):
            tok, tr = tokens_from_act(act)
            b = act.shape[0]
            enc = self._enc(name, tok)
            new_enc = torch.where(mask[None, :], enc, broadcast_average(enc_avg, b))
            new_dec = self._dec(name, new_enc)
            if variant == "zero":
                out = new_dec
            elif variant == "mean":
                out = new_dec + broadcast_average(err_avg, b)
            elif variant == "circuit":
                err = tok - self._dec(name, enc)
                err_mean = broadcast_average(err_avg, b) * torch.ones_like(err)
                out = new_dec + torch.where(err_keep, err, err_mean)
            else:
                raise ValueError(variant)
            return act_from_tokens(out, act.shape) if tr else out

        return sp

    def _loss(self, images, labels, splice=None) -> torch.Tensor:
        logits, _, _ = self.net.apply(self.params, images, state=self.state, splice=splice)
        return self.criterion(logits, labels)

    @torch.no_grad()
    def _faithfulness_batch(self, images, labels, feat_masks, err_keep, enc_avg, err_avg):
        def run(variant, masks, keep=None):
            return self._loss(images, labels, {
                n: self._sae_splice(n, masks[n], enc_avg[n], err_avg[n], variant,
                                    None if keep is None else keep[n])
                for n in self.layers})

        empty = {n: torch.zeros_like(feat_masks[n]) for n in self.layers}
        return {
            "m_C_zero": run("zero", feat_masks),
            "m_C_mean": run("mean", feat_masks),
            "m_C": run("circuit", feat_masks, err_keep),
            "m_empty": run("mean", empty),
            "m_M": self._loss(images, labels),
        }

    @torch.no_grad()
    def _faithfulness_model_batch(self, images, labels, neuron_masks, out_avg):
        """Model-neuron circuit variant: mean-ablate raw channels below
        threshold."""

        def make_sp(name, mask):
            def sp(act):
                tok, tr = tokens_from_act(act)
                avg_tok = broadcast_average(out_avg[name], act.shape[0])
                out = torch.where(mask[None, :], tok, avg_tok)
                return act_from_tokens(out, act.shape) if tr else out

            return sp

        def run(masks):
            return self._loss(images, labels, {n: make_sp(n, masks[n]) for n in self.layers})

        empty = {n: torch.zeros_like(neuron_masks[n]) for n in self.layers}
        return {"m_C": run(neuron_masks), "m_empty": run(empty),
                "m_M": self._loss(images, labels)}

    def compute_faithfulness(
        self,
        data: Iterable,
        node_ie: NodeIE,
        feature_threshold: float,
        model_or_sae: str = "sae",
        *,
        averages: Averages,
    ) -> dict:
        """Faithfulness = (m(C) - m(empty)) / (m(M) - m(empty)) with the zero- /
        mean- / original-error circuit variants; the error nodes are held to the
        feature threshold; batch losses averaged with equal batch weight."""
        feat_masks, err_keep, neuron_masks = self.circuit_masks(node_ie, feature_threshold)
        acc: dict = {}
        batch_idx = 0
        for images, labels in data:
            batch_idx += 1
            if model_or_sae == "sae":
                m = self._faithfulness_batch(images, labels, feat_masks, err_keep,
                                             averages.enc, averages.err)
            else:
                m = self._faithfulness_model_batch(images, labels, neuron_masks,
                                                   averages.out)
            for k, v in m.items():
                acc[k] = running_mean(acc.get(k), v, batch_idx - 1, 1)

        denom = acc["m_M"] - acc["m_empty"]
        result = {
            "feature_node_threshold": float(feature_threshold),
            "error_node_threshold": float(feature_threshold),
            "faithfulness": float((acc["m_C"] - acc["m_empty"]) / denom),
            "m_C": float(acc["m_C"]),
            "m_empty": float(acc["m_empty"]),
            "m_M": float(acc["m_M"]),
        }
        if model_or_sae == "sae":
            result["faithfulness_sae_errors_zero_ablated"] = float(
                (acc["m_C_zero"] - acc["m_empty"]) / denom)
            result["faithfulness_sae_errors_mean_ablated"] = float(
                (acc["m_C_mean"] - acc["m_empty"]) / denom)
            result["num_feature_nodes"] = {n: int(feat_masks[n].sum()) for n in self.layers}
            result["num_error_nodes"] = int(sum(bool(err_keep[n]) for n in self.layers))
        return result
