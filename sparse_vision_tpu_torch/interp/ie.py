"""IE run orchestration: wires the Pipeline to the CircuitEngine and keeps the
artifacts (port of sparse_vision_tpu/interp/ie.py for GoogLeNet).

Modes (cfg.compute_ie), each a Pipeline.run of its own, files under the run's
``ie_related_quantities`` folder with the JAX package's names and .npz keys (a
file written by one package drives the other):
  "1"   dataset averages per layer -> averages.npz, perc_dead_units.csv,
        sparsity.csv
  "2"   node IE                    -> node_ie.npz (needs averages)
  "3"   edge IE                    -> edge_ie.npz (needs averages and node IE)
  "4i"  faithfulness at FAITHFULNESS_THRESHOLDS[i] -> faithfulness.csv rows for
        the SAE-circuit and the model-neuron variants, and faithfulness.png,
        the SAE variant's curves over every threshold in the CSV (drawn with
        PIL, eval_tools/draw.py, where the JAX package uses matplotlib).

On GoogLeNet the circuit spans the eight CIRCUIT_LAYERS, each with its frozen
SAE from the registry; on any other backbone it is the one layer
``cfg.sae_layer`` with the pipeline's own SAE.
"""

from __future__ import annotations

import csv
import os
import numpy as np
import torch

from sparse_vision_tpu_torch.data.labels import remap_torch_to_tf_labels
from sparse_vision_tpu_torch.data.prefetch import prefetch
from sparse_vision_tpu_torch.device import resolve_device
from sparse_vision_tpu_torch.interp.circuit import (
    FAITHFULNESS_THRESHOLDS,
    Averages,
    CircuitEngine,
    FrozenSAE,
    NodeIE,
)
from sparse_vision_tpu_torch.interp.registry import (
    CIRCUIT_LAYERS,
    layer_ckpt_dir,
    load_frozen_sae,
)
from sparse_vision_tpu_torch.models.backbone import layer_dimensions
from sparse_vision_tpu_torch.ops.metrics import perc_dead

GOOGLENET = ("inceptionv1", "googlenet")
# the files each mode writes, in the run's ie_related_quantities folder
MODE_FILES = {"1": ("averages.npz", "perc_dead_units.csv", "sparsity.csv"),
              "2": ("node_ie.npz",), "3": ("edge_ie.npz",),
              "4": ("faithfulness.csv", "faithfulness.png")}


def _ie_dir(pipeline) -> str:
    d = pipeline.paths["ie_related_quantities"]
    os.makedirs(d, exist_ok=True)
    return d


def build_engine(pipeline) -> CircuitEngine:
    """The engine over the pipeline's frozen backbone. On GoogLeNet: the
    registry's eight SAEs, each restored from the checkpoint directory where
    the pipeline saves a run with the registry's hyperparameters (a random SAE
    where none is). Elsewhere: one SAE at ``cfg.sae_layer``, the pipeline's own
    parameters (a restored checkpoint's with ``sae_checkpoint_epoch``)."""
    cfg = pipeline.cfg
    if cfg.model_name not in GOOGLENET:
        params = {k: v.detach() for k, v in pipeline.ts.params.items()}
        saes = {cfg.sae_layer: FrozenSAE(cfg.sae_model_name, params, cfg.sae_expansion_factor)}
        return CircuitEngine(pipeline.net, pipeline.frozen_params, saes, pipeline.criterion,
                             state=pipeline.net_state)
    dims = layer_dimensions(pipeline.net, cfg.dataset_name)
    saes, missing = {}, []
    for name in CIRCUIT_LAYERS:
        ckpt_dir = layer_ckpt_dir(pipeline.paths["checkpoints"], name, cfg.sae_model_name)
        has_ckpt = os.path.isdir(ckpt_dir)
        if not has_ckpt:
            missing.append(name)
        saes[name] = load_frozen_sae(name, dims[name][-1], cfg.sae_model_name,
                                     checkpoint_dir=ckpt_dir if has_ckpt else None,
                                     device=pipeline.device)
    if missing:
        print("WARNING: no trained SAE checkpoints for layers "
              f"{missing} under {pipeline.paths['checkpoints']} — circuit "
              "discovery will run on RANDOMLY-INITIALIZED SAEs and produce "
              "meaningless artifacts. Train per-layer SAEs first.")
    return CircuitEngine(pipeline.net, pipeline.frozen_params, saes, pipeline.criterion,
                         state=pipeline.net_state)


def check_labels(classes: np.ndarray, translated: torch.Tensor, num_classes: int) -> None:
    """Raise ValueError, naming the class, if a translated label lies outside
    the head's ``num_classes`` logits: the loss of such a batch is not a number
    (a device-side assert on CUDA)."""
    bad = ((translated < 0) | (translated >= num_classes)).numpy()
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        raise ValueError(
            f"ImageNet class {int(classes[i])} translates to GoogLeNet label "
            f"{int(translated[i])}, outside the head's {num_classes} logits "
            f"(0..{num_classes - 1}); the loss of its batch would not be a number")


def _batches(pipeline):
    """The train dataset in ``sae_batch_size`` batches, in order (decoded by
    ``cfg.data_workers`` threads where it is file-backed), labels
    translated to GoogLeNet's old-convention ids on ImageNet and checked on the
    host before the batch is staged onto the device through data/prefetch.py."""
    cfg = pipeline.cfg
    translate = cfg.model_name in GOOGLENET and cfg.dataset_name == "imagenet"
    head = layer_dimensions(pipeline.net, cfg.dataset_name)[pipeline.net.stage_names[-1]][-1]

    def host():
        for b in pipeline.train_ds.batches(cfg.sae_batch_size, shuffle=False,
                                           workers=cfg.data_workers):
            labels = torch.from_numpy(b.labels)
            if translate:
                labels = remap_torch_to_tf_labels(labels)
                check_labels(b.labels, labels, head)
            yield b.images, labels

    return prefetch(host(), pipeline.device)


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------

def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_averages(path: str, avgs: Averages) -> None:
    arrays = {}
    for name in avgs.enc:
        arrays[f"enc:{name}"] = _np(avgs.enc[name])
        arrays[f"err:{name}"] = _np(avgs.err[name])
        arrays[f"out:{name}"] = _np(avgs.out[name])
        arrays[f"dead:{name}"] = _np(avgs.dead[name])
        arrays[f"sparsity:{name}"] = _np(avgs.sparsity[name])
    np.savez(path, **arrays)


def _layers(z) -> list:
    return sorted({k.split(":", 1)[1] for k in z.files})


def load_averages(path: str, device=None) -> Averages:
    """The averages of ``path`` as tensors on ``device`` (None means CUDA)."""
    device = resolve_device(device)
    with np.load(path) as z:
        names = _layers(z)

        def get(key):
            return {n: torch.from_numpy(z[f"{key}:{n}"]).to(device) for n in names}

        return Averages(enc=get("enc"), err=get("err"), out=get("out"), dead=get("dead"),
                        sparsity={n: float(z[f"sparsity:{n}"]) for n in names})


def save_node_ie(path: str, node: NodeIE) -> None:
    arrays = {}
    for name in node.features:
        arrays[f"features:{name}"] = _np(node.features[name])
        arrays[f"error:{name}"] = _np(node.error[name])
        arrays[f"model_neurons:{name}"] = _np(node.model_neurons[name])
    np.savez(path, **arrays)


def load_node_ie(path: str, device=None) -> NodeIE:
    """The node IE of ``path`` as tensors on ``device`` (None means CUDA)."""
    device = resolve_device(device)
    with np.load(path) as z:
        names = _layers(z)

        def get(key):
            return {n: torch.from_numpy(z[f"{key}:{n}"]).to(device) for n in names}

        return NodeIE(features=get("features"), error=get("error"),
                      model_neurons=get("model_neurons"))


# ---------------------------------------------------------------------------
# mode dispatch
# ---------------------------------------------------------------------------

def run_ie(pipeline, flag: str):
    """Run the mode ``flag``; returns the Averages, the NodeIE, the edge
    matrices by upstream layer, or the faithfulness rows."""
    cfg = pipeline.cfg
    eng = build_engine(pipeline)
    d = _ie_dir(pipeline)
    paths = {m: [os.path.join(d, f) for f in files] for m, files in MODE_FILES.items()}
    avg_path, dead_path, sparsity_path = paths["1"]
    (node_path,), (edge_path,), (faith_path, faith_png) = paths["2"], paths["3"], paths["4"]

    if flag == "1":
        avgs = eng.compute_averages(_batches(pipeline))
        save_averages(avg_path, avgs)
        with open(dead_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["Layer", "Percentage dead units"])
            for n in eng.layers:
                w.writerow([n, float(perc_dead(avgs.dead[n]))])
        with open(sparsity_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["Layer", "Sparsity"])
            for n in eng.layers:
                w.writerow([n, float(avgs.sparsity[n])])
        return avgs

    avgs = load_averages(avg_path, pipeline.device)

    if flag == "2":
        node = eng.compute_node_ie(_batches(pipeline), avgs)
        save_node_ie(node_path, node)
        return node

    node = load_node_ie(node_path, pipeline.device)

    if flag == "3":
        # the top-|IE| features of the node pass, per layer
        feature_indices = {
            n: [int(i) for i in
                np.argsort(-np.abs(_np(node.features[n])))[:cfg.ie_top_features]]
            for n in eng.layers
        }
        edges = eng.compute_edge_ie(_batches(pipeline), avgs, feature_indices,
                                    cotangent_chunk=cfg.ie_cotangent_chunk)
        np.savez(edge_path,
                 **{n: _np(m) for n, m in edges.items()},
                 **{f"idx:{n}": np.asarray(feature_indices[n]) for n in feature_indices})
        return edges

    if flag.startswith("4"):
        threshold = FAITHFULNESS_THRESHOLDS[int(flag[1:])]
        rows = []
        for variant in ("sae", "model"):
            r = eng.compute_faithfulness(_batches(pipeline), node, threshold,
                                         model_or_sae=variant, averages=avgs)
            r["variant"] = variant
            rows.append(r)
        store_faithfulness(faith_path, rows)
        plot_faithfulness(faith_path, faith_png)
        return rows

    raise ValueError(f"Unknown compute_ie flag: {flag!r}")


FAITHFULNESS_COLUMNS = [
    "variant", "feature_node_threshold", "error_node_threshold",
    "faithfulness_sae_errors_zero_ablated", "faithfulness_sae_errors_mean_ablated",
    "faithfulness", "m_C", "m_empty", "m_M",
]


def store_faithfulness(path: str, rows: list) -> None:
    """Append or update faithfulness rows keyed on (variant, thresholds)."""
    existing: dict = {}
    if os.path.exists(path):
        with open(path) as f:
            for row in csv.DictReader(f):
                existing[(row["variant"], row["feature_node_threshold"],
                          row["error_node_threshold"])] = row
    for r in rows:
        clean = {c: str(r.get(c, "")) for c in FAITHFULNESS_COLUMNS}
        existing[(clean["variant"], clean["feature_node_threshold"],
                  clean["error_node_threshold"])] = clean
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FAITHFULNESS_COLUMNS)
        w.writeheader()
        for key in sorted(existing):
            w.writerow(existing[key])


FAITHFULNESS_CURVES = ("faithfulness_sae_errors_zero_ablated",
                       "faithfulness_sae_errors_mean_ablated", "faithfulness")


def plot_faithfulness(csv_path: str, out_path: str) -> str:
    """The SAE variant's faithfulness against the feature-node threshold, one
    panel per column of FAITHFULNESS_CURVES (20 x 5 in at 150 dpi, as the
    JAX figure). A row whose cell is empty is left out of that panel, its
    (threshold, value) pair together."""
    from sparse_vision_tpu_torch.eval_tools.draw import Figure

    with open(csv_path) as f:
        rows = [r for r in csv.DictReader(f) if r["variant"] == "sae"]
    rows.sort(key=lambda r: float(r["feature_node_threshold"]))
    fig = Figure((20, 5), dpi=150)
    for ax, col in zip(fig.grid(1, 3), FAITHFULNESS_CURVES):
        pairs = [(float(r["feature_node_threshold"]), float(r[col]))
                 for r in rows if r[col] != ""]
        xs, ys = (np.asarray([p[i] for p in pairs], np.float64) for i in (0, 1))
        ok = np.isfinite(xs) & np.isfinite(ys)
        xs, ys = xs[ok], ys[ok]
        ax.axes(col, "Feature node threshold", "Faithfulness",
                (xs.min(), xs.max()) if len(xs) else (0.0, 1.0),
                (ys.min(), ys.max()) if len(ys) else (0.0, 1.0))
        ax.line(xs, ys)
        ax.legend([(col, "#1f77b4")])
    return fig.save(out_path)
