"""Multi-layer SAE and transcoder training from one backbone pass (port of
sparse_vision_tpu/train/multilayer.py).

The circuit tier needs one frozen SAE per circuit layer (interp/registry.py).
``SeqNet.apply`` returns every stage's output up to ``stop_at``, so one
``dump_activations_multi`` call taps every missing layer from a single forward
(the backbone's cost is paid once per call, whatever the layer count), and each
layer's dictionary then trains from its own cache through ``Pipeline.run``. The
per-layer caches, run IDs, checkpoints and results are those of the layers run
one at a time, so the registry, the circuit passes and resume read them
unchanged.

The caches live under each Pipeline's ``evaluation_results_<sae_model_name>``
folder, so an SAE call and a transcoder call make one dump each; a second call
of either dumps nothing. Every layer shares the base config's dump geometry
(``cache_tokens_per_step``, ``sae_epochs``, the cache dtype): at a fixed T a
layer with fewer tokens an image takes fewer steps an epoch.

``pipeline_kwargs`` (``device``, ``datasets``, ``backbone``) go to every
Pipeline these functions build, as ``Pipeline.__init__`` takes them; the JAX
functions have none.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

from sparse_vision_tpu_torch.config import RunConfig
from sparse_vision_tpu_torch.interp.registry import CIRCUIT_LAYERS, LAYER_SAE_CONFIGS


def layer_config(base_cfg: RunConfig, layer: str, use_registry: bool = True) -> RunConfig:
    """``base_cfg`` retargeted at ``layer``, with the registry's known-good
    hyperparameters when ``use_registry`` and the layer has them. The epoch
    count, the dataset, the model and the cache settings stay base-level, so
    every layer shares one dump geometry."""
    overrides: dict = {"sae_layer": layer, "original_model": False, "training": True,
                       "use_activation_cache": True}
    if use_registry and layer in LAYER_SAE_CONFIGS:
        reg = LAYER_SAE_CONFIGS[layer]
        overrides.update(
            sae_expansion_factor=reg.expansion_factor,
            sae_lambda_sparse=reg.lambda_sparse,
            dead_neurons_steps=reg.dead_neurons_steps,
            sae_learning_rate=reg.learning_rate,
            sae_optimizer_name=reg.optimizer,
            # the batch size is part of the registry recipe and of the
            # checkpoint folder's name that registry.layer_ckpt_dir rebuilds:
            # left at the base value, the trained folder and the one the
            # circuit passes load would differ
            sae_batch_size=reg.batch_size,
        )
    return dataclasses.replace(base_cfg, **overrides)


def _dump_missing(p0, layers: Sequence[str]) -> list:
    """One backbone pass of ``p0``'s dump settings for every layer of ``layers``
    whose cache is missing; returns those layers."""
    from sparse_vision_tpu_torch.data.activation_cache import dump_activations_multi

    unknown = [l for l in layers if l.split(".")[0] not in p0.net.stage_names]
    if unknown:
        raise ValueError(f"Layers {unknown} not in backbone stages {p0.net.stage_names}")
    missing = [l for l in layers
               if not os.path.exists(os.path.join(p0._cache_dir(l), "meta.json"))]
    if missing:
        print(f"Building activation caches for {missing} in one backbone pass ...")
        dump_activations_multi(p0.net, p0.frozen_params, p0.net_state, p0.train_ds, missing,
                               {l: p0._cache_dir(l) for l in missing}, device=p0.device,
                               **p0._cache_dump_kwargs())
    return missing


def train_saes_multilayer(base_cfg: RunConfig, layers: Optional[Sequence[str]] = None,
                          use_registry: bool = True, **pipeline_kwargs) -> dict:
    """Dump every missing layer cache in one backbone pass, then train one SAE
    per layer from its cache. Returns {layer: the last eval's means}.

    ``layers`` defaults to the circuit layers of the backbone
    (interp/registry.CIRCUIT_LAYERS among its stages). With ``use_registry``
    each layer trains at its registry hyperparameters, otherwise at
    ``base_cfg``'s."""
    from sparse_vision_tpu_torch.train.pipeline import Pipeline

    def pipeline(layer):
        return Pipeline(layer_config(base_cfg, layer, use_registry), **pipeline_kwargs)

    layers = list(layers) if layers is not None else []
    first = layers[0] if layers else (
        base_cfg.sae_layer if base_cfg.sae_layer in LAYER_SAE_CONFIGS else CIRCUIT_LAYERS[0])
    p0 = pipeline(first)
    if not layers:
        layers = [l for l in CIRCUIT_LAYERS if l in p0.net.stage_names]
        if not layers:
            raise ValueError(f"No circuit layers found in backbone {base_cfg.model_name!r} "
                             f"(stages: {p0.net.stage_names}); pass layers= explicitly.")
        if layers[0] != first:
            p0 = pipeline(layers[0])
    _dump_missing(p0, layers)
    results = {}
    for layer in layers:
        pipe = p0 if layer == layers[0] else pipeline(layer)
        print(f"Training SAE on layer {layer} from cache ...")
        results[layer] = pipe.run()
    return results


def transcoder_pairs(net, dataset_name: str,
                     layers: Optional[Sequence[str]] = None) -> list:
    """Consecutive entries of ``layers`` (default: the backbone's circuit
    layers) whose spatial dims match. A transcoder maps one token to one token,
    so pairs across a pooling boundary (GoogLeNet mixed3b -> mixed4a) are left
    out."""
    from sparse_vision_tpu_torch.models.backbone import layer_dimensions

    if layers is None:
        layers = [l for l in CIRCUIT_LAYERS if l in net.stage_names]
    dims = layer_dimensions(net, dataset_name)
    return [(a, b) for a, b in zip(layers, layers[1:]) if dims[a][:-1] == dims[b][:-1]]


def pair_config(base_cfg: RunConfig, a: str, b: str, use_registry: bool = True) -> RunConfig:
    """The transcoder a -> b's RunConfig: ``a``'s layer config (its registry
    hyperparameters with ``use_registry``) with ``transcoder_target_layer=b``."""
    return dataclasses.replace(layer_config(base_cfg, a, use_registry),
                               sae_model_name="transcoder", transcoder_target_layer=b)


def train_transcoders_multilayer(base_cfg: RunConfig, pairs: Optional[Sequence[tuple]] = None,
                                 use_registry: bool = True, **pipeline_kwargs) -> dict:
    """Train a transcoder for every pair, all paired caches from one backbone
    pass. ``pairs`` defaults to transcoder_pairs over the backbone's circuit
    layers (GoogLeNet: 3a->3b, 4b->4c->4d->4e, 5a->5b). With ``use_registry``
    each pair trains at its input layer's registry hyperparameters. Returns
    {(in_layer, out_layer): the last eval's means}."""
    from sparse_vision_tpu_torch.models.backbone import make_backbone
    from sparse_vision_tpu_torch.train.pipeline import Pipeline

    if pairs is None:
        pairs = transcoder_pairs(make_backbone(base_cfg.model_name, base_cfg.dataset_name),
                                 base_cfg.dataset_name)
        if not pairs:
            raise ValueError(f"No same-geometry consecutive circuit pairs in "
                             f"{base_cfg.model_name!r}; pass pairs= explicitly.")
    pairs = [tuple(p) for p in pairs]

    def pipeline(pair):
        return Pipeline(pair_config(base_cfg, *pair, use_registry), **pipeline_kwargs)

    p0 = pipeline(pairs[0])
    _dump_missing(p0, list(dict.fromkeys(l for pair in pairs for l in pair)))
    results = {}
    for pair in pairs:
        pipe = p0 if pair == pairs[0] else pipeline(pair)
        print(f"Training transcoder {pair[0]} -> {pair[1]} from caches ...")
        results[pair] = pipe.run()
    return results
