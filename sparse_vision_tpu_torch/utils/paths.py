"""Deterministic run-ID and file-path scheme (the port's own copy of
sparse_vision_tpu/utils/paths.py, on the port's RunConfig).

A run is named by the joined values of its parameter dicts; the checkpoint name
leaves ``sae_epochs`` out, so a run resumed with more epochs maps onto the same
files.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

from sparse_vision_tpu_torch.config import RunConfig


def join_params(params: Mapping) -> str:
    return "_".join("None" if v is None else str(v) for v in params.values())


def get_file_path(
    folder_path: Optional[str] = None,
    sae_layer: Optional[str] = None,
    params: Optional[Mapping | str] = None,
    file_name: Optional[str] = None,
    params2: Optional[Mapping | str] = None,
) -> str:
    """``<sae_layer>_<params>[_<params2>]_<file_name>`` (a ``file_name`` that
    starts with "." is an extension, appended as it is), inside ``folder_path``
    when given, which is created."""
    if file_name is not None and file_name.startswith("."):
        ending = file_name
    else:
        ending = f"_{file_name}"

    if folder_path is not None:
        os.makedirs(folder_path, exist_ok=True)

    if params is not None:
        if isinstance(params, Mapping):
            params = join_params(params)
        if params2 is not None:
            if isinstance(params2, Mapping):
                params2 = join_params(params2)
            name = f"{sae_layer}_{params}_{params2}{ending}"
        else:
            name = f"{sae_layer}_{params}{ending}"
    else:
        name = f"{sae_layer}{ending}"

    return name if folder_path is None else os.path.join(folder_path, name)


def model_params_dict(cfg: RunConfig) -> dict:
    return {
        "model_name": cfg.model_name,
        "epochs": cfg.model_epochs,
        "learning_rate": cfg.model_learning_rate,
        "batch_size": cfg.batch_size,
        "optimizer": cfg.model_optimizer_name,
    }


def sae_params_dict(cfg: RunConfig) -> dict:
    d = {
        "sae_model_name": cfg.sae_model_name,
        "sae_epochs": cfg.sae_epochs,
        "learning_rate": cfg.sae_learning_rate,
        "batch_size": cfg.sae_batch_size,
        "optimizer": cfg.sae_optimizer_name,
        "expansion_factor": cfg.sae_expansion_factor,
        "lambda_sparse": cfg.sae_lambda_sparse,
        "dead_neurons_steps": cfg.dead_neurons_steps,
    }
    # a transcoder's target layer and a crosscoder's layer set are part of the
    # run's identity, so two such runs from one sae_layer never share files
    if cfg.transcoder_target_layer:
        d["sae_model_name"] = f"{cfg.sae_model_name}-to-{cfg.transcoder_target_layer}"
    if cfg.crosscoder_layers:
        extra = "+".join(cfg.crosscoder_layer_list)
        d["sae_model_name"] = f"{d['sae_model_name']}-x-{extra}"
    return d


def sae_params_no_epochs(cfg: RunConfig) -> dict:
    """sae_params_dict without ``sae_epochs``: checkpoints and run IDs stay the
    same when a run resumes with another epoch count."""
    d = sae_params_dict(cfg)
    d.pop("sae_epochs", None)
    return d


def sae_run_name(cfg: RunConfig) -> str:
    """``<sae_layer>_<sae_params_no_epochs>``: the name of a run's checkpoint
    folder, weight exports and decoder-norm CSV."""
    return f"{cfg.sae_layer}_" + join_params(sae_params_no_epochs(cfg))


def run_id(cfg: RunConfig) -> str:
    """The run's identifier: the backbone's parameters, then the SAE's."""
    if cfg.use_sae:
        return get_file_path(
            sae_layer=cfg.sae_layer,
            params=model_params_dict(cfg),
            params2=sae_params_no_epochs(cfg),
            file_name=None,
        ).removesuffix("_None")
    return get_file_path(
        sae_layer=cfg.sae_layer, params=model_params_dict(cfg), file_name=None
    ).removesuffix("_None")


def folder_paths(cfg: RunConfig) -> dict:
    """The run's output folders under ``<directory_path>/<model>/<dataset>``."""
    base = os.path.join(cfg.directory_path, cfg.model_name, cfg.dataset_name)
    return {
        "model_weights": os.path.join(base, "model_weights"),
        "sae_weights": os.path.join(base, f"sae_weights_{cfg.sae_model_name}"),
        "evaluation_results": os.path.join(base, f"evaluation_results_{cfg.sae_model_name}"),
        "checkpoints": os.path.join(base, f"checkpoints_{cfg.sae_model_name}"),
        "ie_related_quantities": os.path.join(
            base, f"ie_related_quantities_{cfg.sae_model_name}"),
    }
