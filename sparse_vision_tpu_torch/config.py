"""Typed run configuration: the port's own copy of sparse_vision_tpu/config.py
(RunConfig with the same field names, defaults and JSON round trip; the
reference's 24-field parameters.txt and 17-field parameters_eval.txt lines both
ways; Sweep, the cartesian-product sweep, and read_jsonl; the image size
tables). The port supports a subset of the values; train/pipeline.py raises
NotImplementedError, naming the field, for any value outside it.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from dataclasses import dataclass, field
from typing import Any, Iterator

# Field order of a legacy parameters.txt line (specify_parameters.py:250-272 + the
# trailing sae_checkpoint_epoch appended at :287-293).
LEGACY_FIELDS = (
    "model_name",
    "sae_model_name",
    "sae_layer",
    "directory_path",
    "wandb_status",
    "model_epochs",
    "model_learning_rate",
    "batch_size",
    "model_optimizer_name",
    "sae_epochs",
    "sae_learning_rate",
    "sae_optimizer_name",
    "sae_batch_size",
    "sae_lambda_sparse",
    "sae_expansion_factor",
    "dataset_name",
    "training",
    "original_model",
    "model_criterion_name",
    "sae_criterion_name",
    "dead_neurons_steps",
    "mis",
    "compute_ie",
    "sae_checkpoint_epoch",
)


# Field order of a legacy parameters_eval.txt line (specify_parameters.py:296-312):
# the 24-field schema minus sae_lambda_sparse, sae_expansion_factor, training,
# criteria, mis, and compute_ie — one line identifies a SWEEP's results file, not a
# single run.
LEGACY_EVAL_FIELDS = (
    "model_name",
    "sae_model_name",
    "sae_layer",
    "directory_path",
    "wandb_status",
    "model_epochs",
    "model_learning_rate",
    "batch_size",
    "model_optimizer_name",
    "sae_epochs",
    "sae_learning_rate",
    "sae_optimizer_name",
    "sae_batch_size",
    "dataset_name",
    "original_model",
    "dead_neurons_steps",
    "sae_checkpoint_epoch",
)


def _fmt_legacy(v: Any) -> str:
    if isinstance(v, bool):
        return "True" if v else "False"
    return str(v)


def _parse_bool(s: str) -> bool:
    # The reference uses eval("True") (execute_project.py:40-64); we parse strictly.
    if s in ("True", "true", "1"):
        return True
    if s in ("False", "false", "0"):
        return False
    raise ValueError(f"Not a boolean literal: {s!r}")


@dataclass(frozen=True)
class RunConfig:
    """One run of the pipeline; see the JAX package's RunConfig for every field."""

    # --- reference-parity fields ---
    model_name: str = "custom_mlp_9"
    sae_model_name: str = "sae_mlp"
    sae_layer: str = "fc1"
    directory_path: str = "runs"
    wandb_status: bool = False
    model_epochs: int = 1
    model_learning_rate: float = 1e-3
    batch_size: int = 64
    model_optimizer_name: str = "adam"
    sae_epochs: int = 1
    sae_learning_rate: float = 1e-3
    sae_optimizer_name: str = "constrained_adam"
    sae_batch_size: int = 64
    sae_lambda_sparse: float = 0.1
    sae_expansion_factor: int = 2
    dataset_name: str = "mnist"
    training: bool = True
    original_model: bool = False
    model_criterion_name: str = "cross_entropy"
    sae_criterion_name: str = "sae_loss"
    dead_neurons_steps: int = 200
    mis: str = "0"
    compute_ie: str = "0"
    sae_checkpoint_epoch: int = 0

    # --- extensions of the JAX package ---
    data_dir: str = ""  # "" -> synthetic data
    mesh_shape: tuple = ()
    sae_topk: int = 32
    sae_aux_k: int = 0
    sae_aux_alpha: float = 0.03125
    jumprelu_bandwidth: float = 1e-3
    jumprelu_threshold_init: float = 1e-3
    sae_matryoshka_prefixes: str = "0.0625,0.25,1.0"
    sae_topk_approx: bool = False
    # matmul dtype inside the fused kernels (accumulation always f32)
    compute_dtype: str = "bfloat16"
    seed: int = 0
    use_pallas: bool = True  # use the fused SAE kernels where available
    log_every: int = 100
    profile_dir: str = ""
    imagenet_class_filter: str = ""
    use_activation_cache: bool = False
    cache_tokens_per_step: int = 4096
    sae_e2e_finetune_epochs: int = 0
    sae_e2e_alpha_mse: float = 0.0
    transcoder_target_layer: str = ""
    crosscoder_layers: str = ""
    cache_dtype: str = "float32"  # "float32" | "bfloat16" | "int8"
    overlap_dump_train: bool = False
    data_workers: int = -1
    sae_weights_path: str = ""
    eval_batch_size: int = 0  # 0 -> sae_batch_size, clamped (Pipeline)
    sae_input_norm: str = "none"
    ie_top_features: int = 16
    ie_cotangent_chunk: int = 64

    @property
    def use_sae(self) -> bool:
        return not self.original_model

    @property
    def matryoshka_prefix_fractions(self) -> tuple:
        return tuple(float(f) for f in self.sae_matryoshka_prefixes.split(",") if f)

    @property
    def crosscoder_layer_list(self) -> tuple:
        """The additional crosscoder layers (sae_layer is the anchor and is not
        repeated here)."""
        return tuple(s.strip() for s in self.crosscoder_layers.split(",") if s.strip())

    # ---- legacy conversion -------------------------------------------------
    @classmethod
    def from_legacy_line(cls, line: str, **overrides: Any) -> "RunConfig":
        """Parse one comma-separated parameters.txt line (reference: main.py:86-111)."""
        values = [v.strip() for v in line.strip().split(",")]
        if len(values) != len(LEGACY_FIELDS):
            raise ValueError(
                f"Expected {len(LEGACY_FIELDS)} fields, got {len(values)}: {line!r}"
            )
        raw = dict(zip(LEGACY_FIELDS, values))
        kwargs: dict[str, Any] = dict(
            model_name=raw["model_name"],
            sae_model_name=raw["sae_model_name"],
            sae_layer=raw["sae_layer"],
            directory_path=raw["directory_path"],
            wandb_status=_parse_bool(raw["wandb_status"]),
            model_epochs=int(raw["model_epochs"]),
            model_learning_rate=float(raw["model_learning_rate"]),
            batch_size=int(raw["batch_size"]),
            model_optimizer_name=raw["model_optimizer_name"],
            sae_epochs=int(raw["sae_epochs"]),
            sae_learning_rate=float(raw["sae_learning_rate"]),
            sae_optimizer_name=raw["sae_optimizer_name"],
            sae_batch_size=int(raw["sae_batch_size"]),
            sae_lambda_sparse=float(raw["sae_lambda_sparse"]),
            sae_expansion_factor=int(raw["sae_expansion_factor"]),
            dataset_name=raw["dataset_name"],
            training=_parse_bool(raw["training"]),
            original_model=_parse_bool(raw["original_model"]),
            model_criterion_name=raw["model_criterion_name"],
            sae_criterion_name=raw["sae_criterion_name"],
            dead_neurons_steps=int(raw["dead_neurons_steps"]),
            mis=raw["mis"],
            compute_ie=raw["compute_ie"],
            sae_checkpoint_epoch=int(raw["sae_checkpoint_epoch"]),
        )
        kwargs.update(overrides)
        return cls(**kwargs)

    @classmethod
    def from_legacy_eval_line(cls, line: str, **overrides: Any) -> "RunConfig":
        """Parse one 17-field parameters_eval.txt line (the reference's separate
        eval-sweep spec: specify_parameters.py:296-322, consumed by main.py:117-155).
        Eval-only fields default to a frozen-SAE evaluation run."""
        values = [v.strip() for v in line.strip().split(",")]
        if len(values) != len(LEGACY_EVAL_FIELDS):
            raise ValueError(
                f"Expected {len(LEGACY_EVAL_FIELDS)} fields, got {len(values)}: {line!r}"
            )
        raw = dict(zip(LEGACY_EVAL_FIELDS, values))
        kwargs: dict[str, Any] = dict(
            model_name=raw["model_name"],
            sae_model_name=raw["sae_model_name"],
            sae_layer=raw["sae_layer"],
            directory_path=raw["directory_path"],
            wandb_status=_parse_bool(raw["wandb_status"]),
            model_epochs=int(raw["model_epochs"]),
            model_learning_rate=float(raw["model_learning_rate"]),
            batch_size=int(raw["batch_size"]),
            model_optimizer_name=raw["model_optimizer_name"],
            sae_epochs=int(raw["sae_epochs"]),
            sae_learning_rate=float(raw["sae_learning_rate"]),
            sae_optimizer_name=raw["sae_optimizer_name"],
            sae_batch_size=int(raw["sae_batch_size"]),
            dataset_name=raw["dataset_name"],
            original_model=_parse_bool(raw["original_model"]),
            dead_neurons_steps=int(raw["dead_neurons_steps"]),
            sae_checkpoint_epoch=int(raw["sae_checkpoint_epoch"]),
            training=False,
        )
        kwargs.update(overrides)
        return cls(**kwargs)

    def to_legacy_line(self) -> str:
        return ",".join(_fmt_legacy(getattr(self, f)) for f in LEGACY_FIELDS)

    def to_legacy_eval_line(self) -> str:
        return ",".join(_fmt_legacy(getattr(self, f)) for f in LEGACY_EVAL_FIELDS)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["mesh_shape"] = list(self.mesh_shape)
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "RunConfig":
        d = json.loads(s)
        d["mesh_shape"] = tuple(d.get("mesh_shape", ()))
        return cls(**d)


@dataclass
class Sweep:
    """Cartesian-product sweep over RunConfig fields.

    Typed replacement for specify_parameters.py (reference: :250-293); validation rules
    mirrored from :222-236 (e.g. MIS/IE only meaningful with a frozen SAE, not during
    original-model training).
    """

    axes: dict = field(default_factory=dict)  # field name -> list of values
    base: RunConfig = field(default_factory=RunConfig)

    def __iter__(self) -> Iterator[RunConfig]:
        names = list(self.axes)
        for combo in itertools.product(*(self.axes[n] for n in names)):
            cfg = dataclasses.replace(self.base, **dict(zip(names, combo)))
            self.validate(cfg)
            yield cfg

    @staticmethod
    def validate(cfg: RunConfig) -> None:
        if cfg.original_model and cfg.compute_ie != "0":
            # reference guard: specify_parameters.py:229-230
            raise ValueError("IE can only be computed for the SAE model, not the original model.")
        if cfg.compute_ie != "0" and cfg.training:
            raise ValueError("IE is computed on a frozen SAE, not during training.")
        if cfg.mis != "0" and cfg.training:
            raise ValueError("MIS is computed on a frozen SAE, not during training.")

    def write_jsonl(self, path: str) -> int:
        n = 0
        with open(path, "w") as f:
            for cfg in self:
                f.write(cfg.to_json() + "\n")
                n += 1
        return n

    def write_legacy(self, path: str) -> int:
        n = 0
        with open(path, "w") as f:
            for cfg in self:
                f.write(cfg.to_legacy_line() + "\n")
                n += 1
        return n

    def write_legacy_eval(self, path: str) -> int:
        """Write the companion eval-sweep file (the parameters_eval.txt role,
        specify_parameters.py:296-322): the DISTINCT 17-field combos of the sweep —
        per-λ/per-k runs of one sweep share one results CSV, so they collapse to one
        eval line."""
        seen: list[str] = []
        for cfg in self:
            line = cfg.to_legacy_eval_line()
            if line not in seen:
                seen.append(line)
        with open(path, "w") as f:
            for line in seen:
                f.write(line + "\n")
        return len(seen)


def read_jsonl(path: str) -> list[RunConfig]:
    with open(path) as f:
        return [RunConfig.from_json(line) for line in f if line.strip()]


# Image sizes per dataset, channels-last (reference get_img_size, utils.py:139-149)
IMG_SIZES = {
    "tiny_imagenet": (64, 64, 3),
    "cifar_10": (32, 32, 3),
    "mnist": (28, 28, 1),
    "imagenet": (229, 229, 3),  # the lucent-InceptionV1 crop (utils.py:318-329)
    "synthetic": (28, 28, 1),
}

NUM_CLASSES = {
    "tiny_imagenet": 200,
    "cifar_10": 10,
    "mnist": 10,
    "imagenet": 1000,
    "synthetic": 10,
}


def is_vit_family(model_name: str) -> bool:
    """True for the ViT/CLIP tower specs (optionally '_split'-suffixed)."""
    base = model_name[:-6] if model_name.endswith("_split") else model_name
    return base.startswith("vit_") or base.startswith("clip_vit")


def get_img_size(dataset_name: str, model_name: str | None = None) -> tuple:
    """Input image shape, channels-last; ViT/CLIP towers take 224 px on ImageNet."""
    if dataset_name not in IMG_SIZES:
        raise ValueError(f"Unsupported dataset: {dataset_name}")
    size = IMG_SIZES[dataset_name]
    if model_name and is_vit_family(model_name) and size[0] == 229:
        return (224, 224, 3)
    return size
