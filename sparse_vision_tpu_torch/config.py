"""Typed run configuration: the port's own copy of sparse_vision_tpu/config.py
(RunConfig with the same field names, defaults and JSON round trip; the image
size tables). The port supports a subset of the values; train/pipeline.py
raises NotImplementedError, naming the field, for any value outside it.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass


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
    def matryoshka_prefix_fractions(self) -> tuple:
        return tuple(float(f) for f in self.sae_matryoshka_prefixes.split(",") if f)

    @property
    def crosscoder_layer_list(self) -> tuple:
        """The additional crosscoder layers (sae_layer is the anchor and is not
        repeated here)."""
        return tuple(s.strip() for s in self.crosscoder_layers.split(",") if s.strip())

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["mesh_shape"] = list(self.mesh_shape)
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "RunConfig":
        d = json.loads(s)
        d["mesh_shape"] = tuple(d.get("mesh_shape", ()))
        return cls(**d)


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
