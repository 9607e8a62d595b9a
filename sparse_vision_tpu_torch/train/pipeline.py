"""Run orchestration (port of sparse_vision_tpu/train/pipeline.py).

``Pipeline(cfg).run()`` runs a circuit-discovery mode (``compute_ie``, with
``training=False``: interp/ie.py), an MIS mode (``mis`` "1" collects each
unit's 200 extreme train samples, ``mis_epoch``; "2" scores them,
interp/mis.py), trains (``training``) or runs one standalone eval of a
restored checkpoint. With ``original_model`` the model is the backbone itself:
``train_original`` trains it (the reference's first step) and writes
``model_weights/epoch_<e>``, ``eval_original`` evaluates it, and MIS scores
the channels of the backbone layer that ``sae_layer`` names. Every Pipeline
loads the latest ``model_weights`` checkpoint into its backbone, so the
dictionaries of a directory train on the backbone trained there. Training a
dictionary, ``train_sae``, trains any SAE variant
(``sae_mlp``, ``gated_sae``, ``jumprelu_sae``, ``matryoshka_sae``,
``topk_sae``, ``batch_topk_sae``, ``sae_conv``) in one of the JAX package's
two modes, on any backbone of models/backbone.py (GoogLeNet, ResNet-18/50,
the MLPs and the CNN, the ViT and CLIP towers). With ``use_activation_cache``
(the north-star chain): frozen backbone -> tap ``sae_layer`` -> activation cache -> training on the
variant's fused CUDA kernels on a GPU (their plain versions on the CPU), or on
the TopK family's fast paths (plain torch ops, any shape); sae_conv has no
cached mode. Without it (the JAX default): each step runs the frozen backbone
to the tap, updates the SAE on its stock math and splices the reconstruction
back for the full metrics (train/steps.make_sae_train_step). Both track dead
latents (resampling for sae_mlp, the rolling dead window for the others, the
TopK family's optional AuxK term; batch_topk's threshold by its EMA, then
calibrated at the final parameters on the cached path) and evaluate by
splicing the SAE back into the backbone, before and after each epoch; a
checkpoint after each epoch (train/checkpoint.py), resumable with
``sae_checkpoint_epoch``; the weights exported at the end (train/sae_io.py).
``transcoder`` (from
``sae_layer`` to ``transcoder_target_layer``) and ``crosscoder`` (``sae_layer``
plus ``crosscoder_layers``) train the same way from aligned caches of every
layer they read, dumped in one backbone pass (train/transcoder.py,
train/crosscoder.py). With ``overlap_dump_train`` the first epoch trains on
each shard as the dump publishes it (a dump thread; data/activation_cache.py),
and every batch and stack reaches the device through data/prefetch.py; an int8
cache is dequantized on the device. ``sae_input_norm="rms"`` trains on each
layer's activations divided by its cache's token RMS. Each eval writes the
per-unit top-k file and activity frequencies, and each eval after an epoch its
row of the results CSV (eval_tools/results.py), under the JAX package's file
names (utils/paths.py). Every eval draws the channel-frequency histogram, and
the run's last eval the top-k sample grids and the per-unit activation
histograms (an extra inference pass), with PIL (eval_tools/draw.py) at the JAX
figures' pixel sizes; a figure that fails prints that it was skipped and never
fails the run. ``sae_e2e_finetune_epochs`` finetunes the trained dictionary on
the downstream KL (train/e2e_finetune.py), and ``profile_dir`` traces each
training epoch's steps with torch.profiler (utils/profiling.py). Datasets come
from ``data_dir`` (data/datasets.py) or the synthetic stand-in, each
file-backed read decoded by ``cfg.data_workers`` threads. A config that asks
for anything outside the port (``wandb_status``) raises NotImplementedError
naming the field.

``mesh_shape`` trains the cached dictionary on a mesh of torch.distributed
ranks (parallel/, started by parallel/distributed.spawn or the CLI's
``--mesh_shape``; every rank builds its own Pipeline): ``(d,)`` data parallel
for every SAE variant (parallel/sharded_steps.py), the transcoder and the
crosscoder, ``(d, m)`` tensor parallel for sae_mlp, gated_sae, jumprelu_sae,
matryoshka_sae and topk_sae on the TP ops (parallel/tensor_parallel.py) and
for the transcoder and the crosscoder on theirs (train/transcoder.py,
train/crosscoder.py); validate_mesh_mode gives the shapes. Rank 0 alone dumps
the caches (the others wait for it), then every rank reads the same step
blocks and keeps its own token rows. The evals run on rank 0 over the
gathered parameters while the other ranks go on to the next step's first
collective, and rank 0 alone writes the checkpoints (of the gathered state),
the results CSV, the top-k files, the figures, the export and the logs. A
resume restores the full state on every rank, then shards it. Any other
mode on more than one rank raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from sparse_vision_tpu_torch.config import IMG_SIZES, RunConfig
from sparse_vision_tpu_torch.data.datasets import load_data
from sparse_vision_tpu_torch.data.prefetch import prefetch
from sparse_vision_tpu_torch.device import resolve_device
from sparse_vision_tpu_torch.eval_tools import results as results_store
from sparse_vision_tpu_torch.models.backbone import (
    BACKBONES,
    get_sae_input_size,
    init_backbone,
    layer_dimensions,
    make_backbone,
)
from sparse_vision_tpu_torch.models.crosscoder import init_crosscoder
from sparse_vision_tpu_torch.models.sae import (
    SAE_VARIANTS,
    TOPK_FAMILY,
    calibrate_batch_topk_threshold,
    init_sae,
    init_transcoder,
    matryoshka_prefix_counts,
)
from sparse_vision_tpu_torch.ops import metrics, optim
from sparse_vision_tpu_torch.ops.fused_sae_tp import (
    can_fuse_matryoshka_tp,
    matryoshka_union_tiles,
)
from sparse_vision_tpu_torch.ops.losses import get_criterion
from sparse_vision_tpu_torch.ops.topk import init_topk, update_topk
from sparse_vision_tpu_torch.parallel.distributed import process_local_batch_slice
from sparse_vision_tpu_torch.parallel.mesh import make_mesh
from sparse_vision_tpu_torch.parallel.sharded_steps import (
    make_sharded_fused_train_step,
    put_replicated_state,
    put_tokens_sharded,
)
from sparse_vision_tpu_torch.parallel.tensor_parallel import (
    TP_VARIANTS,
    gather_tp_state,
    make_tp_fused_train_step,
    put_tp_state,
)
from sparse_vision_tpu_torch.train import checkpoint as ckpt
from sparse_vision_tpu_torch.train.steps import (
    ModelTrainState,
    SAETrainState,
    fused_op,
    init_sae_train_state,
    make_dequant_step_fn,
    make_model_eval_step,
    make_model_train_step,
    make_sae_eval_step,
    make_sae_train_multi_step,
    make_sae_train_multi_step_quant,
    make_sae_train_step,
    make_sae_train_step_from_acts,
)
from sparse_vision_tpu_torch.utils.logging import RunLogger
from sparse_vision_tpu_torch.utils.paths import folder_paths, run_id, sae_run_name
from sparse_vision_tpu_torch.utils.profiling import maybe_profile

# field -> the values the port supports, checked by validate_slice; anything
# else is not ported yet
_SLICE = {
    "model_name": BACKBONES,
    "dataset_name": tuple(IMG_SIZES),
    "sae_model_name": SAE_VARIANTS + ("transcoder", "crosscoder"),
    "sae_optimizer_name": ("constrained_adam", "adam"),
    "model_optimizer_name": ("adam", "sgd", "sgd_w_scheduler"),
    "cache_dtype": ("float32", "bfloat16", "int8"),
    "compute_dtype": ("bfloat16", "float32"),
    "model_criterion_name": ("cross_entropy", "negative_log_likelihood"),
    # 1: the collection epoch (mis_epoch), 2: scoring (interp/mis.py)
    "mis": ("0", "1", "2"),
    # 0: off; 1 averages, 2 node IE, 3 edge IE, 4<i> faithfulness (interp/ie.py)
    "compute_ie": ("0", "1", "2", "3") + tuple(f"4{i}" for i in range(20)),
    "overlap_dump_train": (False, True),
    "sae_input_norm": ("none", "rms"),
    "wandb_status": (False,),
}
# the dictionary's fields, which an original-model run does not read
_SAE_FIELDS = ("sae_model_name", "sae_optimizer_name")


def validate_slice(cfg: RunConfig) -> None:
    """Raise NotImplementedError, naming the field, for a value the port does not
    support yet."""
    for field, ok in _SLICE.items():
        if cfg.original_model and field in _SAE_FIELDS:
            continue
        value = getattr(cfg, field)
        if value not in ok:
            raise NotImplementedError(
                f"RunConfig.{field}={value!r} is not ported yet (supported: {ok})")
    if cfg.compute_ie != "0" and cfg.training:
        raise ValueError("IE is computed on a frozen SAE, not during training "
                         "(set training=False).")
    if cfg.mis != "0" and cfg.training:
        raise ValueError("MIS is computed on a frozen SAE, not during training "
                         "(set training=False).")
    if cfg.training and cfg.use_activation_cache and cfg.sae_model_name == "sae_conv":
        raise ValueError("RunConfig.use_activation_cache=True: sae_conv trains on feature "
                         "maps, and the cache holds tokens; set use_activation_cache=False")
    for field, model in (("transcoder_target_layer", "transcoder"),
                         ("crosscoder_layers", "crosscoder")):
        if getattr(cfg, field) and cfg.sae_model_name != model:
            raise NotImplementedError(
                f"RunConfig.{field}={getattr(cfg, field)!r} needs sae_model_name={model!r}")
    if len(cfg.mesh_shape) > 2 or any(int(n) < 1 for n in cfg.mesh_shape):
        raise ValueError(f"RunConfig.mesh_shape must be (), (d,) or (d, m) of positive sizes, "
                         f"got {cfg.mesh_shape}")


# the trainers whose TP op runs under a 'model' axis whatever use_pallas says
# (the JAX package's train/transcoder.py:345-367 and train/crosscoder.py:383-407)
_CODERS = ("transcoder", "crosscoder")
_GSPMD = ("the JAX package's GSPMD engine, which runs the stock step under a 'model' axis, "
          "is not ported (ROADMAP A6)")


def validate_mesh_mode(cfg: RunConfig, num_units: Optional[int] = None) -> None:
    """Raise NotImplementedError for a config that a mesh of more than one rank
    does not run. The mesh trains every SAE variant (data parallel on
    ``(d,)``), the transcoder and the crosscoder (data parallel on ``(d,)``,
    their TP ops on ``(d, m)``) from their activation caches; it refuses any
    other mode, and, under a 'model' axis, what the JAX package's pipeline
    gives its GSPMD engine rather than its fused TP engine
    (train/pipeline.py:585-619 there): an SAE variant without a TP op,
    use_pallas=False for an SAE, TopK with AuxK, and, once ``num_units`` (the
    dictionary's latents) is known, latents that do not split over the axis,
    a Matryoshka prefix set whose snapshot union does not tile
    (ops/fused_sae_tp.matryoshka_union_tiles) and a TopK k above the shard's
    latents. The kernels' token and width rules at (T/d, H/m) are
    Pipeline.check_fusable's, on the card."""
    name = cfg.sae_model_name
    if cfg.original_model or not cfg.training or cfg.compute_ie != "0" or cfg.mis != "0":
        raise NotImplementedError(
            "on a mesh of more than one rank the port trains dictionaries only (original_model, "
            "training=False, compute_ie and mis run on one rank; ROADMAP A6)")
    for field, off in (("use_activation_cache", True), ("overlap_dump_train", False),
                       ("sae_e2e_finetune_epochs", 0)):
        if getattr(cfg, field) != off:
            raise NotImplementedError(f"RunConfig.{field}={getattr(cfg, field)!r} is not "
                                      f"ported on a mesh of more than one rank (set {off!r}; "
                                      "ROADMAP A6)")
    if len(cfg.mesh_shape) < 2 or cfg.mesh_shape[1] == 1:
        return
    m = int(cfg.mesh_shape[1])
    if name not in _CODERS and (name not in TP_VARIANTS or not cfg.use_pallas):
        raise NotImplementedError(
            f"a 'model' axis trains {', '.join(TP_VARIANTS)} on their TP ops only "
            f"(use_pallas=True), and the transcoder and crosscoder; {_GSPMD}")
    if name == "topk_sae" and cfg.sae_aux_k > 0:
        raise NotImplementedError(
            f"topk_sae with sae_aux_k={cfg.sae_aux_k} on a 'model' axis: the TP op has no "
            f"AuxK term, and {_GSPMD}")
    if num_units is None:
        return
    if num_units % m:
        raise NotImplementedError(
            f"{num_units} latents do not shard over the model axis of {m}"
            + ("" if name in _CODERS else f", and {_GSPMD}"))
    if name == "matryoshka_sae":
        boundaries = matryoshka_prefix_counts(num_units, cfg.matryoshka_prefix_fractions)
        if not matryoshka_union_tiles(boundaries, m):
            raise NotImplementedError(
                f"the Matryoshka prefix boundaries {boundaries} clip into {m} shards at a "
                f"snapshot union the TP kernels do not take (multiples of 128), and {_GSPMD}")
    if name == "topk_sae" and cfg.sae_topk > num_units // m:
        raise NotImplementedError(
            f"sae_topk={cfg.sae_topk} exceeds the {num_units // m} latents of a shard, which "
            f"the two-stage selection needs, and {_GSPMD}")


class Pipeline:
    # steps per stack of the cached path (the JAX package's lax.scan block); the
    # cache shards are sized to a multiple of it so a stack is one shard slice
    CACHE_SCAN_K = 8

    def __init__(self, cfg: RunConfig, device=None, datasets=None,
                 backbone: Optional[tuple] = None, sae_params: Optional[dict] = None,
                 mesh=None):
        """``device``: None means CUDA (raises without a GPU); "cpu" runs the plain
        versions of the kernels. ``datasets`` optionally injects
        ``(train_ds, val_ds, category_names, img_size)``; without it load_data
        reads ``cfg.data_dir`` (ImageNet filtered to ``cfg.imagenet_class_filter``)
        or draws the stand-in. The backbone is drawn from ``cfg.seed``, then
        the latest checkpoint of the run folder's ``model_weights/`` (an
        original model trained there) replaces it, as in the JAX package; a
        checkpoint the JAX package wrote there (an Orbax directory) raises.
        ``backbone`` = (params, state) and ``sae_params`` optionally replace
        both the draw and ``model_weights/`` (e.g. with the JAX package's
        weights through convert.py): an explicit backbone wins over the
        directory, and an original-model run then trains from epoch 0.
        ``cfg.sae_weights_path`` still imports over the dictionary's, and
        ``cfg.sae_checkpoint_epoch`` restores the train state.

        ``mesh`` is this rank's (parallel/mesh.py), as parallel/distributed
        hands it to each rank; without it a ``cfg.mesh_shape`` of more than
        one rank builds one from the initialized torch.distributed world, and
        raises without one."""
        self.validate_input_norm(cfg)  # before any dump thread can start
        validate_slice(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = self._mesh(cfg, mesh)
        self.is_main = self.mesh is None or self.mesh.rank == 0
        self.paths = folder_paths(cfg)
        self.run_id = run_id(cfg)
        # rank 0 alone logs the training steps
        self.logger = RunLogger(log_every=cfg.log_every if self.is_main else math.inf)
        self.net = make_backbone(cfg.model_name, cfg.dataset_name)
        if datasets is None:
            datasets = load_data(cfg, class_filter=cfg.imagenet_class_filter or None)
        self.train_ds, self.val_ds, self.category_names, self.img_size = datasets
        self.criterion = get_criterion(cfg.model_criterion_name)

        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._model_ckpt_epoch = 0
        if backbone is None:
            backbone = self._restore_model(init_backbone(self.net, gen, cfg.dataset_name))
        self.frozen_params, self.net_state = _to_device(backbone, self.device)
        if cfg.use_sae:
            self._init_dictionary(gen, sae_params)
        else:
            self.tx = optim.get_optimizer(cfg.model_optimizer_name, cfg.model_learning_rate)
            self.mts = ModelTrainState(self.frozen_params, self.net_state,
                                       self.tx.init(self.frozen_params), 0)
            # the channels of the backbone layer that sae_layer names (top-k and
            # MIS of the original model); 0 where it names none (e.g. "None")
            try:
                self.num_units = get_sae_input_size(self.net, cfg.dataset_name, cfg.sae_layer)
            except ValueError:
                self.num_units = 0
        self.train_log: list = []  # (step, metrics of that step)
        self.eval_log: list = []  # (epoch, means)
        # per epoch: steps, tokens or images, seconds, whether it was profiled
        self.train_timing: list = []
        self.finetune_log: list = []  # (step, metrics) of the e2e finetune
        self.finetune_timing: list = []  # per finetune epoch: steps, images, seconds

    def _mesh(self, cfg: RunConfig, mesh):
        """This rank's mesh, or None on one rank (module docstring)."""
        if mesh is None:
            mesh = make_mesh(cfg.mesh_shape, device=self.device)
        if cfg.mesh_shape and tuple(cfg.mesh_shape) != mesh.shape:
            raise ValueError(f"RunConfig.mesh_shape {tuple(cfg.mesh_shape)} differs from the "
                             f"mesh {mesh.shape}")
        if mesh.world == 1:
            return None
        validate_mesh_mode(dataclasses.replace(cfg, mesh_shape=mesh.shape))
        return mesh

    def _restore_model(self, backbone: tuple) -> tuple:
        """``backbone`` (params, state), or the latest original-model checkpoint
        of ``model_weights/`` in its place (the JAX package's restore,
        sparse_vision_tpu/train/pipeline.py:92-104), with its epoch in
        ``_model_ckpt_epoch``."""
        folder = self.paths["model_weights"]
        last = ckpt.latest_epoch(folder)
        if last is None:
            return backbone
        if os.path.isdir(os.path.join(folder, f"epoch_{last}")):
            raise ValueError(
                f"{folder}/epoch_{last} is a checkpoint of the JAX package (an Orbax "
                "directory), which the port does not read: restore it with the JAX "
                "package, bring its params and net_state over with "
                "convert.backbone_from_jax (or an SAE checkpoint with "
                "convert.checkpoint_from_jax) and save them with "
                "train/checkpoint.save_checkpoint, or pass them as backbone=")
        params, state = backbone
        restored = ckpt.load_checkpoint(folder, last, like={"params": params, "net_state": state})
        self._model_ckpt_epoch = last
        print(f"Loaded original-model weights from epoch {last}.")
        return restored["params"], restored["net_state"]

    def _init_dictionary(self, gen: torch.Generator, sae_params: Optional[dict]) -> None:
        """The dictionary's parameters (drawn from ``gen`` unless given), its
        optimizer and train state, restored from ``cfg.sae_checkpoint_epoch``."""
        cfg = self.cfg
        self.sae_input_size = get_sae_input_size(self.net, cfg.dataset_name, cfg.sae_layer)
        self.num_units = int(self.sae_input_size * cfg.sae_expansion_factor)
        name = cfg.sae_model_name
        if name == "transcoder":
            if not cfg.transcoder_target_layer:
                raise ValueError("sae_model_name='transcoder' needs transcoder_target_layer")
            self.transcoder_out_size = get_sae_input_size(
                self.net, cfg.dataset_name, cfg.transcoder_target_layer)

            def init():
                return init_transcoder(gen, self.sae_input_size, cfg.sae_expansion_factor,
                                       self.transcoder_out_size)
        elif name == "crosscoder":
            if not cfg.crosscoder_layer_list:
                raise ValueError("sae_model_name='crosscoder' needs crosscoder_layers "
                                 "(additional layers beyond sae_layer)")
            layers = (cfg.sae_layer, *cfg.crosscoder_layer_list)
            order = [self.net.index_of(l) for l in layers]
            if order != sorted(order) or len(set(layers)) != len(layers):
                raise ValueError(
                    f"crosscoder layers must be distinct and in network depth order with "
                    f"sae_layer shallowest (got {layers}; stage order: "
                    f"{self.net.stage_names})")
            self.crosscoder_all_layers = layers
            self.crosscoder_dims = tuple(
                get_sae_input_size(self.net, cfg.dataset_name, l) for l in layers)

            def init():
                return init_crosscoder(gen, self.crosscoder_dims, cfg.sae_expansion_factor)
        else:
            def init():
                return init_sae(name, gen, self.sae_input_size, cfg.sae_expansion_factor,
                                jumprelu_threshold_init=cfg.jumprelu_threshold_init)
        self.sae_params = _to_device(init() if sae_params is None else sae_params, self.device)
        if cfg.sae_weights_path:  # weights only: a native .npz, a .pth or SAELens
            from sparse_vision_tpu_torch.train.sae_io import import_any

            like = self.sae_params
            imported = import_any(cfg.sae_weights_path, name, like=like)
            # an export under sae_input_norm="rms" also holds input_scale, a
            # statistic of the cache that is no parameter
            self.sae_params = {k: imported[k].to(like[k]) for k in like}
            print(f"Initialized SAE weights from {cfg.sae_weights_path}.")
        self.tx = optim.get_optimizer(cfg.sae_optimizer_name, cfg.sae_learning_rate)
        self.ts = init_sae_train_state(self.sae_params, self.tx, self.num_units, seed=cfg.seed)
        if cfg.sae_checkpoint_epoch > 0:
            self._restore_sae(cfg.sae_checkpoint_epoch)

    # ------------------------------------------------------------------
    def _cache_dir(self, layer: str) -> str:
        """Per-layer cache directory, shared by every run on this backbone (same
        scheme as the JAX package's evaluation_results/activation_cache/<layer>)."""
        cfg = self.cfg
        return os.path.join(cfg.directory_path, cfg.model_name, cfg.dataset_name,
                            f"evaluation_results_{cfg.sae_model_name}",
                            "activation_cache", layer)

    def _cache_dump_kwargs(self) -> dict:
        cfg = self.cfg
        block = self.CACHE_SCAN_K * cfg.cache_tokens_per_step
        return dict(
            batch_size=cfg.sae_batch_size,
            workers=cfg.data_workers,
            dtype=cfg.cache_dtype,
            # a multiple of the stack block, so stacks are zero-copy shard slices
            shard_tokens=block * max(1, -(-(1 << 16) // block)),
        )

    def _sae_ckpt_dir(self) -> str:
        return os.path.join(self.paths["checkpoints"], sae_run_name(self.cfg))

    def _ckpt_tree(self, ts: Optional[SAETrainState] = None) -> dict:
        ts = self.ts if ts is None else ts
        return {"params": ts.params, "opt_state": ts.opt_state, "step": ts.step,
                "dead_acc": ts.dead_acc}

    def _restore_sae(self, epoch: int) -> None:
        """The train state of the checkpoint of ``epoch``, on this device. The
        generator is not checkpointed: the run goes on with one seeded from
        ``cfg.seed``, as the JAX package resumes with a fresh key(seed), so a
        resample after the restart draws other directions than an
        uninterrupted run would."""
        r = ckpt.load_checkpoint(self._sae_ckpt_dir(), epoch, like=self._ckpt_tree())
        self.ts = SAETrainState(params=r["params"], opt_state=r["opt_state"], step=r["step"],
                                dead_acc=r["dead_acc"], rng=self.ts.rng.manual_seed(self.cfg.seed))
        print(f"Resumed SAE from checkpoint epoch {epoch} (train step {self.ts.step}).")

    def run(self):
        """The configured mode: a circuit-discovery mode (``compute_ie``,
        interp/ie.py; the dictionary's only), an MIS mode (``mis``; with
        ``original_model`` over the channels of the layer ``sae_layer``
        names), training (the dictionary, or with ``original_model`` the
        backbone), or a standalone eval of the model as it is (a restored
        checkpoint's, with ``sae_checkpoint_epoch``), which is its own last
        epoch."""
        cfg = self.cfg
        if cfg.original_model and cfg.compute_ie != "0":
            raise ValueError("IE can only be computed for the SAE model, not the original "
                             "model (original_model=False).")
        if cfg.original_model and cfg.mis != "0" and self.num_units == 0:
            raise ValueError(
                f"Original-model MIS needs sae_layer to name a backbone layer (got "
                f"{cfg.sae_layer!r}; available: {self.net.stage_names}).")
        if self.cfg.compute_ie != "0":
            from sparse_vision_tpu_torch.interp.ie import run_ie

            return run_ie(self, self.cfg.compute_ie)
        if self.cfg.mis == "1":
            return self.mis_epoch()
        if self.cfg.mis == "2":
            from sparse_vision_tpu_torch.interp.mis import compute_mis_for_run

            return compute_mis_for_run(self)
        if cfg.use_sae and cfg.training:
            return self.train_sae()
        if cfg.use_sae:
            return self.eval_modified(epoch=cfg.sae_checkpoint_epoch, final=True)
        if cfg.training:
            return self.train_original()
        # a layer named: its own last epoch, with the top-k collection over the
        # layer's channels
        collect = self.num_units > 0 and cfg.sae_layer not in ("", "None")
        return self.eval_original(collect_topk=collect, final=collect)

    def train_sae(self):
        """Train the configured dictionary: an SAE variant from its activation
        cache (``use_activation_cache``) or through the frozen backbone at every
        step, the transcoder and the crosscoder from their caches in their
        modules (as the JAX package, whatever ``use_activation_cache`` says).
        Returns the last eval's means."""
        name = self.cfg.sae_model_name
        if name == "transcoder":
            from sparse_vision_tpu_torch.train.transcoder import train_transcoder_cached

            return train_transcoder_cached(self)
        if name == "crosscoder":
            from sparse_vision_tpu_torch.train.crosscoder import train_crosscoder_cached

            return train_crosscoder_cached(self)
        if self.cfg.use_activation_cache:
            return self.train_sae_cached()
        return self.train_sae_uncached()

    def train_sae_uncached(self):
        """The JAX package's default mode: each step runs the frozen backbone on
        a batch of images, updates the SAE on the tap with the stock SAE math
        (no fused op, on either device) and splices the reconstruction back for
        the full metrics (train/steps.make_sae_train_step); the epochs' evals,
        checkpoints and export as run_epochs. Batches reach the device through
        data/prefetch.py."""
        cfg = self.cfg
        step_fn = make_sae_train_step(
            self.net, cfg.sae_layer, cfg.sae_model_name, cfg.sae_lambda_sparse, self.tx,
            cfg.dead_neurons_steps, cfg.sae_expansion_factor, self.criterion,
            topk=cfg.sae_topk, topk_approx=cfg.sae_topk_approx,
            jumprelu_bandwidth=cfg.jumprelu_bandwidth,
            matryoshka_prefixes=cfg.matryoshka_prefix_fractions,
            aux_k=cfg.sae_aux_k, aux_alpha=cfg.sae_aux_alpha)
        bs = cfg.sae_batch_size
        shape = self.net.shapes(tuple(self.img_size))[cfg.sae_layer]
        units = {"images": bs, "tokens": bs * int(np.prod(shape[:-1]))}

        def run_epoch(epoch):
            for b in self._batches(self.train_ds, bs, shuffle=True, seed=cfg.seed + epoch):
                self.ts, m = step_fn(self.ts, self.frozen_params, self.net_state, b.images,
                                     b.labels)
                self.logger.log_train(self.ts.step, m)
                self.train_log.append((self.ts.step, m))
            return units

        return self._epochs(run_epoch)

    def check_fusable(self, can_fuse, c_in: int, c_out: int, t: Optional[int] = None,
                      h: Optional[int] = None, always: bool = False) -> bool:
        """Whether the step takes the fused op (``cfg.use_pallas``). On the card a
        shape that the kernels' ``can_fuse(t, h, c_in, c_out, compute_dtype)``
        refuses raises, before any cache is dumped: there is no quiet fallback to
        the stock step. ``t`` and ``h`` are the kernels' tokens and latents (a
        rank's shard on a mesh; default: a step's tokens and every latent).
        ``always``: the kernels run whatever use_pallas says (the coders' TP
        ops), so the shape is checked either way."""
        cfg = self.cfg
        t = cfg.cache_tokens_per_step if t is None else t
        h = self.num_units if h is None else h
        if (cfg.use_pallas or always) and self.device.type == "cuda" and not can_fuse(
                t, h, c_in, c_out, cfg.compute_dtype):
            raise ValueError(
                f"the fused {cfg.sae_model_name} kernels do not take T={t}, "
                f"H={h}, C_in={c_in}, C_out={c_out} with compute dtype "
                f"{cfg.compute_dtype} (their can_fuse); set use_pallas=False for the "
                "stock step")
        return cfg.use_pallas

    @staticmethod
    def validate_input_norm(cfg: RunConfig) -> None:
        """The config's part of the sae_input_norm contract, checked in __init__
        so that a misconfiguration fails before any dump thread starts."""
        if cfg.sae_input_norm == "none":
            return
        if cfg.sae_input_norm != "rms":
            raise ValueError(f"sae_input_norm must be 'none' or 'rms', got "
                             f"{cfg.sae_input_norm!r}")
        if not cfg.use_activation_cache:
            raise ValueError("sae_input_norm='rms' requires use_activation_cache=True (the "
                             "scale is a cache statistic)")
        if cfg.overlap_dump_train:
            raise ValueError("sae_input_norm='rms' is incompatible with overlap_dump_train "
                             "(the scale is only known once the dump finishes)")
        if cfg.sae_e2e_finetune_epochs > 0:
            raise ValueError("sae_input_norm='rms' does not support the e2e KL finetune yet "
                             "(its splice step is scale-unaware); run the finetune on a "
                             "sae_input_norm='none' run")

    def input_scale_for(self, layer: str) -> Optional[float]:
        """The layer's input scale, or None when sae_input_norm is "none". With
        "rms" the dictionary trains on ``x / token_rms`` of the layer's cache and
        the eval splice rescales the reconstruction back: tap scales span orders
        of magnitude across layers, so λ and lr transfer only on a normalized
        basis. The scale is a statistic of the cache, fixed by the dump."""
        if self.cfg.sae_input_norm == "none":
            return None
        self.validate_input_norm(self.cfg)
        if not hasattr(self, "_input_scales"):
            self._input_scales = {}
        if layer not in self._input_scales:
            from sparse_vision_tpu_torch.data.activation_cache import ActivationCache

            cache_dir = self._cache_dir(layer)
            if not os.path.exists(os.path.join(cache_dir, "meta.json")):
                raise ValueError(f"sae_input_norm='rms' needs the {layer} activation cache at "
                                 f"{cache_dir} (train first, or dump the cache)")
            self._input_scales[layer] = ActivationCache(cache_dir).token_rms
        return self._input_scales[layer]

    def normalized_step(self, step_fn, layers: tuple):
        """``step_fn(ts, *acts)`` on each activation cast to f32 and multiplied by
        1 / token_rms of its layer (``layers`` in argument order), ahead of the
        fused op's own casts; ``step_fn`` itself when sae_input_norm is "none".
        The int8 wrappers dequantize before this multiply."""
        if self.cfg.sae_input_norm == "none":
            return step_fn
        invs = tuple(float(1.0 / self.input_scale_for(l)) for l in layers)

        def step(ts, *acts):
            return step_fn(ts, *(a.float() * inv for a, inv in zip(acts, invs)))

        return step

    def run_epochs(self, step_fn, epoch_items, before_checkpoint=None) -> Optional[dict]:
        """Train from caches: the epochs of ``_epochs``, each running every
        dispatch that ``epoch_items(epoch)`` yields. A dispatch is
        ``(stacks, scale)``: a tuple of [k, T, C_l] stacks (one per cache) and
        None, or, from an int8 cache read with dequantize="device", a tuple of
        one int8 stack and its scale [C]. Each is staged onto the device
        through data/prefetch.py. A stack of CACHE_SCAN_K steps runs as one
        multi-step dispatch, a shorter tail step by step through
        ``step_fn(ts, *acts)`` (with a scale, both through the dequantizing
        wrappers of train/steps.py), as the JAX package runs them. Keeps every
        step in ``train_log`` and hands the logger the last step of each
        dispatch, as the JAX package does."""
        cfg = self.cfg
        k_full = self.CACHE_SCAN_K
        runs = {False: (make_sae_train_multi_step(step_fn), step_fn),
                True: (make_sae_train_multi_step_quant(step_fn), make_dequant_step_fn(step_fn))}

        def run_epoch(epoch):
            for stacks, scale in prefetch(epoch_items(epoch), self.device):
                multi, single = runs[scale is not None]
                extra = () if scale is None else (scale,)
                step0, k = self.ts.step, stacks[0].shape[0]
                if k == k_full:
                    self.ts, ms = multi(self.ts, *stacks, *extra)
                    ms = [{n: v[j] for n, v in ms.items()} for j in range(k)]
                    self.logger.log_train(self.ts.step, ms[-1])
                else:  # a tail of fewer steps
                    ms = []
                    for j in range(k):
                        self.ts, m = single(self.ts, *(s[j] for s in stacks), *extra)
                        ms.append(m)
                        self.logger.log_train(self.ts.step, m)
                self.train_log.extend((step0 + j + 1, m) for j, m in enumerate(ms))
            return {"tokens": cfg.cache_tokens_per_step}

        return self._epochs(run_epoch, before_checkpoint)

    def _epochs(self, run_epoch, before_checkpoint=None) -> Optional[dict]:
        """Eval (stored nowhere), then for each epoch from
        ``cfg.sae_checkpoint_epoch`` on: ``run_epoch(epoch)`` (its steps; it
        returns the tokens, and images, of one step; traced under
        ``cfg.profile_dir``), the epoch's timing, ``before_checkpoint(epoch)``,
        an asynchronous checkpoint, an eval. Then wait for the checkpoints,
        export the weights and run the e2e finetune
        (``cfg.sae_e2e_finetune_epochs``). Returns the last eval's means (None
        when no epoch is left to run)."""
        cfg = self.cfg
        start = cfg.sae_checkpoint_epoch
        last_eval = None
        full = self._full_state()
        if self.is_main:
            self.eval_modified(epoch=start, store=False, params=full.params)
        for epoch in range(start, cfg.sae_epochs):
            with maybe_profile(cfg.profile_dir if self.is_main else "", self.device,
                               f"{self.run_id}_epoch_{epoch}"):
                t0 = time.perf_counter()
                steps0 = self.ts.step
                per_step = run_epoch(epoch)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                steps = self.ts.step - steps0
                self.train_timing.append({"epoch": epoch, "steps": steps,
                                          **{k: steps * v for k, v in per_step.items()},
                                          "seconds": time.perf_counter() - t0,
                                          "profiled": bool(cfg.profile_dir)})
            if before_checkpoint is not None:
                before_checkpoint(epoch)
            full = self._full_state()
            if self.is_main:
                # the host snapshot blocks; the write overlaps the next epoch
                ckpt.save_checkpoint(self._sae_ckpt_dir(), epoch + 1, self._ckpt_tree(full),
                                     blocking=False)
                last_eval = self.eval_modified(epoch=epoch + 1, params=full.params,
                                               final=epoch + 1 == cfg.sae_epochs)
        ckpt.wait_for_saves()
        if self.mesh is not None:
            self.ts = full  # every rank leaves with the whole state
        if self.is_main:
            self._export_sae_weights()
        if self.mesh is not None:
            self.mesh.barrier()  # the ranks leave once rank 0 has written
        if cfg.sae_e2e_finetune_epochs > 0:
            from sparse_vision_tpu_torch.train.e2e_finetune import e2e_finetune

            last_eval = e2e_finetune(self) or last_eval
        return last_eval

    def _full_state(self) -> SAETrainState:
        """The whole train state: the ranks' latent shards gathered under a
        'model' axis (a collective), else the state itself."""
        if self.mesh is None or self.mesh.size("model") == 1:
            return self.ts
        return gather_tp_state(self.mesh, self.ts)

    def _export_sae_weights(self) -> None:
        """Weight-only export to the run's sae_weights folder: the native .npz
        and a .pth in the reference's nn.Linear key layout. Under
        sae_input_norm="rms" the .npz also holds ``input_scale``, the token RMS
        of each layer the dictionary reads (the crosscoder's layers in order;
        the transcoder's input, then target), so that any reader can reproduce
        the splice."""
        from sparse_vision_tpu_torch.train.sae_io import save_sae_weights, to_torch_state_dict

        cfg = self.cfg
        name = sae_run_name(cfg)
        folder = self.paths["sae_weights"]
        params = self.ts.params
        if cfg.sae_input_norm != "none":
            if cfg.sae_model_name == "crosscoder":
                layers = self.crosscoder_all_layers
            elif cfg.sae_model_name == "transcoder":
                layers = (cfg.sae_layer, cfg.transcoder_target_layer)
            else:
                layers = (cfg.sae_layer,)
            params = {**params, "input_scale": torch.tensor(
                [self.input_scale_for(l) for l in layers], dtype=torch.float32)}
        path = save_sae_weights(params, folder, file_name=f"{name}_model_weights")
        pth = os.path.join(folder, f"{name}_model_weights.pth")
        torch.save(to_torch_state_dict(self.ts.params, cfg.sae_model_name), pth + ".tmp")
        os.replace(pth + ".tmp", pth)
        print(f"Saved SAE weights to {path}")

    def train_sae_cached(self):
        """Dump the layer's cache (on a thread, streamed into the first epoch,
        with overlap_dump_train), then train and evaluate. Later epochs read the
        cache shuffled, an int8 one as (int8 stack, scale) pairs dequantized on
        the device where its shards are aligned to the stacks. The TopK family's
        fast paths take any shape, so only the fused kernels' shapes are
        checked. batch_topk's threshold is calibrated after the last epoch,
        before its checkpoint and eval (_recalibrate_batch_topk). On a mesh
        (module docstring) the fused shapes are a rank's: T/d tokens, and
        H/m latents under a 'model' axis."""
        from sparse_vision_tpu_torch.data.activation_cache import (
            ActivationCache,
            dump_activations,
            overlapped_multi_dump,
            stream_stacks,
        )

        cfg = self.cfg
        prefixes = cfg.matryoshka_prefix_fractions
        tps = cfg.cache_tokens_per_step
        mesh = self.mesh
        n_data, n_model = (1, 1) if mesh is None else (mesh.size("data"), mesh.size("model"))
        t_local = process_local_batch_slice(tps, n_data)
        if mesh is not None:
            validate_mesh_mode(dataclasses.replace(cfg, mesh_shape=mesh.shape), self.num_units)
        if cfg.sae_model_name in TOPK_FAMILY:
            fused = cfg.use_pallas
        else:
            if n_model > 1 and cfg.sae_model_name == "matryoshka_sae":
                boundaries = matryoshka_prefix_counts(self.num_units, prefixes)

                def can_fuse(t, _h, c, dtype):  # the shard's rule at the global boundaries
                    return can_fuse_matryoshka_tp(t, boundaries, n_model, c, dtype)
            else:
                can_fuse, _ = fused_op(cfg.sae_model_name, prefixes)
            c = self.sae_input_size
            fused = self.check_fusable(
                lambda t, h, c_in, _, dtype: can_fuse(t, h, c_in, dtype), c, c,
                t=t_local, h=self.num_units // n_model)
        k = self.CACHE_SCAN_K
        cache_dir = self._cache_dir(cfg.sae_layer)
        stream_q = dump_thread = None
        # on a mesh rank 0 alone dumps the cache, and the others wait for it
        if self.is_main and not os.path.exists(os.path.join(cache_dir, "meta.json")):
            if cfg.overlap_dump_train and cfg.sae_epochs > cfg.sae_checkpoint_epoch:
                print(f"Building activation cache at {cache_dir} (overlapped) ...")
                qs, dump_thread = overlapped_multi_dump(
                    self.net, self.frozen_params, self.net_state, self.train_ds,
                    [cfg.sae_layer], {cfg.sae_layer: cache_dir}, device=self.device,
                    **self._cache_dump_kwargs())
                stream_q = qs[cfg.sae_layer]
            else:
                print(f"Building activation cache at {cache_dir} ...")
                dump_activations(self.net, self.frozen_params, self.net_state, self.train_ds,
                                 cfg.sae_layer, cache_dir, device=self.device,
                                 **self._cache_dump_kwargs())

        if mesh is not None:
            mesh.barrier()
        fused_opts = {"compute_dtype": cfg.compute_dtype}
        if cfg.sae_model_name == "jumprelu_sae":
            fused_opts["bandwidth"] = cfg.jumprelu_bandwidth
        if n_model > 1:
            step_fn = make_tp_fused_train_step(
                mesh, cfg.sae_lambda_sparse, self.tx, cfg.dead_neurons_steps,
                cfg.sae_expansion_factor, fused_opts=fused_opts,
                sae_model_name=cfg.sae_model_name, matryoshka_prefixes=prefixes,
                topk=cfg.sae_topk, topk_approx=cfg.sae_topk_approx)
            self.ts = put_tp_state(mesh, self.ts)
        else:
            opts = dict(fused=fused, fused_opts=fused_opts, topk=cfg.sae_topk,
                        topk_approx=cfg.sae_topk_approx,
                        jumprelu_bandwidth=cfg.jumprelu_bandwidth,
                        matryoshka_prefixes=prefixes, aux_k=cfg.sae_aux_k,
                        aux_alpha=cfg.sae_aux_alpha)
            args = (cfg.sae_lambda_sparse, self.tx, cfg.dead_neurons_steps,
                    cfg.sae_expansion_factor)
            if mesh is None:
                step_fn = make_sae_train_step_from_acts(cfg.sae_model_name, *args, **opts)
            else:
                step_fn = make_sharded_fused_train_step(
                    mesh, *args, sae_model_name=cfg.sae_model_name, **opts)
                self.ts = put_replicated_state(mesh, self.ts)
        step_fn = self.normalized_step(step_fn, (cfg.sae_layer,))
        opened: list = []  # the cache, once its dump has finished

        def open_cache():
            if not opened:
                if dump_thread is not None:
                    dump_thread.join()
                opened.append(ActivationCache(cache_dir))
            return opened[0]

        def epoch_items(epoch):
            # the first epoch run takes the shards as the dump publishes them
            if stream_q is not None and epoch == cfg.sae_checkpoint_epoch:
                return (((s,), None) for s in stream_stacks(
                    stream_q, tps, k, logical_dtype=cfg.cache_dtype))
            cache = open_cache()
            # device dequantization needs stacks within one shard (one scale each)
            aligned = int(cache.meta["shard_tokens"]) % (k * tps) == 0
            items = ((item[:1], item[1]) if isinstance(item, tuple) else ((item,), None)
                     for item in cache.stacks(tps, k, shuffle=True, seed=cfg.seed + epoch,
                                              dequantize="device" if aligned else "host"))
            if mesh is None:
                return items
            # every rank reads the same block and keeps its data index's rows
            return (((put_tokens_sharded(mesh, stacks[0], 1),), scale)
                    for stacks, scale in items)

        def before_checkpoint(epoch):
            if cfg.sae_model_name == "batch_topk_sae" and epoch + 1 == cfg.sae_epochs:
                self._recalibrate_batch_topk(open_cache(), tps)

        last_eval = self.run_epochs(step_fn, epoch_items, before_checkpoint)
        if dump_thread is not None:
            dump_thread.join()
        return last_eval

    def _recalibrate_batch_topk(self, cache, tps: int) -> None:
        """Replace batch_topk's EMA threshold by its calibration at the final
        parameters (models/sae.calibrate_batch_topk_threshold) on one shuffled
        cached block of ``tps`` tokens, the JAX package's block; under
        sae_input_norm="rms" in the normalized space the threshold lives in."""
        tok = next(iter(cache.batches(tps, shuffle=True, seed=self.cfg.seed + 7919,
                                      prefetch=False)))
        tok = tok.float()  # an int8 cache's block comes dequantized on the host
        scale = self.input_scale_for(self.cfg.sae_layer)
        if scale is not None:
            tok = tok / torch.tensor(scale, dtype=torch.float32)
        params = self.ts.params
        thr = calibrate_batch_topk_threshold(params, tok.to(self.device), self.cfg.sae_topk)
        old = float(params["threshold"])
        self.ts = self.ts._replace(params={**params, "threshold": thr})
        print(f"[batch_topk] inference threshold calibrated: {old:.5g} (EMA) -> "
              f"{float(thr):.5g}")

    # ------------------------------------------------------------------
    @property
    def _sae_eval_step_fn(self):
        if not hasattr(self, "_sae_eval_step_cache"):
            cfg = self.cfg
            rms = cfg.sae_input_norm != "none"
            if cfg.sae_model_name == "transcoder":
                from sparse_vision_tpu_torch.train.transcoder import make_transcoder_eval_step

                layers = (cfg.sae_layer, cfg.transcoder_target_layer)
                self._sae_eval_step_cache = make_transcoder_eval_step(
                    self.net, *layers, cfg.sae_lambda_sparse, cfg.sae_expansion_factor,
                    self.criterion,
                    input_scales=tuple(map(self.input_scale_for, layers)) if rms else None)
                return self._sae_eval_step_cache
            if cfg.sae_model_name == "crosscoder":
                from sparse_vision_tpu_torch.train.crosscoder import make_crosscoder_eval_step

                layers = self.crosscoder_all_layers
                self._sae_eval_step_cache = make_crosscoder_eval_step(
                    self.net, layers, cfg.sae_lambda_sparse, cfg.sae_expansion_factor,
                    self.criterion,
                    input_scales=tuple(map(self.input_scale_for, layers)) if rms else None)
                return self._sae_eval_step_cache
            self._sae_eval_step_cache = make_sae_eval_step(
                self.net, cfg.sae_layer, cfg.sae_model_name, cfg.sae_lambda_sparse,
                cfg.sae_expansion_factor, self.criterion, topk=cfg.sae_topk,
                topk_approx=cfg.sae_topk_approx, jumprelu_bandwidth=cfg.jumprelu_bandwidth,
                matryoshka_prefixes=cfg.matryoshka_prefix_fractions,
                input_scale=self.input_scale_for(cfg.sae_layer))
        return self._sae_eval_step_cache

    def eval_modified(self, epoch: int, store: bool = True, on_train_data: bool = False,
                      k: int = 25, final: bool = False, params: Optional[dict] = None) -> dict:
        """Means over the eval batches (validation, or train with
        ``on_train_data``) of every eval-step metric, plus exact accuracy and
        perc_dead_units (units dead in every batch). Writes
        ``<evaluation_results>/filename_indices/<run_id>_epoch_<epoch>.npz``:
        per unit the filename indices of the ``k`` samples with the largest and
        the smallest channel-averaged activation (the pre-activation where the
        variant has one), the dead units and the batch-mean activity frequency.
        With ``store``, writes the epoch's results row and merges the CSV. The
        batches reach the device through data/prefetch.py; the sums and the
        top-k states stay there until one readback after the loop. Draws the
        channel-frequency histogram, and with ``final`` (the run's last eval)
        the top-k grids and the activation histograms. ``params`` are the
        dictionary's (default: the train state's)."""
        cfg = self.cfg
        params = self.ts.params if params is None else params
        step_fn = self._sae_eval_step_fn
        ds = self.train_ds if on_train_data else self.val_ds
        bs = cfg.eval_batch_size or self._auto_eval_batch_size()
        sums = freq_sum = correct = dead_acc = None
        top = init_topk(k, self.num_units, largest=True, device=self.device)
        small = init_topk(k, self.num_units, largest=False, device=self.device)
        num_batches = 0
        for b in self._batches(ds, bs, shuffle=False):
            m, arrays = step_fn(params, self.frozen_params, self.net_state,
                                b.images, b.labels)
            num_batches += 1
            sums = m if sums is None else {key: sums[key] + v for key, v in m.items()}
            freq_sum = arrays["freq"] if freq_sum is None else freq_sum + arrays["freq"]
            correct = arrays["correct"] if correct is None else correct + arrays["correct"]
            dead_acc = metrics.update_dead_accumulator(dead_acc, arrays["dead"])
            start_idx = (num_batches - 1) * bs
            top = update_topk(top, arrays["topk_acts"], start_idx, b.indices)
            small = update_topk(small, arrays["topk_acts"], start_idx, b.indices)
        if num_batches == 0:
            raise ValueError("Empty evaluation dataset")
        names = sorted(sums)
        host = {key: v.cpu().numpy() for key, v in (
            ("sums", torch.stack([sums[n].float() for n in names])), ("freq", freq_sum),
            ("correct", correct), ("dead", dead_acc), ("top", top.filename_indices),
            ("small", small.filename_indices))}
        means = {n: float(v) / num_batches for n, v in zip(names, host["sums"])}
        means["accuracy"] = int(host["correct"]) / (num_batches * bs)
        means["perc_dead_units"] = float(host["dead"].mean())
        self.eval_log.append((epoch, means))
        self.logger.log_eval(epoch, means)

        # batch-mean activity frequency per unit
        freq = host["freq"].astype(np.float64) / num_batches
        self._channel_frequency_figure(freq, epoch)
        if final:
            self._final_eval_figures(ds, top, small, host["dead"], epoch, params=params)
        fn_dir = os.path.join(self.paths["evaluation_results"], "filename_indices")
        os.makedirs(fn_dir, exist_ok=True)
        np.savez(os.path.join(fn_dir, f"{self.run_id}_epoch_{epoch}.npz"),
                 max_filename_indices=host["top"], min_filename_indices=host["small"],
                 dead_units=host["dead"], activity_freq=freq.astype(np.float32))

        if store:
            row = {
                "lambda_sparse": cfg.sae_lambda_sparse,
                "expansion_factor": cfg.sae_expansion_factor,
                "batch_size": cfg.sae_batch_size,
                "optimizer_name": cfg.sae_optimizer_name,
                "learning_rate": cfg.sae_learning_rate,
                "rec_loss": means.get("sae_rec_loss"),
                "l1_loss": means.get("sae_l1_loss"),
                "nrmse_loss": means.get("sae_nrmse_loss"),
                "rmse_loss": means.get("sae_rmse_loss"),
                "aux_loss": means.get("sae_aux_loss"),
                "rel_sparsity": means.get("sparsity"),
                "var_expl": means.get("var_expl"),
                "perc_dead_units": means.get("perc_dead_units"),
                "loss_diff": means.get("loss_diff"),
                "median_mis": None,
                "epochs": epoch,
            }
            folder = self.paths["evaluation_results"]
            results_store.store_run_result(folder, f"{self.run_id}_epoch_{epoch}", row)
            results_store.merge_results(folder)
        return means

    def mis_epoch(self, n_mis: int = 20, k_mis: int = 9) -> dict:
        """Mode ``mis="1"``: an eval epoch on the train data that keeps each
        unit's n_mis·(k_mis + 1) = 200 most and least activating samples in the
        top-k file of ``sae_checkpoint_epoch``, which ``mis="2"`` scores; no
        results row. With ``original_model`` the units are the channels of the
        backbone layer that ``sae_layer`` names (eval_original)."""
        k = n_mis * (k_mis + 1)
        if self.cfg.use_sae:
            return self.eval_modified(epoch=self.cfg.sae_checkpoint_epoch, store=False,
                                      on_train_data=True, k=k)
        return self.eval_original(epoch=self.cfg.sae_checkpoint_epoch, on_train_data=True,
                                  k=k, collect_topk=True)

    def _batches(self, ds, batch_size: int, shuffle: bool, seed: int = 0):
        """``ds`` in batches, decoded by ``cfg.data_workers`` threads where it is
        file-backed, staged onto the device through data/prefetch.py."""
        return prefetch(ds.batches(batch_size, shuffle=shuffle, seed=seed,
                                   workers=self.cfg.data_workers), self.device)

    # ------------------------------------------------------------------
    # the original model: training and eval
    # ------------------------------------------------------------------
    def train_original(self):
        """Train the backbone itself (the reference's first step): an eval
        before the first epoch, then per epoch one step per batch of
        ``batch_size`` (shuffled by ``seed + epoch``), the StepLR epoch
        advanced, a checkpoint ``{"params", "net_state"}`` to
        ``model_weights/epoch_<e+1>`` and an eval. A directory that holds a
        checkpoint resumes after its epoch (the weights only: the optimizer
        starts anew, as in the JAX package, with the schedule advanced to the
        resume point), and returns at once when that reaches
        ``model_epochs``. The trained weights become the frozen backbone.
        Returns the train state."""
        cfg = self.cfg
        step_fn = make_model_train_step(self.net, self.tx, self.criterion)
        start = self._model_ckpt_epoch
        if start >= cfg.model_epochs:
            print(f"Original model already trained to epoch {start}; nothing to do.")
            return self.mts._replace(params=self.frozen_params, net_state=self.net_state)
        for _ in range(start):
            self.mts = self.mts._replace(opt_state=optim.advance_epoch(self.mts.opt_state))
        for epoch in range(start, cfg.model_epochs):
            if epoch == 0:
                self.eval_original(0)
            with maybe_profile(cfg.profile_dir, self.device, f"{self.run_id}_epoch_{epoch}"):
                t0, steps0 = time.perf_counter(), self.mts.step
                for b in self._batches(self.train_ds, cfg.batch_size, shuffle=True,
                                       seed=cfg.seed + epoch):
                    self.mts, m = step_fn(self.mts, b.images, b.labels)
                    self.logger.log_train(self.mts.step, m)
                    self.train_log.append((self.mts.step, m))
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                steps = self.mts.step - steps0
                self.train_timing.append({"epoch": epoch, "steps": steps,
                                          "images": steps * cfg.batch_size,
                                          "seconds": time.perf_counter() - t0,
                                          "profiled": bool(cfg.profile_dir)})
            # the per-epoch StepLR step (model_pipeline.py:963-965)
            self.mts = self.mts._replace(opt_state=optim.advance_epoch(self.mts.opt_state))
            ckpt.save_checkpoint(self.paths["model_weights"], epoch + 1,
                                 {"params": self.mts.params, "net_state": self.mts.net_state})
            self.eval_original(epoch + 1)
        self.frozen_params, self.net_state = self.mts.params, self.mts.net_state
        return self.mts

    def eval_original(self, epoch: int = 0, on_train_data: bool = False, k: int = 25,
                      collect_topk: bool = False, final: bool = False) -> dict:
        """The original model's eval epoch over the validation data (the train
        data with ``on_train_data``) in ``batch_size`` batches: the means of
        ``model_loss`` and ``accuracy``, logged; no results row. With
        ``collect_topk``, over the channel means of the layer ``sae_layer``
        names: the activity frequency, the dead channels and each channel's
        ``k`` most and least activating samples, written to
        ``filename_indices/<run_id>_epoch_<epoch>.npz`` under the JAX
        package's four names, which interp/mis.compute_mis_for_run scores,
        and draws the channel-frequency histogram (with ``final`` also the
        top-k grids and the activation histograms, model key "original")."""
        cfg = self.cfg
        if collect_topk and self.num_units == 0:
            raise ValueError(
                f"Top-k collection needs sae_layer to name a backbone layer (got "
                f"{cfg.sae_layer!r}; available: {self.net.stage_names}).")
        step_fn = make_model_eval_step(self.net, self.criterion,
                                       topk_layer=cfg.sae_layer if collect_topk else None)
        params, net_state = self._model_weights()
        ds = self.train_ds if on_train_data else self.val_ds
        sums = freq_sum = dead_acc = None
        if collect_topk:
            top = init_topk(k, self.num_units, largest=True, device=self.device)
            small = init_topk(k, self.num_units, largest=False, device=self.device)
        num_batches = 0
        for b in self._batches(ds, cfg.batch_size, shuffle=False):
            m, arrays, _ = step_fn(params, net_state, b.images, b.labels)
            num_batches += 1
            sums = m if sums is None else {key: sums[key] + v for key, v in m.items()}
            if collect_topk:
                freq_sum = arrays["freq"] if freq_sum is None else freq_sum + arrays["freq"]
                dead_acc = metrics.update_dead_accumulator(dead_acc, arrays["dead"])
                start_idx = (num_batches - 1) * cfg.batch_size
                top = update_topk(top, arrays["topk_acts"], start_idx, b.indices)
                small = update_topk(small, arrays["topk_acts"], start_idx, b.indices)
        if num_batches == 0:
            raise ValueError("Empty evaluation dataset")
        names = sorted(sums)
        totals = torch.stack([sums[n].float() for n in names]).cpu().numpy()
        means = {n: float(v) / num_batches for n, v in zip(names, totals)}
        self.eval_log.append((epoch, means))
        self.logger.log_eval(epoch, means)
        if collect_topk:
            freq = freq_sum.cpu().numpy().astype(np.float64) / num_batches
            dead = dead_acc.cpu().numpy()
            self._channel_frequency_figure(freq, epoch)
            if final:
                self._final_eval_figures(ds, top, small, dead, epoch, model_key="original")
            fn_dir = os.path.join(self.paths["evaluation_results"], "filename_indices")
            os.makedirs(fn_dir, exist_ok=True)
            np.savez(os.path.join(fn_dir, f"{self.run_id}_epoch_{epoch}.npz"),
                     max_filename_indices=top.filename_indices.cpu().numpy(),
                     min_filename_indices=small.filename_indices.cpu().numpy(),
                     dead_units=dead, activity_freq=freq.astype(np.float32))
        return means

    def _model_weights(self) -> tuple:
        """(params, net_state) of the original model: the train state's while
        it trains, else the frozen backbone's."""
        mts = getattr(self, "mts", None)
        if mts is None:
            return self.frozen_params, self.net_state
        return mts.params, mts.net_state

    def _auto_eval_batch_size(self) -> int:
        """sae_batch_size, clamped so the stock eval step's [B*H*W, latents] f32
        block stays under ~2 GB (256 images of 28x28 mixed3a tokens at 16k latents
        would need ~13 GB for it). The gated eval holds about five such blocks at
        once (~10 GB), which the card's 80 GB still takes."""
        bs = self.cfg.sae_batch_size
        shape = layer_dimensions(self.net, self.cfg.dataset_name)[self.cfg.sae_layer]
        tokens_per_image = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        max_bs = max(1, (2 << 30) // max(tokens_per_image * self.num_units * 4, 1))
        return int(min(bs, max_bs))

    # ------------------------------------------------------------------
    # the eval figures (the JAX package's, drawn with PIL: eval_tools/draw.py)
    # ------------------------------------------------------------------
    def _channel_frequency_figure(self, freq: np.ndarray, epoch: int) -> None:
        """Histogram of the per-unit activation frequency, at every eval: the
        non-zero frequencies in 40 bins over [0, 1], the never-active units as
        the red bar at 0; ``channel_frequency_histograms/<run_id>_epoch_<e>.png``
        (8 x 4 in at 120 dpi). A failure prints that it was skipped."""
        try:
            from sparse_vision_tpu_torch.eval_tools.draw import Figure

            zero = int(np.sum(freq == 0))
            counts, edges = np.histogram(freq[freq != 0], bins=40, range=(0.0, 1.0))
            fig = Figure((8, 4), dpi=120)
            ax = fig.grid(1, 1)[0]
            ax.axes(f"Frequency of how often a channel is active, {self.cfg.sae_layer}, "
                    f"epoch {epoch}", "Frequency of activation",
                    "No. of channels", (0.0, 1.0), (0.0, max(int(counts.max()), zero, 1)))
            ax.bars(edges[:-1], counts, 1.0 / 40, outline="black")
            ax.bars([0.0], [zero], 0.025, fill="red", outline="black")
            ax.legend([("Zero Values", "red")])
            fig.save(os.path.join(self.paths["evaluation_results"],
                                  "channel_frequency_histograms",
                                  f"{self.run_id}_epoch_{epoch}.png"))
        except Exception as e:  # a figure never fails a run
            print(f"[eval] channel-frequency figure skipped: {e}")

    @staticmethod
    def _select_figure_units(dead_acc: np.ndarray, n: int = 10) -> np.ndarray:
        """The first n units that are not dead, padded with dead units when
        fewer than n are alive."""
        dead = np.asarray(dead_acc, bool)
        return np.concatenate([np.flatnonzero(~dead), np.flatnonzero(dead)])[:n].astype(
            np.int64)

    def _final_eval_figures(self, ds, top, small, dead_acc: np.ndarray, epoch: int,
                            model_key: str = "sae", params: Optional[dict] = None) -> None:
        """The last eval's figures over ``_select_figure_units``'s units: the
        top and small grids of n_show = int(sqrt(k)) images a unit
        (``top_k_samples/<run_id>_{top,small}_k_samples_epoch_<e>.png``), then
        one more inference pass over ``ds`` that fills a 100-bin histogram a
        unit over [small.values[0], top.values[0]]
        (``activation_histograms/<run_id>_epoch_<e>.png``). ``model_key`` is
        "sae" (the spliced dictionary's latents) or "original" (the channels of
        the backbone layer ``sae_layer``), whose ``params`` (default: the
        train state's) the sae pass runs. A failure of either part prints
        that it was skipped."""
        from sparse_vision_tpu_torch.eval_tools import viz
        from sparse_vision_tpu_torch.ops import histograms

        cfg = self.cfg
        units = self._select_figure_units(dead_acc, n=10)
        k = top.values.shape[0]
        n_show = max(1, int(np.sqrt(k)))
        out_dir = self.paths["evaluation_results"]
        try:
            for state, tag in ((top, "top"), (small, "small")):
                images = viz.gather_topk_images(
                    ds, state.dataset_indices[:n_show].cpu().numpy(), units)
                values = state.values[:n_show].cpu().numpy()
                viz.show_top_k_samples(
                    images, {int(u): values[:, u] for u in units},
                    os.path.join(out_dir, "top_k_samples",
                                 f"{self.run_id}_{tag}_k_samples_epoch_{epoch}.png"),
                    title=f"{tag}-{n_show} activating samples, ({cfg.sae_layer}, "
                          f"{model_key}), epoch {epoch}")
        except Exception as e:  # a figure never fails a run
            print(f"[eval] top-k sample grids skipped: {e}")

        try:
            unit_idx = torch.as_tensor(units, device=self.device)
            hstate = histograms.init_histogram(100, small.values[0, unit_idx],
                                               top.values[0, unit_idx])
            if model_key == "original":
                step_fn = make_model_eval_step(self.net, self.criterion,
                                               topk_layer=cfg.sae_layer)
                params, net_state = self._model_weights()

                def batch_acts(b):
                    return step_fn(params, net_state, b.images, b.labels)[1]["topk_acts"]
            else:
                step_fn = self._sae_eval_step_fn

                sae_params = self.ts.params if params is None else params

                def batch_acts(b):
                    return step_fn(sae_params, self.frozen_params, self.net_state,
                                   b.images, b.labels)[1]["topk_acts"]

            ebs = cfg.eval_batch_size or self._auto_eval_batch_size()
            for b in self._batches(ds, ebs, shuffle=False):
                hstate = histograms.update_histogram(hstate, batch_acts(b)[:, unit_idx])
            histograms.plot_histograms(
                hstate, units,
                os.path.join(out_dir, "activation_histograms", f"{self.run_id}_epoch_{epoch}.png"),
                title=f"Histograms of neuron activations, ({cfg.sae_layer}, {model_key}), "
                      f"epoch {epoch}")
        except Exception as e:  # a figure never fails a run
            print(f"[eval] activation histograms skipped: {e}")


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_device(v, device) for v in tree)
    raise TypeError(f"unexpected tree node {type(tree)}")
