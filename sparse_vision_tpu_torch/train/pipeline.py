"""Run orchestration for the SAE training slice (port of the cached-training and
modified-model-eval parts of sparse_vision_tpu/train/pipeline.py).

``Pipeline(cfg).run()`` trains (``training``) or runs one standalone eval of a
restored checkpoint. Training, ``train_sae``, runs the north-star chain: frozen
GoogLeNet -> tap ``sae_layer`` -> activation cache -> SAE training (``sae_mlp``, ``gated_sae``,
``jumprelu_sae`` or ``matryoshka_sae``; the variant's fused CUDA kernels on a
GPU, their plain versions on the CPU) with dead-latent tracking (resampling for
sae_mlp, the rolling dead window for the others) -> eval by splicing the SAE
back into the backbone, before and after each epoch; a checkpoint after each
epoch (train/checkpoint.py), resumable with ``sae_checkpoint_epoch``; the
weights exported at the end (train/sae_io.py). ``transcoder`` (from
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
names (utils/paths.py). The eval figures are not ported; a config that asks for
anything outside the slice raises NotImplementedError naming the field.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from sparse_vision_tpu_torch.config import RunConfig
from sparse_vision_tpu_torch.data.datasets import load_data
from sparse_vision_tpu_torch.data.prefetch import prefetch
from sparse_vision_tpu_torch.device import resolve_device
from sparse_vision_tpu_torch.eval_tools import results as results_store
from sparse_vision_tpu_torch.models.backbone import (
    get_sae_input_size,
    init_backbone,
    layer_dimensions,
    make_backbone,
)
from sparse_vision_tpu_torch.models.crosscoder import init_crosscoder
from sparse_vision_tpu_torch.models.sae import PORTED, init_sae, init_transcoder
from sparse_vision_tpu_torch.ops import metrics, optim
from sparse_vision_tpu_torch.ops.losses import get_criterion
from sparse_vision_tpu_torch.ops.topk import init_topk, update_topk
from sparse_vision_tpu_torch.train import checkpoint as ckpt
from sparse_vision_tpu_torch.train.steps import (
    SAETrainState,
    fused_op,
    init_sae_train_state,
    make_dequant_step_fn,
    make_sae_eval_step,
    make_sae_train_multi_step,
    make_sae_train_multi_step_quant,
    make_sae_train_step_from_acts,
)
from sparse_vision_tpu_torch.utils.logging import RunLogger
from sparse_vision_tpu_torch.utils.paths import folder_paths, run_id, sae_run_name

# field -> (supported values, or None for "the JAX default only"), checked by
# validate_slice; anything else is not ported yet
_SLICE = {
    "model_name": ("inceptionv1", "googlenet"),
    "dataset_name": ("imagenet",),
    "sae_model_name": PORTED + ("transcoder", "crosscoder"),
    "sae_optimizer_name": ("constrained_adam", "adam"),
    "cache_dtype": ("float32", "bfloat16", "int8"),
    "compute_dtype": ("bfloat16", "float32"),
    "model_criterion_name": ("cross_entropy", "negative_log_likelihood"),
    "original_model": (False,),
    "mis": ("0",),
    "compute_ie": ("0",),
    "data_dir": ("",),
    "mesh_shape": ((),),
    "overlap_dump_train": (False, True),
    "sae_input_norm": ("none", "rms"),
    "sae_e2e_finetune_epochs": (0,),
    "wandb_status": (False,),
    "imagenet_class_filter": ("",),
    "profile_dir": ("",),
}


def validate_slice(cfg: RunConfig) -> None:
    """Raise NotImplementedError, naming the field, for a value the port does not
    support yet."""
    for field, ok in _SLICE.items():
        value = getattr(cfg, field)
        if value not in ok:
            raise NotImplementedError(
                f"RunConfig.{field}={value!r} is not ported yet (supported: {ok})")
    if cfg.training and not cfg.use_activation_cache:
        raise NotImplementedError(
            "RunConfig.use_activation_cache=False: only cached SAE training is ported")
    for field, model in (("transcoder_target_layer", "transcoder"),
                         ("crosscoder_layers", "crosscoder")):
        if getattr(cfg, field) and cfg.sae_model_name != model:
            raise NotImplementedError(
                f"RunConfig.{field}={getattr(cfg, field)!r} needs sae_model_name={model!r}")


class Pipeline:
    # steps per stack of the cached path (the JAX package's lax.scan block); the
    # cache shards are sized to a multiple of it so a stack is one shard slice
    CACHE_SCAN_K = 8

    def __init__(self, cfg: RunConfig, device=None, datasets=None,
                 backbone: Optional[tuple] = None, sae_params: Optional[dict] = None):
        """``device``: None means CUDA (raises without a GPU); "cpu" runs the plain
        versions of the kernels. ``datasets`` optionally injects
        ``(train_ds, val_ds, category_names, img_size)``. ``backbone`` =
        (params, state) and ``sae_params`` optionally replace the random init,
        e.g. with the JAX package's weights through convert.py;
        ``cfg.sae_weights_path`` then still imports over them, and
        ``cfg.sae_checkpoint_epoch`` restores the train state."""
        self.validate_input_norm(cfg)  # before any dump thread can start
        validate_slice(cfg)
        self.cfg = cfg
        self.paths = folder_paths(cfg)
        self.run_id = run_id(cfg)
        self.logger = RunLogger(log_every=cfg.log_every)
        self.device = resolve_device(device)
        self.net = make_backbone(cfg.model_name, cfg.dataset_name)
        if datasets is None:
            datasets = load_data(cfg)
        self.train_ds, self.val_ds, self.category_names, self.img_size = datasets
        self.criterion = get_criterion(cfg.model_criterion_name)

        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        if backbone is None:
            backbone = init_backbone(self.net, gen, cfg.dataset_name)
        self.frozen_params, self.net_state = _to_device(backbone, self.device)
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
        self.train_log: list = []  # (step, metrics of that step)
        self.eval_log: list = []  # (epoch, means)
        self.train_timing: list = []  # per epoch: steps, tokens, seconds

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
            dtype=cfg.cache_dtype,
            # a multiple of the stack block, so stacks are zero-copy shard slices
            shard_tokens=block * max(1, -(-(1 << 16) // block)),
        )

    def _sae_ckpt_dir(self) -> str:
        return os.path.join(self.paths["checkpoints"], sae_run_name(self.cfg))

    def _ckpt_tree(self) -> dict:
        ts = self.ts
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
        """The configured mode: training, or a standalone eval of the dictionary
        as it is (a restored checkpoint's, with ``sae_checkpoint_epoch``), which
        is its own last epoch. The other modes are refused by validate_slice."""
        if self.cfg.training:
            return self.train_sae()
        return self.eval_modified(epoch=self.cfg.sae_checkpoint_epoch, final=True)

    def train_sae(self):
        """Train the configured dictionary from activation caches: the SAE
        variants here, the transcoder and the crosscoder in their modules.
        Returns the last eval's means."""
        name = self.cfg.sae_model_name
        if name == "transcoder":
            from sparse_vision_tpu_torch.train.transcoder import train_transcoder_cached

            return train_transcoder_cached(self)
        if name == "crosscoder":
            from sparse_vision_tpu_torch.train.crosscoder import train_crosscoder_cached

            return train_crosscoder_cached(self)
        return self.train_sae_cached()

    def check_fusable(self, can_fuse, c_in: int, c_out: int) -> bool:
        """Whether the step takes the fused op (``cfg.use_pallas``). On the card a
        shape that the kernels' ``can_fuse(t, h, c_in, c_out, compute_dtype)``
        refuses raises, before any cache is dumped: there is no quiet fallback to
        the stock step."""
        cfg = self.cfg
        tps = cfg.cache_tokens_per_step
        if cfg.use_pallas and self.device.type == "cuda" and not can_fuse(
                tps, self.num_units, c_in, c_out, cfg.compute_dtype):
            raise ValueError(
                f"the fused {cfg.sae_model_name} kernels do not take T={tps}, "
                f"H={self.num_units}, C_in={c_in}, C_out={c_out} with compute dtype "
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

    def run_epochs(self, step_fn, epoch_items) -> Optional[dict]:
        """Eval (stored nowhere), then for each epoch from
        ``cfg.sae_checkpoint_epoch`` on: every dispatch that
        ``epoch_items(epoch)`` yields, an asynchronous checkpoint, an eval. Then
        wait for the checkpoints and export the weights. A dispatch is
        ``(stacks, scale)``: a tuple of [k, T, C_l]
        stacks (one per cache) and None, or, from an int8 cache read with
        dequantize="device", a tuple of one int8 stack and its scale [C]. Each is
        staged onto the device through data/prefetch.py. A stack of
        CACHE_SCAN_K steps runs as one multi-step dispatch, a shorter tail step
        by step through ``step_fn(ts, *acts)`` (with a scale, both through the
        dequantizing wrappers of train/steps.py), as the JAX package runs them.
        Keeps every step in ``train_log`` and hands the logger the last step of
        each dispatch, as the JAX package does; records the epoch's timing.
        Returns the last eval's means (None when no epoch is left to run)."""
        cfg = self.cfg
        k_full = self.CACHE_SCAN_K
        runs = {False: (make_sae_train_multi_step(step_fn), step_fn),
                True: (make_sae_train_multi_step_quant(step_fn), make_dequant_step_fn(step_fn))}
        start = cfg.sae_checkpoint_epoch
        last_eval = None
        self.eval_modified(epoch=start, store=False)
        for epoch in range(start, cfg.sae_epochs):
            t0 = time.perf_counter()
            steps0 = self.ts.step
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
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            steps = self.ts.step - steps0
            self.train_timing.append({"epoch": epoch, "steps": steps,
                                      "tokens": steps * cfg.cache_tokens_per_step,
                                      "seconds": time.perf_counter() - t0})
            # the host snapshot blocks; the write overlaps the next epoch
            ckpt.save_checkpoint(self._sae_ckpt_dir(), epoch + 1, self._ckpt_tree(),
                                 blocking=False)
            last_eval = self.eval_modified(epoch=epoch + 1,
                                           final=epoch + 1 == cfg.sae_epochs)
        ckpt.wait_for_saves()
        self._export_sae_weights()
        return last_eval

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
        the device where its shards are aligned to the stacks."""
        from sparse_vision_tpu_torch.data.activation_cache import (
            ActivationCache,
            dump_activations,
            overlapped_multi_dump,
            stream_stacks,
        )

        cfg = self.cfg
        prefixes = cfg.matryoshka_prefix_fractions
        can_fuse, _ = fused_op(cfg.sae_model_name, prefixes)
        c = self.sae_input_size
        fused = self.check_fusable(lambda t, h, c_in, _, dtype: can_fuse(t, h, c_in, dtype), c, c)
        tps, k = cfg.cache_tokens_per_step, self.CACHE_SCAN_K
        cache_dir = self._cache_dir(cfg.sae_layer)
        stream_q = dump_thread = None
        if not os.path.exists(os.path.join(cache_dir, "meta.json")):
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

        fused_opts = {"compute_dtype": cfg.compute_dtype}
        if cfg.sae_model_name == "jumprelu_sae":
            fused_opts["bandwidth"] = cfg.jumprelu_bandwidth
        step_fn = make_sae_train_step_from_acts(
            cfg.sae_model_name, cfg.sae_lambda_sparse, self.tx, cfg.dead_neurons_steps,
            cfg.sae_expansion_factor, fused=fused, fused_opts=fused_opts,
            jumprelu_bandwidth=cfg.jumprelu_bandwidth, matryoshka_prefixes=prefixes)
        step_fn = self.normalized_step(step_fn, (cfg.sae_layer,))
        opened: list = []  # the cache, once its dump has finished

        def epoch_items(epoch):
            # the first epoch run takes the shards as the dump publishes them
            if stream_q is not None and epoch == cfg.sae_checkpoint_epoch:
                return (((s,), None) for s in stream_stacks(
                    stream_q, tps, k, logical_dtype=cfg.cache_dtype))
            if not opened:
                if dump_thread is not None:
                    dump_thread.join()
                opened.append(ActivationCache(cache_dir))
            cache = opened[0]
            # device dequantization needs stacks within one shard (one scale each)
            aligned = int(cache.meta["shard_tokens"]) % (k * tps) == 0
            return ((item[:1], item[1]) if isinstance(item, tuple) else ((item,), None)
                    for item in cache.stacks(tps, k, shuffle=True, seed=cfg.seed + epoch,
                                             dequantize="device" if aligned else "host"))

        last_eval = self.run_epochs(step_fn, epoch_items)
        if dump_thread is not None:
            dump_thread.join()
        return last_eval

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
                cfg.sae_expansion_factor, self.criterion,
                jumprelu_bandwidth=cfg.jumprelu_bandwidth,
                matryoshka_prefixes=cfg.matryoshka_prefix_fractions,
                input_scale=self.input_scale_for(cfg.sae_layer))
        return self._sae_eval_step_cache

    def eval_modified(self, epoch: int, store: bool = True, on_train_data: bool = False,
                      k: int = 25, final: bool = False) -> dict:
        """Means over the eval batches (validation, or train with
        ``on_train_data``) of every eval-step metric, plus exact accuracy and
        perc_dead_units (units dead in every batch). Writes
        ``<evaluation_results>/filename_indices/<run_id>_epoch_<epoch>.npz``:
        per unit the filename indices of the ``k`` samples with the largest and
        the smallest channel-averaged activation (the pre-activation where the
        variant has one), the dead units and the batch-mean activity frequency.
        With ``store``, writes the epoch's results row and merges the CSV. The
        batches reach the device through data/prefetch.py; the sums and the
        top-k states stay there until one readback after the loop. ``final``
        (the run's last eval) would draw the eval figures, which are not
        ported."""
        cfg = self.cfg
        step_fn = self._sae_eval_step_fn
        ds = self.train_ds if on_train_data else self.val_ds
        bs = cfg.eval_batch_size or self._auto_eval_batch_size()
        sums = freq_sum = correct = dead_acc = None
        top = init_topk(k, self.num_units, largest=True, device=self.device)
        small = init_topk(k, self.num_units, largest=False, device=self.device)
        num_batches = 0
        for b in prefetch(ds.batches(bs, shuffle=False), self.device):
            m, arrays = step_fn(self.ts.params, self.frozen_params, self.net_state,
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


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_device(v, device) for v in tree)
    raise TypeError(f"unexpected tree node {type(tree)}")
