"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase, one card
    python3 chip_smoke.py --profile    # the same, with a torch.profiler table of each slice run

Every run through the port's Pipeline below also draws the eval figures with
PIL (eval_tools/draw.py): the channel-frequency histogram at each eval, the
top-k grids and activation histograms at the last.

Phases, in order; a phase that fails raises and the script exits non-zero:
  1. device:  require CUDA; print the card's name and power limit (nvidia-smi).
  2. build:   compile every kernel in sparse_vision_tpu_torch/csrc with nvcc, one
              process per source, all started together; print each
              instantiation's registers (beside REGISTERS_BEFORE's count
              where it has one) and fail on any spill, and unless the
              coders' source builds the held backward's two passes
              (coder_bwd_held, HELD_SOURCES) and no other source any, and
              the JumpReLU source the cluster-pair backward's Act::Jump
              instantiation, the SAEs' source its Act::Relu one and the gated
              SAE's source its Act::Gated one (coder_bwd_pair, PAIR_SOURCES)
              and no other source any; print
              each pair's registers, spill bytes and the clusters of it the
              card holds (cudaOccupancyMaxActiveClusters).
  3. kernels: hold each kernel against its plain PyTorch version on the card at
              the training shape (SAEs: T=32768 tokens, C=256, H=16384 latents,
              the Matryoshka prefixes ending at 1024, 4096 and 16384; the
              transcoder: T=32768, C_in=256 -> C_out=480, H=16384; the
              crosscoder: T=16384, dims 512/512/512/528/832 = 2896, H=8192), in
              f32 and bf16 operands; time kernel, plain version and the cuBLAS
              products of the stock path; compute each kernel's bound and its
              achieved TFLOP/s. The ReLU and Matryoshka ops (the coder bodies
              on the centred input) are also held to their plain versions at
              C=480 and C=832 (T=8192, H=4096, prefixes 1024/2048/4096; a
              Matryoshka backward whose levels' errors differ, prefixes
              128/1024/4096), their bf16 launches must repeat bitwise, 20 at
              C=832 (the in-place forward), and each is timed there, the two
              dx entry points too (above C=256 the dx route of the in-place
              body; 20 bitwise-equal ReLU dx launches at 832); so are
              the JumpReLU and gated forwards and backwards in both dtypes (the
              coder bodies' Act::Jump and Act::Gated epilogues; the gated
              forward's two launches, Act::GatedEnc and Act::GatedPi, above
              C=256 in bf16 and always in f32), also at a ragged shape (T=1152,
              H=640, C=136), 20 bitwise-equal bf16 launches each at C=832.
              The ptxas report names each instantiation with its registers
              and spill bytes. The
              transcoder/crosscoder pair is also held to
              its plain versions at ragged shapes (T=1152, C_in=264, H=640,
              C_out=136 and 520: a partial token step, latent group and channel
              chunk at every edge, for both bf16 forward bodies, the in-place
              one split in two; and T=2176 at C_out=520, where the bf16
              backward splits too), and its bf16 kernels must give
              bitwise-equal outputs on a repeat launch. Where bwd_route gives
              the bf16 transcoder backward the held passes (C_in <= 256 <
              C_out <= 512: row 12 here, row 24 in phase 15 (e)), pass E's
              dW_enc, db_enc and pass D's dW_dec, db_dec are held to their
              plain versions, REPEATS launches must repeat bitwise, and the
              launch is timed beside the same launch on coder_bwd_tc
              (route="tc"), in turns ("[route]" lines); at row 12 each pass
              is also launched alone and timed as a row of the kernels line.
              The held passes are also held pass by pass where they end in
              a partial step or split (C_in 136 -> C_out 264 at T 1152 and
              2176, H 640; phase 10's mixed3a -> mixed3b launch, T 3072, H
              2048, split in 3): the split launch and the same launch
              unsplit, REPEATS bitwise-equal launches each. Where bwd_route
              gives the bf16 JumpReLU backward the cluster pair (C <= 256:
              row 5 here, row 20 in phase 15 (e), row 32 in phase 16 (a)),
              its launch is held to its plain version with REPEATS launches
              bitwise equal and timed beside the same launch on
              coder_bwd_tc (route="tc"), in turns ("[route]" lines); so is
              the pair at the ragged shape (T 1152, H 640, C 136) and at T
              2176 split in 2 and unsplit (kernels_pair_shapes), which also
              holds it at the narrower widths the backbones give it
              (PAIR_WIDTHS: C 64 and 192 at T 32768, expansion 64, and C 64
              at expansion 16, where it splits in 4), each timed beside
              coder_bwd_tc ("[route]") and beside the same launch at the
              other side of the split rule ("[split]"), and launches a
              sweep of 8 at H 512 PAIR_STRESS_REPEATS times bitwise equal
              (a slot overwritten before it was read would differ). Where
              bwd_route gives the bf16 ReLU and Matryoshka SAE backwards the
              cluster pair (C <= 256, any levels: rows 2 and 9 here, 16 and
              22 in phase 15 (e), 28 and 34 in phase 16 (a)), each launch is
              held to the plain version of its route with REPEATS launches
              bitwise equal and timed beside coder_bwd_tc ("[route]"); so is
              the ReLU SAE at T 2176, C 136, H 640 split in 2 and unsplit,
              a Matryoshka launch there whose levels' errors differ, and
              PAIR_STRESS's sweep of the ReLU SAE. Where bwd_route gives the
              bf16 gated SAE backward the cluster pair (C <= 256, one level:
              row 7 here, 18 in phase 15 (e), 30 in phase 16 (a)), each
              launch is held to the plain version of its route with REPEATS
              launches bitwise equal and timed beside coder_bwd_tc
              ("[route]"); so are the gated SAE at T 2176, C 136, H 640 with
              planted pre_gate == 0 ties (the gate's 0.5), split in 2 and
              unsplit, and PAIR_STRESS's sweep of the gated SAE. The kernels
              line's coder_bwd_pair (row 5's launch), coder_bwd_pair_relu
              (row 2's) and coder_bwd_pair_gated (row 7's) rows are each
              body's own device time (torch.profiler, in a process of its
              own after phase 16: --pair-body jump|relu|gated), apart from
              its pre-passes, whose time is printed beside it.
  4. parity:  each fused op's loss and gradients against the stock autograd path
              on the card at a small shape, in f32; with compute_dx=True, the
              sae_mlp and Matryoshka ops' input gradients too.
  5. dx:      the dx kernels' path (training treats activations as data): the
              sae_mlp and Matryoshka ops with compute_dx=True at the training
              shape in bf16 through torch.autograd, one launch each of forward,
              backward and dx, x's gradient held to the plain dx.
  6. slice:   Pipeline.train_sae on the north-star config (GoogLeNet mixed3a,
              16,384 latents, bf16 cache, 12 steps of 32,768 tokens) for sae_mlp
              (measurement resets at steps 4 and 12, a resample at step 9), then
              gated_sae, jumprelu_sae and matryoshka_sae (the rolling dead window
              restarts at steps 4, 8 and 12), the transcoder mixed3a -> mixed3b
              and the crosscoder mixed4a..mixed4e (8,192 latents, 12 steps of
              16,384 tokens; sae_input_norm="rms" at λ 5), both resampling
              like sae_mlp; every kernel launch count is reset just before each
              run and read after it (the jumprelu_sae, sae_mlp,
              matryoshka_sae and gated_sae runs also 12 of their cluster
              pair's body).
  7. cache:   the host side of the cached path at the sae_mlp slice's shape:
              an overlap_dump_train run (12 + 12 launches) whose shards are
              byte-equal to a sequential dump's; every stack that prefetch
              stages onto the card bitwise equal to a synchronous copy, read
              behind fused launches; an int8-cache run through the
              device-dequant steps within 5% of the bf16 run's last eval.
  8. artifacts: a trained dictionary as an artifact, on the gated_sae slice
              (two epochs, 12 steps each, through Pipeline.run): (a) an
              uninterrupted run (24 + 24 launches); (b) one epoch, then a
              fresh Pipeline resumed from its checkpoint (12 + 12 launches
              each), bitwise equal to (a) in params, Adam state, step and
              dead accumulator; (c) a standalone eval of (a)'s epoch-2
              checkpoint that reproduces (a)'s last eval; (d) the .npz, .pth
              and SAELens exports read back bitwise; (e) the results CSV's
              rows of epochs 1 and 2 and the epoch-2 top-k file. Times one
              checkpoint's snapshot, write and restore, the export, and an
              eval with and without its top-k updates.
  9. circuit: circuit discovery through Pipeline.run on GoogLeNet at 229 px
              (random, conv weights x sqrt(6); each image labelled with the
              class its logits raise most) with the eight registry-shaped
              sae_mlp SAEs (mixed3a 256 -> 2,048 ... mixed5b 1,024 -> 4,096
              latents) written as checkpoints and loaded through the registry:
              (a) the C5 case (seed 0's stand-in holds class 543) raises a
              ValueError naming the class; (b) compute_ie 1 and 2 over 128
              images at batch 32, 3 at batch 8 (64 top features a layer,
              cotangent chunks of 16, every pair and the loss node), 40; every
              artifact finite at the JAX package's shapes; (c) one batch's node
              IE on the card equal to the CPU's; (d) one pair's edges in chunks
              of 16 equal to one chunk; (e) faithfulness 1 at threshold -1, to
              a tolerance that tells errors kept from errors ablated, and
              exactly 0 at 1e9, for the SAE and the model variant;
              faithfulness.png after mode 40 at the JAX figure's size. Fails on
              a vmap fallback warning or a kernel launch; prints each mode's
              seconds and images/s and the edge pass's peak memory.
 10. multilayer: ROADMAP A8's second half on the same scaled GoogLeNet (seed
              2, 512 train / 64 val images at 229 px, relabelled as in phase
              9; bf16 cache and compute, 3,072 tokens a step): (a) the sae_mlp
              op at C 528 / H 2,112 (padded to 2,176 inside the op) and C
              1,024 / H 4,096, the transcoder op at 528 -> 832 / H 2,112
              (padded), T 8,192, against the plain versions at the true H in
              f32 and bf16, a bf16 repeat bitwise equal, every padded latent
              exactly zero at the entry points; (b) train_saes_multilayer over
              the eight CIRCUIT_LAYERS at their registry hyperparameters:
              one dump of all eight, each layer's fused kernels launched once
              a train step (counts set to 0 just before each run and read just
              after; mixed4d through the padded op), tokens/s per layer; (c)
              train_transcoders_multilayer over the five same-geometry pairs
              the same way; (d) load_pair_params, the edges of the chain
              mixed4b -> 4c -> 4d -> 4e over 128 images at batch 32
              (transcoder_circuit_edges_images_per_sec), 4 images' edges
              against the formula in f64 on the CPU, chain_faithfulness's
              anchors (exact transcoders of a small MLP: 1 and exactly 0; the
              chain with no latent kept: exactly 0), finite loss-node edges;
              (e) mis "1" and "2" on the trained mixed3a: one CSV row per
              unit, a finite median, the seconds of each; (f) the eight SAEs
              read back from their exports through the CircuitEngine: finite
              node IE, faithfulness 1 at threshold -1. TF32 off throughout.
 11. topk:    the TopK family and training without a cache, no kernel of the
              JSON line among them (the JAX package's TopK paths are stock
              XLA, not Pallas): (a) f32, TF32 off, T 8,192, C 256, H 4,096, k
              32: topk_sae's gather decode and batch_topk_sae's index selection
              against the stock math of models/sae.py, each with AuxK (k_aux
              512, weight 1/32, a quarter of the latents dead): loss terms,
              AuxK and every gradient within 1e-5 of the largest entry, both
              timed; GatherDecode's dW_dec at that shape with every index in
              64 latents, bitwise equal over three runs; kth_largest over
              32,768 x 16,384 values (n = 32,768 x 32) bitwise the n-th value
              of a sort, timed beside the sort and torch.topk on the floats;
              (b) topk_sae and batch_topk_sae through Pipeline.train_sae at
              phase 6's north-star config (mixed3a at 229 px, 16,384 latents,
              bf16 cache, 12 steps of 32,768 tokens) with k 32, sae_aux_k 512
              and the 4-step dead window: finite losses, a
              non-zero AuxK at a mature step with dead latents, topk's eval code
              at most 32 latents a token, batch_topk's threshold positive from
              step 1, its EMA and calibrated values printed, the last eval and
              the checkpoint at the calibrated one, and a second batch_topk run
              from the same cache bitwise equal (params, Adam state, threshold,
              dead accumulator); tokens/s; (c) Pipeline.run with
              use_activation_cache=False on 256 images at 229 px, batch 32, one
              epoch, on phase 9's GoogLeNet (conv weights scaled by CONV_GAIN,
              so that logits depend on the image): sae_mlp at expansion 64 and
              sae_conv at expansion 4 (1,024 channels; UNCACHED says why): 14
              finite metrics every step with kld > 0; the first step's
              model_loss, kld, perc_same and var_expl against a plain f64
              recomputation from its images, the SAE's parameters before the
              step and the splice (UNCACHED_TOL); the evals before and after
              the epoch, its checkpoint and the export; images/s. (b) and (c)
              fail on any fused kernel launch.
 12. backbones: the families beyond GoogLeNet (models/backbone.py): (a) 4
              images through clip_vit_b16, clip_vit_b16_split and vit_base at
              224 px, resnet18 (64 px), resnet18_1 and resnet50 (224 px),
              custom_cnn_1, custom_mlp_2, custom_mlp_9_sae_fc1 and GoogLeNet's
              aux heads on the card in f32 (TF32 off), logits and every tap
              within FWD_TOL of the same net on the CPU in f64; the split CLIP
              tower on the fused one's parameters against it. Then the ReLU
              SAE op at C 768 / H 6,144 and C 512 / H 4,096 and the transcoder
              op at 768 -> 768 / H 6,144 (coder_fwd_tc), T 32,768, against
              their plain versions in f32 and bf16, bf16 repeats bitwise
              equal, each timed beside its bound and the cuBLAS products.
              Through Pipeline.train_sae at those widths (bf16 cache, 12 steps
              of 32,768 tokens, phase 6's checks and launch counts; the dump's
              seconds): (b) sae_mlp on clip_vit_b16 block6 (bench_clip_sae.py's
              shape, 2,048 224 px images); (c) the clip_vit_b16_split
              transcoder block5_attn -> block5_mlp; (d) sae_mlp on resnet18
              layer4.1 (6,144 64 px images, 200 classes). (e) compute_ie 1
              and 2 through Pipeline.run on (b)'s trained SAE (interp/ie.py's
              one-layer engine), no kernel launched; bench_vit_circuit.py's
              shape: CircuitEngine over clip_vit_b16_split with four random
              sae_mlp SAEs (6,144 latents) at block2/5/8/11_attn, 64
              relabelled images at batch 16: averages and node IE, one
              batch's node IE against the CPU's f64, block2_attn ->
              block5_attn edges at 64 features a side (peak memory), phase
              9's faithfulness anchors; no vmap fallback.
 13. original: the original model's training and eval, and the dataset
              loaders (no TPU kernel lies on the training path; JAX trains it
              with plain value_and_grad): (a) Pipeline.run trains ResNet-18
              (Tiny-ImageNet stem, 64 px, 200 classes; sgd_w_scheduler, batch
              256) two epochs on 10,240 / 1,024 stand-in images, a fresh
              Pipeline resumes it from model_weights/epoch_2 to three, and an
              uninterrupted three-epoch run trains a second folder, cuDNN
              deterministic: the train loss falls each epoch, val accuracy
              rises, every running statistic moves, EpochLRState.epoch counts
              the epochs, both folders' epochs 1-2 are bitwise equal; the
              resumed third epoch's distance from the uninterrupted one is
              printed (the resume restarts the optimizer, as the JAX package);
              images/s; (b) one train step of the trained model on 32 images
              on the card in f32, TF32 off, against the CPU's f64: the loss
              and running statistics within ORIG_TOL, the parameters within
              ORIG_TOL or F32_NOISE times the CPU's own f32 step; (c) a cached
              sae_mlp run at layer4.1 (8x, bf16, 12 steps of 32,768 tokens) in
              that folder prints "Loaded original-model weights from epoch 3.",
              runs on the trained backbone bitwise and launches rows 1-2 once
              a step (phase 6's checks); (d) mis "1" then "2" over layer4.1's
              512 channels: one CSV row a channel, a finite median, seconds;
              (e) MNIST idx files (60,000 / 10,000, the train images also
              gzipped) and CIFAR-10 pickles (50,000 / 10,000) written from a
              seed, read back through load_data bitwise equal to the formula
              on the written bytes, custom_mlp_9 and custom_cnn_1 trained an
              epoch on them (batch 64) to above-chance accuracy, images/s; (f)
              "pil: <version>" or "pil: absent"; with PIL a tiny-imagenet-200
              folder through eval_original of (a)'s model (its figures over
              layer4.1's channels, model key "original", each PNG at the JAX
              figure's size), two ImageNet tar
              shards of 300 x 400 JPEGs decoded at 229 px (inceptionv1) and
              224 px (clip_vit_b16), the pool bitwise the synchronous decode,
              the index file reused, decode images/s; without PIL the first
              decode's ImportError naming it. TF32 is off for (b) only.
 14. finish:  the eval figures, the feature report, the e2e KL finetune and
              profile_dir (no TPU kernel on these paths: JAX's finetune,
              figures and report are stock XLA, numpy and matplotlib): (a)
              Pipeline.run of sae_mlp at phase 6's north-star shape (mixed3a
              at 229 px, 16,384 latents, bf16 cache, 12 steps of 32,768 tokens)
              on phase 9's GoogLeNet (conv weights x CONV_GAIN, so that the
              logits depend on the image and the KLD is no f32 noise; so (e)),
              with profile_dir set and one finetune epoch at sae_batch_size 32
              (FIN_BATCH): rows 1-2 launched once a training step and never in
              the finetune; KLD, perc_same and var_expl before and after the
              finetune, its images/s and its steps' peak memory; (b) one
              finetune step of 4 images on the card in f32, TF32 off, against
              the CPU's f64 (and f32, the noise floor) from (a)'s trained
              state: the loss and each updated parameter array within FIN_TOL
              (or F32_NOISE times the CPU's f32); (c) one Chrome trace per
              trained epoch, loaded with json: the fused kernels by name with
              12 launches each, one step's device time split into the fused
              forward and backward, the loss terms, the optimizer, the dead
              units, the copies and the rest (the profiler ranges of
              train/steps.make_update), and the device's idle share of the
              traced window; (d) every PNG the JAX package's run writes, and
              no other, decoded at the JAX figures' sizes (FIG_SIZES), the
              last top-k grids' tiles read back bitwise as the gathered
              images upscaled, the last activation histogram's counts bitwise
              the CPU's plain update of the same activations; (e) one finetune
              epoch each of the transcoder (mixed3a -> mixed3b) and the
              crosscoder (mixed4a..4e, sae_input_norm "none": rms refuses the
              finetune) at their phase 6 shapes, the crosscoder's decoder-norm
              CSV equal to its finetuned parameters' norms; (f)
              write_feature_report on (a)'s folder, embedding (d)'s PNGs.
 15. mesh:    the data- and tensor-parallel trainers (parallel/), every world of
              ranks on this one card over gloo (torch.distributed's other
              backend, NCCL, takes one card a rank), spawned with
              parallel/distributed.spawn: (e) first the twelve TP rows'
              wrappers (ReLU, gated, JumpReLU, Matryoshka at the snapshot
              union MESH_UNION: rows 15-22 at a (2, 2) rank's shard, T
              16,384, C 256, H 8,192; the transcoder, rows 23-24, at T
              16,384, 256 -> 480, H 8,192; the crosscoder, rows 25-26, at T
              8,192, ΣC 2,896, H 4,096) against their plain versions in f32
              and bf16, bf16 repeats bitwise, timed beside their bounds and
              the cuBLAS products; then the one-rank Pipeline.run of each
              MESH_RUNS config and of phase 6's transcoder and crosscoder
              (their caches the mesh runs read); then one (2, 2) world: (a)
              the ReLU, gated, JumpReLU (θ in MESH_THETA, ε MESH_BANDWIDTH),
              Matryoshka (MESH_PREFIXES, which cut rank 1's shard) and TopK
              (phase 11's k) TP ops at T 32,768, C 256, H 16,384, and the
              transcoder's and crosscoder's TP ops at phase 6's shapes, in
              f32 and bf16 on each rank's shard, loss terms (the coders'
              global rmse and nrmse too) and gathered gradients and
              statistics held on rank 0 to the single-rank op on the whole
              batch (MESH_OP_TOL; counts equal; TopK in bf16 against its TP
              op on a mesh of one rank); (b) Pipeline.run of sae_mlp at
              mesh_shape (2, 2) (resets at 4 and 12, the resample at 9), (c)
              of gated_sae, (g) of jumprelu_sae, matryoshka_sae (restarts at
              4, 8, 12) and topk_sae (phase 11's k, no AuxK, f32: MESH_RUNS)
              and (h) of phase 6's transcoder and crosscoder (resets at 4 and
              12, the resample at 9), each rank's TP kernels launched 12
              times, and the cluster pair's body under its backward (the
              ReLU, gated, JumpReLU and Matryoshka runs, where bwd_route
              gives the shard the pair) 12 times and the other pair bodies
              never (counts set to 0 just before each run and read just
              after), held to the one-rank run by _check_mesh_run: the
              restarts at its steps, each step's loss terms and perc_dead
              (MESH_STEP_RTOL, MESH_DEAD_ATOL), rank 0's dead accumulator
              equal, each resample's dead mask (at most MESH_FLIPS_MAX latents
              apart, each at the margin), the parameters' median and 99th
              percentile latent gap and b_dec's (MESH_PARAM_LIMITS by
              variant), the replicated parameters' Adam moments
              (MESH_MOMENT_LIMITS; chip_mesh_checks.py plants six faults that
              fail these checks); each run prints rank 0's host ms of
              collectives a step; (e) the host ms of one TP step's
              collectives at the shard, labelled as gloo across ranks that
              share one card; then a (2,) world: (d) sae_mlp data parallel
              the same way through rows 1-2, (i) the transcoder and the
              crosscoder through rows 11-14; then (f) a (2, 2) world whose
              rank 3 raises fails the phase's spawn with that rank's
              traceback, the waiting ranks killed.
 16. sweep:   the vmapped hyperparameter sweep (train/sweep_vmap.py): (a)
              the eight sweep kernels (the ReLU, gated, JumpReLU and
              Matryoshka forwards and backwards with the combo on the grid's
              y dimension) at bench_sweep.py's shape (T 4,096, C 256, H
              2,048) for N 4, 8 and 16, in f32 and bf16, and at the ragged
              shape with N 3: every combo of a launch bitwise equal to a
              one-dictionary launch on its slices, the outputs against the
              stacked plain versions, 20 bitwise-equal bf16 launches at N 8;
              the batched launch, the loop of N one-dictionary launches, the
              plain version and the batched cuBLAS products (torch.bmm)
              timed, against N times one dictionary's bound; (b)
              train_sae_sweep_cached of four sae_mlp combos on phase 6's
              north-star config (12 steps, the resample at 9), exactly 12 +
              12 launches of the batched pair and none other, combo 0 (phase
              6's own λ and learning rate) held to phase 6's final
              parameters (SWEEP_REF_ATOL), and sweep_combo_tokens_per_sec
              beside one run's tokens/s; (c) the gated, JumpReLU and
              Matryoshka fused sweep steps (f32, the bench shape, four
              combos, four steps), each combo against its single-device
              step; (d) the transcoder and crosscoder sweeps (the stock math
              under torch.func.vmap, as JAX's) through their trainers at a
              small depth, no fused launch.
Wherever grid_split (ops/fused_sae.py) cuts a timed bf16 launch into parts
on the grid's z dimension (csrc/coder.cuh, "Splits": rows 25-26 in phase 15
(e), phase 12's backwards at 64 and 96 latent blocks, phase 16 (a)'s
backwards at N 1 and 8), the split launch, the one held to its plain version
and repeated bitwise above, is timed beside the same launch unsplit
(n_split=1), in turns, and both are printed ("[split]" lines).
Then one JSON line of those pairs ({"splits": [...]}), one of the held and
cluster-pair launches beside coder_bwd_tc ({"routes": [...]}), one JSON line
naming each kernel (the held passes' launches from phase 6's transcoder
slice, the cluster pair's from its jumprelu_sae slice (Act::Jump) and its
matryoshka_sae slice (Act::Relu: the sae_mlp slice's 12 too); the TP
rows' summed over the ranks of (b), (c), (g) and (h); the sweep rows' from
phase 16 (b) and (c)), the nvidia-smi line, and the last line {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import glob
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from sparse_vision_tpu_torch.config import RunConfig
from sparse_vision_tpu_torch.data.datasets import ArrayDataset, load_data, make_synthetic
from sparse_vision_tpu_torch.models.crosscoder import (
    crosscoder_inference_and_loss,
    init_crosscoder,
)
from sparse_vision_tpu_torch.models.sae import (
    DEFAULT_MATRYOSHKA_PREFIXES,
    init_gated_sae,
    init_jumprelu_sae,
    init_sae_mlp,
    init_transcoder,
    matryoshka_prefix_counts,
    matryoshka_sae_apply,
    sae_inference_and_loss,
    topk_aux_loss,
    transcoder_inference_and_loss,
)
from sparse_vision_tpu_torch.ops import (
    fused_crosscoder,
    fused_gated_sae,
    fused_jumprelu_sae,
    fused_matryoshka_sae,
    fused_sae,
    fused_sae_tp,
    fused_transcoder,
    native,
    optim,
)
from sparse_vision_tpu_torch.ops.fast_batch_topk import (
    fast_batch_topk_sae_loss_terms,
    kth_largest,
)
from sparse_vision_tpu_torch.ops.fast_topk_sae import GatherDecode, fast_topk_sae_loss_terms
from sparse_vision_tpu_torch.train import checkpoint as ckpt
from sparse_vision_tpu_torch.train import steps as tsteps
from sparse_vision_tpu_torch.train.pipeline import Pipeline
from sparse_vision_tpu_torch.utils.paths import sae_run_name

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "_smoke_work"  # listed in .gitignore; removed at the end
DEVICE = "cuda"

# H100 SXM data sheet, dense: bf16 tensor cores, f32 outside them; HBM3 rate
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

T, C, H = 32768, 256, 16384
TC_T, TC_CIN, TC_COUT, TC_H = 32768, 256, 480, 16384  # transcoder mixed3a -> mixed3b
CC_T, CC_DIMS, CC_H = 16384, (512, 512, 512, 528, 832), 8192  # crosscoder mixed4a..4e
LAMBDA = 5.0  # sae_mlp and gated_sae
# jumprelu_sae: λ, and the STE bandwidth of the kernel and parity phases, whose
# inputs give pre-activations of std ~2
LAMBDA_J, BANDWIDTH = 0.02, 1.0
REPS = 5  # timed launches per measurement, after one warm-up

MODULES = {"sae_mlp": fused_sae, "gated_sae": fused_gated_sae,
           "jumprelu_sae": fused_jumprelu_sae, "matryoshka_sae": fused_matryoshka_sae,
           "transcoder": fused_transcoder, "crosscoder": fused_crosscoder}
KERNELS = tuple(k for m in MODULES.values() for k in m.KERNELS)
# the source of each kernel's body (bf16, the main path's); the coder family's
# entry points are in fused_sae.cu (the ReLU and Matryoshka SAEs),
# fused_jumprelu_sae.cu and fused_gated_sae.cu (the JumpReLU and gated SAEs) and
# fused_transcoder.cu (the coders)
CODER = "sparse_vision_tpu_torch/csrc/coder.cuh"
SOURCES = {
    "fused_sae_fwd": CODER, "fused_sae_bwd": CODER,
    "fused_sae_dx": CODER,  # bf16: coder_fwd_tc_hold<256, false, Act::Relu, true> (kDx)
    "fused_matryoshka_sae_fwd": CODER, "fused_matryoshka_sae_bwd": CODER,
    "fused_matryoshka_sae_dx": CODER,
    "fused_jumprelu_sae_fwd": CODER,  # bf16: coder_fwd_tc_hold<256, false, Act::Jump>
    "fused_jumprelu_sae_bwd": CODER,  # bf16: coder_bwd_pair<Act::Jump> (C <= 256)
    # bf16 at C <= 256 (fused_sae.bwd_route): coder_bwd_pair<Act::Relu>
    "fused_gated_sae_fwd": CODER,  # bf16: coder_fwd_tc_hold<256, false, Act::Gated>
    "fused_gated_sae_bwd": CODER,  # bf16: coder_bwd_pair<Act::Gated> (C <= 256)
    "fused_transcoder_fwd": CODER, "fused_transcoder_bwd": CODER,
    "fused_crosscoder_fwd": CODER, "fused_crosscoder_bwd": CODER,
    # the TP sites run the same bodies on a latent shard (ops/fused_sae_tp.py)
    "fused_sae_tp_fwd": CODER, "fused_sae_tp_bwd": CODER,
    "fused_gated_sae_tp_fwd": CODER, "fused_gated_sae_tp_bwd": CODER,
    "fused_jumprelu_sae_tp_fwd": CODER, "fused_jumprelu_sae_tp_bwd": CODER,
    "fused_matryoshka_sae_tp_fwd": CODER, "fused_matryoshka_sae_tp_bwd": CODER,
    "fused_transcoder_tp_fwd": CODER, "fused_transcoder_tp_bwd": CODER,
    "fused_crosscoder_tp_fwd": CODER, "fused_crosscoder_tp_bwd": CODER,
    # the held backward route's two passes (coder_bwd_held), under rows 12 and
    # 24's wrappers (fused_sae.bwd_route)
    "coder_bwd_held_enc": CODER, "coder_bwd_held_dec": CODER,
    # the cluster-pair backward (coder_bwd_pair), under rows 5, 20 and 32's
    # wrappers (Act::Jump) and rows 2, 9, 16, 22, 28 and 34's (Act::Relu;
    # fused_sae.bwd_route)
    "coder_bwd_pair": CODER, "coder_bwd_pair_relu": CODER, "coder_bwd_pair_gated": CODER,
}
REPLACES = {
    "fused_sae_fwd": "sparse_vision_tpu/ops/fused_sae.py:43",
    "fused_sae_bwd": "sparse_vision_tpu/ops/fused_sae.py:96",
    "fused_sae_dx": "sparse_vision_tpu/ops/fused_sae.py:168",
    "fused_matryoshka_sae_fwd": "sparse_vision_tpu/ops/fused_matryoshka_sae.py:99",
    "fused_matryoshka_sae_bwd": "sparse_vision_tpu/ops/fused_matryoshka_sae.py:155",
    "fused_matryoshka_sae_dx": "sparse_vision_tpu/ops/fused_matryoshka_sae.py:227",
    "fused_jumprelu_sae_fwd": "sparse_vision_tpu/ops/fused_jumprelu_sae.py:30",
    "fused_jumprelu_sae_bwd": "sparse_vision_tpu/ops/fused_jumprelu_sae.py:80",
    "fused_gated_sae_fwd": "sparse_vision_tpu/ops/fused_gated_sae.py:42",
    "fused_gated_sae_bwd": "sparse_vision_tpu/ops/fused_gated_sae.py:98",
    "fused_transcoder_fwd": "sparse_vision_tpu/ops/fused_transcoder.py:41",
    "fused_transcoder_bwd": "sparse_vision_tpu/ops/fused_transcoder.py:91",
    "fused_crosscoder_fwd": "sparse_vision_tpu/ops/fused_crosscoder.py:68",
    "fused_crosscoder_bwd": "sparse_vision_tpu/ops/fused_crosscoder.py:109",
    "fused_sae_tp_fwd": "sparse_vision_tpu/ops/fused_sae_tp.py:65",
    "fused_sae_tp_bwd": "sparse_vision_tpu/ops/fused_sae_tp.py:102",
    "fused_gated_sae_tp_fwd": "sparse_vision_tpu/ops/fused_sae_tp.py:275",
    "fused_gated_sae_tp_bwd": "sparse_vision_tpu/ops/fused_sae_tp.py:341",
    "fused_jumprelu_sae_tp_fwd": "sparse_vision_tpu/ops/fused_sae_tp.py:463",
    "fused_jumprelu_sae_tp_bwd": "sparse_vision_tpu/ops/fused_sae_tp.py:526",
    "fused_matryoshka_sae_tp_fwd": "sparse_vision_tpu/ops/fused_sae_tp.py:721",
    "fused_matryoshka_sae_tp_bwd": "sparse_vision_tpu/ops/fused_sae_tp.py:803",
    # the coders' TP ops call the single-device pallas_calls (:227 / :264, :238 /
    # :274) on the shard: their call sites in make_fused_*_tp_op
    "fused_transcoder_tp_fwd": "sparse_vision_tpu/ops/fused_transcoder.py:318",
    "fused_transcoder_tp_bwd": "sparse_vision_tpu/ops/fused_transcoder.py:362",
    "fused_crosscoder_tp_fwd": "sparse_vision_tpu/ops/fused_crosscoder.py:399",
    "fused_crosscoder_tp_bwd": "sparse_vision_tpu/ops/fused_crosscoder.py:450",
    # each pass computes part of the transcoder backward kernel's outputs:
    # dW_enc and db_enc, or dW_dec and db_dec
    "coder_bwd_held_enc": "sparse_vision_tpu/ops/fused_transcoder.py:91",
    "coder_bwd_held_dec": "sparse_vision_tpu/ops/fused_transcoder.py:91",
    # the JumpReLU backward kernel's whole function, in two CTAs a latent block
    "coder_bwd_pair": "sparse_vision_tpu/ops/fused_jumprelu_sae.py:80",
    # the ReLU SAE backward kernel's (and, level by level, the Matryoshka one's)
    "coder_bwd_pair_relu": "sparse_vision_tpu/ops/fused_sae.py:96",
    # the gated SAE backward kernel's
    "coder_bwd_pair_gated": "sparse_vision_tpu/ops/fused_gated_sae.py:98",
}
HELD_KERNELS = fused_transcoder.HELD_PASSES
# the cluster pair's body counters: the JumpReLU SAE's (Act::Jump), the ReLU
# and Matryoshka SAEs' (Act::Relu) and the gated SAE's (Act::Gated)
PAIR_KERNELS = (fused_jumprelu_sae.pair_kernel, fused_sae.pair_kernel,
                fused_gated_sae.pair_kernel)
BODY_KERNELS = HELD_KERNELS + PAIR_KERNELS  # counted beside their launching wrappers


def log(msg: str) -> None:
    print(msg, flush=True)


def set_tf32(enabled: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(flops: float, moved: int, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; no result")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"count {torch.cuda.device_count()} kind {torch.cuda.get_device_name(0)}")
    return smi.splitlines()[0]


def phase_build() -> None:
    """Build every kernel and print ptxas's report; a kernel that spills
    registers to local memory fails the phase."""
    t0 = time.perf_counter()
    built = native.build()
    for name, b in built.items():
        ptxas = [ln.strip() for ln in b["log"].splitlines()
                 if "Function properties" in ln or "registers" in ln or "spill" in ln]
        log(f"[build] {name}: {b['seconds']:.1f} s -> {b['path']}")
        for ln in ptxas:
            log(f"[build]   {ln}")
        for kernel, regs, spill in _ptxas_kernels(b["log"]):
            before = REGISTERS_BEFORE.get(re.sub(r"^(coder_fwd_tc\w*<.*), false>$", r"\1>", kernel))
            note = "" if before is None else (
                f" (before: {before}{'' if before == regs else ', moved'})")
            log(f"[build]   {regs} registers, {spill} spill bytes: {kernel}{note}")
        spills = [ln for ln in ptxas if re.search(r"[1-9]\d* bytes spill (stores|loads)", ln)]
        if spills:
            raise AssertionError(f"{name}: ptxas reports register spills: {spills}")
        for body, route, counts in (("coder_bwd_held", "held", HELD_SOURCES),
                                    ("coder_bwd_pair", "pair", PAIR_SOURCES)):
            found = [k for k in _ptxas_kernels(b["log"]) if body in k[0]]
            if b["log"] and len(found) != counts.get(name, 0):
                raise AssertionError(f"{name}: expected {counts.get(name, 0)} {body} "
                                     f"instantiations in ptxas's report, found {len(found)}")
            for kernel, regs, spill in found:
                log(f"[build]   {route} route: {regs} registers, {spill} spill bytes: {kernel}")
    for act, mod in (("Act::Jump", fused_jumprelu_sae), ("Act::Relu", fused_sae),
                     ("Act::Gated", fused_gated_sae)):
        log(f"[build] pair route, coder_bwd_pair<{act}>: {mod.pair_clusters()} clusters of "
            "two CTAs resident at once (cudaOccupancyMaxActiveClusters)")
    log(f"[build] all kernels in {time.perf_counter() - t0:.1f} s")


# the held backward route's instantiations a source builds (coder.cuh bwd_held:
# pass E and pass D, in the coders' source only)
HELD_SOURCES = {"fused_transcoder": 2}
# the cluster-pair route's (coder.cuh bwd_pair: Act::Jump in the JumpReLU source,
# Act::Relu in the ReLU and Matryoshka SAEs' source, Act::Gated in the gated
# SAE's, and no other source any)
PAIR_SOURCES = {"fused_jumprelu_sae": 1, "fused_sae": 1, "fused_gated_sae": 1}


# ptxas registers of the coder family's instantiations (nvcc 12.8, sm_90a; this
# script's build phase on an H100 host): the bf16 bodies' before the dx route
# (kDx) joined the forward bodies, the SIMT bodies' Act::Relu instantiations
# before the kAct epilogues joined them (the parent's sources built beside).
# The build phase prints each instantiation here beside its count: neither
# change moved them; the combo axis (PR 21) moved some by -12 to +28 (the SIMT
# bodies most), with no spill.
REGISTERS_BEFORE = {
    "coder_fwd_kernel<float, true, false, Act::Relu>": 122,
    "coder_fwd_kernel<float, false, false, Act::Relu>": 181,
    "coder_fwd_kernel<float, false, true, Act::Relu>": 216,
    "coder_fwd_tc<true, Act::Relu>": 255, "coder_fwd_tc<false, Act::Relu>": 247,
    "coder_fwd_tc_hold<512, true, Act::Relu>": 255,
    "coder_fwd_tc_hold<512, false, Act::Relu>": 254,
    "coder_fwd_tc_hold<256, true, Act::Relu>": 225,
    "coder_fwd_tc_hold<256, false, Act::Relu>": 218,
    "coder_fwd_tc<false, Act::Jump>": 251, "coder_fwd_tc_hold<512, false, Act::Jump>": 255,
    "coder_fwd_tc_hold<256, false, Act::Jump>": 226,
    "coder_fwd_tc<false, Act::GatedEnc>": 246,
    "coder_fwd_tc_hold<512, false, Act::GatedEnc>": 254,
    "coder_fwd_tc<false, Act::GatedPi>": 192, "coder_fwd_tc_hold<512, false, Act::GatedPi>": 248,
    "coder_fwd_tc_hold<256, false, Act::Gated>": 255,
    "coder_bwd_kernel<float, true, Act::Relu>": 197,
    "coder_bwd_kernel<float, false, Act::Relu>": 189,
    "coder_bwd_tc<true, Act::Relu>": 251, "coder_bwd_tc<false, Act::Relu>": 254,
    "coder_bwd_tc<true, Act::Jump>": 248, "coder_bwd_tc<true, Act::Gated>": 254,
}


def _ptxas_kernels(ptxas_log: str) -> list:
    """(kernel, registers, spill bytes) of every entry function in a ptxas -v
    report, the names demangled by c++filt where the toolkit's host has it."""
    rows, name, spill = [], None, 0
    for ln in ptxas_log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", ln):
            name, spill = m.group(1), 0
        elif (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)) and name:
            spill = int(m.group(1)) + int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", ln)) and name:
            rows.append([name, int(m.group(1)), spill])
            name = None
    if rows and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows), text=True,
                             capture_output=True, check=True).stdout.splitlines()
        for r, n in zip(rows, out):
            depth = 0  # cut the parameter list, the last balanced (...)
            for i in range(len(n) - 1, -1, -1):
                depth += {")": 1, "(": -1}.get(n[i], 0)
                if depth == 0:
                    n = n[:i]
                    break
            n = n.removeprefix("void ").replace("(anonymous namespace)::", "")
            for k, act in enumerate(("Relu", "Jump", "Gated", "GatedEnc", "GatedPi")):
                n = n.replace(f"(Act){k}", f"Act::{act}")
            r[0] = n
    return rows


def _check(name: str, got, ref, rtol: float, atol_frac: float) -> float:
    """Max abs error of got vs ref; fails when it exceeds rtol*|ref| + atol_frac*max|ref|."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    scale = ref.abs().max().item()
    tol = rtol * ref.abs() + atol_frac * max(scale, 1e-30)
    worst = err.max().item()
    log(f"[kernels]   {name}: max_abs_err {worst:.3e} (max|ref| {scale:.3e}, "
        f"max rel {(err / ref.abs().clamp(min=1e-30)).max().item():.3e})")
    if not bool((err <= tol).all()):
        raise AssertionError(f"{name}: kernel disagrees with the plain version "
                             f"(max abs err {worst:.3e})")
    return worst


def _measure(name: str, tag: str, cd, kernel, plain, library, flops: float, moved: int,
             max_abs_err: float) -> dict:
    """Times of kernel, plain version and the stock path's cuBLAS products, the
    bound and the achieved rate; one row of the kernels line."""
    ms = time_ms(kernel, REPS)
    plain_ms = time_ms(plain, REPS)
    lib_ms = time_ms(library, REPS)
    b_ms, b_by = bound(flops, moved, cd)
    tflops = flops / ms / 1e9
    log(f"[kernels] {name} [{tag}] ms {ms:.3f} plain_ms {plain_ms:.3f} "
        f"library_ms {lib_ms:.3f} bound_ms {b_ms:.4f} ({b_by}) TFLOP/s {tflops:.1f}")
    return dict(max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, tflops=tflops)


SPLITS = []  # the split launches timed beside their unsplit ones: the "splits" line
SPLIT_REPS = 20  # timed launches a turn: the pairs differ by a few percent at N 8


def _split_pair(name: str, tag: str, launch, t: int, h: int, c_out: int,
                backward: bool, pair: bool = False, whole: bool = False) -> None:
    """Where grid_split cuts this bf16 launch of one dictionary's (t, h, c_out;
    ``pair``: the cluster-pair backward's grid) into parts (csrc/coder.cuh,
    "Splits"), time ``launch()`` (the rule's split,
    the launch the checks hold to the plain version) beside
    ``launch(n_split=1)`` (the same launch unsplit) in turns, split, unsplit,
    unsplit, split, and record both for the splits line. Where the rule leaves
    the launch whole and ``whole`` is set, time it beside ``launch(n_split=2)``
    the same way (the other side of the rule's boundary)."""
    s = fused_sae.grid_split(t, h, c_out, backward=backward,
                             n_sm=fused_sae.sm_count(torch.cuda.current_device()), pair=pair)
    if s == 1 and not whole:
        return
    other = 1 if s > 1 else 2
    first = time_ms(launch, SPLIT_REPS)
    alt = time_ms(lambda: launch(n_split=other), SPLIT_REPS)
    alt += time_ms(lambda: launch(n_split=other), SPLIT_REPS)
    rule_ms = (first + time_ms(launch, SPLIT_REPS)) / 2
    if s > 1:
        row = dict(name=name, tag=tag, n_split=s, ms=rule_ms, unsplit_ms=alt / 2)
        log(f"[split] {name} [{tag}] n_split {s} ms {rule_ms:.3f} unsplit_ms {alt / 2:.3f} "
            f"({alt / 2 / rule_ms:.2f}x)")
    else:
        row = dict(name=name, tag=tag, n_split=1, ms=rule_ms, unsplit_ms=rule_ms,
                   split_2_ms=alt / 2)
        log(f"[split] {name} [{tag}] whole (n_split 1) ms {rule_ms:.3f} n_split 2 ms "
            f"{alt / 2:.3f} ({alt / 2 / rule_ms:.2f}x)")
    SPLITS.append(row)


# held and pair launches timed beside coder_bwd_tc on the same launch: the "routes" line
ROUTES = []
HELD_NAMES = {"E": ("dW_enc", "db_enc"), "D": ("dW_dec", "db_dec")}


def _held_pair(name: str, tag: str, launch, bops: tuple, ct, timed: bool = True) -> dict:
    """Where bwd_route sends this bf16 transcoder backward to the held passes
    (rows 12 and 24; kernels_coder_ragged's partial-step and split launches): ``launch()`` (the
    wrapper's launch, both passes) with each pass's outputs held to its plain
    version (coder_bwd_enc_plain, coder_bwd_dec_plain on ``bops`` = (x, W_enc,
    b_enc, W_dec, err, coeffs) and the L1 cotangent ``ct``) at the backward
    checks' tolerances, REPEATS launches bitwise equal; with ``timed`` then
    timed beside ``launch(route="tc")`` (the same launch on coder_bwd_tc) in
    turns, held, tc, tc, held, and recorded for the routes line. Returns each
    pass's max abs error."""
    x, we, be, wd, res, coeffs = bops[:6]
    dw_enc, db_enc, dw_dec, db_dec = launch()
    got = {"E": (dw_enc, db_enc), "D": (dw_dec, db_dec)}
    want = {"E": fused_sae.coder_bwd_enc_plain(x, we, be, wd, res, coeffs[0], ct),
            "D": fused_sae.coder_bwd_dec_plain(x, we, be, res, coeffs[0])}
    torch.cuda.synchronize()
    log(f"[kernels] {name} [{tag}] held passes vs their plain versions")
    errs = {p: max(_check(f"pass {p} {n}", a, b, 1e-3, 1e-4)
                   for n, a, b in zip(HELD_NAMES[p], got[p], want[p])) for p in want}
    del got, want, dw_enc, db_enc, dw_dec, db_dec
    first = launch()
    for _ in range(REPEATS - 1):
        if not all(torch.equal(a, b) for a, b in zip(first, launch())):
            raise AssertionError(f"{name}: held launches on the same inputs differ")
    log(f"[kernels]   {name}: {REPEATS} held launches bitwise equal")
    del first
    if timed:
        _route_timing(name, tag, "held", launch)
    return errs


def _route_timing(name: str, tag: str, route: str, launch) -> None:
    """``launch()`` (the wrapper's launch, on the body bwd_route gives it:
    "held" or "pair") timed beside ``launch(route="tc")`` (the same launch on
    coder_bwd_tc) in turns, route, tc, tc, route, and recorded for the routes
    line."""
    ms = time_ms(launch, SPLIT_REPS)
    tc = time_ms(lambda: launch(route="tc"), SPLIT_REPS)
    tc = (tc + time_ms(lambda: launch(route="tc"), SPLIT_REPS)) / 2
    ms = (ms + time_ms(launch, SPLIT_REPS)) / 2
    log(f"[route] {name} [{tag}] {route} ms {ms:.3f} coder_bwd_tc ms {tc:.3f} "
        f"({tc / ms:.2f}x)")
    ROUTES.append(dict(name=name, tag=tag, route=route, ms=ms, tc_ms=tc))


def _jump_route(cd, c: int) -> str:
    """The body bwd_route gives a JumpReLU backward of width c in dtype cd."""
    return fused_sae.bwd_route(c, c, act="jump", dtype=cd)


def _sae_route(cd, c: int, levels: int = 1) -> str:
    """The body bwd_route gives a ReLU (one level) or Matryoshka SAE backward
    of width c in dtype cd."""
    return fused_sae.bwd_route(c, c, levels, act="sae", dtype=cd)


def _gated_route(cd, c: int) -> str:
    """The body bwd_route gives a gated backward of width c in dtype cd."""
    return fused_sae.bwd_route(c, c, act="gated", dtype=cd)


def _held_pass_rows(tag: str, bops: tuple, post, errs: dict) -> dict:
    """The kernels line's rows of the two held passes at the transcoder's
    training shape (row 12's launch, phase 6's main path), each pass launched
    alone (the wrapper's routes "held E" / "held D"): ms, its plain version's,
    its bound (pass E: 2·T·H·(2·C_in + C_out) FLOP, pass D: 2·T·H·(C_in +
    C_out), which recomputes pre) and the cuBLAS products of the same work."""
    x, we, be, wd, res, coeffs = bops
    t, c_in = x.shape
    h, c_out = wd.shape
    dr = (coeffs[0] * res.float()).to(x.dtype)
    k = fused_transcoder.bwd_kernel
    rows = {}
    for kern, route, flops, moved, plain, library in (
            (fused_transcoder.held_enc_kernel, "held E", 2.0 * t * h * (2 * c_in + c_out),
             nbytes(x, we, be, wd, res, coeffs) + 4 * (c_in * h + h),
             lambda: fused_sae.coder_bwd_enc_plain(x, we, be, wd, res, coeffs[0], coeffs[1]),
             lambda: (x @ we, dr @ wd.T, x.T @ post)),
            (fused_transcoder.held_dec_kernel, "held D", 2.0 * t * h * (c_in + c_out),
             nbytes(x, we, be, res, coeffs) + 4 * (h * c_out + c_out),
             lambda: fused_sae.coder_bwd_dec_plain(x, we, be, res, coeffs[0]),
             lambda: (x @ we, post.T @ dr))):
        rows[kern.name] = _measure(kern.name, tag, x.dtype, lambda: k(*bops, route=route),
                                   plain, library, flops, moved, errs[route[-1]])
    return rows


def _dyadic(t: torch.Tensor, step: float) -> torch.Tensor:
    """``t`` rounded to a multiple of the power of two ``step``."""
    return torch.round(t / step) * step


def _odd_grid(gen, n: int, half_range: int) -> torch.Tensor:
    """Odd multiples of 2^-11 in about ±half_range·2^-10: as biases on top of a
    product that is an exact multiple of 2^-10, the sum is never 0."""
    k = torch.randint(-half_range, half_range, (n,), device=DEVICE, generator=gen)
    return (2 * k + 1).float() * 2.0 ** -11


def _exact_inputs(gen, n_tokens: int, w: torch.Tensor):
    """Token input and encoder weights on a dyadic grid (x in quarters, W in
    1/256ths, b_dec in quarters): every product and partial sum of x_cent @ W is
    exact in f32, so the kernel and cuBLAS, which sum in other orders, give the
    same pre-activations bit for bit. The gated and JumpReLU activations jump at
    a threshold, so a pre-activation that differed by one rounding could switch a
    latent on in one and off in the other; on this grid none can."""
    x = _dyadic(torch.relu(torch.randn(n_tokens, w.shape[0], device=DEVICE, generator=gen))
                * 2.0, 0.25)
    b_dec = _dyadic(0.2 * torch.randn(w.shape[0], device=DEVICE, generator=gen), 0.25)
    return x, _dyadic(w, 2.0 ** -8), b_dec


# ---------------------------------------------------------------------------
# kernels phase, one function per fused op; each returns {kernel name: row}
# ---------------------------------------------------------------------------

def _sae_fwd_check(mod, tag: str, cd, ops, extra=(), exact: bool = False, label: str = "",
                   kernel=None):
    """The SAE op ``mod``'s forward entry point (fused_sae or
    fused_matryoshka_sae) on the card, through ``kernel`` (default its own
    wrapper), against its plain reference on the same inputs; bf16 launches
    repeat bitwise. Returns (x_cent, the plain outputs, max abs err of the
    reconstruction)."""
    fwd = mod.fused_sae_forward if mod is fused_sae else mod.fused_matryoshka_forward
    plain = (mod.fused_sae_forward_plain if mod is fused_sae
             else mod.fused_matryoshka_forward_plain)
    kernel = kernel or mod.fwd_kernel
    x, bd = ops[0], ops[4]
    out_k = fwd(*ops, *extra, kernel=kernel)
    out_p = plain(*ops, *extra)
    torch.cuda.synchronize()
    log(f"[kernels] {kernel.name} [{tag}{label}] vs plain")
    if cd == torch.bfloat16:
        _repeatable(kernel.name, kernel(*ops, *extra), kernel(*ops, *extra))
    if not torch.equal(out_k[0], x - bd.to(cd)):
        raise AssertionError(f"{kernel.name}: x_cent differs from x - round(b_dec)")
    # on _exact_inputs' grid the pre-activations are exact on both sides, so the
    # counts agree exactly; else a pre-activation within rounding of 0 may flip,
    # so counts get a tolerance of a few tokens
    count_tol = 0.0 if exact else 1e-3
    err = _check("recon", out_k[1], out_p[0], 1e-4, 1e-5)
    _check("act_count", out_k[2], out_p[1], 0.0, count_tol)
    _check("row_active", out_k[3], out_p[2], 0.0, count_tol)
    _check("l1_sum", out_k[4], out_p[3], 1e-5, 0.0)
    return out_k[0], out_p, err


def _sae_bwd_check(mod, tag: str, cd, ops, x_cent, err_in, coeffs, extra=(), label: str = "",
                   kernel=None) -> tuple:
    """The SAE op's backward entry point on x_cent, through ``kernel`` (default
    its own wrapper), against the plain version of its route (backward_plain:
    in bf16 at C <= 256 the cluster pair's pre-pass and body) on x_cent, which
    the forward check held to x - round(b_dec); bf16 launches repeat bitwise,
    REPEATS of them where bwd_route gives the launch the cluster pair. Returns
    (plain grads, max abs err)."""
    bwd = mod.fused_sae_backward if mod is fused_sae else mod.fused_matryoshka_backward
    kernel = kernel or mod.bwd_kernel
    _, we, be, wd, _ = ops
    bops = (x_cent, we, be, wd, err_in, coeffs, *extra)
    g_k = bwd(*bops, kernel=kernel)
    *g_p, db_dec_part = mod.backward_plain(*bops)
    g_p = (*g_p, db_dec_part.sum(0))
    torch.cuda.synchronize()
    log(f"[kernels] {kernel.name} [{tag}{label}] vs plain")
    if cd == torch.bfloat16:
        pair = _sae_route(cd, x_cent.shape[-1], len(extra[0]) if extra else 1) == "pair"
        first = kernel(*bops)
        for _ in range(REPEATS - 1 if pair else 1):
            _repeatable(kernel.name, first, kernel(*bops))
        if pair:
            log(f"[kernels]   {kernel.name}: {REPEATS} launches on the cluster pair bitwise equal")
        del first
    err = max(_check(n, a, b, 1e-3, 1e-4)
              for n, a, b in zip(("dW_enc", "db_enc", "dW_dec", "db_dec"), g_k, g_p))
    return g_p, err


def kernels_relu(cd, tag: str, t: int = T, c: int = C, h: int = H) -> dict:
    """The ReLU SAE op's forward and backward at [t, c] with h latents (the
    training shape by default) against their plain versions; timed."""
    # on _exact_inputs' grid: the tensor cores' sums of the encode run in another
    # order and rounding than cuBLAS's, and off the grid a pre-activation that
    # moved by a rounding flips round_bf16(post) by a bf16 ulp in the decode
    ops = _relu_exact_operands(cd, t, c, h)
    x, we, be, wd, bd = ops
    label = "" if (t, c, h) == (T, C, H) else f", C={c} T={t} H={h}"
    x_cent, out_p, err = _sae_fwd_check(fused_sae, tag, cd, ops, exact=True, label=label)
    xc = x - bd.to(cd)
    post = torch.relu(xc @ we).to(cd)
    rows = {"fused_sae_fwd": _measure(
        "fused_sae_fwd", f"{tag}{label}", cd, lambda: fused_sae.fused_sae_forward(*ops),
        lambda: fused_sae.fused_sae_forward_plain(*ops),
        lambda: (xc @ we, post @ wd), 4.0 * t * c * h,
        nbytes(*ops) + nbytes(out_p[0], out_p[1], out_p[2]) + 4, err)}

    res = (out_p[0] - x.float()).to(cd)  # the residual the backward reads
    del out_p
    coeffs = torch.tensor([2.0 / (t * c), LAMBDA / (t * h)], device=DEVICE)
    g_p, err = _sae_bwd_check(fused_sae, tag, cd, ops, x_cent, res, coeffs, label=label)
    moved = nbytes(*ops, res, coeffs) + nbytes(*g_p)
    del g_p
    dr = (coeffs[0] * res.float()).to(cd)
    rows["fused_sae_bwd"] = _measure(
        "fused_sae_bwd", f"{tag}{label}", cd,
        lambda: fused_sae.fused_sae_backward(x_cent, we, be, wd, res, coeffs),
        lambda: fused_sae.fused_sae_backward_plain(*ops, res, coeffs),
        lambda: (dr @ wd.T, xc.T @ post, post.T @ dr), 8.0 * t * c * h, moved, err)
    if cd == torch.bfloat16:
        pair = _sae_route(cd, c) == "pair"
        bwd = lambda **kw: fused_sae.bwd_kernel(x_cent, we, be, wd, res, coeffs, **kw)  # noqa: E731
        _split_pair("fused_sae_fwd", f"{tag}{label}",
                    lambda **kw: fused_sae.fwd_kernel(*ops, **kw), t, h, c, False)
        _split_pair("fused_sae_bwd", f"{tag}{label}", bwd, t, h, c, True, pair=pair)
        if pair:  # rows 2's launch runs coder_bwd_pair<Act::Relu>: its row comes last
            _route_timing("fused_sae_bwd", f"{tag}{label}", "pair", bwd)
    return rows


def _gated_ops(cd) -> tuple:
    """Rows 6 and 7's forward operands at the training shape (seed 0)."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = init_gated_sae(gen, C, H // C)
    x, wg, bd = _exact_inputs(gen, T, params["W_gate"])
    x, wg, wd = x.to(cd), wg.to(cd), params["W_dec"].to(cd).contiguous()
    bg = _odd_grid(gen, H, 100)  # about ±0.05
    bm = _odd_grid(gen, H, 60)
    er = torch.exp(0.1 * torch.randn(H, device=DEVICE, generator=gen))
    return x, wg, bg, bm, er, wd, bd


def kernels_gated(cd, tag: str) -> dict:
    ops = _gated_ops(cd)
    out_p, err = _act_fwd_check(fused_gated_sae, tag, cd, ops)
    rows = {"fused_gated_sae_fwd": _measure(
        "fused_gated_sae_fwd", tag, cd, lambda: fused_gated_sae.fwd_kernel(*ops),
        lambda: fused_gated_sae.fused_gated_forward_plain(*ops),
        _act_fwd_library(fused_gated_sae, ops), 6.0 * T * C * H,
        nbytes(*ops) + nbytes(*out_p[:4]) + 4, err)}

    del out_p
    bops = _gated_bwd_operands(ops, T, C, H)
    pair = _gated_route(cd, C) == "pair"
    g_p, err = _act_bwd_check(fused_gated_sae, tag, cd, bops, GATED_GRADS,
                              REPEATS if pair else 2)
    moved = nbytes(*bops) + nbytes(*g_p)
    del g_p
    bwd = fused_gated_sae.bwd_kernel
    rows["fused_gated_sae_bwd"] = _measure(
        "fused_gated_sae_bwd", tag, cd, lambda: bwd(*bops),
        lambda: fused_gated_sae.backward_plain(*bops), _gated_bwd_library(bops),
        10.0 * T * C * H, moved, err)
    if pair:  # row 7's launch runs coder_bwd_pair<Act::Gated>: its row comes last
        _route_timing(bwd.name, tag, "pair", lambda **kw: bwd(*bops, **kw))
    return rows


GATED_GRADS = ("dW_gate", "db_gate", "db_mag", "dr_mag", "dW_dec", "db_dec")
JUMPRELU_GRADS = ("dW_enc", "db_enc", "dtheta", "dW_dec", "db_dec")


def _act_fwd_check(mod, tag: str, cd, ops, repeats: int = 2, label: str = "", kernel=None):
    """The forward of the JumpReLU or gated op ``mod``, through ``kernel``
    (default its own wrapper), against its plain version on the same inputs;
    in bf16 ``repeats`` launches must agree bitwise. The
    inputs lie on _exact_inputs' grid, so the pre-activations, and with them the
    mask or gate, the counts and relu(pi), agree exactly; the decodes (recon,
    and the gated op's via_gate) and the L1 sum add in other orders. Returns
    (plain outputs, max abs err of the decodes)."""
    kernel = kernel or mod.fwd_kernel
    name = kernel.name
    out_k = kernel(*ops)
    out_p = _act_fwd_plain(mod)(*ops)
    torch.cuda.synchronize()
    log(f"[kernels] {name} [{tag}{label}] vs plain")
    if cd == torch.bfloat16:
        for _ in range(repeats - 1):
            _repeatable(name, out_k, kernel(*ops))
        if repeats > 2:
            log(f"[kernels]   {name}: {repeats} launches bitwise equal")
    n = len(out_p) - 3  # the decodes come first
    err = max(_check(k, a, b, 1e-4, 1e-5)
              for k, a, b in zip(("recon", "via_gate")[:n], out_k, out_p))
    _check("act_count", out_k[n], out_p[n], 0.0, 0.0)
    _check("row_active", out_k[n + 1], out_p[n + 1], 0.0, 0.0)
    _check("l1_sum", out_k[n + 2], out_p[n + 2], 1e-5, 0.0)
    return out_p, err


def _act_fwd_plain(mod):
    """The forward's plain version of the JumpReLU or gated op ``mod``."""
    return (mod.fused_gated_forward_plain if mod is fused_gated_sae
            else mod.fused_jumprelu_forward_plain)


def _act_fwd_library(mod, ops):
    """The stock path's cuBLAS products of the JumpReLU forward (encode and
    decode) or the gated one (encode and two decodes), as one call."""
    x, w, wd, bd = ops[0], ops[1], ops[-2], ops[-1]
    xc = x - bd.to(x.dtype)
    post = torch.relu(xc @ w).to(x.dtype)  # a [T, H] operand of the stock path's shapes
    if mod is fused_gated_sae:
        return lambda: (xc @ w, post @ wd, post @ wd)
    return lambda: (xc @ w, post @ wd)


def _act_bwd_check(mod, tag: str, cd, bops, names, repeats: int = 2, label: str = "",
                   kernel=None):
    """The backward of the JumpReLU or gated op ``mod``, through ``kernel``
    (default its own wrapper), against the plain version of its route
    (backward_plain: in bf16 centre, pre-pass and the coder body's epilogue);
    in bf16 ``repeats`` launches must agree bitwise. Returns (plain grads, max
    abs err)."""
    kernel = kernel or mod.bwd_kernel
    name = kernel.name
    g_k = kernel(*bops)
    g_p = mod.backward_plain(*bops)
    torch.cuda.synchronize()
    log(f"[kernels] {name} [{tag}{label}] vs plain")
    if cd == torch.bfloat16:
        for _ in range(repeats - 1):
            _repeatable(name, g_k, kernel(*bops))
        if repeats > 2:
            log(f"[kernels]   {name}: {repeats} launches bitwise equal")
    err = max(_check(n, a, b, 1e-3, 1e-4) for n, a, b in zip(names, g_k, g_p))
    if mod is fused_jumprelu_sae:
        n_win = int((g_p[2] != 0).sum())
        log(f"[kernels]   dtheta non-zero for {n_win} of {g_p[2].numel()} latents")
        if n_win == 0:
            raise AssertionError("no pre-activation fell in the STE window")
    return g_p, err


def _gated_bwd_operands(ops, t: int, c: int, h: int):
    """The gated backward's operands after its forward's plain version: the f32
    residuals of recon and via_gate, and (c_rec, c_l1, c_aux)."""
    x = ops[0]
    recon, via = fused_gated_sae.fused_gated_forward_plain(*ops)[:2]
    coeffs = torch.tensor([2.0 / (t * c), LAMBDA / (t * h), 2.0 / (t * c)], device=DEVICE)
    return ops + (recon - x.float(), via - x.float(), coeffs)


def _gated_bwd_library(bops):
    """The stock path's four cuBLAS products of the gated backward, as one call."""
    x, wg, _, _, _, wd, bd, err_rec, err_via, coeffs = bops
    cd = x.dtype
    xc = x - bd.to(cd)
    enc = torch.relu(xc @ wg).to(cd)  # a [T, H] operand of the stock path's shapes
    dr = (coeffs[0] * err_rec).to(cd)
    dv = (coeffs[2] * err_via).to(cd)
    return lambda: (dr @ wd.T, dv @ wd.T, xc.T @ enc, enc.T @ dr)


def _jumprelu_bwd_library(bops):
    """The stock path's three cuBLAS products of the JumpReLU backward."""
    x, we, _, _, wd, bd, res, coeffs, _ = bops
    cd = x.dtype
    xc = x - bd.to(cd)
    post = torch.relu(xc @ we).to(cd)
    dr = (coeffs[0] * res).to(cd)
    return lambda: (dr @ wd.T, xc.T @ post, post.T @ dr)


def _jumprelu_ops(cd) -> tuple:
    """Rows 4 and 5's forward operands at the training shape (seed 0)."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = init_jumprelu_sae(gen, C, H // C)
    x, we, bd = _exact_inputs(gen, T, params["W_enc"])
    x, we, wd = x.to(cd), we.to(cd), params["W_dec"].to(cd).contiguous()
    be = _odd_grid(gen, H, 100)
    thr = 0.5 + torch.rand(H, device=DEVICE, generator=gen)  # pre has std ~2 here
    return x, we, be, thr, wd, bd


def kernels_jumprelu(cd, tag: str) -> dict:
    ops = _jumprelu_ops(cd)
    out_p, err = _act_fwd_check(fused_jumprelu_sae, tag, cd, ops)
    rows = {"fused_jumprelu_sae_fwd": _measure(
        "fused_jumprelu_sae_fwd", tag, cd, lambda: fused_jumprelu_sae.fwd_kernel(*ops),
        lambda: fused_jumprelu_sae.fused_jumprelu_forward_plain(*ops),
        _act_fwd_library(fused_jumprelu_sae, ops), 4.0 * T * C * H,
        nbytes(*ops) + nbytes(*out_p[:3]) + 4, err)}

    del out_p
    bops = _jumprelu_bwd_operands(ops, T, C)
    pair = _jump_route(cd, C) == "pair"
    g_p, err = _act_bwd_check(fused_jumprelu_sae, tag, cd, bops, JUMPRELU_GRADS,
                              REPEATS if pair else 2)
    moved = nbytes(*bops[:-1]) + nbytes(*g_p)
    del g_p
    bwd = fused_jumprelu_sae.bwd_kernel
    rows["fused_jumprelu_sae_bwd"] = _measure(
        "fused_jumprelu_sae_bwd", tag, cd, lambda: bwd(*bops),
        lambda: fused_jumprelu_sae.backward_plain(*bops), _jumprelu_bwd_library(bops),
        8.0 * T * C * H, moved, err)
    if pair:  # row 5's launch runs coder_bwd_pair: its row comes last (pair_body_row)
        _route_timing(bwd.name, tag, "pair", lambda **kw: bwd(*bops, **kw))
    return rows


def _bodies_ms(launch, bodies: tuple, reps: int, per_call: dict | None = None) -> dict:
    """{body: mean device time a call of the kernel whose name holds it}, over
    ``reps`` calls of ``launch()`` (which launches each once, or per_call[body]
    times, its time then the sum of a call's launches: a body and its
    pre-passes) under one torch.profiler session: each kernel's own time. The
    profiler can drop an event (its time and its count go together, so the
    mean holds), but not half of them."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    launch()
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
    out = {}
    for body in bodies:
        hits = [e for e in prof.key_averages()
                if e.device_type.name == "CUDA" and body in e.key]
        per = (per_call or {}).get(body, 1)
        n = sum(e.count for e in hits)
        if not reps / 2 <= n / per <= reps:
            raise AssertionError(f"{body}: {n} launches traced in {reps} calls of {per}")
        out[body] = sum(e.self_device_time_total for e in hits) / (n / per) / 1e3
    return out


def _body_ms(launch, body: str, reps: int) -> float:
    """_bodies_ms of one body."""
    return _bodies_ms(launch, (body,), reps)[body]


def _slice_pair_body(name: str, cfg, params: dict):
    """The cluster pair's body counter that the backward of slice ``name``
    (its config and parameters) launches where bwd_route gives its width the
    pair (Act::Jump, Act::Relu with the Matryoshka levels, Act::Gated), else
    None."""
    if name == "jumprelu_sae":
        c = params["W_enc"].shape[0]
        return fused_jumprelu_sae.pair_kernel if _jump_route(cfg.compute_dtype, c) == "pair" else None
    if name in ("sae_mlp", "matryoshka_sae"):
        c = params["W_enc"].shape[0]
        levels = len(cfg.matryoshka_prefix_fractions) if name == "matryoshka_sae" else 1
        return fused_sae.pair_kernel if _sae_route(cfg.compute_dtype, c, levels) == "pair" else None
    if name == "gated_sae":
        c = params["W_gate"].shape[0]
        return fused_gated_sae.pair_kernel if _gated_route(cfg.compute_dtype, c) == "pair" else None
    return None


def _pair_body_ms_here(act: str) -> dict:
    """coder_bwd_pair's own device time and its pre-pass's at row 5's launch
    (``act`` "jump"), row 2's ("relu") or row 7's ("gated": two pre-pass
    launches a call, their sum), by this process's first torch.profiler
    session."""
    per_call = None
    if act == "jump":
        bops = _jumprelu_bwd_operands(_jumprelu_ops(torch.bfloat16), T, C)
        launch = lambda: fused_jumprelu_sae.bwd_kernel(*bops)  # noqa: E731
    elif act == "gated":
        bops = _gated_bwd_operands(_gated_ops(torch.bfloat16), T, C, H)
        launch = lambda: fused_gated_sae.bwd_kernel(*bops)  # noqa: E731
        per_call = {"scale_err_kernel": 2}
    else:
        ops = _relu_exact_operands(torch.bfloat16)
        x, we, be, wd, bd = ops
        res = (fused_sae.fused_sae_forward_plain(*ops)[0] - x.float()).to(torch.bfloat16)
        coeffs = torch.tensor([2.0 / (T * C), LAMBDA / (T * H)], device=DEVICE)
        bops = (x - bd.to(torch.bfloat16), we, be, wd, res, coeffs)
        launch = lambda: fused_sae.bwd_kernel(*bops)  # noqa: E731
    with torch.no_grad():
        got = _bodies_ms(launch, ("coder_bwd_pair<", "scale_err_kernel"), REPS, per_call)
    return {"pair_body_ms": got["coder_bwd_pair<"], "pre_pass_ms": got["scale_err_kernel"]}


# the kernels line's rows of the cluster pair's bodies: (act, the row's name,
# the launching wrapper's row, its [T, C] bf16 token operands, its per-latent
# f32 inputs and outputs, its FLOP over T·C·H: x_cent and err, b_enc and θ in,
# db_enc and dθ out, 8 for Act::Jump; b_enc and ct in, db_enc out for
# Act::Relu; x_cent, err_rec and err_via, b_gate, b_mag and exp(r_mag) in,
# db_gate, db_mag and dr_mag out, 10 for Act::Gated)
PAIR_BODY_ROWS = (("jump", "coder_bwd_pair", "fused_jumprelu_sae_bwd", 2, 2, 2, 8.0),
                  ("relu", "coder_bwd_pair_relu", "fused_sae_bwd", 2, 2, 1, 8.0),
                  ("gated", "coder_bwd_pair_gated", "fused_gated_sae_bwd", 3, 3, 3, 10.0))


def pair_body_row(rows: dict) -> None:
    """The kernels line's rows of coder_bwd_pair<Act::Jump> at row 5's launch,
    coder_bwd_pair<Act::Relu> at row 2's and coder_bwd_pair<Act::Gated> at
    row 7's, where bwd_route gives those rows the pair, into ``rows``: each
    body's own device time (torch.profiler, apart from center_kernel and
    scale_err_kernel, which the wrapper's row includes; the pre-pass's time is
    printed beside it), its bound (PAIR_BODY_ROWS' FLOP; x_cent and the
    scaled errors read once, both W tiles, the per-latent inputs, the
    gradients, the per-latent outputs and db_dec's centring rows written
    once), and the plain
    version's and the library's times from the wrapper's row, which computes
    the same function. The times come from processes of their own (this script
    with --pair-body ACT): in one process a second profiler session lost
    events on the card, before phase 14's traced epoch (which counts its
    launches exactly) and after it."""
    routes = {"jump": _jump_route(torch.bfloat16, C), "relu": _sae_route(torch.bfloat16, C),
              "gated": _gated_route(torch.bfloat16, C)}
    for act, name, wrapper_name, n_tok, n_in, n_out, f in PAIR_BODY_ROWS:
        if routes[act] != "pair":
            continue
        wrapper = rows[wrapper_name]
        torch.cuda.empty_cache()
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--pair-body", act],
                             capture_output=True, text=True, timeout=600)
        if out.returncode:
            raise AssertionError(f"--pair-body {act} failed ({out.returncode}):\n"
                                 f"{out.stdout[-2000:]}{out.stderr[-4000:]}")
        got = json.loads(out.stdout.strip().splitlines()[-1])
        ms = got["pair_body_ms"]
        # bf16 the token operands, W_enc and W_dec; f32 the per-latent inputs,
        # the gradients, the per-latent outputs and the centring rows
        moved = 2 * (n_tok * T * C + 2 * C * H) + 4 * (
            n_in * H + 2 * C * H + n_out * H + H // 64 * C)
        b_ms, b_by = bound(f * T * C * H, moved, torch.bfloat16)
        log(f"[kernels] {name} [bf16] ms {ms:.3f} (torch.profiler; the wrapper "
            f"{wrapper['ms']:.3f}, its scale_err_kernel pre-pass {got['pre_pass_ms']:.4f}) "
            f"bound_ms {b_ms:.4f} ({b_by})")
        rows[name] = dict(wrapper, ms=ms, bound_ms=b_ms, bound_by=b_by,
                          tflops=f * T * C * H / ms / 1e9, pre_pass_ms=got["pre_pass_ms"])


def _jumprelu_bwd_operands(ops, t: int, c: int):
    """The JumpReLU backward's operands after its forward's plain version: the
    f32 residual, (c_rec, c_l0) and the STE bandwidth."""
    res = fused_jumprelu_sae.fused_jumprelu_forward_plain(*ops)[0] - ops[0].float()
    return ops + (res, torch.tensor([2.0 / (t * c), LAMBDA_J / t], device=DEVICE), BANDWIDTH)


def _relu_exact_operands(cd, t: int = T, c: int = C, h: int = H):
    """ReLU-layout operands ([t, c], h latents; the training shape by default)
    on _exact_inputs' grid, b_enc odd multiples of 2^-11: the kernel and cuBLAS
    get the same pre-activations, so the ReLU mask, which the dx kernels' sums
    over latents jump with, is the same on both sides."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = init_sae_mlp(gen, c, h // c)
    x, we, bd = _exact_inputs(gen, t, params["W_enc"])
    be = _odd_grid(gen, h, 100)
    return x.to(cd), we.to(cd), be, params["W_dec"].to(cd).contiguous(), bd


def _dx_check(mod, tag: str, cd, dops, repeats: int = 2, label: str = ""):
    """The dx entry point of the SAE op ``mod`` (fused_sae or
    fused_matryoshka_sae) on (x_cent, W_enc, b_enc, W_dec, err or S, coeffs[,
    boundaries]) against its plain version; in bf16 ``repeats`` launches must
    agree bitwise. Returns (plain dx, max abs err)."""
    kern = mod.dx_kernel
    plain = mod.fused_sae_dx_plain if mod is fused_sae else mod.fused_matryoshka_dx_plain
    dx_k = kern(*dops)
    dx_p = plain(*dops)
    torch.cuda.synchronize()
    log(f"[kernels] {kern.name} [{tag}{label}] vs plain")
    if cd == torch.bfloat16:
        for _ in range(repeats - 1):
            _repeatable(kern.name, (dx_k,), (kern(*dops),))
        if repeats > 2:
            log(f"[kernels]   {kern.name}: {repeats} launches bitwise equal")
    if not bool(torch.isfinite(dx_k).all()):
        raise AssertionError(f"{kern.name}: non-finite dx")
    return dx_p, _check("dx", dx_k, dx_p, 1e-3, 1e-4)


def _dx_library(x_cent, we, wd, dr):
    """The stock path's three cuBLAS products of dx (encode, dpost, the product
    with W_enc^T), as one call; dr is the rounded cotangent of level 0."""
    post = torch.relu(x_cent @ we)  # a [T, H] operand of the stock path's shapes
    return lambda: (x_cent @ we, dr @ wd.T, post @ we.T)


def kernels_relu_dx(cd, tag: str) -> dict:
    ops = _relu_exact_operands(cd)
    x, we, be, wd, bd = ops
    res = (fused_sae.fused_sae_forward_plain(*ops)[0] - x.float()).to(cd)
    coeffs = torch.tensor([2.0 / (T * C), LAMBDA / (T * H)], device=DEVICE)
    dops = (x - bd.to(cd), we, be, wd, res, coeffs)  # x_cent, as the forward saves it
    dx_p, err = _dx_check(fused_sae, tag, cd, dops)
    dr = (coeffs[0] * res.float()).to(cd)
    return {"fused_sae_dx": _measure(
        "fused_sae_dx", tag, cd, lambda: fused_sae.dx_kernel(*dops),
        lambda: fused_sae.fused_sae_dx_plain(*dops), _dx_library(dops[0], we, wd, dr),
        6.0 * T * C * H, nbytes(*dops) + nbytes(dx_p), err)}


def _suffix_error(prefix_recon, x, cd):
    """The suffix-weighted error S of the prefix mean's cotangents, 1/P each."""
    n, t, c = prefix_recon.shape
    weighted = (2.0 / (n * t * c)) * (prefix_recon - x.float()[None])
    return weighted.flip(0).cumsum(0).flip(0).to(cd)


def kernels_matryoshka(cd, tag: str) -> dict:
    fm = fused_matryoshka_sae
    ops = _relu_exact_operands(cd)
    x, we, _, wd, bd = ops
    bounds = matryoshka_prefix_counts(H, DEFAULT_MATRYOSHKA_PREFIXES)
    x_cent, out_p, err = _sae_fwd_check(fm, tag, cd, ops, (bounds,), exact=True,
                                        label=f", prefixes end at {bounds}")
    xc = x - bd.to(cd)
    post = torch.relu(xc @ we).to(cd)
    rows = {"fused_matryoshka_sae_fwd": _measure(
        "fused_matryoshka_sae_fwd", tag, cd, lambda: fm.fused_matryoshka_forward(*ops, bounds),
        lambda: fm.fused_matryoshka_forward_plain(*ops, bounds),
        lambda: (xc @ we, *(post[:, :m] @ wd[:m] for m in bounds)), 4.0 * T * C * H,
        nbytes(*ops) + nbytes(*out_p[:3]) + 4, err)}

    s = _suffix_error(out_p[0], x, cd)
    del out_p
    coeffs = torch.tensor([1.0, LAMBDA / (T * H)], device=DEVICE)
    g_p, err = _sae_bwd_check(fm, tag, cd, ops, x_cent, s, coeffs, (bounds,))
    moved = nbytes(*ops, s, coeffs) + nbytes(*g_p)
    del g_p
    dr = s[0]
    rows["fused_matryoshka_sae_bwd"] = _measure(
        "fused_matryoshka_sae_bwd", tag, cd,
        lambda: fm.fused_matryoshka_backward(x_cent, we, *ops[2:4], s, coeffs, bounds),
        lambda: fm.fused_matryoshka_backward_plain(*ops, s, coeffs, bounds),
        lambda: (xc @ we, dr @ wd.T, xc.T @ post, post.T @ dr), 8.0 * T * C * H, moved, err)
    if cd == torch.bfloat16 and _sae_route(cd, C, len(bounds)) == "pair":  # row 9
        _route_timing("fused_matryoshka_sae_bwd", tag, "pair",
                      lambda **kw: fm.bwd_kernel(x_cent, we, *ops[2:4], s, coeffs, bounds, **kw))

    bops = (x_cent, we, ops[2], wd, s, coeffs, bounds)
    dx_p, err = _dx_check(fm, tag, cd, bops)
    rows["fused_matryoshka_sae_dx"] = _measure(
        "fused_matryoshka_sae_dx", tag, cd, lambda: fm.dx_kernel(*bops),
        lambda: fm.fused_matryoshka_dx_plain(*bops), _dx_library(x_cent, we, wd, dr),
        6.0 * T * C * H, nbytes(*bops[:-1]) + nbytes(dx_p), err)
    return rows


# the ReLU and Matryoshka ops at other widths: mixed3b's 480 (the register-held
# bf16 forward) and mixed4e's 832 (the in-place one)
W_T, W_H, W_WIDTHS, W_BOUNDS = 8192, 4096, (480, 832), (1024, 2048, 4096)
REPEATS = 20  # bitwise-equal launches of the in-place bf16 forward at C = 832
# the JumpReLU and gated ops' ragged shape: T = 2*512 + 128, H = 640, C = 2*64 + 8
RAGGED_T, RAGGED_H, RAGGED_C = 1152, 640, 136


def kernels_sae_widths(cd, tag: str) -> dict:
    """Both SAE ops at C = 480 and 832 (T = 8,192, H = 4,096, prefixes 1,024 /
    2,048 / 4,096) on _exact_inputs' grid against their plain references, and a
    Matryoshka backward whose levels' errors differ, with prefixes 128 / 1,024 /
    4,096: two level-0 blocks must sum all 16 steps' direct db_dec rows from
    S_0; the dx entry points of both (above C = 256 the dx route of the
    in-place coder_fwd_tc), the Matryoshka one on both sets of levels. In bf16,
    REPEATS launches of the C = 832 forward (coder_fwd_tc) and of the ReLU dx
    there must agree bitwise, and each op is timed. No rows: the kernels line
    keeps the main path's."""
    fm = fused_matryoshka_sae
    for c in W_WIDTHS:
        gen = torch.Generator(device=DEVICE).manual_seed(c)
        ops = _sae_ops(gen, W_T, c, W_H, cd)
        label = f", C={c} T={W_T} H={W_H}"
        x_cent, out_p, _ = _sae_fwd_check(fused_sae, tag, cd, ops, exact=True, label=label)
        res = (out_p[0] - ops[0].float()).to(cd)
        coeffs = torch.tensor([2.0 / (W_T * c), LAMBDA / (W_T * W_H)], device=DEVICE)
        _sae_bwd_check(fused_sae, tag, cd, ops, x_cent, res, coeffs, label=label)
        if cd == torch.bfloat16 and c > 512:
            first = fused_sae.fwd_kernel(*ops)
            for _ in range(REPEATS - 1):
                _repeatable(fused_sae.fwd_kernel.name, first, fused_sae.fwd_kernel(*ops))
            log(f"[kernels]   {fused_sae.fwd_kernel.name}: {REPEATS} launches of the in-place "
                f"forward at C={c} bitwise equal")

        _, m_out, _ = _sae_fwd_check(fm, tag, cd, ops, (W_BOUNDS,), exact=True, label=label)
        s = _suffix_error(m_out[0], ops[0], cd)
        m_coeffs = torch.tensor([1.0, LAMBDA / (W_T * W_H)], device=DEVICE)
        _sae_bwd_check(fm, tag, cd, ops, x_cent, s, m_coeffs, (W_BOUNDS,), label=label)
        # levels whose errors differ by orders of magnitude, few level-0 blocks;
        # S and W_dec on dyadic grids, so that dpost = S @ W_dec^T is exact on
        # both sides and round_bf16(dpre) cannot flip
        lv = (128, W_H // 4, W_H)
        s_diff = torch.stack([
            _dyadic(torch.randn(W_T, c, device=DEVICE, generator=gen) * 2.0 ** e, 2.0 ** (e - 4))
            for e in (-13, -17, -20)]).to(cd)
        _sae_bwd_check(fm, tag, cd, ops, x_cent, s_diff, m_coeffs, (lv,),
                       label=f"{label}, levels {lv} with differing errors")
        dops = (x_cent, *ops[1:4], res, coeffs)
        _dx_check(fused_sae, tag, cd, dops, REPEATS if c > 512 else 2, label)
        mops = (x_cent, *ops[1:4], s, m_coeffs, W_BOUNDS)
        _dx_check(fm, tag, cd, mops, label=label)
        _dx_check(fm, tag, cd, (x_cent, *ops[1:4], s_diff, m_coeffs, lv),
                  label=f"{label}, levels {lv} with differing errors")
        if cd == torch.bfloat16:
            xc = x_cent
            post = torch.relu(xc @ ops[1]).to(cd)
            dr = (coeffs[0] * res.float()).to(cd)
            fl = 4.0 * W_T * c * W_H
            for name, kern, plain, lib, flops in (
                    ("fused_sae_fwd", lambda: fused_sae.fused_sae_forward(*ops),
                     lambda: fused_sae.fused_sae_forward_plain(*ops),
                     lambda: (xc @ ops[1], post @ ops[3]), fl),
                    ("fused_sae_bwd",
                     lambda: fused_sae.fused_sae_backward(x_cent, *ops[1:4], res, coeffs),
                     lambda: fused_sae.fused_sae_backward_plain(*ops, res, coeffs),
                     lambda: (dr @ ops[3].T, xc.T @ post, post.T @ dr), 2 * fl),
                    ("fused_matryoshka_sae_fwd",
                     lambda: fm.fused_matryoshka_forward(*ops, W_BOUNDS),
                     lambda: fm.fused_matryoshka_forward_plain(*ops, W_BOUNDS),
                     lambda: (xc @ ops[1], *(post[:, :m] @ ops[3][:m] for m in W_BOUNDS)), fl),
                    ("fused_matryoshka_sae_bwd",
                     lambda: fm.fused_matryoshka_backward(x_cent, *ops[1:4], s, m_coeffs,
                                                          W_BOUNDS),
                     lambda: fm.fused_matryoshka_backward_plain(*ops, s, m_coeffs, W_BOUNDS),
                     lambda: (xc @ ops[1], s[0] @ ops[3].T, xc.T @ post, post.T @ s[0]),
                     2 * fl),
                    ("fused_sae_dx", lambda: fused_sae.dx_kernel(*dops),
                     lambda: fused_sae.fused_sae_dx_plain(*dops),
                     _dx_library(xc, ops[1], ops[3], dr), 1.5 * fl),
                    ("fused_matryoshka_sae_dx", lambda: fm.dx_kernel(*mops),
                     lambda: fm.fused_matryoshka_dx_plain(*mops),
                     _dx_library(xc, ops[1], ops[3], s[0]), 1.5 * fl)):
                _measure(name, f"{tag}, C={c} T={W_T} H={W_H}", cd, kern, plain, lib, flops,
                         0, 0.0)
        torch.cuda.empty_cache()
    return {}


def kernels_act_widths(cd, tag: str) -> dict:
    """The JumpReLU and gated forwards and backwards on _exact_inputs' grid
    against the plain versions of their routes, the backwards' errors from the
    forwards' plain versions: first at the ragged shape (RAGGED_*: a partial
    token step and channel chunk; in bf16 the forwards' register-held bodies,
    the gated one with recon and via_gate held together), then at C = 480 (bf16:
    the held 512-column bodies, the gated forward's two launches) and 832 (bf16:
    the in-place bodies) with T = 8,192, H = 4,096, where each is timed. In f32
    every shape runs the SIMT bodies (the gated forward in two launches). In
    bf16 REPEATS launches of each at C = 832 must agree bitwise. No rows: the
    kernels line keeps the main path's."""
    for t, h, c in ((RAGGED_T, RAGGED_H, RAGGED_C),) + tuple((W_T, W_H, c) for c in W_WIDTHS):
        gen = torch.Generator(device=DEVICE).manual_seed(c)
        w = torch.randn(c, h, device=DEVICE, generator=gen) / c ** 0.5
        x, we, bd = _exact_inputs(gen, t, w)
        x, we = x.to(cd), we.to(cd)
        wd = (torch.randn(h, c, device=DEVICE, generator=gen) / h ** 0.5).to(cd)
        label = f", C={c} T={t} H={h}"
        repeats = REPEATS if c > 512 else 2
        thr = 0.5 + torch.rand(h, device=DEVICE, generator=gen)  # pre has std ~2 here
        jf = (x, we, _odd_grid(gen, h, 100), thr, wd, bd)
        jp, _ = _act_fwd_check(fused_jumprelu_sae, tag, cd, jf, repeats, label)
        jops = _jumprelu_bwd_operands(jf, t, c)
        # the cluster pair (C <= 256 in bf16: the ragged shape) repeats REPEATS times
        _act_bwd_check(fused_jumprelu_sae, tag, cd, jops, JUMPRELU_GRADS,
                       REPEATS if _jump_route(cd, c) == "pair" else repeats, label)
        er = torch.exp(0.1 * torch.randn(h, device=DEVICE, generator=gen))
        gf = (x, we, _odd_grid(gen, h, 100), _odd_grid(gen, h, 60), er, wd, bd)
        gp, _ = _act_fwd_check(fused_gated_sae, tag, cd, gf, repeats, label)
        gops = _gated_bwd_operands(gf, t, c, h)
        _act_bwd_check(fused_gated_sae, tag, cd, gops, GATED_GRADS,
                       REPEATS if _gated_route(cd, c) == "pair" else repeats, label)
        if t == W_T:
            fl = 2.0 * t * c * h
            for mod, fops, out_p, flops in ((fused_jumprelu_sae, jf, jp, 2 * fl),
                                            (fused_gated_sae, gf, gp, 3 * fl)):
                _measure(mod.fwd_kernel.name, f"{tag}{label}", cd,
                         lambda: mod.fwd_kernel(*fops), lambda: _act_fwd_plain(mod)(*fops),
                         _act_fwd_library(mod, fops), flops,
                         nbytes(*fops) + nbytes(*out_p[:-1]) + 4, 0.0)
            for mod, bops, lib, flops in (
                    (fused_jumprelu_sae, jops, _jumprelu_bwd_library(jops), 4 * fl),
                    (fused_gated_sae, gops, _gated_bwd_library(gops), 5 * fl)):
                _measure(mod.bwd_kernel.name, f"{tag}{label}", cd,
                         lambda: mod.bwd_kernel(*bops), lambda: mod.backward_plain(*bops), lib,
                         flops, 0, 0.0)
        del jp, gp, jops, gops
        torch.cuda.empty_cache()
    return {}


PAIR_SPLIT_T = 2176  # the cluster pair's split check: 5 token steps, split in 2 at H 640
# the pair's route at the widths below 256 that the repo's backbones give it, at
# phase 3's T and expansion 64: GoogLeNet's conv2d0 (C 64) and conv2d2 (C 192,
# vit_tiny's width too); and C 64 at expansion 16, where its grid of 32 CTAs
# splits in 4: (T, C, H)
PAIR_WIDTHS = ((T, 64, 4096), (T, 192, 12288), (T, 64, 1024))
# a sweep of short sweeps (N 8 at T 4,096, H 512: 16 CTAs a combo, split in 4
# by the rule, eight 64-token sub-steps a warpgroup), where the exchange
# slots turn over most often for the work done: a slot that a sender
# overwrote before its receiver had read it (coder.cuh, mbar_arrive_peer's
# CTA-scope release) would show as launches that differ; launched this many
# times bitwise equal
PAIR_STRESS = (8, 4096, 256, 512)  # N, T, C, H
PAIR_STRESS_REPEATS = 100
# the sweeps PAIR_STRESS launches: one a cluster pair's epilogue (Act::Jump,
# Act::Relu, Act::Gated)
PAIR_STRESS_NAMES = ("jumprelu_sae", "sae_mlp", "gated_sae")


class _Split:
    """A backward wrapper launched at a fixed ``n_split``, under its own name."""

    def __init__(self, kernel, n_split: int):
        self.kernel, self.n_split, self.name = kernel, n_split, kernel.name

    def __call__(self, *args, **kw):
        return self.kernel(*args, n_split=self.n_split, **kw)


def _pair_ops(gen, t: int, c: int, h: int, cd) -> tuple:
    """JumpReLU backward operands at (t, c, h) on _exact_inputs' grid."""
    w = torch.randn(c, h, device=DEVICE, generator=gen) / c ** 0.5
    x, we, bd = _exact_inputs(gen, t, w)
    wd = (torch.randn(h, c, device=DEVICE, generator=gen) / h ** 0.5).to(cd)
    thr = 0.5 + torch.rand(h, device=DEVICE, generator=gen)  # pre has std ~2 here
    return _jumprelu_bwd_operands((x.to(cd), we.to(cd), _odd_grid(gen, h, 100), thr, wd, bd),
                                  t, c)


def _sae_ops(gen, t: int, c: int, h: int, cd) -> tuple:
    """ReLU SAE forward operands (x, W_enc, b_enc, W_dec, b_dec) at any (t, c,
    h) on _exact_inputs' grid, W_dec on the 1/256 grid as well."""
    w = torch.randn(c, h, device=DEVICE, generator=gen) / c ** 0.5
    x, we, bd = _exact_inputs(gen, t, w)
    wd = _dyadic(torch.randn(h, c, device=DEVICE, generator=gen) / h ** 0.5, 2.0 ** -8)
    return x.to(cd), we.to(cd), _odd_grid(gen, h, 100), wd.to(cd), bd


def _sae_pair_shapes(cd, tag: str) -> None:
    """The ReLU and Matryoshka SAEs' backward where bwd_route gives it the
    cluster pair, each launch held to the plain version of its route: the ReLU
    SAE at T 2,176, C 136, H 640 split in 2 and unsplit, and a Matryoshka
    launch there whose levels' errors differ by orders of magnitude (levels
    128 / 384 / 640, S and W_dec on dyadic grids, so that dpost is exact on
    both sides), REPEATS launches bitwise equal each; then PAIR_STRESS's sweep
    of the ReLU SAE, PAIR_STRESS_REPEATS launches bitwise equal, each combo
    bitwise its one-dictionary launch."""
    t, h, c = PAIR_SPLIT_T, RAGGED_H, RAGGED_C
    lv = (128, 384, h)
    if _sae_route(cd, c) != "pair" or _sae_route(cd, c, len(lv)) != "pair":
        return
    gen = torch.Generator(device=DEVICE).manual_seed(c + 2)
    ops = _sae_ops(gen, t, c, h, cd)
    x, we, be, wd, bd = ops
    x_cent = x - bd.to(cd)
    res = (fused_sae.fused_sae_forward_plain(*ops)[0] - x.float()).to(cd)
    coeffs = torch.tensor([2.0 / (t * c), LAMBDA / (t * h)], device=DEVICE)
    s = fused_sae.grid_split(t, h, c, backward=True, pair=True,
                             n_sm=fused_sae.sm_count(torch.cuda.current_device()))
    if s == 1:
        raise AssertionError(f"the pair's split check does not split at T={t} H={h}")
    label = f", C={c} T={t} H={h}"
    for n_split in (s, 1):
        _sae_bwd_check(fused_sae, tag, cd, ops, x_cent, res, coeffs,
                       label=f"{label}, n_split {n_split}",
                       kernel=_Split(fused_sae.bwd_kernel, n_split))
    s_diff = torch.stack([
        _dyadic(torch.randn(t, c, device=DEVICE, generator=gen) * 2.0 ** e, 2.0 ** (e - 4))
        for e in (-13, -17, -20)]).to(cd)
    m_coeffs = torch.tensor([1.0, LAMBDA / (t * h)], device=DEVICE)
    _sae_bwd_check(fused_matryoshka_sae, tag, cd, ops, x_cent, s_diff, m_coeffs, (lv,),
                   label=f"{label}, levels {lv} with differing errors")
    del ops, x_cent, res, s_diff
    n, t, c, h = PAIR_STRESS
    _sweep_kernel_check("sae_mlp", cd, n, t, c, h, timed=False, repeats=PAIR_STRESS_REPEATS)


def _gated_pair_ops(gen, t: int, c: int, h: int, cd, ties: int) -> tuple:
    """Gated forward operands at (t, c, h) on _exact_inputs' grid with ``ties``
    (or no) planted latents whose W_gate column and b_gate are 0 (pre_gate exactly 0
    at every token: the gate's 0.5) and b_mag > 0 (pre_mag > 0, so that
    d_premag = denc * 0.5 reaches dW_dec, db_mag and dr_mag)."""
    w = torch.randn(c, h, device=DEVICE, generator=gen) / c ** 0.5
    x, wg, bd = _exact_inputs(gen, t, w)
    wd = (torch.randn(h, c, device=DEVICE, generator=gen) / h ** 0.5).to(cd)
    bg, bm = _odd_grid(gen, h, 100), _odd_grid(gen, h, 60)
    er = torch.exp(0.1 * torch.randn(h, device=DEVICE, generator=gen))
    if ties:
        idx = torch.arange(3, h, h // ties, device=DEVICE)[:ties]
        wg[:, idx] = 0.0
        bg[idx] = 0.0
        bm[idx] = bm[idx].abs() + 2.0 ** -6
    return x.to(cd), wg.to(cd), bg, bm, er, wd, bd


def _gated_pair_shapes(cd, tag: str) -> None:
    """The gated backward where bwd_route gives it the cluster pair, each
    launch held to the plain version of its route: T 2,176, C 136, H 640 with
    16 planted pre_gate == 0 ties, split in 2 and unsplit, REPEATS launches
    bitwise equal each and timed beside coder_bwd_tc ("[route]"); then
    PAIR_STRESS's sweep of the gated SAE, PAIR_STRESS_REPEATS launches bitwise
    equal, each combo bitwise its one-dictionary launch."""
    t, h, c = PAIR_SPLIT_T, RAGGED_H, RAGGED_C
    if _gated_route(cd, c) != "pair":
        return
    gen = torch.Generator(device=DEVICE).manual_seed(c + 3)
    gops = _gated_bwd_operands(_gated_pair_ops(gen, t, c, h, cd, 16), t, c, h)
    s = fused_sae.grid_split(t, h, c, backward=True, pair=True,
                             n_sm=fused_sae.sm_count(torch.cuda.current_device()))
    if s == 1:
        raise AssertionError(f"the pair's split check does not split at T={t} H={h}")
    bwd = fused_gated_sae.bwd_kernel
    label = f"C={c} T={t} H={h}, 16 pre_gate == 0 ties"
    for n_split in (s, 1):
        g_p, _ = _act_bwd_check(fused_gated_sae, tag, cd, gops, GATED_GRADS, REPEATS,
                                f", {label}, n_split {n_split}", kernel=_Split(bwd, n_split))
    if not (g_p[2] != 0).any() or int((g_p[1] != 0).sum()) == h:
        raise AssertionError("the gated pair check's d_premag or ties are missing")
    _route_timing(bwd.name, f"{tag}, {label}", "pair", lambda **kw: bwd(*gops, **kw))
    del gops, g_p
    n, t, c, h = PAIR_STRESS
    _sweep_kernel_check("gated_sae", cd, n, t, c, h, timed=False, repeats=PAIR_STRESS_REPEATS)


def kernels_pair_shapes(cd, tag: str) -> dict:
    """The JumpReLU backward where bwd_route gives it the cluster pair (bf16, C
    <= 256), each launch held to the plain version; no rows:
    - T 2,176 (five 512-token steps, the last a partial one), C 136, H 640
      (RAGGED_C, RAGGED_H): the rule's split launch (in 2: the second split's
      steps end in the partial one) and the same launch unsplit, REPEATS
      launches bitwise equal each;
    - PAIR_WIDTHS: two bitwise-equal launches, timed beside coder_bwd_tc on
      the same launch ("[route]") and beside the same launch at another split
      ("[split]": unsplit where the rule splits, split in 2 where it does not);
    - PAIR_STRESS: the sweep launch PAIR_STRESS_REPEATS times bitwise equal,
      each combo bitwise its one-dictionary launch, against the plain version.
    First the ReLU and Matryoshka SAEs' pair launches (_sae_pair_shapes) and
    the gated SAE's (_gated_pair_shapes)."""
    _sae_pair_shapes(cd, tag)
    _gated_pair_shapes(cd, tag)
    t, h, c = PAIR_SPLIT_T, RAGGED_H, RAGGED_C
    if _jump_route(cd, c) != "pair":
        return {}
    gen = torch.Generator(device=DEVICE).manual_seed(c + 1)
    jops = _pair_ops(gen, t, c, h, cd)
    n_sm = fused_sae.sm_count(torch.cuda.current_device())
    s = fused_sae.grid_split(t, h, c, backward=True, pair=True, n_sm=n_sm)
    if s == 1:
        raise AssertionError(f"the pair's split check does not split at T={t} H={h}")
    for n_split in (s, 1):
        _act_bwd_check(fused_jumprelu_sae, tag, cd, jops, JUMPRELU_GRADS, REPEATS,
                       f", C={c} T={t} H={h}, n_split {n_split}",
                       kernel=_Split(fused_jumprelu_sae.bwd_kernel, n_split))
    del jops
    bwd = fused_jumprelu_sae.bwd_kernel
    for t, c, h in PAIR_WIDTHS:
        if _jump_route(cd, c) != "pair":
            raise AssertionError(f"bwd_route does not give C {c} the pair")
        jops = _pair_ops(gen, t, c, h, cd)
        label = f"C={c} T={t} H={h}"
        _act_bwd_check(fused_jumprelu_sae, tag, cd, jops, JUMPRELU_GRADS, 2, ", " + label)
        launch = lambda **kw: bwd(*jops, **kw)  # noqa: E731
        _route_timing(bwd.name, f"{tag}, {label}", "pair", launch)
        _split_pair(bwd.name, f"{tag}, {label}", launch, t, h, c, True, pair=True, whole=True)
        del jops
        torch.cuda.empty_cache()
    n, t, c, h = PAIR_STRESS
    _sweep_kernel_check("jumprelu_sae", cd, n, t, c, h, timed=False,
                        repeats=PAIR_STRESS_REPEATS)
    return {}


def _coder_operands(gen, t: int, c_in: int, c_out: int, h: int, cd):
    """Operands of the transcoder/crosscoder kernels: x and W_enc on
    _exact_inputs' grid (x in quarters, W_enc in 1/256ths, sums of at most a few
    thousand products: exact in f32), b_enc odd multiples of 2^-11, so the
    kernel and cuBLAS get the same pre-activations and switch the same latents
    on; W_dec and b_dec plain random."""
    x = _dyadic(torch.relu(torch.randn(t, c_in, device=DEVICE, generator=gen)) * 2.0, 0.25)
    we = _dyadic(torch.randn(c_in, h, device=DEVICE, generator=gen) / c_in ** 0.5, 2.0 ** -8)
    be = _odd_grid(gen, h, 100)
    wd = torch.randn(h, c_out, device=DEVICE, generator=gen) / h ** 0.5
    bd = 0.1 * torch.randn(c_out, device=DEVICE, generator=gen)
    return x.to(cd), we.to(cd), be, wd.to(cd), bd


def _kernels_coder(mod, tag: str, cd, t: int, c_in: int, c_out: int, h: int,
                   bwd_extra, timed: bool = True, kernels=None) -> dict:
    """The fused transcoder or crosscoder kernel pair (``mod``; ``kernels`` =
    (forward, backward) wrappers in place of ``mod``'s, the TP sites') against
    its plain versions at [t, c_in] -> [t, c_out] with h latents.
    ``bwd_extra(gen)`` gives the backward's coefficient arguments, c_rec first.
    bf16 kernels launch twice and must agree bitwise. ``timed`` false: checks
    only, no rows."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    x, we, be, wd, _ = ops = _coder_operands(gen, t, c_in, c_out, h, cd)
    if mod is fused_transcoder:
        plain_fwd, plain_bwd = (mod.fused_transcoder_forward_plain,
                                mod.fused_transcoder_backward_plain)
    else:
        plain_fwd, plain_bwd = (mod.fused_crosscoder_forward_plain,
                                mod.fused_crosscoder_backward_plain)
    fwd, bwd = kernels or (mod.fwd_kernel, mod.bwd_kernel)
    name = fwd.name
    out_k = fwd(*ops)
    out_p = plain_fwd(*ops)
    torch.cuda.synchronize()
    log(f"[kernels] {name} [{tag}] vs plain, T={t} C_in={c_in} C_out={c_out} H={h}")
    if cd == torch.bfloat16:
        _repeatable(name, out_k, fwd(*ops))
    # pre-activations are exact on both sides, so the counts agree exactly; the
    # decode and the sums of post run in other orders
    err = _check("recon", out_k[0], out_p[0], 1e-4, 1e-5)
    _check("act_count", out_k[1], out_p[1], 0.0, 0.0)
    _check("row_active", out_k[2], out_p[2], 0.0, 0.0)
    _check("zsum" if mod is fused_crosscoder else "l1_sum", out_k[3], out_p[3], 1e-5, 1e-7)
    del out_k
    post = torch.relu(x @ we).to(cd) if timed else None  # a [T, H] operand of the stock path
    rows = {name: _measure(
        name, tag, cd, lambda: fwd(*ops), lambda: plain_fwd(*ops),
        lambda: (x @ we, post @ wd), 2.0 * t * h * (c_in + c_out),
        nbytes(*ops) + nbytes(*out_p), err)} if timed else {}

    y = torch.randn(t, c_out, device=DEVICE, generator=gen)
    res = (out_p[0] - y).to(cd)  # the residual the backward reads
    del out_p, y
    bops = (x, we, be, wd, res) + bwd_extra(gen)
    name = bwd.name
    g_k = bwd(*bops)
    g_p = plain_bwd(*bops)
    torch.cuda.synchronize()
    log(f"[kernels] {name} [{tag}] vs plain")
    if cd == torch.bfloat16:
        _repeatable(name, g_k, bwd(*bops))
    err = max(_check(n, a, b, 1e-3, 1e-4)
              for n, a, b in zip(("dW_enc", "db_enc", "dW_dec", "db_dec"), g_k, g_p))
    moved = nbytes(*bops) + nbytes(*g_p)
    del g_k, g_p
    held = (cd == torch.bfloat16 and mod is fused_transcoder
            and fused_sae.bwd_route(c_in, c_out, dtype=cd) == "held")
    if not timed:
        if held:  # the rule's split launch, pass by pass, and the same launch unsplit
            s = fused_sae.grid_split(t, h, c_out, backward=True,
                                     n_sm=fused_sae.sm_count(torch.cuda.current_device()))
            for n_split in sorted({s, 1}, reverse=True):
                _held_pair(name, f"{tag}, T={t} C_in={c_in} C_out={c_out} H={h}, n_split "
                           f"{n_split}", lambda n=n_split, **kw: bwd(*bops, n_split=n, **kw),
                           bops, bops[5][1], timed=False)
        return rows
    dr = (bops[5][0] * res.float()).to(cd)
    rows[name] = _measure(
        name, tag, cd, lambda: bwd(*bops), lambda: plain_bwd(*bops),
        lambda: (dr @ wd.T, x.T @ post, post.T @ dr), 4.0 * t * h * (c_in + c_out), moved, err)
    if cd == torch.bfloat16:
        _split_pair(fwd.name, tag, lambda **kw: fwd(*ops, **kw), t, h, c_out, False)
        _split_pair(name, tag, lambda **kw: bwd(*bops, **kw), t, h, c_out, True)
        if held:
            errs = _held_pair(name, tag, lambda **kw: bwd(*bops, **kw), bops, bops[5][1])
            if kernels is None and (t, h) == (TC_T, TC_H):  # row 12: phase 6's main path
                rows.update(_held_pass_rows(tag, bops, post, errs))
    return rows


def _repeatable(name: str, first, second) -> None:
    """Two launches on the same inputs must give bitwise-equal outputs."""
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{name}: two launches on the same inputs differ")
    log(f"[kernels]   {name}: a repeat launch is bitwise equal")


def kernels_transcoder(cd, tag: str, t: int = TC_T, h: int = TC_H, kernels=None) -> dict:
    """Rows 11-12 at phase 6's shape, or ``kernels`` (the TP sites) at ``t``
    tokens and ``h`` latents (a rank's shard; the coefficients the mesh's)."""
    def coeffs(gen):
        return (torch.tensor([2.0 / (TC_T * TC_COUT), LAMBDA / (TC_T * TC_H)], device=DEVICE),)

    return _kernels_coder(fused_transcoder, tag, cd, t, TC_CIN, TC_COUT, h, coeffs,
                          kernels=kernels)


def kernels_coder_ragged(cd, tag: str) -> dict:
    """Both coder ops at small shapes with a partial chunk at every edge of the
    kernels' tiling (T = 2*512 + 128 tokens, H = 512 + 128 latents, C_in = 4*64 + 8
    channels; C_out = 128 + 8, where the bf16 forward holds recon in registers,
    and 4*128 + 8, where it updates recon in place, split in two there: the
    second split's latents are the partial group), checked against the plain
    versions; then at T = 4*512 + 128, C_out 520, where the bf16 backward splits
    too (the second split's steps end in the partial one). Then the transcoder
    where bwd_route gives it the held passes: C_in 136 -> C_out
    264 at T 1,152 (a partial step, unsplit) and 2,176 (split in 2), and phase
    10's mixed3a -> mixed3b launch (T ML_T = 3,072, 256 -> 480, H 2,048: split
    in 3), the bf16 split launch and the same launch unsplit each held pass by
    pass to the plain versions and repeated bitwise (_held_pair); no rows."""
    c_in, h = 264, 640
    for t, c_out in ((1152, 136), (1152, 520), (2176, 520)):
        def tc_coeffs(gen):
            return (torch.tensor([2.0 / (t * c_out), LAMBDA / (t * h)], device=DEVICE),)

        def cc_coeffs(gen):
            n_j = 0.5 + torch.rand(h, device=DEVICE, generator=gen)
            return torch.tensor([2.0 / (t * c_out)], device=DEVICE), n_j * (LAMBDA / (t * h))

        _kernels_coder(fused_transcoder, tag, cd, t, c_in, c_out, h, tc_coeffs, timed=False)
        _kernels_coder(fused_crosscoder, tag, cd, t, c_in, c_out, h, cc_coeffs, timed=False)
    for t, c_in, c_out, h in ((1152, 136, 264, 640), (2176, 136, 264, 640),
                              (ML_T, TC_CIN, TC_COUT, 2048)):
        def tc_coeffs(gen):
            return (torch.tensor([2.0 / (t * c_out), LAMBDA / (t * h)], device=DEVICE),)

        _kernels_coder(fused_transcoder, tag, cd, t, c_in, c_out, h, tc_coeffs, timed=False)
    return {}


def kernels_crosscoder(cd, tag: str, t: int = CC_T, h: int = CC_H, kernels=None) -> dict:
    """Rows 13-14 at phase 6's shape, or ``kernels`` at a shard, as
    kernels_transcoder."""
    csum = sum(CC_DIMS)

    def coeffs(gen):
        # the L1 cotangent n_j·λ/(T·H), with decoder-norm weights n_j around 1
        n_j = 0.5 + torch.rand(h, device=DEVICE, generator=gen)
        return (torch.tensor([2.0 / (CC_T * csum)], device=DEVICE),
                n_j * (LAMBDA / (CC_T * CC_H)))

    return _kernels_coder(fused_crosscoder, tag, cd, t, csum, csum, h, coeffs, kernels=kernels)


def phase_kernels() -> dict:
    """Every kernel against its plain version in f32 and bf16; returns the bf16
    (main path) rows."""
    set_tf32(False)  # the plain versions' f32 products in full f32
    rows = {}
    for cd, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for fn in (kernels_relu, kernels_relu_dx, kernels_gated, kernels_jumprelu,
                   kernels_matryoshka, kernels_sae_widths, kernels_act_widths,
                   kernels_pair_shapes, kernels_coder_ragged, kernels_transcoder,
                   kernels_crosscoder):
            with torch.no_grad():
                r = fn(cd, tag)
            torch.cuda.empty_cache()  # the plain versions' [T, H] temporaries
            if cd == torch.bfloat16:
                rows.update(r)
    return rows


# ---------------------------------------------------------------------------
# parity phase
# ---------------------------------------------------------------------------

def _parity(name: str, params: dict, fused_fn, stock_fn, keys: tuple) -> None:
    def grads(loss_fn):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        out = loss_fn(p)
        g = torch.autograd.grad(out["loss"], list(p.values()))
        return out, dict(zip(p, g))

    out_f, g_f = grads(fused_fn)
    out_s, g_s = grads(stock_fn)
    for k in keys:
        a, b = float(out_f[k].detach()), float(out_s[k].detach())
        if not math.isclose(a, b, rel_tol=1e-4):
            raise AssertionError(f"parity {name} {k}: fused {a} vs stock {b}")
    for k in params:
        err = (g_f[k] - g_s[k]).abs().max().item()
        scale = g_s[k].abs().max().item()
        log(f"[parity] {name} grad {k}: max_abs_err {err:.3e} (max|ref| {scale:.3e})")
        if err > 1e-4 * scale + 1e-7 or scale == 0.0:
            raise AssertionError(f"parity {name} grad {k}: max abs err {err:.3e} "
                                 f"(max|ref| {scale:.3e})")
    log(f"[parity] {name}: fused op == stock autograd path (f32): ok")


def _parity_dx(name: str, kernel, x, fused_fn, stock_fn) -> None:
    """The input gradient of a fused op with compute_dx=True (one launch of its
    dx kernel) against the stock autograd path's."""
    def xgrad(loss_fn):
        xx = x.clone().requires_grad_(True)
        return torch.autograd.grad(loss_fn(xx)["loss"], [xx])[0]

    before = kernel.launches
    g_f = xgrad(fused_fn)
    if kernel.launches != before + 1:
        raise AssertionError(f"parity {name} dx: {kernel.name} was not launched")
    g_s = xgrad(stock_fn)
    err = (g_f - g_s).abs().max().item()
    scale = g_s.abs().max().item()
    log(f"[parity] {name} grad x: max_abs_err {err:.3e} (max|ref| {scale:.3e})")
    if err > 1e-4 * scale + 1e-7 or scale == 0.0:
        raise AssertionError(f"parity {name} grad x: max abs err {err:.3e} "
                             f"(max|ref| {scale:.3e})")
    log(f"[parity] {name}: compute_dx=True x gradient == stock autograd path (f32): ok")


def phase_parity() -> None:
    """Each fused op (kernels + autograd.Function) against the stock autograd path
    on the card: loss terms and every parameter gradient, f32, small shape; for
    the sae_mlp and Matryoshka ops also the input gradient (compute_dx=True).
    The gated, JumpReLU and Matryoshka inputs, and those of the input-gradient
    checks, lie on _exact_inputs' grid, so both paths switch the same latents
    on."""
    set_tf32(False)
    base = ("loss", "rec_loss", "l1_loss", "nrmse_loss", "rmse_loss")
    f32 = torch.float32

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    params = init_sae_mlp(gen, C, 4)
    params["b_enc"] = params["b_enc"] - 0.05
    x = torch.randn(512, C, device=DEVICE, generator=gen)
    _parity("sae_mlp", params,
            lambda p: fused_sae.fused_sae_loss_terms(p, x, LAMBDA, 4, compute_dtype=f32),
            lambda p: sae_inference_and_loss("sae_mlp", p, x, LAMBDA), base)

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    params = init_gated_sae(gen, C, 4)  # r_mag = 0: both paths' magnitude products exact
    x, params["W_gate"], params["b_dec"] = _exact_inputs(gen, 512, params["W_gate"])
    params["b_gate"] = _odd_grid(gen, 4 * C, 100)
    params["b_mag"] = _odd_grid(gen, 4 * C, 60)
    _parity("gated_sae", params,
            lambda p: fused_gated_sae.fused_gated_sae_loss_terms(p, x, LAMBDA, 4,
                                                                 compute_dtype=f32),
            lambda p: sae_inference_and_loss("gated_sae", p, x, LAMBDA), base + ("aux_loss",))

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    params = init_jumprelu_sae(gen, C, 4, threshold_init=0.5)
    x, params["W_enc"], params["b_dec"] = _exact_inputs(gen, 512, params["W_enc"])
    params["b_enc"] = _odd_grid(gen, 4 * C, 100)
    params["log_threshold"] = params["log_threshold"] + 0.5 * torch.rand(
        4 * C, device=DEVICE, generator=gen)
    _parity("jumprelu_sae", params,
            lambda p: fused_jumprelu_sae.fused_jumprelu_sae_loss_terms(
                p, x, LAMBDA_J, 4, compute_dtype=f32, bandwidth=BANDWIDTH),
            lambda p: sae_inference_and_loss("jumprelu_sae", p, x, LAMBDA_J,
                                             jumprelu_bandwidth=BANDWIDTH),
            base + ("l0_loss",))

    # 2,048 latents: the default prefixes then end at multiples of 128
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    params = init_sae_mlp(gen, C, 8)
    x, params["W_enc"], params["b_dec"] = _exact_inputs(gen, 512, params["W_enc"])
    params["b_enc"] = _odd_grid(gen, 8 * C, 100)
    bounds = matryoshka_prefix_counts(8 * C, DEFAULT_MATRYOSHKA_PREFIXES)
    got = fused_matryoshka_sae.fused_matryoshka_sae(params, x, bounds,
                                                    compute_dtype=f32)["prefix_losses"]
    want = torch.stack([(r - x).square().mean()
                        for r in matryoshka_sae_apply(params, x, bounds)[3]])
    log(f"[parity] matryoshka_sae prefix_losses {got.tolist()} vs stock {want.tolist()}")
    if not torch.allclose(got, want, rtol=1e-5, atol=0.0):
        raise AssertionError("parity matryoshka_sae prefix_losses")
    _parity("matryoshka_sae", params,
            lambda p: fused_matryoshka_sae.fused_matryoshka_sae_loss_terms(
                p, x, LAMBDA, 8, compute_dtype=f32),
            lambda p: sae_inference_and_loss("matryoshka_sae", p, x, LAMBDA),
            base + ("aux_loss",))
    _parity_dx("matryoshka_sae", fused_matryoshka_sae.dx_kernel, x,
               lambda xx: fused_matryoshka_sae.fused_matryoshka_sae_loss_terms(
                   params, xx, LAMBDA, 8, compute_dtype=f32, compute_dx=True),
               lambda xx: sae_inference_and_loss("matryoshka_sae", params, xx, LAMBDA))
    # the same params: sae_mlp has the Matryoshka SAE's layout
    _parity_dx("sae_mlp", fused_sae.dx_kernel, x,
               lambda xx: fused_sae.fused_sae_loss_terms(params, xx, LAMBDA, 8,
                                                         compute_dtype=f32, compute_dx=True),
               lambda xx: sae_inference_and_loss("sae_mlp", params, xx, LAMBDA))

    # the transcoder at its real widths, 1,024 latents; the target y is random
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    params = init_transcoder(gen, TC_CIN, 4, TC_COUT)
    x, params["W_enc"], _ = _exact_inputs(gen, 512, params["W_enc"])
    params["b_enc"] = _odd_grid(gen, 4 * TC_CIN, 100)
    params["b_dec"] = 0.1 * torch.randn(TC_COUT, device=DEVICE, generator=gen)
    y = torch.randn(512, TC_COUT, device=DEVICE, generator=gen)
    _parity("transcoder", params,
            lambda p: fused_transcoder.fused_transcoder_loss_terms(p, x, y, LAMBDA, 4,
                                                                   compute_dtype=f32),
            lambda p: transcoder_inference_and_loss(p, x, y, LAMBDA), base)

    # the crosscoder with ΣC = 176, not a multiple of the kernels' 32- and
    # 128-channel chunks, and 640 latents; the loss's decoder-norm weights n_j
    # carry gradient into every W_dec_i
    dims = (40, 64, 72)
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    params = init_crosscoder(gen, dims, 16)
    xs = []
    for i, d in enumerate(dims):
        xi, params[f"W_enc_{i}"], _ = _exact_inputs(gen, 512, params[f"W_enc_{i}"])
        params[f"b_dec_{i}"] = 0.1 * torch.randn(d, device=DEVICE, generator=gen)
        xs.append(xi)
    params["b_enc"] = _odd_grid(gen, 16 * dims[0], 100)
    xs = tuple(xs)
    _parity("crosscoder", params,
            lambda p: fused_crosscoder.fused_crosscoder_loss_terms(p, xs, LAMBDA, 16,
                                                                   compute_dtype=f32),
            lambda p: crosscoder_inference_and_loss(p, xs, LAMBDA), base)


# ---------------------------------------------------------------------------
# dx phase
# ---------------------------------------------------------------------------

def phase_dx() -> dict:
    """The dx kernels' path: the input gradient that attribution through a
    spliced SAE takes, fused_sae_loss_terms and the Matryoshka op with
    compute_dx=True at the training shape in bf16, through torch.autograd, on
    _relu_exact_operands' grid. Every count is set to 0 just before each op and
    read just after: the op must launch its forward, backward and dx kernels
    once each and no other kernel, and x's gradient must be finite and within
    the dx check's tolerance of the dx entry point's plain version on the
    operands the op saved. Returns the dx kernels' launches."""
    set_tf32(False)
    bf, fm = torch.bfloat16, fused_matryoshka_sae
    x, we, be, wd, bd = _relu_exact_operands(torch.float32)
    params = {"W_enc": we, "b_enc": be, "W_dec": wd, "b_dec": bd}
    saved = (x.to(bf) - bd.to(bf), we.to(bf), be, wd.to(bf))  # x_cent and the cast weights
    bounds = matryoshka_prefix_counts(H, DEFAULT_MATRYOSHKA_PREFIXES)
    launches = {}
    for mod in (fused_sae, fm):
        for k in KERNELS:
            k.launches = 0
        xx = x.clone().requires_grad_(True)
        if mod is fused_sae:
            out = fused_sae.fused_sae_loss_terms(params, xx, LAMBDA, H // C, compute_dtype=bf,
                                                 compute_dx=True)
        else:
            out = fm.fused_matryoshka_sae_loss_terms(params, xx, LAMBDA, H // C,
                                                     compute_dtype=bf, compute_dx=True)
        (gx,) = torch.autograd.grad(out["loss"], [xx])
        torch.cuda.synchronize()
        got = {k.name: k.launches for k in KERNELS}
        log(f"[dx] {mod.dx_kernel.name}: compute_dx=True at T={T} C={C} H={H} (bf16); "
            f"launches {got}")
        want = {k.name: int(k in mod.KERNELS) for k in KERNELS}
        if got != want:
            raise AssertionError(f"dx phase: expected launches {want}, got {got}")
        if not bool(torch.isfinite(gx).all()):
            raise AssertionError(f"dx phase: non-finite x gradient ({mod.dx_kernel.name})")
        launches[mod.dx_kernel.name] = got[mod.dx_kernel.name]
        # the plain dx on what the op saved: its error in bf16 and (c_rec, c_l1)
        # from the loss's cotangents, 1 for the reconstruction term (1/P per
        # prefix) and λ for l1
        if mod is fused_sae:
            err = (out["decoded"] - x).to(bf)
            coeffs = torch.tensor([2.0 / (T * C), LAMBDA / (T * H)], device=DEVICE)
            ref = fused_sae.fused_sae_dx_plain(*saved, err, coeffs)
        else:
            prefix_recon = fm.fused_matryoshka_forward(x.to(bf), saved[1], be, saved[3], bd,
                                                       bounds)[1]
            g = torch.full((len(bounds),), 1.0 / len(bounds), device=DEVICE) * (2.0 / (T * C))
            s = (g[:, None, None] * (prefix_recon - x[None])).flip(0).cumsum(0).flip(0).to(bf)
            coeffs = torch.tensor([1.0, LAMBDA / (T * H)], device=DEVICE)
            ref = fm.fused_matryoshka_dx_plain(*saved, s, coeffs, bounds)
        _check("x.grad vs plain dx", gx, ref, 1e-3, 1e-4)
        del out, gx, ref
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------

# sae_model_name -> (config fields beyond the shared ones, steps whose perc_dead
# reads a freshly restarted accumulator, train images: None for the 512 of the
# synthetic stand-in). JumpReLU takes the "scaled" STE rule, bandwidth ≈ the
# activations' std and θ0 = std/2 (docs/CONVERGENCE.md:39), at the std of this
# run's stand-in activations, ~0.05 (random backbone, synthetic images); θ0 = 0.5
# would sit ~7 std above every pre-activation and no latent would ever fire.
SLICES = {
    # resets at 4 and 12, the resample at 9
    "sae_mlp": (dict(sae_lambda_sparse=LAMBDA), (4, 9, 12), None),
    "gated_sae": (dict(sae_lambda_sparse=LAMBDA), (4, 8, 12), None),  # the rolling window
    "jumprelu_sae": (dict(sae_lambda_sparse=LAMBDA_J, jumprelu_bandwidth=0.05,
                          jumprelu_threshold_init=0.025), (4, 8, 12), None),
    # λ = 5 and the default prefixes 1/16, 1/4, 1 (docs/CONVERGENCE.md:66)
    "matryoshka_sae": (dict(sae_lambda_sparse=LAMBDA), (4, 8, 12), None),
    # bench_transcoder.py:3-5: mixed3a (256) -> mixed3b (480), 16,384 latents
    "transcoder": (dict(sae_lambda_sparse=LAMBDA, transcoder_target_layer="mixed3b"),
                   (4, 9, 12), None),
    # bench_crosscoder.py:3-6: mixed4a..mixed4e (ΣC = 2,896), 8,192 latents, Adam,
    # λ 5, 16,384 tokens a step; 12 steps need 1,004 images of 196 tokens. Each
    # layer trains divided by its cache's token RMS (sae_input_norm="rms"): on the
    # raw stand-in activations (summed MSE ~3.6e-5 at init) λ 5 killed 98% of
    # the latents within four steps (PERF.md §4)
    "crosscoder": (dict(sae_lambda_sparse=LAMBDA, sae_input_norm="rms", sae_layer="mixed4a",
                        crosscoder_layers="mixed4b,mixed4c,mixed4d,mixed4e",
                        sae_expansion_factor=16, sae_optimizer_name="adam",
                        cache_tokens_per_step=16384), (4, 9, 12), 1024),
}


# device work of a traced run, by the start of its name in torch.profiler's
# averages: the host-device copies, the port's kernels (csrc/), and the rest
# (backbone, optimizer, losses, evals)
PORT_KERNELS = ("coder_", "center_kernel", "scale_err_kernel")


def _device_split(averages) -> str:
    """One line: the traced run's device time by kind, from torch.profiler's
    key_averages (self device time, microseconds)."""
    parts = {"HtoD": 0.0, "DtoH": 0.0, "DtoD": 0.0, "port kernels": 0.0, "other": 0.0}
    for e in averages:  # device events only, as the table's total counts them
        if e.device_type.name != "CUDA" or getattr(e, "is_user_annotation", False):
            continue
        if e.key.startswith("Memcpy"):
            kind = next((k for k in ("HtoD", "DtoH", "DtoD") if k in e.key), "DtoD")
        elif any(k in e.key for k in PORT_KERNELS):
            kind = "port kernels"
        else:
            kind = "other"
        parts[kind] += e.self_device_time_total
    total = sum(parts.values())
    return (f"device time {total / 1e3:.1f} ms: " + ", ".join(
        f"{k} {v / 1e3:.1f} ms ({v / max(total, 1e-9):.1%})" for k, v in parts.items()))


def _slice_config(name: str, extra: dict | None = None, datasets=None) -> tuple:
    """(RunConfig, datasets or None) of the slice ``name`` with the fields
    ``extra`` beyond SLICES' (a name SLICES lacks: the shared fields only);
    ``datasets`` given replace the synthetic stand-in of load_data."""
    fields, _, n_train = SLICES.get(name, ({}, (), None))
    cfg = RunConfig(**{
        **dict(model_name="inceptionv1", dataset_name="imagenet", sae_layer="mixed3a",
               sae_model_name=name, sae_expansion_factor=64,
               sae_optimizer_name="constrained_adam", sae_learning_rate=1e-3,
               sae_batch_size=256, use_activation_cache=True, cache_tokens_per_step=32768,
               cache_dtype="bfloat16", sae_epochs=1, dead_neurons_steps=4,
               directory_path=str(WORK)),
        **fields, **(extra or {})})
    if datasets is None and n_train is not None:  # load_data's stand-in, more train images
        size = (229, 229, 3)
        train = make_synthetic(num_samples=n_train, seed=cfg.seed, img_size=size,
                               num_classes=1000)
        val = make_synthetic(num_samples=256, seed=cfg.seed + 1, img_size=size,
                             num_classes=1000)
        datasets = (train, val, train.category_names, size)
    elif datasets is None and not cfg.data_dir:
        datasets = _standin(cfg)
    return cfg, datasets


# load_data's synthetic stand-in by (dataset, seed): drawn once and shared by
# the runs that would each draw it (~11.5 s a draw at 229 px, most of a
# slice's set-up)
_STANDINS: dict = {}


def _standin(cfg: RunConfig) -> tuple:
    """What Pipeline draws for ``cfg`` without datasets or data_dir: load_data's
    stand-in, which depends on the dataset and the seed only."""
    key = (cfg.dataset_name, cfg.seed)
    if key not in _STANDINS:
        _STANDINS[key] = load_data(cfg)
    return _STANDINS[key]


def phase_slice(name: str, profile: bool = False, extra: dict | None = None,
                label: str = "", keep: bool = False, datasets=None,
                on_pipeline=None) -> tuple:
    """One north-star-width run of ``name`` through the port's Pipeline, with
    the config fields ``extra`` beyond SLICES' (``label`` names the run in the
    log) and ``datasets`` in place of the stand-in (_slice_config); returns
    (launches per kernel, the last eval's means, the cache directory of its
    sae_layer, which ``keep`` leaves on disk). ``profile`` traces the run with
    torch.profiler and prints device time by kernel. ``on_pipeline(pipe)``
    checks the Pipeline once it is built."""
    set_tf32(False)
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for the backbone convs
    shutil.rmtree(WORK, ignore_errors=True)
    restarts = SLICES[name][1]
    name_log = f"{name}{label}"
    cfg, datasets = _slice_config(name, extra, datasets)
    t0 = time.perf_counter()
    pipe = Pipeline(cfg, datasets=datasets)
    log(f"[slice {name_log}] pipeline built in {time.perf_counter() - t0:.1f} s "
        f"(train {len(pipe.train_ds)} / val {len(pipe.val_ds)} images, "
        f"{pipe.num_units} latents)")
    if on_pipeline is not None:
        on_pipeline(pipe)
    before = {k: v.clone() for k, v in pipe.ts.params.items()}
    for k in KERNELS + BODY_KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as trace

        with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pipe.train_sae()
        averages = prof.key_averages()
        log(averages.table(sort_by="self_device_time_total", row_limit=25))
        log(f"[slice {name_log}] {_device_split(averages)}")
    else:
        pipe.train_sae()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS + BODY_KERNELS}
    log(f"[slice {name_log}] train_sae (dump, 12 steps, 2 evals) in {wall:.1f} s; "
        f"launches {launches}")

    steps = [(s, {k: float(v) for k, v in m.items()}) for s, m in pipe.train_log]
    for s, m in steps:
        log(f"[slice {name_log}] step {s}: sae_loss {m['sae_loss']:.6g} rec "
            f"{m['sae_rec_loss']:.6g} l1 {m['sae_l1_loss']:.6g} sparsity "
            f"{m['sparsity']:.6g} perc_dead {m['perc_dead']:.6g}")
    if len(steps) != 12:
        raise AssertionError(f"{name_log}: expected 12 train steps, ran {len(steps)}")
    if not all(math.isfinite(v) for _, m in steps for v in m.values()):
        raise AssertionError(f"{name_log}: non-finite step metric")
    by_step = dict(steps)
    # each restart leaves an all-True accumulator, which perc_dead reads (the
    # JAX step's documented quirk)
    for s in restarts:
        if by_step[s]["perc_dead"] != 1.0:
            raise AssertionError(f"{name_log}: no restart of the dead accumulator at step {s}: "
                                 f"perc_dead {by_step[s]['perc_dead']}")
    # and between restarts latents fire, so the restarts are what set it to 1
    if not all(m["perc_dead"] < 1.0 and m["sparsity"] > 0.0
               for s, m in steps if s not in restarts):
        raise AssertionError(f"{name_log}: every latent dead between restarts")
    timing = pipe.train_timing[0]
    log(f"[slice {name_log}] training loop: {timing['steps']} steps, {timing['tokens']} tokens "
        f"in {timing['seconds']:.3f} s = {timing['tokens'] / timing['seconds']:.0f} tokens/s "
        "(host clock, ends in a synchronize)")
    if len(pipe.eval_log) != 2:
        raise AssertionError(f"{name_log}: expected evals before and after the epoch")
    for epoch, m in pipe.eval_log:
        log(f"[slice {name_log}] eval epoch {epoch}: " + json.dumps(m, sort_keys=True))
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"{name_log}: non-finite eval metric at epoch {epoch}")
    trained = (MODULES[name].fwd_kernel, MODULES[name].bwd_kernel)  # not dx: x is data
    # the held passes run under the transcoder's backward where bwd_route gives
    # its widths the held route (256 -> 480 here; the crosscoder's ΣC never)
    held = name == "transcoder" and fused_sae.bwd_route(
        pipe.ts.params["W_enc"].shape[0], pipe.ts.params["W_dec"].shape[-1],
        dtype=cfg.compute_dtype) == "held"
    # and the cluster pair under the JumpReLU, ReLU, Matryoshka and gated
    # backwards where it gives their width the pair
    pair_body = _slice_pair_body(name, cfg, pipe.ts.params)
    for k in KERNELS + BODY_KERNELS:
        want = 12 if (k in trained or (held and k in HELD_KERNELS) or k is pair_body) else 0
        if launches[k.name] != want:
            raise AssertionError(f"{name_log}: expected {want} launches of {k.name}, got "
                                 f"{launches[k.name]}")
    for k, v in pipe.ts.params.items():
        moved = int((v != before[k]).sum())
        log(f"[slice {name_log}] {k}: {moved} of {v.numel()} entries moved")
        if k == "log_threshold" and moved == 0:
            raise AssertionError(f"{name_log}: no threshold moved: the STE path did not train")
    if name == "crosscoder":
        with open(pipe.decoder_norms_path) as f:
            rows = sum(1 for _ in f) - 1
        log(f"[slice {name_log}] decoder-norm CSV {pipe.decoder_norms_path}: {rows} rows")
        if rows != pipe.num_units:
            raise AssertionError(f"{name_log}: decoder-norm CSV has {rows} rows, not one per "
                                 "latent")
    last_eval, cache_dir = pipe.eval_log[-1][1], pipe._cache_dir(cfg.sae_layer)
    del pipe
    torch.cuda.empty_cache()
    if not keep:
        shutil.rmtree(WORK, ignore_errors=True)
    return {k: v for k, v in launches.items() if v}, last_eval, cache_dir


# ---------------------------------------------------------------------------
# cache phase
# ---------------------------------------------------------------------------

STAGE_ROUNDS = 8  # passes over the cache's stacks: each pinned buffer size is reused
INT8_BOUND = 0.05  # relative: the int8 run's last sae_rec_loss and sparsity vs bf16's


def _staged_copies_equal(cache_dir: str) -> None:
    """(a) Every stack that prefetch stages onto the card (pinned buffers, a
    side stream, an event each) is bitwise equal to a synchronous copy of the
    same host stack, read after two fused forward launches queued on the compute
    stream; over STAGE_ROUNDS passes each pinned buffer is reused, so a buffer
    refilled before its copy had landed would show."""
    from sparse_vision_tpu_torch.data.activation_cache import ActivationCache
    from sparse_vision_tpu_torch.data.prefetch import prefetch

    host = list(ActivationCache(cache_dir).stacks(T, Pipeline.CACHE_SCAN_K, shuffle=True))
    items = host * STAGE_ROUNDS
    ops = _relu_exact_operands(torch.bfloat16)
    t0 = time.perf_counter()
    with torch.no_grad():
        for i, staged in enumerate(prefetch(iter(items), DEVICE)):
            for _ in range(2):  # the compute stream is busy when the stack is read
                fused_sae.fused_sae_forward(*ops)
            if not torch.equal(staged, items[i].to(DEVICE)):
                raise AssertionError(f"cache: staged stack {i} differs from a synchronous copy")
    torch.cuda.synchronize()
    log(f"[cache] (a) {len(items)} staged stacks ({[tuple(h.shape) for h in host]}, "
        f"{STAGE_ROUNDS} passes) bitwise equal to synchronous copies, read behind fused "
        f"launches, in {time.perf_counter() - t0:.1f} s")


def _same_bytes(a: str, b: str) -> int:
    """Fail unless directories ``a`` and ``b`` hold the same files with the same
    bytes; returns the file count."""
    names = sorted(os.listdir(a))
    if names != sorted(os.listdir(b)) or any(".tmp" in n for n in names):
        raise AssertionError(f"cache: files differ: {names} vs {sorted(os.listdir(b))}")
    for n in names:
        if Path(a, n).read_bytes() != Path(b, n).read_bytes():
            raise AssertionError(f"cache: {n} differs between {a} and {b}")
    return len(names)


def phase_cache(bf16_eval: dict) -> None:
    """The host side of the cached path at the sae_mlp slice's shape (mixed3a,
    bf16 cache, T 32,768, K 8): (b) an overlap_dump_train run (the dump on a
    thread of its own stream, the epoch streamed from its shards) makes 12
    finite steps with 12 + 12 launches, and its shards are byte-equal to a
    sequential dump's; (a) the staged copies of that cache are bitwise equal to
    synchronous ones (_staged_copies_equal); (c) a cache_dtype="int8" run makes
    its 12 steps through the device-dequantizing steps, and its last eval's
    sae_rec_loss and sparsity are within INT8_BOUND of the bf16 slice's
    (``bf16_eval``; tests/test_int8_cache.py:100-110's bound)."""
    import sparse_vision_tpu_torch.train.pipeline as pipeline_mod
    from sparse_vision_tpu_torch.data.activation_cache import dump_activations

    _, _, over_dir = phase_slice("sae_mlp", extra=dict(overlap_dump_train=True),
                                 label=" (overlap_dump_train)", keep=True)
    cfg, _ = _slice_config("sae_mlp")
    pipe = Pipeline(dataclasses.replace(cfg, directory_path=str(WORK / "sequential")))
    seq_dir = pipe._cache_dir(cfg.sae_layer)
    t0 = time.perf_counter()
    dump_activations(pipe.net, pipe.frozen_params, pipe.net_state, pipe.train_ds,
                     cfg.sae_layer, seq_dir, device=pipe.device, **pipe._cache_dump_kwargs())
    del pipe
    n = _same_bytes(over_dir, seq_dir)
    log(f"[cache] (b) the overlapped dump's {n} files are byte-equal to a sequential dump's "
        f"(sequential dump {time.perf_counter() - t0:.1f} s)")
    _staged_copies_equal(seq_dir)
    shutil.rmtree(WORK, ignore_errors=True)

    quant = {"multi": 0, "single": 0}

    def counted(make, key):
        def wrapped(step_fn):
            inner = make(step_fn)

            def run(ts, q, *rest):
                if q.dtype != torch.int8 or q.device.type != torch.device(DEVICE).type:
                    raise AssertionError(f"cache: the quant step got {q.dtype} on {q.device}")
                quant[key] += 1
                return inner(ts, q, *rest)
            return run
        return wrapped

    saved = (pipeline_mod.make_sae_train_multi_step_quant, pipeline_mod.make_dequant_step_fn)
    pipeline_mod.make_sae_train_multi_step_quant = counted(saved[0], "multi")
    pipeline_mod.make_dequant_step_fn = counted(saved[1], "single")
    try:
        _, int8_eval, _ = phase_slice("sae_mlp", extra=dict(cache_dtype="int8"),
                                      label=" (int8 cache)")
    finally:
        pipeline_mod.make_sae_train_multi_step_quant, pipeline_mod.make_dequant_step_fn = saved
    steps = Pipeline.CACHE_SCAN_K * quant["multi"] + quant["single"]
    if steps != 12:
        raise AssertionError(f"cache: {steps} of 12 steps took the device-dequant steps")
    for key in ("sae_rec_loss", "sparsity"):
        rel = abs(int8_eval[key] - bf16_eval[key]) / abs(bf16_eval[key])
        log(f"[cache] (c) int8 {key} {int8_eval[key]:.6g} vs bf16 {bf16_eval[key]:.6g}: "
            f"{rel:.4%} apart (bound {INT8_BOUND:.0%})")
        if not rel <= INT8_BOUND:
            raise AssertionError(f"cache: int8 {key} is {rel:.2%} from bf16's")
    log(f"[cache] (c) {quant['multi']} multi-step and {quant['single']} single dispatches "
        "dequantized int8 stacks on the card")


# ---------------------------------------------------------------------------
# artifacts phase
# ---------------------------------------------------------------------------

COUNTING = ("perc_same", "perc_dead_units", "accuracy")
EVAL_RTOL = 1e-6  # the standalone eval's means against the last training eval's


def _same_state(name: str, a, b) -> None:
    """Fail unless two train states are bitwise equal: params, Adam moments and
    count, step and dead accumulator."""
    for k in a.params:
        for what, x, y in (("param", a.params[k], b.params[k]),
                           ("mu", a.opt_state["mu"][k], b.opt_state["mu"][k]),
                           ("nu", a.opt_state["nu"][k], b.opt_state["nu"][k])):
            if not torch.equal(x, y):
                n = int((x != y).sum())
                raise AssertionError(f"artifacts: {name}: {what} {k} differs in {n} entries")
    if (a.step, a.opt_state["count"]) != (b.step, b.opt_state["count"]):
        raise AssertionError(f"artifacts: {name}: step/count {a.step}/{a.opt_state['count']} "
                             f"vs {b.step}/{b.opt_state['count']}")
    if not torch.equal(a.dead_acc, b.dead_acc):
        raise AssertionError(f"artifacts: {name}: the dead accumulators differ")


def _artifact_run(label: str, want: int, **extra) -> tuple:
    """The gated_sae slice with ``extra`` through Pipeline.run(); fails unless
    rows 6-7 launched ``want`` times each and nothing else launched. Returns
    (pipe, result of run, seconds)."""
    cfg, datasets = _slice_config("gated_sae", extra)
    pipe = Pipeline(cfg, datasets=datasets)
    for k in KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipe.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    trained = (fused_gated_sae.fwd_kernel, fused_gated_sae.bwd_kernel)
    for k in KERNELS:
        if launches[k.name] != (want if k in trained else 0):
            raise AssertionError(f"artifacts: {label}: expected {want if k in trained else 0} "
                                 f"launches of {k.name}, got {launches[k.name]}")
    log(f"[artifacts] {label}: Pipeline.run in {wall:.1f} s, step {pipe.ts.step}, "
        f"{want} + {want} launches of {trained[0].name} / {trained[1].name}")
    return pipe, out, wall


def _check_exports(pipe) -> None:
    """(d) The .npz and .pth that training exported and a SAELens folder, each
    read back through import_any, bitwise equal to the trained params; the
    SAELens file's header parses and names every tensor."""
    from sparse_vision_tpu_torch.train import sae_io

    params = pipe.ts.params
    folder = pipe.paths["sae_weights"]
    stem = os.path.join(folder, f"{sae_run_name(pipe.cfg)}_model_weights")
    t0 = time.perf_counter()
    pipe._export_sae_weights()
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    saelens = sae_io.save_sae_saelens(params, "gated_sae", os.path.join(folder, "saelens"))
    saelens_s = time.perf_counter() - t0
    for path in (stem + ".npz", stem + ".pth", saelens):
        got = sae_io.import_any(path, "gated_sae", like=params)
        for k, v in params.items():
            if not torch.equal(got[k], v.cpu()):
                raise AssertionError(f"artifacts: {path}: {k} does not read back bitwise")
    wpath = os.path.join(saelens, sae_io.SAELENS_WEIGHTS_FILE)
    raw = Path(wpath).read_bytes()
    n = int.from_bytes(raw[:8], "little")
    header = json.loads(raw[8:8 + n])
    want = {"W_enc": params["W_gate"], "b_gate": params["b_gate"], "b_mag": params["b_mag"],
            "r_mag": params["r_mag"], "W_dec": params["W_dec"], "b_dec": params["b_dec"]}
    for k, v in want.items():
        e = header[k]
        if e["dtype"] != "F32" or e["shape"] != list(v.shape):
            raise AssertionError(f"artifacts: SAELens header entry {k}: {e}")
    if max(e["data_offsets"][1] for k, e in header.items() if k != "__metadata__") != \
            len(raw) - 8 - n:
        raise AssertionError("artifacts: the SAELens header's offsets do not end the file")
    log(f"[artifacts] (d) .npz, .pth and SAELens exports read back bitwise equal; export "
        f"(.npz + .pth, {os.path.getsize(stem + '.npz') + os.path.getsize(stem + '.pth')} "
        f"bytes) {export_s:.3f} s, SAELens {saelens_s:.3f} s; header of {len(header)} "
        "entries parsed")


def _check_results(pipe, last: dict) -> dict:
    """(e) The results CSV's rows of epochs 1 and 2, the second with the last
    eval's values; the epoch-2 top-k file: [25, H] indices of samples in
    [0, 256), unique per unit, and H finite activity frequencies in [0, 1]."""
    import numpy as np

    from sparse_vision_tpu_torch.eval_tools.results import read_results

    folder = pipe.paths["evaluation_results"]
    rows = read_results(os.path.join(folder, "sae_eval_results.csv"))
    if [r["epochs"] for r in rows] != [1.0, 2.0]:
        raise AssertionError(f"artifacts: results rows {[r['epochs'] for r in rows]}")
    names = {"rec_loss": "sae_rec_loss", "l1_loss": "sae_l1_loss",
             "nrmse_loss": "sae_nrmse_loss", "rmse_loss": "sae_rmse_loss",
             "aux_loss": "sae_aux_loss", "rel_sparsity": "sparsity", "var_expl": "var_expl",
             "perc_dead_units": "perc_dead_units", "loss_diff": "loss_diff"}
    for col, key in names.items():
        if rows[1][col] != last[key]:
            raise AssertionError(f"artifacts: results row 2 {col} {rows[1][col]} != {last[key]}")
    n_val = len(pipe.val_ds)
    with np.load(os.path.join(folder, "filename_indices",
                              f"{pipe.run_id}_epoch_2.npz")) as z:
        f = {k: z[k] for k in z.files}
    h = pipe.num_units
    for k in ("max_filename_indices", "min_filename_indices"):
        idx = f[k]
        if idx.shape != (25, h) or idx.min() < 0 or idx.max() >= n_val:
            raise AssertionError(f"artifacts: {k} shape {idx.shape}, range "
                                 f"[{idx.min()}, {idx.max()}]")
        srt = np.sort(idx, axis=0)
        if (srt[1:] == srt[:-1]).any():
            raise AssertionError(f"artifacts: {k} repeats a sample within a unit")
    freq = f["activity_freq"]
    if freq.shape != (h,) or not np.isfinite(freq).all() or freq.min() < 0 or freq.max() > 1:
        raise AssertionError(f"artifacts: activity_freq shape {freq.shape}, range "
                             f"[{freq.min()}, {freq.max()}]")
    log(f"[artifacts] (e) results rows of epochs 1 and 2 (row 2 = the last eval); top-k "
        f"file [25, {h}] indices in [0, {n_val}), unique per unit; activity_freq in "
        f"[{freq.min():.4g}, {freq.max():.4g}], {int(f['dead_units'].sum())} dead units")
    return f


def _check_topk_values(pipe, f: dict) -> None:
    """The top-k file's samples rank first by value: the values at its indices,
    from a fresh pass of the eval step over the validation images, equal the
    largest and smallest 25 of each unit (values, not order, so the check does
    not depend on how equal values are ordered)."""
    import numpy as np

    bs = pipe.cfg.eval_batch_size or pipe._auto_eval_batch_size()
    with torch.no_grad():
        acts = torch.cat([pipe._sae_eval_step_fn(
            pipe.ts.params, pipe.frozen_params, pipe.net_state,
            torch.from_numpy(b.images).to(DEVICE), torch.from_numpy(b.labels).to(DEVICE)
        )[1]["topk_acts"] for b in pipe.val_ds.batches(bs, shuffle=False)])
    scale = float(acts.abs().max())
    for k, largest in (("max_filename_indices", True), ("min_filename_indices", False)):
        idx = torch.from_numpy(f[k].astype(np.int64)).to(DEVICE)
        got = acts.gather(0, idx)
        want = torch.topk(acts, 25, dim=0, largest=largest).values
        err = float((got - want).abs().max())
        if not err <= 1e-6 * scale:
            raise AssertionError(f"artifacts: {k}: values at the file's indices {err:.3g} "
                                 f"from the top 25 (scale {scale:.3g})")
    log(f"[artifacts] (e) the top-k file's samples hold the 25 largest and smallest values "
        f"of each unit (fresh eval pass, {acts.shape[0]} samples)")


def phase_artifacts() -> None:
    """A trained dictionary as an artifact (gated_sae slice, two epochs; its
    rolling window never resamples, so the generator, which is not
    checkpointed, plays no part)."""
    set_tf32(False)
    torch.backends.cudnn.allow_tf32 = True
    shutil.rmtree(WORK, ignore_errors=True)
    split, whole = str(WORK / "resumed"), str(WORK / "uninterrupted")
    # (b) one epoch, then a fresh Pipeline resumed from its checkpoint
    _, _, _ = _artifact_run("(b) epoch 1", 12, sae_epochs=1, directory_path=split)
    resumed, _, _ = _artifact_run("(b) resumed to epoch 2", 12, sae_epochs=2,
                                  sae_checkpoint_epoch=1, directory_path=split)
    # (a) the uninterrupted run, from a copy of the same cache bytes
    cache = os.path.join(resumed.paths["evaluation_results"], "activation_cache")
    cfg, _ = _slice_config("gated_sae", dict(sae_epochs=2, directory_path=whole))
    from sparse_vision_tpu_torch.utils.paths import folder_paths

    shutil.copytree(cache, os.path.join(folder_paths(cfg)["evaluation_results"],
                                        "activation_cache"))
    pipe, last, _ = _artifact_run("(a) uninterrupted", 24, sae_epochs=2, directory_path=whole)
    _same_state("(b) against (a)", resumed.ts, pipe.ts)
    log("[artifacts] (b) the resumed run is bitwise equal to the uninterrupted one: params, "
        "Adam moments and count, step, dead accumulator")
    del resumed
    torch.cuda.empty_cache()

    # one checkpoint's snapshot, write and restore
    tree, ck_dir = pipe._ckpt_tree(), str(WORK / "ckpt_timing")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = ckpt.save_checkpoint(ck_dir, 1, tree, blocking=False)
    t1 = time.perf_counter()
    ckpt.wait_for_saves()
    t2 = time.perf_counter()
    back = ckpt.load_checkpoint(ck_dir, 1, like=tree)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    on_card = back["dead_acc"].device.type == torch.device(DEVICE).type
    if not on_card or back["opt_state"]["count"] != 24:
        raise AssertionError("artifacts: the restored checkpoint is off the card or miscounted")
    _same_state("checkpoint round trip", pipe.ts, pipe.ts._replace(
        params=back["params"], opt_state=back["opt_state"], step=back["step"],
        dead_acc=back["dead_acc"]))
    log(f"[artifacts] checkpoint of {os.path.getsize(path)} bytes: snapshot (blocking) "
        f"{(t1 - t0) * 1e3:.1f} ms, write {(t2 - t1) * 1e3:.1f} ms, restore to the card "
        f"{(t3 - t2) * 1e3:.1f} ms; round trip bitwise")

    _check_exports(pipe)
    f = _check_results(pipe, last)

    # (c) the standalone eval of the epoch-2 checkpoint
    import sparse_vision_tpu_torch.train.pipeline as pipeline_mod

    evaluated, means, eval_s = _artifact_run("(c) standalone eval", 0, training=False,
                                             sae_epochs=2, sae_checkpoint_epoch=2,
                                             directory_path=whole)
    _same_state("(c) restored against (a)", evaluated.ts, pipe.ts)
    for k, v in last.items():
        if (means[k] != v) if k in COUNTING else not abs(means[k] - v) <= EVAL_RTOL * abs(v):
            raise AssertionError(f"artifacts: standalone eval {k} {means[k]!r} vs last "
                                 f"training eval {v!r}")
    exact = sum(means[k] == v for k, v in last.items())
    log(f"[artifacts] (c) standalone eval of the epoch-2 checkpoint reproduces the last "
        f"eval (counts exactly, the rest within {EVAL_RTOL:g} relative; {exact} of "
        f"{len(last)} means bitwise): {json.dumps(means)}")
    del evaluated
    _check_topk_values(pipe, f)

    # an eval with and without its top-k updates, on the same pipeline
    times, bs = {}, pipe.cfg.eval_batch_size or pipe._auto_eval_batch_size()
    saved = pipeline_mod.update_topk
    for label in ("with top-k", "without top-k", "with top-k"):
        if label == "without top-k":
            pipeline_mod.update_topk = lambda state, *_: state
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.eval_modified(epoch=99, store=False)
            torch.cuda.synchronize()
            times.setdefault(label, []).append(time.perf_counter() - t0)
        finally:
            pipeline_mod.update_topk = saved
    log(f"[artifacts] eval of {len(pipe.val_ds)} val images in batches of {bs} (drop_last): "
        f"with its top-k updates "
        f"{times['with top-k']} s, without {times['without top-k']} s (the standalone "
        f"Pipeline.run eval, build not counted: {eval_s:.2f} s)")
    del pipe
    torch.cuda.empty_cache()
    shutil.rmtree(WORK, ignore_errors=True)


# ---------------------------------------------------------------------------
# circuit phase
# ---------------------------------------------------------------------------

# bench_ie.py:1-15, 60-110: GoogLeNet at 229 px, the eight CIRCUIT_LAYERS with
# registry-shaped sae_mlp SAEs; modes 1, 2 and 4 at batch 32, mode 3 at batch 8
# with 64 top features a layer and cotangent chunks of 16 over the whole chain
CIRCUIT_SIZE = (229, 229, 3)
CIRCUIT_IMAGES = 128
CIRCUIT_BATCH, EDGE_BATCH = 32, 8
TOP_FEATURES, COTANGENT_CHUNK = 64, 16
# the synthetic stand-in of seed 0 holds class 543 (image 17), the C5 case; the
# circuit runs on seed 2's images, relabelled (_image_dependent_labels), none
# of class 543
C5_SEED, CIRCUIT_SEED = 0, 2
# the backbone's conv weights times sqrt(6) (Kaiming's ReLU gain over torch's
# default U(+-1/sqrt(fan_in))): at the default init the signal shrinks ~6x per
# conv layer, every image gets the same logits, and faithfulness's denominator
# m(M) - m(empty) is 0
CONV_GAIN = math.sqrt(6.0)
# the circuit layers' taps at 229 px (H, W, C), as the JAX package has them
CIRCUIT_DIMS = {"mixed3a": (28, 28, 256), "mixed3b": (28, 28, 480), "mixed4b": (14, 14, 512),
                "mixed4c": (14, 14, 512), "mixed4d": (14, 14, 528), "mixed4e": (14, 14, 832),
                "mixed5a": (7, 7, 832), "mixed5b": (7, 7, 1024)}
NODE_CPU_IMAGES = 4  # the batch whose node IE the card and the CPU both compute
# the card's f32 node IE against the CPU's f64, within NODE_TOL of each
# array's largest magnitude. Its f32 gradient comes out of cancelling terms:
# on an H100 machine, with the seed's own labels, the worst array of the card
# was 6.59e-4 of its scale from f64 and of the machine's CPU f32 1.5e-3; with
# the image-dependent labels below, 1.24e-3 and 7.83e-4
NODE_TOL = 3e-3
CHUNK_RTOL, CHUNK_ATOL_FRAC = 1e-4, 1e-6  # chunks of 16 against one chunk
# faithfulness at threshold -1: each loss within LOSS_RTOL (16 f32 ulps),
# carried through (m_C - m_empty) / (m_M - m_empty); the phase fails unless
# that tolerance is below FAITH_RESOLVE and leaves out the circuit with its
# SAE errors zero- or mean-ablated
LOSS_RTOL = 16 * torch.finfo(torch.float32).eps
FAITH_RESOLVE = 1e-2


def _sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _circuit_config(seed: int, flag: str, batch: int) -> RunConfig:
    return RunConfig(model_name="inceptionv1", dataset_name="imagenet", sae_layer="mixed3a",
                     sae_model_name="sae_mlp", training=False, compute_ie=flag,
                     sae_batch_size=batch, ie_top_features=TOP_FEATURES,
                     ie_cotangent_chunk=COTANGENT_CHUNK, seed=seed,
                     directory_path=str(WORK / f"circuit_seed{seed}"))


_LABELS: dict = {}  # seed -> _image_dependent_labels of its stand-in


def _image_dependent_labels(net, params, state, images) -> np.ndarray:
    """Each image's ImageNet class: of the classes whose GoogLeNet label lies
    in the head (so never 543, C5), the one whose logit the image raises most
    above the set's mean logits. With the seed's own labels the loss of the
    random net barely depends on the image (m_M - m_empty was 3.0e-4 of a 9.41
    loss on the card), which leaves the faithfulness ratio unresolved."""
    import numpy as np

    from sparse_vision_tpu_torch.data.labels import torch_to_tf_label_table

    with torch.no_grad():
        logits = torch.cat([net.apply(params, torch.from_numpy(images[i:i + CIRCUIT_BATCH])
                                      .to(DEVICE), state=state)[0].double().cpu()
                            for i in range(0, len(images), CIRCUIT_BATCH)])
    table = torch_to_tf_label_table().long()
    inside = table < logits.shape[1]
    inverse = torch.full((logits.shape[1],), -1, dtype=torch.long)
    inverse[table[inside]] = torch.arange(len(table))[inside]
    rise = (logits - logits.mean(0)).masked_fill(inverse < 0, -math.inf)
    return inverse[rise.argmax(1)].numpy().astype(np.int32)


def _scaled_googlenet(seed: int):
    """(net, params, state): GoogLeNet drawn from ``seed`` with its conv weights
    scaled by CONV_GAIN."""
    from sparse_vision_tpu_torch.models.backbone import init_backbone, make_backbone

    net = make_backbone("inceptionv1", "imagenet")
    params, state = init_backbone(net, torch.Generator(device=DEVICE).manual_seed(seed),
                                  "imagenet")

    def scale(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                scale(v)
            elif k == "w" and v.ndim == 4:
                v.mul_(CONV_GAIN)

    scale(params)
    return net, params, state


def _circuit_pipeline(seed: int, flag: str, batch: int | None = None, relabel: bool = True):
    """A Pipeline of the circuit config: the synthetic stand-in of ``seed``
    (CIRCUIT_IMAGES; with ``relabel`` its labels from _image_dependent_labels),
    GoogLeNet drawn from ``seed`` with its conv weights scaled by CONV_GAIN."""
    train = make_synthetic(num_samples=CIRCUIT_IMAGES, seed=seed, img_size=CIRCUIT_SIZE,
                           num_classes=1000)
    net, params, state = _scaled_googlenet(seed)
    if relabel:
        if seed not in _LABELS:
            _LABELS[seed] = _image_dependent_labels(net, params, state, train.images)
        train.labels = _LABELS[seed]
    return Pipeline(_circuit_config(seed, flag, batch or CIRCUIT_BATCH), device=DEVICE,
                    datasets=(train, train, train.category_names, CIRCUIT_SIZE),
                    backbone=(params, state))


def _write_registry_checkpoints(pipe) -> dict:
    """Each circuit layer's registry-shaped sae_mlp, drawn from the seed with
    non-zero b_enc / b_dec, saved at its registry epoch where the registry
    looks (layer_ckpt_dir). Returns the params by layer."""
    from sparse_vision_tpu_torch.interp.registry import (
        CIRCUIT_LAYERS,
        LAYER_SAE_CONFIGS,
        layer_ckpt_dir,
    )
    from sparse_vision_tpu_torch.models.backbone import layer_dimensions

    dims = layer_dimensions(pipe.net, "imagenet")
    gen = torch.Generator(device=DEVICE).manual_seed(pipe.cfg.seed)
    saes = {}
    for name in CIRCUIT_LAYERS:
        reg = LAYER_SAE_CONFIGS[name]
        p = init_sae_mlp(gen, dims[name][-1], reg.expansion_factor)
        p["b_enc"].normal_(0.0, 0.1, generator=gen)
        p["b_dec"].normal_(0.0, 0.1, generator=gen)
        h = p["b_enc"].shape[0]
        ckpt.save_checkpoint(layer_ckpt_dir(pipe.paths["checkpoints"], name),
                             reg.checkpoint_epoch,
                             {"params": p, "opt_state": {}, "step": 0,
                              "dead_acc": torch.ones(h, dtype=torch.bool, device=DEVICE)})
        saes[name] = p
    return saes


def _run_mode(seed: int, flag: str, batch: int, images: int, label: str = "") -> tuple:
    """Pipeline.run of ``flag``, its printed output captured (it must not warn
    of random SAEs) and echoed; returns (pipe, result, seconds)."""
    pipe = _circuit_pipeline(seed, flag, batch)
    out = io.StringIO()
    _sync()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = pipe.run()
    _sync()
    seconds = time.perf_counter() - t0
    for ln in out.getvalue().splitlines():
        log(f"[circuit]   {ln}")
    if "RANDOMLY-INITIALIZED" in out.getvalue():
        raise AssertionError(f"circuit: mode {flag} ran on random SAEs")
    log(f"[circuit] mode {flag}{label}: Pipeline.run in {seconds:.3f} s over {images} images in "
        f"batches of {batch} = {images / seconds:.1f} images/s")
    return pipe, result, seconds


def _check_npz(path: str, shapes: dict) -> dict:
    """Every array of ``path`` finite (dead masks boolean) at ``shapes``."""
    import numpy as np

    with np.load(path) as z:
        got = {k: z[k] for k in z.files}
    if set(got) != set(shapes):
        raise AssertionError(f"circuit: {path} keys {sorted(got)} != {sorted(shapes)}")
    for k, a in got.items():
        if a.shape != shapes[k]:
            raise AssertionError(f"circuit: {path} {k} shape {a.shape} != {shapes[k]}")
        if a.dtype != np.bool_ and not np.isfinite(a).all():
            raise AssertionError(f"circuit: {path} {k} is not finite")
    return got


def _close(name: str, got, want, rtol: float, atol_frac: float) -> float:
    """max |got - want| / max |want|; fails past rtol / atol_frac of the
    largest |want|."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    scale = float(want.abs().max())
    err = (got - want).abs()
    if not bool((err <= rtol * want.abs() + atol_frac * scale).all()):
        raise AssertionError(f"{name}: max error {float(err.max()):.3g} (scale "
                             f"{scale:.3g}) past rtol {rtol:g} / atol {atol_frac:g} of the scale")
    return float(err.max()) / max(scale, 1e-30)


def _cpu_engine(eng, dtype):
    """The engine's weights on the CPU in ``dtype``."""
    from sparse_vision_tpu_torch.interp.circuit import CircuitEngine, FrozenSAE

    return CircuitEngine(eng.net, _tree_to(eng.params, "cpu", dtype), {
        l: FrozenSAE(s.model_name, _tree_to(s.params, "cpu", dtype), s.expansion_factor)
        for l, s in eng.saes.items()}, eng.criterion, state=_tree_to(eng.state, "cpu", dtype))


def _tree_to(tree, device, dtype):
    """A tree of tensors on ``device``, the floating ones cast to ``dtype``
    (integer tensors keep theirs; other leaves pass as they are)."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device, dtype) if tree.is_floating_point() else tree.to(device)
    return tree


def _faith_tol(r: dict) -> float:
    """LOSS_RTOL of the losses carried through the ratio at faithfulness 1."""
    denom = abs(r["m_M"] - r["m_empty"])
    m = max(abs(r["m_C"]), abs(r["m_M"]), abs(r["m_empty"]))
    return LOSS_RTOL * m * 4 / denom


def _check_anchors(phase: str, part: str, eng, data, node, averages) -> None:
    """Faithfulness over ``data`` for the SAE and the model variant: 1 at
    threshold -1, within a tolerance below FAITH_RESOLVE that the circuit with
    its SAE errors zero- or mean-ablated falls outside, and at 1e9 exactly 0
    (m_C is m_empty's own computation)."""
    ablated = ("faithfulness_sae_errors_zero_ablated", "faithfulness_sae_errors_mean_ablated")
    for variant in ("sae", "model"):
        keep, drop = (eng.compute_faithfulness(data, node, thr, model_or_sae=variant,
                                               averages=averages) for thr in (-1.0, 1e9))
        tol = _faith_tol(keep)
        others = {k: keep[k] for k in ablated if k in keep}
        log(f"[{phase}] {part} {variant} faithfulness at threshold -1: "
            f"{keep['faithfulness']!r} (want 1 within {tol:.3g}; m_C {keep['m_C']!r}, "
            f"m_empty {keep['m_empty']!r}, m_M {keep['m_M']!r}; m_M - m_empty "
            f"{keep['m_M'] - keep['m_empty']:.6g}"
            + "".join(f"; {k} {v!r}" for k, v in others.items())
            + f"); at 1e9: {drop['faithfulness']!r} (want exactly 0; m_C "
            f"{drop['m_C']!r}, m_empty {drop['m_empty']!r})")
        if not tol < FAITH_RESOLVE:
            raise AssertionError(f"{phase}: {variant} faithfulness is resolved to "
                                 f"{tol:.3g} only")
        if not abs(keep["faithfulness"] - 1.0) <= tol:
            raise AssertionError(f"{phase}: {variant} faithfulness at -1 is "
                                 f"{keep['faithfulness']}, not 1")
        for k, v in others.items():
            if abs(v - 1.0) <= tol:
                raise AssertionError(f"{phase}: at -1, {k} {v} is within {tol:.3g} of 1: "
                                     "the anchor cannot tell kept errors from ablated")
        if drop["m_C"] != drop["m_empty"] or drop["faithfulness"] != 0.0:
            raise AssertionError(f"{phase}: {variant} faithfulness at 1e9 is "
                                 f"{drop['faithfulness']}, not exactly 0")


def phase_circuit(smi: str) -> None:
    """Circuit discovery (interp/) through Pipeline.run at the flagship config:
    (a) the C5 case: seed 0's stand-in holds class 543, and mode 1 raises a
    ValueError naming it before any pass; (b) on seed 2's images, the eight
    registry SAEs written as checkpoints and loaded through the registry, modes
    1 and 2 at batch 32, 3 at batch 8 (64 top features a layer, cotangent chunks
    of 16, every consecutive pair and the loss node) and 40, each artifact
    finite at the JAX package's shapes; (c) one batch's node IE on the card
    equal to the CPU's (TF32 off); (d) one pair's edges in chunks of 16 equal
    to one chunk of 65; (e) the faithfulness anchors, for the SAE and the model
    variant: 1 at threshold -1, within a tolerance below FAITH_RESOLVE that the
    circuit with its SAE errors zero- or mean-ablated falls outside, and at
    1e9 exactly 0 (m_C is m_empty's own computation). No vmap fallback warning, and
    no kernel of the port launched: no TPU kernel is on this path."""
    import warnings

    import numpy as np

    from sparse_vision_tpu_torch.data.labels import remap_torch_to_tf_labels
    from sparse_vision_tpu_torch.interp import ie
    from sparse_vision_tpu_torch.interp.registry import CIRCUIT_LAYERS, LAYER_SAE_CONFIGS
    from sparse_vision_tpu_torch.models.backbone import layer_dimensions

    set_tf32(False)  # the passes in f32; the card-against-CPU check needs it
    shutil.rmtree(WORK, ignore_errors=True)
    for k in KERNELS:
        k.launches = 0
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        # (a) C5
        c5 = _circuit_pipeline(C5_SEED, "1", relabel=False)
        cls = int(c5.train_ds.labels[17])
        try:
            with contextlib.redirect_stdout(io.StringIO()):  # its random-SAE warning
                c5.run()
        except ValueError as e:
            log(f"[circuit] (a) C5: seed {C5_SEED}'s image 17 is of class {cls}: {e}")
            if f"class {cls}" not in str(e) or cls != 543:
                raise
        else:
            raise AssertionError("circuit: the C5 batch ran")
        del c5

        # (b) the four modes
        first = _circuit_pipeline(CIRCUIT_SEED, "1")
        labels = first.train_ds.labels
        if (labels == 543).any():
            raise AssertionError(f"circuit: seed {CIRCUIT_SEED}'s images hold class 543")
        log(f"[circuit] (b) seed {CIRCUIT_SEED}'s {len(labels)} images relabelled into "
            f"{len(set(labels.tolist()))} classes")
        saes = _write_registry_checkpoints(first)
        dims = layer_dimensions(first.net, "imagenet")
        if {l: dims[l] for l in CIRCUIT_LAYERS} != CIRCUIT_DIMS:
            raise AssertionError(f"circuit: the taps are at {dims}")
        ie_dir = first.paths["ie_related_quantities"]
        del first
        n = CIRCUIT_IMAGES
        _, avgs, s1 = _run_mode(CIRCUIT_SEED, "1", CIRCUIT_BATCH, n)
        ck = {l: dims[l][-1] * LAYER_SAE_CONFIGS[l].expansion_factor for l in CIRCUIT_LAYERS}
        shapes = {}
        for l in CIRCUIT_LAYERS:
            shapes.update({f"enc:{l}": (*dims[l][:-1], ck[l]), f"err:{l}": dims[l],
                           f"out:{l}": dims[l], f"dead:{l}": (ck[l],), f"sparsity:{l}": ()})
        a = _check_npz(os.path.join(ie_dir, "averages.npz"), shapes)
        for f in ("perc_dead_units.csv", "sparsity.csv"):
            with open(os.path.join(ie_dir, f)) as fh:
                rows = list(csv.reader(fh))
            if [r[0] for r in rows[1:]] != list(CIRCUIT_LAYERS) or not all(
                    math.isfinite(float(r[1])) for r in rows[1:]):
                raise AssertionError(f"circuit: {f}: {rows}")
        log("[circuit] (b) averages.npz finite at the JAX shapes (enc:mixed3a "
            f"{shapes['enc:mixed3a']}); dead latents per layer "
            + ", ".join(f"{l} {int(a[f'dead:{l}'].sum())}/{ck[l]}" for l in CIRCUIT_LAYERS)
            + "; sparsity " + ", ".join(f"{float(a[f'sparsity:{l}']):.4g}"
                                        for l in CIRCUIT_LAYERS))

        # twice: the first run pays a one-time cost of ~7 s (not split yet)
        _, _, s2_cold = _run_mode(CIRCUIT_SEED, "2", CIRCUIT_BATCH, n, " (first)")
        node_pipe, node, s2 = _run_mode(CIRCUIT_SEED, "2", CIRCUIT_BATCH, n, " (again)")
        shapes = {}
        for l in CIRCUIT_LAYERS:
            shapes.update({f"features:{l}": (ck[l],), f"error:{l}": (),
                           f"model_neurons:{l}": (dims[l][-1],)})
        _check_npz(os.path.join(ie_dir, "node_ie.npz"), shapes)
        log("[circuit] (b) node_ie.npz finite at the JAX shapes; max |IE| of a feature per "
            "layer " + ", ".join(f"{float(node.features[l].abs().max()):.3g}"
                                 for l in CIRCUIT_LAYERS))

        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _, edges, s3 = _run_mode(CIRCUIT_SEED, "3", EDGE_BATCH, n)
        peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
        k1 = TOP_FEATURES + 1
        shapes = {l: (k1, k1) for l in CIRCUIT_LAYERS[:-1]}
        shapes.update({CIRCUIT_LAYERS[-1]: (k1, 1)})
        shapes.update({f"idx:{l}": (TOP_FEATURES,) for l in CIRCUIT_LAYERS})
        _check_npz(os.path.join(ie_dir, "edge_ie.npz"), shapes)
        log(f"[circuit] (b) edge_ie.npz finite at the JAX shapes ([{k1}, {k1}] per pair, "
            f"[{k1}, 1] to the loss); edge pass peak memory {peak / 2**30:.2f} GiB "
            "(max_memory_allocated)")

        _, rows, s4 = _run_mode(CIRCUIT_SEED, "40", CIRCUIT_BATCH, n)
        with open(os.path.join(ie_dir, "faithfulness.csv")) as fh:
            csv_rows = list(csv.reader(fh))
        if len(csv_rows) != 3 or not all(math.isfinite(float(v)) for r in csv_rows[1:]
                                         for v in r[1:] if v != ""):
            raise AssertionError(f"circuit: faithfulness.csv: {csv_rows}")
        png = os.path.join(ie_dir, "faithfulness.png")
        if _png_size(png) != FIG_SIZES["faithfulness"]:
            raise AssertionError(f"circuit: faithfulness.png is {_png_size(png)}, JAX's is "
                                 f"{FIG_SIZES['faithfulness']}")
        log("[circuit] (b) faithfulness.csv: " + "; ".join(
            f"{r['variant']} F {r['faithfulness']:.4g} (m_C {r['m_C']:.6g}, m_empty "
            f"{r['m_empty']:.6g}, m_M {r['m_M']:.6g})" for r in rows) +
        f"; faithfulness.png decoded at the JAX figure's size {FIG_SIZES['faithfulness']}")

        # (c) one batch's node IE: the card's f32 and the CPU's f32 against the
        # CPU's f64, on the same weights and images
        eng = ie.build_engine(node_pipe)
        avg_dev = ie.load_averages(os.path.join(ie_dir, "averages.npz"), DEVICE)
        b = next(node_pipe.train_ds.batches(NODE_CPU_IMAGES, shuffle=False))
        x = torch.from_numpy(b.images)
        y = remap_torch_to_tf_labels(torch.from_numpy(b.labels))
        on_card = eng.compute_node_ie([(x.to(DEVICE), y.to(DEVICE))], avg_dev)
        avg_cpu = ie.load_averages(os.path.join(ie_dir, "averages.npz"), "cpu")
        t0 = time.perf_counter()
        on_cpu = {dt: _cpu_engine(eng, dt).compute_node_ie(
            [(x.to(dt), y)], avg_cpu._replace(**{f: {l: v.to(dt) for l, v in
                                                     getattr(avg_cpu, f).items()}
                                                  for f in ("enc", "err", "out")}))
            for dt in (torch.float32, torch.float64)}
        cpu_s = time.perf_counter() - t0
        worst = {"card": 0.0, "cpu": 0.0}
        for f in ("features", "error", "model_neurons"):
            for l in CIRCUIT_LAYERS:
                ref = getattr(on_cpu[torch.float64], f)[l]
                for who, got in (("card", getattr(on_card, f)[l]),
                                 ("cpu", getattr(on_cpu[torch.float32], f)[l])):
                    worst[who] = max(worst[who], _close(f"circuit: node IE {f}:{l} ({who} f32)", got,
                                                        ref, 0.0, NODE_TOL))
        log(f"[circuit] (c) node IE of {NODE_CPU_IMAGES} images against the CPU's f64 (TF32 "
            f"off): the card's f32 within {worst['card']:.3g} of each array's scale, the "
            f"CPU's f32 within {worst['cpu']:.3g} (bound {NODE_TOL:g}); the CPU took "
            f"{cpu_s:.1f} s for both")
        del on_cpu

        # (d) one pair's edges: chunks of 16 against one chunk of 65
        idx = {l: [int(i) for i in np.argsort(-np.abs(node.features[l].cpu().numpy()))
                   [:TOP_FEATURES]] for l in CIRCUIT_LAYERS}
        eb = next(node_pipe.train_ds.batches(EDGE_BATCH, shuffle=False))
        batch = [(torch.from_numpy(eb.images).to(DEVICE),
                  remap_torch_to_tf_labels(torch.from_numpy(eb.labels)).to(DEVICE))]
        pair = list(CIRCUIT_LAYERS[:2])
        chunked = eng.compute_edge_ie(batch, avg_dev, idx, custom_layers=pair,
                                      cotangent_chunk=COTANGENT_CHUNK)
        whole = eng.compute_edge_ie(batch, avg_dev, idx, custom_layers=pair,
                                    cotangent_chunk=TOP_FEATURES + 1)
        worst = max(_close(f"circuit: edges {l}", chunked[l], whole[l], CHUNK_RTOL,
                           CHUNK_ATOL_FRAC)
                    for l in pair)
        log(f"[circuit] (d) {pair[0]} -> {pair[1]} edges ([{TOP_FEATURES + 1}, "
            f"{TOP_FEATURES + 1}]) in chunks of {COTANGENT_CHUNK} equal one chunk of "
            f"{TOP_FEATURES + 1}: max error {worst:.3g} of the scale")

        # (e) the faithfulness anchors
        data = [(torch.from_numpy(bb.images).to(DEVICE),
                 remap_torch_to_tf_labels(torch.from_numpy(bb.labels)).to(DEVICE))
                for bb in node_pipe.train_ds.batches(CIRCUIT_BATCH, shuffle=False)]
        _check_anchors("circuit", "(e)", eng, data, node, avg_dev)
        del eng, node_pipe, data
    fallbacks = [str(w.message) for w in caught
                 if "batching rule" in str(w.message) or "performance drop" in str(w.message)]
    if fallbacks:
        raise AssertionError(f"circuit: vmap fell back to a loop: {fallbacks[:3]}")
    launched = {k.name: k.launches for k in KERNELS if k.launches}
    if launched:
        raise AssertionError(f"circuit: kernels of the port launched: {launched}")
    log(f"[circuit] {smi}: modes 1 / 2 / 3 / 40 in {s1:.2f} / {s2:.2f} / {s3:.2f} / {s4:.2f} s "
        f"= {n / s1:.1f} / {n / s2:.1f} / {n / s3:.1f} / {n / s4:.1f} images/s (node IE, "
        f"mode 2, is the compute_ie images/s; its first run {s2_cold:.2f} s); edge pass "
        f"peak {peak / 2**30:.2f} GiB; no vmap fallback; no kernel launched")
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(WORK, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 10: multilayer training, transcoder circuits, MIS
# ---------------------------------------------------------------------------

# the padded ops at the registry's widths that are no multiple of 128 (mixed4d's
# SAE and the mixed4d -> mixed4e transcoder, 2,112 latents) and at mixed5b's
# 4,096 (no padding), T = PAD_T tokens: (C, H) and (C_in, C_out, H)
PAD_T = 8192
PAD_SAE = ((528, 2112), (1024, 4096))
PAD_TC = ((528, 832, 2112),)
ML_SIZE = (229, 229, 3)
# 512 train images (two dump batches of the registry's 256) and T = 3,072
# tokens a step: mixed5a/5b's 49 tokens an image give 25,088 tokens, one full
# stack of CACHE_SCAN_K = 8 steps (and a 512-token tail that makes no step);
# mixed4b-4e 32 steps, mixed3a/3b 130
ML_IMAGES, ML_VAL, ML_T = 512, 64, 3072
ML_SEED = CIRCUIT_SEED
TC_CHAIN = (("mixed4b", "mixed4c"), ("mixed4c", "mixed4d"), ("mixed4d", "mixed4e"))
TC_EDGE_IMAGES, TC_EDGE_BATCH = 128, 32
TC_CHECK_IMAGES = 4  # the images whose edges the CPU's f64 formula checks
TC_EDGE_TOL = (1e-4, 1e-5)  # rtol, atol of the matrix's largest entry (card f32 vs f64)
TC_MAX_FLIPS = 16  # downstream gates that f32 and f64 may set apart, left out of the check
MLP_ANCHOR_TOL = 1e-5  # faithfulness 1 of exact transcoders on the tiny MLP


def _padded_op_check(cd, tag: str, kind: str, dims: tuple) -> None:
    """The sae_mlp or transcoder op (``kind``) at ``dims`` on _exact_inputs'
    grid: loss terms, statistics and gradients of the op (padded to a multiple
    of 128 latents inside its autograd function) against the plain versions at
    the true H on the same card tensors; in bf16 a second call bitwise equal;
    and the entry points at H_pad leave every padded latent's activity, Σpost
    and gradients exactly zero."""
    gen = torch.Generator(device=DEVICE).manual_seed(sum(dims))
    if kind == "sae":
        c, h = dims
        c_out = c
        w = torch.randn(c, h, device=DEVICE, generator=gen) / c ** 0.5
        x, we, bd = _exact_inputs(gen, PAD_T, w)
        wd = _dyadic(torch.randn(h, c, device=DEVICE, generator=gen) / h ** 0.5, 2.0 ** -8)
        be, y, mod = _odd_grid(gen, h, 100), x, fused_sae
    else:
        c, c_out, h = dims
        x, we, be, wd, bd = _coder_operands(gen, PAD_T, c, c_out, h, torch.float32)
        y, mod = torch.randn(PAD_T, c_out, device=DEVICE, generator=gen), fused_transcoder
    params = {"W_enc": we, "b_enc": be, "W_dec": wd, "b_dec": bd}
    hp = fused_sae.padded_h(h)
    label = f"{kind} op, T={PAD_T} C={c}{'' if kind == 'sae' else f'->{c_out}'} H={h}" + (
        f" (padded to {hp})" if hp != h else "")

    def op():
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        if kind == "sae":
            out = fused_sae.fused_sae_loss_terms(p, x, LAMBDA, 4, compute_dtype=cd)
        else:
            out = fused_transcoder.fused_transcoder_loss_terms(p, x, y, LAMBDA, 4,
                                                               compute_dtype=cd)
        return out, torch.autograd.grad(out["loss"], list(p.values()))

    before = {k.name: k.launches for k in mod.KERNELS}
    out, grads = op()
    torch.cuda.synchronize()
    if {k.name: k.launches - before[k.name] for k in mod.KERNELS[:2]} != {
            k.name: 1 for k in mod.KERNELS[:2]}:
        raise AssertionError(f"multilayer: the {label} did not launch its two kernels once each")
    log(f"[multilayer] (a) {label} [{tag}] vs the plain versions at the true H")
    xc, wec, wdc = x.to(cd), we.to(cd), wd.to(cd)
    if kind == "sae":
        recon, act, _, l1 = fused_sae.fused_sae_forward_plain(xc, wec, be, wdc, bd)
        c_rec = 2.0 / (PAD_T * c)
    else:
        recon, act, _, l1 = fused_transcoder.fused_transcoder_forward_plain(xc, wec, be, wdc, bd)
        c_rec = 2.0 / (PAD_T * c_out)
    _check("recon", out["decoded"], recon, 1e-4, 1e-5)
    # the exact grid: the same latents switch on, so the counts agree exactly
    _check("act_count", out["activity_freq"] * PAD_T, act, 0.0, 0.0)
    _check("l1_loss", out["l1_loss"], l1 / (PAD_T * h), 1e-5, 0.0)
    # the backward on the op's own saved error
    err = (out["decoded"] - y).to(cd)
    coeffs = torch.tensor([c_rec, LAMBDA / (PAD_T * h)], device=DEVICE)
    if kind == "sae":
        g_p = fused_sae.fused_sae_backward_plain(xc, wec, be, wdc, bd, err, coeffs)
    else:
        g_p = fused_transcoder.fused_transcoder_backward_plain(xc, wec, be, wdc, err, coeffs)
    for n, g, ref, p in zip(("dW_enc", "db_enc", "dW_dec", "db_dec"), grads, g_p,
                            params.values()):
        if g.shape != p.shape:
            raise AssertionError(f"multilayer: {label}: {n} is {tuple(g.shape)}, not "
                                 f"{tuple(p.shape)}")
        _check(n, g, ref, 1e-3, 1e-4)
    if cd == torch.bfloat16:
        out2, grads2 = op()
        _repeatable(f"{label} op", [out["decoded"], out["activity_freq"], *grads],
                    [out2["decoded"], out2["activity_freq"], *grads2])
    wep, bep, wdp = fused_sae.padded_operands(we, be, wd, cd)
    if kind == "sae":
        x_cent, _, act_part, _, zsum_part = fused_sae.fwd_kernel(xc, wep, bep, wdp, bd)
        pad = [act_part[:, h:], zsum_part[:, h:]]
        g_pad = fused_sae.bwd_kernel(x_cent, wep, bep, wdp, err, coeffs)
    else:
        _, act_p, _, zsum_p = fused_transcoder.coder_forward_launch(
            fused_transcoder.fwd_kernel, xc, wep, bep, wdp, bd)
        pad = [act_p[h:], zsum_p[h:]]
        g_pad = fused_transcoder.bwd_kernel(xc, wep, bep, wdp, err, coeffs)
    pad += [g_pad[0][:, h:], g_pad[1][h:], g_pad[2][h:]]
    if any(bool(t.any()) for t in pad):
        raise AssertionError(f"multilayer: {label}: a padded latent is not exactly zero")
    log(f"[multilayer]   {label}: the {hp - h} padded latents' activity, Σpost and "
        "gradients exactly zero at the entry points")


@contextlib.contextmanager
def _counted_runs():
    """Every Pipeline.run inside: the launch counts set to 0 just before it and
    read just after, with its steps and training timing; yields the records."""
    records = []
    run = Pipeline.run

    def counted(self):
        for k in KERNELS:
            k.launches = 0
        out = run(self)
        records.append({"cfg": self.cfg, "out": out, "steps": self.ts.step,
                        "timing": list(self.train_timing),
                        "launches": {k.name: k.launches for k in KERNELS if k.launches}})
        return out

    Pipeline.run = counted
    try:
        yield records
    finally:
        Pipeline.run = run


@contextlib.contextmanager
def _counted_dumps():
    """The layer lists of every dump_activations_multi call inside; a
    single-layer dump_activations raises."""
    from sparse_vision_tpu_torch.data import activation_cache

    calls = []
    multi, single = activation_cache.dump_activations_multi, activation_cache.dump_activations

    def counted(net, params, state, dataset, layers, *args, **kwargs):
        calls.append(list(layers))
        return multi(net, params, state, dataset, layers, *args, **kwargs)

    def refused(*args, **kwargs):
        raise AssertionError("multilayer: a layer cache was dumped on its own")

    activation_cache.dump_activations_multi, activation_cache.dump_activations = counted, refused
    try:
        yield calls
    finally:
        activation_cache.dump_activations_multi, activation_cache.dump_activations = multi, single


def _check_trained(what: str, records: list, dumps: list, layers: list, mod) -> None:
    """One dump of every layer; each run's two ``mod`` kernels launched once a
    train step and nothing else launched; finite eval means; prints tokens/s."""
    if dumps != [layers]:
        raise AssertionError(f"multilayer: {what}: dumps {dumps}, not one of {layers}")
    want = {k.name for k in mod.KERNELS[:2]}
    for r in records:
        cfg, steps = r["cfg"], r["steps"]
        name = cfg.sae_layer + (f"->{cfg.transcoder_target_layer}"
                                if cfg.transcoder_target_layer else "")
        if steps <= 0 or r["launches"] != {k: steps for k in want}:
            raise AssertionError(f"multilayer: {what} {name}: launches {r['launches']} for "
                                 f"{steps} steps")
        if not all(math.isfinite(v) for v in r["out"].values()):
            raise AssertionError(f"multilayer: {what} {name}: eval means {r['out']}")
        tm = r["timing"][0]
        log(f"[multilayer] {what} {name}: expansion {r['cfg'].sae_expansion_factor}, {steps} "
            f"steps, {tm['tokens']} tokens in {tm['seconds']:.3f} s = "
            f"{tm['tokens'] / tm['seconds']:.0f} tokens/s; launches {r['launches']}; "
            f"sae_rec_loss {r['out']['sae_rec_loss']:.5g}, var_expl {r['out']['var_expl']:.4g}, "
            f"perc_dead_units {r['out']['perc_dead_units']:.4g}")


def _mlp_anchor() -> None:
    """chain_faithfulness's anchors on the card: on a small MLP, transcoders
    that are its own segments (W_enc = I keeps the ReLU, W_dec = the next
    linear layer) give faithfulness 1 with every latent kept and exactly 0
    with none."""
    from sparse_vision_tpu_torch.interp.transcoder_circuit import chain_faithfulness
    from sparse_vision_tpu_torch.models import layers as tl
    from sparse_vision_tpu_torch.ops.losses import cross_entropy

    net = tl.SeqNet([tl.linear("fc1", 10), tl.relu("relu1"), tl.linear("fc2", 8),
                     tl.relu("relu2"), tl.linear("fc3", 6), tl.relu("relu3"),
                     tl.linear("fc4", 4)])
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    params, state = net.init(gen, (12,))
    tcs = [{"W_enc": torch.eye(n, device=DEVICE), "b_enc": torch.zeros(n, device=DEVICE),
            "W_dec": params[nxt]["w"].T.contiguous(), "b_dec": params[nxt]["b"]}
           for n, nxt in ((10, "fc2"), (8, "fc3"))]
    batches = [SimpleNamespace(images=torch.randn(8, 12, device=DEVICE, generator=gen),
                               labels=torch.randint(0, 4, (8,), device=DEVICE, generator=gen))
               for _ in range(2)]
    chain = [("fc1", "fc2"), ("fc2", "fc3")]
    full = chain_faithfulness(net, params, state, chain, tcs, [torch.ones(10), torch.ones(8)],
                              batches, cross_entropy)
    empty = chain_faithfulness(net, params, state, chain, tcs,
                               [torch.zeros(10), torch.zeros(8)], batches, cross_entropy)
    log(f"[multilayer] (d) MLP anchors: faithfulness {full['faithfulness']!r} with every "
        f"latent kept (want 1 within {MLP_ANCHOR_TOL:g}), {empty['faithfulness']!r} with "
        "none (want exactly 0)")
    if not abs(full["faithfulness"] - 1.0) <= MLP_ANCHOR_TOL or empty["faithfulness"] != 0.0:
        raise AssertionError("multilayer: the chain_faithfulness anchors do not hold")


def _edges_f64(net, params, state, params_list, images):
    """The chain's edge formula in float64 on the CPU, from the card's taps:
    (edges, downstream gates of each pair but the first)."""
    with torch.no_grad():
        _, taps, _ = net.apply(params, images, state=state, stop_at=TC_CHAIN[-1][0])
    zs = []
    for (a, _), p in zip(TC_CHAIN, params_list):
        tok = taps[a].double().cpu().reshape(-1, p["W_enc"].shape[0])
        zs.append(torch.relu(tok @ p["W_enc"].double().cpu() + p["b_enc"].double().cpu()))
    edges = []
    for k in range(len(TC_CHAIN) - 1):
        conn = params_list[k]["W_dec"].double().cpu() @ params_list[k + 1]["W_enc"].double().cpu()
        edges.append(conn * (zs[k].T @ (zs[k + 1] > 0).double()) / zs[0].shape[0])
    return edges, [z > 0 for z in zs[1:]]


def phase_multilayer(smi: str) -> dict:
    """ROADMAP A8's second half on the card. (a) The padded fused ops (kernels
    at a multiple of 128 latents, parameters at the registry's H) against the
    plain versions at the true H, f32 and bf16, bf16 bitwise repeatable; (b)
    train_saes_multilayer over the eight CIRCUIT_LAYERS at their registry
    hyperparameters from one dump, each layer's two fused kernels launched
    once a step (mixed4d through the padded op), tokens/s per layer; (c)
    train_transcoders_multilayer over the five same-geometry pairs the same
    way; (d) load_pair_params, the longest chain's edges at batch 32
    (transcoder_circuit_edges_images_per_sec), held on a few images against
    the f64 formula, the chain_faithfulness anchors and finite loss-node
    edges; (e) mis "1" and "2" on the trained mixed3a; (f) the eight SAEs from
    their exports through the CircuitEngine: finite node IE, faithfulness 1
    at threshold -1. Returns the launches of each kernel in (b) and (c)."""
    import numpy as np

    from sparse_vision_tpu_torch.data.labels import remap_torch_to_tf_labels
    from sparse_vision_tpu_torch.interp import transcoder_circuit as tc
    from sparse_vision_tpu_torch.interp.circuit import CircuitEngine, FrozenSAE
    from sparse_vision_tpu_torch.interp.registry import CIRCUIT_LAYERS
    from sparse_vision_tpu_torch.ops.losses import cross_entropy
    from sparse_vision_tpu_torch.train import multilayer
    from sparse_vision_tpu_torch.train.sae_io import load_sae_weights
    from sparse_vision_tpu_torch.utils.paths import folder_paths

    set_tf32(False)
    shutil.rmtree(WORK, ignore_errors=True)
    t_phase = time.perf_counter()
    for cd, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for dims in PAD_SAE:
            _padded_op_check(cd, tag, "sae", dims)
        for dims in PAD_TC:
            _padded_op_check(cd, tag, "transcoder", dims)
        torch.cuda.empty_cache()

    net, params, state = _scaled_googlenet(ML_SEED)
    train = make_synthetic(num_samples=ML_IMAGES, seed=ML_SEED, img_size=ML_SIZE,
                           num_classes=1000)
    val = make_synthetic(num_samples=ML_VAL, seed=ML_SEED + 1, img_size=ML_SIZE,
                         num_classes=1000)
    train.labels = _image_dependent_labels(net, params, state, train.images)
    val.labels = _image_dependent_labels(net, params, state, val.images)
    kwargs = dict(device=DEVICE, datasets=(train, val, train.category_names, ML_SIZE),
                  backbone=(params, state))
    base = RunConfig(model_name="inceptionv1", dataset_name="imagenet", sae_layer="mixed3a",
                     sae_epochs=1, use_activation_cache=True, cache_tokens_per_step=ML_T,
                     cache_dtype="bfloat16", compute_dtype="bfloat16", eval_batch_size=32,
                     seed=ML_SEED, directory_path=str(WORK / "multilayer"))
    layers = list(CIRCUIT_LAYERS)
    launches: dict = {}

    # (b) eight SAEs from one backbone pass
    _sync()
    t0 = time.perf_counter()
    with _counted_runs() as runs, _counted_dumps() as dumps:
        sae_means = multilayer.train_saes_multilayer(base, **kwargs)
    _sync()
    sae_s = time.perf_counter() - t0
    if list(sae_means) != layers:
        raise AssertionError(f"multilayer: trained {list(sae_means)}")
    _check_trained("(b) SAE", runs, dumps, layers, fused_sae)
    for r in runs:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    log(f"[multilayer] (b) {len(layers)} SAEs from one dump of {ML_IMAGES} images at "
        f"{ML_SIZE[0]} px in {sae_s:.2f} s (dump, {2 * len(layers)} evals, training)")

    # (c) five transcoders from one backbone pass
    pairs = multilayer.transcoder_pairs(net, "imagenet")
    t0 = time.perf_counter()
    with _counted_runs() as runs, _counted_dumps() as dumps:
        tc_means = multilayer.train_transcoders_multilayer(base, **kwargs)
    _sync()
    tc_s = time.perf_counter() - t0
    if list(tc_means) != pairs or len(pairs) != 5:
        raise AssertionError(f"multilayer: transcoders {list(tc_means)}, pairs {pairs}")
    _check_trained("(c) transcoder", runs, dumps, list(dict.fromkeys(
        l for p in pairs for l in p)), fused_transcoder)
    for r in runs:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    log(f"[multilayer] (c) {len(pairs)} transcoders from one dump in {tc_s:.2f} s")
    for k in KERNELS:
        k.launches = 0

    # (d) transcoder circuits on the longest chain
    params_list = tc.load_pair_params(base, list(TC_CHAIN), **kwargs)
    n = TC_EDGE_IMAGES
    batches = [torch.from_numpy(train.images[i:i + TC_EDGE_BATCH]).to(DEVICE)
               for i in range(0, n, TC_EDGE_BATCH)]
    seconds = []
    for _ in range(2):  # the first run pays the pass's one-time costs
        _sync()
        t0 = time.perf_counter()
        edges = tc.compute_transcoder_edges(net, params, state, list(TC_CHAIN), params_list,
                                            batches)
        seconds.append(time.perf_counter() - t0)
    shapes = [e.shape for e in edges]
    if shapes != [(2048, 2048), (2048, 2112)] or not all(np.isfinite(e).all() for e in edges):
        raise AssertionError(f"multilayer: chain edges {shapes}")
    rate = n / seconds[1]
    log(f"[multilayer] (d) chain {' -> '.join([TC_CHAIN[0][0]] + [b for _, b in TC_CHAIN])}: "
        f"edges {shapes} over {n} images at batch {TC_EDGE_BATCH} in {seconds[1]:.3f} s "
        f"(first run {seconds[0]:.3f} s): transcoder_circuit_edges_images_per_sec "
        f"{rate:.1f}")
    few = torch.from_numpy(train.images[:TC_CHECK_IMAGES]).to(DEVICE)
    got = tc.compute_transcoder_edges(net, params, state, list(TC_CHAIN), params_list, [few])
    want, gates = _edges_f64(net, params, state, params_list, few)
    with torch.no_grad():
        _, taps, _ = net.apply(params, few, state=state, stop_at=TC_CHAIN[-1][0])
    flips = 0
    for k, (g, w) in enumerate(zip(got, want)):
        a, p = TC_CHAIN[k + 1][0], params_list[k + 1]
        tok = taps[a].reshape(-1, p["W_enc"].shape[0])
        f32_gate = (torch.relu(tok @ p["W_enc"] + p["b_enc"]) > 0).cpu()
        flipped = (f32_gate != gates[k]).any(0)
        flips += int(flipped.sum())
        keep = ~flipped
        worst = _close(f"multilayer: chain edges {k}", torch.from_numpy(g)[:, keep], w[:, keep],
                       *TC_EDGE_TOL)
        log(f"[multilayer] (d) edges {k} on {TC_CHECK_IMAGES} images: the card's f32 within "
            f"{worst:.3g} of the f64 formula's scale; {int(flipped.sum())} gate column(s) "
            "set apart by f32 and f64 left out")
    if flips > TC_MAX_FLIPS:
        raise AssertionError(f"multilayer: {flips} downstream gates differ between f32 and f64")
    _mlp_anchor()
    data = [SimpleNamespace(images=torch.from_numpy(train.images[i:i + TC_EDGE_BATCH]).to(DEVICE),
                            labels=remap_torch_to_tf_labels(torch.from_numpy(
                                train.labels[i:i + TC_EDGE_BATCH])).to(DEVICE))
            for i in range(0, 2 * TC_EDGE_BATCH, TC_EDGE_BATCH)]
    node = tc.loss_node_edges(net, params, state, TC_CHAIN[-1], params_list[-1], data,
                              cross_entropy)
    hs = [p["W_enc"].shape[1] for p in params_list]
    empty = tc.chain_faithfulness(net, params, state, list(TC_CHAIN), params_list,
                                  [torch.zeros(h) for h in hs], data, cross_entropy)
    full = tc.chain_faithfulness(net, params, state, list(TC_CHAIN), params_list,
                                 [torch.ones(h) for h in hs], data, cross_entropy)
    if not np.isfinite(node).all() or node.shape != (hs[-1],):
        raise AssertionError(f"multilayer: loss-node edges {node.shape} not finite")
    if empty["m_C"] != empty["m_empty"] or empty["faithfulness"] != 0.0 \
            or not math.isfinite(full["faithfulness"]):
        raise AssertionError(f"multilayer: chain faithfulness {empty}, {full}")
    log(f"[multilayer] (d) loss-node edges of {TC_CHAIN[-1]} [{hs[-1]}] finite (max |e| "
        f"{float(np.abs(node).max()):.4g}); chain faithfulness with every latent kept "
        f"{full['faithfulness']!r} (m_C {full['m_C']:.6g}, m_empty {full['m_empty']:.6g}, "
        f"m_M {full['m_M']:.6g}), with none exactly 0")
    if any(k.launches for k in KERNELS):
        raise AssertionError("multilayer: the circuit passes launched a kernel of the port")

    # (e) MIS on the trained mixed3a
    mis_seconds = {}
    for mode in ("1", "2"):
        cfg = dataclasses.replace(multilayer.layer_config(base, "mixed3a"), training=False,
                                  mis=mode, sae_checkpoint_epoch=1)
        pipe = Pipeline(cfg, **kwargs)
        _sync()
        t0 = time.perf_counter()
        out = pipe.run()
        _sync()
        mis_seconds[mode] = time.perf_counter() - t0
    mis_csv = os.path.join(pipe.paths["evaluation_results"], "MIS",
                           f"{pipe.run_id}_mis_epoch_1.csv")
    with open(mis_csv) as f:
        rows = list(csv.DictReader(f))
    h3a = pipe.num_units
    if len(rows) != h3a or [int(r["unit_idx"]) for r in rows] != list(range(h3a)) \
            or not math.isfinite(out["median_mis"]):
        raise AssertionError(f"multilayer: MIS CSV of {len(rows)} rows, median "
                             f"{out['median_mis']}")
    log(f"[multilayer] (e) MIS on mixed3a ({h3a} units, {ML_IMAGES} train images): mis 1 "
        f"(the 200-sample collection epoch) {mis_seconds['1']:.2f} s, mis 2 (embed + score) "
        f"{mis_seconds['2']:.2f} s; median_mis {out['median_mis']:.4g}, average "
        f"{out['average_mis']:.4g}; {len(rows)} CSV rows")

    # (f) the eight trained SAEs, from their exports, through the CircuitEngine
    saes = {}
    for layer in layers:
        cfg = multilayer.layer_config(base, layer)
        path = os.path.join(folder_paths(cfg)["sae_weights"],
                            f"{sae_run_name(cfg)}_model_weights.npz")
        p = {k: v.to(DEVICE) for k, v in load_sae_weights(path, "sae_mlp").items()}
        saes[layer] = FrozenSAE("sae_mlp", p, cfg.sae_expansion_factor)
    eng = CircuitEngine(net, params, saes, cross_entropy, state=state)
    pairs_data = [(b.images, b.labels) for b in data]
    _sync()
    t0 = time.perf_counter()
    avgs = eng.compute_averages(pairs_data)
    node_ie = eng.compute_node_ie(pairs_data, avgs)
    keep = eng.compute_faithfulness(pairs_data, node_ie, -1.0, averages=avgs)
    _sync()
    eng_s = time.perf_counter() - t0
    if not all(bool(torch.isfinite(v).all()) for f in (node_ie.features, node_ie.error)
               for v in f.values()):
        raise AssertionError("multilayer: node IE of the trained SAEs is not finite")
    tol = _faith_tol(keep)
    log(f"[multilayer] (f) trained SAEs from their exports: node IE finite; faithfulness at "
        f"threshold -1 {keep['faithfulness']!r} (want 1 within "
        f"{tol:.3g}; m_M - m_empty {keep['m_M'] - keep['m_empty']:.6g}); "
        f"{2 * TC_EDGE_BATCH} images in {eng_s:.2f} s")
    if not tol < FAITH_RESOLVE or not abs(keep["faithfulness"] - 1.0) <= tol:
        raise AssertionError(f"multilayer: faithfulness at -1 is {keep['faithfulness']} "
                             f"(tolerance {tol:.3g})")
    log(f"[multilayer] {smi}: phase {time.perf_counter() - t_phase:.1f} s; SAEs {sae_s:.2f} s, "
        f"transcoders {tc_s:.2f} s, edges {rate:.1f} images/s, MIS {mis_seconds['1']:.2f} + "
        f"{mis_seconds['2']:.2f} s")
    del eng, saes, params_list
    torch.cuda.empty_cache()
    shutil.rmtree(WORK, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# topk phase: the TopK family's fast paths and slices, the uncached path
# ---------------------------------------------------------------------------

TK_T, TK_H, TK_K = 8192, 4096, 32  # (a): the fast paths against the stock math, at C
TK_AUX_K, TK_ALPHA = 512, 1 / 32  # AuxK's k_aux and weight (the paper's 1/32)
# (a) f32, TF32 off: the fast and stock paths sum in other orders (a gather and
# a dense product); values and gradients within this share of their largest entry
TK_TOL = 1e-5
KTH_T, KTH_H = 32768, 16384  # kth_largest at the north-star batch: n = T * 32
# (b) phase 6's north-star slice with the TopK family's fields: 12 steps
TOPK_FIELDS = dict(sae_topk=TK_K, sae_aux_k=TK_AUX_K, sae_lambda_sparse=0.0)
TK_STEPS = 12
UNCACHED_IMAGES, UNCACHED_VAL, UNCACHED_BATCH = 256, 64, 32
# (c) sae_conv's expansion: 4 (1,024 channels). At phase 6's 64 its two 3x3
# convolutions would be 256 -> 16,384 -> 256 channels, ~45 TFLOP a step of 32
# images: a heavy run for a smoke phase, where 4 drives the same code
UNCACHED = {"sae_mlp": 64, "sae_conv": 4}
UNCACHED_SEED = 3
# (c) the step's f32 full metrics against their f64 recomputation: within
# UNCACHED_TOL of max(1, |value|), and perc_same within one image of the batch
UNCACHED_TOL = 1e-4
GATHER_REPEATS, GATHER_LATENTS = 3, 64  # (a) GatherDecode's dW_dec, heavy duplicates


def _topk_operands(gen, t: int, h: int):
    """A topk_sae / batch_topk_sae parameter set at C, h latents (biases drawn
    away from 0) and t normal tokens, f32 on the card."""
    p = init_sae_mlp(gen, C, h // C)
    p["b_enc"] = 0.1 * torch.randn(h, device=DEVICE, generator=gen)
    p["b_dec"] = 0.1 * torch.randn(C, device=DEVICE, generator=gen)
    p["threshold"] = torch.zeros((), device=DEVICE)
    return p, torch.randn(t, C, device=DEVICE, generator=gen)


def _loss_and_grads(fn, params: dict, x, dead):
    """(terms, grads) of ``fn(params, x)`` with AuxK at weight TK_ALPHA on the
    given dead mask, as the train step forms them."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    out = fn(p, x)
    out["aux_loss"] = topk_aux_loss(p, x, x - out["decoded"], dead, TK_AUX_K)
    total = out["loss"] + TK_ALPHA * out["aux_loss"]
    grads = torch.autograd.grad(total, list(p.values()), allow_unused=True)
    return out, {k: g for k, g in zip(p, grads) if g is not None}


def _fast_vs_stock(name: str, fast_fn, stock_fn, params, x, dead) -> dict:
    fast, fg = _loss_and_grads(fast_fn, params, x, dead)
    stock, sg = _loss_and_grads(stock_fn, params, x, dead)
    errs = {}
    for key in ("loss", "rec_loss", "l1_loss", "aux_loss", "decoded"):
        errs[key] = _close_frac(f"topk (a) {name} {key}", fast[key], stock[key])
    if set(fg) != set(sg):
        raise AssertionError(f"topk (a) {name}: gradients of {sorted(fg)} vs {sorted(sg)}")
    for key in fg:
        errs[f"d{key}"] = _close_frac(f"topk (a) {name} d{key}", fg[key], sg[key])
    if not float(fast["aux_loss"].detach()) > 0:
        raise AssertionError(f"topk (a) {name}: AuxK is 0 with dead latents")
    ms = {label: time_ms(lambda f=f: _loss_and_grads(f, params, x, dead), 3)
          for label, f in (("fast", fast_fn), ("stock", stock_fn))}
    log(f"[topk] (a) {name} fast path vs stock at T {x.shape[0]}, C {C}, H "
        f"{params['b_enc'].shape[0]}, k {TK_K}, AuxK {TK_AUX_K}: largest error / largest "
        f"entry {max(errs.values()):.3g} (tolerance {TK_TOL}); loss + AuxK and gradients "
        f"{ms['fast']:.2f} ms vs {ms['stock']:.2f} ms")
    return errs


def _close_frac(what: str, got, want) -> float:
    err = float((got.detach() - want.detach()).abs().max())
    scale = float(want.detach().abs().max())
    frac = err / max(scale, 1e-30)
    if not frac <= TK_TOL:
        raise AssertionError(f"{what}: error {err:.3g} is {frac:.3g} of the largest entry "
                             f"{scale:.3g} (tolerance {TK_TOL})")
    return frac


def _topk_fast_paths() -> dict:
    """(a) The fast paths with AuxK against the stock math, f32 with TF32 off,
    and kth_largest at the north-star batch against a sort."""
    set_tf32(False)
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    params, x = _topk_operands(gen, TK_T, TK_H)
    dead = torch.zeros(TK_H, dtype=torch.bool, device=DEVICE)
    dead[: TK_H // 4] = True
    errs = {}
    topk = {k: v for k, v in params.items() if k != "threshold"}
    errs["topk_sae"] = _fast_vs_stock(
        "topk_sae", lambda p, t: fast_topk_sae_loss_terms(p, t, 0.0, TK_H // C, TK_K),
        lambda p, t: sae_inference_and_loss("topk_sae", p, t, 0.0, topk=TK_K), topk, x, dead)
    errs["batch_topk_sae"] = _fast_vs_stock(
        "batch_topk_sae",
        lambda p, t: fast_batch_topk_sae_loss_terms(p, t, 0.0, TK_H // C, TK_K),
        lambda p, t: sae_inference_and_loss("batch_topk_sae", p, t, 0.0, topk=TK_K),
        params, x, dead)
    del params, x
    _gather_decode_repeats(gen)
    flat = torch.randn(KTH_T * KTH_H, device=DEVICE, generator=gen)
    n = KTH_T * TK_K
    got = kth_largest(flat, n)
    want = torch.sort(flat, descending=True).values[n - 1]
    if int(got.view(torch.int32)) != int(want.view(torch.int32)):
        raise AssertionError(f"topk (a): kth_largest {float(got)!r} is not the sort's "
                             f"{n}-th value {float(want)!r}")
    kth_ms = time_ms(lambda: kth_largest(flat, n), 3)
    sort_ms = time_ms(lambda: torch.sort(flat, descending=True), 1)
    topk_ms = time_ms(lambda: torch.topk(flat, n, sorted=False), 3)
    log(f"[topk] (a) kth_largest over {KTH_T} x {KTH_H} = {flat.numel()} values, n {n}: "
        f"bitwise the sort's value {float(got)!r}; {kth_ms:.2f} ms (bytes bound of one "
        f"read {nbytes(flat) / PEAK_BYTES_PER_S * 1e3:.2f} ms) vs sort {sort_ms:.2f} ms, "
        f"torch.topk on the floats {topk_ms:.2f} ms")
    del flat
    torch.cuda.empty_cache()
    return errs


def _gather_decode_repeats(gen) -> None:
    """GatherDecode's backward at (a)'s shape with every index in
    GATHER_LATENTS latents (4,096 rows a latent to sum): dW_dec and d_act
    bitwise equal over GATHER_REPEATS runs."""
    act = torch.relu(torch.randn(TK_T, TK_K, device=DEVICE, generator=gen))
    idx = torch.randint(0, GATHER_LATENTS, (TK_T, TK_K), device=DEVICE, generator=gen)
    w = torch.randn(TK_H, C, device=DEVICE, generator=gen)
    g = torch.randn(TK_T, C, device=DEVICE, generator=gen)

    def grads():
        a, ww = act.clone().requires_grad_(True), w.clone().requires_grad_(True)
        return torch.autograd.grad(GatherDecode.apply(a, idx, ww), (a, ww), g)

    first = grads()
    for _ in range(GATHER_REPEATS - 1):
        again = grads()
        if not all(torch.equal(x, y) for x, y in zip(first, again)):
            raise AssertionError("topk (a): GatherDecode's backward does not repeat bitwise")
    log(f"[topk] (a) GatherDecode backward at T {TK_T}, k {TK_K}, H {TK_H}, C {C}, every "
        f"index in {GATHER_LATENTS} latents: d_act and dW_dec bitwise equal over "
        f"{GATHER_REPEATS} runs")


def _launched() -> dict:
    return {k.name: k.launches for k in KERNELS if k.launches}


def _topk_slice(name: str, label: str = "", keep: bool = False) -> tuple:
    """(b) One run of ``name`` at phase 6's north-star config with
    TOPK_FIELDS; returns (pipe, EMA thresholds per step (batch_topk), the
    threshold each eval ran at, the cache directory)."""
    set_tf32(False)
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for the backbone convs
    name_log = f"{name}{label}"
    cfg, datasets = _slice_config(name, TOPK_FIELDS)
    pipe = Pipeline(cfg, datasets=datasets)
    emas, eval_thr = [], []
    finish = tsteps._threshold_ema

    def record(old, new, out):
        new = finish(old, new, out)
        emas.append(new["threshold"].detach().clone())
        return new

    evaluate = pipe.eval_modified

    def eval_and_record(*a, **kw):
        if "threshold" in pipe.ts.params:
            eval_thr.append(float(pipe.ts.params["threshold"]))
        return evaluate(*a, **kw)

    pipe.eval_modified = eval_and_record
    tsteps._threshold_ema = record
    for k in KERNELS:
        k.launches = 0
    try:
        t0 = time.perf_counter()
        pipe.train_sae()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tsteps._threshold_ema = finish
    if _launched():
        raise AssertionError(f"topk (b) {name_log}: fused kernels launched: {_launched()}")
    steps = [(s, {k: float(v) for k, v in m.items()}) for s, m in pipe.train_log]
    if len(steps) != TK_STEPS or not all(math.isfinite(v) for _, m in steps for v in m.values()):
        raise AssertionError(f"topk (b) {name_log}: expected {TK_STEPS} finite steps, got "
                             f"{steps}")
    by_step = dict(steps)
    for s, m in steps:
        log(f"[topk] (b) {name_log} step {s}: sae_loss {m['sae_loss']:.6g} rec "
            f"{m['sae_rec_loss']:.6g} aux {m['sae_aux_loss']:.6g} sparsity "
            f"{m['sparsity']:.6g} perc_dead {m['perc_dead']:.6g}")
    # AuxK weighs in at steps whose start is in a window's mature half (step % 4 in
    # 3, 0), where the accumulator the step reads holds dead latents
    mature = [s for s in by_step if (s - 1) % 4 >= 2 and 0 < by_step[s - 1]["perc_dead"] < 1]
    if not mature or not all(by_step[s]["sae_aux_loss"] > 0 for s in mature):
        raise AssertionError(f"topk (b) {name_log}: no non-zero AuxK at a mature step "
                             f"with dead latents ({mature})")
    timing = pipe.train_timing[0]
    log(f"[topk] (b) {name_log}: train_sae (dump, {TK_STEPS} steps, 2 evals) {wall:.1f} s; "
        f"training loop {timing['tokens']} tokens in {timing['seconds']:.3f} s = "
        f"{timing['tokens'] / timing['seconds']:.0f} tokens/s; no fused launch")
    if len(pipe.eval_log) != 2 or not all(
            math.isfinite(v) for _, m in pipe.eval_log for v in m.values()):
        raise AssertionError(f"topk (b) {name_log}: expected 2 finite evals")
    log(f"[topk] (b) {name_log} last eval: " + json.dumps(pipe.eval_log[-1][1], sort_keys=True))
    return pipe, emas, eval_thr, pipe._cache_dir(cfg.sae_layer)


def _topk_codes(pipe) -> int:
    """The most latents any token of 8 validation images keeps in the code the
    eval reads (training=False)."""
    images = torch.from_numpy(pipe.val_ds.images[:8]).to(DEVICE)
    with torch.no_grad():
        _, taps, _ = pipe.net.apply(pipe.frozen_params, images, state=pipe.net_state)
        out = sae_inference_and_loss(pipe.cfg.sae_model_name, pipe.ts.params,
                                     taps[pipe.cfg.sae_layer], 0.0, topk=TK_K, training=False)
    return int((out["encoded"] != 0).sum(-1).max())


def _recording_step(make, first: dict):
    """``make`` (train/steps.make_sae_train_step) whose step keeps, at its first
    call, the SAE's parameters before the update, the batch and the metrics."""

    def make_recording(*a, **kw):
        step = make(*a, **kw)

        def step_fn(ts, frozen_params, frozen_state, images, labels, resample_draws=None):
            keep = not first
            if keep:
                first.update(params={k: v.detach().clone() for k, v in ts.params.items()},
                             images=images.clone(), labels=labels.clone())
            ts, m = step(ts, frozen_params, frozen_state, images, labels, resample_draws)
            if keep:
                first["metrics"] = {k: float(v) for k, v in m.items()}
            return ts, m

        return step_fn

    return make_recording


def _check_splice(pipe, first: dict) -> dict:
    """The first step's model_loss, kld, perc_same and var_expl recomputed in
    f64 from its images, the SAE's parameters before the update and the
    splice; raises beyond UNCACHED_TOL. Returns the recomputed values."""
    layer, net = pipe.cfg.sae_layer, pipe.net
    with torch.no_grad():
        logits, taps, _ = net.apply(pipe.frozen_params, first["images"], state=pipe.net_state)
        act = taps[layer]
        decoded = sae_inference_and_loss(pipe.cfg.sae_model_name, first["params"], act,
                                         LAMBDA)["decoded"]
        mod = net.apply_segment(pipe.frozen_params, decoded, after=layer,
                                upto=net.stage_names[-1], state=pipe.net_state)
    logits, mod, act, decoded = logits.double(), mod.double(), act.double(), decoded.double()
    logp, logq = torch.log_softmax(logits, 1), torch.log_softmax(mod, 1)
    dims = tuple(range(1, act.ndim - 1)) if act.ndim == 4 else (1,)
    ce = torch.nn.functional.cross_entropy(mod, first["labels"].long())
    want = {"model_loss": float(ce),
            "kld": float((logq.exp() * (logq - logp)).sum(1).mean()),
            "perc_same": float((logits.argmax(1) == mod.argmax(1)).double().mean()),
            "var_expl": float(1 - decoded.var(dims).mean() / act.var(dims).mean())}
    got = first["metrics"]
    for key in ("model_loss", "kld", "var_expl"):
        if not abs(got[key] - want[key]) <= UNCACHED_TOL * max(1.0, abs(want[key])):
            raise AssertionError(f"topk (c) {pipe.cfg.sae_model_name}: step 1 {key} "
                                 f"{got[key]!r}, recomputed {want[key]!r}")
    if not abs(got["perc_same"] - want["perc_same"]) <= 1 / len(first["labels"]):
        raise AssertionError(f"topk (c) {pipe.cfg.sae_model_name}: step 1 perc_same "
                             f"{got['perc_same']!r}, recomputed {want['perc_same']!r}")
    return want


def _uncached_run(name: str, expansion: int) -> None:
    """(c) Pipeline.run without a cache, on the scaled GoogLeNet: the stock SAE
    math at every step, and step 1's spliced metrics held to a plain
    recomputation."""
    import sparse_vision_tpu_torch.train.pipeline as pipeline_mod

    set_tf32(False)
    torch.backends.cudnn.allow_tf32 = True
    size = (229, 229, 3)
    train = make_synthetic(num_samples=UNCACHED_IMAGES, seed=0, img_size=size, num_classes=1000)
    val = make_synthetic(num_samples=UNCACHED_VAL, seed=1, img_size=size, num_classes=1000)
    cfg = RunConfig(model_name="inceptionv1", dataset_name="imagenet", sae_layer="mixed3a",
                    sae_model_name=name, sae_expansion_factor=expansion, sae_lambda_sparse=LAMBDA,
                    sae_optimizer_name="constrained_adam", sae_learning_rate=1e-3,
                    sae_batch_size=UNCACHED_BATCH, use_activation_cache=False, sae_epochs=1,
                    dead_neurons_steps=4, directory_path=str(WORK))
    _, params, state = _scaled_googlenet(UNCACHED_SEED)
    pipe = Pipeline(cfg, device=DEVICE, datasets=(train, val, train.category_names, size),
                    backbone=(params, state))
    del params, state
    first = {}
    make = pipeline_mod.make_sae_train_step
    pipeline_mod.make_sae_train_step = _recording_step(make, first)
    for k in KERNELS:
        k.launches = 0
    try:
        t0 = time.perf_counter()
        pipe.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pipeline_mod.make_sae_train_step = make
    if _launched():
        raise AssertionError(f"topk (c) {name}: fused kernels launched: {_launched()}")
    steps = [(s, {k: float(v) for k, v in m.items()}) for s, m in pipe.train_log]
    want = UNCACHED_IMAGES // UNCACHED_BATCH
    if len(steps) != want or any(len(m) != 14 for _, m in steps) or not all(
            math.isfinite(v) for _, m in steps for v in m.values()):
        raise AssertionError(f"topk (c) {name}: expected {want} steps of 14 finite metrics")
    for s, m in steps:
        log(f"[topk] (c) {name} step {s}: " + json.dumps(m, sort_keys=True))
    if not all(m["kld"] > 0 for _, m in steps):
        raise AssertionError(f"topk (c) {name}: a step's kld is not positive")
    plain = _check_splice(pipe, first)
    log(f"[topk] (c) {name} step 1 against the f64 recomputation (tolerance {UNCACHED_TOL}): "
        + ", ".join(f"{k} {first['metrics'][k]!r} vs {v!r}" for k, v in plain.items()))
    ckpt_dir = pipe._sae_ckpt_dir()
    export = os.path.join(pipe.paths["sae_weights"], f"{sae_run_name(cfg)}_model_weights.npz")
    if len(pipe.eval_log) != 2 or ckpt.latest_epoch(ckpt_dir) != 1 or not os.path.exists(export):
        raise AssertionError(f"topk (c) {name}: expected the evals before and after the "
                             f"epoch, the epoch-1 checkpoint and the export")
    last = pipe.eval_log[-1][1]
    if not all(math.isfinite(v) for v in last.values()):
        raise AssertionError(f"topk (c) {name}: non-finite eval {last}")
    timing = pipe.train_timing[0]
    log(f"[topk] (c) {name} at expansion {expansion} ({pipe.num_units} latents): Pipeline.run "
        f"{wall:.1f} s; training loop {timing['images']} images in {timing['seconds']:.3f} s = "
        f"{timing['images'] / timing['seconds']:.1f} images/s ({timing['tokens']} tokens); "
        f"last eval var_expl {last['var_expl']:.4g}, kld {last['kld']:.4g}; no fused launch")
    del pipe
    torch.cuda.empty_cache()
    shutil.rmtree(WORK, ignore_errors=True)


def phase_topk(smi: str) -> None:
    """Phase 11 (the module docstring)."""
    t_phase = time.perf_counter()
    _topk_fast_paths()
    shutil.rmtree(WORK, ignore_errors=True)
    pipe, _, _, _ = _topk_slice("topk_sae")
    most = _topk_codes(pipe)
    if most > TK_K:
        raise AssertionError(f"topk (b): a token keeps {most} latents in topk_sae's eval code")
    log(f"[topk] (b) topk_sae eval code: at most {most} latents a token (k {TK_K})")
    del pipe
    shutil.rmtree(WORK, ignore_errors=True)
    pipe, emas, eval_thr, cache_dir = _topk_slice("batch_topk_sae")
    emas = [float(t) for t in emas]
    thr = float(pipe.ts.params["threshold"])
    log(f"[topk] (b) batch_topk_sae threshold EMA by step: {emas}; calibrated {thr!r}; the "
        f"evals ran at {eval_thr}")
    if not emas or not emas[0] > 0 or not thr > 0 or eval_thr[-1] != thr or thr == emas[-1]:
        raise AssertionError(f"topk (b): threshold EMA {emas}, calibrated {thr}, evals at "
                             f"{eval_thr}")
    tree = ckpt.load_checkpoint(pipe._sae_ckpt_dir(), 1, like=pipe._ckpt_tree())
    if float(tree["params"]["threshold"]) != thr:
        raise AssertionError("topk (b): the checkpoint does not carry the calibrated threshold")
    first = pipe.ts
    del pipe
    again, _, _, cache_again = _topk_slice("batch_topk_sae", label=" (again)")
    if cache_again != cache_dir:
        raise AssertionError("topk (b): the second run did not read the first run's cache")
    _same_state("topk (b) repeat", first, again.ts)
    log("[topk] (b) batch_topk_sae from the same cache again: params, Adam state, threshold "
        "and dead accumulator bitwise equal")
    del again, first
    torch.cuda.empty_cache()
    shutil.rmtree(WORK, ignore_errors=True)
    for name, expansion in UNCACHED.items():
        _uncached_run(name, expansion)
    log(f"[topk] {smi}: phase {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 12: the backbone families beyond GoogLeNet
# ---------------------------------------------------------------------------

BB_IMAGES = 4  # (a)'s batch
# (a): model name, dataset (its classes), input size where not the dataset's
BB_FORWARD = (("clip_vit_b16", "imagenet", None), ("clip_vit_b16_split", "imagenet", None),
              ("vit_base", "imagenet", None), ("resnet18", "tiny_imagenet", None),
              ("resnet18_1", "tiny_imagenet", (224, 224, 3)),
              ("resnet50", "imagenet", (224, 224, 3)), ("custom_cnn_1", "cifar_10", None),
              ("custom_mlp_2", "mnist", None), ("custom_mlp_9_sae_fc1", "mnist", None))
# the card's f32 (TF32 off) against the CPU's f64: every tap within FWD_TOL of
# its largest magnitude
FWD_TOL = 1e-4
# rows 1-2 at CLIP ViT-B/16's C 768 (8x: 6,144 latents) and ResNet-18 layer4.1's
# C 512 (8x: 4,096), rows 11-12 at 768 -> 768 (block5_attn -> block5_mlp), T 32,768
BB_SAE = ((32768, 768, 6144), (32768, 512, 4096))
BB_TC = (32768, 768, 768, 6144)
# bench_clip_sae.py's tower (224 px: 197 tokens an image, width 768) and
# bench_vit_circuit.py's split one, SAEs and transcoder at expansion 8
CLIP, CLIP_SPLIT, CLIP_DEPTH = "clip_vit_b16", "clip_vit_b16_split", 12
CLIP_SIZE, CLIP_TOKENS, CLIP_DIM, EXPANSION = (224, 224, 3), 197, 768, 8
CLIP_TRAIN, CLIP_IE_IMAGES = 2048, 512  # 8 batches of 256 x 197 tokens: 12 steps of 32,768
RESNET_SIZE, RESNET_TRAIN = (64, 64, 3), 6144  # layer4.1: 8 x 8 = 64 tokens an image
CLIP_SAE_LAYER, CLIP_TC_LAYERS = "block6", ("block5_attn", "block5_mlp")
CLIP_LAYERS = ("block2_attn", "block5_attn", "block8_attn", "block11_attn")
CLIP_BATCH, CLIP_IMAGES, CLIP_EDGE_FEATURES = 16, 64, 64


def _bb_forward() -> None:
    """(a) Each family on the card in f32 (TF32 off) against the same net on the
    CPU in f64, logits and every tap; the split CLIP tower against the fused
    one on the same parameters; GoogLeNet's aux heads."""
    import numpy as np

    from sparse_vision_tpu_torch.models import googlenet
    from sparse_vision_tpu_torch.models.backbone import make_backbone
    from sparse_vision_tpu_torch.models.vit import split_converted_blocks

    set_tf32(False)  # the patch and residual convolutions too (cuDNN's default is TF32)
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    rng = np.random.default_rng(12)
    f64 = torch.float64

    def both(net, params, state, x):
        with torch.no_grad():
            card = net.apply(params, x.to(DEVICE), state=state)
            cpu = net.apply(_tree_to(params, "cpu", f64), x.double(),
                            state=_tree_to(state, "cpu", f64))
        return card, cpu

    clip = None
    for name, ds, size in BB_FORWARD:
        net = make_backbone(name, ds)
        size = size or tuple(net.input_size)
        params, state = net.init(gen, size)
        x = torch.from_numpy(rng.standard_normal((BB_IMAGES, *size)).astype(np.float32))
        t0 = time.perf_counter()
        (out, taps, _), (ref, ref_taps, _) = both(net, params, state, x)
        worst = max(_close(f"backbones: (a) {name} {k}", taps[k], ref_taps[k], 0.0, FWD_TOL)
                    for k in ref_taps)
        worst = max(worst, _close(f"backbones: (a) {name} logits", out, ref, 0.0, FWD_TOL))
        log(f"[backbones] (a) {name} at {size[0]} px, {BB_IMAGES} images: logits "
            f"{tuple(out.shape)} and {len(taps)} taps within {worst:.3g} of the CPU's f64 "
            f"(bound {FWD_TOL:g}; {time.perf_counter() - t0:.1f} s)")
        if name == CLIP:
            clip = (params, x, out, taps)
        if name == CLIP_SPLIT:
            c_params, c_x, c_out, c_taps = clip
            with torch.no_grad():
                s_out, s_taps, _ = net.apply(split_converted_blocks(c_params, CLIP_DEPTH),
                                             c_x.to(DEVICE))
            blocks = range(CLIP_DEPTH)
            worst = max(_close(f"backbones: (a) split block{i}", s_taps[f"block{i}_mlp"],
                               c_taps[f"block{i}"], 0.0, 1e-6) for i in blocks)
            worst = max(worst, _close("backbones: (a) split logits", s_out, c_out, 0.0, 1e-6))
            same = torch.equal(s_out, c_out) and all(
                torch.equal(s_taps[f"block{i}_mlp"], c_taps[f"block{i}"]) for i in blocks)
            log(f"[backbones] (a) {CLIP_SPLIT} on the fused tower's parameters: logits "
                f"and block{{i}}_mlp taps within {worst:.3g} of the fused block{{i}} (bitwise "
                f"equal: {same})")
            clip = None
        del params, state
        torch.cuda.empty_cache()

    net = make_backbone("googlenet", "imagenet")
    size = (224, 224, 3)
    params, state = net.init(gen, size)
    aux_p, aux_s = googlenet.init_googlenet_aux(gen, 1000)
    x = torch.from_numpy(rng.standard_normal((BB_IMAGES, *size)).astype(np.float32))
    (_, taps, _), (_, ref_taps, _) = both(net, params, state, x)
    with torch.no_grad():
        aux = googlenet.apply_googlenet_aux(aux_p, aux_s, taps)
        ref = googlenet.apply_googlenet_aux(_tree_to(aux_p, "cpu", f64),
                                            _tree_to(aux_s, "cpu", f64), ref_taps)
    worst = max(_close(f"backbones: (a) googlenet {k}", aux[k], ref[k], 0.0, FWD_TOL)
                for k in ref)
    log(f"[backbones] (a) GoogLeNet's aux heads at 224 px: {sorted(aux)} "
        f"{tuple(aux['aux1'].shape)} within {worst:.3g} of the CPU's f64")


def _bb_kernels() -> dict:
    """Rows 1-2 at BB_SAE's widths and rows 11-12 at BB_TC against their plain
    versions in f32 and bf16 (TF32 off), bf16 repeats bitwise equal, each timed
    beside its bound and the cuBLAS products; returns the rows by label."""
    set_tf32(False)
    t, c_in, c_out, h = BB_TC

    def tc_coeffs(gen):
        return (torch.tensor([2.0 / (t * c_out), LAMBDA / (t * h)], device=DEVICE),)

    rows = {}
    for cd, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        with torch.no_grad():
            for shape in BB_SAE:
                r = kernels_relu(cd, tag, *shape)
                rows.update({f"{k} {tag} T={shape[0]} C={shape[1]} H={shape[2]}": v
                             for k, v in r.items()})
                torch.cuda.empty_cache()
            r = _kernels_coder(fused_transcoder, f"{tag}, {c_in} -> {c_out}", cd, t, c_in,
                               c_out, h, tc_coeffs)
            rows.update({f"{k} {tag} T={t} C={c_in}->{c_out} H={h}": v for k, v in r.items()})
        torch.cuda.empty_cache()
    log("[backbones] kernels at the backbones' widths: " + json.dumps(rows, sort_keys=True))
    return rows


@contextlib.contextmanager
def _timed_dumps():
    """The seconds of every activation-cache dump inside (the outermost call
    where one dump function calls the other)."""
    from sparse_vision_tpu_torch.data import activation_cache
    from sparse_vision_tpu_torch.train import paired_caches

    seconds, depth = [], [0]
    names = ("dump_activations", "dump_activations_multi")
    saved = [(m, n, getattr(m, n)) for m in (activation_cache, paired_caches) for n in names
             if hasattr(m, n)]

    def timed(fn):
        def run(*args, **kwargs):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                _sync()
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                seconds.append(time.perf_counter() - t0)
            return out
        return run

    for m, n, fn in saved:
        setattr(m, n, timed(fn))
    try:
        yield seconds
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def _bb_slice(label: str, name: str, extra: dict, datasets, keep: bool = False) -> None:
    """One phase_slice run on a backbone of this phase: its launches checked
    there (its two kernels once a step, nothing else), the dump's seconds."""
    with _timed_dumps() as dumps:
        phase_slice(name, extra=extra, label=f" {label}", keep=keep, datasets=datasets)
    if len(dumps) != 1:
        raise AssertionError(f"backbones: {label}: {len(dumps)} dumps")
    n = len(datasets[0])
    log(f"[backbones] {label}: the dump of {n} images took {dumps[0]:.2f} s = "
        f"{n / dumps[0]:.0f} images/s (host clock, ends in a synchronize)")


def _clip_circuits(smi: str) -> None:
    """(e) CircuitEngine over clip_vit_b16_split with four frozen sae_mlp SAEs
    at CLIP_LAYERS: averages and node IE over CLIP_IMAGES, one batch's node IE
    against the CPU's f64, one pair's edge IE at CLIP_EDGE_FEATURES a side, the
    faithfulness anchors; no vmap fallback."""
    import warnings

    import numpy as np

    from sparse_vision_tpu_torch.interp.circuit import CircuitEngine, FrozenSAE
    from sparse_vision_tpu_torch.models.backbone import init_backbone, make_backbone
    from sparse_vision_tpu_torch.ops.losses import cross_entropy

    set_tf32(False)
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    net = make_backbone(CLIP_SPLIT, "imagenet")
    params, state = init_backbone(net, gen, "imagenet")
    saes = {l: FrozenSAE("sae_mlp", init_sae_mlp(gen, CLIP_DIM, EXPANSION), EXPANSION)
            for l in CLIP_LAYERS}
    h = CLIP_DIM * EXPANSION
    eng = CircuitEngine(net, params, saes, cross_entropy, state=state)
    ds = make_synthetic(num_samples=CLIP_IMAGES, img_size=CLIP_SIZE, num_classes=1000, seed=13)
    images = torch.from_numpy(ds.images)
    with torch.no_grad():  # each image's class: the one its logits raise most
        logits = torch.cat([net.apply(params, images[i:i + CLIP_BATCH].to(DEVICE))[0]
                            for i in range(0, CLIP_IMAGES, CLIP_BATCH)])
    labels = (logits - logits.mean(0)).argmax(1)
    data = [(images[i:i + CLIP_BATCH].to(DEVICE), labels[i:i + CLIP_BATCH])
            for i in range(0, CLIP_IMAGES, CLIP_BATCH)]
    log(f"[backbones] (e) {CLIP_IMAGES} images in {len(set(labels.tolist()))} classes")
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _sync()
        t0 = time.perf_counter()
        avgs = eng.compute_averages(data)
        _sync()
        s1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        node = eng.compute_node_ie(data, avgs)
        _sync()
        s2 = time.perf_counter() - t0
        for l in CLIP_LAYERS:
            if tuple(avgs.enc[l].shape) != (CLIP_TOKENS, h) or tuple(node.features[l].shape) != (h,):
                raise AssertionError(f"backbones: (e) {l}: averages {tuple(avgs.enc[l].shape)}, "
                                     f"node IE {tuple(node.features[l].shape)}")
            if not all(bool(torch.isfinite(v).all()) for v in (
                    avgs.enc[l], avgs.err[l], node.features[l], node.error[l],
                    node.model_neurons[l])):
                raise AssertionError(f"backbones: (e) {l}: non-finite averages or node IE")
        log(f"[backbones] (e) averages / node IE at {len(CLIP_LAYERS)} taps over {CLIP_IMAGES} "
            f"images in {s1:.2f} / {s2:.2f} s = {CLIP_IMAGES / s1:.1f} / "
            f"{CLIP_IMAGES / s2:.1f} images/s; max |IE| of a feature "
            + ", ".join(f"{l} {float(node.features[l].abs().max()):.3g}" for l in CLIP_LAYERS))

        # one batch's node IE: the card's f32 against the CPU's f64
        x, y = data[0][0][:NODE_CPU_IMAGES], data[0][1][:NODE_CPU_IMAGES]
        on_card = eng.compute_node_ie([(x, y)], avgs)
        avg64 = avgs._replace(**{f: {l: v.to("cpu", torch.float64) for l, v in
                                      getattr(avgs, f).items()} for f in ("enc", "err", "out")},
                              dead={l: v.cpu() for l, v in avgs.dead.items()})
        t0 = time.perf_counter()
        on_cpu = _cpu_engine(eng, torch.float64).compute_node_ie(
            [(x.to("cpu", torch.float64), y.cpu())], avg64)
        cpu_s = time.perf_counter() - t0
        worst = max(_close(f"backbones: (e) node IE {f}:{l}", getattr(on_card, f)[l],
                           getattr(on_cpu, f)[l], 0.0, NODE_TOL)
                    for f in ("features", "error", "model_neurons") for l in CLIP_LAYERS)
        log(f"[backbones] (e) node IE of {NODE_CPU_IMAGES} images: the card's f32 within "
            f"{worst:.3g} of each array's scale from the CPU's f64 (bound {NODE_TOL:g}; the "
            f"CPU took {cpu_s:.1f} s)")

        # one pair's edges at CLIP_EDGE_FEATURES a side
        pair = list(CLIP_LAYERS[:2])
        idx = {l: [int(i) for i in np.argsort(-np.abs(node.features[l].cpu().numpy()))
                   [:CLIP_EDGE_FEATURES]] for l in pair}
        torch.cuda.reset_peak_memory_stats()
        _sync()
        t0 = time.perf_counter()
        edges = eng.compute_edge_ie(data[:1], avgs, idx, custom_layers=pair,
                                    cotangent_chunk=COTANGENT_CHUNK)
        _sync()
        s3 = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        k1 = CLIP_EDGE_FEATURES + 1
        if tuple(edges[pair[0]].shape) != (k1, k1) or tuple(edges[pair[1]].shape) != (k1, 1) \
                or not all(bool(torch.isfinite(m).all()) for m in edges.values()):
            raise AssertionError(f"backbones: (e) edges {[tuple(m.shape) for m in edges.values()]}")
        log(f"[backbones] (e) {pair[0]} -> {pair[1]} edges [{k1}, {k1}] and to the loss "
            f"[{k1}, 1] over {CLIP_BATCH} images (chunks of {COTANGENT_CHUNK}) in {s3:.2f} s = "
            f"{CLIP_BATCH / s3:.2f} images/s; peak memory {peak / 2**30:.2f} GiB "
            f"(max_memory_allocated); max |edge| {float(edges[pair[0]].abs().max()):.3g}")

        _check_anchors("backbones", "(e)", eng, data, node, avgs)
    fallbacks = [str(w.message) for w in caught
                 if "batching rule" in str(w.message) or "performance drop" in str(w.message)]
    if fallbacks:
        raise AssertionError(f"backbones: (e) vmap fell back to a loop: {fallbacks[:3]}")
    log(f"[backbones] (e) {smi}: no vmap fallback")
    del eng, params, saes, data
    torch.cuda.empty_cache()


def _clip_ie_modes(extra: dict, datasets) -> None:
    """(e) compute_ie "1" then "2" through Pipeline.run on (b)'s trained SAE
    (its epoch-1 checkpoint): interp/ie.py's one-layer engine at CLIP_SAE_LAYER."""
    from sparse_vision_tpu_torch.interp import ie

    cfg, _ = _slice_config("sae_mlp", extra)
    for flag in ("1", "2"):
        for k in KERNELS:
            k.launches = 0
        pipe = Pipeline(dataclasses.replace(cfg, training=False, compute_ie=flag,
                                            sae_checkpoint_epoch=1), datasets=datasets)
        _sync()
        t0 = time.perf_counter()
        out = pipe.run()
        _sync()
        sec = time.perf_counter() - t0
        arrays = out.enc if flag == "1" else out.features
        if list(arrays) != [CLIP_SAE_LAYER] or not all(
                bool(torch.isfinite(v).all()) for v in arrays.values()):
            raise AssertionError(f"backbones: compute_ie {flag}: {list(arrays)}")
        h = CLIP_DIM * EXPANSION
        shape = tuple(arrays[CLIP_SAE_LAYER].shape)
        if shape != ((CLIP_TOKENS, h) if flag == "1" else (h,)):
            raise AssertionError(f"backbones: compute_ie {flag}: block6 at {shape}")
        launched = {k.name: k.launches for k in KERNELS if k.launches}
        if launched:
            raise AssertionError(f"backbones: compute_ie {flag} launched {launched}")
        files = ie.MODE_FILES[flag]
        log(f"[backbones] (e) Pipeline.run compute_ie {flag} on the trained {CLIP_SAE_LAYER} "
            f"SAE over {len(pipe.train_ds)} images in {sec:.2f} s = "
            f"{len(pipe.train_ds) / sec:.1f} images/s; wrote {files}; {shape}")
        del pipe, out
        torch.cuda.empty_cache()


def phase_backbones(smi: str) -> dict:
    """Phase 12 (the module docstring); returns the kernels' rows at its widths."""
    t_phase = time.perf_counter()
    _bb_forward()
    rows = _bb_kernels()
    clip_train = make_synthetic(num_samples=CLIP_TRAIN, seed=0, img_size=CLIP_SIZE,
                                num_classes=1000)
    clip_val = make_synthetic(num_samples=256, seed=1, img_size=CLIP_SIZE, num_classes=1000)
    clip = (clip_train, clip_val, clip_train.category_names, CLIP_SIZE)
    sae = dict(model_name=CLIP, sae_layer=CLIP_SAE_LAYER, sae_expansion_factor=EXPANSION)
    _bb_slice(f"{CLIP} {CLIP_SAE_LAYER} sae_mlp", "sae_mlp", sae, clip, keep=True)
    ie_train = make_synthetic(num_samples=CLIP_IE_IMAGES, seed=2, img_size=CLIP_SIZE,
                              num_classes=1000)
    _clip_ie_modes(sae, (ie_train, clip_val, ie_train.category_names, CLIP_SIZE))
    shutil.rmtree(WORK, ignore_errors=True)
    src, tgt = CLIP_TC_LAYERS
    _bb_slice(f"{CLIP_SPLIT} {src} -> {tgt}", "transcoder",
              dict(model_name=CLIP_SPLIT, sae_layer=src, transcoder_target_layer=tgt,
                   sae_expansion_factor=EXPANSION), clip)
    del clip, clip_train, ie_train
    res_train = make_synthetic(num_samples=RESNET_TRAIN, seed=0, img_size=RESNET_SIZE,
                               num_classes=200)
    res_val = make_synthetic(num_samples=256, seed=1, img_size=RESNET_SIZE, num_classes=200)
    _bb_slice("resnet18 layer4.1 sae_mlp", "sae_mlp",
              dict(model_name="resnet18", dataset_name="tiny_imagenet", sae_layer="layer4.1",
                   sae_expansion_factor=EXPANSION),
              (res_train, res_val, res_train.category_names, RESNET_SIZE))
    del res_train, res_val
    _clip_circuits(smi)
    shutil.rmtree(WORK, ignore_errors=True)
    log(f"[backbones] {smi}: phase {time.perf_counter() - t_phase:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# phase 13: the original model's training and eval, the dataset loaders
# ---------------------------------------------------------------------------

ORIG_WORK = ROOT / "_smoke_original"  # listed in .gitignore; removed at the end
# (a): the reference's own trained backbone, ResNet-18 with the Tiny-ImageNet stem
ORIG = dict(model_name="resnet18", dataset_name="tiny_imagenet", sae_model_name="None",
            sae_layer="layer4.1", original_model=True, model_optimizer_name="sgd_w_scheduler",
            model_learning_rate=0.01, batch_size=256, log_every=10**9)
ORIG_TRAIN, ORIG_VAL, ORIG_SIZE, ORIG_CLASSES = 10240, 1024, (64, 64, 3), 200
ORIG_EPOCHS = 3
# (b): the card's f32 step (TF32 off) against the CPU's f64 on ORIG_STEP_IMAGES
# images: the loss and the running statistics within ORIG_TOL of each array's
# scale; a parameter array within ORIG_TOL, or within F32_NOISE times the
# distance of the CPU's own f32 step from f64 (at a random init this model's
# f32 gradients lie up to a few percent of an update from f64 on any device,
# PERF.md §6)
ORIG_STEP_IMAGES, ORIG_TOL, F32_NOISE = 32, 1e-4, 4.0
SAE_IMAGES = 6144  # (c): 12 steps of 32,768 layer4.1 tokens, 64 an image
MNIST_N, CIFAR_N, LOADER_BATCH = (60000, 10000), (50000, 10000), 64
TAR_IMAGES, TAR_SHARD, TAR_WH = 256, 128, (400, 300)  # (f): 2 train shards of 300 x 400 JPEGs
TINY_PER_CLASS, TINY_BATCH = 8, 100


class _Tee(io.TextIOBase):
    """Writes to stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _orig_cfg(folder, **kw) -> RunConfig:
    return RunConfig(**{**ORIG, "directory_path": str(folder), **kw})


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _tree_diff(a, b) -> float:
    """The largest |a - b| of any leaf over that leaf's largest |b|."""
    def host(t):
        return t.detach().to("cpu", torch.float64)

    return max(float((host(x) - host(_get(b, p))).abs().max()
                     / host(_get(b, p)).abs().max().clamp_min(1e-30))
               for p, x in _leaves(a))


def _tree_equal(a, b) -> bool:
    return all(torch.equal(x, _get(b, p).to(x.device)) for p, x in _leaves(a))


def _epoch_losses(pipe, steps_per_epoch: int) -> list:
    losses = [float(m["model_loss"]) for _, m in pipe.train_log]
    return [sum(losses[i:i + steps_per_epoch]) / steps_per_epoch
            for i in range(0, len(losses), steps_per_epoch)]


def _orig_train(data, smi: str):
    """(a) Pipeline.run trains ResNet-18 two epochs, a fresh Pipeline resumes
    it to three, and an uninterrupted run trains three in a second folder;
    cuDNN deterministic. Returns the uninterrupted Pipeline."""
    dir_a, dir_c = ORIG_WORK / "a", ORIG_WORK / "c"
    steps = ORIG_TRAIN // ORIG["batch_size"]
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        a = Pipeline(_orig_cfg(dir_a, model_epochs=2), datasets=data)
        a.run()
        b = Pipeline(_orig_cfg(dir_a, model_epochs=ORIG_EPOCHS), datasets=data)
        if b._model_ckpt_epoch != 2 or not _tree_equal(b.frozen_params, a.mts.params) \
                or not _tree_equal(b.net_state, a.mts.net_state):
            raise AssertionError("original: (a) the resumed Pipeline did not start from "
                                 "model_weights/epoch_2")
        b.run()
        c = Pipeline(_orig_cfg(dir_c, model_epochs=ORIG_EPOCHS), datasets=data)
        init_state = [(path, t.clone()) for path, t in _leaves(c.net_state)]
        c.run()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    epochs = _epoch_losses(c, steps)
    log(f"[original] (a) {smi}: mean train loss per epoch {[round(v, 5) for v in epochs]}; "
        "evals " + ", ".join(f"{e}: loss {m['model_loss']:.5f} acc {m['accuracy']:.4f}"
                             for e, m in c.eval_log))
    if len(epochs) != ORIG_EPOCHS or not all(x > y for x, y in zip(epochs, epochs[1:])):
        raise AssertionError(f"original: (a) the train loss did not fall each epoch: {epochs}")
    if not c.eval_log[-1][1]["accuracy"] > c.eval_log[0][1]["accuracy"]:
        raise AssertionError("original: (a) val accuracy did not rise")
    moved = sum(not torch.equal(_get(c.net_state, path), t) for path, t in init_state)
    if moved != len(init_state):
        raise AssertionError(f"original: (a) {moved} running statistics moved, not all")
    counts = (a.mts.opt_state.epoch, b.mts.opt_state.epoch, c.mts.opt_state.epoch)
    if counts != (2, ORIG_EPOCHS, ORIG_EPOCHS):
        raise AssertionError(f"original: (a) EpochLRState.epoch {counts}")
    for e in (1, 2):  # both folders ran the same two epochs
        ta = ckpt.load_checkpoint(a.paths["model_weights"], e)
        tc = ckpt.load_checkpoint(c.paths["model_weights"], e)
        if set(ta) != {"params", "net_state"}:
            raise AssertionError(f"original: (a) checkpoint keys {sorted(ta)}")
        if not _tree_equal(ta, tc):
            raise AssertionError(f"original: (a) epoch {e} differs between two runs of one "
                                 f"seed: {_tree_diff(ta, tc):.3g} of an array's scale")
    final = ckpt.load_checkpoint(c.paths["model_weights"], ORIG_EPOCHS)
    if not _tree_equal(final["params"], c.frozen_params):
        raise AssertionError("original: (a) the trained weights are not the frozen backbone")
    log(f"[original] (a) checkpoints epoch_1 and epoch_2 of the two folders bitwise equal "
        f"(cuDNN deterministic); EpochLRState.epoch {counts}; every running statistic "
        f"moved; the resumed epoch 3 against the uninterrupted one: params "
        f"{_tree_diff(b.mts.params, c.mts.params):.3g} of an array's scale apart (the resume "
        "restarts the momentum, as the JAX package: model_weights holds params and net_state)")
    for e, t in enumerate(c.train_timing):
        log(f"[original] (a) {smi}: epoch {e + 1}: {t['steps']} steps of {ORIG['batch_size']} "
            f"images in {t['seconds']:.3f} s = {t['images'] / t['seconds']:.0f} images/s "
            "(host clock, ends in a synchronize; cuDNN deterministic)")
    return c


def _orig_step_vs_cpu(pipe, data) -> None:
    """(b) One train step of (a)'s model on the card in f32, TF32 off, against
    the same step on the CPU in f64 (and in f32, the noise floor)."""
    import numpy as np

    set_tf32(False)
    x = torch.from_numpy(np.ascontiguousarray(data[0].images[:ORIG_STEP_IMAGES]))
    y = torch.from_numpy(data[0].labels[:ORIG_STEP_IMAGES])
    runs = {}
    for tag, device, dtype in (("card", DEVICE, torch.float32), ("cpu64", "cpu", torch.float64),
                               ("cpu32", "cpu", torch.float32)):
        params = _tree_to(pipe.frozen_params, device, dtype)
        state = _tree_to(pipe.net_state, device, dtype)
        tx = optim.get_optimizer(ORIG["model_optimizer_name"], ORIG["model_learning_rate"])
        step = tsteps.make_model_train_step(pipe.net, tx, pipe.criterion)
        t0 = time.perf_counter()
        ts, m = step(tsteps.ModelTrainState(params, state, tx.init(params), 0),
                     x.to(device, dtype), y.to(device))
        _sync()
        runs[tag] = (ts, float(m["model_loss"]), time.perf_counter() - t0)
    (card, loss, _), (ref, ref_loss, cpu_s), (cpu32, _, _) = (runs[k] for k in (
        "card", "cpu64", "cpu32"))
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    state_err = _tree_diff(card.net_state, ref.net_state)
    worst, floor = 0.0, 0.0
    for path, want in _leaves(ref.params):
        scale = float(want.abs().max().clamp_min(1e-30))
        err = float((_get(card.params, path).double().cpu() - want).abs().max()) / scale
        noise = float((_get(cpu32.params, path).double() - want).abs().max()) / scale
        if err > max(ORIG_TOL, F32_NOISE * noise):
            raise AssertionError(f"original: (b) {'/'.join(path)}: the card's step {err:.3g} of "
                                 f"the array's scale from the CPU's f64; the CPU's f32 {noise:.3g}")
        worst, floor = max(worst, err), max(floor, noise)
    if loss_err > ORIG_TOL or state_err > ORIG_TOL:
        raise AssertionError(f"original: (b) loss {loss_err:.3g}, running statistics "
                             f"{state_err:.3g} from the CPU's f64 (bound {ORIG_TOL:g})")
    log(f"[original] (b) one step of {ORIG_STEP_IMAGES} images, TF32 off: the card's f32 loss "
        f"{loss_err:.3g} and running statistics {state_err:.3g} of their scale from the CPU's "
        f"f64 (bound {ORIG_TOL:g}); params {worst:.3g} (the CPU's own f32 step {floor:.3g}; "
        f"bound max({ORIG_TOL:g}, {F32_NOISE:g}x the CPU's f32 per array)); the CPU's f64 "
        f"step took {cpu_s:.1f} s")
    torch.backends.cudnn.allow_tf32 = True


def _orig_chain(trained, data) -> None:
    """(c) A cached sae_mlp run in (a)'s folder at layer4.1 (expansion 8):
    the trained backbone loaded from model_weights, rows 1-2 once a step."""
    train, val, names, size = data
    sae_data = (ArrayDataset(train.images[:SAE_IMAGES], train.labels[:SAE_IMAGES], names),
                ArrayDataset(val.images[:256], val.labels[:256], names), names, size)
    tee = _Tee(sys.stdout)

    def check(pipe):
        if pipe._model_ckpt_epoch != ORIG_EPOCHS or not _tree_equal(
                pipe.frozen_params, trained.frozen_params) or not _tree_equal(
                pipe.net_state, trained.net_state):
            raise AssertionError("original: (c) the SAE run's backbone is not the trained one")

    with contextlib.redirect_stdout(tee):
        launches, _, _ = phase_slice(
            "sae_mlp", extra=dict(model_name="resnet18", dataset_name="tiny_imagenet",
                                  sae_layer="layer4.1", sae_expansion_factor=EXPANSION,
                                  directory_path=str(ORIG_WORK / "c")),
            label=" resnet18 layer4.1 on the trained backbone", datasets=sae_data,
            on_pipeline=check)
    line = f"Loaded original-model weights from epoch {ORIG_EPOCHS}."
    if line not in tee.buf.getvalue():
        raise AssertionError(f"original: (c) the SAE run did not print {line!r}")
    log(f"[original] (c) the SAE Pipeline printed {line!r}; its frozen_params and net_state "
        f"are bitwise the trained ones; launches {launches}")


def _orig_mis(data) -> None:
    """(d) Original-model MIS over layer4.1's 512 channels of the trained model."""
    for flag in ("1", "2"):
        pipe = Pipeline(_orig_cfg(ORIG_WORK / "c", training=False, mis=flag), datasets=data)
        _sync()
        t0 = time.perf_counter()
        out = pipe.run()
        _sync()
        sec = time.perf_counter() - t0
        if flag == "1":
            log(f"[original] (d) mis 1: the 200 extreme train samples of {pipe.num_units} "
                f"channels over {len(pipe.train_ds)} images in {sec:.2f} s")
            continue
        with open(os.path.join(pipe.paths["evaluation_results"], "MIS",
                               f"{pipe.run_id}_mis_epoch_0.csv")) as f:
            rows = sum(1 for _ in f) - 1
        if rows != 512 or len(out["per_unit"]) != 512 or not math.isfinite(out["median_mis"]):
            raise AssertionError(f"original: (d) {rows} CSV rows, median {out['median_mis']}")
        log(f"[original] (d) mis 2: 512 CSV rows, median MIS {out['median_mis']:.4f} in "
            f"{sec:.2f} s")


def _blobs(rng, centers, n: int, chunk: int = 10000):
    """n images of the classes of ``centers`` (make_synthetic's recipe, noise
    0.3) quantized to uint8, and their labels."""
    import numpy as np

    labels = rng.integers(0, centers.shape[0], size=n)
    out = np.empty((n,) + centers.shape[1:], np.uint8)
    for s in range(0, n, chunk):
        x = centers[labels[s:s + chunk]] + 0.3 * rng.standard_normal(
            (min(chunk, n - s),) + centers.shape[1:], dtype=np.float32)
        out[s:s + chunk] = np.clip(np.rint(128 + 48 * x), 0, 255).astype(np.uint8)
    return out, labels


def _write_idx(path: str, arr, opener=open) -> None:
    import struct

    with opener(path, "wb") as f:
        f.write(struct.pack(">I", 0x800 | arr.ndim))
        f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        f.write(arr.tobytes())


def _orig_loaders(smi: str) -> None:
    """(e) MNIST's idx files (the train images also gzipped) and CIFAR-10's
    pickles at full size, read back through load_data equal to the formula on
    the written bytes; custom_mlp_9 and custom_cnn_1 trained an epoch on them."""
    import gzip
    import pickle

    import numpy as np

    from sparse_vision_tpu_torch.data.datasets import load_data

    rng = np.random.default_rng(16)
    root, gz_root = ORIG_WORK / "data", ORIG_WORK / "data_gz"
    t0 = time.perf_counter()
    mnist = {}
    centers = np.random.default_rng(1234).standard_normal((10, 28, 28), dtype=np.float32)
    for prefix, n in zip(("train", "t10k"), MNIST_N):
        mnist[prefix] = _blobs(rng, centers, n)
        for base in (root, gz_root):
            os.makedirs(base / "mnist", exist_ok=True)
            _write_idx(str(base / "mnist" / f"{prefix}-labels-idx1-ubyte"),
                       mnist[prefix][1].astype(np.uint8))
            if base is root or prefix != "train":
                _write_idx(str(base / "mnist" / f"{prefix}-images-idx3-ubyte"), mnist[prefix][0])
    _write_idx(str(gz_root / "mnist" / "train-images-idx3-ubyte.gz"), mnist["train"][0],
               lambda p, m: gzip.open(p, m, compresslevel=1))
    cifar_dir = root / "cifar-10" / "cifar-10-batches-py"
    os.makedirs(cifar_dir)
    centers = np.random.default_rng(1235).standard_normal((10, 3, 32, 32), dtype=np.float32)
    cifar = {"train": [], "test": []}
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for name in names:
        n = CIFAR_N[1] if name == "test_batch" else CIFAR_N[0] // 5
        x, y = _blobs(rng, centers, n)
        cifar["test" if name == "test_batch" else "train"].append((x, y))
        with open(cifar_dir / name, "wb") as f:
            pickle.dump({b"data": x.reshape(n, 3072), b"labels": y.tolist()}, f)
    log(f"[original] (e) wrote MNIST ({MNIST_N[0]:,} / {MNIST_N[1]:,}, the train images also "
        f"as .gz) and CIFAR-10 ({CIFAR_N[0]:,} / {CIFAR_N[1]:,}) in "
        f"{time.perf_counter() - t0:.1f} s")

    def mnist_formula(u8):
        return (u8.astype(np.float32)[..., None] / 255.0 - 0.1307) / 0.3081

    def cifar_formula(parts):
        x = np.concatenate([p for p, _ in parts]).transpose(0, 2, 3, 1).astype(np.float32)
        return (x / 255.0 - 0.1307) / 0.3081

    for base, tag in ((root, "idx"), (gz_root, "idx.gz")):
        t0 = time.perf_counter()
        tr, va, _, size = load_data(RunConfig(model_name="custom_mlp_9", dataset_name="mnist",
                                              data_dir=str(base)))
        sec = time.perf_counter() - t0
        if tuple(size) != (28, 28, 1) or not (
                np.array_equal(tr.images, mnist_formula(mnist["train"][0]))
                and np.array_equal(va.images, mnist_formula(mnist["t10k"][0]))
                and np.array_equal(tr.labels, mnist["train"][1])):
            raise AssertionError(f"original: (e) MNIST ({tag}) differs from the written bytes")
        log(f"[original] (e) MNIST from {tag} read in {sec:.2f} s, bitwise the formula")
    t0 = time.perf_counter()
    tr, va, _, size = load_data(RunConfig(model_name="custom_cnn_1", dataset_name="cifar_10",
                                          data_dir=str(root)))
    sec = time.perf_counter() - t0
    if tuple(size) != (32, 32, 3) or not (
            np.array_equal(tr.images, cifar_formula(cifar["train"]))
            and np.array_equal(va.images, cifar_formula(cifar["test"]))
            and np.array_equal(tr.labels, np.concatenate([y for _, y in cifar["train"]]))):
        raise AssertionError("original: (e) CIFAR-10 differs from the written bytes")
    log(f"[original] (e) CIFAR-10 read in {sec:.2f} s, bitwise the formula")
    for model, dataset, layer in (("custom_mlp_9", "mnist", "fc1"),
                                  ("custom_cnn_1", "cifar_10", "conv2")):
        cfg = RunConfig(model_name=model, dataset_name=dataset, data_dir=str(root),
                        sae_model_name="None", sae_layer=layer, original_model=True,
                        batch_size=LOADER_BATCH, model_epochs=1, log_every=10**9,
                        directory_path=str(ORIG_WORK / "loaders"))
        pipe = Pipeline(cfg)
        pipe.run()
        t, acc = pipe.train_timing[0], pipe.eval_log[-1][1]["accuracy"]
        log(f"[original] (e) {smi}: {model} on the {dataset} files, one epoch: "
            f"{t['steps']} steps of {LOADER_BATCH} in {t['seconds']:.2f} s = "
            f"{t['images'] / t['seconds']:.0f} images/s; val accuracy "
            f"{pipe.eval_log[0][1]['accuracy']:.4f} -> {acc:.4f}")
        if not acc > 0.5:
            raise AssertionError(f"original: (e) {model} ended at accuracy {acc}")


def _decode_pass(ds, batch: int, workers: int) -> tuple:
    t0 = time.perf_counter()
    batches = list(ds.batches(batch, shuffle=False, workers=workers))
    return batches, time.perf_counter() - t0


def _same(a: list, b: list) -> bool:
    import numpy as np

    return len(a) == len(b) and all(
        np.array_equal(x.images, y.images) and np.array_equal(x.indices, y.indices)
        for x, y in zip(a, b))


def _orig_pil(smi: str) -> None:
    """(f) With PIL: the Tiny-ImageNet folders through eval_original of (a)'s
    model, ImageNet tar shards decoded at 229 px (inceptionv1) and 224 px
    (clip_vit_b16), the pool against the synchronous decode, the index file
    reused. Without PIL: the ImportError that names it."""
    import numpy as np

    from sparse_vision_tpu_torch.data.datasets import TarShardDataset, load_data, write_tar_shards

    try:
        import PIL
        from PIL import Image
    except ImportError:
        log("pil: absent")
        shard = ORIG_WORK / "nopil"
        os.makedirs(shard)
        (shard / "x.jpg").write_bytes(b"\xff\xd8 an image")
        ds = TarShardDataset(write_tar_shards([str(shard / "x.jpg")], [0], str(shard)), ["x"])
        try:
            ds.get_image(0)
        except ImportError as e:
            if "PIL" not in str(e):
                raise AssertionError(f"original: (f) the ImportError does not name PIL: {e}")
            log(f"[original] (f) without PIL the first decode raises: {e!r}; not run: the "
                "Tiny-ImageNet eval, the tar-shard decodes at 229 and 224 px, the index "
                "reuse, workers=0 against the pool and the decode rates")
            return
        raise AssertionError("original: (f) a decode without PIL did not raise")
    log(f"pil: {PIL.__version__}")
    rng = np.random.default_rng(17)
    tiny = ORIG_WORK / "tiny" / "tiny-imagenet-200"
    wnids = [f"n{i:08d}" for i in range(ORIG_CLASSES)]
    centers = np.random.default_rng(1236).standard_normal((ORIG_CLASSES, 64, 64, 3),
                                                          dtype=np.float32)
    t0 = time.perf_counter()
    os.makedirs(tiny / "val" / "images")
    (tiny / "wnids.txt").write_text("\n".join(wnids) + "\n")
    imgs, labels = _blobs(rng, centers, ORIG_CLASSES * (TINY_PER_CLASS + 1))
    with open(tiny / "val" / "val_annotations.txt", "w") as f:
        for i, (img, lab) in enumerate(zip(imgs, labels)):
            if i < ORIG_CLASSES:  # val
                Image.fromarray(img).save(tiny / "val" / "images" / f"val_{i}.png")
                f.write(f"val_{i}.png\t{wnids[lab]}\t0\t0\t64\t64\n")
                continue
            d = tiny / "train" / wnids[lab] / "images"
            os.makedirs(d, exist_ok=True)
            Image.fromarray(img).save(d / f"{i}.png")
    for w in wnids:
        os.makedirs(tiny / "train" / w / "images", exist_ok=True)
    log(f"[original] (f) wrote a tiny-imagenet-200 folder ({len(imgs) - ORIG_CLASSES} train / "
        f"{ORIG_CLASSES} val PNGs) in {time.perf_counter() - t0:.1f} s")
    cfg = _orig_cfg(ORIG_WORK / "c", training=False, data_dir=str(tiny.parent),
                    batch_size=TINY_BATCH)
    pipe = Pipeline(cfg)
    means = pipe.run()
    if pipe._model_ckpt_epoch != ORIG_EPOCHS or not all(map(math.isfinite, means.values())):
        raise AssertionError(f"original: (f) eval_original on the folder: {means}")
    # its last eval's figures over layer4.1's channels (model key "original")
    _check_figures("original (f)", pipe, (0,), (0,))
    sync, s0 = _decode_pass(pipe.train_ds, TINY_BATCH, 0)
    pool, s1 = _decode_pass(pipe.train_ds, TINY_BATCH, -1)
    if not _same(sync, pool):
        raise AssertionError("original: (f) the Tiny-ImageNet pool differs from workers=0")
    n = len(sync) * TINY_BATCH
    log(f"[original] (f) eval_original of (a)'s ResNet-18 over the folder's val: "
        f"{json.dumps(means, sort_keys=True)}; {smi}: decode of {n} PNGs {n / s0:.0f} images/s "
        f"with workers=0, {n / s1:.0f} with the pool, bitwise equal")

    src = ORIG_WORK / "jpegs"
    os.makedirs(src)
    paths = []
    for i in range(TAR_IMAGES):
        small = rng.integers(0, 256, (TAR_WH[1] // 10, TAR_WH[0] // 10, 3), dtype=np.uint8)
        p = str(src / f"{i:05d}.jpg")
        Image.fromarray(small).resize(TAR_WH, Image.BICUBIC).save(p, quality=90)
        paths.append(p)
    base = ORIG_WORK / "inet" / "imagenet"
    write_tar_shards(paths, [i % 1000 for i in range(TAR_IMAGES)], str(base),
                     shard_size=TAR_SHARD, prefix="train")
    write_tar_shards(paths[:TAR_SHARD], list(range(TAR_SHARD)), str(base),
                     shard_size=TAR_SHARD, prefix="val")
    index = None
    for model, side in (("inceptionv1", 229), ("clip_vit_b16", 224)):
        train, _, _, size = load_data(RunConfig(model_name=model, dataset_name="imagenet",
                                                data_dir=str(base.parent)))
        caches = sorted(base.glob("_svt_index_*.json"))
        stamps = [os.stat(c).st_mtime_ns for c in caches]
        if index is not None and stamps != index:
            raise AssertionError("original: (f) the tar index was rewritten on a second open")
        index = stamps
        if not isinstance(train, TarShardDataset) or tuple(size) != (side, side, 3) \
                or len(train) != TAR_IMAGES or len(caches) != 2:
            raise AssertionError(f"original: (f) {model}: {type(train).__name__} {size} "
                                 f"{len(train)} images, {len(caches)} index files")
        sync, s0 = _decode_pass(train, 32, 0)
        pool, s1 = _decode_pass(train, 32, -1)
        if not _same(sync, pool) or sync[0].images.shape[1:] != (side, side, 3):
            raise AssertionError(f"original: (f) {model}: the pool differs from workers=0")
        log(f"[original] (f) {smi}: {TAR_IMAGES} JPEGs of {TAR_WH[1]} x {TAR_WH[0]} from "
            f"{len(train.tar_paths)} tar shards at {side} px ({model}): {TAR_IMAGES / s0:.0f} "
            f"images/s with workers=0, {TAR_IMAGES / s1:.0f} with the pool "
            f"({os.cpu_count()} CPUs), bitwise equal")
    log("[original] (f) the _svt_index files were reused by the second open")


def phase_original(smi: str) -> None:
    """Phase 13 (the module docstring)."""
    t_phase = time.perf_counter()
    shutil.rmtree(ORIG_WORK, ignore_errors=True)
    torch.backends.cudnn.allow_tf32 = True  # a user's run: PyTorch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    train = make_synthetic(num_samples=ORIG_TRAIN, img_size=ORIG_SIZE,
                           num_classes=ORIG_CLASSES, seed=0)
    val = make_synthetic(num_samples=ORIG_VAL, img_size=ORIG_SIZE, num_classes=ORIG_CLASSES,
                         seed=1)
    data = (train, val, train.category_names, ORIG_SIZE)
    trained = _orig_train(data, smi)
    _orig_step_vs_cpu(trained, data)
    _orig_chain(trained, data)
    _orig_mis(data)
    del trained
    torch.cuda.empty_cache()
    _orig_loaders(smi)
    _orig_pil(smi)
    shutil.rmtree(ORIG_WORK, ignore_errors=True)
    log(f"[original] {smi}: phase {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 14: finish (the eval figures, the report, the e2e finetune, the trace)
# ---------------------------------------------------------------------------

# the JAX figures' pixel sizes (figsize x dpi): the channel-frequency
# histogram 8 x 4 in at 120 dpi, the activation histograms 18 x 12 at 150, a
# top-k grid of 10 units x 5 images (2 x 5) x (2.2 x 10) at 150, faithfulness
# 20 x 5 at 150
FIG_SIZES = {"channel_frequency_histograms": (960, 480), "top_k_samples": (1500, 3300),
             "activation_histograms": (2700, 1800), "faithfulness": (3000, 750)}
FIN_WORK = ROOT / "_smoke_finish"  # listed in .gitignore; removed at the end
FIN_BATCH = 32  # the finetune's sae_batch_size: its stock step holds [B·784, 16,384] f32
FIN_STEP_IMAGES = 4  # (b): the card's f32 step against the CPU's f64
# (b): the loss within FIN_TOL of the CPU's f64; each parameter array's update
# within FIN_TOL of the update's largest entry, or within F32_NOISE times the
# distance of the CPU's own f32 step from f64
FIN_TOL = 1e-4
# (c): a trace event's device time by the profiler range its launch lies in
# (train/steps.make_update); the fused kernels by name
RANGE_KIND = {"sae_step.loss": "loss terms", "sae_step.backward": "loss terms",
              "sae_step.optimizer": "optimizer", "sae_step.dead_units": "dead units"}
FUSED_KIND = (("coder_fwd", "fused forward"), ("center_kernel", "fused forward"),
              ("coder_bwd", "fused backward"), ("scale_err_kernel", "fused backward"))


def _png_size(path: str) -> tuple:
    from PIL import Image

    with Image.open(path) as im:
        im.load()  # decodes the whole file
        return im.size


def _check_figures(label: str, pipe, freq_epochs, final_epochs) -> dict:
    """Every PNG that the JAX package's run writes under the run's
    evaluation_results, and no other of its run ID: the channel-frequency
    histogram of each of ``freq_epochs``, the top / small grids and the
    activation histograms of each of ``final_epochs``; each decodes at the
    JAX figure's size. Returns {relative path: path}."""
    ev, rid = pipe.paths["evaluation_results"], pipe.run_id
    want = [("channel_frequency_histograms", f"{rid}_epoch_{e}.png") for e in freq_epochs]
    for e in final_epochs:
        want += [("top_k_samples", f"{rid}_top_k_samples_epoch_{e}.png"),
                 ("top_k_samples", f"{rid}_small_k_samples_epoch_{e}.png"),
                 ("activation_histograms", f"{rid}_epoch_{e}.png")]
    have = sorted(os.path.relpath(os.path.join(r, f), ev) for r, _, fs in os.walk(ev)
                  for f in fs if f.startswith(f"{rid}_") and f.endswith(".png"))
    if have != sorted(os.path.join(sub, name) for sub, name in want):
        raise AssertionError(f"{label}: figure files {have}, expected {want}")
    for sub, name in want:
        size = _png_size(os.path.join(ev, sub, name))
        if size != FIG_SIZES[sub]:
            raise AssertionError(f"{label}: {sub}/{name} is {size}, JAX's is {FIG_SIZES[sub]}")
    log(f"[{label}] figures: {len(want)} PNGs, each decoded at the JAX figure's size: " +
        ", ".join(f"{sub} {FIG_SIZES[sub][0]}x{FIG_SIZES[sub][1]}" for sub in
                  sorted({s for s, _ in want})))
    return {os.path.join(sub, name): os.path.join(ev, sub, name) for sub, name in want}


@contextlib.contextmanager
def _recording_figures(record: dict):
    """Record what the eval hands show_top_k_samples (the images and values,
    by file name) and every histogram update (the state before it and the
    activations), and still draw."""
    from sparse_vision_tpu_torch.eval_tools import viz
    from sparse_vision_tpu_torch.ops import histograms

    show, update = viz.show_top_k_samples, histograms.update_histogram

    def show_rec(images, values, path, title=""):
        record.setdefault("topk", {})[os.path.basename(path)] = (images, values)
        return show(images, values, path, title=title)

    def update_rec(state, acts):
        record.setdefault("hist", []).append((state, acts.detach().clone()))
        new = update(state, acts)
        record["hist_last"] = new
        return new

    viz.show_top_k_samples, histograms.update_histogram = show_rec, update_rec
    try:
        yield
    finally:
        viz.show_top_k_samples, histograms.update_histogram = show, update


def _check_tiles(label: str, path: str, images: dict, values: dict) -> int:
    """The grid's tiles read back bitwise equal to the gathered images,
    upscaled (eval_tools/draw.tile_pixels)."""
    import numpy as np
    from PIL import Image

    from sparse_vision_tpu_torch.eval_tools import draw, viz

    with Image.open(path) as im:
        px = np.asarray(im.convert("RGB"))
    boxes = viz.topk_tile_boxes(images, values)
    for (u, c), (x, y, scale, stride) in boxes.items():
        want = draw.tile_pixels(images[u][c][::stride, ::stride], scale)
        if not np.array_equal(px[y:y + want.shape[0], x:x + want.shape[1]], want):
            raise AssertionError(f"{label}: tile ({u}, {c}) of {os.path.basename(path)} does not "
                                 "read back as the gathered image")
    return len(boxes)


def _check_histogram_counts(label: str, record: dict) -> None:
    """The last histogram pass's counts on the card against the port's plain
    update of the same activations on the CPU, bitwise."""
    from sparse_vision_tpu_torch.ops import histograms

    last = record["hist_last"]  # the last pass's updates share its ranges
    passes = [(s, a) for s, a in record["hist"] if s.mins is last.mins]
    state = passes[0][0]
    cpu = histograms.init_histogram(state.counts.shape[0], state.mins.cpu(), state.maxs.cpu())
    for _, acts in passes:
        cpu = histograms.update_histogram(cpu, acts.cpu())
    card = last.counts.cpu()
    if not torch.equal(card, cpu.counts):
        raise AssertionError(f"{label}: the card's histogram counts differ from the CPU's plain "
                             f"update: {int((card != cpu.counts).sum())} of {card.numel()} bins")
    log(f"[{label}] activation histogram: {len(passes)} batches, {int(card.sum())} "
        f"counts in {card.shape[0]} bins x {card.shape[1]} units, bitwise the CPU's plain "
        "update of the same activations")


def _trace_split(path: str, steps: int) -> tuple:
    """(launches of each fused kernel by name, one step's device ms by kind,
    the device's idle share of the traced window) from one Chrome trace of
    utils/profiling.maybe_profile. A kernel or copy counts for the kind of the
    profiler range its launch lies in (RANGE_KIND), the fused kernels by name,
    the host-device copies as "copies"."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"], RANGE_KIND[e["name"]]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"] in RANGE_KIND)
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    fused: dict = {}
    split: dict = {}
    for e in device:
        name = e.get("name", "")
        kind = next((k for key, k in FUSED_KIND if key in name), None)
        if kind is not None and e["cat"] == "kernel":
            base = re.search(r"(coder_\w+|center_kernel|scale_err_kernel)", name).group(1)
            fused[base] = fused.get(base, 0) + 1
        elif e["cat"] != "kernel":
            kind = "copies"
        else:
            ts = launch_ts.get(e.get("args", {}).get("correlation"))
            kind = next((k for a, b, k in ranges if ts is not None and a <= ts <= b), "other")
        split[kind] = split.get(kind, 0.0) + e["dur"] / 1e3 / steps
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in device)
    busy, end = 0.0, -math.inf
    for a, b in spans:  # the union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    window = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    return fused, split, 1.0 - busy / window


def _fin_step_vs_cpu(pipe) -> None:
    """(b) One finetune step of (a)'s trained SAE on FIN_STEP_IMAGES images:
    the card's f32 (TF32 off) against the CPU's f64 (and the CPU's f32, the
    noise floor), from the same parameters and Adam state."""
    from sparse_vision_tpu_torch.train.e2e_finetune import finetune_step_for

    set_tf32(False)
    b = next(pipe.train_ds.batches(FIN_STEP_IMAGES, shuffle=False))
    x, y = torch.from_numpy(b.images), torch.from_numpy(b.labels)
    step = finetune_step_for(pipe)
    runs = {}
    for tag, device, dtype in (("card", DEVICE, torch.float32), ("cpu64", "cpu", torch.float64),
                               ("cpu32", "cpu", torch.float32)):
        ts = tsteps.SAETrainState(_tree_to(pipe.ts.params, device, dtype),
                                  _tree_to(pipe.ts.opt_state, device, dtype), pipe.ts.step,
                                  pipe.ts.dead_acc.to(device), pipe.ts.rng)
        t0 = time.perf_counter()
        new, m = step(ts, _tree_to(pipe.frozen_params, device, dtype),
                      _tree_to(pipe.net_state, device, dtype), x.to(device, dtype),
                      y.to(device))
        _sync()
        runs[tag] = (new.params, {k: float(v) for k, v in m.items()}, time.perf_counter() - t0)
    (card, cm, _), (ref, rm, cpu_s), (cpu32, _, _) = (runs[k] for k in ("card", "cpu64",
                                                                         "cpu32"))
    loss_err = abs(cm["e2e_loss"] - rm["e2e_loss"]) / abs(rm["e2e_loss"])
    worst = floor = 0.0
    for k, want in ref.items():
        scale = float((want - pipe.ts.params[k].double().cpu()).abs().max().clamp_min(1e-30))
        err = float((card[k].double().cpu() - want).abs().max()) / scale
        noise = float((cpu32[k].double() - want).abs().max()) / scale
        if err > max(FIN_TOL, F32_NOISE * noise):
            raise AssertionError(f"finish: (b) {k}: the card's step {err:.3g} of the update's "
                                 f"scale from the CPU's f64; the CPU's f32 {noise:.3g}")
        worst, floor = max(worst, err), max(floor, noise)
    if loss_err > FIN_TOL:
        raise AssertionError(f"finish: (b) e2e_loss {loss_err:.3g} from the CPU's f64")
    log(f"[finish] (b) one finetune step of {FIN_STEP_IMAGES} images, TF32 off: the card's f32 "
        f"e2e_loss {cm['e2e_loss']:.8g} (f64 {rm['e2e_loss']:.8g}; {loss_err:.3g} apart, bound "
        f"{FIN_TOL:g}), kld {cm['kld']:.6g} (f64 {rm['kld']:.6g}); the updated parameters "
        f"{worst:.3g} of each update's largest entry from f64 (the CPU's own f32 step "
        f"{floor:.3g}; bound max({FIN_TOL:g}, {F32_NOISE:g}x the CPU's f32)); the CPU's f64 "
        f"step took {cpu_s:.1f} s")
    torch.backends.cudnn.allow_tf32 = True


def _fin_north_star(smi: str):
    """(a), (c), (d): sae_mlp at phase 6's north-star shape through
    Pipeline.run with profile_dir and one finetune epoch. Returns the
    Pipeline."""
    from sparse_vision_tpu_torch.train import e2e_finetune

    set_tf32(False)
    torch.backends.cudnn.allow_tf32 = True  # a user's run: PyTorch's default for the convs
    traces = FIN_WORK / "traces"
    cfg, datasets = _slice_config("sae_mlp", dict(
        directory_path=str(FIN_WORK / "a"), profile_dir=str(traces),
        sae_e2e_finetune_epochs=1, sae_batch_size=FIN_BATCH))
    pipe = Pipeline(cfg, datasets=datasets, backbone=_scaled_googlenet(cfg.seed)[1:])
    record, peak = {}, {}
    run_ft, make_step = e2e_finetune.e2e_finetune, e2e_finetune.finetune_step_for

    def measured_step(p):  # the finetune steps' peak memory, before its eval
        step = make_step(p)

        def run(*args):
            out = step(*args)
            peak["bytes"] = torch.cuda.max_memory_allocated()
            return out

        return run

    def measured_finetune(p, epochs=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return run_ft(p, epochs)

    e2e_finetune.e2e_finetune, e2e_finetune.finetune_step_for = (measured_finetune,
                                                                measured_step)
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    try:
        with _recording_figures(record):
            pipe.run()
    finally:
        e2e_finetune.e2e_finetune, e2e_finetune.finetune_step_for = run_ft, make_step
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    steps = len(pipe.train_log)
    ft_steps = len(pipe.finetune_log)
    log(f"[finish] (a) Pipeline.run (dump, {steps} training steps profiled, {ft_steps} finetune "
        f"steps, 3 evals, figures) in {wall:.1f} s; launches {launches}")
    if steps != 12 or ft_steps != -(-len(pipe.train_ds) // FIN_BATCH):
        raise AssertionError(f"finish: (a) {steps} training and {ft_steps} finetune steps")
    for k in KERNELS:  # once a training step; the finetune's stock step launches none
        want = steps if k in (fused_sae.fwd_kernel, fused_sae.bwd_kernel) else 0
        if launches[k.name] != want:
            raise AssertionError(f"finish: (a) {launches[k.name]} launches of {k.name}, "
                                 f"expected {want}")
    if [e for e, _ in pipe.eval_log] != [0, 1, 2]:
        raise AssertionError(f"finish: (a) evals {[e for e, _ in pipe.eval_log]}")
    for s, m in pipe.finetune_log:
        if not all(math.isfinite(float(v)) for v in m.values()):
            raise AssertionError(f"finish: (a) finetune step {s}: {m}")
    (_, before), (_, after) = pipe.eval_log[1], pipe.eval_log[2]
    for e, m in ((1, before), (2, after)):
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"finish: (a) eval {e} not finite: {m}")
    ft = pipe.finetune_timing[0]
    log(f"[finish] (a) {smi}: before the finetune (epoch 1) kld {before['kld']:.6g}, perc_same "
        f"{before['perc_same']:.4f}, var_expl {before['var_expl']:.6g}; after it (epoch 2) kld "
        f"{after['kld']:.6g}, perc_same {after['perc_same']:.4f}, var_expl "
        f"{after['var_expl']:.6g}")
    log(f"[finish] (a) {smi}: finetune {ft['steps']} steps of {FIN_BATCH} images in "
        f"{ft['seconds']:.3f} s = {ft['images'] / ft['seconds']:.1f} images/s (host clock, ends "
        f"in a synchronize; not profiled); peak memory of its steps "
        f"{peak['bytes'] / 2**30:.2f} GiB (max_memory_allocated); first / last step e2e_loss "
        f"{float(pipe.finetune_log[0][1]['e2e_loss']):.6g} / "
        f"{float(pipe.finetune_log[-1][1]['e2e_loss']):.6g}")
    if pipe.train_timing[0]["profiled"] is not True:
        raise AssertionError("finish: (a) the training epoch was not marked as profiled")
    log("[finish] (a) the training epoch ran under the profiler: its time is not a throughput "
        f"({pipe.train_timing[0]['seconds']:.3f} s for 12 steps, traced)")

    # (c) the trace
    paths = sorted(glob.glob(str(traces / "*.json")))
    if len(paths) != 1:
        raise AssertionError(f"finish: (c) {len(paths)} traces for one trained epoch: {paths}")
    fused, split, idle = _trace_split(paths[0], steps)
    if set(fused.values()) != {steps} or not any("coder_fwd" in k for k in fused) \
            or not any("coder_bwd" in k for k in fused):
        raise AssertionError(f"finish: (c) fused kernels in the trace: {fused}")
    total = sum(split.values())
    log(f"[finish] (c) {smi}: trace {os.path.basename(paths[0])} "
        f"({os.path.getsize(paths[0]) / 2**20:.1f} MiB) names the fused kernels "
        f"{json.dumps(fused, sort_keys=True)}")
    log(f"[finish] (c) {smi}: one step's device time {total:.3f} ms: " + ", ".join(
        f"{k} {v:.3f} ms ({v / total:.1%})" for k, v in sorted(split.items(),
                                                                key=lambda kv: -kv[1])) +
        f"; device idle {idle:.1%} of the traced window")

    # (d) the figures
    files = _check_figures("finish", pipe, (0, 1, 2), (1, 2))
    tiles = sum(_check_tiles("finish", files[os.path.join("top_k_samples", name)], *iv)
                for name, iv in record["topk"].items() if name.endswith("epoch_2.png"))
    log(f"[finish] (d) {tiles} top-k tiles of epoch 2 read back bitwise as the gathered "
        "images, upscaled")
    _check_histogram_counts("finish", record)
    return pipe, files


def _fin_other(name: str, extra: dict, smi: str) -> None:
    """(e) One finetune epoch of ``name`` at its phase 6 shape through
    Pipeline.run: its kernels once a training step and never in the
    finetune, finite metrics, the crosscoder's CSV on the finetuned
    parameters."""
    cfg, datasets = _slice_config(name, {"directory_path": str(FIN_WORK / name),
                                         "sae_e2e_finetune_epochs": 1,
                                         "sae_batch_size": FIN_BATCH, **extra})
    pipe = Pipeline(cfg, datasets=datasets, backbone=_scaled_googlenet(cfg.seed)[1:])
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    pipe.run()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    if len(pipe.train_log) != 12:
        raise AssertionError(f"finish: (e) {name}: {len(pipe.train_log)} training steps")
    trained = (MODULES[name].fwd_kernel, MODULES[name].bwd_kernel)
    for k in KERNELS:
        want = 12 if k in trained else 0
        if launches[k.name] != want:
            raise AssertionError(f"finish: (e) {name}: {launches[k.name]} launches of {k.name}, "
                                 f"expected {want}")
    last = pipe.eval_log[-1]
    if last[0] != 2 or not all(math.isfinite(v) for v in last[1].values()) or not all(
            math.isfinite(float(v)) for _, m in pipe.finetune_log for v in m.values()):
        raise AssertionError(f"finish: (e) {name}: last eval {last}")
    ft = pipe.finetune_timing[0]
    note = ""
    if name == "crosscoder":
        from sparse_vision_tpu_torch.models.crosscoder import crosscoder_decoder_norms

        with open(pipe.decoder_norms_path) as f:
            rows = list(csv.reader(f))[1:]
        norms = crosscoder_decoder_norms(pipe.ts.params).float().cpu()
        got = torch.tensor([[float(v) for v in r[1:1 + norms.shape[0]]] for r in rows]).T
        if got.shape != norms.shape or not torch.equal(got, norms):
            raise AssertionError("finish: (e) crosscoder: the decoder-norm CSV is not the "
                                 "finetuned parameters'")
        note = f"; decoder-norm CSV: {len(rows)} rows, the finetuned parameters' norms"
    _check_figures(f"finish {name}", pipe, (0, 1, 2), (1, 2))
    log(f"[finish] (e) {name} {smi}: Pipeline.run in {wall:.1f} s; launches "
        f"{ {k: v for k, v in launches.items() if v} }; finetune {ft['steps']} steps of "
        f"{FIN_BATCH} images, {ft['images'] / ft['seconds']:.1f} images/s, no fused launch; "
        f"eval before / after the finetune: kld {pipe.eval_log[1][1]['kld']:.6g} / "
        f"{last[1]['kld']:.6g}, perc_same {pipe.eval_log[1][1]['perc_same']:.4f} / "
        f"{last[1]['perc_same']:.4f}{note}")
    del pipe
    torch.cuda.empty_cache()


def _fin_report(pipe, files: dict) -> None:
    """(f) write_feature_report on (a)'s folder: the HTML embeds (d)'s PNGs of
    the last epoch."""
    import base64

    from sparse_vision_tpu_torch.eval_tools.report import write_feature_report

    out = write_feature_report(pipe.paths["evaluation_results"], pipe.run_id,
                               str(FIN_WORK / "report.html"),
                               ie_dir=pipe.paths["ie_related_quantities"])
    with open(out) as f:
        page = f.read()
    embedded = [rel for rel, p in files.items() if rel.endswith("epoch_2.png")]
    for rel in embedded:
        with open(files[rel], "rb") as f:
            if base64.b64encode(f.read()).decode() not in page:
                raise AssertionError(f"finish: (f) the report does not embed {rel}")
    log(f"[finish] (f) feature report {os.path.getsize(out) / 2**20:.1f} MiB, embedding "
        f"{len(embedded)} PNGs of epoch 2 and {pipe.num_units} unit rows")


def phase_finish(smi: str) -> None:
    """Phase 14 (the module docstring)."""
    t_phase = time.perf_counter()
    shutil.rmtree(FIN_WORK, ignore_errors=True)
    pipe, files = _fin_north_star(smi)
    _fin_step_vs_cpu(pipe)
    _fin_report(pipe, files)
    del pipe
    torch.cuda.empty_cache()
    _fin_other("transcoder", {}, smi)
    _fin_other("crosscoder", {"sae_input_norm": "none"}, smi)
    shutil.rmtree(FIN_WORK, ignore_errors=True)
    log(f"[finish] {smi}: phase {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 15: mesh (parallel/: data- and tensor-parallel training over ranks
# that share this one card through gloo)
# ---------------------------------------------------------------------------

MESH = (2, 2)  # (data, model): 4 ranks
MESH_DP = (2,)
SHARD_T, SHARD_H = T // MESH[0], H // MESH[1]  # a TP rank's 16,384 tokens, 8,192 latents
MESH_WORK = ROOT / "_smoke_mesh"  # listed in .gitignore; removed at the end
MESH_TIMEOUT_S = 600
MESH_FAIL_TIMEOUT_S = 120
SHARING = "gloo, ranks sharing one card"
TP_KERNELS = fused_sae_tp.KERNELS  # rows 15-22: ReLU, gated, JumpReLU, Matryoshka
# (a): the JumpReLU op's thresholds and STE window, where the inputs' pre-activations
# have std ~0.3, so that many fall in the window and dθ is held; the Matryoshka
# prefixes, which cut rank 1's shard: boundaries (1,024, 12,288, 16,384), union
# (1,024, 4,096, 8,192), n_contrib (1, 2, 2) (phase 6's 1/16, 1/4, 1 cut only rank
# 0's); and (e)'s Matryoshka rows run at that union
MESH_THETA, MESH_BANDWIDTH = (0.05, 0.15), 0.1  # θ uniform in the range; ε
MESH_PREFIXES = (1 / 16, 3 / 4, 1.0)
MESH_UNION = fused_sae_tp.tp_snapshot_union(matryoshka_prefix_counts(H, MESH_PREFIXES),
                                            MESH[1])[0]
# the mesh runs of (b), (c) and (g), and the fields of each beyond phase 6's. TopK
# runs phase 11's k without AuxK (the TP op has none) in f32: its one-rank fast
# path encodes in f32 whatever compute_dtype says, where the TP op rounds the
# encode's operands to compute_dtype as JAX's does, so in bf16 the two runs would
# select from different pre-activations
MESH_RUNS = {"sae_mlp": {}, "gated_sae": {}, "jumprelu_sae": {}, "matryoshka_sae": {},
             "topk_sae": dict(sae_topk=TK_K, sae_aux_k=0, sae_lambda_sparse=0.0,
                              compute_dtype="float32")}
# each run's TP rows (TopK: none, its op is torch ops)
MESH_RUN_KERNELS = {"sae_mlp": TP_KERNELS[:2], "gated_sae": TP_KERNELS[2:4],
                    "jumprelu_sae": TP_KERNELS[4:6], "matryoshka_sae": TP_KERNELS[6:8],
                    "topk_sae": ()}
# rows 23-26: the coders' TP sites; (h) and (i) run phase 6's transcoder and
# crosscoder configs at (2, 2) through them and at (2,) through rows 11-14. A
# (2, 2) rank's shard: the transcoder's 16,384 tokens and 8,192 latents, the
# crosscoder's 8,192 and 4,096
CODER_TP_KERNELS = fused_transcoder.TP_KERNELS + fused_crosscoder.TP_KERNELS
MESH_CODERS = {"transcoder": (fused_transcoder.TP_KERNELS, fused_transcoder.KERNELS),
               "crosscoder": (fused_crosscoder.TP_KERNELS, fused_crosscoder.KERNELS)}
TC_SHARD_T, TC_SHARD_H = TC_T // MESH[0], TC_H // MESH[1]
CC_SHARD_T, CC_SHARD_H = CC_T // MESH[0], CC_H // MESH[1]
# the TP op against the single-rank op on the same inputs (a): the pre-activations
# are the same bits on both (the encode's C-sum does not depend on H), so the
# counts agree exactly; the partial decodes and latent-local gradients are summed
# over ranks in another order, and in bf16 a reconstruction that moved by an f32
# rounding can round its error (and with it drecon, round(db_enc)) to the next
# bf16 value. The loss terms: relative, f32 1e-5; in bf16 each reconstruction
# entry sums 16,384 bf16 products in f32 in another grouping, and the MSE of a
# small error amplifies that (1.2e-5 of the loss on an H100; PERF.md)
MESH_OP_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 5e-3)}  # rtol, atol·max
MESH_LOSS_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
# (b)-(d), (g): the mesh run against the one-rank run, both in bf16 (TopK in f32).
# The ranks sum the decode and the gradients in another order, and bf16 rounds
# b_dec (x_cent = x − round(b_dec)) and the errors, so the runs part at the first
# update and cannot be held bitwise. Held instead, each limit about 3x the largest
# reading of the H100 runs (PERF.md §6):
# - each step's loss terms, relative to the one-rank run's (MESH_STEP_RTOL,
#   the coders' MESH_STEP_RTOL_BY) and
#   perc_dead (MESH_DEAD_ATOL; a latent whose every pre-activation sits at 0 can
#   be dead in one run's accumulator only);
# - each resample's dead mask: such latents are resampled in one run only (their
#   parameters then are a fresh draw in one run and their own in the other), at
#   most MESH_FLIPS_MAX of them, and each must sit at the margin: its largest
#   pre-activation over the resample's window (the one-rank run's) within
#   MESH_MARGIN_ULPS bf16 ulps of 0, the ulp taken at the median latent's
#   largest pre-activation;
# - the other latents' parameters: the median and the 99th percentile over the
#   latents of each latent's largest gap, and b_dec's largest gap
#   (MESH_PARAM_LIMITS by variant: the gated run parts ~40x further, as far at
#   (2,) as at (2, 2), and not at all in f32: bf16's rounding, PERF.md; TopK's
#   f32 runs part only where a selection flips);
# - the replicated parameters' Adam moments (MESH_MOMENT_LIMITS below; the
#   gated run's b_dec mu parts 0.11 of its largest entry, at (2, 2) as at (2,)).
# chip_mesh_checks.py shows that six planted faults fail these checks.
MESH_STEP_RTOL = {"sae_loss": 1.5e-3, "sae_rec_loss": 3e-3, "sae_l1_loss": 2e-4,
                  "sparsity": 2e-4}
# the coders' own, where their readings come nearer MESH_STEP_RTOL's: a few
# latents at the threshold of the rms-normalized crosscoder switch in one run
# only (its step-12 sparsity 3.1e-4 apart, PERF.md)
MESH_STEP_RTOL_BY = {"transcoder": {"sae_l1_loss": 4e-4, "sparsity": 5e-4},
                     "crosscoder": {"sparsity": 1e-3}}
MESH_DEAD_ATOL = 1.5e-3
MESH_FLIPS_MAX = 16
MESH_MARGIN_ULPS = 0.1
MESH_PARAM_LIMITS = {"sae_mlp": (1e-4, 2.5e-3, 1e-4),  # median, 99th percentile, b_dec
                     "gated_sae": (4e-3, 3e-2, 2e-3),
                     "jumprelu_sae": (1e-4, 4e-4, 2e-4),
                     "matryoshka_sae": (2e-4, 1e-3, 1.5e-4),
                     "topk_sae": (1e-6, 5e-5, 2e-6),
                     "transcoder": (3e-5, 3e-3, 5e-5),
                     "crosscoder": (2e-4, 5e-3, 2.5e-5)}
# - the Adam moments of the replicated parameters (b_dec, each b_dec_i), the
#   largest gap of mu and of nu relative to the one-rank run's largest entry:
#   a gradient scaled by a constant moves no Adam update, and so no parameter,
#   but it scales the moments (mu by the factor, nu by its square)
MESH_MOMENT_LIMITS = {"sae_mlp": 2e-3, "gated_sae": 0.35, "jumprelu_sae": 5e-3,
                      "matryoshka_sae": 7e-4, "topk_sae": 1e-5, "transcoder": 3e-2,
                      "crosscoder": 2.5e-3}


def _tp_kernel_rows(cd, tag: str) -> dict:
    """The eight TP rows' wrappers on the card at a (2, 2) rank's shard (T
    16,384, C 256, H 8,192; Matryoshka at MESH_UNION) against their plain
    versions, timed beside their bounds and the stock path's cuBLAS products;
    bf16 launches repeat bitwise."""
    t, c, h = SHARD_T, C, SHARD_H
    label = f"{tag}, shard T={t} H={h}"
    ops = _relu_exact_operands(cd, t, c, h)
    x, we, be, wd, bd = ops
    fwd, bwd = fused_sae_tp.fwd_kernel, fused_sae_tp.bwd_kernel
    out_k, out_p = fwd(*ops), fused_sae.sae_fwd_plain(*ops)
    log(f"[mesh] {fwd.name} [{label}] vs plain")
    if cd == torch.bfloat16:
        _repeatable(fwd.name, out_k, fwd(*ops))
    err = _check("recon", out_k[1], out_p[1], 1e-4, 1e-5)
    _check("act_count", out_k[2].sum(0), out_p[2].sum(0), 0.0, 0.0)
    _check("row_active", out_k[3], out_p[3], 0.0, 0.0)
    _check("l1_sum", out_k[4].sum(), out_p[4].sum(), 1e-5, 0.0)
    xc = x - bd.to(cd)
    post = torch.relu(xc @ we).to(cd)
    rows = {fwd.name: _measure(fwd.name, label, cd, lambda: fwd(*ops),
                               lambda: fused_sae.sae_fwd_plain(*ops),
                               lambda: (xc @ we, post @ wd), 4.0 * t * c * h,
                               nbytes(*ops) + nbytes(*out_p[1:4]) + 4, err)}
    x_cent = out_k[0]
    res = (out_p[1] - x.float()).to(cd)
    del out_k, out_p
    coeffs = torch.tensor([2.0 / (T * c), LAMBDA / (T * H)], device=DEVICE)
    g_k, g_p = bwd(x_cent, we, be, wd, res, coeffs), fused_sae.backward_plain(
        x_cent, we, be, wd, res, coeffs)
    log(f"[mesh] {bwd.name} [{label}] vs plain")
    pair = _sae_route(cd, c) == "pair"
    if cd == torch.bfloat16:
        for _ in range(REPEATS - 1 if pair else 1):
            _repeatable(bwd.name, g_k, bwd(x_cent, we, be, wd, res, coeffs))
    err = max(_check(n, a, b, 1e-3, 1e-4) for n, a, b in zip(
        ("dW_enc", "db_enc", "dW_dec", "db_dec"), g_k[:3] + (g_k[3].sum(0),),
        g_p[:3] + (g_p[3].sum(0),)))
    moved = nbytes(x_cent, we, be, wd, res, coeffs) + nbytes(*g_p[:3]) + 4 * c
    del g_k, g_p
    dr = (coeffs[0] * res.float()).to(cd)
    rows[bwd.name] = _measure(
        bwd.name, label, cd, lambda: bwd(x_cent, we, be, wd, res, coeffs),
        lambda: fused_sae.backward_plain(x_cent, we, be, wd, res, coeffs),
        lambda: (dr @ wd.T, xc.T @ post, post.T @ dr), 8.0 * t * c * h, moved, err)
    if cd == torch.bfloat16 and pair:  # row 16 beside coder_bwd_tc
        _route_timing(bwd.name, label, "pair",
                      lambda **kw: bwd(x_cent, we, be, wd, res, coeffs, **kw))
    del x_cent, res, dr, post, xc, ops, x, we, be, wd

    gfwd, gbwd = fused_sae_tp.gated_fwd_kernel, fused_sae_tp.gated_bwd_kernel
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = init_gated_sae(gen, c, h // c)
    x, wg, bd = _exact_inputs(gen, t, params["W_gate"])
    gops = (x.to(cd), wg.to(cd), _odd_grid(gen, h, 100), _odd_grid(gen, h, 60),
            torch.exp(0.1 * torch.randn(h, device=DEVICE, generator=gen)),
            params["W_dec"].to(cd).contiguous(), bd)
    out_k, out_p = gfwd(*gops), fused_gated_sae.fused_gated_forward_plain(*gops)
    log(f"[mesh] {gfwd.name} [{label}] vs plain")
    if cd == torch.bfloat16:
        _repeatable(gfwd.name, out_k, gfwd(*gops))
    err = max(_check(k, a, b, 1e-4, 1e-5) for k, a, b in zip(("recon", "via_gate"), out_k,
                                                                out_p))
    _check("act_count", out_k[2], out_p[2], 0.0, 0.0)
    _check("row_active", out_k[3], out_p[3], 0.0, 0.0)
    _check("l1_sum", out_k[4], out_p[4], 1e-5, 0.0)
    rows[gfwd.name] = _measure(gfwd.name, label, cd, lambda: gfwd(*gops),
                               lambda: fused_gated_sae.fused_gated_forward_plain(*gops),
                               _act_fwd_library(fused_gated_sae, gops), 6.0 * t * c * h,
                               nbytes(*gops) + nbytes(*out_p[:4]) + 4, err)
    del out_k, out_p
    bops = _gated_bwd_operands(gops, t, c, h)
    g_k, g_p = gbwd(*bops), fused_gated_sae.backward_plain(*bops)
    log(f"[mesh] {gbwd.name} [{label}] vs plain")
    gpair = _gated_route(cd, c) == "pair"
    if cd == torch.bfloat16:
        for _ in range(REPEATS - 1 if gpair else 1):
            _repeatable(gbwd.name, g_k, gbwd(*bops))
        if gpair:
            log(f"[mesh]   {gbwd.name}: {REPEATS} launches on the cluster pair bitwise equal")
    err = max(_check(n, a, b, 1e-3, 1e-4) for n, a, b in zip(GATED_GRADS, g_k, g_p))
    moved = nbytes(*bops) + nbytes(*g_p)
    del g_k, g_p
    rows[gbwd.name] = _measure(gbwd.name, label, cd, lambda: gbwd(*bops),
                               lambda: fused_gated_sae.backward_plain(*bops),
                               _gated_bwd_library(bops), 10.0 * t * c * h, moved, err)
    if cd == torch.bfloat16 and gpair:  # row 18 beside coder_bwd_tc
        _route_timing(gbwd.name, label, "pair", lambda **kw: gbwd(*bops, **kw))
    del bops, gops, x, wg
    rows.update(_tp_jumprelu_rows(cd, label))
    rows.update(_tp_matryoshka_rows(cd, label))
    return rows


def _tp_jumprelu_rows(cd, label: str) -> dict:
    """Rows 19-20: the JumpReLU TP wrappers at the shard, as kernels_jumprelu."""
    t, c, h = SHARD_T, C, SHARD_H
    jfwd, jbwd = fused_sae_tp.jumprelu_fwd_kernel, fused_sae_tp.jumprelu_bwd_kernel
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = init_jumprelu_sae(gen, c, h // c)
    x, we, bd = _exact_inputs(gen, t, params["W_enc"])
    thr = 0.5 + torch.rand(h, device=DEVICE, generator=gen)  # pre has std ~2 here
    ops = (x.to(cd), we.to(cd), _odd_grid(gen, h, 100), thr,
           params["W_dec"].to(cd).contiguous(), bd)
    out_p, err = _act_fwd_check(fused_jumprelu_sae, "mesh, " + label, cd, ops, kernel=jfwd)
    rows = {jfwd.name: _measure(jfwd.name, label, cd, lambda: jfwd(*ops),
                                lambda: fused_jumprelu_sae.fused_jumprelu_forward_plain(*ops),
                                _act_fwd_library(fused_jumprelu_sae, ops), 4.0 * t * c * h,
                                nbytes(*ops) + nbytes(*out_p[:3]) + 4, err)}
    del out_p
    bops = _jumprelu_bwd_operands(ops, t, c)
    pair = _jump_route(cd, c) == "pair"
    g_p, err = _act_bwd_check(fused_jumprelu_sae, "mesh, " + label, cd, bops, JUMPRELU_GRADS,
                              REPEATS if pair else 2, kernel=jbwd)
    moved = nbytes(*bops[:-1]) + nbytes(*g_p)
    del g_p
    rows[jbwd.name] = _measure(jbwd.name, label, cd, lambda: jbwd(*bops),
                               lambda: fused_jumprelu_sae.backward_plain(*bops),
                               _jumprelu_bwd_library(bops), 8.0 * t * c * h, moved, err)
    if pair:
        _route_timing(jbwd.name, label, "pair", lambda **kw: jbwd(*bops, **kw))
    return rows


def _tp_matryoshka_rows(cd, label: str) -> dict:
    """Rows 21-22: the Matryoshka TP wrappers at the shard and MESH_UNION, as
    kernels_matryoshka."""
    t, c, h = SHARD_T, C, SHARD_H
    fm = fused_matryoshka_sae
    mfwd, mbwd = fused_sae_tp.matryoshka_fwd_kernel, fused_sae_tp.matryoshka_bwd_kernel
    ops = _relu_exact_operands(cd, t, c, h)
    x, we, be, wd, bd = ops
    u = MESH_UNION
    label = f"{label}, union {u}"
    x_cent, out_p, err = _sae_fwd_check(fm, "mesh, " + label, cd, ops, (u,), exact=True,
                                        kernel=mfwd)
    xc = x - bd.to(cd)
    post = torch.relu(xc @ we).to(cd)
    rows = {mfwd.name: _measure(
        mfwd.name, label, cd, lambda: mfwd(*ops, u), lambda: fm.fused_matryoshka_forward_plain(
            *ops, u), lambda: (xc @ we, *(post[:, :m] @ wd[:m] for m in u)), 4.0 * t * c * h,
        nbytes(*ops) + nbytes(*out_p[:3]) + 4, err)}
    s = _suffix_error(out_p[0], x, cd)
    del out_p
    coeffs = torch.tensor([1.0, LAMBDA / (T * H)], device=DEVICE)
    g_p, err = _sae_bwd_check(fm, "mesh, " + label, cd, ops, x_cent, s, coeffs, (u,),
                              kernel=mbwd)
    moved = nbytes(*ops, s, coeffs) + nbytes(*g_p)
    del g_p
    dr = s[0]
    rows[mbwd.name] = _measure(
        mbwd.name, label, cd, lambda: mbwd(x_cent, we, be, wd, s, coeffs, u),
        lambda: fm.fused_matryoshka_backward_plain(*ops, s, coeffs, u),
        lambda: (xc @ we, dr @ wd.T, xc.T @ post, post.T @ dr), 8.0 * t * c * h, moved, err)
    if cd == torch.bfloat16 and _sae_route(cd, c, len(u)) == "pair":  # row 22
        _route_timing(mbwd.name, label, "pair",
                      lambda **kw: mbwd(x_cent, we, be, wd, s, coeffs, u, **kw))
    return rows


def _tp_coder_rows(cd, tag: str) -> dict:
    """Rows 23-26: the coders' TP wrappers on the card at a (2, 2) rank's shard
    (the transcoder T 16,384, 256 -> 480, H 8,192; the crosscoder T 8,192, ΣC
    2,896, H 4,096) against their plain versions, timed beside their bounds
    and the stock path's cuBLAS products; bf16 launches repeat bitwise."""
    rows = kernels_transcoder(cd, f"{tag}, shard T={TC_SHARD_T} H={TC_SHARD_H}", TC_SHARD_T,
                              TC_SHARD_H, fused_transcoder.TP_KERNELS)
    rows.update(kernels_crosscoder(cd, f"{tag}, shard T={CC_SHARD_T} H={CC_SHARD_H}",
                                   CC_SHARD_T, CC_SHARD_H, fused_crosscoder.TP_KERNELS))
    return rows


def _op_inputs(name: str, cd):
    """The north-star shape's inputs of ``name``'s op (T 32,768, C 256, H
    16,384), the same on every rank: a seeded generator on the card. The
    JumpReLU thresholds are uniform in MESH_THETA."""
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    init = init_gated_sae if name == "gated_sae" else init_sae_mlp
    params = init(gen, C, H // C)
    if name == "gated_sae":
        params["r_mag"] = 0.1 * torch.randn(H, device=DEVICE, generator=gen)
    if name == "jumprelu_sae":
        lo, hi = MESH_THETA
        params["log_threshold"] = torch.log(lo + (hi - lo) * torch.rand(
            H, device=DEVICE, generator=gen))
    x = torch.relu(torch.randn(T, C, device=DEVICE, generator=gen)) * 0.5
    return params, x


def _mesh_op_pairs(cd):
    """(name, TP loss terms, single-rank loss terms) of (a), each
    ``f(params, x, mesh_or_none)``. The TopK op's single-rank counterpart in
    f32 is the one-rank fast path; in bf16, where that path has no compute
    dtype, the TP op on a mesh of one rank (no collective)."""
    from sparse_vision_tpu_torch.ops.fast_topk_sae import fast_topk_sae_tp_loss_terms
    from sparse_vision_tpu_torch.parallel.mesh import Mesh

    one = Mesh((1, 1), 0, {"data": None, "model": None}, DEVICE)
    kw = dict(compute_dtype=cd)
    jr = dict(kw, bandwidth=MESH_BANDWIDTH)
    mat = dict(kw, prefixes=MESH_PREFIXES)
    topk_one = ((lambda p, x: fast_topk_sae_loss_terms(p, x, LAMBDA, H // C, TK_K))
                if cd == torch.float32 else
                (lambda p, x: fast_topk_sae_tp_loss_terms(p, x, LAMBDA, H // C, one, k=TK_K,
                                                          compute_dtype=cd)))
    return (
        ("sae_mlp", lambda p, x, m: fused_sae_tp.fused_sae_tp_loss_terms(
            p, x, LAMBDA, H // C, m, **kw),
         lambda p, x: fused_sae.fused_sae_loss_terms(p, x, LAMBDA, H // C, **kw)),
        ("gated_sae", lambda p, x, m: fused_sae_tp.fused_gated_sae_tp_loss_terms(
            p, x, LAMBDA, H // C, m, **kw),
         lambda p, x: fused_gated_sae.fused_gated_sae_loss_terms(p, x, LAMBDA, H // C, **kw)),
        ("jumprelu_sae", lambda p, x, m: fused_sae_tp.fused_jumprelu_sae_tp_loss_terms(
            p, x, LAMBDA_J, H // C, m, **jr),
         lambda p, x: fused_jumprelu_sae.fused_jumprelu_sae_loss_terms(
             p, x, LAMBDA_J, H // C, **jr)),
        ("matryoshka_sae", lambda p, x, m: fused_sae_tp.fused_matryoshka_sae_tp_loss_terms(
            p, x, LAMBDA, H // C, m, **mat),
         lambda p, x: fused_matryoshka_sae.fused_matryoshka_sae_loss_terms(
             p, x, LAMBDA, H // C, **mat)),
        ("topk_sae", lambda p, x, m: fast_topk_sae_tp_loss_terms(
            p, x, LAMBDA, H // C, m, k=TK_K, compute_dtype=cd), topk_one),
    )


def _coder_op_inputs(name: str):
    """Phase 6's whole-batch inputs of the coder ``name``'s op (the transcoder T
    32,768, 256 -> 480, H 16,384 with a target y; the crosscoder T 16,384 over
    CC_DIMS, H 8,192), the same on every rank, b_enc and b_dec drawn small and
    non-zero: (params, inputs)."""
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    if name == "transcoder":
        params = init_transcoder(gen, TC_CIN, TC_H // TC_CIN, TC_COUT)
        inputs = (torch.relu(torch.randn(TC_T, TC_CIN, device=DEVICE, generator=gen)) * 0.5,
                  0.5 * torch.randn(TC_T, TC_COUT, device=DEVICE, generator=gen))
    else:
        params = init_crosscoder(gen, CC_DIMS, CC_H // CC_DIMS[0])
        inputs = tuple(torch.relu(torch.randn(CC_T, d, device=DEVICE, generator=gen)) * 0.5
                       for d in CC_DIMS)
    for k, v in params.items():
        if k == "b_enc" or k.startswith("b_dec"):
            params[k] = 0.02 * torch.randn(v.shape, device=DEVICE, generator=gen)
    return params, inputs


def _coder_op_pairs(cd):
    """(name, TP loss terms f(params, rows, mesh), single-rank loss terms
    f(params, inputs)) of the coders in (a)."""
    kw = dict(compute_dtype=cd)
    tc_ef, cc_ef = TC_H // TC_CIN, CC_H // CC_DIMS[0]
    return (
        ("transcoder", lambda p, r, m: fused_transcoder.fused_transcoder_tp_loss_terms(
            p, *r, LAMBDA, tc_ef, m, **kw),
         lambda p, i: fused_transcoder.fused_transcoder_loss_terms(p, *i, LAMBDA, tc_ef, **kw)),
        ("crosscoder", lambda p, r, m: fused_crosscoder.fused_crosscoder_tp_loss_terms(
            p, r, LAMBDA, cc_ef, m, **kw),
         lambda p, i: fused_crosscoder.fused_crosscoder_loss_terms(p, i, LAMBDA, cc_ef, **kw)),
    )


def _mesh_ops(mesh) -> dict:
    """(a) on a rank: each TP op on this rank's shard and, on rank 0, the
    single-rank op on the whole batch; the gathered loss terms, gradients and
    statistics held to it (the coders' global rmse and nrmse too). Returns
    rank 0's max errors."""
    out = {}
    for cd in (torch.float32, torch.bfloat16):
        for name, tp_terms, terms in _mesh_op_pairs(cd):
            params, x = _op_inputs(name, cd)
            _hold_op(mesh, out, name, cd, params, (x,),
                     lambda p, r, m, f=tp_terms: f(p, r[0], m),
                     lambda p, i, f=terms: f(p, i[0]), ())
            del params, x
        for name, tp_terms, terms in _coder_op_pairs(cd):
            params, inputs = _coder_op_inputs(name)
            _hold_op(mesh, out, name, cd, params, inputs, tp_terms, terms,
                     ("nrmse_loss", "rmse_loss"))
            del params, inputs
    return out


def _hold_op(mesh, out: dict, name: str, cd, params: dict, inputs: tuple, tp_terms, terms,
             metrics: tuple) -> None:
    """One case of (a): ``tp_terms(shard, rows, mesh)`` on this rank, and on
    rank 0 ``terms(params, inputs)``, the loss terms (and the ``metrics``),
    gradients, counts and reconstruction held to it; rank 0's max errors into
    ``out``."""
    from sparse_vision_tpu_torch.parallel.mesh import gather_params, shard_params
    from sparse_vision_tpu_torch.parallel.sharded_steps import put_tokens_sharded

    set_tf32(False)
    local = {k: v.requires_grad_(True) for k, v in shard_params(params, mesh).items()}
    got = tp_terms(local, tuple(put_tokens_sharded(mesh, a) for a in inputs), mesh)
    got["loss"].backward()
    grads = gather_params({k: v.grad for k, v in local.items()}, mesh)
    dead = mesh.gather(got["dead"], 0)
    freq = mesh.gather(got["activity_freq"], 0)
    if mesh.rank != 0:
        del got, grads, local
        return
    full = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    want = terms(full, inputs)
    want["loss"].backward()
    torch.cuda.synchronize()
    rtol, atol = MESH_OP_TOL[cd]
    tag = f"{name} {str(cd).removeprefix('torch.')}"
    errs = {}
    for k in ("loss", "rec_loss", "l1_loss", "aux_loss", "sparsity", "l0_loss") + metrics:
        if k not in want:
            continue
        a, b = got[k].item(), want[k].item()
        errs[k] = abs(a - b)
        if abs(a - b) > MESH_LOSS_RTOL[cd] * abs(b) + 1e-12:
            raise AssertionError(f"[mesh] (a) {tag}: {k} {a} vs single-rank {b}")
    for k, v in grads.items():
        e = (v - full[k].grad).abs().max().item()
        scale = full[k].grad.abs().max().item()
        errs[f"d{k}"] = e
        bad = ((v - full[k].grad).abs() > rtol * full[k].grad.abs() + atol * scale)
        if bool(bad.any()):
            raise AssertionError(f"[mesh] (a) {tag}: d{k} off the single-rank op by "
                                 f"{e:.3e} (max {scale:.3e}) at {int(bad.sum())} entries")
    if not (torch.equal(dead, want["dead"]) and torch.equal(
            freq, want["activity_freq"].to(freq.dtype))):
        raise AssertionError(f"[mesh] (a) {tag}: dead / activity_freq differ")
    if "decoded" in want:  # the crosscoder's op hands out no reconstruction
        rows = put_tokens_sharded(mesh, want["decoded"])  # rank 0's token rows
        errs["decoded"] = (got["decoded"] - rows).abs().max().item()
        if errs["decoded"] > atol * rows.abs().max().item() + 1e-30:
            raise AssertionError(f"[mesh] (a) {tag}: recon off the single-rank op by "
                                 f"{errs['decoded']:.3e}")
    log(f"[mesh] (a) {tag} ({SHARING}): TP op vs single-rank op, max abs err "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    out[tag] = errs
    del want, full, got, grads, local
    torch.cuda.empty_cache()


def _time_collectives(mesh, t_l: int, c: int, h_l: int, reps: int = 5) -> float:
    """Host ms of one TP step's collectives at this shard (the four all_reduces
    of the op, of their sizes, and perc_dead's), each ending in a synchronize."""
    bufs = [("model", t_l * c + t_l + 1), ("data", h_l + 4), ("data", 2 * c * h_l + h_l + 2 * c),
            ("model", c), ("model", 1)]
    tensors = [(a, torch.zeros(n, device=DEVICE)) for a, n in bufs]

    def one():
        for axis, buf in tensors:
            mesh.psum(buf, axis)
        torch.cuda.synchronize()

    one()
    mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        one()
    return (time.perf_counter() - t0) / reps * 1e3


def _pre_max(params: dict, x, cd, center: bool = True) -> torch.Tensor:
    """Per latent, the largest pre-activation (the gate's for gated_sae) over
    the tokens of ``x``, from the operands as the kernels read them (x −
    round(b_dec) with ``center``, and the weights in ``cd``), in f32 products.
    A tuple ``x`` is the crosscoder's layers, read in the cat space."""
    if isinstance(x, tuple):  # the crosscoder: no centring
        n = len(x)
        x = torch.cat(x, 1)
        params = {"W_enc": torch.cat([params[f"W_enc_{i}"] for i in range(n)], 0),
                  "b_enc": params["b_enc"]}
        center = False
    enc, bias = ("W_enc", "b_enc") if "W_enc" in params else ("W_gate", "b_gate")
    w = params[enc].detach().to(cd).float()
    shift = params["b_dec"].detach().to(cd) if center else 0.0
    peak = None
    for rows in x.split(4096):
        got = ((rows.to(cd) - shift).float() @ w).amax(0)
        peak = got if peak is None else torch.maximum(peak, got)
    return peak + params[bias].detach().float()


@contextlib.contextmanager
def _recording(mesh=None, pre_max: bool = False):
    """What a Pipeline.run in the block did: "dead", the dead masks (whole, on
    the host) that each resample read, in order (a TP rank gathers its
    shard's: every rank resamples at the same step); with ``pre_max`` (one
    rank), "pre_max", each step's _pre_max [steps, H], and "at", the step of
    each resample."""
    from sparse_vision_tpu_torch.parallel import tensor_parallel
    from sparse_vision_tpu_torch.train import crosscoder as tcrosscoder
    from sparse_vision_tpu_torch.train import transcoder as ttranscoder

    seen = {"dead": [], "pre_max": [], "at": []}

    def wrap_resample(fn):
        def resample(params, opt_state, dead, *args, **kw):
            full = dead if mesh is None or mesh.size("model") == 1 else mesh.gather(dead, 0)
            seen["dead"].append(full.cpu())
            seen["at"].append(len(seen["pre_max"]))
            return fn(params, opt_state, dead, *args, **kw)
        return resample

    def wrap_terms(fn, center):
        def terms(params, x, *args, **kw):
            with torch.no_grad():
                cd = fused_sae.compute_dtype_of(kw.get("compute_dtype", torch.bfloat16))
                seen["pre_max"].append(_pre_max(params, x, cd, center).cpu())
            return fn(params, x, *args, **kw)
        return terms

    # (module, name, wrapper): every trainer's resample, each one-rank op whose
    # pre-activations _window_peak reads (the coders' uncentred)
    patches = [(tsteps, "resample_sae", wrap_resample),
               (ttranscoder, "resample_sae", wrap_resample),
               (tcrosscoder, "_resample", wrap_resample),
               (tensor_parallel, "resample_sae_tp", wrap_resample),
               (tcrosscoder, "resample_crosscoder_tp", wrap_resample)]
    if pre_max:
        patches += [(fused_sae, "fused_sae_loss_terms", lambda f: wrap_terms(f, True)),
                    (fused_gated_sae, "fused_gated_sae_loss_terms",
                     lambda f: wrap_terms(f, True)),
                    (fused_transcoder, "fused_transcoder_loss_terms",
                     lambda f: wrap_terms(f, False)),
                    (fused_crosscoder, "fused_crosscoder_loss_terms",
                     lambda f: wrap_terms(f, False))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, wrap in patches:
        setattr(mod, name, wrap(getattr(mod, name)))
    try:
        yield seen
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def _collective_seconds():
    """The host seconds that the block's collectives take on this rank (every
    all_reduce of parallel/mesh.Mesh, each through ``_reduce_``; the time
    includes waiting for the other ranks), but for those of the Pipeline's
    gathers of the whole state before and after the epoch: yields a dict
    whose "s" grows."""
    from sparse_vision_tpu_torch.parallel.mesh import Mesh
    from sparse_vision_tpu_torch.train.pipeline import Pipeline as _Pipeline

    spent = {"s": 0.0, "gathering": False}
    saved_reduce, saved_full = Mesh._reduce_, _Pipeline._full_state

    def timed(self, out, axis, op):
        t0 = time.perf_counter()
        try:
            return saved_reduce(self, out, axis, op)
        finally:
            if not spent["gathering"]:
                spent["s"] += time.perf_counter() - t0

    def full_state(self):
        spent["gathering"] = True
        try:
            return saved_full(self)
        finally:
            spent["gathering"] = False

    Mesh._reduce_, _Pipeline._full_state = timed, full_state
    try:
        yield spent
    finally:
        Mesh._reduce_, _Pipeline._full_state = saved_reduce, saved_full


def _replicated_moments(ts) -> dict:
    """The Adam moments of the replicated parameters (b_dec, each b_dec_i) of
    a train state, on the host."""
    from sparse_vision_tpu_torch.parallel.mesh import param_axes

    keys = [k for k, axis in param_axes(ts.params).items() if axis is None]
    return {f"{part} {k}": ts.opt_state[part][k].cpu() for part in ("mu", "nu") for k in keys}


def _mesh_run(mesh, name: str, kernels, extra: dict | None = None) -> dict:
    """(b)-(d), (h), (i) on a rank: Pipeline.run of phase 6's ``name`` config
    (with the fields ``extra``) on the mesh, every launch count (``kernels``'
    and the cluster pair's bodies') set to 0 just before and read just after,
    the pair body its backward runs, and the host seconds of its collectives. Rank
    0 returns the whole final state, the replicated parameters' Adam moments
    and the resamples' dead masks too."""
    cfg, datasets = _slice_config(name, dict(mesh_shape=mesh.shape,
                                             directory_path=str(MESH_WORK), **(extra or {})))
    pipe = Pipeline(cfg, mesh=mesh, datasets=datasets)
    kernels = tuple(kernels) + PAIR_KERNELS  # the pair's body under the SAEs' backwards too
    for k in kernels:
        k.launches = 0
    pair_body = _slice_pair_body(name, cfg, pipe.ts.params)
    t0 = time.perf_counter()
    with _recording(mesh) as rec, _collective_seconds() as coll:
        pipe.run()
    wall = time.perf_counter() - t0
    out = {"launches": {k.name: k.launches for k in kernels}, "wall": wall,
           "pair_body": pair_body.name if pair_body else None,
           "timing": pipe.train_timing[0], "collective_s": coll["s"],
           "log": [(s, {k: float(v) for k, v in m.items()}) for s, m in pipe.train_log]}
    if mesh.rank == 0:
        out.update(params=pipe.ts.params, dead=pipe.ts.dead_acc, resampled=rec["dead"],
                   moments=_replicated_moments(pipe.ts))
    del pipe
    torch.cuda.empty_cache()
    return out


def _mesh_rank(rank: int, mesh, job: str) -> dict:
    """One rank of phase 15's worlds: ``job`` "tp" runs (a), (b), (c), (g) and
    the collective timing of (e) on (2, 2); "dp" runs (d) on (2,)."""
    set_tf32(False)
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for the backbone convs
    if job == "dp":
        out = {"sae_mlp": _mesh_run(mesh, "sae_mlp", KERNELS)}
        for name, (_, single) in MESH_CODERS.items():
            out[name] = _mesh_run(mesh, name, single)
        return out
    out = {"ops": _mesh_ops(mesh)}
    for name, extra in MESH_RUNS.items():
        out[name] = _mesh_run(mesh, name, TP_KERNELS, extra)
    for name, (tp, _) in MESH_CODERS.items():
        out[name] = _mesh_run(mesh, name, tp)
    out["collectives_ms"] = _time_collectives(mesh, SHARD_T, C, SHARD_H)
    return out


def _mesh_fail(rank: int, mesh) -> None:
    """(f): rank 3 raises; the other ranks wait in a collective it never joins."""
    if rank == 3:
        raise RuntimeError("rank 3 of the failure check raises on purpose")
    mesh.barrier()


def _one_rank_run(name: str, extra: dict | None = None) -> dict:
    """The one-rank run of phase 6's ``name`` config (with the fields
    ``extra``) in MESH_WORK (its cache is the one the mesh runs then read):
    final state on the host, steps, the resamples' dead masks and steps, and
    each step's largest pre-activation per latent (_recording)."""
    set_tf32(False)
    torch.backends.cudnn.allow_tf32 = True
    cfg, datasets = _slice_config(name, dict(directory_path=str(MESH_WORK), **(extra or {})))
    pipe = Pipeline(cfg, datasets=datasets)
    t0 = time.perf_counter()
    with _recording(pre_max=True) as rec:
        pipe.run()
    log(f"[mesh] {name} {cfg.compute_dtype} one rank: Pipeline.run in "
        f"{time.perf_counter() - t0:.1f} s; training loop "
        f"{pipe.train_timing[0]['tokens'] / pipe.train_timing[0]['seconds']:.0f} tokens/s")
    out = {"params": {k: v.cpu() for k, v in pipe.ts.params.items()},
           "dead": pipe.ts.dead_acc.cpu(), "resampled": rec["dead"], "at": rec["at"],
           "moments": _replicated_moments(pipe.ts),
           # the runs of the ops that record it (the variants that read it:
           # _window_peak): ReLU, gated, the coders
           "pre_max": torch.stack(rec["pre_max"]) if rec["pre_max"] else None,
           "log": [(s, {k: float(v) for k, v in m.items()}) for s, m in pipe.train_log]}
    del pipe
    torch.cuda.empty_cache()
    return out


def _latent_diff(params: dict, ref: dict) -> torch.Tensor:
    """Per latent, the largest |difference| over its parameters (encoder
    columns, decoder rows, per-latent vectors); b_dec is no latent's."""
    from sparse_vision_tpu_torch.parallel.mesh import param_axes

    worst = None
    for k, axis in param_axes(ref).items():
        if axis is None:
            continue
        d = (params[k] - ref[k]).abs()
        d = d.amax(dim=1 - axis) if d.dim() == 2 else d
        worst = d if worst is None else torch.maximum(worst, d)
    return worst


def _window_peak(ref: dict, i: int) -> torch.Tensor:
    """Per latent, the one-rank run's largest pre-activation over the steps
    that fed resample ``i``'s dead mask: those after the last restart of the
    accumulator (perc_dead 1) up to the resample's own."""
    at = ref["at"][i]
    start = max((s for s, m in ref["log"] if s < at and m["perc_dead"] == 1.0), default=0)
    return ref["pre_max"][start:at].amax(0)


def _check_mesh_run(label: str, name: str, ranks: list, ref: dict, kernels,
                    want: int) -> None:
    """A mesh run's ranks against the one-rank run ``ref`` of variant
    ``name`` (the tolerances' comment): 12 steps, every rank's ``kernels``
    launched ``want`` times and of the cluster pair's bodies its run's own
    (_slice_pair_body) ``want`` times and the others never, the restarts at
    the same steps, each step's loss
    terms within MESH_STEP_RTOL (MESH_STEP_RTOL_BY) and perc_dead within
    MESH_DEAD_ATOL, rank
    0's final dead accumulator equal, the resamples at the same steps with
    their dead masks apart at no more than MESH_FLIPS_MAX latents, each at the
    margin, the other latents' parameters and b_dec within
    MESH_PARAM_LIMITS, and the replicated parameters' Adam moments within
    MESH_MOMENT_LIMITS. Logs every reading first (with rank 0's host ms of
    collectives a step), then raises with every check that failed."""
    from sparse_vision_tpu_torch.parallel.mesh import param_axes

    bad = []
    for r, res in enumerate(ranks):
        launches = res["launches"]
        # rank 0's loop: the other ranks start theirs while rank 0 still evaluates
        loop = "" if r else (f"; training loop {res['timing']['tokens'] / res['timing']['seconds']:.0f}"
                             f" tokens/s ({SHARING})")
        log(f"[mesh] {label} rank {r}: launches {launches}; Pipeline.run {res['wall']:.1f} s; "
            f"collectives {res['collective_s'] * 1e3 / max(len(res['log']), 1):.1f} ms a step "
            f"(host, waits included, the state gathers left out)" + loop)
        bad += [f"rank {r}: {launches[k.name]} launches of {k.name}, expected {want}"
                for k in kernels if launches[k.name] != want]
        # the cluster pair's body counters: the run's own (where bwd_route gives
        # its shard the pair) launched ``want`` times, the others never
        bad += [f"rank {r}: {launches[k.name]} launches of {k.name}, expected "
                f"{want if k.name == res['pair_body'] else 0}"
                for k in PAIR_KERNELS if launches[k.name] != (
                    want if k.name == res["pair_body"] else 0)]
        if len(res["log"]) != 12:
            bad.append(f"rank {r}: {len(res['log'])} steps, expected 12")
    step_rtol = {**MESH_STEP_RTOL, **MESH_STEP_RTOL_BY.get(name, {})}
    worst = dict.fromkeys(step_rtol, 0.0)
    dead_gap = 0.0
    failed = set()  # the loss terms already reported, at their first failing step
    for (s, m), (s1, m1) in zip(ranks[0]["log"], ref["log"]):
        log(f"[mesh] {label} step {s}: " + ", ".join(
            f"{k} {m[k]:.6g} (one rank {m1[k]:.6g})" for k in m1))
        if (m["perc_dead"] == 1.0) != (m1["perc_dead"] == 1.0):
            bad.append(f"the dead accumulator restarts at step {s} on one run only")
        dead_gap = max(dead_gap, abs(m["perc_dead"] - m1["perc_dead"]))
        for k, rtol in step_rtol.items():
            rel = abs(m[k] - m1[k]) / abs(m1[k])
            worst[k] = max(worst[k], rel)
            if rel > rtol and k not in failed:
                failed.add(k)
                bad.append(f"step {s} {k} {m[k]:.6g}, one rank {m1[k]:.6g} ({rel:.2e} "
                           f"relative, limit {rtol:g})")
    log(f"[mesh] {label} steps against the one-rank run: largest relative gap "
        + ", ".join(f"{k} {v:.3e} (limit {step_rtol[k]:g})" for k, v in worst.items())
        + f"; perc_dead {dead_gap:.3e} (limit {MESH_DEAD_ATOL:g})")
    if dead_gap > MESH_DEAD_ATOL:
        bad.append(f"perc_dead {dead_gap:.3e} off the one-rank run's")
    top = ranks[0]
    if not torch.equal(top["dead"], ref["dead"]):
        bad.append(f"dead accumulator differs from the one-rank run's "
                   f"({int((top['dead'] != ref['dead']).sum())} latents)")
    if len(top["resampled"]) != len(ref["resampled"]):
        bad.append(f"{len(top['resampled'])} resamples, one rank {len(ref['resampled'])}")
    flipped = torch.zeros_like(ref["dead"])
    for i, (a, b) in enumerate(zip(top["resampled"], ref["resampled"])):
        apart = a != b
        flipped |= apart
        peak = _window_peak(ref, i)
        scale = peak.abs().median().item()
        ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
        margin = peak[apart].abs() / ulp
        shown = MESH_FLIPS_MAX  # the first ones of a longer list
        log(f"[mesh] {label} resample {i + 1} (step {ref['at'][i]}): {int(b.sum())} dead "
            f"latents on one rank, {int(a.sum())} on the mesh, {int(apart.sum())} apart; "
            f"their largest pre-activations in the window "
            f"{[round(v, 7) for v in peak[apart][:shown].tolist()]}, "
            f"{[round(v, 3) for v in margin[:shown].tolist()]} bf16 ulps at the median "
            f"latent's {scale:.4g} (ulp {ulp:.3g}; largest "
            f"{margin.max().item() if margin.numel() else 0.0:.3g}, limit {MESH_MARGIN_ULPS:g})")
        if bool((margin > MESH_MARGIN_ULPS).any()):
            bad.append(f"resample {i + 1}: a latent resampled in one run only sits "
                       f"{margin.max().item():.3g} bf16 ulps from 0")
    if int(flipped.sum()) > MESH_FLIPS_MAX:
        bad.append(f"the resamples' dead masks differ at {int(flipped.sum())} latents")
    gap = _latent_diff(top["params"], ref["params"])[~flipped]
    b_dec = max((top["params"][k] - ref["params"][k]).abs().max().item()  # each b_dec_i
                for k, axis in param_axes(ref["params"]).items() if axis is None)
    got = (gap.median().item(), torch.quantile(gap, 0.99).item(), b_dec)
    log(f"[mesh] {label} parameters against the one-rank run: per latent max "
        f"{gap.max().item():.3e}, median {got[0]:.3e}, 99th percentile {got[1]:.3e}, "
        f"{int((gap > 1e-4).sum())} of {gap.numel()} latents above 1e-4 "
        f"({int(flipped.sum())} resampled in one run only, not held); b_dec {b_dec:.3e} "
        f"(limits {MESH_PARAM_LIMITS[name]})")
    bad += [f"parameters' {what} {v:.3e} off the one-rank run (limit {lim:g})"
            for what, v, lim in zip(("median latent gap", "99th percentile latent gap",
                                     "b_dec gap"), got, MESH_PARAM_LIMITS[name]) if v > lim]
    moments = {k: ((top["moments"][k] - v).abs().max()
                   / v.abs().max().clamp(min=1e-30)).item() for k, v in ref["moments"].items()}
    worst_m = max(moments.values())
    log(f"[mesh] {label} Adam moments of the replicated parameters against the one-rank "
        "run, largest gap relative to the largest entry: "
        + ", ".join(f"{k} {v:.3e}" for k, v in moments.items())
        + f" (limit {MESH_MOMENT_LIMITS[name]:g})")
    if worst_m > MESH_MOMENT_LIMITS[name]:
        bad.append(f"Adam moments of the replicated parameters {worst_m:.3e} off the one-rank "
                   f"run (limit {MESH_MOMENT_LIMITS[name]:g})")
    if bad:
        raise AssertionError(f"{label}: " + "; ".join(bad))


def phase_mesh(smi: str) -> dict:
    """Phase 15 (the module docstring). Returns the TP kernels' rows, their
    launches summed over the ranks of (b), (c), (g) and (h)."""
    from sparse_vision_tpu_torch.parallel.distributed import RankError, spawn

    t_phase = time.perf_counter()
    shutil.rmtree(MESH_WORK, ignore_errors=True)
    set_tf32(False)
    rows = {}
    for cd, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        got = _tp_kernel_rows(cd, tag)
        got.update(_tp_coder_rows(cd, tag))
        if cd == torch.bfloat16:
            rows = got
    torch.cuda.empty_cache()
    ref = {name: _one_rank_run(name, extra) for name, extra in MESH_RUNS.items()}
    ref.update({name: _one_rank_run(name) for name in MESH_CODERS})

    t0 = time.perf_counter()
    ranks = spawn(_mesh_rank, MESH, "tp", device=DEVICE, backend="gloo",
                  timeout_s=MESH_TIMEOUT_S)
    log(f"[mesh] world {MESH} ({SHARING}, {torch.cuda.get_device_name(0)}): "
        f"{time.perf_counter() - t0:.1f} s")
    for name, part in zip(MESH_RUNS, ("(b)", "(c)", "(g)", "(g)", "(g)")):
        _check_mesh_run(f"{part} {name} (2, 2)", name, [r[name] for r in ranks], ref[name],
                        MESH_RUN_KERNELS[name], 12)
    for name, (tp, _) in MESH_CODERS.items():
        _check_mesh_run(f"(h) {name} (2, 2)", name, [r[name] for r in ranks], ref[name], tp, 12)
    for k in TP_KERNELS:
        rows[k.name]["launches"] = sum(r[n]["launches"][k.name] for r in ranks
                                       for n in MESH_RUNS)
    for name, (tp, _) in MESH_CODERS.items():
        for k in tp:
            rows[k.name]["launches"] = sum(r[name]["launches"][k.name] for r in ranks)
    coll = [r["collectives_ms"] for r in ranks]
    log(f"[mesh] (e) one TP step's collectives at the shard (T {SHARD_T}, C {C}, H {SHARD_H}): "
        + ", ".join(f"rank {r} {ms:.2f} ms" for r, ms in enumerate(coll))
        + f" ({SHARING}: a number for gloo on one card, not for several cards; {smi})")
    del ranks

    t0 = time.perf_counter()
    dp = spawn(_mesh_rank, MESH_DP, "dp", device=DEVICE, backend="gloo",
               timeout_s=MESH_TIMEOUT_S)
    log(f"[mesh] world {MESH_DP} ({SHARING}): {time.perf_counter() - t0:.1f} s")
    _check_mesh_run("(d) sae_mlp (2,)", "sae_mlp", [r["sae_mlp"] for r in dp], ref["sae_mlp"],
                    (fused_sae.fwd_kernel, fused_sae.bwd_kernel), 12)
    for name, (_, single) in MESH_CODERS.items():
        _check_mesh_run(f"(i) {name} (2,)", name, [r[name] for r in dp], ref[name], single, 12)
    del dp, ref

    t0 = time.perf_counter()
    try:
        spawn(_mesh_fail, MESH, device=DEVICE, backend="gloo", timeout_s=MESH_FAIL_TIMEOUT_S)
    except RankError as e:
        if "raises on purpose" not in str(e):
            raise
        log(f"[mesh] (f) a rank that raises fails the world in "
            f"{time.perf_counter() - t0:.1f} s: {str(e).splitlines()[0]} "
            f"{str(e).strip().splitlines()[-1]}")
    else:
        raise AssertionError("[mesh] (f) a world with a failing rank returned")
    shutil.rmtree(MESH_WORK, ignore_errors=True)
    log(f"[mesh] {smi}: phase {time.perf_counter() - t_phase:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# sweep phase (16): the vmapped hyperparameter sweep (train/sweep_vmap.py)
# ---------------------------------------------------------------------------

SW_T, SW_C, SW_H = 4096, 256, 2048  # bench_sweep.py:147-152
SW_NS = (4, 8, 16)
SW_ROW_N = 8  # the N of the kernels line's rows 27-34 (and the repeats)
SW_RAGGED = (3, RAGGED_T, RAGGED_C, RAGGED_H)  # N, T, C, H: every edge partial
SWEEP_MODULES = {"sae_mlp": fused_sae, "gated_sae": fused_gated_sae,
                 "jumprelu_sae": fused_jumprelu_sae, "matryoshka_sae": fused_matryoshka_sae}
SWEEP_KERNELS = tuple(k for m in SWEEP_MODULES.values() for k in m.SWEEP_KERNELS)
SW_FLOPS = {"sae_mlp": (4, 8), "matryoshka_sae": (4, 8), "jumprelu_sae": (4, 8),
            "gated_sae": (6, 10)}  # forward, backward: multiples of T·C·H
SW_PREFIXES = (0.0625, 0.25, 1.0)  # matryoshka: levels at H/16, H/4, H
for _k in SWEEP_KERNELS:
    SOURCES[_k.name] = CODER
REPLACES.update({
    # the same pallas_calls under jax.vmap: the sweep step's call sites
    "fused_sae_sweep_fwd": "sparse_vision_tpu/train/sweep_vmap.py:171",
    "fused_sae_sweep_bwd": "sparse_vision_tpu/train/sweep_vmap.py:190",
    "fused_gated_sae_sweep_fwd": "sparse_vision_tpu/train/sweep_vmap.py:148",
    "fused_gated_sae_sweep_bwd": "sparse_vision_tpu/train/sweep_vmap.py:190",
    "fused_jumprelu_sae_sweep_fwd": "sparse_vision_tpu/train/sweep_vmap.py:156",
    "fused_jumprelu_sae_sweep_bwd": "sparse_vision_tpu/train/sweep_vmap.py:190",
    "fused_matryoshka_sae_sweep_fwd": "sparse_vision_tpu/train/sweep_vmap.py:164",
    "fused_matryoshka_sae_sweep_bwd": "sparse_vision_tpu/train/sweep_vmap.py:190",
})


def _sweep_ops(name: str, cd, n: int, t: int, c: int, h: int) -> tuple:
    """The forward operands of ``name``'s sweep kernel: x [t, c] shared and n
    combos' parameters, stacked, each combo its own draw on _exact_inputs' grid
    (so the kernel and cuBLAS see the same pre-activations, masks and gates);
    the Matryoshka boundaries come as the last operand."""
    gen = torch.Generator(device=DEVICE).manual_seed(n * 7919 + c)
    x, per = None, []
    for _ in range(n):
        w = torch.randn(c, h, device=DEVICE, generator=gen) / c ** 0.5
        xi, we, bd = _exact_inputs(gen, t, w)
        x = xi if x is None else x  # the first draw's tokens, shared
        wd = _dyadic(torch.randn(h, c, device=DEVICE, generator=gen) / h ** 0.5, 2.0 ** -8)
        be = _odd_grid(gen, h, 100)
        if name == "gated_sae":
            er = torch.exp(0.1 * torch.randn(h, device=DEVICE, generator=gen))
            per.append((we.to(cd), be, _odd_grid(gen, h, 60), er, wd.to(cd), bd))
        elif name == "jumprelu_sae":
            thr = 0.5 + torch.rand(h, device=DEVICE, generator=gen)
            per.append((we.to(cd), be, thr, wd.to(cd), bd))
        else:
            per.append((we.to(cd), be, wd.to(cd), bd))
    ops = (x.to(cd), *(torch.stack(v).contiguous() for v in zip(*per)))
    if name == "matryoshka_sae":  # the prefixes' counts rounded up to the kernels' 128
        ops += (tuple(sorted({min(h, -(-b // 128) * 128)
                              for b in matryoshka_prefix_counts(h, SW_PREFIXES)})),)
    return ops


def _combo(ops: tuple, i: int, shared: int = 1) -> tuple:
    """Combo i's operands of a sweep call: the first ``shared`` whole (the
    shared x), each stacked operand's slice i, the trailing non-tensor operands
    (the prefix boundaries, the STE bandwidth) as they are."""
    return (*ops[:shared], *(a[i] if torch.is_tensor(a) else a for a in ops[shared:]))


def _sweep_parts(name: str, outs: tuple, i: int, backward: bool) -> tuple:
    """Combo i of a sweep kernel's outputs, reduced as the one-dictionary
    kernel's wrapper reduces its own (the JumpReLU and gated wrappers sum
    their partials, the others return them)."""
    if name in ("sae_mlp", "matryoshka_sae"):
        return tuple(o[i] for o in outs)
    if backward:
        return (*(o[i] for o in outs[:-1]), outs[-1][i].sum(0))
    *heads, act, row, l1 = outs
    return (*(o[i] for o in heads), act[i].sum(0), row[i], l1[i].sum())


def _sweep_reduce(name: str, outs: tuple, backward: bool) -> tuple:
    """A sweep kernel's or plain version's outputs with every partial axis
    summed per combo (the comparable form of the two)."""
    if backward:
        return (*outs[:-1], outs[-1].sum(1))
    if name in ("sae_mlp", "matryoshka_sae"):
        x_cent, recon, act, row, z = outs
        return x_cent, recon, act.sum(1), row, z.sum((1, 2))
    *heads, act, row, l1 = outs
    return (*heads, act.sum(1), row, l1.sum((1, 2)))


# the plain versions (forward, backward) of each sweep op's kernels
SW_PLAIN = {
    "sae_mlp": (fused_sae.sae_sweep_fwd_plain, fused_sae.sae_sweep_bwd_plain),
    "matryoshka_sae": (fused_matryoshka_sae.matryoshka_sweep_fwd_plain,
                       fused_matryoshka_sae.matryoshka_sweep_bwd_plain),
    "jumprelu_sae": (fused_jumprelu_sae.jumprelu_sweep_fwd_plain,
                     fused_jumprelu_sae.jumprelu_sweep_bwd_plain),
    "gated_sae": (fused_gated_sae.gated_sweep_fwd_plain, fused_gated_sae.gated_sweep_bwd_plain),
}


def _sweep_bwd_ops(name: str, cd, ops: tuple, x_cent, plain_fwd: tuple) -> tuple:
    """The backward operands after the forward: the errors the ops save
    (residuals from the plain forward), per-combo coefficients with a λ of
    each combo's own."""
    n = ops[1].shape[0]
    t, c = ops[0].shape
    h = ops[1].shape[2]
    lam = LAMBDA * torch.arange(1, n + 1, device=DEVICE, dtype=torch.float32) / n
    ones = torch.ones(n, device=DEVICE)
    x = ops[0].float()
    if name == "sae_mlp":
        res = (plain_fwd[1] - x).to(cd)
        coeffs = torch.stack([ones * 2.0 / (t * c), lam / (t * h)], 1)
        return (x_cent, ops[1], ops[2], ops[3], res, coeffs)
    if name == "matryoshka_sae":
        prefix = plain_fwd[1]  # [N, P, T, C]
        p = prefix.shape[1]
        s = ((2.0 / (p * t * c)) * (prefix - x)).flip(1).cumsum(1).flip(1).to(cd)
        coeffs = torch.stack([ones, lam / (t * h)], 1)
        return (x_cent, ops[1], ops[2], ops[3], s, coeffs, ops[-1])
    if name == "jumprelu_sae":
        coeffs = torch.stack([ones * 2.0 / (t * c), LAMBDA_J * ones / t], 1)
        return ops + (plain_fwd[0] - x, coeffs, BANDWIDTH)
    coeffs = torch.stack([ones * 2.0 / (t * c), lam / (t * h), ones * 2.0 / (t * c)], 1)
    return ops + (plain_fwd[0] - x, plain_fwd[1] - x, coeffs)


def _sweep_library(name: str, ops: tuple, backward: bool):
    """The stock sweep path's batched cuBLAS products (torch.bmm) on the same
    stacked operands, as one call: the forward's encode and decode(s), the
    backward's dpost product(s) and the two weight gradients."""
    x, we = ops[0], ops[1]
    wd, bd = (ops[3], ops[4]) if name == "matryoshka_sae" else (ops[-2], ops[-1])
    xc = (x[None] - bd.to(x.dtype)[:, None]).contiguous()
    post = torch.relu(torch.bmm(xc, we)).to(x.dtype)  # an [N, T, H] operand of the stock path
    decodes = 2 if name == "gated_sae" else 1
    if not backward:
        return lambda: (torch.bmm(xc, we), *(torch.bmm(post, wd) for _ in range(decodes)))
    dr = xc  # any [N, T, C] operand of the compute dtype
    wdt = wd.transpose(1, 2)
    return lambda: (*(torch.bmm(dr, wdt) for _ in range(decodes)),
                    torch.bmm(xc.transpose(1, 2), post), torch.bmm(post.transpose(1, 2), dr))


def _sweep_route(name: str, cd, c: int, ops: tuple) -> str:
    """The body bwd_route gives ``name``'s sweep backward (one dictionary's
    width; the Matryoshka levels are ops' last operand)."""
    if name == "jumprelu_sae":
        return _jump_route(cd, c)
    if name in ("sae_mlp", "matryoshka_sae"):
        return _sae_route(cd, c, len(ops[-1]) if name == "matryoshka_sae" else 1)
    return fused_sae.bwd_route(c, c, act="gated", dtype=cd)


def _sweep_kernel_check(name: str, cd, n: int, t: int, c: int, h: int, timed: bool,
                        repeats: int = 2) -> dict:
    """Rows of ``name``'s sweep forward and backward at (n, t, c, h): each combo
    of one batched launch bitwise equal to a one-dictionary launch on its
    slices, the batched outputs against the stacked plain version, ``repeats``
    bitwise-equal bf16 launches; with ``timed`` the batched launch, the loop of
    n one-dictionary launches, the plain version and the batched cuBLAS
    products, against n times the one-dictionary bound."""
    mod = SWEEP_MODULES[name]
    tag = f"{'bf16' if cd == torch.bfloat16 else 'f32'}, N={n} T={t} C={c} H={h}"
    rows = {}
    ops = _sweep_ops(name, cd, n, t, c, h)
    fwd_names = {"sae_mlp": ("x_cent", "recon", "act_count", "row_active", "l1_sum"),
                 "matryoshka_sae": ("x_cent", "prefix_recon", "act_count", "row_active",
                                    "l1_sum"),
                 "jumprelu_sae": ("recon", "act_count", "row_active", "l1_sum"),
                 "gated_sae": ("recon", "via_gate", "act_count", "row_active", "l1_sum")}[name]
    bwd_names = {"gated_sae": GATED_GRADS, "jumprelu_sae": JUMPRELU_GRADS}.get(
        name, ("dW_enc", "db_enc", "dW_dec", "db_dec"))
    # the SAE and Matryoshka backwards take each combo's x_cent: no shared operand
    stacked_bwd = name in ("sae_mlp", "matryoshka_sae")
    plain_fwd = x_cent = None
    for backward, kern, single, names in ((False, mod.sweep_fwd_kernel, mod.fwd_kernel,
                                           fwd_names),
                                          (True, mod.sweep_bwd_kernel, mod.bwd_kernel,
                                           bwd_names)):
        args = _sweep_bwd_ops(name, cd, ops, x_cent, plain_fwd) if backward else ops
        shared = 0 if backward and stacked_bwd else 1
        got = kern(*args)
        torch.cuda.synchronize()
        log(f"[sweep] {kern.name} [{tag}] vs {n} one-dictionary launches and the plain version")
        for i in range(n):
            want = single(*_combo(args, i, shared))
            if not all(torch.equal(a, b) for a, b in zip(_sweep_parts(name, got, i, backward),
                                                        want)):
                raise AssertionError(f"{kern.name}: combo {i} differs from a one-dictionary "
                                     "launch on its operands")
        log(f"[sweep]   every combo bitwise equal to its one-dictionary launch")
        if cd == torch.bfloat16:
            for _ in range(repeats - 1):
                if not all(torch.equal(a, b) for a, b in zip(got, kern(*args))):
                    raise AssertionError(f"{kern.name}: two launches on the same inputs differ")
            log(f"[sweep]   {repeats} launches bitwise equal")
        plain = SW_PLAIN[name][backward](*args)
        a_red, p_red = _sweep_reduce(name, got, backward), _sweep_reduce(name, plain, backward)
        if backward:
            err = max(_check(nm, a, b, 1e-3, 1e-4) for nm, a, b in zip(names, a_red, p_red))
        else:
            err = 0.0
            for nm, a, b in zip(names, a_red, p_red):
                if nm in ("act_count", "row_active"):
                    _check(nm, a, b, 0.0, 0.0)
                elif nm == "x_cent":
                    if not torch.equal(a, b):
                        raise AssertionError(f"{kern.name}: x_cent differs from x - round(b_dec)")
                else:
                    e = _check(nm, a, b, 1e-4 if nm != "l1_sum" else 1e-5,
                               1e-5 if nm != "l1_sum" else 0.0)
                    if nm != "l1_sum":
                        err = max(err, e)
            plain_fwd = _sweep_reduce(name, plain, False) if name in ("jumprelu_sae",
                                                                      "gated_sae") else plain
            x_cent = got[0] if name in ("sae_mlp", "matryoshka_sae") else None
        if timed:
            f = SW_FLOPS[name][int(backward)] * t * c * h
            moved = nbytes(*(a for a in args if torch.is_tensor(a))) + nbytes(*plain)
            one = bound(f, moved // n, cd)[0]
            ms = time_ms(lambda: kern(*args), REPS)
            loop_ms = time_ms(lambda: [single(*_combo(args, i, shared)) for i in range(n)], REPS)
            plain_ms = time_ms(lambda: SW_PLAIN[name][backward](*args), REPS)
            lib_ms = time_ms(_sweep_library(name, ops, backward), REPS)
            b_ms, b_by = bound(n * f, moved, cd)
            log(f"[sweep] {kern.name} [{tag}] ms {ms:.3f} loop_ms {loop_ms:.3f} plain_ms "
                f"{plain_ms:.3f} library_ms {lib_ms:.3f} bound_ms {b_ms:.4f} ({b_by}; "
                f"{n} x {one:.4f}) TFLOP/s {n * f / ms / 1e9:.1f}")
            rows[kern.name] = dict(max_abs_err=err, ms=ms, loop_ms=loop_ms, plain_ms=plain_ms,
                                   bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                                   tflops=n * f / ms / 1e9, n_combo=n)
            if cd == torch.bfloat16 and n == SW_ROW_N:
                pair = backward and _sweep_route(name, cd, c, ops) == "pair"
                _split_pair(kern.name, tag, lambda **kw: kern(*args, **kw), t, h, c, backward,
                            pair)
                _split_pair(single.name, f"{tag}, combo 0 alone",
                            lambda **kw: single(*_combo(args, 0, shared), **kw), t, h, c,
                            backward, pair)
                if pair:  # rows 28, 32 and 34: the cluster pair beside coder_bwd_tc
                    _route_timing(kern.name, tag, "pair", lambda **kw: kern(*args, **kw))
        del got, plain
    torch.cuda.empty_cache()
    return rows


def sweep_kernels() -> dict:
    """(a): rows 27-34 at bench_sweep.py's shape for every N of SW_NS in f32 and
    bf16, and at the ragged shape; returns the bf16 rows at SW_ROW_N."""
    set_tf32(False)
    rows = {}
    with torch.no_grad():
        for name in SWEEP_MODULES:
            for cd in (torch.float32, torch.bfloat16):
                _sweep_kernel_check(name, cd, *SW_RAGGED, timed=False)
                for n in SW_NS:
                    bf16 = cd == torch.bfloat16
                    r = _sweep_kernel_check(
                        name, cd, n, SW_T, SW_C, SW_H, timed=True,
                        repeats=REPEATS if bf16 and n == SW_ROW_N else 2)
                    if bf16 and n == SW_ROW_N:
                        rows.update(r)
    return rows


# (b): phase 6's north-star sae_mlp config, 4 combos; combo 0 is phase 6's own
# λ and learning rate, so its final parameters are held to phase 6's run
SWEEP_COMBOS = ({"sae_lambda_sparse": LAMBDA, "sae_learning_rate": 1e-3},
                {"sae_lambda_sparse": LAMBDA, "sae_learning_rate": 2e-3},
                {"sae_lambda_sparse": 2 * LAMBDA, "sae_learning_rate": 5e-4},
                {"sae_lambda_sparse": LAMBDA / 2, "sae_learning_rate": 1e-3})
# combo 0 against phase 6's parameters: the kernels give each combo a
# one-dictionary launch's bits, but the two runs part by rounding outside them
# (1.311e-6 measured in five runs on the H100, the same each time); the bound
# is ~8x that and a hundredth of one Adam step (lr 1e-3)
SWEEP_REF_ATOL = 1e-5
SWEEP_STEP_N, SWEEP_STEPS = 4, 4  # (c): combos and steps at the bench shape
# (d): the coders' sweeps at a small depth (train images, latents, tokens a step)
SWEEP_CODERS = {"transcoder": (96, dict(sae_expansion_factor=16, cache_tokens_per_step=8192,
                                        sae_batch_size=32)),
                "crosscoder": (336, dict(sae_expansion_factor=2, sae_batch_size=32))}


def _zero_launches() -> None:
    for k in KERNELS + SWEEP_KERNELS:
        k.launches = 0


def _launches() -> dict:
    return {k.name: k.launches for k in KERNELS + SWEEP_KERNELS}


def _sweep_north_star(smi: str, ref: dict) -> dict:
    """(b) train_sae_sweep_cached on phase 6's sae_mlp config with the
    SWEEP_COMBOS; returns its launches."""
    from sparse_vision_tpu_torch.train.sweep_vmap import train_sae_sweep_cached

    shutil.rmtree(WORK, ignore_errors=True)
    set_tf32(False)
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for the backbone convs
    cfg, datasets = _slice_config("sae_mlp")
    pipes: list = []
    _zero_launches()
    t0 = time.perf_counter()
    last = train_sae_sweep_cached(cfg, SWEEP_COMBOS, datasets=datasets, pipelines=pipes)
    wall = time.perf_counter() - t0
    launches = _launches()
    n = len(SWEEP_COMBOS)
    log(f"[sweep] (b) train_sae_sweep_cached, {n} sae_mlp combos (dump, 12 steps, {2 * n} "
        f"evals) in {wall:.1f} s; launches {launches}")
    want = {"fused_sae_sweep_fwd": 12, "fused_sae_sweep_bwd": 12}
    for k, v in launches.items():
        if v != want.get(k, 0):
            raise AssertionError(f"(b): expected {want.get(k, 0)} launches of {k}, got {v}")
    for i, (p, m) in enumerate(zip(pipes, last)):
        steps = [(s, {k: float(v) for k, v in ms.items()}) for s, ms in p.train_log]
        if [s for s, _ in steps] != list(range(1, 13)):
            raise AssertionError(f"(b) combo {i}: steps {[s for s, _ in steps]}")
        if not all(math.isfinite(v) for _, ms in steps for v in ms.values()) or not all(
                math.isfinite(v) for v in m.values()):
            raise AssertionError(f"(b) combo {i}: a non-finite metric")
        if ckpt.latest_epoch(p._sae_ckpt_dir()) != 1:
            raise AssertionError(f"(b) combo {i}: no epoch-1 checkpoint")
        log(f"[sweep] (b) combo {i} {SWEEP_COMBOS[i]}: step 12 sae_loss "
            f"{steps[-1][1]['sae_loss']:.6g} rec {steps[-1][1]['sae_rec_loss']:.6g}; last eval "
            f"rec {m['sae_rec_loss']:.6g} perc_dead_units {m['perc_dead_units']:.6g}")
    worst, bitwise = 0.0, True
    for k, v in pipes[0].ts.params.items():
        r = ref["params"][k].to(v.device)
        bitwise &= torch.equal(v, r)
        worst = max(worst, (v - r).abs().max().item())
    log(f"[sweep] (b) combo 0 against phase 6's sae_mlp run: max abs param difference "
        f"{worst:.3e}{' (bitwise equal)' if bitwise else ''} (bound {SWEEP_REF_ATOL})")
    if worst > SWEEP_REF_ATOL:
        raise AssertionError(f"(b) combo 0 departs from phase 6's run by {worst:.3e}")
    timing = pipes[0].train_timing[0]
    rate = n * timing["tokens"] / timing["seconds"]
    log(f"[sweep] {smi}: (b) sweep_combo_tokens_per_sec {rate:.0f} ({n} combos x "
        f"{timing['tokens']} tokens in {timing['seconds']:.3f} s, host clock, ends in a "
        f"synchronize) against {ref['tokens_per_sec']:.0f} tokens/s of one run (phase 6): "
        f"{rate / ref['tokens_per_sec']:.2f}x N sequential single runs' rate")
    del pipes
    torch.cuda.empty_cache()
    shutil.rmtree(WORK, ignore_errors=True)
    return launches


def _sweep_steps() -> dict:
    """(c) The gated, JumpReLU and Matryoshka sweep steps (fused, f32) at the
    bench shape, SWEEP_STEPS steps of SWEEP_STEP_N combos (the rolling window
    restarting at 2 and 4), each combo against its single-device step; returns
    the sweep steps' launches."""
    from sparse_vision_tpu_torch.train.sweep_vmap import (
        make_sae_sweep_step,
        stack_sae_states,
        unstack_sae_state,
    )

    set_tf32(False)
    out = {}
    kw = {"gated_sae": {}, "jumprelu_sae": {"jumprelu_bandwidth": BANDWIDTH},
          "matryoshka_sae": {"matryoshka_prefixes": SW_PREFIXES}}
    lams = [LAMBDA * (i + 1) / SWEEP_STEP_N for i in range(SWEEP_STEP_N)]
    lrs = [1e-3 * (1 + i % 2) for i in range(SWEEP_STEP_N)]
    ef = SW_H // SW_C
    opts = {"compute_dtype": "float32"}
    for name in kw:
        if name == "jumprelu_sae":
            opts_n = {**opts, "bandwidth": BANDWIDTH}
            lams_n = [LAMBDA_J * (i + 1) for i in range(SWEEP_STEP_N)]
        else:
            opts_n, lams_n = opts, lams
        gen = torch.Generator(device=DEVICE).manual_seed(16)
        xs = [torch.relu(torch.randn(SW_T, SW_C, device=DEVICE, generator=gen)) * 2.0
              for _ in range(SWEEP_STEPS)]
        states = []
        for i in range(SWEEP_STEP_N):
            g = torch.Generator(device=DEVICE).manual_seed(100 + i)
            params = {"gated_sae": init_gated_sae, "jumprelu_sae": lambda g_, d, e:
                      init_jumprelu_sae(g_, d, e, threshold_init=0.5),
                      "matryoshka_sae": init_sae_mlp}[name](g, SW_C, ef)
            states.append(tsteps.init_sae_train_state(
                params, optim.get_optimizer("adam", lrs[i]), SW_H, seed=i))
        ss = stack_sae_states([s._replace(params={k: v.clone() for k, v in s.params.items()})
                               for s in states])
        step = make_sae_sweep_step(name, lams_n, lrs, "adam", 2, ef, fused=True,
                                   fused_opts=opts_n, device=DEVICE, **kw[name])
        _zero_launches()
        for x in xs:
            ss, m = step(ss, x)
        torch.cuda.synchronize()
        launches = _launches()
        mod = SWEEP_MODULES[name]
        for k, v in launches.items():
            want = SWEEP_STEPS if k in (mod.sweep_fwd_kernel.name, mod.sweep_bwd_kernel.name) else 0
            if v != want:
                raise AssertionError(f"(c) {name}: expected {want} launches of {k}, got {v}")
        out.update({k: v for k, v in launches.items() if v})
        worst, bitwise = 0.0, True
        for i, st in enumerate(states):
            one = tsteps.make_sae_train_step_from_acts(
                name, lams_n[i], optim.get_optimizer("adam", lrs[i]), 2, ef, fused=True,
                fused_opts=opts_n, **kw[name])
            for x in xs:
                st, _ = one(st, x)
            si = unstack_sae_state(ss, i)
            for k, v in st.params.items():
                bitwise &= torch.equal(si.params[k], v)
                scale = v.abs().max().item()
                d = (si.params[k] - v).abs().max().item()
                worst = max(worst, d / max(scale, 1e-30))
                if d > 1e-6 * scale + 1e-7:
                    raise AssertionError(f"(c) {name} combo {i} {k}: {d:.3e} from its "
                                         "single-device step")
            if not torch.equal(si.dead_acc, st.dead_acc):
                raise AssertionError(f"(c) {name} combo {i}: dead accumulators differ")
        log(f"[sweep] (c) {name}: {SWEEP_STEP_N} combos x {SWEEP_STEPS} fused f32 steps at "
            f"T={SW_T} C={SW_C} H={SW_H}, {SWEEP_STEPS} launches each of "
            f"{mod.sweep_fwd_kernel.name} / {mod.sweep_bwd_kernel.name}; every combo against its "
            f"single-device step: max relative parameter difference {worst:.3e}"
            f"{' (bitwise equal)' if bitwise else ''}; last sae_loss "
            f"{[round(float(v), 6) for v in m['sae_loss']]}")
        del ss, states, step
        torch.cuda.empty_cache()
    return out


def _sweep_coders() -> None:
    """(d) The transcoder and crosscoder sweeps (stock math under
    torch.func.vmap, as JAX's) through their trainers at a small depth: two
    combos each, finite losses and evals, each combo's checkpoint (and the
    crosscoder's decoder-norm CSV), no fused launch."""
    from sparse_vision_tpu_torch.train.sweep_vmap import train_sae_sweep_cached

    set_tf32(False)
    torch.backends.cudnn.allow_tf32 = True
    for name, (n_train, extra) in SWEEP_CODERS.items():
        shutil.rmtree(WORK, ignore_errors=True)
        size = (229, 229, 3)
        train = make_synthetic(num_samples=n_train, seed=0, img_size=size, num_classes=1000)
        val = make_synthetic(num_samples=64, seed=1, img_size=size, num_classes=1000)
        cfg, datasets = _slice_config(name, extra, (train, val, train.category_names, size))
        combos = [{"sae_lambda_sparse": cfg.sae_lambda_sparse},
                  {"sae_lambda_sparse": cfg.sae_lambda_sparse / 2}]
        pipes: list = []
        _zero_launches()
        t0 = time.perf_counter()
        last = train_sae_sweep_cached(cfg, combos, datasets=datasets, pipelines=pipes)
        wall = time.perf_counter() - t0
        if any(_launches().values()):
            raise AssertionError(f"(d) {name}: a fused launch in the stock sweep: {_launches()}")
        for i, (p, m) in enumerate(zip(pipes, last)):
            losses = [float(ms["sae_loss"]) for _, ms in p.train_log]
            if not losses or not all(math.isfinite(v) for v in losses) or not all(
                    math.isfinite(v) for v in m.values()):
                raise AssertionError(f"(d) {name} combo {i}: no or non-finite losses")
            if ckpt.latest_epoch(p._sae_ckpt_dir()) != 1:
                raise AssertionError(f"(d) {name} combo {i}: no epoch-1 checkpoint")
            if name == "crosscoder":
                with open(p.decoder_norms_path) as f:
                    if sum(1 for _ in f) - 1 != p.num_units:
                        raise AssertionError("(d) crosscoder: a decoder-norm CSV without one "
                                             "row per latent")
            log(f"[sweep] (d) {name} combo {i} {combos[i]}: {len(losses)} steps, sae_loss "
                f"{losses[0]:.6g} -> {losses[-1]:.6g}, last eval rec {m['sae_rec_loss']:.6g}")
        log(f"[sweep] (d) {name}: train_sae_sweep_cached of 2 combos ({pipes[0].num_units} "
            f"latents) in {wall:.1f} s, no fused launch")
        del pipes
        torch.cuda.empty_cache()
    shutil.rmtree(WORK, ignore_errors=True)


def sweep_reference(pipe=None) -> dict:
    """Phase 16 (b)'s reference: the final parameters (on the host) and the
    loop's tokens/s of phase 6's sae_mlp run, ``pipe`` that run's Pipeline
    (without it, the run is made here)."""
    if pipe is None:
        kept = {}
        phase_slice("sae_mlp", on_pipeline=lambda p: kept.update(pipe=p))
        pipe = kept["pipe"]
    t = pipe.train_timing[0]
    return {"params": {k: v.detach().cpu() for k, v in pipe.ts.params.items()},
            "tokens_per_sec": t["tokens"] / t["seconds"]}


def phase_sweep(smi: str, ref: dict) -> tuple:
    """Phase 16: the vmapped sweep. (a) rows 27-34 (sweep_kernels), (b) the
    north-star sweep, (c) the variants' sweep steps, (d) the coders' sweeps.
    Returns (the kernels line's rows 27-34, their launches from (b) and (c))."""
    t0 = time.perf_counter()
    rows = sweep_kernels()
    launches = _sweep_north_star(smi, ref)
    launches.update(_sweep_steps())
    _sweep_coders()
    log(f"[sweep] {smi}: phase {time.perf_counter() - t0:.1f} s")
    return rows, launches


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="trace the slices with torch.profiler (slows them; times are then "
                         "not clean)")
    ap.add_argument("--pair-body", choices=("jump", "relu", "gated"),
                    help="print coder_bwd_pair's own device time (and its pre-pass's) at "
                         "row 5's launch (jump), row 2's (relu) or row 7's (gated) as one JSON "
                         "line and exit "
                         "(the kernels line's row, from a fresh process)")
    args = ap.parse_args()
    if args.pair_body:
        print(json.dumps(_pair_body_ms_here(args.pair_body)))
        return 0

    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    rows = phase_kernels()
    phase_parity()
    launches = phase_dx()
    evals, kept = {}, {}
    for name in SLICES:
        got, evals[name], _ = phase_slice(
            name, args.profile,
            on_pipeline=(lambda p: kept.update(pipe=p)) if name == "sae_mlp" else None)
        launches.update(got)
    sae_ref = sweep_reference(kept.pop("pipe"))
    phase_cache(evals["sae_mlp"])
    phase_artifacts()
    phase_circuit(smi)
    ml_launches = phase_multilayer(smi)
    log("[multilayer] launches in (b) and (c): " + ", ".join(
        f"{k} {v}" for k, v in sorted(ml_launches.items())))
    phase_topk(smi)
    phase_backbones(smi)
    phase_original(smi)
    phase_finish(smi)
    tp_rows = phase_mesh(smi)
    sweep_rows, sweep_launches = phase_sweep(smi, sae_ref)
    pair_body_row(rows)
    log(f"[smoke] phases 1-16 in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"splits": SPLITS}))
    print(json.dumps({"routes": ROUTES}))
    kernels = [
        {"name": k.name, "route": "cuda", "source": SOURCES[k.name],
         "replaces": REPLACES[k.name], "launches": launches.get(k.name, 0), **rows[k.name]}
        for k in KERNELS + BODY_KERNELS
    ] + [{"name": k.name, "route": "cuda", "source": SOURCES[k.name],
          "replaces": REPLACES[k.name], **tp_rows[k.name]}
         for k in TP_KERNELS + CODER_TP_KERNELS] + [
        {"name": k.name, "route": "cuda", "source": SOURCES[k.name],
         "replaces": REPLACES[k.name], "launches": sweep_launches.get(k.name, 0),
         **sweep_rows[k.name]}
        for k in SWEEP_KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
