#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (transmf_ad_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero
before the final line:

1. device   a CUDA device, or exit 1 (there is no CPU fallback); the card's
            name and power limit as nvidia-smi reports them
2. build    compile csrc/*.cu with nvcc, one process per source (timed), and
            load the library
3. kernels  each hand-written kernel K1-K12 against its plain PyTorch
            version on the card, float32 and bfloat16, at the shapes the
            serving paths and the train steps give it (91x109x91 at batch 8
            and 182x218x182 at batch 6; the plain version of a stem or pool
            kernel at 182x218x182 runs one sample at a time, to bound its
            float32 temporaries; the flash kernels K10-K12 at 1,573 queries
            x 3,146 keys, the saved logsumexp included, and at two small odd
            shapes): max error against a stated tolerance;
            kernel and plain
            median times from CUDA events; the kernel's bound, the larger of
            its bytes (inputs read once, outputs written once) over 3.35 TB/s
            and its operations over the card's peak for their type; and,
            where one PyTorch call computes the same function, that call's
            time (a yardstick: nothing in the port calls it for that; for
            K11 and K12 SDPA's forward and backward, and its backward alone
            with the backend it took); for K2-K12 the variant the call took
            ("mma" on the tensor cores for bfloat16 at the models' widths,
            "vec" for K4 and K7 wherever a channel row is whole 16-byte
            pieces, "rows" / "direct" otherwise) and, in bfloat16 at the
            main shapes (K2 also at phase 15's (24,65,65,64) of ADVIT and
            (64,150,150,16) of the hold-out ModelAd), the earlier
            variant's time in the same run, with
            edge cases of the tensor-core variants (one and
            two planes, tiles one below, at and one above their size,
            weights staged by taps, segments along x, blocks of channels;
            one query, one key, partial chunks, every head dim) and of K4 /
            K7 (odd tails on each axis, one lane, rows one block below, at
            and above a block's lanes, C 8, 12, 16, ties, the plain pooling
            entries, whose library yardsticks are F.max_pool3d /
            F.avg_pool3d and their backward); K5's y and sums, K6's dw and
            K7's dy and sums bit-identical over two calls on the same
            inputs, K4 "vec" and K7's dy bit-identical to "direct"; then K2
            and K10 side by side at 1,573 and 3,146 keys. K1 ("cluster":
            a thread-block cluster a batch row; "column" timed beside it)
            at the fusion head of both resolutions, (8,150,128)x2 and
            (6,1573,128)x2, bit-identical over two calls, with edge cases
            of token count and width; its times are the card's alone
            (queued behind a spin: `_queued_ms`), beside the launch floor
            (an empty kernel) by the same method and by events around the
            call. K13, the train step's augmentation (no TPU kernel: the
            JAX package's is XLA), at the cells' (6,182,218,182) x 2 on
            draws of every kind ("smem"), bit-identical over two calls,
            and at a plane over the shared-memory limit ("global"). K14,
            swin_unetr's window attention, forward and backward, at each of
            the 8 calls a train step of its cell makes each way (the four
            stages' grids at batch 6, (6,91,109,91) with 3 heads to
            (6,12,14,12) with 24, shift 0 and 3), the plain version one
            sample at a time, at tests/test_torch_swin.py's tolerances; the
            forward bit-identical over two calls; the 8 calls' kernel,
            plain and bound times summed ("step")
4. serving  full-width ModelAd (dim 128, depth 3, 4 heads x 32, mlp 512) in
            bfloat16, random weights and BN statistics from a seeded
            torch.Generator, answers 6 batch-8 requests of 91x109x91
            MRI+PET (the last 3 timed); every serving kernel's launch count
            must rise, every K2 and K3 launch is of the "mma" variant and
            every K4 launch of "vec"
5. check    the same weights at batch 2 in float32 (TF32 off) on the card and
            through the plain path on the CPU: logits, d_mri and d_pet agree
6. train    the adversarial train step of full-width ModelAd at batch 8,
            91x109x91, bfloat16 compute with float32 master weights,
            augmentation on, head dropout 0.5 from a CUDA torch.Generator,
            Adam 1e-4: 3 warm-up and 5 timed steps; losses finite,
            parameters and running statistics move, every train-path
            kernel's launch count rises, and K13 launches once a step
7. train check  one SGD (lr 1, no momentum) step with the same weights on the
            card (float32, TF32 off) and on the CPU plain path, at full width,
            batch 4, 35x37x33, no augmentation or dropout: the losses, every
            parameter update and every running statistic agree within 1e-3
            of their largest magnitude plus 3x the spread of 4 CPU steps on
            inputs perturbed by 1e-6 (`compare_steps` says why); then the
            same with every body conv on the band route (band_min_voxels=0)
8. full-resolution serving  the same model answers 3 batch-6 requests of
            182x218x182 MRI+PET (the last 2 timed): the stem, both stage-2
            convs (K8) and the lane-vector pools run at full resolution, and
            every launch of K8, K2 and K3 is of the "mma" variant (asserted,
            in phases 6, 9 and 11 too, for K5, K6 and K9-K12 as well, and
            "vec" for every K4 and K7 launch); then
            card
            float32
            against the CPU at 35x37x33 with every body conv on the band
            route
9. full-resolution train  the train step at batch 6, 182x218x182: 2 warm-up
            and 3 timed steps; losses finite, parameters and running
            statistics move, K5, K6, K8 and K9 launched; peak device memory
10. full-resolution serving, transformer_res  full-width
            ModelTransformerRes (CrossTransformer over the joint context of
            2 x 1,573 = 3,146 keys) answers 3 batch-6 requests of 182x218x182
            (the last 2 timed): K10 launched 6 times per request and K2
            never; then card float32 against the CPU at 51x53x49 with the
            flash gate lowered to 8 keys on both sides, so the check goes
            through K10
11. full-resolution train, transformer_res  its train step
            (adversarial=False) at batch 6, 182x218x182: 2 warm-up and 3 timed
            steps; losses finite, parameters move, K10, K11 and K12 each
            launched 6 times per step and K2 never; peak device memory; then
            the one-SGD-step check of phase 7 for transformer_res at 51x53x49
            with the flash gate lowered, so K11 and K12 are held inside a
            real backward; then swin_unetr's train step (Swin UNETR's
            encoder, feature size 48) at batch 6, 182x218x182: 2 warm-up
            and 3 timed steps, K14's forward and backward each launched 8
            times a step, all "mma", and no other model kernel; losses
            finite, parameters move; peak device memory
12. bf16 check  full-width ModelAd in bfloat16 on the card against the
            card in float32 (phase 7's weights-from-a-seed, batch 4,
            35x37x33): the eval forward's logits, d_mri, d_pet and one SGD
            step's losses, within 3x the CPU plain path's own bf16-vs-f32
            difference + 1e-3 of each output's scale; on the default and on
            the band route, then transformer_res at 51x53x49 with the flash
            gate lowered (K10 forward, K11 / K12 in the step); every bf16
            launch took the variant its rule names ("mma", "vec"). In the
            bf16 step every call of K6-K9, K11 and K12 is held against
            its plain version on the model's own inputs, at phase 3's
            tolerances; the updates in bf16 against f32 are printed, not
            held (see `bf16_check`)
13. learning check  the port of scripts/tpu_sanity_train.py through the
            host data layer: a synthetic ADNI tree of 8 subjects a group at
            91x109x91 on disk, ADCN (16 pairs) cached in bf16 by
            VolumeSource and shuffled by Loader (batch 8); full-width
            ModelAd trains 40 steps in bf16 with Adam 1e-4 and no
            augmentation, and the mean ce_loss of its last epoch must be
            under half that of its first; the same rule on the band route
            and on transformer_res with the flash gate lowered, each on the
            script's fixed batch at phase 12's volumes; then the eval step
            over the 16 pairs in batches of 6, the last padded and masked:
            total 16, K1 launched, acc / sen / spe / f1 / AUC printed; then
            the eval step on the card (f32) against the CPU plain path:
            probs within 1e-4, counts equal. From phase 4 on every K1
            launch is "cluster" (asserted) and every launch takes the
            variant its rule names
14. k-fold   the port's normal entry point: a synthetic ADNI tree of 40
            ADCN pairs (20 a class) at 91x109x91 in $TMPDIR, then
            `cli/kfold_train_adversarial.py`'s `main` in this process with
            the reference README's flags: full-width ModelAd in bfloat16,
            batch 8, augmentation on, 5 folds of 1 + 1 epochs. Held: 5 fold
            result lines and the mean +- std, each fold's log.txt (training,
            validation and test results, MRIaccuracy) and exactly one best
            .pt, losses and accuracies finite, every fold's train feed the
            device cache, and the launches: K1 and K2 once and 6 times a
            forward, K5 and K6 twice a train step, K3 twice an eval batch,
            K4 and K7 launched, each in its rule's variant. Then `--model
            CNN --folds 0` (the same without K1 and K2); one epoch of fold
            0's train loader (and its ragged validation loader) through the
            host Loader + pad_batch, DeviceFeed, DeviceCachedFeed and a
            HybridCachedFeed about half cold: the same batches bit for bit;
            fold 0's best .pt scored by `cli/evaluate.py` on the card: fold
            0's test metrics (counts equal, loss and AUC within 1e-5); a
            resumed run: the step, learning rate, Adam moments, scheduler
            and generator right after the load equal what was saved, and it
            logs epoch 2 only. Printed, not held: each fold's epoch vols/s as
            the Trainer logs it, for the cached, streaming and hybrid feeds
15. zoo      the other entry points, each `main` in this process on
            synthetic trees of 40 ADCN pairs in bfloat16 at batch 8 with the
            README's flags: `cli/kfold_train_single.py` (ModelSingle on the
            MRI at 91x109x91; no drop_last, so 2 ragged train batches take
            the masked step), `cli/kfold_train_ADVIT.py` (volumes of
            91x109x79 padded to 128x128x79), `cli/kfold_train_Mnet.py`
            (91x109x91, spatial kernel 11 and pool 3), each fold 0 of 1 +
            1 epochs, and `cli/train_adversarial.py` (the hold-out 60/20/20,
            ModelAd at heads 8, one epoch). Held: each result finite, its
            log complete, and the exact launches its splits give, every
            other kernel at 0: K13 once a train step but in ADVIT, which
            does not augment; ModelSingle K5 and K6 once a train step, K3
            once an eval batch, K4 4 times a forward, K7 4 times a step;
            ADVIT K2 12 times a forward ("mma" at (24,65,65,64)) and no
            other; Mnet no kernel of the model; the hold-out as ModelAd (K2
            "mma" at head dim 16, K4 8 times a forward, K7 8 times a step);
            then
            `cli/evaluate.py --model single --fold 0` against fold 0's
            logged test metrics; the eval forward of ModelSingle, ADVIT
            (128x128x79), Mnet and ModelAd at heads 8, card f32 against the
            CPU as in phase 5; one SGD step card against CPU as in phase 7
            of ModelSingle, ADVIT (32x32x79) and Mnet (spatial kernel 3,
            pool 2) at 35x37x33. Printed: each run's seconds and epoch
            vols/s
16. remat    per-block remat (`SNet(remat=True)`) at full resolution: the
            rule wraps blocks 0, 1, 2 and 4 of each encoder at batch 6,
            182x218x182; one float32 SGD step (TF32 off) with remat
            against one without, for full-width ModelAd and
            transformer_res: the train-check rule (the spread from 2 steps
            on perturbed inputs), the running statistics within 1e-6 of
            their scale (they move once); then bf16 steps without
            augmentation at batch 6 and 12, with and without remat, each
            model: ms/step (median of 3 after 2), peak memory, and the
            largest batch estimated from the two peaks (not searched);
            held: remat launches K5 2, K8 4 and K4 6 more times a step, no
            other kernel more, every launch in its rule's variant
17. data parallel  two ranks share the card through Gloo (NCCL refuses
            two ranks on one device), each a child process of this script,
            every child of the phase started at once (7 processes on the
            card): (a) one float32 SGD step of full-width ModelAd on a global
            batch of 8 at 91x109x91, 4 pairs a rank, against the
            single-process step on the same pairs (the train-check rule;
            the spread from 4 steps on perturbed inputs), the ranks'
            parameters and running statistics bit-identical, each rank's
            K5, K6 (2), K1 (1), K2 (6), K4 and K7 launched; then, once
            the CLI runs of (b) and (c) have ended, 3 steps of one process
            on 4 pairs and 3 steps of the ranks, each under the profiler
            with the card to itself: ms/step and the collectives' host ms;
            (b) `cli/kfold_train_adversarial.py`'s `main` on 2 ranks
            (`--coordinator_address`, `--num_processes 2`,
            `--process_id`; each child joins the Gloo group first, and the
            CLI finds it up) over a synthetic tree of 40 ADCN pairs, bf16,
            fold 0 of 1 + 1 epochs, with the device cache and with the
            streaming feed (TRANSMF_CACHE_BUDGET_MB=0): both ranks finish
            with the same state before the test, only rank 0 opens files
            for writing under the checkpoints, and `cli/evaluate.py --fold
            0` on the same ranks reproduces the fold's test metrics; (c)
            the same CLI as one rank on NCCL (`--num_processes 1
            --process_id 0`)
18. ops, artifact, sharded serving, profiler  (a) `torch.library.opcheck`
            of every op of the `transmf` namespace on CUDA tensors at the
            small odd shapes of tests/test_torch_library_ops.py, float32 and
            bfloat16 (the fake implementation against the kernel's output:
            shape, dtype, strides, no aliasing; the autograd registration;
            aot_autograd), then the host microseconds a call of K1 and K4
            through the old wrapper's path and through the op (printed);
            (b) full-width ModelAd (phase 4's seeded weights) exported with
            a symbolic batch at 91x109x91 and loaded by a child that imports
            the serving module and the ops alone (not `models`), serving
            batches 8 and 3: the probabilities equal `make_inference_fn`'s
            bit for bit (where the card differs, within one bf16 ulp, the
            largest difference printed), every kernel's launches and
            variants per request equal; export and load seconds and both
            request ms printed; (c) the same for transformer_res at
            182x218x182, batches 6 and 1 (K8 and K10 launch from the loaded
            program); (d) `make_sharded_inference_fn` on two Gloo ranks
            sharing the card, float32: a global batch of 8 pairs of
            full-width ModelAd at 91x109x91 against one process within 1e-4
            of the probabilities' scale, the ranks bit-identical, a global
            batch of 3 raising ValueError on both; (e) `Trainer.fit` of
            full-width ModelAd (phase 14's synthetic tree and fold-0
            trainer, 3 epochs) with `profile_dir` set and the window over
            the second epoch: one Chrome trace holding the port's kernels,
            by their `__global__` names in csrc/, beside cuDNN's, and its
            top device items printed
19. model axis  two Gloo ranks sharing the card on a data-1 x model-2
            mesh (`parallel.make_mesh`), each holding its rows of the
            weights JAX's rule shards (`param_shardings`, min_size 2048:
            every body conv, dense layer and head, not the stem): (a) one
            float32 SGD step of full-width ModelAd at 182x218x182 on a
            global batch of MP_CHECK_BATCH against the single-process step
            on the same pairs by the train-check rule (the spread of
            CHECK_DRAWS perturbed single-process steps), the ranks' whole
            states bit-identical, each rank's rows of every sharded weight
            its rows of the whole, and the size arguments of every launch
            of K8 / K9 / K4 / K7 / K2 printed (the rank's channel and head
            slices); (b) MP_STEPS bfloat16 Adam steps at batch MP_BATCH:
            ms/step and each rank's peak memory beside one process's on
            the same batches, every K2 / K5 / K6 / K8 / K9 launch "mma" and
            every K4 / K7 launch "vec", after one step at batch
            MP_CHECK_BATCH (not timed) in which every call of K6, K7, K8
            (forward and dx) and K9 is held against its plain version at
            phase 3's tolerances; (c) a `transformer_res`
            request at 182x218x182, batch MP_BATCH, through
            `make_sharded_inference_fn(model_axis=2)` in float32 within
            1e-4 of `make_inference_fn`, K10 on 2 of 4 heads

The line before the last is a JSON object with one entry per kernel: `ms`,
`plain_ms`, `bound_ms`, `bound_by` and `library_ms` belong to the bfloat16
run at the first shape listed for the kernel (K1's full-resolution case is
under `full_resolution`, its launch floor under `launch_floor_ms`; K14's
other calls under their labels and their sum over a train step under
`step`),
`max_abs_err` is the largest over all its cases, `launches` its count over
the seven serving and train runs, the learning check, the two k-fold CLI
runs of phase 14, the four CLI runs of phase 15, phase 16's bf16 runs,
every rank of phase 17, phase 18's runs (a request of each loaded program
at each batch, each sharded rank, the profiled fit) and every rank of
phase 19 together, each counted from zero (K13 too: a run that augments
launches it once a train step, and it is held to that). Before it a
`[time]` line gives the seconds each group of phases took. The last line is
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --only band_dw flash_fwd

runs phases 1-3 for the named kernels alone and stops without the result
lines: a short first run of a new kernel.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import glob
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

BATCH, VOLUME = 8, (91, 109, 91)
WARMUP, REQUESTS = 3, 6  # requests served; the first WARMUP are not timed
TRAIN_WARMUP, TRAIN_STEPS = 3, 5  # train steps; the first 3 are not timed
FULL_BATCH, FULL_VOLUME = 6, (182, 218, 182)  # the full-resolution phases
# phase 3, K13: (flip, rotate, angle, zoom, factor, unused) uniforms giving,
# under the default AugmentConfig, the identity, a flip, a zoom, a
# rotation, all three, and a flip with a rotation of exactly 0
AUGMENT_ROWS = [[0.9, 0.9, 0.5, 0.9, 0.5, 0.0], [0.1, 0.9, 0.5, 0.9, 0.5, 0.0],
                [0.9, 0.9, 0.5, 0.1, 0.3, 0.0], [0.9, 0.1, 0.8, 0.9, 0.5, 0.0],
                [0.1, 0.1, 0.1, 0.1, 0.9, 0.0], [0.1, 0.2, 0.5, 0.9, 0.5, 0.0]]
FULL_WARMUP, FULL_REQUESTS = 1, 3
FULL_TRAIN_WARMUP, FULL_TRAIN_STEPS = 2, 3
# H100 SXM data sheet: HBM bytes/s; dense FLOP/s of the tensor cores in
# bfloat16 and of the CUDA cores in float32
HBM_RATE = 3.35e12
PEAK = {"bfloat16": 989e12, "float32": 67e12}
CHECK_BATCH, CHECK_VOLUME = 4, (35, 37, 33)
# transformer_res's checks: 3 x 3 x 3 = 27 tokens a modality, 54 keys (a
# partial query tile and two key chunks, the second partial), with the flash
# gate lowered to FLASH_CHECK_GATE keys on the card and on the CPU
RES_CHECK_VOLUME, FLASH_CHECK_GATE = (51, 53, 49), 8
FLASH_SHAPE = (6, 4, 1573, 32, 3146)  # batch, heads, queries, head dim, keys
# swin_unetr's cell (patch 2, window 7, feature size 48): each stage's
# token grid at FULL_VOLUME and its heads; block 1 of a stage shifts by 3;
# K14 launches 8 times a train step each way (2 blocks x 4 stages)
SWIN_STAGES = (((91, 109, 91), 3), ((46, 55, 46), 6), ((23, 28, 23), 12),
               ((12, 14, 12), 24))
SWIN_WINDOW, SWIN_SHIFT, SWIN_CALLS = 7, 3, 8
# the train check's conditioning probe: CPU steps on inputs perturbed by a
# relative CHECK_EPS (a few float32 ulps), and the weight of their spread
CHECK_DRAWS, CHECK_EPS, CHECK_SLACK = 4, 1e-6, 3.0
BF16_RTOL = 2.0 ** -7  # one bfloat16 ulp, relative
SPIN_CYCLES = 400_000  # `_queued_ms`'s spin: ~0.2 ms at the H100's clock
# phase 13, scripts/tpu_sanity_train.py's steps and batch; the eval batch
LEARN_STEPS, LEARN_BATCH, EVAL_BATCH = 40, 8, 6
# phase 14: pairs a class of the synthetic tree, folds, and the reference
# README's flags (the task's seed is 42)
KFOLD_PER_CLASS, KFOLD_FOLDS, KFOLD_SEED = 20, 5, 42
# phase 15: ADVIT's ViT (heads, tokens at its (128, 128, 79) pad) and its
# K2 launches a forward (depth 6, two modalities); the hold-out ModelAd's
# heads; ADVIT's synthetic volumes, whose 79 slices its depth-collapse
# stack takes to 1 (the reference pads to (128, 128, 79), so its volumes
# have at most 79); Mnet's and the train checks' spatial stack at
# CHECK_VOLUME (the reference's 11 / 3 needs a 91 x 109-class plane)
ADVIT_HEADS, ADVIT_TOKENS, ADVIT_CALLS = 3, 65, 12
ADVIT_PAD, ADVIT_VOLUME, ADVIT_CHECK = (128, 128, 79), (91, 109, 79), \
    (32, 32, 79)
HOLDOUT_HEADS = 8
MNET_CHECK = dict(spatial_kernel=3, spatial_pool=2)
# phase 16, remat at full resolution: the bf16 runs' batches, warm-up and
# timed steps, and the float32 check's steps on perturbed inputs; the
# blocks the rule wraps at batch 6 (0, 1, 2 and 4 of each encoder) and the
# forward launches a step they add: K5 once an encoder (block 0), K8 with
# its sums twice (blocks 1 and 2), K4 three times (the pools of blocks 0, 2
# and 4)
REMAT_BATCHES, REMAT_WARMUP, REMAT_STEPS, REMAT_DRAWS = (6, 12), 2, 3, 2
REMAT_BLOCKS = [0, 1, 2, 4]
REMAT_EXTRA = {"stem_conv_stats": 2, "band_conv": 4, "affine_act_pool": 6}
# phase 17, data parallel: the ranks that share the card, the step check's
# global batch, the steps profiled after it, the children's time limit (s)
DP_WORLD, DP_BATCH, DP_PROFILED, DP_TIMEOUT = 2, 8, 3, 300
# phase 18: the artifacts' request batches (ModelAd at VOLUME,
# transformer_res at FULL_VOLUME) and the calls of each (the first not
# timed); the sharded ranks, their global batch and the children's time
# limit (s); the profiled fit's epochs (the window is the second)
ARTIFACT_BATCHES, RES_ARTIFACT_BATCHES, ARTIFACT_REPEATS = (8, 3), (6, 1), 6
SHARD_WORLD, SHARD_BATCH, SHARD_TIMEOUT = 2, 8, 300
PROFILE_EPOCHS = 3
# phase 19, the model axis: the ranks (one model group), the f32 check's
# global batch, the bf16 steps' batch and count, the transformer_res
# request's repeats, the children's time limit (s)
MP_WORLD, MP_CHECK_BATCH, MP_BATCH, MP_STEPS = 2, 2, 6, 3
MP_REQUESTS, MP_TIMEOUT = 3, 300
# phase 18 (a): K4 / K7's (mode, lanes) opchecked on the card (the CPU
# tests take all four)
OPCHECK_POOLS = (("max", True), ("avg", False))
SERVING_KERNELS = ("token_pool", "attention_fwd", "stem_conv",
                   "affine_act_pool")
TRAIN_KERNELS = ("token_pool", "attention_fwd", "affine_act_pool",
                 "stem_conv_stats", "stem_dw", "affine_act_pool_bwd")
FULL_SERVING_KERNELS = SERVING_KERNELS + ("band_conv",)
FULL_TRAIN_KERNELS = TRAIN_KERNELS + ("band_conv", "band_dw")
# transformer_res pools its tokens with a mean (no K1) and attends over
# 3,146 keys (K10-K12, never K2)
RES_SERVING_KERNELS = ("stem_conv", "affine_act_pool", "band_conv",
                       "flash_fwd")
RES_TRAIN_KERNELS = ("affine_act_pool", "stem_conv_stats", "stem_dw",
                     "affine_act_pool_bwd", "band_conv", "band_dw",
                     "flash_fwd", "flash_dq", "flash_dkv")
ATTENTION_CALLS = 6  # per forward: depth 3, one per modality
# swin_unetr runs K14 (window attention) and no other model kernel
SWIN_TRAIN_KERNELS = ("window_attention_fwd", "window_attention_bwd")
SWIN_TAG = "train, full resolution, swin_unetr"
# the variant every launch of K1-K14 must take on the bfloat16 paths at the
# models' widths and volumes: the tensor cores ("mma"), K4 / K7's 16-byte
# groups ("vec"), K1's clusters and K13's plane in shared memory
FAST = {"attention_fwd": "mma", "band_conv": "mma", "band_dw": "mma",
        "flash_fwd": "mma", "flash_dq": "mma", "flash_dkv": "mma",
        "stem_conv": "mma", "stem_conv_stats": "mma", "stem_dw": "mma",
        "affine_act_pool": "vec", "affine_act_pool_bwd": "vec",
        "token_pool": "cluster", "augment": "smem",
        "window_attention_fwd": "mma", "window_attention_bwd": "mma"}


def _median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of `fn`; fewer repeats of a call that takes
    over 5 ms, fewer still over 100 ms."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = 1e3 * (time.perf_counter() - t0)
    if once > 100.0:
        iters, warmup = 3, 0
    elif once > 5.0:
        iters, warmup = 7, 0
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _queued_ms(fn, iters: int = 20) -> float:
    """Median CUDA-event time of `fn` with its launches queued behind a
    0.2 ms spin of the card (`torch.cuda._sleep`), so that the host's work
    to launch them overlaps the spin: the card's time alone, where
    `_median_ms` also counts the host's time to reach the launch while the
    card waits."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _host_us(fn, calls: int = 200) -> float:
    """The host's microseconds a call of `fn`, launches enqueued and not
    waited for (the card drains them after the clock stops)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    spent = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * spent / calls


def _randn(g, *shape, scale=1.0):
    return torch.randn(*shape, generator=g, device="cuda") * scale


def _elem(rtol, atol):
    """|kernel - plain| <= atol + rtol * |plain|, elementwise."""
    return ("elem", rtol, atol)


def _sums(rtol):
    """float32 sums: |kernel - plain| <= rtol * max |plain| (only the order
    of the float32 additions differs)."""
    return ("sum", rtol, 0.0)


def _scaled(rtol, rel_atol):
    """|kernel - plain| <= rel_atol * max |plain| + rtol * |plain|,
    elementwise: sums of signed terms, whose error follows the terms and not
    the (possibly cancelled) result."""
    return ("scaled", rtol, rel_atol)


@dataclasses.dataclass
class Case:
    """One kernel at one shape: the kernel's wrapper and its plain version
    on the arguments `make(dtype)` builds, one tolerance per output for
    float32 and for bfloat16, the operations the function needs on those
    arguments, and the one PyTorch call (if any) that computes the same."""
    name: str
    label: str
    kern: object
    plain: object
    make: object
    tol32: list
    tol16: list
    # args -> (operations, "mma" for products the tensor cores take in
    # bfloat16, or "f32" for elementwise float32 arithmetic)
    work: object
    library: object = None
    # the same call through the kernel's CUDA-core variant (bfloat16 only):
    # the design the tensor-core variant replaced, timed in the same run
    earlier: object = None
    timed: bool = True  # an edge case is checked and not timed
    # args -> (a second library call to time, what it is): K11 and K12's
    # SDPA backward alone, its forward run outside the timed region
    library_part: object = None
    # a second call on the same inputs must give the same bits (K5, K6, K7:
    # no float atomics, partials added in a fixed order)
    repeat: bool = False
    # what `earlier` is called in the printed line
    earlier_name: str = "CUDA-core variant"
    # args -> the leading outputs of the other variant, which must give the
    # same bits (K4 "vec" and "direct"; K7's dy)
    twin: object = None
    # `library(*args)` returns the call to time, its forward run outside
    # the timed region (the backward of F.max_pool3d / F.avg_pool3d)
    library_bwd: bool = False
    # the positions of arguments the function never reads (K7's mean
    # backward: p), left out of the bound's bytes
    unread: tuple = ()
    # a second timed shape of the kernel that the result line gives under
    # this key of its entry (K1's full-resolution case)
    record: str = None
    # time with `_queued_ms` (the card alone) where the host's time to reach
    # the launch is of the kernel's order (K1), and print `_median_ms`'s
    # times and the launch floor beside
    queued: bool = False


def _by_sample(plain, batched, summed=()):
    """`plain` run on one sample at a time: the arguments at the positions
    `batched` are sliced along the batch, the outputs at the positions
    `summed` (sums over the batch) are added in float64 and rounded once to
    float32, the others concatenated. The same function as `plain` on the
    whole batch, with temporaries of one sample."""
    def run(*args):
        parts = []
        for i in range(args[batched[0]].shape[0]):
            out = plain(*(a[i:i + 1] if j in batched else a
                          for j, a in enumerate(args)))
            parts.append(out if isinstance(out, tuple) else (out,))
        outs = tuple(torch.stack(col).double().sum(0).float() if k in summed
                     else torch.cat(col) for k, col in enumerate(zip(*parts)))
        return outs if len(outs) > 1 else outs[0]
    return run


def _crossover_labels():
    """Labels of the four cases that show K2 and K10 side by side, by
    kernel and key count: the queries of one modality over its own keys
    (batch 2) and over the joint context (batch 6)."""
    b, h, n, d, m = FLASH_SHAPE
    return {("attention_fwd", n): f"({2 * h},{n},{d})",
            ("flash_fwd", n): f"({2 * h},{n},{n},{d}) + lse",
            ("attention_fwd", m): f"({b * h},{n},{m},{d})",
            ("flash_fwd", m): f"({b * h},{n},{m},{d}) + lse"}


CROSSOVER = _crossover_labels()


def _swin_calls():
    """(label, grid, heads, shift) of K14's calls a train step of
    swin_unetr's cell, each way: stage by stage, shift 0 then SWIN_SHIFT."""
    return [(f"stage {i + 1} ({FULL_BATCH},{','.join(map(str, grid))}) "
             f"{heads} heads shift {shift}", grid, heads, shift)
            for i, (grid, heads) in enumerate(SWIN_STAGES)
            for shift in (0, SWIN_SHIFT)]


def _kernel_cases(g):
    from torch.nn.grad import conv3d_weight

    from transmf_ad_tpu_torch import _build
    from transmf_ad_tpu_torch.ops import (band_conv, flash_attention as fa,
                                          pool3d, pooling, stem)
    from transmf_ad_tpu_torch.ops.flash_attention import (attention_reference,
                                                          fused_attention)

    def attn(b, h, n, d, m=None):
        def make(dt):
            q = _randn(g, b, h, n, d).to(dt)
            k, v = (_randn(g, b, h, m or n, d).to(dt) for _ in range(2))
            return q, k, v, d ** -0.5
        return make

    def attn_bwd(b, h, n, d, m):
        """inputs of K11 and K12: q, k, v, an output gradient, and the
        plain forward's lse and delta = rowsum(g * out) (so both sides see
        the same)"""
        def make(dt):
            q, k, v, scale = attn(b, h, n, d, m)(dt)
            out, lse = fa.flash_fwd_reference(q, k, v, scale)
            gg = _randn(g, b, h, n, d).to(dt)
            return q, k, v, gg, lse, fa.flash_delta(out, gg), scale
        return make

    def affine(shape, lanes):
        n = shape[3] * shape[4] if lanes else shape[4]
        return 1.0 + 0.5 * _randn(g, n), 0.3 * _randn(g, n)

    def pool_y(shape, dt, ties):
        """y, or with `ties` y on a grid of 0.5 (many tied window maxima,
        exact in bfloat16)"""
        y = _randn(g, *shape)
        return ((2 * y).round() / 2 if ties else y).to(dt)

    def pool(shape, lanes, ties=False, identity=False):
        def make(dt):
            s, b = affine(shape, lanes)
            if identity:
                return (pool_y(shape, dt, ties), torch.ones_like(s),
                        torch.zeros_like(b), 1.0)
            return pool_y(shape, dt, ties), s, b, 0.01
        return make

    def pool_bwd(shape, lanes, mode, identity=False, ties=False):
        """inputs of K7: y, the affine, the plain forward's output p (so
        both sides see the same p) and a pooled gradient g"""
        def make(dt):
            y = pool_y(shape, dt, ties)
            s, b = affine(shape, lanes)
            slope = 0.01
            if identity:
                s, b, slope = torch.ones_like(s), torch.zeros_like(b), 1.0
            p = _by_sample(pool3d.affine_act_pool_reference, (0,))(
                y, s, b, slope, mode)
            return y, s, b, p, _randn(g, *p.shape).to(dt), slope
        return make

    def k4(mode, lanes):
        """K4 through its wrapper's path, in the variant the rule names"""
        def kern(y, s, b, slope):
            return pool3d._affine_act_pool("affine_act_pool", y, s, b, slope,
                                           mode, lanes)
        return kern

    def k4_direct(mode, lanes):
        """K4's "direct" variant on the arguments of `k4`, whatever the
        channel count"""
        def run(y, s, b, slope):
            bb, X, Y, Z, C = y.shape
            out = torch.empty(bb, X // 2, Y // 2, Z // 2, C, dtype=y.dtype,
                              device="cuda")
            pool3d.AFFINE_ACT_POOL.launch(
                y.device, y.data_ptr(), s.data_ptr(), b.data_ptr(),
                out.data_ptr(), bb, X, Y, Z, C, C if lanes else 0,
                float(slope), pool3d._MODES[mode],
                _build.DTYPE_CODES[y.dtype], 0, 0, variant="direct")
            return out
        return run

    def k7(mode, lanes, round_gi):
        def kern(y, s, b, p, gg, slope):
            return pool3d.affine_act_pool_bwd(y, s, b, p, gg, slope, mode,
                                              lanes, round_gi)

        def plain(y, s, b, p, gg, slope):
            return pool3d.affine_act_pool_bwd_reference(y, s, b, p, gg, slope,
                                                        mode, round_gi)
        return kern, plain

    def k7_direct(mode, lanes, round_gi):
        """K7's "direct" variant on the arguments of `k7`, whatever the
        channel count"""
        def run(y, s, b, p, gg, slope):
            bb, X, Y, Z, C = y.shape
            grid = pool3d.bwd_blocks("direct", y.dtype, bb, X, Y, Z, C)
            dy = torch.empty_like(y)
            part = torch.empty(2, grid, Z * C, device="cuda")
            dsb = torch.empty(2, s.numel(), device="cuda")
            pool3d.AFFINE_ACT_POOL_BWD.launch(
                y.device, y.data_ptr(), s.data_ptr(), b.data_ptr(),
                p.data_ptr(), gg.data_ptr(), dy.data_ptr(), part.data_ptr(),
                dsb.data_ptr(), bb, X, Y, Z, C, C if lanes else 0,
                float(slope), pool3d._MODES[mode], int(round_gi), grid,
                _build.DTYPE_CODES[y.dtype], 0, 0, variant="direct")
            return dy, dsb
        return run

    def pool_cases(label, shape, timed, lanes, mode, identity=False,
                   ties=False):
        """K4 and K7 at one shape in one mode, each checked against its
        plain version, "vec" against "direct" bit for bit (K4; K7's dy)
        and K7's two calls on the same inputs bit for bit; `timed` adds
        "direct"'s time in the same run. `identity`: plain pooling, with
        the library's pooling and its backward as yardsticks; untimed, K4
        through the public entry (which makes the identity affine too)"""
        round_gi = mode == "max" and (lanes or identity)
        ref = functools.partial(pool3d.affine_act_pool_reference, mode=mode)
        k7_kern, k7_plain = k7(mode, lanes, round_gi)
        if shape[0] == FULL_BATCH and shape[1] == FULL_VOLUME[0]:
            ref = _by_sample(ref, (0,))
            k7_plain = _by_sample(k7_plain, (0, 3, 4), summed=(1,))
        fwd_tol = ([_elem(1e-6, 1e-6)], [_elem(BF16_RTOL, 0.0)]) \
            if mode == "avg" else (exact, exact)
        kern, direct = k4(mode, lanes), k4_direct(mode, lanes)
        k7_dir = k7_direct(mode, lanes, round_gi)
        if identity and not timed:
            entry = (pool3d.max_pool3d_2x2 if mode == "max"
                     else pool3d.avg_pool3d_2x2)
            kern = lambda y, *_: entry(y)  # noqa: E731
        return [
            Case("affine_act_pool", label, kern, ref,
                 pool(shape, lanes, ties, identity), *fwd_tol, pool_ops,
                 lib_pool(mode) if identity else None,
                 direct if timed else None, timed, earlier_name="direct",
                 twin=direct),
            Case("affine_act_pool_bwd", label, k7_kern, k7_plain,
                 pool_bwd(shape, lanes, mode, identity, ties), *bwd,
                 pool_bwd_ops, lib_pool_bwd(mode) if identity else None,
                 k7_dir if timed else None, timed, repeat=True,
                 earlier_name="direct",
                 twin=lambda *args: k7_dir(*args)[0],
                 library_bwd=identity, unread=(3,) if mode == "avg" else ())]

    def tokens(b, n, d):
        def make(dt):
            return _randn(g, b, n, d).to(dt), _randn(g, b, n, d).to(dt)
        return make

    def token_column(mri, pet):
        """K1's "column" variant, whatever the shape"""
        b, n, d = mri.shape
        out = torch.empty(b, 4 * d, dtype=mri.dtype, device="cuda")
        pooling.TOKEN_POOL.launch(mri.device, mri.data_ptr(), pet.data_ptr(),
                                  out.data_ptr(), b, n, d,
                                  _build.DTYPE_CODES[mri.dtype], 0,
                                  variant="column")
        return out

    def stem_in(b, volume, c=32):
        def make(dt):
            return (_randn(g, b, *volume).to(dt),
                    _randn(g, 3, 3, 3, c, scale=0.2).to(dt))
        return make

    def dw_in(b, volume, c=32, zero_ab=False):
        def make(dt):
            a, b2 = _randn(g, c), _randn(g, c, scale=0.1)
            if zero_ab:
                a, b2 = torch.zeros_like(a), torch.zeros_like(b2)
            return (_randn(g, b, *volume).to(dt),
                    _randn(g, b, *volume, c).to(dt),
                    _randn(g, b, *volume, c).to(dt), a, b2)
        return make

    def band_in(cin, cout):
        def make(dt):
            return (_randn(g, FULL_BATCH, *VOLUME, cin).to(dt),
                    _randn(g, 3, 3, 3, cin, cout,
                           scale=(13.5 * cin) ** -0.5).to(dt))
        return make

    def band_dw_in(cin, cout, with_ab):
        def make(dt):
            x = _randn(g, FULL_BATCH, *VOLUME, cin).to(dt)
            gy = _randn(g, FULL_BATCH, *VOLUME, cout).to(dt)
            if not with_ab:
                return x, gy
            return (x, gy, _randn(g, FULL_BATCH, *VOLUME, cout).to(dt),
                    _randn(g, cout), _randn(g, cout, scale=0.1))
        return make

    # operations: 2 per multiply-add of a product, a handful per element of
    # an elementwise pass
    def conv_ops(x, w, *_):
        return 2 * 27 * x.numel() * w.shape[-1], "mma"

    def band_dw_ops(x, gy, *_):
        return 2 * 27 * x.numel() * gy.shape[-1], "mma"

    def stem_dw_ops(x, y, *_):
        return 2 * 27 * y.numel(), "mma"

    def attn_ops(q, k, *_):
        return 4 * q.numel() * k.shape[2], "mma"

    def dq_ops(q, k, *_):  # s, dp and ds k
        return 6 * q.numel() * k.shape[2], "mma"

    def dkv_ops(q, k, *_):  # s, dp, p^T g and ds^T q
        return 8 * q.numel() * k.shape[2], "mma"

    def pool_ops(y, *_):
        return 4 * y.numel(), "f32"  # multiply, add, select, max or add

    def pool_bwd_ops(y, *_):
        return 10 * y.numel(), "f32"

    def token_ops(mri, pet):
        return 2 * (mri.numel() + pet.numel()), "f32"

    # the one PyTorch call that computes the same function, for its time
    def lib_stem(x, w):
        return F.conv3d(x.unsqueeze(1), stem._oidhw(w), padding=1)

    def lib_stem_dw(x, y, gy, a, b2):
        return conv3d_weight(x.unsqueeze(1), (y.shape[-1], 1, 3, 3, 3),
                             gy.permute(0, 4, 1, 2, 3), padding=1)

    def lib_band(x, w):
        wt = w.permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        return F.conv3d(x.permute(0, 4, 1, 2, 3), wt, padding=1)

    def lib_band_dw(x, gy, *_):
        return conv3d_weight(x.permute(0, 4, 1, 2, 3),
                             (gy.shape[-1], x.shape[-1], 3, 3, 3),
                             gy.permute(0, 4, 1, 2, 3), padding=1)

    def lib_pool(mode):
        """F.max_pool3d / F.avg_pool3d on the channels_last_3d view of y"""
        fn = F.max_pool3d if mode == "max" else F.avg_pool3d
        return lambda y, *_: fn(y.permute(0, 4, 1, 2, 3), 2)

    def lib_pool_bwd(mode):
        """their autograd backward alone (the forward runs outside the
        timed call); for max it routes a window's gradient to one index,
        the same function as K7's only where the window's maximum is
        unique, and its time does not depend on that"""
        fn = F.max_pool3d if mode == "max" else F.avg_pool3d

        def prep(y, s, b, p, gg, slope):
            x = y.permute(0, 4, 1, 2, 3).detach().requires_grad_()
            out = fn(x, 2)
            go = gg.permute(0, 4, 1, 2, 3)
            return lambda: torch.autograd.grad(out, x, go, retain_graph=True)
        return prep

    def lib_attn(q, k, v, scale):
        return F.scaled_dot_product_attention(q, k, v, scale=scale)

    def lib_attn_bwd(q, k, v, gg, lse, delta, scale):
        """forward and backward through the library call: dq, dk and dv
        together, the yardstick of K11 + K12 (+ K10)"""
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v, scale=scale)
        return torch.autograd.grad(out, (q, k, v), gg)

    def lib_attn_bwd_alone(q, k, v, gg, lse, delta, scale):
        """the library call's backward alone, the yardstick of K11 + K12:
        its forward runs here, outside the timed call; the name of its
        backward node says which backend SDPA took"""
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v, scale=scale)
        return (lambda: torch.autograd.grad(out, (q, k, v), gg,
                                            retain_graph=True),
                f"SDPA backward alone, {out.grad_fn.name()}")

    def band_direct(stats):
        """K8's "direct" variant on the arguments of `_band_forward`,
        whatever their dtype"""
        def run(x, w):
            b, X, Y, Z, cin = x.shape
            cout = w.shape[-1]
            out = torch.empty(b, X, Y, Z, cout, dtype=x.dtype, device="cuda")
            rows = band_conv._blocks_fn()(b, X, Y, Z, cin, cout, 0)
            part = torch.empty(2, rows, cout, device="cuda") if stats else None
            st = torch.empty(2, cout, device="cuda") if stats else None
            band_conv.BAND_CONV.launch(
                x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(),
                part.data_ptr() if stats else None,
                st.data_ptr() if stats else None, b, X, Y, Z, cin, cout,
                int(stats), _build.DTYPE_CODES[x.dtype], 0, variant="direct")
            return (out, st) if stats else out
        return run

    def attn_rows(q, k, v, scale):
        """K2's "rows" variant, whatever the dtype"""
        out = torch.empty_like(q)
        b, h, n, d = q.shape
        fa.ATTENTION.launch(q.device, q.data_ptr(), k.data_ptr(),
                            v.data_ptr(), out.data_ptr(), b * h, n,
                            k.shape[2], d, float(scale),
                            _build.DTYPE_CODES[q.dtype], 0, variant="rows")
        return out

    def flash_rows(q, k, v, scale):
        """K10's "rows" variant, whatever the dtype"""
        out = torch.empty_like(q)
        b, h, n, d = q.shape
        lse = torch.empty(b, h, n, device="cuda")
        fa.FLASH_FWD.launch(q.device, q.data_ptr(), k.data_ptr(),
                            v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                            b * h, n, k.shape[2], d, float(scale),
                            _build.DTYPE_CODES[q.dtype], 0, variant="rows")
        return out, lse

    def bwd_rows(kernel):
        """K11's or K12's "rows" variant on the arguments of `flash_dq` /
        `flash_dkv`, whatever the dtype"""
        def run(q, k, v, gg, lse, delta, scale):
            b, h, n, d = q.shape
            outs = ((torch.empty_like(q),) if kernel is fa.FLASH_DQ
                    else (torch.empty_like(k), torch.empty_like(v)))
            kernel.launch(q.device, *(t.data_ptr() for t in
                                      (q, k, v, gg, lse, delta, *outs)),
                          b * h, n, k.shape[2], d, float(scale),
                          _build.DTYPE_CODES[q.dtype], 0, variant="rows")
            return outs if len(outs) > 1 else outs[0]
        return run

    def stem_direct(stats):
        """K3's (with `stats` K5's) "direct" variant on the arguments of
        `stem_conv`, whatever their dtype"""
        def run(x, w):
            b, X, Y, Z = x.shape
            c = w.shape[-1]
            out = torch.empty(b, X, Y, Z, c, dtype=x.dtype, device="cuda")
            code = _build.DTYPE_CODES[x.dtype]
            if not stats:
                stem.STEM_CONV.launch(x.device, x.data_ptr(), w.data_ptr(),
                                      out.data_ptr(), b, X, Y, Z, c, code, 0,
                                      variant="direct")
                return out
            part = torch.empty(2, stem._blocks_fn()(b, X, Y, Z, 0), c,
                               device="cuda")
            st = torch.empty(2, c, device="cuda")
            stem.STEM_CONV_STATS.launch(
                x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(),
                part.data_ptr(), st.data_ptr(), b, X, Y, Z, c, code, 0,
                variant="direct")
            return out, st
        return run

    def stem_dw_direct(x, y, gy, a, b2):
        """K6's "direct" variant on the arguments of `stem_dw`, whatever
        their dtype"""
        b, X, Y, Z = x.shape
        c = y.shape[-1]
        part = torch.empty(stem._dw_rows_fn()(b, X, Y, Z, 0), 27 * c,
                           device="cuda")
        dw = torch.empty(3, 3, 3, c, device="cuda")
        stem.STEM_DW.launch(
            x.device, x.data_ptr(), y.data_ptr(), gy.data_ptr(), a.data_ptr(),
            b2.data_ptr(), part.data_ptr(), dw.data_ptr(), b, X, Y, Z, c,
            _build.DTYPE_CODES[x.dtype], 0, variant="direct")
        return dw

    def dw_direct(x, gy, y=None, a=None, b2=None):
        """K9's "direct" variant on the arguments of `band_dw`, whatever
        their dtype"""
        b, X, Y, Z, cin = x.shape
        cout = gy.shape[-1]
        rows = band_conv._dw_rows_fn()(b, X, Y, Z, cin, cout, 0)
        part = torch.empty(rows, 27 * cin * cout, device="cuda")
        dw = torch.empty(3, 3, 3, cin, cout, device="cuda")
        ab = a is not None
        band_conv.BAND_DW.launch(
            x.device, x.data_ptr(), y.data_ptr() if ab else None,
            gy.data_ptr(), a.data_ptr() if ab else None,
            b2.data_ptr() if ab else None, part.data_ptr(), dw.data_ptr(), b,
            X, Y, Z, cin, cout, int(ab), _build.DTYPE_CODES[x.dtype], 0,
            variant="direct")
        return dw

    exact = [_elem(0.0, 0.0)]
    # float32: the order of f32 sums differs (and cuDNN may pick Winograd or
    # FFT algorithms for the plain conv); bfloat16: one ulp of the output,
    # since both sides round the same f32 value once
    sums = [_elem(1e-4, 2e-5)], [_elem(BF16_RTOL, 1e-4)]
    conv = [_elem(1e-4, 1e-4)], [_elem(BF16_RTOL, 1e-3)]
    # K7: dy is the same float32 arithmetic on both sides (exact; one bf16
    # ulp allowed); d(scale), d(shift), the BN sums and dw are float32 sums
    # over up to 4.3e7 terms in another order (1e-4 of their largest
    # magnitude, 1e-2 from bfloat16 inputs)
    bwd = ([_elem(0.0, 0.0), _sums(1e-4)], [_elem(BF16_RTOL, 0.0),
                                             _sums(1e-2)])
    conv_stats = conv[0] + [_sums(1e-4)], conv[1] + [_sums(1e-2)]
    dw_tol = [_sums(1e-4)], [_sums(1e-2)]
    # K10-K12: float32 sums over up to 3,146 signed terms in another order
    # (the "mma" variants' bfloat16 products are exact, P and dS enter as
    # hi + lo within 2^-17): 1e-4 of the output's scale; bfloat16 adds the
    # one rounding of the output (one ulp); the float32 lse 1e-5 absolute
    flash1 = [_scaled(0.0, 1e-4)], [_scaled(BF16_RTOL, 1e-4)]
    flash2 = flash1[0] * 2, flash1[1] * 2
    flash_fwd_tol = (flash1[0] + [_elem(0.0, 1e-5)],
                     flash1[1] + [_elem(0.0, 1e-5)])
    stage1, stage2 = (BATCH, *VOLUME, 32), (BATCH, 45, 54, 45, 64)
    stage3, stage4 = (BATCH, 22, 27, 22, 128), (BATCH, 11, 13, 11, 128)
    # the full-resolution shapes, at the step's batch: the stem's output
    # (2.77 GB in bfloat16, over 2^31 bytes) and the stage-2 end; the plain
    # versions of the stem's kernels and of its pool go sample by sample
    full1 = (FULL_BATCH, *FULL_VOLUME, 32)
    full2 = (FULL_BATCH, *VOLUME, 64)
    full_in = f"({FULL_BATCH},{','.join(map(str, FULL_VOLUME))})"
    band_fwd = functools.partial(band_conv._band_forward, stats=False)
    band_fwd_stats = functools.partial(band_conv._band_forward, stats=True)
    cases = [
        # K1 at the fusion head of a 91x109x91 request (150 tokens) and of a
        # 182x218x182 one (11 x 13 x 11 = 1,573 tokens, batch 6), "column"
        # timed beside "cluster"
        *(Case("token_pool", f"({b},{n},128)x2", pooling.fused_token_pool,
               pooling.pool_reference, tokens(b, n, 128), *sums, token_ops,
               earlier=token_column, repeat=True, earlier_name="column",
               record=record, queued=True)
          for b, n, record in ((BATCH, 150, None),
                               (FULL_BATCH, 1573, "full_resolution"))),
        Case("attention_fwd", "(32,150,32)", fused_attention,
             attention_reference, attn(8, 4, 150, 32), *sums, attn_ops,
             lib_attn, attn_rows),
        Case("attention_fwd", CROSSOVER["attention_fwd", FLASH_SHAPE[2]],
             fused_attention, attention_reference,
             attn(2, *FLASH_SHAPE[1:4]), *sums, attn_ops, lib_attn,
             attn_rows),
        # K2 on phase 15's paths at batch 8: ADVIT's ViTs (3 heads x 64,
        # 8 x 8 patches + CLS) and the hold-out ModelAd (8 heads x 16)
        *(Case("attention_fwd", f"({BATCH * h},{n},{n},{d})",
               fused_attention, attention_reference, attn(BATCH, h, n, d),
               *sums, attn_ops, lib_attn, attn_rows)
          for h, n, d in ((ADVIT_HEADS, ADVIT_TOKENS, 64),
                          (HOLDOUT_HEADS, 150, 128 // HOLDOUT_HEADS))),
        Case("stem_conv", "(8,91,109,91)->C32", stem.stem_conv,
             stem._conv_reference, stem_in(BATCH, VOLUME), *conv, conv_ops,
             lib_stem, stem_direct(False)),
        Case("stem_conv_stats", "(8,91,109,91)->C32 + (2,32) sums",
             stem.stem_conv_stats, stem._stem_stats_reference,
             stem_in(BATCH, VOLUME), *conv_stats, conv_ops, lib_stem,
             stem_direct(True), repeat=True),
        Case("stem_dw", "(8,91,109,91) x (..,32) -> (3,3,3,32)", stem.stem_dw,
             stem.stem_dw_reference, dw_in(BATCH, VOLUME), *dw_tol,
             stem_dw_ops, lib_stem_dw, stem_dw_direct, repeat=True),
        # K4 and K7 at the shapes of the 91x109x91 path: the four stage ends,
        # then plain max and mean pooling (library: F.max_pool3d and
        # F.avg_pool3d on a channels_last_3d tensor, and their backward)
        *pool_cases("max lanes (8,91,109,91,32)", stage1, True, True, "max"),
        *pool_cases("max chan (8,45,54,45,64)", stage2, True, False, "max"),
        *pool_cases("max chan (8,22,27,22,128)", stage3, True, False, "max"),
        *pool_cases("avg chan (8,11,13,11,128)", stage4, True, False, "avg"),
        *pool_cases("identity max (8,11,13,11,128)", stage4, True, False,
                    "max", identity=True),
        *pool_cases("identity avg (8,11,13,11,128)", stage4, True, False,
                    "avg", identity=True),
        # --- the full-resolution path -------------------------------------
        Case("stem_conv", f"{full_in}->C32", stem.stem_conv,
             _by_sample(stem._conv_reference, (0,)),
             stem_in(FULL_BATCH, FULL_VOLUME), *conv, conv_ops, lib_stem,
             stem_direct(False)),
        Case("stem_conv_stats", f"{full_in}->C32 + (2,32) sums",
             stem.stem_conv_stats,
             _by_sample(stem._stem_stats_reference, (0,), summed=(1,)),
             stem_in(FULL_BATCH, FULL_VOLUME), *conv_stats, conv_ops,
             lib_stem, stem_direct(True), repeat=True),
        Case("stem_dw", f"{full_in} x (..,32) -> (3,3,3,32)", stem.stem_dw,
             _by_sample(stem.stem_dw_reference, (0, 1, 2), summed=(0,)),
             dw_in(FULL_BATCH, FULL_VOLUME), *dw_tol, stem_dw_ops,
             lib_stem_dw, stem_dw_direct, repeat=True),
        *pool_cases(f"max lanes {full_in[:-1]},32), 5824 lanes", full1,
                    True, True, "max"),
        *pool_cases("max lanes (6,91,109,91,64), 5824 lanes", full2, True,
                    True, "max"),
    ]
    # K10-K12 at the joint context of a 182x218x182 pair (1,573 queries of a
    # modality over 3,146 keys; 1,573 = 49 x 32 + 5 and 3,146 = 98 x 32 + 10
    # give a partial tile of each kind), then a head dim off the lane grid
    # and a single partial chunk of keys; K2 and K10 at each other's shape
    fb, fh, fn, fd, fm = FLASH_SHAPE
    for b, h, n, d, m in (FLASH_SHAPE, (1, 4, 37, 48, 2100),
                          (1, 2, 300, 32, 100)):
        shape = f"({b * h},{n},{m},{d})"
        mma_bwd = d in fa.BWD_MMA_HEAD_DIMS
        cases += [
            Case("flash_fwd", shape + " + lse", fa.flash_fwd,
                 fa.flash_fwd_reference, attn(b, h, n, d, m), *flash_fwd_tol,
                 attn_ops, lib_attn,
                 flash_rows if d in fa.MMA_HEAD_DIMS else None),
            Case("flash_dq", shape, fa.flash_dq, fa.flash_dq_reference,
                 attn_bwd(b, h, n, d, m), *flash1, dq_ops, lib_attn_bwd,
                 bwd_rows(fa.FLASH_DQ) if mma_bwd else None,
                 library_part=lib_attn_bwd_alone),
            Case("flash_dkv", shape, fa.flash_dkv, fa.flash_dkv_reference,
                 attn_bwd(b, h, n, d, m), *flash2, dkv_ops, lib_attn_bwd,
                 bwd_rows(fa.FLASH_DKV) if mma_bwd else None,
                 library_part=lib_attn_bwd_alone)]
    cases += [
        Case("flash_fwd", CROSSOVER["flash_fwd", fn], fa.flash_fwd,
             fa.flash_fwd_reference, attn(2, fh, fn, fd), *flash_fwd_tol,
             attn_ops, lib_attn, flash_rows),
        Case("attention_fwd", CROSSOVER["attention_fwd", fm],
             fused_attention, attention_reference, attn(fb, fh, fn, fd, fm),
             *sums, attn_ops, lib_attn, attn_rows)]
    # K8 and K9 at the stage-2 volume of a 182x218x182 input: the two convs
    # and their input gradients (Cin and Cout swapped)
    for cin, cout in ((32, 32), (32, 64), (64, 32)):
        shape = f"(6,91,109,91) {cin}->{cout}"
        cases.append(Case("band_conv", shape, band_fwd,
                          band_conv.band_conv_reference, band_in(cin, cout),
                          *conv, conv_ops, lib_band, band_direct(False)))
        if cin == 32:
            cases.append(Case("band_conv", shape + " + (2,C) sums",
                              band_fwd_stats,
                              band_conv.band_conv_stats_reference,
                              band_in(cin, cout), *conv_stats, conv_ops,
                              lib_band, band_direct(True)))
    # edge cases of K8 "mma" (float32 takes "direct" at the same shapes): one
    # plane and two (the ring's edges), Y and Z one below, at and one above
    # a tile, batch 2, 64 -> 32 (the wgmma kernel's other width), 64 -> 64
    # and 128 -> 128 (the mma.sync kernel, weights staged 9 taps and 1 tap
    # at a time; two blocks of output channels), 16 -> 8 (one partly empty
    # block of output channels), three segments along x
    def band_small(b, volume, cin, cout):
        def make(dt):
            return (_randn(g, b, *volume, cin).to(dt),
                    _randn(g, 3, 3, 3, cin, cout,
                           scale=(13.5 * cin) ** -0.5).to(dt))
        return make

    for b, volume, cin, cout in ((1, (1, 9, 17), 32, 32),
                                 (1, (2, 8, 16), 32, 32),
                                 (1, (3, 7, 15), 16, 8),
                                 (2, (3, 9, 17), 32, 64),
                                 (1, (3, 9, 17), 64, 32),
                                 (1, (4, 10, 20), 64, 64),
                                 (1, (3, 9, 18), 128, 128),
                                 (1, (20, 9, 17), 16, 8)):
        shape = f"({b},{','.join(map(str, volume))}) {cin}->{cout}"
        cases += [
            Case("band_conv", shape, band_fwd, band_conv.band_conv_reference,
                 band_small(b, volume, cin, cout), *conv, conv_ops,
                 timed=False),
            Case("band_conv", shape + " + (2,C) sums", band_fwd_stats,
                 band_conv.band_conv_stats_reference,
                 band_small(b, volume, cin, cout), *conv_stats, conv_ops,
                 timed=False)]
    # edge cases of K4 and K7, both variants (the wrapper's, then "direct"
    # bit for bit): odd tails on each axis, Z*C one group, a pooled row of
    # 376, 384 and 392 bfloat16 lanes (one block below, at and above its
    # 384 threads: two slices; float32 has twice the lanes), C 8 and 16,
    # C 12 (bfloat16 "direct", float32 "vec"), many ties, and the identity
    # max and mean entries
    for label, shape in (("odd X", (2, 7, 6, 6, 32)),
                         ("odd Y", (2, 6, 9, 6, 32)),
                         ("odd Z", (2, 6, 6, 9, 32)),
                         ("odd X, Y, Z", (1, 5, 7, 9, 16)),
                         ("Z*C one group", (1, 3, 5, 2, 8)),
                         ("C 8", (2, 5, 6, 7, 8)),
                         ("C 12", (2, 5, 6, 7, 12)),
                         ("376 lanes", (1, 3, 5, 95, 64)),
                         ("384 lanes", (1, 3, 5, 96, 64)),
                         ("392 lanes", (1, 3, 4, 98, 64))):
        for lanes, mode in ((True, "max"), (False, "max"), (False, "avg")):
            cases += pool_cases(
                f"{mode} {'lanes' if lanes else 'chan'} {label} {shape}",
                shape, False, lanes, mode)
    for lanes, identity in ((True, False), (False, False), (False, True)):
        cases += pool_cases(
            f"max {'identity' if identity else 'lanes' if lanes else 'chan'}"
            " ties (2,6,8,10,32)", (2, 6, 8, 10, 32), False, lanes, "max",
            identity=identity, ties=True)
    for mode in ("max", "avg"):
        cases += pool_cases(f"{mode} identity entry (1,5,7,9,16)",
                            (1, 5, 7, 9, 16), False, False, mode,
                            identity=True)
    # edge cases of K1, each in the variant its rule names and bit for bit
    # over two calls: an odd token count (a short last chunk), one token,
    # fewer tokens than a block's rows (one block a cluster), D 32 and 48
    # ("cluster"; 48 with a partly idle block), D 12 ("column" in bfloat16,
    # "cluster" in float32), D 6 ("column"), 256 pieces a row (one row a
    # block) and 257 ("column")
    for b, n, d in ((3, 157, 128), (2, 1, 128), (2, 9, 128), (4, 150, 32),
                    (2, 157, 48), (2, 33, 12), (2, 20, 6), (1, 40, 2048),
                    (1, 12, 2056)):
        cases.append(Case("token_pool", f"({b},{n},{d})x2",
                          pooling.fused_token_pool, pooling.pool_reference,
                          tokens(b, n, d), *sums, token_ops, timed=False,
                          repeat=True))
    # edge cases of K2 "mma" (float32 takes "rows"): one query, one key, a
    # partial first chunk, keys and queries one below, at and one above a
    # chunk and a block, every head dim; then the full-resolution path's
    # own shape, batch 6
    for b, h, n, d, m in ((1, 2, 1, 32, 70), (1, 2, 40, 32, 1),
                          (1, 2, 70, 32, 17), (1, 2, 63, 32, 63),
                          (1, 2, 64, 32, 64), (1, 2, 65, 32, 65),
                          (2, 2, 100, 16, 100), (2, 2, 100, 64, 130),
                          (1, 2, 100, 128, 130), (fb, fh, fn, fd, fn)):
        cases.append(Case("attention_fwd", f"({b * h},{n},{m},{d})",
                          fused_attention, attention_reference,
                          attn(b, h, n, d, m), *sums, attn_ops, lib_attn,
                          attn_rows if n == fn else None, timed=n == fn))
    # edge cases of K10 "mma" (float32 takes "rows"): one query, one key, a
    # partial first chunk, one above a chunk, every head dim
    for b, h, n, d, m in ((1, 2, 1, 32, 70), (1, 2, 40, 32, 1),
                          (1, 2, 70, 32, 17), (1, 2, 65, 32, 65),
                          (2, 2, 100, 16, 100), (2, 2, 100, 64, 130),
                          (1, 2, 100, 128, 130)):
        cases.append(Case("flash_fwd", f"({b * h},{n},{m},{d}) + lse",
                          fa.flash_fwd, fa.flash_fwd_reference,
                          attn(b, h, n, d, m), *flash_fwd_tol, attn_ops,
                          timed=False))
    # edge cases of K11 and K12 "mma" (float32 and D = 128 take "rows"): one
    # query, two keys (with one key, p = 1 and dq = dk = 0: both sides give
    # rounding noise, which has no scale to hold it to), partial chunks and
    # blocks on both axes, a chunk and one, every head dim
    for b, h, n, d, m in ((1, 2, 1, 32, 70), (1, 2, 40, 32, 2),
                          (1, 2, 70, 32, 17), (1, 2, 65, 32, 65),
                          (2, 2, 100, 16, 100), (2, 2, 100, 64, 130),
                          (1, 2, 100, 128, 130)):
        shape = f"({b * h},{n},{m},{d})"
        cases += [
            Case("flash_dq", shape, fa.flash_dq, fa.flash_dq_reference,
                 attn_bwd(b, h, n, d, m), *flash1, dq_ops, timed=False),
            Case("flash_dkv", shape, fa.flash_dkv, fa.flash_dkv_reference,
                 attn_bwd(b, h, n, d, m), *flash2, dkv_ops, timed=False)]
    # edge cases of K6 "mma" (float32 takes "direct"): 16 and 64 channels
    # (one and four pairs of n-tiles), 48, 24 (which the rule sends to
    # "direct"), batch 1 and 2, one plane, Y and Z off the 16 x 16 tile and
    # on it, segments along x, a = b2 = 0
    for b, volume, c, zero_ab in ((1, (5, 17, 18), 16, False),
                                  (2, (4, 20, 35), 64, False),
                                  (1, (3, 17, 15), 48, False),
                                  (1, (3, 9, 17), 24, False),
                                  (1, (1, 33, 31), 32, False),
                                  (1, (20, 9, 17), 32, False),
                                  (2, (3, 16, 16), 32, True)):
        cases.append(Case(
            "stem_dw", f"({b},{','.join(map(str, volume))}) x (..,{c})"
            + (" a = b2 = 0" if zero_ab else ""), stem.stem_dw,
            stem.stem_dw_reference, dw_in(b, volume, c, zero_ab), *dw_tol,
            stem_dw_ops, timed=False, repeat=True))
    # edge cases of K3 and K5 "mma" (float32 takes "direct"): 16, 48 and 64
    # channels (the quads' 8-byte pieces, and two groups of 16-byte ones),
    # 24 (which the rule sends to "direct"), batch 1 and 2, one plane, Y one
    # below, at and one above the tile's 32 rows, Z one below, at and one
    # above its 16 voxels (odd Z: rows of x not 16-byte aligned), several
    # tiles along y and z, segments along x
    for b, volume, c in ((1, (1, 15, 15), 32), (2, (3, 16, 16), 32),
                         (1, (3, 17, 17), 32), (1, (5, 17, 18), 16),
                         (1, (3, 17, 15), 48), (2, (4, 20, 35), 64),
                         (1, (3, 9, 17), 24), (1, (20, 9, 17), 32),
                         (1, (3, 31, 16), 32), (1, (2, 32, 33), 64),
                         (2, (5, 33, 31), 32)):
        shape = f"({b},{','.join(map(str, volume))})->C{c}"
        cases += [
            Case("stem_conv", shape, stem.stem_conv, stem._conv_reference,
                 stem_in(b, volume, c), *conv, conv_ops, timed=False),
            Case("stem_conv_stats", shape + f" + (2,{c}) sums",
                 stem.stem_conv_stats, stem._stem_stats_reference,
                 stem_in(b, volume, c), *conv_stats, conv_ops, timed=False,
                 repeat=True)]
    for cin, cout in ((32, 32), (32, 64)):
        for with_ab in (True, False):
            cases.append(Case(
                "band_dw", f"(6,91,109,91) {cin}x{cout} -> (3,3,3,{cin},"
                f"{cout})" + (" with a, b2" if with_ab else ""),
                band_conv.band_dw, band_conv.band_dw_reference,
                band_dw_in(cin, cout, with_ab), *dw_tol, band_dw_ops,
                lib_band_dw, dw_direct))
    # edge cases of K9 "mma" (float32 takes "direct"), each with and without
    # a, b2: one plane and two, Y and Z one below, at and one above its
    # 16 x 16 voxel tile, batch 2, 16 -> 8 (one partly empty group of output
    # channels), 64 x 64 and 128 x 128 (blocks of input and output
    # channels), several tiles along y and z, segments along x
    def dw_small(b, volume, cin, cout, with_ab):
        def make(dt):
            x = _randn(g, b, *volume, cin).to(dt)
            gy = _randn(g, b, *volume, cout).to(dt)
            if not with_ab:
                return x, gy
            return (x, gy, _randn(g, b, *volume, cout).to(dt),
                    _randn(g, cout), _randn(g, cout, scale=0.1))
        return make

    for b, volume, cin, cout in ((1, (1, 15, 15), 32, 32),
                                 (1, (2, 16, 16), 32, 64),
                                 (2, (3, 17, 17), 32, 64),
                                 (1, (3, 9, 17), 16, 8),
                                 (1, (4, 10, 20), 64, 64),
                                 (1, (3, 9, 18), 128, 128),
                                 (1, (20, 33, 35), 64, 32)):
        for with_ab in (True, False):
            cases.append(Case(
                "band_dw", f"({b},{','.join(map(str, volume))}) {cin}x{cout}"
                + (" with a, b2" if with_ab else ""), band_conv.band_dw,
                band_conv.band_dw_reference,
                dw_small(b, volume, cin, cout, with_ab), *dw_tol,
                band_dw_ops, timed=False))
    # K13: both modalities in one launch, on uniforms that give every kind
    # of draw (`AUGMENT_ROWS`) under the default configuration
    from transmf_ad_tpu_torch.data import transforms

    def aug_in(b, volume):
        def make(dt):
            vols = [torch.rand(b, *volume, generator=g, device="cuda").to(dt)
                    for _ in range(2)]
            u = torch.tensor(AUGMENT_ROWS, device="cuda")
            return (*vols, u[torch.arange(b, device="cuda") % len(u)])
        return make

    def aug(mri, pet, u):
        out = transforms.augment_batch({"MRI": mri, "PET": pet}, u)
        return out["MRI"], out["PET"]

    def aug_plain(mri, pet, u):
        out = transforms.augment_reference({"MRI": mri, "PET": pet}, u,
                                           transforms.AugmentConfig())
        return out["MRI"], out["PET"]

    def aug_ops(mri, pet, u):  # the gather's 7 mixes of 3 operations
        return 21 * 2 * mri.numel(), "f32"

    # float32: on the card PyTorch divides by a Python scalar (the zoom)
    # through its float32 reciprocal, so the plain version's source
    # coordinates lie up to an ulp from K13's, which divides as the CPU does
    # (1.5e-5 at 218 voxels, moving a value by as much times its step);
    # tests/test_torch_augment.py holds K13 to the plain version on the
    # CPU within 1e-5 and to its emulation bit for bit
    aug_tol = [_scaled(0.0, 1e-4)] * 2, [_elem(BF16_RTOL, 0.0)] * 2
    cases += [
        Case("augment", f"({FULL_BATCH},{','.join(map(str, FULL_VOLUME))}) x2",
             aug, aug_plain, aug_in(FULL_BATCH, FULL_VOLUME), *aug_tol,
             aug_ops, repeat=True),
        Case("augment", "(8,6,256,256) x2, a plane over the shared memory",
             aug, aug_plain, aug_in(8, (6, 256, 256)), *aug_tol, aug_ops,
             timed=False)]
    # K14: swin_unetr's window attention at each call of its cell's train
    # step (`_swin_calls`), forward and backward, on the card against the
    # plain version run one sample at a time (stage 1's scores are 3.8 GB a
    # sample in float32), its sums over the batch added in float64; the
    # tolerances of tests/test_torch_swin.py's card test
    from transmf_ad_tpu_torch.ops import window_attention as wa

    full = (SWIN_WINDOW,) * 3
    window_plain = _by_sample(wa.window_attention_reference, (0,))

    def window_in(grid, heads, shift, bwd):
        def make(dt):
            c = heads * wa.HEAD_DIM
            qkv = _randn(g, FULL_BATCH, *grid, 3 * c).to(dt)
            bias = _randn(g, 3 * c, scale=0.5).to(dt)
            table = _randn(g, wa.table_size(full), heads, scale=0.5)
            window, sh = wa.window_size(grid, full, (shift,) * 3)
            geo = ([*window], [*sh], [*full], wa.HEAD_DIM ** -0.5)
            if not bwd:
                return (qkv, bias, table, *geo)
            out, lse = window_plain(qkv, bias, table, *geo)
            return (qkv, bias, table, out, lse,
                    _randn(g, *out.shape).to(dt), *geo)
        return make

    def window_bwd_plain(qkv, bias, table, out, lse, gg, *geo):
        nw = lse.shape[0] // qkv.shape[0]
        parts = [wa.window_attention_bwd_reference(
            qkv[i:i + 1], bias, table, out[i:i + 1],
            lse[i * nw:(i + 1) * nw], gg[i:i + 1], *geo)
            for i in range(qkv.shape[0])]
        dqkv, dbias, dtable = zip(*parts)
        return (torch.cat(dqkv), torch.stack(dbias).double().sum(0).float(),
                torch.stack(dtable).double().sum(0).float())

    def window_ops(qkv, bias, table, *rest):  # QK^T and PV, padded rows too
        window = rest[-4]
        windows = qkv.shape[0] * wa.window_count(qkv.shape[1:4], window)
        n = math.prod(window)
        return 4 * windows * table.shape[1] * n * n * wa.HEAD_DIM, "mma"

    def window_bwd_ops(*args):  # S and dP twice, dQ, dK, dV: 7 products
        ops, kind = window_ops(*args)
        return 7 * ops // 2, kind

    fwd_tol = ([_elem(1e-5, 1e-5)] * 2,
               [_elem(BF16_RTOL, 1e-4), _elem(1e-5, 1e-5)])
    bwd_tol = ([_elem(1e-5, 1e-5), _sums(1e-4), _sums(1e-4)],
               [_elem(BF16_RTOL, 1e-4), _sums(1e-2), _sums(1e-2)])
    for label, grid, heads, shift in _swin_calls():
        cases += [
            Case("window_attention_fwd", label, wa.window_attention_op,
                 window_plain, window_in(grid, heads, shift, False),
                 *fwd_tol, window_ops, repeat=True, record=label),
            Case("window_attention_bwd", label, wa.window_attention_bwd_op,
                 window_bwd_plain, window_in(grid, heads, shift, True),
                 *bwd_tol, window_bwd_ops, record=label)]
    return cases


def _agree(out, ref, tol) -> bool:
    kind, rtol, atol = tol
    if not bool(torch.isfinite(out).all()):
        return False
    if kind == "sum":
        return bool((out.float() - ref.float()).abs().max()
                    <= rtol * ref.float().abs().max())
    if kind == "scaled":
        atol *= ref.float().abs().max().item()
    return torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol)


def _bound(case, args, outs, tag):
    """(ms, "bytes" or "operations"): the least time the card could take
    for this call, the larger of its bytes (every input tensor read once,
    every output written once) over the HBM rate and its operations over
    the peak for their type: the tensor cores' for products of bfloat16
    inputs, the CUDA cores' float32 rate otherwise."""
    read = [a for i, a in enumerate(args) if i not in case.unread]
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*read, *outs) if isinstance(t, torch.Tensor))
    ops, kind = case.work(*args)
    peak = PEAK[tag] if kind == "mma" else PEAK["float32"]
    by_bytes, by_ops = 1e3 * nbytes / HBM_RATE, 1e3 * ops / peak
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else \
        "operations"


def launch_floor() -> dict:
    """The median CUDA-event time of an empty kernel (one block of 32
    threads) queued behind a spin (`_queued_ms`) and with events around the
    call (`_median_ms`), and the host's microseconds a launch: what a
    launch-bound kernel's time is read against."""
    from transmf_ad_tpu_torch import _build

    lib = _build.library()
    lib.transmf_empty.argtypes = [_build.PTR]
    lib.transmf_empty.restype = _build.INT

    def empty():
        err = lib.transmf_empty(torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"empty kernel: launch failed ({err})")
    return {"queued": _queued_ms(empty, iters=50),
            "events": _median_ms(empty, iters=50), "host_us": _host_us(empty)}


def check_kernels(results, only=()):
    """Phase 3. Fills `results` per kernel name and returns the bfloat16
    kernel time of every case by (name, label)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    times = {}
    by_name = {k.name: k for k in _kernels()}
    floor = launch_floor()
    print(f"[kernel] launch floor, an empty kernel: queued behind a spin "
          f"{floor['queued']:.4f} ms, events around the call "
          f"{floor['events']:.4f} ms, host {floor['host_us']:.1f} us a call",
          flush=True)
    for case in _kernel_cases(g):
        name, label = case.name, case.label
        if only and name not in only:
            continue
        for dt, dtols in ((torch.float32, case.tol32),
                          (torch.bfloat16, case.tol16)):
            args = case.make(dt)
            by_name[name].reset()
            outs, refs = case.kern(*args), case.plain(*args)
            torch.cuda.synchronize()
            took = "".join(f' "{v}"' for v in by_name[name].by_variant)
            outs = outs if isinstance(outs, tuple) else (outs,)
            refs = refs if isinstance(refs, tuple) else (refs,)
            if case.repeat:
                again = case.kern(*args)
                again = again if isinstance(again, tuple) else (again,)
                if not all(torch.equal(o, p) for o, p in zip(outs, again)):
                    raise AssertionError(f"{name} {label}: two calls on the "
                                         "same inputs differ")
                del again
            if case.twin is not None:
                twin = case.twin(*args)
                twin = twin if isinstance(twin, tuple) else (twin,)
                if not all(torch.equal(o, t) for o, t in zip(outs, twin)):
                    raise AssertionError(f"{name} {label}: the two variants "
                                         "give different bits")
                del twin
            for o, r in zip(outs, refs, strict=True):
                if o.shape != r.shape or o.dtype != r.dtype:
                    raise AssertionError(f"{name} {label}: {o.shape} "
                                         f"{o.dtype} vs {r.shape} {r.dtype}")
            errs = [(o.float() - r.float()).abs().max().item()
                    for o, r in zip(outs, refs)]
            ok = all(_agree(o, r, t) for o, r, t in zip(outs, refs, dtols,
                                                        strict=True))
            tag = str(dt).replace("torch.", "")
            bound_ms, bound_by = _bound(case, args, outs, tag)
            del refs
            verdict = "ok" if ok else "FAIL"
            tol_s = ", ".join(f"{k} rtol={r:.3g} atol={a:.3g}"
                              for k, r, a in dtols)
            line = (f"[kernel] {name}{took} {label} {tag}: max_abs_err="
                    f"{[float(f'{e:.3g}') for e in errs]} ({tol_s}) {verdict}"
                    + (", two calls bit-identical" if case.repeat else "")
                    + (", the other variant bit-identical"
                       if case.twin is not None else ""))
            if not ok:
                print(line, flush=True)
                raise AssertionError(f"{name} {label} {tag} disagrees with "
                                     f"its plain version: {errs}")
            if case.timed:
                timer = _queued_ms if case.queued else _median_ms
                ms = timer(lambda: case.kern(*args))
                plain_ms = timer(lambda: case.plain(*args))
                if case.library is None:
                    library_ms = None
                elif case.library_bwd:
                    library_ms = timer(case.library(*args))
                else:
                    library_ms = timer(lambda: case.library(*args))
                lib_s = ("none" if library_ms is None
                         else f"{library_ms:.4f} ms")
                line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                         f"bound {bound_ms:.4f} ms by {bound_by}, library "
                         f"call {lib_s}")
                if case.library_part is not None:
                    part, what = case.library_part(*args)
                    line += f", {what} {timer(part):.4f} ms"
                    del part
                if case.earlier is not None and dt == torch.bfloat16:
                    was = timer(lambda: case.earlier(*args))
                    line += (f", {case.earlier_name} {was:.4f} ms "
                             f"({was / ms:.1f}x)")
                if case.queued:
                    # the same calls timed as the other kernels are, and the
                    # host's time a call of the public entry
                    line += (f"; queued behind a spin, launch floor "
                             f"{floor['queued']:.4f} ms; events around the "
                             f"call (host included): kernel "
                             f"{_median_ms(lambda: case.kern(*args)):.4f} ms")
                    if case.earlier is not None:
                        line += (f", {case.earlier_name} "
                                 f"{_median_ms(lambda: case.earlier(*args)):.4f}"
                                 f" ms")
                    line += (f", launch floor {floor['events']:.4f} ms; host "
                             f"{_host_us(lambda: case.kern(*args)):.1f} us a "
                             f"call (empty kernel {floor['host_us']:.1f})")
            else:
                line += "; an edge case, not timed"
            print(line, flush=True)
            r = results.setdefault(name, {"max_abs_err": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], *errs)
            if dt == torch.bfloat16 and case.timed:
                times[name, label] = ms
                timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=library_ms)
                if case.earlier is not None:
                    timing.update(earlier=case.earlier_name, earlier_ms=was)
                if "ms" not in r:  # main-path shape
                    r.update(timing)
                elif case.record is not None:
                    r[case.record] = {"shape": label, **timing}
                if case.queued:
                    r["launch_floor_ms"] = floor["queued"]
                    r["launch_floor_events_ms"] = floor["events"]
            del args, outs
            torch.cuda.empty_cache()
    _window_step(results)
    return times


def _window_step(results):
    """K14's bfloat16 kernel, plain and bound times summed over the calls
    of a train step of swin_unetr's cell (`_swin_calls`), each way:
    printed, and kept under the kernel's "step" entry."""
    labels = [label for label, *_ in _swin_calls()]
    for name in SWIN_TRAIN_KERNELS:
        r = results.get(name, {})
        parts = [r] + [r[label] for label in labels[1:] if label in r]
        if "ms" not in r or len(parts) != len(labels):
            continue
        r["step"] = {k: sum(p[k] for p in parts)
                     for k in ("ms", "plain_ms", "bound_ms")}
        print(f"[kernel] {name}: the {len(labels)} calls of a train step of "
              f"swin_unetr, batch {FULL_BATCH}, bfloat16: kernel "
              f"{r['step']['ms']:.4f} ms, plain {r['step']['plain_ms']:.4f} "
              f"ms, bound {r['step']['bound_ms']:.4f} ms", flush=True)


@torch.no_grad()
def randomize_bn(model, g):
    """Random BN affine and running statistics, so eval BN is far from the
    identity."""
    from transmf_ad_tpu_torch.nn.batchnorm import BatchNormMasked, ManualBN

    for m in model.modules():
        if isinstance(m, (ManualBN, BatchNormMasked)):
            m.weight.uniform_(0.5, 1.5, generator=g)
            m.bias.normal_(0.0, 0.1, generator=g)
            m.running_mean.normal_(0.0, 0.2, generator=g)
            m.running_var.uniform_(0.5, 2.0, generator=g)


@contextlib.contextmanager
def flash_gate(keys):
    """Lower (or restore) the key count above which `attention_core` takes
    the flash kernels, for the card and the CPU alike."""
    from transmf_ad_tpu_torch import ops

    saved, ops.FLASH_MIN_KEYS = ops.FLASH_MIN_KEYS, keys
    try:
        yield
    finally:
        ops.FLASH_MIN_KEYS = saved


def _require_launches(tag, launches, kernels, exact):
    """Every kernel of `kernels` launched at least once, and those of
    `exact` exactly that often."""
    missing = [n for n in kernels if launches[n] == 0]
    if missing:
        raise AssertionError(f"{tag} never launched {missing}")
    wrong = {n: launches[n] for n, c in exact.items() if launches[n] != c}
    if wrong:
        raise AssertionError(f"{tag}: launches {wrong}, expected {exact}")


def serve(card, tag="serving", batch=BATCH, volume=VOLUME, warmup=WARMUP,
          n_requests=REQUESTS, kernels=SERVING_KERNELS, model_name="ad",
          exact=None, variants=FAST):
    """Serve `n_requests` requests of host arrays through
    `make_inference_fn`; returns the model, a float32 CPU copy of it and
    the launch counts of this run, counted from zero. `exact`: launch
    counts per request that must hold exactly. `variants`: the one variant
    each of these kernels may have launched."""
    from transmf_ad_tpu_torch.models import build_model
    from transmf_ad_tpu_torch.serving import make_inference_fn
    from transmf_ad_tpu_torch.utils.weights import init_weights

    g = torch.Generator().manual_seed(0)
    model = build_model(model_name)
    init_weights(model, g)
    randomize_bn(model, g)
    reference = copy.deepcopy(model)  # float32 CPU copy for the checks
    fn = make_inference_fn(model, "cuda", "auto")
    rng = np.random.default_rng(0)
    requests = [tuple(rng.standard_normal((batch, *volume), dtype=np.float32)
                      for _ in range(2)) for _ in range(n_requests)]

    reset_counts()
    times = []
    for mri, pet in requests:
        t0 = time.perf_counter()
        probs = fn(mri, pet)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if probs.shape != (batch, 2) or not bool(torch.isfinite(probs).all()):
            raise AssertionError(f"{tag}: bad probabilities {probs}")
        if not torch.allclose(probs.sum(-1), torch.ones_like(probs[:, 0]),
                              atol=1e-5):
            raise AssertionError(f"{tag}: rows do not sum to 1: {probs}")
    launches = _launches()
    _require_launches(tag, launches, kernels,
                      {n: c * n_requests for n, c in (exact or {}).items()})
    took = _require_variants(tag, variants)
    steady = times[warmup:]
    vols = batch * len(steady) / sum(steady)
    print(f"[{tag}] {type(model).__name__} dim=128 depth=3 bf16, batch "
          f"{batch} x "
          f"{volume} MRI+PET, {len(steady)} requests after {warmup} warm-up: "
          f"{vols:.2f} vols/s ({1e3 * np.median(steady):.2f} ms/request "
          f"median) on {card}; launches {launches}, variants {took}",
          flush=True)
    print(f"[{tag}] request ms: {[round(1e3 * t, 3) for t in times]}",
          flush=True)
    print(f"[{tag}] probabilities of the last request: "
          f"{probs[:, 1].tolist()}", flush=True)
    return model, reference, launches


def cross_check(model, reference, volume=VOLUME, tag="check", inputs=2):
    """Same weights, batch 2, float32: the card (kernels, TF32 off) against
    the CPU (plain path). Both sides compute in float32; they differ only in
    the order of float32 sums (and cuDNN's choice of conv algorithm), which
    keeps them within 1e-4 of the outputs' scale (3e-7 was measured on an
    H100), while a wrong layout, tap or rounding step moves them by O(1).
    `inputs`: the model's volumes (1: the MRI alone)."""
    rng = np.random.default_rng(2)
    vols = [torch.from_numpy(rng.standard_normal((2, *volume, 1),
                                                 dtype=np.float32))
            for _ in range(2)][:inputs]
    def outputs(out):  # an adversarial model returns a triple
        return [t.float().cpu() for t in
                ((out,) if isinstance(out, torch.Tensor) else out)]

    with torch.inference_mode():
        card = outputs(model(*(v.cuda() for v in vols)))
        cpu = outputs(reference.eval()(*vols))
    for name, a, b in zip(("logits", "d_mri", "d_pet"), card, cpu,
                          strict=False):
        err = (a - b).abs().max().item()
        tol = 1e-4 * (1.0 + b.abs().max().item())
        print(f"[{tag}] {name} card f32 vs cpu f32: max_abs_err={err:.3g} "
              f"(tol {tol:.3g}); card {a.flatten().tolist()}", flush=True)
        if not (bool(torch.isfinite(a).all()) and err <= tol):
            raise AssertionError(f"{name}: card and CPU disagree by {err}")


def band_cross_check(reference):
    """`cross_check` at a small volume with every 3x3x3 body conv on the
    band route (band_min_voxels=0) on both sides: K8 on the card against
    its plain version on the CPU, through the whole model."""
    from transmf_ad_tpu_torch.models import build_model

    models = []
    for device in ("cuda", "cpu"):
        m = build_model("ad", band_min_voxels=0)
        m.load_state_dict(reference.state_dict())
        models.append(m.to(device).eval())
    before = _launches()["band_conv"]
    cross_check(*models, volume=CHECK_VOLUME, tag="check, band route")
    if _launches()["band_conv"] != before + 10:  # 2 encoders x 5 convs
        raise AssertionError("the band-route check did not launch K8 for "
                             "every 3x3x3 body conv")


def flash_cross_check(reference):
    """`cross_check` of transformer_res at a small volume with the flash
    gate lowered on both sides: K10 on the card against its plain version
    on the CPU, through the whole model."""
    before = _launches()
    with flash_gate(FLASH_CHECK_GATE):
        cross_check(copy.deepcopy(reference).cuda().eval(), reference,
                    volume=RES_CHECK_VOLUME, tag="check, flash route")
    after = _launches()
    if (after["flash_fwd"] != before["flash_fwd"] + ATTENTION_CALLS
            or after["attention_fwd"] != before["attention_fwd"]):
        raise AssertionError("the flash-route check did not launch K10 for "
                             "every attention call")


def reset_counts():
    """Set every launch count (K1-K14) to 0, after checking that K1
    launched no "column" since the last reset: from phase 4 on, every K1
    launch is at the models' width, which the rule sends to "cluster"."""
    from transmf_ad_tpu_torch.ops import TOKEN_POOL, reset_launch_counts

    if TOKEN_POOL.by_variant.get("column"):
        raise AssertionError(f"K1 launched {TOKEN_POOL.by_variant} at the "
                             "models' width, expected only \"cluster\"")
    reset_launch_counts()


def _kernels():
    """K1-K12 and K14 (`ops.KERNELS`), then K13, the train step's
    augmentation (no op, so not in `ops.KERNELS`)."""
    from transmf_ad_tpu_torch.data.transforms import AUGMENT
    from transmf_ad_tpu_torch.ops import KERNELS

    return (*KERNELS, AUGMENT)


def _launches():
    return {k.name: k.launches for k in _kernels()}


def _require_variants(tag, variants):
    """Every launch of each kernel in `variants` since the counts were reset
    was of the variant named there."""
    for k in _kernels():
        want = variants.get(k.name)
        if want is not None and k.launches \
                and k.by_variant != {want: k.launches}:
            raise AssertionError(
                f"{tag}: {k.name} launched {k.by_variant} of {k.launches}, "
                f"expected only \"{want}\"")
    return {k.name: dict(k.by_variant) for k in _kernels() if k.by_variant}


def _snapshot(model):
    return {k: v.detach().float().cpu().clone()
            for k, v in model.state_dict().items()}


def train(card, tag="train", batch_size=BATCH, volume=VOLUME,
          warmup=TRAIN_WARMUP, steps=TRAIN_STEPS, kernels=TRAIN_KERNELS,
          model_name="ad", exact=None, variants=FAST):
    """The train step at full width: ms/step, volumes/s, every loss, the
    launch counts of this run (counted from zero) and its peak memory.
    `exact`: launch counts per step that must hold exactly, besides K13's
    one. `variants`: the one variant each of these kernels may have
    launched."""
    from transmf_ad_tpu_torch.data.transforms import AugmentConfig
    from transmf_ad_tpu_torch.models import ADVERSARIAL, build_model
    from transmf_ad_tpu_torch.train import create_state, make_train_step
    from transmf_ad_tpu_torch.utils.weights import init_weights

    g = torch.Generator().manual_seed(3)
    model = build_model(model_name)  # head dropout 0.5
    init_weights(model, g)
    randomize_bn(model, g)
    state = create_state(model, "cuda", "auto", seed=0, name="Adam",
                         lr=1e-4)
    step = make_train_step(adversarial=model_name in ADVERSARIAL,
                           aug_cfg=AugmentConfig())
    # [0, 1]-normalised volumes made on the device, as a device feed holds
    # them; labels alternate
    dg = torch.Generator(device="cuda").manual_seed(4)
    batches = [{"MRI": torch.rand(batch_size, *volume, generator=dg,
                                  device="cuda"),
                "PET": torch.rand(batch_size, *volume, generator=dg,
                                  device="cuda"),
                "label": torch.arange(batch_size, device="cuda") % 2}
               for _ in range(warmup + steps)]
    before = _snapshot(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, losses = [], []
    for batch in batches:
        t0 = time.perf_counter()
        aux = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(aux["loss"]))
    launches = _launches()
    _require_launches(tag, launches, kernels,
                      {n: c * len(batches)
                       for n, c in {"augment": 1, **(exact or {})}.items()})
    took = _require_variants(tag, variants)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: non-finite losses {losses}")
    after = _snapshot(model)
    still = [k for k in after if (k.endswith("weight") or "running" in k)
             and torch.equal(after[k], before[k])]
    if still:
        raise AssertionError(f"{tag}: unchanged after {len(batches)} steps: "
                             f"{still}")
    steady = times[warmup:]
    widths = ("feature size 48, heads 3-24, window 7" if model_name ==
              "swin_unetr" else "dim=128 depth=3, head dropout 0.5")
    print(f"[{tag}] {type(model).__name__} {widths}, bf16 (f32 master "
          f"weights), "
          f"batch {batch_size} x {volume} MRI+PET, augmentation on, "
          f"Adam 1e-4: {len(steady)} steps after {warmup} "
          f"warm-up: {batch_size * len(steady) / sum(steady):.2f} vols/s "
          f"({1e3 * np.median(steady):.2f} ms/step median) on {card}; "
          f"launches {launches}, variants {took}", flush=True)
    print(f"[{tag}] step ms: {[round(1e3 * t, 3) for t in times]}",
          flush=True)
    print(f"[{tag}] losses: {losses}", flush=True)
    print(f"[{tag}] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return launches


def swin_train(card):
    """Phase 11's last part: swin_unetr's train step at batch 6,
    182x218x182, counted from zero; K14's forward and backward launched
    SWIN_CALLS times a step each, of the "mma" variant, and no other model
    kernel."""
    return train(card, SWIN_TAG, FULL_BATCH, FULL_VOLUME, FULL_TRAIN_WARMUP,
                 FULL_TRAIN_STEPS, SWIN_TRAIN_KERNELS, "swin_unetr",
                 {k.name: SWIN_CALLS if k.name in SWIN_TRAIN_KERNELS else 0
                  for k in _kernels() if k.name != "augment"})


def sgd_step(model, device, batch, adversarial=True, dtype=torch.float32,
             modalities=("MRI", "PET")):
    """One step of the port's train step with SGD (lr 1, no momentum, so
    each parameter update is minus its gradient), computing in `dtype`
    with float32 parameters: name -> tensor on the CPU for the three
    losses, every parameter update and every running statistic."""
    from transmf_ad_tpu_torch.train import create_state, make_train_step

    before = _snapshot(model)
    aux = make_train_step(modalities, adversarial=adversarial)(
        create_state(model, device, dtype, name="SGD", lr=1.0,
                     milestones=()), batch)
    out = {k: aux[k].float().cpu() for k in ("loss", "ce_loss", "ad_loss")}
    for k, v in _snapshot(model).items():
        if "running" in k:
            out[k] = v
        else:
            out[k + " update"] = v - before[k]
    return out


def compare_steps(card, cpu, perturbed):
    """Hold each tensor of `card` against `cpu` (dicts from `sgd_step`).

    A one-step update of this network is ill-conditioned in float32: a max
    pool's winner or a LeakyReLU's side flips when its margin is below the
    rounding difference of the two sides, and each flip moves a weight
    gradient by a finite amount; a Linear bias before a training BatchNorm
    has an exact gradient of 0, so its update is rounding alone. The
    conditioning is measured on the spot: `perturbed` holds CPU steps on the
    inputs times (1 + CHECK_EPS * N(0, 1)). Tolerance per tensor: 1e-3 of
    its largest magnitude + 1e-6, plus CHECK_SLACK times the largest
    distance of a perturbed step from the CPU's. A wrong gradient misses by
    O(1) of the tensor's magnitude. Returns rows (err / tol, err / the 1e-3
    part, name) sorted from the worst."""
    rows = []
    for name, ref in cpu.items():
        noise = max(float((p[name] - ref).abs().max()) for p in perturbed)
        base = 1e-3 * float(ref.abs().max()) + 1e-6
        tol = base + CHECK_SLACK * noise
        err = float((card[name] - ref).abs().max())
        if not (bool(torch.isfinite(card[name]).all()) and err <= tol):
            raise AssertionError(
                f"train check: {name} card vs cpu differ by {err} (tol "
                f"{tol}: {base} + {CHECK_SLACK} x {noise} from the "
                f"perturbed steps)")
        rows.append((err / tol, err / base, name))
    return sorted(rows, reverse=True)


def check_batch(seed, volume=CHECK_VOLUME):
    """The train check's batch: [0, 1) volumes from a numpy seed, labels
    alternating."""
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.random((CHECK_BATCH, *volume),
                                            dtype=np.float32))
             for k in ("MRI", "PET")}
    batch["label"] = torch.arange(CHECK_BATCH) % 2
    return batch


def perturb(batch, seed):
    """The batch's volumes times (1 + CHECK_EPS * N(0, 1)), drawn from
    `seed`."""
    g = torch.Generator().manual_seed(seed)
    return {k: v if k == "label" else
            v * (1.0 + CHECK_EPS * torch.randn(v.shape, generator=g))
            for k, v in batch.items()}


def train_check(model_name="ad", volume=CHECK_VOLUME, **model_kw):
    """One SGD step with the same weights on the card (kernels, float32,
    TF32 off) and on the CPU (plain versions), at full width, batch 4 (with
    2 samples every BatchNorm1d gradient is O(eps / var), a difference of
    rounding), no augmentation or dropout: the losses, every parameter
    update and every running statistic agree (`compare_steps`).
    `model_kw` (band_min_voxels=0: every 3x3x3 body conv through K8 and
    K9) goes to `build_model`. transformer_res runs with the flash gate
    lowered, so its backward goes through K11 and K12. ModelSingle takes
    the MRI alone; ADVIT and Mnet are built for `volume`, their dropout
    off as well."""
    from transmf_ad_tpu_torch.models import (ADVERSARIAL, SINGLE_MODALITY,
                                             build_model)
    from transmf_ad_tpu_torch.utils.weights import init_weights

    g = torch.Generator().manual_seed(5)
    model = build_model(model_name, head_dropout=0.0, vit_dropout=0.0,
                        emb_dropout=0.0, input_shape=volume, **model_kw)
    init_weights(model, g)
    randomize_bn(model, g)
    batch = check_batch(5, volume)
    adversarial = model_name in ADVERSARIAL
    mods = ("MRI",) if model_name in SINGLE_MODALITY else ("MRI", "PET")
    flash = model_name == "transformer_res"
    with flash_gate(FLASH_CHECK_GATE) if flash else contextlib.nullcontext():
        cpu = sgd_step(copy.deepcopy(model), "cpu", batch, adversarial,
                       modalities=mods)
        perturbed = [sgd_step(copy.deepcopy(model), "cpu", perturb(batch, d),
                              adversarial, modalities=mods)
                     for d in range(CHECK_DRAWS)]
        before = _launches()
        card = sgd_step(model, "cuda", batch, adversarial, modalities=mods)
    after = _launches()
    if flash and any(after[n] != before[n] + ATTENTION_CALLS for n in
                     ("flash_fwd", "flash_dq", "flash_dkv")):
        raise AssertionError("train check: the flash route did not launch "
                             "K10, K11 and K12 for every attention call")
    if model_kw.get("band_min_voxels") == 0:
        # per encoder 5 convs: forward and dx through K8, dw through K9
        if (after["band_conv"] != before["band_conv"] + 20
                or after["band_dw"] != before["band_dw"] + 10):
            raise AssertionError("train check: the band route did not "
                                 "launch K8 and K9 for every body conv")
    rows = compare_steps(card, cpu, perturbed)
    within = sum(r[1] <= 1.0 for r in rows)
    what = " ".join(["train check",
                     *([model_name] if model_name != "ad" else []),
                     *([str(model_kw)] if model_kw else [])])
    print(f"[{what}] one SGD "
          f"step, full width, batch {CHECK_BATCH} x "
          f"{volume}, card f32 vs cpu f32: loss "
          f"{float(card['loss']):.6f} vs {float(cpu['loss']):.6f}; all "
          f"{len(rows)} tensors agree, {within} of them within 1e-3 of "
          f"their largest magnitude; closest to the tolerance: "
          f"{[(n, round(t, 3), round(b, 3)) for t, b, n in rows[:4]]} "
          f"(name, of the tolerance, of the 1e-3 part)", flush=True)


def _band_route_variants(step: bool):
    """K8 and K9 launches of full-width ModelAd on the band route in
    bfloat16, per eval forward (or per train step), by the variant the
    rules send each to: every 3x3x3 body conv of both encoders forward,
    and in a step its input gradient (Cin and Cout swapped: 256 -> 128 is
    "direct") and its weight gradient"""
    from transmf_ad_tpu_torch.nn.blocks import _PLAN
    from transmf_ad_tpu_torch.ops import band_conv

    want = {"band_conv": {}, "band_dw": {}}

    def add(name, which):
        want[name][which] = want[name].get(which, 0) + 2  # two encoders

    for _, _, _, (ci, co), kernel, _ in _PLAN:
        if kernel != 3 or ci == 0:
            continue
        cin, cout = ci * 32, co * 32
        add("band_conv", band_conv.variant(torch.bfloat16, cin, cout))
        if step:
            add("band_conv", band_conv.variant(torch.bfloat16, cout, cin))
            add("band_dw", band_conv.dw_variant(torch.bfloat16, cin, cout))
    return want


@contextlib.contextmanager
def held_in_model(held):
    """Every call of the backward kernels K6, K7, K9, K11 and K12, and of
    K8 (forward and dx), while the context is open is held against its
    plain version on the same inputs, the model's own activations and
    gradients, at phase 3's bfloat16 tolerances (K7's dy and K8's y one
    ulp, K8's plus 1e-3; the float32 sums 1e-2 of their largest magnitude;
    K11 / K12 1e-4 of the output's scale plus one ulp); a disagreement
    raises. `held` collects, per kernel, the calls held and the largest
    error as a share of its tolerance. The kernels launch as the model
    launches them; the plain versions launch nothing."""
    from transmf_ad_tpu_torch.ops import band_conv, pool3d, stem
    from transmf_ad_tpu_torch.ops import flash_attention as fa

    ulp, sums = _elem(BF16_RTOL, 0.0), _sums(1e-2)
    conv, flash = _elem(BF16_RTOL, 1e-3), _scaled(BF16_RTOL, 1e-4)

    def k7_plain(y, s, b, p, g, slope, mode, lanes, round_gi):
        return pool3d.affine_act_pool_bwd_reference(y, s, b, p, g, slope,
                                                    mode, round_gi)

    def k8_plain(x, w, stats):
        return (band_conv.band_conv_stats_reference(x, w) if stats
                else band_conv.band_conv_reference(x, w))

    def k8_tols(x, w, stats):
        return (conv, sums) if stats else (conv,)

    specs = [(pool3d, "affine_act_pool_bwd", k7_plain, (ulp, sums)),
             (band_conv, "_band_forward", k8_plain, k8_tols),
             (stem, "stem_dw", stem.stem_dw_reference, (sums,)),
             (band_conv, "band_dw", band_conv.band_dw_reference, (sums,)),
             (fa, "flash_dq", fa.flash_dq_reference, (flash,)),
             (fa, "flash_dkv", fa.flash_dkv_reference, (flash, flash))]
    saved = [getattr(mod, name) for mod, name, _, _ in specs]

    def spy(name, kern, plain, tols):
        def run(*args):
            out = kern(*args)
            outs = out if isinstance(out, tuple) else (out,)
            refs = plain(*args)
            refs = refs if isinstance(refs, tuple) else (refs,)
            worst = 0.0
            for o, r, tol in zip(outs, refs,
                                 tols(*args) if callable(tols) else tols,
                                 strict=True):
                if not _agree(o, r, tol):
                    raise AssertionError(
                        f"{name} in the model: {tuple(o.shape)} "
                        f"{o.dtype} off its plain version by "
                        f"{float((o.float() - r.float()).abs().max())} "
                        f"(tolerance {tol})")
                worst = max(worst, _share(o, r, tol))
            calls, top = held.get(name, (0, 0.0))
            held[name] = (calls + 1, max(top, worst))
            return out
        return run

    for (mod, name, plain, tols), kern in zip(specs, saved):
        setattr(mod, name, spy(name, kern, plain, tols))
    try:
        yield held
    finally:
        for (mod, name, _, _), kern in zip(specs, saved):
            setattr(mod, name, kern)


def _share(out, ref, tol) -> float:
    """the largest error of `out` as a share of what `_agree` allows"""
    kind, rtol, atol = tol
    err = (out.float() - ref.float()).abs()
    scale = float(ref.float().abs().max())
    if kind == "sum":
        return float(err.max()) / (rtol * scale) if scale else 0.0
    if kind == "scaled":
        atol *= scale
    room = atol + rtol * ref.float().abs()
    some = room > 0  # where there is none, `_agree` held the error to 0
    return float((err[some] / room[some]).max()) if bool(some.any()) else 0.0


def _rel(a, b):
    """|a - b| / |b| by the norm, 0 where both are 0"""
    den = float(b.norm())
    return float((a - b).norm()) / den if den else float((a - b).norm())


def bf16_check(model_name="ad", volume=CHECK_VOLUME, **model_kw):
    """Phase 12: a full-width model in bfloat16 on the card against float32
    on the card, with the same weights and inputs (phase 7's: batch 4, no
    augmentation or dropout; transformer_res at its larger volume with the
    flash gate lowered, so K10 runs in the forward and K11 / K12 in the
    step): the eval forward's outputs (ModelAd: logits, d_mri and d_pet)
    and one SGD step's losses. The CPU's plain path runs the same in
    bfloat16 and float32 in this run, and sets the tolerance: per output,
    max |card bf16 - card f32| <= 3 x max |CPU bf16 - CPU f32| + 1e-3 of
    the output's scale (its largest magnitude on the CPU in float32).

    The step's parameter updates are printed, not held to that rule: in
    bfloat16 one step's update differs from float32 by a large share of its
    norm on the card and on the CPU alike (max-pool winners and LeakyReLU
    sides flip with the roundings, and the bf16 backward carries a change
    of an ulp anywhere through flipped roundings of the gradients), so no
    rule on the updates can hold a backward kernel. Instead every call of
    K6, K7, K8 (forward and dx), K9, K11 and K12 in the card's bf16 step is
    held against its plain version on the same inputs (`held_in_model`),
    and each kernel the route runs must have been held. The bf16 card runs
    take the tensor cores and K4 / K7 "vec" wherever the variant rules
    send them (asserted)."""
    from transmf_ad_tpu_torch.models import ADVERSARIAL, build_model
    from transmf_ad_tpu_torch.utils.weights import init_weights

    tag = " ".join(["bf16 check", *([model_name] if model_name != "ad"
                                    else []),
                    *([str(model_kw)] if model_kw else [])])
    g = torch.Generator().manual_seed(7)
    model = build_model(model_name, head_dropout=0.0, **model_kw)
    init_weights(model, g)
    randomize_bn(model, g)
    batch = check_batch(7, volume)
    adversarial = model_name in ADVERSARIAL
    flash = model_name == "transformer_res"
    outputs = ("logits", "d_mri", "d_pet") if adversarial else ("logits",)
    losses = ("loss", "ce_loss", "ad_loss")
    runs, steps, held = {}, {}, {}
    for device, dt in (("cuda", torch.bfloat16), ("cuda", torch.float32),
                       ("cpu", torch.bfloat16), ("cpu", torch.float32)):
        reset_counts()
        with (flash_gate(FLASH_CHECK_GATE) if flash
              else contextlib.nullcontext()):
            m = copy.deepcopy(model).to(device).eval()
            with torch.inference_mode():
                out = m(*(batch[k].to(device, dt)[..., None]
                          for k in ("MRI", "PET")), train=False)
            res = {k: t.float().cpu() for k, t in
                   zip(outputs, out if adversarial else (out,), strict=True)}
            forward = _launches()
            card16 = device == "cuda" and dt == torch.bfloat16
            with (held_in_model(held) if card16
                  else contextlib.nullcontext()):
                steps[device, dt] = sgd_step(copy.deepcopy(model), device,
                                             batch, adversarial, dt)
        runs[device, dt] = res | {k: steps[device, dt][k] for k in losses}
        if device == "cuda" and dt == torch.bfloat16:
            band = model_kw.get("band_min_voxels") == 0
            fast = {k: v for k, v in FAST.items()
                    if not (band and k.startswith("band_"))}
            took = _require_variants(tag, fast)
            if band:
                want = _band_route_variants(False)
                for name, n in _band_route_variants(True).items():
                    for which, c in n.items():
                        want[name][which] = want[name].get(which, 0) + c
                got = {k: took.get(k, {}) for k in want}
                if got != want:
                    raise AssertionError(f"{tag}: K8 / K9 variants {got}, "
                                         f"the rules give {want}")
            if not (forward["affine_act_pool"]
                    and took.get("affine_act_pool_bwd")):
                raise AssertionError(f"{tag}: K4 or K7 not launched")
            if flash and not all(took.get(k) for k in
                                 ("flash_fwd", "flash_dq", "flash_dkv")):
                raise AssertionError(f"{tag}: K10, K11 or K12 not launched")
            want = {"affine_act_pool_bwd", "stem_dw",
                    *(["band_dw", "_band_forward"] if band else []),
                    *(["flash_dq", "flash_dkv"] if flash else [])}
            if not want <= set(held):
                raise AssertionError(f"{tag}: {sorted(want - set(held))} "
                                     "not held in the bf16 step")
    rows = []
    for name, ref in runs["cpu", torch.float32].items():
        card = (runs["cuda", torch.bfloat16][name]
                - runs["cuda", torch.float32][name]).abs().max().item()
        cpu = (runs["cpu", torch.bfloat16][name] - ref).abs().max().item()
        tol = 3.0 * cpu + 1e-3 * ref.abs().max().item()
        if not (torch.isfinite(runs["cuda", torch.bfloat16][name]).all()
                and card <= tol):
            raise AssertionError(
                f"{tag}: {name} card bf16 vs f32 differ by {card} (tol "
                f"{tol}: 3 x {cpu} on the CPU + 1e-3 of the scale)")
        rows.append((name, round(card, 6), round(cpu, 6), round(tol, 6)))
    # the updates in bf16 against f32, by the norm (printed, not held)
    moved, spread = {}, {}
    for dev in ("cuda", "cpu"):
        low, high = steps[dev, torch.bfloat16], steps[dev, torch.float32]
        moved[dev] = [_rel(low[k], high[k]) for k in high
                      if k.endswith(" update")]
        spread[dev] = [round(float(np.quantile(moved[dev], q)), 3)
                       for q in (0.5, 0.9)]
    print(f"[{tag}] full width, batch {CHECK_BATCH} x {volume}, card "
          f"bf16 vs card f32 against cpu bf16 vs cpu f32 (name, card err, "
          f"cpu err, tol): {rows}; the step's {len(moved['cuda'])} updates, "
          f"bf16 vs f32 by the norm (median, 90th percentile; not held): card "
          f"{spread['cuda']}, cpu {spread['cpu']}; in the bf16 step every "
          f"backward kernel call against its plain version on the same "
          f"inputs (kernel: calls, largest error of the tolerance): "
          f"{ {k: (n, round(w, 4)) for k, (n, w) in held.items()} }; "
          f"variants {took}", flush=True)


def _epoch_rule(tag, losses, per_epoch):
    """The learning check's rule (scripts/tpu_sanity_train.py's, over
    epochs): the mean ce_loss of the last epoch is under half that of the
    first. Returns the two means."""
    first = float(np.mean(losses[:per_epoch]))
    last = float(np.mean(losses[-per_epoch:]))
    if not (np.isfinite(losses).all() and last < 0.5 * first):
        raise AssertionError(f"{tag}: no learning, epoch-mean ce_loss "
                             f"{first:.4f} -> {last:.4f}: {losses}")
    return first, last


def sanity_batch(seed, volume, batch=LEARN_BATCH):
    """scripts/tpu_sanity_train.py's fixed batch: labels alternate, the
    class shifts the volume's mean by 0.3, PET is MRI flipped along x"""
    rng = np.random.default_rng(seed)
    labels = np.array([0, 1] * (batch // 2), np.int32)
    vols = rng.standard_normal((batch, *volume)).astype(np.float32)
    vols += labels[:, None, None, None] * 0.3
    return {"MRI": torch.from_numpy(vols),
            "PET": torch.from_numpy(vols[:, ::-1].copy()),
            "label": torch.from_numpy(labels)}


def _learn(tag, model, batches, adversarial, variants, flash=False):
    """LEARN_STEPS Adam 1e-4 steps in bfloat16 over `batches` (a list of
    one epoch's batches, or a callable giving the next epoch's), no
    augmentation; the epoch rule on ce_loss; every launch in the variant
    `variants` names. Returns the launch counts and the train state."""
    from transmf_ad_tpu_torch.train import create_state, make_train_step

    state = create_state(model, "cuda", torch.bfloat16, seed=0, name="Adam",
                         lr=1e-4, milestones=())
    step = make_train_step(adversarial=adversarial)
    epoch = batches if callable(batches) else (lambda: batches)
    reset_counts()
    losses, per_epoch = [], None
    with flash_gate(FLASH_CHECK_GATE) if flash else contextlib.nullcontext():
        while len(losses) < LEARN_STEPS:
            todo = list(epoch())
            per_epoch = per_epoch or len(todo)
            for batch in todo[:LEARN_STEPS - len(losses)]:
                losses.append(float(step(state, batch)["ce_loss"]))
    launches = _launches()
    took = _require_variants(tag, variants)
    first, last = _epoch_rule(tag, losses, per_epoch)
    print(f"[{tag}] {LEARN_STEPS} steps, {per_epoch} a epoch, bf16, Adam "
          f"1e-4: epoch-mean ce_loss {first:.4f} -> {last:.4f} (rule: under "
          f"half); ce_loss by step {[round(v, 4) for v in losses]}; launches "
          f"{launches}, variants {took}", flush=True)
    return launches, state


def learning_check(card):
    """Phase 13, the port of scripts/tpu_sanity_train.py, through the host
    data layer and the eval step: (a) a synthetic ADNI tree at 91x109x91
    (8 subjects a group) on disk, indexed for ADCN (16 pairs), cached in
    bfloat16 by `VolumeSource` and shuffled by `Loader` (batch 8); (b)
    full-width ModelAd learns on it (`_learn`), and so do the band route
    and transformer_res with the flash gate lowered on the script's fixed
    batch at phase 12's volumes; (c) the eval step over the 16 pairs in
    batches of 6, the last padded by `pad_batch` and masked, counts 16
    and launches K1; (d) `eval_check`."""
    import tempfile

    from transmf_ad_tpu_torch.data import (ADNI, Loader, VolumeSource,
                                           make_synthetic_adni, native_loader,
                                           pad_batch)
    from transmf_ad_tpu_torch.models import build_model
    from transmf_ad_tpu_torch.ops import KERNELS
    from transmf_ad_tpu_torch.train import (MetricState, confusion_metrics,
                                            make_eval_step, roc_auc)
    from transmf_ad_tpu_torch.utils.weights import init_weights

    kernels = {k.name: k for k in KERNELS}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        make_synthetic_adni(root, n_per_group=8, shape=VOLUME, seed=0)
        made = time.perf_counter() - t0
        records = ADNI(root, task="ADCN").data_dict
        if len(records) != 16:
            raise AssertionError(f"ADCN indexed {len(records)} pairs, not 16")
        source = VolumeSource(records, dtype=torch.bfloat16)
        loader = Loader(source, batch_size=LEARN_BATCH, shuffle=True, seed=0)
        t0 = time.perf_counter()
        cached = next(iter(Loader(source, batch_size=len(records))))
        print(f"[learning] synthetic ADNI, {len(records)} ADCN pairs at "
              f"{VOLUME}: written in {made:.1f} s, decoded and cached in "
              f"bf16 in {time.perf_counter() - t0:.1f} s by the "
              f"{'native' if source.use_native else 'pure-Python'} decoder "
              f"(native_loader.available() = {native_loader.available()}); "
              f"a batch's MRI {cached['MRI'].dtype} "
              f"{tuple(cached['MRI'].shape)}", flush=True)
        g = torch.Generator().manual_seed(13)
        model = build_model("ad")
        init_weights(model, g)
        learned, state = _learn("learning, ModelAd, synthetic ADNI", model,
                                lambda: iter(loader), True, FAST)

        # (c) the eval step over all 16 pairs, the last batch padded
        step = make_eval_step(adversarial=True)
        reset_counts()
        metrics, probs, labels = MetricState.zero("cuda"), [], []
        batches = 0
        for batch in Loader(source, batch_size=EVAL_BATCH):
            n = batch["label"].shape[0]
            batch = pad_batch(batch, EVAL_BATCH)
            metrics, out = step(state, metrics, batch)
            keep = out["mask"].bool()
            probs.append(out["probs"][keep].cpu())
            labels.append(out["label"][keep].cpu())
            batches += 1
            if n < EVAL_BATCH and out["mask"].sum() != n:
                raise AssertionError("the padded batch's mask is wrong")
        evaluated = _launches()
        took = _require_variants("learning, eval", FAST)
        total = float(metrics.total)
        if total != len(records) or batches != 3:
            raise AssertionError(f"the eval step counted {total} samples in "
                                 f"{batches} batches, not 16 in 3")
        if evaluated["token_pool"] != batches:
            raise AssertionError(f"the eval step launched K1 "
                                 f"{evaluated['token_pool']} times, not "
                                 f"{batches}")
        scores = confusion_metrics(metrics.confusion.cpu().numpy())
        auc = roc_auc(torch.cat(probs).numpy(), torch.cat(labels).numpy())
        print(f"[learning, eval] ModelAd after {LEARN_STEPS} steps, bf16, "
              f"{batches} batches of {EVAL_BATCH} (the last 4 pairs padded "
              f"and masked): total {total:.0f}, acc "
              f"{float(metrics.correct) / total:.4f}, sen {scores['sen']:.4f},"
              f" spe {scores['spe']:.4f}, f1 {scores['f1']:.4f}, AUC "
              f"{auc:.4f}, loss {float(metrics.loss_sum) / total:.4f} "
              f"(printed, not held); launches {evaluated}, variants {took}",
              flush=True)
    del state, model
    torch.cuda.empty_cache()

    g = torch.Generator().manual_seed(14)
    band = build_model("ad", band_min_voxels=0)
    init_weights(band, g)
    fast = {k: v for k, v in FAST.items() if not k.startswith("band_")}
    band_run, _ = _learn("learning, ModelAd, band route", band,
                         [sanity_batch(15, CHECK_VOLUME)], True, fast)
    want = {name: {which: c * LEARN_STEPS for which, c in n.items()}
            for name, n in _band_route_variants(True).items()}
    got = {k: dict(kernels[k].by_variant) for k in want}
    if got != want:
        raise AssertionError(f"learning, band route: K8 / K9 variants {got}, "
                             f"the rules give {want}")
    g = torch.Generator().manual_seed(16)
    res = build_model("transformer_res")
    init_weights(res, g)
    res_run, _ = _learn("learning, transformer_res, flash route", res,
                        [sanity_batch(17, RES_CHECK_VOLUME)], False, FAST,
                        flash=True)
    if not all(res_run[k] == ATTENTION_CALLS * LEARN_STEPS
               for k in ("flash_fwd", "flash_dq", "flash_dkv")):
        raise AssertionError(f"learning, transformer_res: the flash route "
                             f"was not taken: {res_run}")
    eval_check()
    return {n: learned[n] + evaluated[n] + band_run[n] + res_run[n]
            for n in learned}


def eval_check():
    """Phase 13 (d): the eval step on the card (float32, TF32 off) against
    the CPU plain path, with the same weights (phase 7's kind: seeded,
    random BN statistics) at CHECK_VOLUME, on 3 real samples padded to 4
    and masked: probs within 1e-4, loss_sum within 1e-4 of its magnitude,
    correct, total and confusion equal. A sample whose two logits lie
    within 1e-4 of each other may be classed either way by float32
    rounding: it is reported and masked out of the comparison of the
    counts."""
    from transmf_ad_tpu_torch.data import pad_batch
    from transmf_ad_tpu_torch.models import build_model
    from transmf_ad_tpu_torch.train import (MetricState, create_state,
                                            make_eval_step)
    from transmf_ad_tpu_torch.utils.weights import init_weights

    g = torch.Generator().manual_seed(18)
    model = build_model("ad", head_dropout=0.0)
    init_weights(model, g)
    randomize_bn(model, g)
    real = check_batch(19)
    batch = pad_batch({k: v[:3].numpy() for k, v in real.items()},
                      CHECK_BATCH)
    with torch.inference_mode():
        logits = model(*(torch.from_numpy(batch[k])[..., None]
                         for k in ("MRI", "PET")), train=False)[0]
    ties = ((logits[:, 1] - logits[:, 0]).abs() < 1e-4) \
        & torch.from_numpy(batch["mask"]).bool()
    if bool(ties.any()):
        batch["mask"] = batch["mask"] * (~ties).float().numpy()
    step = make_eval_step(adversarial=True)
    runs = {}
    for device in ("cuda", "cpu"):
        state = create_state(copy.deepcopy(model), device, torch.float32)
        before = _launches()["token_pool"]
        m, out = step(state, MetricState.zero(device), batch)
        if device == "cuda" and _launches()["token_pool"] != before + 1:
            raise AssertionError("eval check: K1 not launched on the card")
        runs[device] = (m, {k: v.cpu() for k, v in out.items()})
    (cm, cout), (pm, pout) = runs["cuda"], runs["cpu"]
    perr = float((cout["probs"] - pout["probs"]).abs().max())
    lerr = abs(float(cm.loss_sum) - float(pm.loss_sum))
    ltol = 1e-4 * abs(float(pm.loss_sum))
    if not (perr <= 1e-4 and lerr <= ltol):
        raise AssertionError(f"eval check: probs differ by {perr} (tol "
                             f"1e-4), loss_sum by {lerr} (tol {ltol})")
    for f in ("correct", "total", "confusion", "batches"):
        if not torch.equal(getattr(cm, f).cpu(), getattr(pm, f)):
            raise AssertionError(f"eval check: {f} card {getattr(cm, f)} "
                                 f"vs cpu {getattr(pm, f)}")
    print(f"[eval check] the eval step, full width, 3 samples padded to "
          f"{CHECK_BATCH} x {CHECK_VOLUME}, card f32 vs cpu f32: probs "
          f"max_abs_err {perr:.3g} (tol 1e-4), loss_sum {float(cm.loss_sum):.6f}"
          f" vs {float(pm.loss_sum):.6f} (err {lerr:.3g}, tol {ltol:.3g}); "
          f"correct {float(cm.correct):.0f}, total {float(cm.total):.0f}, "
          f"confusion {cm.confusion.cpu().tolist()} equal; samples within "
          f"1e-4 of a tie (masked out of the counts): "
          f"{ties.nonzero().flatten().tolist()}", flush=True)


def _cli_flags(root, ckpt, name, model="Transformer", folds=""):
    """The reference README's command at 1 + 1 epochs, on the card."""
    flags = ["--dataroot", root, "--task", "ADCN", "--model", model,
             "--batch_size", str(BATCH), "--aug", "True", "--randint",
             "False", "--num_folds", str(KFOLD_FOLDS), "--stage1_epochs",
             "1", "--stage2_epochs", "1", "--checkpoints_dir", ckpt,
             "--name", name]
    return flags + (["--folds", folds] if folds else [])


def _epoch_rates(log_path):
    """The epochs' volumes/s as the Trainer logged them."""
    text = open(log_path).read()
    return [float(v) for v in re.findall(r"Epoch time: [0-9.]+s "
                                         r"\(([0-9.]+) volumes/s\)", text)]


def _kfold_run(tag, root, ckpt, name, n_records, model, folds=""):
    """Run the k-fold CLI in this process with the counts at 0; hold its
    logs, checkpoints, metrics, feeds and launches. Returns (result,
    launches, the folds that ran)."""
    from transmf_ad_tpu_torch.cli import kfold_train_adversarial
    from transmf_ad_tpu_torch.train.kfold import (kfold_split,
                                                  train_val_split)

    ran = ([int(f) for f in folds.split(",")] if folds
           else list(range(KFOLD_FOLDS)))
    steps = evals = 0
    for fold, (tr, te) in enumerate(kfold_split(n_records, KFOLD_FOLDS,
                                                KFOLD_SEED)):
        if fold in ran:
            tr, va = train_val_split(tr, KFOLD_SEED)
            steps += 2 * (len(tr) // BATCH)  # drop_last, 2 epochs
            evals += 2 * math.ceil(len(va) / BATCH) + math.ceil(
                len(te) / BATCH)
    reset_counts()
    res = kfold_train_adversarial.main(_cli_flags(root, ckpt, name, model,
                                                  folds))
    launches = _launches()
    took = _require_variants(tag, FAST)
    forwards = steps + evals
    transformer = model == "Transformer"
    exact = {"stem_conv_stats": 2 * steps, "stem_dw": 2 * steps,
             "stem_conv": 2 * evals,
             "token_pool": forwards if transformer else 0,
             "attention_fwd": ATTENTION_CALLS * forwards if transformer
             else 0, "augment": steps}
    kernels = [k for k in TRAIN_KERNELS + ("stem_conv",)
               if transformer or k not in ("token_pool", "attention_fwd")]
    _require_launches(tag, launches, kernels, exact)

    if len(res["folds"]) != len(ran) or res["feeds"] != \
            ["DeviceCachedFeed"] * len(ran):
        raise AssertionError(f"{tag}: folds {res['folds']}, feeds "
                             f"{res['feeds']}")
    folds_arr = np.array(res["folds"])
    if not np.isfinite(folds_arr[:, :2]).all():
        raise AssertionError(f"{tag}: a loss or accuracy is not finite: "
                             f"{res['folds']}")
    mean = np.array(res["mean"])
    some = np.isfinite(folds_arr).any(axis=0)
    if not (np.isfinite(mean) == some).all():
        raise AssertionError(f"{tag}: the nan-mean {res['mean']} does not "
                             f"follow the folds {res['folds']}")
    main_log = open(os.path.join(ckpt, name, "log.txt")).read()
    lines = re.findall(r"^loss: \S+ accuracy: .* AUC: \S+ $", main_log,
                       re.M)
    final = re.findall(r"^(loss|acc|sen|spe|f1|auc): \S+ \+- \S+$",
                       main_log, re.M)
    if len(lines) != len(ran) or len(final) != 6 \
            or "************Final Results************" not in main_log:
        raise AssertionError(f"{tag}: the main log has {len(lines)} fold "
                             f"lines and {len(final)} aggregate lines")
    rates = {}
    for fold in ran:
        d = os.path.join(ckpt, name, str(fold))
        log = open(os.path.join(d, "log.txt")).read()
        missing = [t for t in ("Training Results", "Validation Results",
                               "Test Results", "MRIaccuracy",
                               "HBM dataset cache") if t not in log]
        best = glob.glob(os.path.join(d, "best_label_net_model_*.pt"))
        if missing or len(best) != 1:
            raise AssertionError(f"{tag}: fold {fold}'s log lacks {missing}"
                                 f", best checkpoints {best}")
        rates[fold] = _epoch_rates(os.path.join(d, "log.txt"))
    print(f"[{tag}] {len(ran)} folds, {steps} train steps and {evals} eval "
          f"batches: mean {[round(v, 4) for v in res['mean']]} +- "
          f"{[round(v, 4) for v in res['std']]}, folds {res['folds']}; "
          f"launches {launches}, variants {took}", flush=True)
    print(f"[{tag}] epoch vols/s by fold (epoch 1, 2; the cached feed, as "
          f"the Trainer logs it) on {torch.cuda.get_device_name(0)}: {rates}",
          flush=True)
    return res, launches, ran


def _same_batches(tag, got, want):
    """Two lists of batches agree bit for bit: volumes as int16 views of
    bfloat16, labels, masks and the real counts."""
    if len(got) != len(want):
        raise AssertionError(f"{tag}: {len(got)} batches, not {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("MRI", "PET", "label", "mask"):
            a, b = (torch.as_tensor(x).cpu() for x in (g[k], w[k]))
            if k in ("MRI", "PET"):
                a, b = a.view(torch.int16), b.view(torch.int16)
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"{tag}: batch {i} {k} differs")
        if g["_n_real"] != w["_n_real"]:
            raise AssertionError(f"{tag}: batch {i} _n_real differs")


def _feeds_check(source, n_records):
    """One epoch of fold 0's train loader (drop_last, shuffled) and of its
    validation loader (7 pairs: a ragged batch) through the host path and
    the three device feeds: the same batches, bit for bit."""
    from transmf_ad_tpu_torch.data import (DeviceCachedFeed, DeviceFeed,
                                           HybridCachedFeed, Loader,
                                           cache_bytes, pad_batch)
    from transmf_ad_tpu_torch.train.kfold import (kfold_split,
                                                  train_val_split)

    tr, _ = next(kfold_split(n_records, KFOLD_FOLDS, KFOLD_SEED))
    tr, va = train_val_split(tr, KFOLD_SEED)
    for which, idx, kw in (("train", tr, dict(shuffle=True, drop_last=True,
                                              seed=KFOLD_SEED)),
                           ("validation", va, {})):
        def loader():
            return Loader(source, list(idx), BATCH, **kw)

        host = [dict(pad_batch(b, BATCH), _n_real=int(b["label"].shape[0]))
                for b in loader()]
        half = cache_bytes(loader()) / len(idx) * (len(idx) // 2)
        with mock.patch.dict(os.environ,
                             {"TRANSMF_CACHE_BUDGET_MB": str(half / 2**20)}):
            hybrid = HybridCachedFeed(loader(), "cuda", pad_to=BATCH)
        if not 0 < hybrid.n_hot < len(idx):
            raise AssertionError(f"feeds: the hybrid feed holds "
                                 f"{hybrid.n_hot} of {len(idx)} rows hot")
        feeds = {"DeviceFeed": DeviceFeed(loader(), "cuda", pad_to=BATCH),
                 "DeviceCachedFeed": DeviceCachedFeed(loader(), "cuda",
                                                      pad_to=BATCH),
                 f"HybridCachedFeed ({hybrid.n_hot}/{len(idx)} hot)": hybrid}
        for name, feed in feeds.items():
            batches = list(feed)
            if any(b["MRI"].device.type != "cuda" for b in batches):
                raise AssertionError(f"feeds: {name} left a batch off the "
                                     "card")
            _same_batches(f"feeds, {which}, {name}", batches, host)
        print(f"[k-fold, feeds] fold 0's {which} loader ({len(idx)} pairs, "
              f"{len(host)} batches of {BATCH}, real counts "
              f"{[b['_n_real'] for b in host]}): the host Loader + "
              f"pad_batch, {', '.join(feeds)} give the same batches bit for "
              f"bit", flush=True)


def _evaluate_check(root, ckpt, name, fold0, model="Transformer"):
    """Fold 0's best .pt scored by `cli/evaluate.py` on the card gives the
    fold's logged test metrics."""
    from transmf_ad_tpu_torch.cli import evaluate

    (best,) = glob.glob(os.path.join(ckpt, name, "0",
                                     "best_label_net_model_*.pt"))
    m = evaluate.main(["--checkpoint", best, "--fold", "0",
                       *_cli_flags(root, ckpt, "evaluate", model)])
    got = [m["loss"], m["accuracy"], m["sen"], m["spe"], m["f1"], m["auc"]]
    counts = all((a == b) or (np.isnan(a) and np.isnan(b))
                 for a, b in zip(got[1:5], fold0[1:5]))
    close = all((abs(a - b) <= 1e-5) or (np.isnan(a) and np.isnan(b))
                for a, b in ((got[0], fold0[0]), (got[5], fold0[5])))
    if not (counts and close):
        raise AssertionError(f"evaluate: {got} from {best}, the fold logged "
                             f"{fold0}")
    print(f"[k-fold, evaluate] cli/evaluate.py --model {model} --fold 0 on "
          f"{best}: {got}; "
          f"fold 0 logged {fold0} (counts equal, loss and AUC within 1e-5)",
          flush=True)


def _fold0_trainer(source, save_dir, n_records, **cfg_kw):
    """A Trainer as the k-fold driver makes fold 0's, and fold 0's
    loaders over `source`."""
    from transmf_ad_tpu_torch.data import Loader
    from transmf_ad_tpu_torch.train import Trainer, TrainerConfig
    from transmf_ad_tpu_torch.train.kfold import (kfold_split,
                                                  train_val_split)

    tr, _ = next(kfold_split(n_records, KFOLD_FOLDS, KFOLD_SEED))
    tr, va = train_val_split(tr, KFOLD_SEED)
    loaders = (Loader(source, list(tr), BATCH, shuffle=True, drop_last=True,
                      seed=KFOLD_SEED),
               Loader(source, list(va), BATCH))
    cfg = TrainerConfig(seed=KFOLD_SEED, save_dir=save_dir, progress=False,
                        **cfg_kw)
    return Trainer(cfg), loaders


def _resume_check(source, tmp, n_records):
    """One epoch with save_latest_every=1, then a run resumed to 2: right
    after the load the step, learning rate, Adam moments, scheduler and
    generator equal what was saved, and the run logs epoch 2 only."""
    from transmf_ad_tpu_torch.train import checkpoint as ckpt
    from transmf_ad_tpu_torch.train import trainer as trainer_mod

    save = os.path.join(tmp, "resume")
    first, loaders = _fold0_trainer(source, save, n_records, epochs=1,
                                    save_latest_every=1)
    first.fit(*loaders)
    saved = ckpt.load_latest(save)
    seen = {}
    run = trainer_mod.Engine.run

    def spy(engine, loader, max_epochs=1, start_epoch=0):
        st = resumed.state
        seen.update(start=start_epoch, step=st.step,
                    lr=st.optimizer.param_groups[0]["lr"],
                    opt=copy.deepcopy(st.optimizer.state_dict()),
                    sched=st.scheduler.state_dict(),
                    gen=st.generator.get_state().clone())
        return run(engine, loader, max_epochs, start_epoch)

    resumed, loaders = _fold0_trainer(source, save, n_records, epochs=2,
                                      resume=True)
    with mock.patch.object(trainer_mod.Engine, "run", spy):
        resumed.fit(*loaders)
    moments = all(torch.equal(seen["opt"]["state"][i][k].cpu(), v)
                  for i, st in saved["optimizer"]["state"].items()
                  for k, v in st.items())
    log = open(os.path.join(save, "log.txt")).read()
    after = log[log.index("Resumed from epoch 1"):]
    ok = (seen["start"] == saved["epoch"] == 1
          and seen["step"] == saved["step"] > 0
          and seen["lr"] == saved["optimizer"]["param_groups"][0]["lr"]
          and moments and seen["sched"] == saved["scheduler"]
          and torch.equal(seen["gen"], saved["generator"])
          and "Training Results - Epoch[2]" in after
          and "Epoch[1]" not in after
          and resumed.state.step == 2 * saved["step"])
    if not ok:
        raise AssertionError(f"resume: restored start {seen['start']}, step "
                             f"{seen['step']}, lr {seen['lr']}, moments "
                             f"{moments}; saved epoch {saved['epoch']}, step "
                             f"{saved['step']}")
    print(f"[k-fold, resume] 1 epoch with save_latest_every=1, then resumed "
          f"to 2: step {seen['step']}, lr {seen['lr']}, Adam moments of "
          f"{len(saved['optimizer']['state'])} tensors, the scheduler and "
          f"the generator's state restored exactly; the resumed run logged "
          f"epoch 2 only", flush=True)


def _feed_rates(source, tmp, n_records):
    """Fold 0 for 2 epochs through the streaming and the hybrid feeds: the
    epochs' vols/s as the Trainer logs them (printed, not held)."""
    from transmf_ad_tpu_torch.data import (DeviceFeed, HybridCachedFeed,
                                           cache_bytes)

    rates = {}
    for feed, want in (("off", DeviceFeed), ("hybrid", HybridCachedFeed)):
        save = os.path.join(tmp, f"feed_{feed}")
        trainer, loaders = _fold0_trainer(source, save, n_records, epochs=2,
                                          device_cache=feed)
        half = cache_bytes(loaders[0]) / 2
        with mock.patch.dict(os.environ,
                             {"TRANSMF_CACHE_BUDGET_MB": str(half / 2**20)}):
            trainer.fit(*loaders)
        if not isinstance(trainer.train_feed, want):
            raise AssertionError(f"device_cache={feed!r} fed the card "
                                 f"through {type(trainer.train_feed)}")
        name = type(trainer.train_feed).__name__
        if feed == "hybrid":
            name += (f" ({trainer.train_feed.n_hot}/"
                     f"{len(loaders[0].indices)} hot)")
        rates[name] = _epoch_rates(os.path.join(save, "log.txt"))
    print(f"[k-fold, feeds] fold 0, full-width ModelAd bf16, batch {BATCH}, "
          f"augmentation on: epoch vols/s (epoch 1, 2) by feed on "
          f"{torch.cuda.get_device_name(0)}: {rates}", flush=True)


def kfold_check(card):
    """Phase 14: the k-fold entry point on the card (see the module's
    docstring). Returns the launch counts of its two CLI runs."""
    from transmf_ad_tpu_torch.data import (ADNI, VolumeSource,
                                           make_synthetic_adni)

    laps = [("start", time.perf_counter())]
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "adni")
        make_synthetic_adni(root, n_per_group=KFOLD_PER_CLASS, shape=VOLUME,
                            groups=("CN", "AD"), seed=1,
                            workers=os.cpu_count() or 1)
        n = 2 * KFOLD_PER_CLASS
        laps.append(("tree", time.perf_counter()))
        print(f"[k-fold] synthetic ADNI, {n} ADCN pairs at {VOLUME}, written "
              f"in {laps[-1][1] - laps[0][1]:.1f} s", flush=True)
        ckpt = os.path.join(tmp, "checkpoints")
        res, launches, _ = _kfold_run("k-fold, ModelAd", root, ckpt, "kfold",
                                      n, "Transformer")
        laps.append(("5 folds", time.perf_counter()))
        _, cnn, _ = _kfold_run("k-fold, ModelCNNAd", root, ckpt, "kfold_cnn",
                               n, "CNN", folds="0")
        laps.append(("CNN fold", time.perf_counter()))
        # one bf16 RAM cache for the checks below, decoded once
        source = VolumeSource(ADNI(root, task="ADCN").data_dict,
                              dtype=torch.bfloat16)
        _feeds_check(source, n)
        laps.append(("feeds", time.perf_counter()))
        _evaluate_check(root, ckpt, "kfold", res["folds"][0])
        laps.append(("evaluate", time.perf_counter()))
        _resume_check(source, tmp, n)
        laps.append(("resume", time.perf_counter()))
        _feed_rates(source, tmp, n)
        laps.append(("feed rates", time.perf_counter()))
    spent = ", ".join(f"{name} {t - t_before:.1f}" for (_, t_before), (name, t)
                      in zip(laps, laps[1:]))
    print(f"[k-fold] phase seconds {laps[-1][1] - laps[0][1]:.1f} ({spent}) "
          f"on {card}", flush=True)
    return launches, cnn


def _fold0_counts(n_records, drop_last):
    """(train steps, of them ragged, eval batches) of fold 0 of the k-fold
    split over 1 + 1 epochs at batch BATCH: 25 train pairs, 7 validation,
    8 test of 40."""
    from transmf_ad_tpu_torch.train.kfold import (kfold_split,
                                                  train_val_split)

    tr, te = next(kfold_split(n_records, KFOLD_FOLDS, KFOLD_SEED))
    tr, va = train_val_split(tr, KFOLD_SEED)
    per_epoch = (len(tr) // BATCH if drop_last
                 else math.ceil(len(tr) / BATCH))
    ragged = 0 if drop_last or len(tr) % BATCH == 0 else 2
    evals = 2 * math.ceil(len(va) / BATCH) + math.ceil(len(te) / BATCH)
    return 2 * per_epoch, ragged, evals


def _zoo_run(tag, main, flags, exact, log_dir):
    """A CLI's `main` in this process with the counts at 0: the kernels of
    `exact` launched exactly that often, every other kernel never, each
    launch in its rule's variant; the result's losses and accuracies
    finite and the run's log complete. Returns (result, launches,
    seconds)."""
    reset_counts()
    t0 = time.perf_counter()
    res = main(flags)
    seconds = time.perf_counter() - t0
    launches = _launches()
    took = _require_variants(tag, FAST)
    _require_launches(tag, launches, [n for n, c in exact.items() if c],
                      {n: exact.get(n, 0) for n in launches})
    folds = np.array(res["folds"] if isinstance(res, dict) else [res])
    if folds.shape != (1, 6) or not np.isfinite(folds[:, :2]).all():
        raise AssertionError(f"{tag}: result {res}")
    log_path = os.path.join(log_dir, "log.txt")
    log = open(log_path).read()
    missing = [t for t in ("Training Results", "Validation Results",
                           "Test Results") if t not in log]
    if missing:
        raise AssertionError(f"{tag}: {log_path} lacks {missing}")
    print(f"[{tag}] {seconds:.1f} s on {torch.cuda.get_device_name(0)}: "
          f"test {folds[0].round(4).tolist()}; epoch vols/s (as the "
          f"Trainer logs them) {_epoch_rates(log_path)}; launches "
          f"{ {n: c for n, c in launches.items() if c} }, variants {took}",
          flush=True)
    return res, launches, seconds


def zoo_cross_check(model_name, volume, **model_kw):
    """`cross_check` of a model with seeded weights at its full geometry."""
    from transmf_ad_tpu_torch.models import SINGLE_MODALITY, build_model
    from transmf_ad_tpu_torch.utils.weights import init_weights

    g = torch.Generator().manual_seed(3)
    reference = build_model(model_name, input_shape=volume, **model_kw)
    init_weights(reference, g)
    randomize_bn(reference, g)
    cross_check(copy.deepcopy(reference).cuda(), reference, volume,
                f"check, {model_name} {model_kw or ''} at {volume}",
                1 if model_name in SINGLE_MODALITY else 2)


def zoo_check(card):
    """Phase 15: the baselines' and the hold-out's entry points on the card
    (see the module's docstring). Returns the launch counts of its four CLI
    runs by name."""
    from transmf_ad_tpu_torch.cli import (kfold_train_ADVIT,
                                          kfold_train_Mnet,
                                          kfold_train_single,
                                          train_adversarial)
    from transmf_ad_tpu_torch.data import make_synthetic_adni

    n = 2 * KFOLD_PER_CLASS
    laps = [("start", time.perf_counter())]
    runs, seconds = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        roots = {shape: make_synthetic_adni(
            os.path.join(tmp, "x".join(map(str, shape))),
            n_per_group=KFOLD_PER_CLASS, shape=shape, groups=("CN", "AD"),
            seed=1, workers=os.cpu_count() or 1)
            for shape in (VOLUME, ADVIT_VOLUME)}
        laps.append(("trees", time.perf_counter()))
        ckpt = os.path.join(tmp, "checkpoints")

        def flags(name, shape=VOLUME, model="Transformer", folds="0"):
            return _cli_flags(roots[shape], ckpt, name, model, folds)

        steps, ragged, evals = _fold0_counts(n, drop_last=False)
        if not ragged:
            raise AssertionError("zoo: fold 0 of ModelSingle has no ragged "
                                 "train batch")
        tag = "k-fold CLI, ModelSingle"
        single, runs[tag], seconds[tag] = _zoo_run(
            tag, kfold_train_single.main, flags("single"),
            {"stem_conv_stats": steps, "stem_dw": steps, "stem_conv": evals,
             "affine_act_pool": 4 * (steps + evals),
             "affine_act_pool_bwd": 4 * steps, "augment": steps},
            os.path.join(ckpt, "single", "0"))
        _evaluate_check(roots[VOLUME], ckpt, "single", single["folds"][0],
                        model="single")
        laps.append(("ModelSingle", time.perf_counter()))

        steps, _, evals = _fold0_counts(n, drop_last=True)
        tag = "k-fold CLI, ADVIT"
        _, runs[tag], seconds[tag] = _zoo_run(
            tag, kfold_train_ADVIT.main, flags("advit", ADVIT_VOLUME),
            {"attention_fwd": ADVIT_CALLS * (steps + evals)},
            os.path.join(ckpt, "advit", "0"))
        laps.append(("ADVIT", time.perf_counter()))
        tag = "k-fold CLI, Mnet"
        _, runs[tag], seconds[tag] = _zoo_run(
            tag, kfold_train_Mnet.main, flags("mnet"), {"augment": steps},
            os.path.join(ckpt, "mnet", "0"))
        laps.append(("Mnet", time.perf_counter()))

        # the hold-out's 60 / 20 / 20 of 40: 24 / 8 / 8, one epoch
        steps, evals = 24 // BATCH, 2
        forwards = steps + evals
        tag = "hold-out CLI, ModelAd heads 8"
        _, runs[tag], seconds[tag] = _zoo_run(
            tag, train_adversarial.main,
            flags("holdout", folds="") + ["--stage2_epochs", "0"],
            {"stem_conv_stats": 2 * steps, "stem_dw": 2 * steps,
             "stem_conv": 2 * evals, "token_pool": forwards,
             "attention_fwd": ATTENTION_CALLS * forwards,
             "affine_act_pool": 8 * forwards,
             "affine_act_pool_bwd": 8 * steps, "augment": steps},
            os.path.join(ckpt, "holdout"))
        laps.append(("hold-out", time.perf_counter()))
    reset_counts()
    zoo_cross_check("single", VOLUME)
    zoo_cross_check("advit", ADVIT_PAD)
    zoo_cross_check("mnet", VOLUME)
    zoo_cross_check("ad", VOLUME, heads=HOLDOUT_HEADS)
    laps.append(("card vs CPU", time.perf_counter()))
    train_check("single")
    train_check("advit", ADVIT_CHECK)
    train_check("mnet", CHECK_VOLUME, **MNET_CHECK)
    laps.append(("train checks", time.perf_counter()))
    spent = ", ".join(f"{name} {t - t_before:.1f}" for (_, t_before), (name, t)
                      in zip(laps, laps[1:]))
    print(f"[zoo] phase seconds {laps[-1][1] - laps[0][1]:.1f} ({spent}); "
          f"CLI runs {({k: round(v, 1) for k, v in seconds.items()})} on "
          f"{card}", flush=True)
    return runs


# ----- phase 16: remat -----

def _remat_run(model_name, batch_size, remat, warmup=REMAT_WARMUP,
               steps=REMAT_STEPS):
    """Train steps of full-width `model_name` at `batch_size`,
    182x218x182, bf16, no augmentation, with or without remat: (median
    ms/step, peak GiB, launches per step, variants)."""
    from transmf_ad_tpu_torch.models import ADVERSARIAL, build_model
    from transmf_ad_tpu_torch.train import create_state, make_train_step
    from transmf_ad_tpu_torch.utils.weights import init_weights

    g = torch.Generator().manual_seed(3)
    model = build_model(model_name, remat=remat)
    init_weights(model, g)
    randomize_bn(model, g)
    state = create_state(model, "cuda", "auto", seed=0, name="Adam",
                         lr=1e-4)
    step = make_train_step(adversarial=model_name in ADVERSARIAL)
    dg = torch.Generator(device="cuda").manual_seed(4)
    batch = {"MRI": torch.rand(batch_size, *FULL_VOLUME, generator=dg,
                               device="cuda"),
             "PET": torch.rand(batch_size, *FULL_VOLUME, generator=dg,
                               device="cuda"),
             "label": torch.arange(batch_size, device="cuda") % 2}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, losses = [], []
    for _ in range(warmup + steps):
        t0 = time.perf_counter()
        aux = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(aux["loss"]))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"remat {model_name} batch {batch_size}: "
                             f"losses {losses}")
    took = _require_variants(f"remat {model_name}", FAST)
    launches = _launches()
    per_step = {n: c / (warmup + steps) for n, c in launches.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state, model, batch, aux, step
    torch.cuda.empty_cache()
    return 1e3 * float(np.median(times[warmup:])), peak, per_step, took, \
        launches


def _remat_f32_check(model_name):
    """One float32 SGD step (TF32 off) of full-width `model_name` at batch
    6, 182x218x182, with remat against one without, from the same weights
    and inputs: the train-check rule (`compare_steps`, the spread from
    REMAT_DRAWS steps without remat on perturbed inputs), and the running
    statistics, which move once either way, within 1e-6 of max(1, their
    magnitude)."""
    from transmf_ad_tpu_torch.models import ADVERSARIAL, build_model
    from transmf_ad_tpu_torch.utils.weights import init_weights

    g = torch.Generator().manual_seed(5)
    plain = build_model(model_name, head_dropout=0.0)
    init_weights(plain, g)
    randomize_bn(plain, g)
    rematted = build_model(model_name, head_dropout=0.0, remat=True)
    rematted.load_state_dict(plain.state_dict())
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.random((FULL_BATCH, *FULL_VOLUME),
                                            dtype=np.float32))
             for k in ("MRI", "PET")}
    batch["label"] = torch.arange(FULL_BATCH) % 2
    adversarial = model_name in ADVERSARIAL

    def run(model, b):
        out = sgd_step(copy.deepcopy(model), "cuda", b, adversarial)
        torch.cuda.empty_cache()
        return out

    ref = run(plain, batch)
    perturbed = [run(plain, perturb(batch, d)) for d in range(REMAT_DRAWS)]
    got = run(rematted, batch)
    rows = compare_steps(got, ref, perturbed)
    stats = [k for k in ref if "running" in k]
    worst = max(float((got[k] - ref[k]).abs().max())
                / max(1.0, float(ref[k].abs().max())) for k in stats)
    if worst > 1e-6:
        raise AssertionError(f"remat check {model_name}: a running "
                             f"statistic moved by {worst} of its scale")
    print(f"[remat check, {model_name}] one f32 SGD step at batch "
          f"{FULL_BATCH} x {FULL_VOLUME}, remat against none: loss "
          f"{float(got['loss']):.6f} vs {float(ref['loss']):.6f}; all "
          f"{len(rows)} tensors within the train-check rule, closest "
          f"{[(n, round(t, 3)) for t, _, n in rows[:3]]}; running "
          f"statistics within {worst:.3g} of their scale", flush=True)


def remat_check(card):
    """Phase 16: per-block remat at full resolution (see the module's
    docstring). Returns the launch counts of its bf16 runs."""
    from transmf_ad_tpu_torch.models import build_model

    wrapped = build_model("ad").mri_cnn.remat_blocks(
        (FULL_BATCH, *FULL_VOLUME, 1))
    if wrapped != REMAT_BLOCKS:
        raise AssertionError(f"remat: the rule wraps blocks {wrapped}, "
                             f"expected {REMAT_BLOCKS}")
    for name in ("ad", "transformer_res"):
        _remat_f32_check(name)
    total = {}
    table = {}
    for name in ("ad", "transformer_res"):
        for batch_size in REMAT_BATCHES:
            per = {}
            for remat in (False, True):
                ms, peak, per[remat], took, launches = _remat_run(
                    name, batch_size, remat)
                table[name, batch_size, remat] = (ms, peak)
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
                print(f"[remat, {name}] batch {batch_size} x {FULL_VOLUME} "
                      f"bf16, remat {remat}: {ms:.2f} ms/step (median of "
                      f"{REMAT_STEPS} after {REMAT_WARMUP}), peak "
                      f"{peak:.2f} GiB on {card}; variants {took}",
                      flush=True)
            extra = {k: per[True][k] - per[False][k] for k in per[True]
                     if per[True][k] != per[False][k]}
            if extra != REMAT_EXTRA:
                raise AssertionError(
                    f"remat {name} batch {batch_size}: extra launches a "
                    f"step {extra}, expected {REMAT_EXTRA}")
    free, total_mem = torch.cuda.mem_get_info()
    for name in ("ad", "transformer_res"):
        for remat in (False, True):
            (_, p6), (_, p12) = (table[name, b, remat] for b in REMAT_BATCHES)
            slope = (p12 - p6) / (REMAT_BATCHES[1] - REMAT_BATCHES[0])
            base = p6 - REMAT_BATCHES[0] * slope
            fits = int((total_mem / 2**30 - base) // slope)
            print(f"[remat, {name}] remat {remat}: peak {p6:.2f} / "
                  f"{p12:.2f} GiB at batch {REMAT_BATCHES}, {slope:.3f} "
                  f"GiB a sample over {base:.2f}: the largest batch "
                  f"estimated to fit {total_mem / 2**30:.1f} GiB is {fits} "
                  f"(estimated, not searched)", flush=True)
    print(f"[remat] each wrapped block (blocks {REMAT_BLOCKS} of each "
          f"encoder) launches its forward kernels once more a step: "
          f"{REMAT_EXTRA}, exact at batch {REMAT_BATCHES} for both models",
          flush=True)
    return total


# ----- phase 17: data parallel -----

def _spawn(args, log_path, env=None):
    """A child process running this script with `args`, its output to
    `log_path`."""
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *args],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, **(env or {})), stdout=log,
        stderr=subprocess.STDOUT)
    proc.log_path = log_path
    log.close()
    return proc


def _wait_all(procs, timeout):
    """Wait for every child; a failure or a run over `timeout` seconds kills
    every child and raises with the end of their output."""
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                failed = "failed" if time.monotonic() <= deadline \
                    else f"over {timeout} s"
                break
            time.sleep(0.1)
        if failed is None and any(p.returncode for p in procs):
            failed = "failed"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if failed:
        tails = [f"--- {p.log_path} (exit {p.returncode}) ---\n"
                 + open(p.log_path).read()[-3000:] for p in procs]
        raise AssertionError(f"data parallel: a child {failed}\n"
                             + "\n".join(tails))


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _wait_for_file(path, timeout):
    """Poll for `path` (the parent's go-ahead); raise after `timeout` s."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.05)


def _profiled_steps(step, state, batch):
    """Wall ms a step over DP_PROFILED steps under the profiler, and the
    collectives it saw: {name: (calls a step, host ms a step)}."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(DP_PROFILED):
            step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / DP_PROFILED
    coll = {}
    for e in prof.key_averages():
        if re.search(r"all_?reduce|broadcast|all_?gather|all_?to_?all",
                     e.key, re.I):
            coll[e.key] = (e.count / DP_PROFILED,
                           e.cpu_time_total / 1e3 / DP_PROFILED)
    return 1e3 * wall, coll


def _dp_child_step(task, rank):
    """A rank of phase 17 (a): one f32 SGD step on this rank's rows (its
    results and launches); then, once the parent's go-ahead file exists
    (the CLI runs have ended, so no other work shares the card), the
    profiler's step and collective times over DP_PROFILED more steps."""
    from transmf_ad_tpu_torch.models import build_model
    from transmf_ad_tpu_torch.parallel import (init_distributed,
                                               place_global, shard_state,
                                               shutdown, world_group)
    from transmf_ad_tpu_torch.train import create_state, make_train_step

    init_distributed(f"localhost:{task['port']}", task["world"], rank,
                     backend="gloo", device="cuda")
    try:
        model = build_model("ad", head_dropout=0.0)
        model.load_state_dict(torch.load(task["weights"], weights_only=True))
        before = _snapshot(model)
        state = shard_state(create_state(model, "cuda", torch.float32,
                                         name="SGD", lr=1.0, milestones=()),
                            world_group())
        batch = place_global(torch.load(task["batch"], weights_only=True),
                             task["world"], rank)
        step = make_train_step(group=world_group())
        reset_counts()
        aux = step(state, batch)
        torch.cuda.synchronize()
        launches, variants = _launches(), _require_variants("dp step", {})
        out = {k: aux[k].float().cpu() for k in ("loss", "ce_loss",
                                                 "ad_loss")}
        after = _snapshot(model)
        for k, v in after.items():
            out[k if "running" in k else k + " update"] = (
                v if "running" in k else v - before[k])
        _wait_for_file(task["go"], DP_TIMEOUT)
        step_ms, coll = _profiled_steps(step, state, batch)
        torch.save({"out": out, "launches": launches, "variants": variants,
                    "collectives": coll, "step_ms": step_ms},
                   os.path.join(task["dir"], f"step_r{rank}.pt"))
    finally:
        shutdown()


def _dp_child_cli(task, rank):
    """A rank of phase 17 (b) or (c): the k-fold CLI's `main` with the
    multi-process flags; the files this rank opened for writing under the
    checkpoints, its state_dict before the test reloads the best weights,
    the feed and the launches; then `cli/evaluate.py --fold 0` on the same
    ranks, scoring fold 0's best `.pt`."""
    from transmf_ad_tpu_torch.cli import evaluate, kfold_train_adversarial
    from transmf_ad_tpu_torch.train import trainer as trainer_mod

    root = os.path.realpath(task["ckpt"])
    written = []

    def hook(event, args):
        if event == "open" and isinstance(args[0], (str, bytes)) and (
                any(c in (args[1] or "") for c in "wax+")
                or (args[2] or 0) & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)):
            path = os.path.realpath(os.fsdecode(args[0]))
            if path.startswith(root):
                written.append(os.path.relpath(path, root))

    sys.addaudithook(hook)
    save = torch.save  # writes through its own C++ file writer

    def recorded_save(obj, f, *a, **kw):
        hook("open", (f, "wb", 0))
        return save(obj, f, *a, **kw)

    torch.save = recorded_save
    if task["backend"]:  # ranks sharing the card: the CLI finds it up
        from transmf_ad_tpu_torch.parallel import init_distributed

        init_distributed(f"localhost:{task['port']}", task["world"], rank,
                         backend=task["backend"], device="cuda")
    before_test = {}
    load = trainer_mod.Trainer.load_checkpoint

    def spy(self, path):
        if not before_test:
            before_test.update(_snapshot(self.state.model))
        return load(self, path)

    trainer_mod.Trainer.load_checkpoint = spy
    reset_counts()
    multi = ["--coordinator_address", f"localhost:{task['port']}",
             "--num_processes", str(task["world"]), "--process_id",
             str(rank)]
    res = kfold_train_adversarial.main([*task["flags"], *multi])
    launches, variants = _launches(), _require_variants("dp cli", FAST)
    wrote = list(written)
    (best,) = glob.glob(os.path.join(task["ckpt"], task["name"], "0",
                                     "best_label_net_model_*.pt"))
    m = evaluate.main(["--checkpoint", best, "--fold", "0",
                       *task["eval_flags"], *multi])
    torch.save = save
    save({"res": res, "written": wrote, "state": before_test,
          "launches": launches, "variants": variants,
          "evaluate": [m["loss"], m["accuracy"], m["sen"], m["spe"],
                       m["f1"], m["auc"]]},
         os.path.join(task["dir"], f"{task['name']}_r{rank}.pt"))
    from transmf_ad_tpu_torch.parallel import shutdown

    shutdown()


def dp_child(task_path, rank):
    """Entry of a child process of phase 17."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(task_path) as f:
        task = json.load(f)
    {"step": _dp_child_step, "cli": _dp_child_cli, "load": _child_load,
     "shard": _child_shard, "model_axis": _mp_child}[task["kind"]](task,
                                                                   rank)
    return 0


def _dp_step_check(card, tmp, also=()):
    """Phase 17 (a): one f32 step of full-width ModelAd on 2 ranks sharing
    the card through Gloo against the single-process step on the same
    global batch. `also`: children already running (the CLI runs). Once
    they have ended, the single-process step on one rank's rows is timed,
    then the ranks' steps, each with the card to itself."""
    from transmf_ad_tpu_torch.models import build_model
    from transmf_ad_tpu_torch.parallel import place_global
    from transmf_ad_tpu_torch.train import create_state, make_train_step
    from transmf_ad_tpu_torch.utils.weights import init_weights

    g = torch.Generator().manual_seed(6)
    model = build_model("ad", head_dropout=0.0)
    init_weights(model, g)
    randomize_bn(model, g)
    torch.save(model.state_dict(), os.path.join(tmp, "weights.pt"))
    rng = np.random.default_rng(6)
    batch = {k: torch.from_numpy(rng.random((DP_BATCH, *VOLUME),
                                            dtype=np.float32))
             for k in ("MRI", "PET")}
    batch["label"] = torch.arange(DP_BATCH) % 2
    torch.save(batch, os.path.join(tmp, "batch.pt"))
    task = os.path.join(tmp, "step.json")
    with open(task, "w") as f:
        json.dump({"kind": "step", "world": DP_WORLD, "port": _free_port(),
                   "weights": os.path.join(tmp, "weights.pt"),
                   "batch": os.path.join(tmp, "batch.pt"), "dir": tmp,
                   "go": os.path.join(tmp, "go")}, f)
    procs = [_spawn(["--dp-child", task, str(r)],
                    os.path.join(tmp, f"step_r{r}.log"))
             for r in range(DP_WORLD)]
    try:  # the reference while the ranks run
        ref = sgd_step(copy.deepcopy(model), "cuda", batch)
        perturbed = [sgd_step(copy.deepcopy(model), "cuda", perturb(batch, d))
                     for d in range(CHECK_DRAWS)]
        _wait_all(list(also), DP_TIMEOUT)
        # the card free of other work: one process on rank 0's rows, then
        # the ranks
        state = create_state(copy.deepcopy(model), "cuda", torch.float32,
                             name="SGD", lr=1.0, milestones=())
        rows, step = place_global(batch, DP_WORLD, 0), make_train_step()
        step(state, rows)  # the warm-up the ranks' checked step is
        single_ms, _ = _profiled_steps(step, state, rows)
        del state
        open(os.path.join(tmp, "go"), "w").close()
        _wait_all(procs, DP_TIMEOUT)
    finally:
        for p in procs + list(also):
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = [torch.load(os.path.join(tmp, f"step_r{r}.pt"),
                        weights_only=False) for r in range(DP_WORLD)]
    a, b = ranks[0]["out"], ranks[1]["out"]
    same = [k for k in a if not torch.equal(a[k], b[k])]
    if same:
        raise AssertionError(f"data parallel: the ranks differ after the "
                             f"step in {same}")
    rows = compare_steps(a, ref, perturbed)
    launches = {}
    for r, res in enumerate(ranks):
        want = {"stem_conv_stats": 2, "stem_dw": 2, "token_pool": 1,
                "attention_fwd": ATTENTION_CALLS, "augment": 0}
        miss = {k: res["launches"][k] for k in want
                if res["launches"][k] != want[k]}
        if miss or not (res["launches"]["affine_act_pool"]
                        and res["launches"]["affine_act_pool_bwd"]):
            raise AssertionError(f"data parallel: rank {r} launched "
                                 f"{res['launches']}, expected {want} and "
                                 "K4 / K7")
        for k, v in res["launches"].items():
            launches[k] = launches.get(k, 0) + v
    print(f"[data parallel, step] full-width ModelAd f32, global batch "
          f"{DP_BATCH} x {VOLUME} on {DP_WORLD} ranks (Gloo, one card) "
          f"against one process: loss {float(a['loss']):.6f} vs "
          f"{float(ref['loss']):.6f}; all {len(rows)} tensors within the train-check rule, closest "
          f"{[(n, round(t, 3)) for t, _, n in rows[:3]]}; the ranks' "
          f"parameters and running statistics bit-identical; launches per "
          f"rank {[r['launches'] for r in ranks]}", flush=True)
    print(f"[data parallel, step] one process on {DP_BATCH // DP_WORLD} "
          f"pairs (rank 0's rows): {single_ms:.2f} ms/step over "
          f"{DP_PROFILED} steps under the profiler, the card to itself, on "
          f"{card}", flush=True)
    for r, res in enumerate(ranks):
        print(f"[data parallel, step] rank {r}: {res['step_ms']:.2f} "
              f"ms/step over {DP_PROFILED} steps under the profiler, after "
              f"the CLI runs ended ({res['step_ms'] - single_ms:+.2f} ms "
              f"against one process on the same pairs: the collectives "
              f"and the other rank's kernels on the same card); collectives "
              f"a step (count, host ms): "
              f"{ {k: (round(c, 1), round(t, 3)) for k, (c, t) in res['collectives'].items()} } "
              f"on {card}; Gloo over one shared card, not NCCL", flush=True)
    return launches


def _dp_cli_task(tmp, name, root, world, backend=None, env=None):
    """Spawn the k-fold CLI of phase 17 on `world` ranks, in a process group
    of `backend` that each child joins before the CLI (None: the CLI's
    own, NCCL on the card); returns (the children, the checkpoints
    directory)."""
    ckpt = os.path.join(tmp, f"ck_{name}")
    task = os.path.join(tmp, f"{name}.json")
    with open(task, "w") as f:
        json.dump({"kind": "cli", "name": name, "world": world,
                   "port": _free_port(), "ckpt": ckpt, "backend": backend,
                   "flags": _cli_flags(root, ckpt, name, folds="0"),
                   "eval_flags": _cli_flags(root, ckpt, f"{name}_evaluate"),
                   "dir": tmp}, f)
    procs = [_spawn(["--dp-child", task, str(r)],
                    os.path.join(tmp, f"{name}_r{r}.log"), env)
             for r in range(world)]
    return procs, ckpt


def dp_check(card):
    """Phase 17: data-parallel training (see the module's docstring).
    Returns the children's launch counts."""
    from transmf_ad_tpu_torch.data import make_synthetic_adni

    laps = [("start", time.perf_counter())]
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "adni")
        make_synthetic_adni(root, n_per_group=KFOLD_PER_CLASS, shape=VOLUME,
                            groups=("CN", "AD"), seed=2,
                            workers=os.cpu_count() or 1)
        laps.append(("tree", time.perf_counter()))
        # every child at once: 7 processes share the card until the CLI
        # runs end; the step's timings come after that
        runs = {"cached": _dp_cli_task(tmp, "cached", root, DP_WORLD, "gloo"),
                "stream": _dp_cli_task(tmp, "stream", root, DP_WORLD, "gloo",
                                       {"TRANSMF_CACHE_BUDGET_MB": "0"}),
                "nccl": _dp_cli_task(tmp, "nccl", root, 1)}
        launches["data parallel step"] = _dp_step_check(
            card, tmp, [p for procs, _ in runs.values() for p in procs])
        laps.append(("step and CLI runs", time.perf_counter()))
        want_feed = {"cached": "DeviceCachedFeed", "stream": "DeviceFeed",
                     "nccl": "DeviceCachedFeed"}
        for name, (procs, ckpt) in runs.items():
            ranks = [torch.load(os.path.join(tmp, f"{name}_r{r}.pt"),
                                weights_only=False)
                     for r in range(len(procs))]
            res = ranks[0]["res"]
            fold0 = res["folds"][0]
            if res["feeds"] != [want_feed[name]] \
                    or not np.isfinite(fold0[:2]).all():
                raise AssertionError(f"data parallel {name}: feeds "
                                     f"{res['feeds']}, fold 0 {fold0}")
            for r, got in enumerate(ranks[1:], 1):
                diff = [k for k in ranks[0]["state"]
                        if not torch.equal(got["state"][k],
                                           ranks[0]["state"][k])]
                if diff or got["written"] or not np.array_equal(
                        got["res"]["folds"], res["folds"], equal_nan=True):
                    raise AssertionError(
                        f"data parallel {name}: rank {r} differs in {diff}, "
                        f"folds {got['res']['folds']} vs {res['folds']}, "
                        f"wrote {got['written']}")
            wrote = sorted(set(ranks[0]["written"]))
            if not any(w.endswith("log.txt") for w in wrote) or not any(
                    "best_label_net_model" in w for w in wrote):
                raise AssertionError(f"data parallel {name}: rank 0 wrote "
                                     f"{wrote}")
            steps = _fold0_counts(2 * KFOLD_PER_CLASS, drop_last=True)[0]
            for r, got in enumerate(ranks):
                launches[f"data parallel CLI {name} rank {r}"] = \
                    got["launches"]
                if got["launches"]["augment"] != steps:
                    raise AssertionError(
                        f"data parallel {name}: rank {r} launched K13 "
                        f"{got['launches']['augment']} times in {steps} "
                        "train steps")
                ev = got["evaluate"]
                counts = all((x == y) or (np.isnan(x) and np.isnan(y))
                             for x, y in zip(ev[1:5], fold0[1:5]))
                close = all((abs(x - y) <= 1e-5)
                            or (np.isnan(x) and np.isnan(y))
                            for x, y in ((ev[0], fold0[0]),
                                         (ev[5], fold0[5])))
                if not (counts and close):
                    raise AssertionError(
                        f"data parallel {name}: cli/evaluate.py --fold 0 on "
                        f"rank {r} gave {ev}, the fold logged {fold0}")
            print(f"[data parallel, CLI {name}] {len(ranks)} rank(s) "
                  f"({'NCCL' if name == 'nccl' else 'Gloo over one card'}), "
                  f"bf16, fold 0 of 1 + 1 epochs, feed {res['feeds'][0]}: "
                  f"test {[round(v, 4) for v in fold0]}, reproduced by "
                  f"cli/evaluate.py --fold 0 on the same ranks (counts "
                  f"equal, loss and AUC within 1e-5); the ranks' states "
                  f"identical, rank 0 alone wrote {wrote}; epoch vols/s "
                  f"{_epoch_rates(os.path.join(ckpt, name, '0', 'log.txt'))}"
                  f"; launches per rank {[g['launches'] for g in ranks]}",
                  flush=True)
        laps.append(("checks", time.perf_counter()))
    spent = ", ".join(f"{n} {t - tb:.1f}" for (_, tb), (n, t)
                      in zip(laps, laps[1:]))
    print(f"[data parallel] phase seconds {laps[-1][1] - laps[0][1]:.1f} "
          f"({spent}) on {card}", flush=True)
    return launches


def _kernel_names():
    """The `__global__` names of the port's CUDA sources."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "transmf_ad_tpu_torch", "csrc")
    names = set()
    for path in glob.glob(os.path.join(src, "*.cu*")):
        with open(path) as f:
            names.update(re.findall(
                r"__global__\s+(?:void\s+)?(?:__\w+__\s*\([^)]*\)\s*)*"
                r"(?:void\s+)?(\w+)\s*\(", f.read()))
    return names


class _Wrapper(torch.autograd.Function):
    """The kernels' entry path before they were registered ops: an
    autograd.Function around the launch path (forward only), the
    yardstick of `_op_host_us`."""

    @staticmethod
    def forward(ctx, launch, *args):
        return launch(*args)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError


def _op_host_us(card):
    """Phase 18 (a), second half: the host's microseconds a call of K1
    ((8,150,128) x2) and of K4 (channels, max, pooling the stage-3 output
    (8,22,27,22,128) to (8,11,13,11,128)) through the old wrapper's path
    (`_Wrapper`) and through the registered op, in inference mode (serving)
    and with inputs that require grad (a train step's forward), in turns:
    old, op, op, old. Printed, not held."""
    from transmf_ad_tpu_torch.ops import pool3d, pooling

    g = torch.Generator(device="cuda").manual_seed(7)
    mri, pet = (_randn(g, 8, 150, 128).to(torch.bfloat16) for _ in range(2))
    y = _randn(g, 8, 22, 27, 22, 128).to(torch.bfloat16)
    s, b = 1.0 + 0.5 * _randn(g, 128), 0.3 * _randn(g, 128)
    calls = {
        "K1": ((pooling._token_pool_launch, mri, pet),
               lambda *a: pooling.fused_token_pool(*a)),
        "K4": ((lambda *a: pool3d._affine_act_pool_launch(
                    *a, 0.01, "max", False, False), y, s, b),
               lambda *a: pool3d.max_pool3d_2x2_affine_act_bc(*a))}
    out = {}
    for name, ((launch, *args), op) in calls.items():
        grads = [a.detach().clone().requires_grad_(a.is_floating_point())
                 for a in args]
        for mode, xs in (("serving", args), ("train", grads)):
            with (torch.inference_mode() if mode == "serving"
                  else contextlib.nullcontext()):
                turns = [_host_us(lambda: _Wrapper.apply(launch, *xs)),
                         _host_us(lambda: op(*xs)),
                         _host_us(lambda: op(*xs)),
                         _host_us(lambda: _Wrapper.apply(launch, *xs))]
            out[name, mode] = turns
    text = "; ".join(f"{k} {mode} {(t[0] + t[3]) / 2:.1f} -> "
                     f"{(t[1] + t[2]) / 2:.1f} (turns "
                     f"{', '.join(f'{x:.1f}' for x in t)})"
                     for (k, mode), t in out.items())
    print(f"[ops] host us a call, old wrapper -> registered op (old, op, "
          f"op, old): {text}; on {card}", flush=True)
    return out


def opcheck_card(card):
    """Phase 18 (a): `torch.library.opcheck` of every op on CUDA tensors
    at the small odd shapes of tests/test_torch_library_ops.py (K4 / K7 in
    two of their four (mode, lanes)), float32 and bfloat16 (schema, fake
    implementation against the kernel's output, autograd registration,
    aot_autograd with dynamic shapes); then the ops' host cost
    (`_op_host_us`). Its launches are checks: the counts
    are reset after it. The test file is loaded by its path: `tests` is a
    namespace package, which another installed `tests` would shadow."""
    import importlib.util

    from transmf_ad_tpu_torch.ops import reset_launch_counts

    spec = importlib.util.spec_from_file_location(
        "_op_cases", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "tests", "test_torch_library_ops.py"))
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)

    t0 = time.perf_counter()
    done = []
    for dtype in (torch.float32, torch.bfloat16):
        for op, args in cases._cases(torch.Generator().manual_seed(1),
                                     dtype, "cuda", OPCHECK_POOLS):
            torch.library.opcheck(op, args)
            done.append(op._opname)
    torch.cuda.synchronize()
    print(f"[ops] opcheck passed on the card: {len(done)} cases of "
          f"{len(set(done))} ops in 2 dtypes, {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    _op_host_us(card)
    reset_launch_counts()


def _artifact_model(name):
    """Full-width `name` with phase 4's seeded weights and BatchNorm
    statistics."""
    from transmf_ad_tpu_torch.models import build_model
    from transmf_ad_tpu_torch.utils.weights import init_weights

    g = torch.Generator().manual_seed(0)
    model = build_model(name)
    init_weights(model, g)
    randomize_bn(model, g)
    return model


def _artifact_inputs(batch, volume, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((batch, *volume), dtype=np.float32)
                 for _ in range(2))


def _served(fn, vols, repeats=ARTIFACT_REPEATS):
    """`repeats` calls of fn(*vols): (the last probabilities on the CPU,
    the median ms of the calls after the first, the launches and variants
    of the last call)."""
    times = []
    for _ in range(repeats):
        reset_counts()
        t0 = time.perf_counter()
        probs = fn(*vols)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return (probs.float().cpu(), float(np.median(times[1:])), _launches(),
            _require_variants("served", {}))


def _child_load(task, rank):
    """The child of phase 18 (b) and (c): it imports the serving module and
    the ops alone, loads each artifact twice (timed) and serves its
    batches."""
    from transmf_ad_tpu_torch.serving import load_inference

    torch.zeros(1, device="cuda")  # the card's context: not the loads'
    out = []
    for art in task["artifacts"]:
        # twice: the process's first load also imports the deserialiser
        loads = []
        for _ in range(2):
            t0 = time.perf_counter()
            fn = load_inference(art["path"])
            loads.append(time.perf_counter() - t0)
        out.append({"load_s": loads, "served": {
            b: _served(fn, _artifact_inputs(b, art["volume"], b))
            for b in art["batches"]}})
    imported = sorted(m for m in sys.modules if m.startswith(
        ("transmf_ad_tpu_torch.models", "transmf_ad_tpu_torch.nn")))
    torch.save({"artifacts": out, "imported": imported},
               os.path.join(task["dir"], "load.pt"))


def _child_shard(task, rank):
    """A rank of phase 18 (d): once the parent's go-ahead file exists (the
    card is then the ranks' alone), `make_sharded_inference_fn` of
    full-width ModelAd in float32 over the Gloo group serves the global
    batch SHARD_BATCH (timed), then a global batch of 3, which must
    raise."""
    from transmf_ad_tpu_torch.models import build_model
    from transmf_ad_tpu_torch.parallel import (init_distributed, shutdown,
                                               world_group)
    from transmf_ad_tpu_torch.serving import make_sharded_inference_fn

    init_distributed(f"localhost:{task['port']}", task["world"], rank,
                     backend="gloo", device="cuda")
    try:
        _wait_for_file(task["go"], SHARD_TIMEOUT)
        model = build_model("ad")
        model.load_state_dict(torch.load(task["weights"], weights_only=True))
        fn = make_sharded_inference_fn(model, world_group(), "cuda",
                                       torch.float32)
        vols = _artifact_inputs(SHARD_BATCH, VOLUME, 1)
        probs, ms, launches, _ = _served(fn, vols)
        try:
            fn(*(v[:3] for v in vols))
            ragged = None
        except ValueError as e:
            ragged = str(e)
        torch.save({"probs": probs, "ms": ms, "launches": launches,
                    "ragged": ragged},
                   os.path.join(task["dir"], f"shard_r{rank}.pt"))
    finally:
        shutdown()


def _hold_served(tag, got, want):
    """The loaded program's request against `make_inference_fn`'s: the
    probabilities bit for bit or, where the card differs, within one bf16
    ulp (the largest difference printed); every kernel's launches and
    variants equal."""
    (p, ms, launches, variants), (q, ms_live, live, live_variants) = got, want
    diff = float((p - q).abs().max())
    if diff and not _agree(p, q, _elem(BF16_RTOL, 0.0)):
        raise AssertionError(f"{tag}: probabilities off by {diff}")
    if launches != live or variants != live_variants:
        raise AssertionError(f"{tag}: launches {launches} {variants}, "
                             f"make_inference_fn {live} {live_variants}")
    same = "bit for bit" if not diff else f"largest difference {diff}"
    return (f"{tag}: {same}, {ms:.2f} ms/request (make_inference_fn "
            f"{ms_live:.2f}), launches "
            f"{ {k: v for k, v in launches.items() if v} }")


def _profile_check(card, tmp):
    """Phase 18 (e): one short `Trainer.fit` of full-width ModelAd (phase
    14's synthetic tree and fold-0 trainer, bf16, augmentation on) with the
    profiler window over the whole second epoch, its validation included:
    a Chrome trace in `profile_dir` that holds the port's kernels by their
    `__global__` names beside cuDNN's, and the window's top device items.
    Returns the run's launches."""
    from transmf_ad_tpu_torch.data import (ADNI, VolumeSource,
                                           make_synthetic_adni)

    root = os.path.join(tmp, "adni")
    make_synthetic_adni(root, n_per_group=KFOLD_PER_CLASS, shape=VOLUME,
                        groups=("CN", "AD"), seed=1,
                        workers=os.cpu_count() or 1)
    source = VolumeSource(ADNI(root, task="ADCN").data_dict,
                          dtype=torch.bfloat16)
    out = os.path.join(tmp, "trace")
    trainer, (train, val) = _fold0_trainer(source, os.path.join(tmp, "run"),
                                           2 * KFOLD_PER_CLASS)
    k = len(train)  # iterations an epoch
    trainer.cfg.epochs = PROFILE_EPOCHS
    trainer.cfg.profile_dir, trainer.cfg.profile_steps = out, (k + 1,
                                                              2 * k + 1)
    reset_counts()
    trainer.fit(train, val)
    launches = _launches()
    _require_variants("profiled fit", FAST)
    _require_launches("profiled fit", launches, (),
                      {"augment": PROFILE_EPOCHS * k})
    (path,) = glob.glob(os.path.join(out, "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = sorted({e["name"] for e in events
                     if e.get("name", "").startswith("iteration ")})
    by_name = {}
    for e in events:
        if e.get("cat") == "kernel":
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    kernels = _kernel_names()
    ours = {n for n in by_name
            if any(re.search(rf"\b{kn}\b", n) for kn in kernels)}
    cudnn = {n for n in by_name if n not in ours and re.search(
        r"cudnn|xmma|implicit|conv|cutlass", n, re.I)}
    want = [f"iteration {i}" for i in range(k + 1, 2 * k + 1)]
    if ranges != sorted(want) or not ours or not cudnn:
        raise AssertionError(f"profiled fit: ranges {ranges} (want {want}), "
                             f"{len(ours)} port kernels, {len(cudnn)} "
                             f"cuDNN kernels in {path}")
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(f"[profile] Trainer.fit, full-width ModelAd bf16, batch {BATCH}, "
          f"{k} iterations an epoch, window over epoch 2 (iterations "
          f"{k + 1}-{2 * k} and its validation): {os.path.basename(path)} "
          f"{os.path.getsize(path) / 2**20:.1f} MiB, {len(by_name)} kernel "
          f"names, {total / 1e3:.3f} device ms, port kernels "
          f"{sum(by_name[n] for n in ours) / 1e3:.3f} ms ({len(ours)} "
          f"names), cuDNN-like {sum(by_name[n] for n in cudnn) / 1e3:.3f} "
          f"ms; on {card}", flush=True)
    for name, us in top:
        tag = "port" if name in ours else "cudnn" if name in cudnn else "torch"
        print(f"[profile]   {us / 1e3:9.3f} ms {100 * us / total:5.1f}% "
              f"[{tag}] {name[:110]}", flush=True)
    return launches


def artifact_check(card):
    """Phase 18: the kernels as ops on the card, the serving artifact,
    sharded serving and the Trainer's profiler window (see the module's
    docstring). Returns the launch counts of its runs."""
    from transmf_ad_tpu_torch.serving import (export_inference,
                                              make_inference_fn)

    laps = [("start", time.perf_counter())]
    opcheck_card(card)
    laps.append(("opcheck", time.perf_counter()))
    runs, lines = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        # (d)'s ranks start first and wait for the go-ahead: their start-up
        # overlaps the exports, their work comes after the timed requests
        model = _artifact_model("ad")
        weights = os.path.join(tmp, "ad.pt")
        torch.save(model.state_dict(), weights)
        shard_task = os.path.join(tmp, "shard.json")
        go = os.path.join(tmp, "go")
        with open(shard_task, "w") as f:
            json.dump({"kind": "shard", "world": SHARD_WORLD,
                       "port": _free_port(), "weights": weights, "go": go,
                       "dir": tmp}, f)
        ranks = [_spawn(["--dp-child", shard_task, str(r)],
                        os.path.join(tmp, f"shard_r{r}.log"))
                 for r in range(SHARD_WORLD)]
        try:
            arts, live = [], []
            for name, volume, batches in (
                    ("ad", VOLUME, ARTIFACT_BATCHES),
                    ("transformer_res", FULL_VOLUME, RES_ARTIFACT_BATCHES)):
                m = model if name == "ad" else _artifact_model(name)
                path = os.path.join(tmp, f"{name}.pt2")
                t0 = time.perf_counter()
                export_inference(m, ("MRI", "PET"), path, volume)
                export_s = time.perf_counter() - t0
                fn = make_inference_fn(m, "cuda")
                live.append({b: _served(fn, _artifact_inputs(b, volume, b))
                             for b in batches})
                arts.append({"path": path, "volume": volume,
                             "batches": batches, "export_s": export_s})
                del fn
                torch.cuda.empty_cache()
            load_task = os.path.join(tmp, "load.json")
            with open(load_task, "w") as f:
                json.dump({"kind": "load", "artifacts": arts, "dir": tmp}, f)
            _wait_all([_spawn(["--dp-child", load_task, "0"],
                              os.path.join(tmp, "load.log"))], SHARD_TIMEOUT)
            laps.append(("export and load", time.perf_counter()))
            loaded = torch.load(os.path.join(tmp, "load.pt"),
                                weights_only=False)
            if loaded["imported"]:
                raise AssertionError(f"the loading child imported "
                                     f"{loaded['imported']}")
            for art, got, want in zip(arts, loaded["artifacts"], live):
                name = os.path.basename(art["path"])
                for b in art["batches"]:
                    lines.append(_hold_served(f"{name} batch {b}",
                                              got["served"][b], want[b]))
                    runs[f"artifact {name} batch {b}"] = got["served"][b][2]
                first, again = got["load_s"]
                print(f"[artifact] {name} at {art['volume']}: export "
                      f"{art['export_s']:.1f} s, load {first:.1f} s (again "
                      f"{again:.1f} s; a child importing serving and ops "
                      f"alone); "
                      + "; ".join(lines[-len(art["batches"]):])
                      + f"; on {card}", flush=True)
            # (d): one process in float32 on the same pairs, then the ranks
            fn = make_inference_fn(model, "cuda", torch.float32)
            one, one_ms, _, _ = _served(
                fn, _artifact_inputs(SHARD_BATCH, VOLUME, 1))
            del fn
            torch.cuda.empty_cache()
            with open(go, "w"):
                pass
            _wait_all(ranks, SHARD_TIMEOUT)
        finally:
            for p in ranks:
                if p.poll() is None:
                    p.kill()
        shards = [torch.load(os.path.join(tmp, f"shard_r{r}.pt"),
                             weights_only=False) for r in range(SHARD_WORLD)]
        share = _share(shards[0]["probs"], one, _sums(1e-4))
        if not _agree(shards[0]["probs"], one, _sums(1e-4)) or any(
                not torch.equal(s["probs"], shards[0]["probs"])
                or "does not split" not in (s["ragged"] or "")
                for s in shards):
            raise AssertionError(
                f"sharded serving: ranks {[s['probs'] for s in shards]}, "
                f"one process {one}, ragged {[s['ragged'] for s in shards]}")
        for r, s in enumerate(shards):
            runs[f"sharded serving rank {r}"] = s["launches"]
        print(f"[sharded] make_sharded_inference_fn, full-width ModelAd f32, "
              f"global batch {SHARD_BATCH} at {VOLUME} on {SHARD_WORLD} Gloo "
              f"ranks sharing the card: ranks bit-identical, against one "
              f"process {float((shards[0]['probs'] - one).abs().max()):.3g} "
              f"({share:.3f} of the 1e-4 rule); "
              f"{[round(s['ms'], 2) for s in shards]} ms/request against "
              f"{one_ms:.2f} for one process; a batch of 3 raises "
              f"ValueError on every rank; on {card}", flush=True)
        laps.append(("sharded serving", time.perf_counter()))
        del model
        torch.cuda.empty_cache()
        runs["profiled fit"] = _profile_check(card, tmp)
        laps.append(("profiled fit", time.perf_counter()))
    spent = ", ".join(f"{name} {t - t_before:.1f}" for (_, t_before), (name, t)
                      in zip(laps, laps[1:]))
    print(f"[phase 18] seconds {laps[-1][1] - laps[0][1]:.1f} ({spent}) on "
          f"{card}", flush=True)
    return runs


# ----- phase 19: the model axis -----

@contextlib.contextmanager
def _launch_sizes():
    """{kernel name: the distinct size arguments of its launches} while the
    context is open: the integers of each launch's arguments that are not
    pointers (batch, spatial sizes, channels or heads, then flags and
    variant codes), in the launch's order."""
    from transmf_ad_tpu_torch import _build

    seen, launch = {}, _build.Kernel.launch

    def spy(self, device, *args, variant=None):
        sizes = tuple(a for a in args if type(a) is int and 0 <= a < 1 << 24)
        seen.setdefault(self.name, set()).add(sizes)
        return launch(self, device, *args, variant=variant)

    _build.Kernel.launch = spy
    try:
        yield seen
    finally:
        _build.Kernel.launch = launch


def _mp_sharded(model):
    """{name: whole shape} of a model's sharded parameters."""
    from transmf_ad_tpu_torch.parallel import shard_of

    out = {}
    for n, p in model.named_parameters():
        s = shard_of(p)
        if s is not None:
            shape = list(p.shape)
            shape[s.dim] = s.full
            out[n] = tuple(shape)
    return out


def _mp_batches(batch, n):
    """`n` batches of `batch` [0, 1) volume pairs at FULL_VOLUME, made on
    the card from one seed (the same on every rank and in one process),
    labels alternating."""
    dg = torch.Generator(device="cuda").manual_seed(19)
    return [{"MRI": torch.rand(batch, *FULL_VOLUME, generator=dg,
                               device="cuda"),
             "PET": torch.rand(batch, *FULL_VOLUME, generator=dg,
                               device="cuda"),
             "label": torch.arange(batch, device="cuda") % 2}
            for _ in range(n)]


def _mp_bf16_steps(model, group=None, mesh=None, held=None):
    """MP_STEPS bf16 Adam (1e-4) steps of `model` at batch MP_BATCH, placed
    on `mesh` when given: (ms of each step, peak GiB, launches, variants).
    `held`: first one step at batch MP_CHECK_BATCH under
    `held_in_model(held)` (the plain versions of K7 and K8 at batch 6 take
    more memory than two ranks leave), not timed or counted."""
    from transmf_ad_tpu_torch.parallel import shard_state
    from transmf_ad_tpu_torch.train import create_state, make_train_step

    state = create_state(model, "cuda", "auto", seed=0, name="Adam",
                         lr=1e-4)
    shard_state(state, group, mesh)
    step = make_train_step(group=group)
    if held is not None:
        reset_counts()
        with held_in_model(held):
            step(state, _mp_batches(MP_CHECK_BATCH, 1)[0])
            torch.cuda.synchronize()
        _require_variants("model axis bf16, held", FAST)
    batches = _mp_batches(MP_BATCH, MP_STEPS)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    for batch in batches:
        t0 = time.perf_counter()
        aux = step(state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        if not math.isfinite(float(aux["loss"])):
            raise AssertionError(f"model axis bf16: loss {aux['loss']}")
    return (times, torch.cuda.max_memory_allocated() / 2**30, _launches(),
            _require_variants("model axis bf16", FAST))


def _mp_child(task, rank):
    """A rank of phase 19: once the parent's go-ahead file exists (the card
    is then the ranks' alone), (a) the float32 step, (b) the bfloat16
    steps, (c) the transformer_res request, on the data-1 x model-2 mesh
    of the two ranks."""
    from transmf_ad_tpu_torch.models import build_model
    from transmf_ad_tpu_torch.parallel import (full_state_dict,
                                               init_distributed, make_mesh,
                                               shard_of, shard_state,
                                               shutdown, world_group)
    from transmf_ad_tpu_torch.serving import make_sharded_inference_fn
    from transmf_ad_tpu_torch.train import create_state, make_train_step

    init_distributed(f"localhost:{task['port']}", task["world"], rank,
                     backend="gloo", device="cuda")
    try:
        mesh = make_mesh({"data": 1, "model": task["world"]})
        _wait_for_file(task["go"], MP_TIMEOUT)
        out = {}
        # (a)
        model = build_model("ad", head_dropout=0.0)
        model.load_state_dict(torch.load(task["weights"], weights_only=True))
        before = _snapshot(model)
        state = create_state(model, "cuda", torch.float32, name="SGD",
                             lr=1.0, milestones=())
        shard_state(state, mesh.data_group, mesh)
        out["sharded"] = _mp_sharded(model)
        batch = torch.load(task["batch"], weights_only=True)
        step = make_train_step(group=mesh.data_group)
        reset_counts()
        with _launch_sizes() as sizes:
            aux = step(state, batch)
            torch.cuda.synchronize()
        out["f32"] = {"launches": _launches(), "sizes": sizes}
        got = {k: aux[k].float().cpu() for k in ("loss", "ce_loss",
                                                 "ad_loss")}
        whole = full_state_dict(model)
        for k, v in whole.items():
            v = v.detach().float().cpu()
            got[k if "running" in k else k + " update"] = (
                v if "running" in k else v - before[k])
        out["f32"]["step"] = got
        # this rank's rows of each sharded weight, bit for bit those of the
        # whole that the check holds
        out["f32"]["not_rows"] = [
            n for n, p in model.named_parameters() if shard_of(p) is not None
            and not torch.equal(p.detach(), shard_of(p).rows(whole[n]))]
        del model, state, aux
        torch.cuda.empty_cache()
        # (b)
        model = build_model("ad")
        model.load_state_dict(torch.load(task["weights"], weights_only=True))
        held = {}
        times, peak, launches, variants = _mp_bf16_steps(
            model, mesh.data_group, mesh, held)
        out["bf16"] = {"ms": times, "peak": peak, "launches": launches,
                       "variants": variants, "held": held}
        del model
        torch.cuda.empty_cache()
        # (c)
        model = build_model("transformer_res")
        model.load_state_dict(torch.load(task["res_weights"],
                                         weights_only=True))
        fn = make_sharded_inference_fn(model, world_group(), "cuda",
                                       torch.float32,
                                       model_axis=task["world"])
        vols = _artifact_inputs(MP_BATCH, FULL_VOLUME, 19)
        with _launch_sizes() as sizes:
            probs, ms, launches, _ = _served(fn, vols, MP_REQUESTS)
        out["res"] = {"probs": probs, "ms": ms, "launches": launches,
                      "sizes": sizes}
        torch.save(out, os.path.join(task["dir"], f"mp_r{rank}.pt"))
    finally:
        shutdown()


def model_axis_check(card):
    """Phase 19: the tensor-parallel model axis (see the module's
    docstring). Returns the ranks' launch counts."""
    from transmf_ad_tpu_torch.models import build_model
    from transmf_ad_tpu_torch.serving import make_inference_fn
    from transmf_ad_tpu_torch.utils.weights import init_weights

    laps = [("start", time.perf_counter())]
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        g = torch.Generator().manual_seed(19)
        model = build_model("ad", head_dropout=0.0)
        init_weights(model, g)
        randomize_bn(model, g)
        weights = os.path.join(tmp, "ad.pt")
        torch.save(model.state_dict(), weights)
        res_model = _artifact_model("transformer_res")
        res_weights = os.path.join(tmp, "res.pt")
        torch.save(res_model.state_dict(), res_weights)
        rng = np.random.default_rng(19)
        batch = {k: torch.from_numpy(rng.random((MP_CHECK_BATCH,
                                                 *FULL_VOLUME),
                                                dtype=np.float32))
                 for k in ("MRI", "PET")}
        batch["label"] = torch.arange(MP_CHECK_BATCH) % 2
        torch.save(batch, os.path.join(tmp, "batch.pt"))
        task = os.path.join(tmp, "mp.json")
        go = os.path.join(tmp, "go")
        with open(task, "w") as f:
            json.dump({"kind": "model_axis", "world": MP_WORLD,
                       "port": _free_port(), "weights": weights,
                       "res_weights": res_weights, "batch":
                       os.path.join(tmp, "batch.pt"), "go": go, "dir": tmp},
                      f)
        procs = [_spawn(["--dp-child", task, str(r)],
                        os.path.join(tmp, f"mp_r{r}.log"))
                 for r in range(MP_WORLD)]
        try:  # one process while the ranks start, the card to itself
            ref = sgd_step(copy.deepcopy(model), "cuda", batch)
            perturbed = [sgd_step(copy.deepcopy(model), "cuda",
                                  perturb(batch, d))
                         for d in range(CHECK_DRAWS)]
            laps.append(("one process f32", time.perf_counter()))
            bf16_model = build_model("ad")
            bf16_model.load_state_dict(model.state_dict())
            one_ms, one_peak, _, _ = _mp_bf16_steps(bf16_model)
            del bf16_model
            torch.cuda.empty_cache()
            laps.append(("one process bf16", time.perf_counter()))
            vols = _artifact_inputs(MP_BATCH, FULL_VOLUME, 19)
            one_probs, one_req_ms, _, _ = _served(
                make_inference_fn(res_model, "cuda", torch.float32), vols,
                MP_REQUESTS)
            del res_model
            torch.cuda.empty_cache()
            laps.append(("one process request", time.perf_counter()))
            open(go, "w").close()
            _wait_all(procs, MP_TIMEOUT)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        laps.append(("ranks", time.perf_counter()))
        ranks = [torch.load(os.path.join(tmp, f"mp_r{r}.pt"),
                            weights_only=False) for r in range(MP_WORLD)]
    a = ranks[0]["f32"]["step"]
    diff = [k for r in ranks[1:] for k in a
            if not torch.equal(r["f32"]["step"][k], a[k])]
    if diff:
        raise AssertionError(f"model axis: the ranks' states differ in "
                             f"{diff}")
    rows = compare_steps(a, ref, perturbed)
    sharded = ranks[0]["sharded"]
    for r, res in enumerate(ranks):
        if res["f32"]["not_rows"]:
            raise AssertionError(f"model axis: rank {r}'s rows of "
                                 f"{res['f32']['not_rows']} are not its "
                                 "rows of the whole")
    convs = [n for n in sharded if ".conv" in n]
    if not convs or any(".conv1.0." in n for n in sharded) \
            or not any("to_kv" in n for n in sharded):
        raise AssertionError(f"model axis: sharded {sorted(sharded)}")
    for r, res in enumerate(ranks):
        want = ("band_conv", "band_dw", "affine_act_pool",
                "affine_act_pool_bwd", "attention_fwd", "stem_conv_stats",
                "stem_dw", "token_pool")
        _require_launches(f"model axis rank {r} f32", res["f32"]["launches"],
                          want, {"attention_fwd": ATTENTION_CALLS,
                                 "augment": 0})
        _require_launches(f"model axis rank {r} bf16",
                          res["bf16"]["launches"], want,
                          {"attention_fwd": ATTENTION_CALLS * MP_STEPS,
                           "augment": 0})
        _require_launches(f"model axis rank {r} request",
                          res["res"]["launches"], ("flash_fwd",),
                          {"flash_fwd": ATTENTION_CALLS, "attention_fwd": 0})
        # K2 / K10's sizes start (batch x heads, queries, keys, head dim)
        heads = {s[0] // MP_BATCH for s in res["res"]["sizes"]["flash_fwd"]}
        heads |= {s[0] // MP_CHECK_BATCH
                  for s in res["f32"]["sizes"]["attention_fwd"]}
        if heads != {4 // MP_WORLD}:
            raise AssertionError(
            f"model axis: K10 launched on "
            f"{res['res']['sizes']['flash_fwd']}, K2 on "
            f"{res['f32']['sizes']['attention_fwd']}")
        share = _share(res["res"]["probs"], one_probs, _sums(1e-4))
        if not _agree(res["res"]["probs"], one_probs, _sums(1e-4)):
            raise AssertionError(
                f"model axis: rank {r}'s transformer_res probabilities "
                f"{res['res']['probs']} against one process {one_probs}")
        for part in ("f32", "bf16", "res"):
            runs[f"model axis {part} rank {r}"] = res[part]["launches"]
    sizes = ranks[0]["f32"]["sizes"]
    print(f"[model axis, step] full-width ModelAd f32, global batch "
          f"{MP_CHECK_BATCH} x {FULL_VOLUME}, data 1 x model {MP_WORLD} "
          f"(Gloo, one card), {len(sharded)} weights sharded "
          f"({sum(math.prod(s) for s in sharded.values())} of "
          f"{sum(p.numel() for p in model.parameters())} parameters): "
          f"loss {float(a['loss']):.6f} vs one process "
          f"{float(ref['loss']):.6f}; all {len(rows)} tensors within the "
          f"train-check rule, closest "
          f"{[(n, round(t, 3)) for t, _, n in rows[:3]]}; the ranks' whole "
          f"states bit-identical, each rank's rows of every sharded weight "
          f"its rows of the whole", flush=True)
    print(f"[model axis, step] launch sizes on rank 0 (the integer "
          f"arguments: batch, sizes, channels or heads, flags, codes): "
          + "; ".join(f"{k} {sorted(sizes[k])}" for k in
                      ("band_conv", "band_dw", "affine_act_pool",
                       "affine_act_pool_bwd", "attention_fwd")
                      if k in sizes), flush=True)
    for r, res in enumerate(ranks):
        b = res["bf16"]
        print(f"[model axis, bf16] rank {r}: batch {MP_BATCH} x "
              f"{FULL_VOLUME}, Adam 1e-4, head dropout 0.5: step ms "
              f"{[round(t, 2) for t in b['ms']]} (median after the first "
              f"{float(np.median(b['ms'][1:])):.2f}), peak "
              f"{b['peak']:.2f} GiB; one process on the same batches "
              f"{[round(t, 2) for t in one_ms]} (median after the first "
              f"{float(np.median(one_ms[1:])):.2f}), peak {one_peak:.2f} "
              f"GiB; variants {b['variants']}; the first step's calls "
              f"held against their plain versions (calls, worst share of "
              f"the tolerance) "
              f"{ {k: (c, round(w, 3)) for k, (c, w) in b['held'].items()} }"
              f" on {card}", flush=True)
    print(f"[model axis, request] transformer_res f32, batch {MP_BATCH} x "
          f"{FULL_VOLUME}, make_sharded_inference_fn(model_axis="
          f"{MP_WORLD}): against make_inference_fn "
          f"{float((ranks[0]['res']['probs'] - one_probs).abs().max()):.3g}"
          f" ({share:.3f} of the 1e-4 rule); K10 sizes "
          f"{sorted(ranks[0]['res']['sizes']['flash_fwd'])}; "
          f"{[round(x['res']['ms'], 2) for x in ranks]} ms/request against "
          f"{one_req_ms:.2f} for one process on {card}", flush=True)
    spent = ", ".join(f"{n} {t - tb:.1f}" for (_, tb), (n, t)
                      in zip(laps, laps[1:]))
    print(f"[phase 19] seconds {laps[-1][1] - laps[0][1]:.1f} ({spent}) on "
          f"{card}", flush=True)
    return runs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", nargs="+", default=(), metavar="KERNEL",
                        help="phases 1-3 for these kernels alone; prints no "
                        "result lines")
    parser.add_argument("--dp-child", nargs=2, metavar=("TASK", "RANK"),
                        help=argparse.SUPPRESS)  # a child of phase 17-19
    args = parser.parse_args(argv)
    if args.dp_child:
        return dp_child(args.dp_child[0], int(args.dp_child[1]))
    only = args.only
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from transmf_ad_tpu_torch import _build
    from transmf_ad_tpu_torch.ops import reset_launch_counts

    laps = [("start", time.perf_counter())]

    def lap(name):
        laps.append((name, time.perf_counter()))

    lib = _build.build()
    _build.library()
    lap("build")
    print(f"[build] {lib.name} in {laps[-1][1] - laps[0][1]:.1f} s",
          flush=True)
    for line in lib.with_suffix(".log").read_text().splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill")):
            print(f"[build] {line.split(':', 1)[-1].strip()}", flush=True)

    results: dict = {}
    times = check_kernels(results, only)
    reset_launch_counts()  # phase 3 launched "column" on purpose
    lap("kernel checks")
    if only:
        print(f"chip_smoke: --only {' '.join(only)}: phases 4-18 not run, "
              "no result", flush=True)
        return 0
    side = {f"{name} at {keys} keys": round(times[name, label], 4)
            for (name, keys), label in CROSSOVER.items()}
    print(f"[kernel] K2 (attention_fwd) and K10 (flash_fwd) side by side, "
          f"{FLASH_SHAPE[2]} queries, bfloat16, ms: {side}; attention_core "
          f"switches above 2,048 keys", flush=True)
    model, reference, serving = serve(card)
    cross_check(model, reference)
    del model, reference
    torch.cuda.empty_cache()
    lap("serving + check")
    trained = train(card)
    lap("train")
    train_check()
    train_check(band_min_voxels=0)
    lap("train checks")
    model, reference, full_serving = serve(
        card, "serving, full resolution", FULL_BATCH, FULL_VOLUME,
        FULL_WARMUP, FULL_REQUESTS, FULL_SERVING_KERNELS)
    del model
    torch.cuda.empty_cache()
    band_cross_check(reference)
    del reference
    lap("full-resolution serving + check")
    full_trained = train(card, "train, full resolution", FULL_BATCH,
                         FULL_VOLUME, FULL_TRAIN_WARMUP, FULL_TRAIN_STEPS,
                         FULL_TRAIN_KERNELS)
    lap("full-resolution train")
    no_k2 = {"attention_fwd": 0}
    tag = "serving, full resolution, transformer_res"
    model, reference, res_serving = serve(
        card, tag, FULL_BATCH, FULL_VOLUME, FULL_WARMUP, FULL_REQUESTS,
        RES_SERVING_KERNELS, "transformer_res",
        {"flash_fwd": ATTENTION_CALLS, **no_k2})
    del model
    torch.cuda.empty_cache()
    flash_cross_check(reference)
    del reference
    lap("transformer_res serving + check")
    res_trained = train(
        card, "train, full resolution, transformer_res", FULL_BATCH,
        FULL_VOLUME, FULL_TRAIN_WARMUP, FULL_TRAIN_STEPS, RES_TRAIN_KERNELS,
        "transformer_res",
        {n: ATTENTION_CALLS for n in ("flash_fwd", "flash_dq", "flash_dkv")}
        | no_k2)
    lap("transformer_res train")
    train_check("transformer_res", RES_CHECK_VOLUME)
    lap("transformer_res train check")
    swin_trained = swin_train(card)
    lap("swin_unetr train")
    bf16_check()
    bf16_check(band_min_voxels=0)
    bf16_check("transformer_res", RES_CHECK_VOLUME)
    lap("bf16 checks")
    learned = learning_check(card)
    reset_counts()
    lap("learning check")
    kfold, kfold_cnn = kfold_check(card)
    reset_counts()
    lap("k-fold")
    zoo = zoo_check(card)
    lap("zoo")
    remat = remat_check(card)
    reset_counts()
    lap("remat")
    data_parallel = dp_check(card)
    reset_counts()
    lap("data parallel")
    artifact = artifact_check(card)
    reset_counts()
    lap("ops, artifact, sharded serving, profiler")
    model_axis = model_axis_check(card)
    reset_counts()
    lap("model axis")
    runs = {"serving": serving, "train": trained,
            "serving, full resolution": full_serving,
            "train, full resolution": full_trained,
            tag: res_serving,
            "train, full resolution, transformer_res": res_trained,
            SWIN_TAG: swin_trained,
            "learning check": learned, "k-fold CLI": kfold,
            "k-fold CLI, CNN": kfold_cnn, **zoo, "remat": remat,
            **data_parallel, **artifact, **model_axis}
    print(f"[launches] {runs}", flush=True)
    spent = ", ".join(f"{name} {t - t_before:.1f}" for (_, t_before), (name, t)
                      in zip(laps, laps[1:]))
    print(f"[time] seconds: {spent}; all {laps[-1][1] - laps[0][1]:.1f}",
          flush=True)

    kernels = [{"name": k.name, "route": "cuda", "source": k.source,
                "replaces": k.replaces,
                "launches": sum(run[k.name] for run in runs.values()),
                **results[k.name]} for k in _kernels()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
