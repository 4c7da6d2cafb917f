#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py

Phases (one line each; any failure raises and exits non-zero):

1. card: name and power limit from nvidia-smi; build every CUDA kernel from
   the sources in ``group_attribution_for_diffusion_models_tpu_torch/csrc``.
2. kernels: each kernel against its plain PyTorch version on the card, at
   the CIFAR shapes and a few others (the attention kernels at every head dim
   the registry reaches, each row repeated bit for bit), in float32 and
   bfloat16, with kernel, plain and library times (SDPA and F.group_norm +
   F.silu, forward and autograd backward, the attention rows also by the
   profiler's device time; for the JL projection, torch.matmul by a
   materialised R at a D where R fits, as a yardstick), and each bound at the
   rate of the kernel's route beside the f32 FMA bound. The GroupNorm rows
   are repeated bit for bit and timed by the profiler's device time too.
   census: every GroupNorm shape of a CIFAR U-Net pass at batch 64, forward
   and backward kernels held against their plain versions, repeated bit for
   bit and timed by device time, with the launch-weighted totals per U-Net
   forward and backward beside their bytes bounds, in float32 and bfloat16.
3. forward: the full-width CIFAR UNet2D (random weights from a seed) on the
   card against the same model on the CPU, batch 4, float32.
   prune-gn: the seeded full-width CIFAR U-Net pruned by magnitude at ratios
   0.3 and 0.5 (hidden widths 96/192 and 64/128: 3, 6, 2 and 4 channels a
   group); every GroupNorm shape of a pruned U-Net pass at batch 64, the
   census's checks and device times at the shapes it has not timed yet, with
   per-pass totals; the ratio-0.3 pruned U-Net on the card against the CPU,
   batch 4, float32.
4. train-step: one `make_train_step` of that model on the card against the
   CPU from the same weights, images, timesteps and noise (batch 8, float32,
   TF32 off): loss, gradient norm and gradients; and two card runs of the
   step agree bit for bit.
   ensemble: the stacked ensemble at full width. 8 CIFAR members at batch
   64, each with a seeded gamma/beta of its own in every GroupNorm: one
   stacked step (`training.train.make_members_step`: one vmapped forward and
   backward, one launch a kernel site for every member) against the same 8
   member-steps one at a time from the same states and draws (losses,
   clipped gradients, weights), seconds a step, peaks and the convolutions'
   device time of both; ``run_scanned(6, chunk=3)`` against ``run(6)`` bit
   for bit under common noise, where two members on one subset end
   bit-identical. 2 miniSD LoRA members at batch 64 in one
   `train_text_to_image_lora.members_step` against each member alone, the
   same checks. ``cli.main --scan_chunk`` on the CIFAR stand-in beside its
   per-step loop.
5. main path, sampling: a seeded random-init full-width CIFAR checkpoint
   sampled through ``cli.generate_samples.main`` (2 batches of 64 images x
   100 DDIM steps; the second batch's time is the warm one).
6. reference: 5 DDIM steps of the same model on the card against the CPU
   from the same initial noise.
7. main path, training: ``cli.train_ensemble.main`` on a seeded stand-in for
   the CIFAR-10 training set (50,000 uint8 images in the
   ``cifar-10-batches-py`` layout), full-width CIFAR, 8 shapley members at
   batch 64, stacked (one launch a kernel site a step for all of them), with
   eval loss and 16 DDIM samples each: 2 steps to warm up, then 6 steps
   timed.
8. trak-step: the full-width CIFAR per-sample gradients (batch 2, one
   timestep, injected noise) through the vmap rules on the card against the
   CPU, and against a per-example autograd loop on the card.
9. main path, TRAK: ``cli.grad_features.main`` on the full-width CIFAR
   checkpoint and the stand-in (train source, 2 batches of 32 x 10
   timesteps, projected to 4096; generated samples; the probe and
   attention-only modes; Journey TRAK), then ``cli.traks.main`` on the
   store.
10. main path, the estimation loop: ``cli.shapley_pipeline.main`` on the
    stand-in at full width (by class, 6 shapley fit and 6 datamodel test
    subsets, 3 steps, at the default ``--chunk_size`` and batch, with the
    peak, eval-loss behavior, two anchors: arm A, retrain), ``cli.prune.main``
    (Taylor importance, 10 timesteps, ratio 0.5) on arm A's full anchor, then
    the pipeline again on the same DB with
    ``--method prune_fine_tune --load <pruned> --fit_training_steps 2``
    (arm B, sparse fine-tuning, its test rows reused). Launch counts per
    arm, attributions of shape (10,), the efficiency constraint, the fit
    game's anchors and a shared y_test are asserted.
11. scores: the full FID InceptionV3 (seeded random init) on 8 seeded 32x32
    images resized to 299, card against CPU (f32, TF32 off), then timed at
    batch 256 (event and device time, images/s, peak memory) beside its
    bound from the layer shapes; the same for VGG16Features at 224. Then
    the main path of the sample behaviors: ``cli.shapley_pipeline.main
    --behavior fid_value`` at full width on the stand-in (by class, 2
    shapley fit and 2 datamodel test subsets, the fewest its fit stage takes,
    10 steps at batch 64, the two anchors, 256 DDIM samples of 10 steps a
    member scored in the loop: 6 FIDs, each a 2048-d host sqrtm), its
    seconds split into training, sampling, tower and FID math, launches,
    every member's FID and the efficiency constraint asserted; then
    ``cli.calculate_global_scores.main`` on the full anchor's checkpoint
    (the same 256 samples: FID and IS equal to the anchor's row; precision
    and recall on VGG16 features). scipy's sqrtm is memoised by its input's
    bytes for the phase, so the global check takes the anchor's root when its
    features and stats are the anchor's, and roots anew when they are not.
12. ldm: the latent-diffusion workload at full CelebA width (the 274M U-Net,
    the full VQ-VAE, the full BLIP tower, seeded random inits) on a seeded
    CelebA-HQ stand-in (128 smooth 256x256 PNGs, labels.csv of 8 integer
    celebrity ids): the attention kernels at the U-Net's three head-dim-32
    shapes and every GroupNorm of a U-Net pass (batch 32) and of a VQ-VAE
    encode and decode (batch 8, the streaming class) against their plain
    versions, repeated bit for bit, timed beside their bounds, library and
    plain times; the plain f32 route of the VQ's D=512 mid attention timed.
    Then ``cli.train_vqvae.main`` (3 steps at batch 8),
    ``cli.shapley_pipeline.main --dataset celeba --vqvae_weights`` (by
    celebrity, 3 fit and 2 test subsets, 3 steps at batch 32, the two
    anchors; one encode of the stand-in, then its cache), ``cli.
    generate_samples.main`` (16 images x 25 DDIM steps decoded to 256x256
    PNGs, all distinct), a card-vs-CPU reference at batch 1 (3 DDIM steps and
    the decode, encode -> quantize of a stand-in image, codes agreeing at
    99% or more), and ``cli.calculate_global_scores_diversity.main`` (32
    samples, 128 reference images, 8 clusters, the full random BLIP tower),
    each with its launches and plain-route calls reckoned from the spec;
    and one member trained with and without ``--remat --remat_policy convs``
    (the JAX package's CelebA option): the same weights bit for bit, the
    recompute's launches, the peak memory of each.

13. tti: the text-to-image tier at full miniSD width (the 860M conditional
    U-Net, the CLIP ViT-L/14 text tower, the KL VAE, rank-256 LoRA on every
    attention projection, seeded random towers; f32, TF32 off) on an
    ArtBench-style stand-in in Imagenette's layout (256 smooth 256x256 PNGs
    named <artist>_<title>_<year>.png, 16 artists): the attention kernels at
    miniSD's self- and cross-attention shapes (Skv = 77; head dims 40, 80 and
    160) forward and backward at batch 64, every GroupNorm of a U-Net pass
    (batch 64), of a KL encode (batch 64) and decode (batch 8) against their
    plain versions, repeated bit for bit, timed beside their bounds, library
    and plain times; the plain route at the KL mid attention timed. Then
    ``cli.train_text_to_image_lora.main`` (2 datamodel members stacked x 3
    steps at batch 64, the base frozen: no GroupNorm gamma/beta reduction; the
    latents encoded once and cached with a tag), ``cli.prune_lora.main``
    (ratio 0.5), a 3-step ``--method pruned_ft`` of the pruned LoRA on 2
    shapley subsets (the latents' cache reused),
    ``cli.generate_samples_tti.main`` (16 images x 25 DDIM steps, and a
    second call that resumes with nothing to do), each with its launches and
    plain-route calls reckoned from the specs; and a card-vs-CPU reference
    at batch 1 of 3 DDIM steps of the LoRA'd base with a CLIP context, the
    text tower on 2 prompts, the KL encode and decode, and the per-sample
    LoRA gradients of 2 samples with their own contexts at one timestep
    (vmap(grad), one launch of each kernel); the cross-attention of each
    level under vmap(grad) at batch 16 with a 77-token context for each
    sample, against the plain versions and timed. The CLIP ViT-L/14 vision tower
    and the aesthetic head card vs CPU at batch 2, the tower timed at batch
    32 beside its FLOP bound. Then the scoring loop: 4 shapley members and
    the full anchor trained (3 steps at batch 64; the 4 members stacked in
    slices of 32, ``--microbatch``, to fit the card), a null anchor (the LoRA's
    up factors zeroed); every member's mask as the LDS CLIs redraw it
    against the trainer's kept_units; ``cli.compute_model_behaviors.main``
    timed once (16 paired samples x 25 DDIM steps, the KL decode, the CLIP
    tower, 3 loss draws), then on each of the 8 members and both anchors (2
    samples x 5 steps), and once more, skipped by the duplicate guard;
    ``cli.shapley_lds.main`` with the measured anchors (the efficiency
    constraint on the saved attributions) and ``cli.shapley_convergence.
    main`` (the sparse fine-tunes against the retrained members);
    ``cli.grad_features_tti.main`` (LoRA-only per-sample gradients under a
    context per sample: the train source on 32 images in batches of 16 x 10
    timesteps, timed with its gradients/JL split, then every image at one
    timestep; generated, 16 samples x 10 steps; generated_journey), the
    latents read from the trainer's tagged cache, ``cli.traks.main``;
    ``cli.similarity_baselines.main`` pixel, clip and aesthetic on the
    stand-in and the 16 generated images; ``cli.baseline_lds.main`` over
    the TRAK and similarity attributions.
14. unlearn: the per-subset single-model jobs at full width. A WoodFisher
    k_vec of the full CIFAR U-Net (2 batches of 2, injected draws) card
    against CPU. ``cli.main`` on the CIFAR stand-in: retrain on the full set
    (20 steps at batch 64), the same command again (it resumes and trains
    nothing), retrain and prune_fine_tune (from [pipeline]'s Taylor-pruned
    model) on shapley seeds 0..2 by class, ga from the full model.
    ``cli.unlearn`` from the full model on shapley seed 1: gd, ga and lora
    (rank 16, the base frozen: no GroupNorm gamma/beta reduction, and the
    merge moves only attention projections) with local behaviors (16 paired
    samples x 20 DDIM steps), gd with the global ones (64 samples, FID, IS
    and P&R of the random Inception tower); iu and ``cli.shapley_groundtruth``
    (7 enumerated subsets x 5 steps, the efficiency constraint on the exact
    values) on a 1,500-image 3-class CIFAR stand-in; ``cli.attribute``
    shapley and datamodel and ``cli.empirical_verification`` on the rows
    written; CelebA's ``cli.main`` (3 steps at batch 32) and iu in VQ
    latents on [ldm]'s weights and latents cache. Each call's seconds split
    into training or unlearning, sampling and scoring, iu's into its two
    average gradients and the recursion, peaks and launches.
15. local: per-example attribution and local behaviors on both unconditional
    workloads. The JL kernel at the CelebA U-Net's gradient width at batch 8
    (8 x 274,056,163, past 2^31 elements) against its plain version on the
    last 2^24 coordinates of every row, where the last row's offsets pass
    2^31, and timed at the full shape beside its bound; the CelebA U-Net's
    attention (three head-dim-32 levels) and GroupNorms (four widths, a
    gamma/beta gradient per sample) under vmap(grad) at batch 8 against the
    plain versions, one launch each, timed beside plain and library times.
    Then ``cli.grad_features.main`` in VQ latents on [ldm]'s full anchor and
    tagged latents cache at batch 8: the train source (2 batches x 5
    timesteps -> 4096), generated (8 samples x 20 DDIM steps, raw latents),
    probe and attn_full (a batch each), generated_journey (5 steps), and
    ``cli.traks.main`` on the store; ``cli.sketch_quality.main`` on CIFAR
    ([unlearn]'s full model, 64 train and 32 generated images, probes at k
    16 and 64, 2 timesteps, LDS on [pipeline]'s datamodel rows);
    ``cli.calculate_local_scores.main`` and ``cli.calculate_local_loss.main``
    on CIFAR and on CelebA (decoded by the VQ decoder), [unlearn]'s full
    model against its shapley seed 1 model, 8 samples x 20 DDIM steps on
    CIFAR and x 10 on CelebA.
16. data: workload 1's other datasets from seeded stand-ins in their real
    layouts (a 50,000-image ``cifar-100-python`` pickle, 60,000-image MNIST
    idx files, the CIFAR-10 stand-in): ``create_dataset`` of cifar2,
    cifar100, cifar100_f and mnist with shapes, label counts and seconds; the
    full ResNet-18 regroup tower (torchvision's init from a seed) card vs CPU
    on 8 images resized to 224 and timed at batch 256 beside its FLOP bound;
    cifar100_new regrouped from it (10,000 animal images embedded on the
    card, k-means into 40 groups on the host, the cache written); the MNIST
    U-Net's attention (D = 256 at 8x8; its D = 512 mid block takes the plain
    route) and every GroupNorm of its pass against the plain versions, then
    ``cli.main`` retrain on mnist (5 steps at batch 64) and
    ``cli.generate_samples.main`` (16 x 20 DDIM steps, 32x32 gray PNGs).

Each main path runs with the kernels' launch counters reset just before and
read just after, and asserts the counts the code implies; the plain
attention route's calls are counted apart and taken only by the VAEs' mid
attention ([ldm], [tti]). The last two lines
are the kernels' JSON record and ``{"ok": true, "device": {...}}``. Without
CUDA it exits non-zero and prints no result.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and FLOP/s of
# float32 outside the tensor cores and of bf16 on them (dense).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# The attention kernels run on the tensor cores: bf16 at 989 TFLOP/s, f32 as
# three TF32 products (495 TFLOP/s) for each f32 one.
TC_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
# The JL projection runs on them in bf16: an f32 G as three bf16 pieces.
JL_FLOPS = {"float32": 989e12 / 3, "bfloat16": 989e12}
# (atol, rtol) of kernel against plain version; see tests/test_torch_kernels_cuda.py.
TOL = {"float32": (5e-5, 1e-5), "bfloat16": (1e-2, 2**-7)}
# dgamma/dbeta: f32 sums over B*HW terms in another order, |d| <= atol + rtol max|ref|.
SUM_TOL = (5e-5, 1e-5)
CIFAR_FWD_ATOL = 5e-4  # 22 resnets of f32 convs summed in other orders
SAMPLE_ATOL = 2e-3  # images in [0, 1] after 5 DDIM steps of that forward
# Train step, card vs CPU: f32 convolutions (TF32 off) summed in other orders
# through the forward and the backward. Relative error of the loss and of the
# global gradient norm, and max |g_card - g_cpu| / max |g_cpu|. A cut graph
# or a wrong backward kernel is off by O(1).
TRAIN_STEP_RTOL = 1e-3
TRAIN_STEP_BATCH = 8
# 6 steps: the stacked f32 step takes 1.7x the member loop's, and [ensemble]
# needs the time.
TRAIN_MEMBERS, TRAIN_STEPS, TRAIN_WARM_STEPS, TRAIN_BATCH = 8, 6, 2, 64
# train_ensemble caps the batch at the smallest subset (as the JAX CLI does).
# Shapley seeds 22..29 keep 65 to 49,999 of the 50,000 images, so the
# members train at batch 64; seed 7, for one, keeps 3.
TRAIN_SEED_START = 22
TRAIN_SAMPLES, TRAIN_SAMPLE_STEPS = 16, 20
CIFAR_TRAIN_IMAGES = 50_000  # the CIFAR-10 training set's size, 5 batches
# JL projection, kernel vs plain: f32 sums of D terms in other orders (the
# kernel's chunks of D, the plain version's tiles), held per row to
# |dY[b, p]| <= JL_RTOL * sum_d |G[b, d]| / sqrt(P). Expected error of a
# sequential f32 sum of D terms is about 2^-24 * sqrt(D) of that scale.
JL_RTOL = 1e-6
JL_SHAPES = [  # (B, D, P), each held against the plain version
    (3, 70_001, 1000),       # ragged D and P
    (32, 1 << 20, 4096),     # aligned
    (32, 393_216, 4096),     # TRAK probe mode (k = 64), one batch
    (32, 1_579_008, 4096),   # TRAK attn_full mode, one batch
    (32, 35_746_307, 4096),  # TRAK full mode: the CIFAR U-Net's gradients, one batch
    (16, 51_019_776, 4096),  # grad_features_tti: miniSD's rank-256 LoRA gradients, one batch
]
JL_MAIN = JL_SHAPES[-1]
JL_BF16_SHAPES = [(32, 1 << 20, 4096)]  # bf16 G (one bf16 piece), held as the f32 rows
JL_IDENTITY_MAX_D = 1 << 20  # identity rows (a 64 x D eye) only up to this D
JL_PLAIN_TILE_D = 16_384  # the plain version's d-tile on the card (any tile gives the same R)
JL_LIBRARY_D = 262_144  # a D where R (D, P) f32 fits for the torch.matmul yardstick
# TRAK per-sample gradients: card vs CPU as the train step (TRAIN_STEP_RTOL);
# the vmap path vs a per-example loop on the card, the same f32 ops on other
# batch shapes.
TRAK_LOOP_RTOL = 1e-4
TRAK_BATCH, TRAK_EXAMPLES, TRAK_TIMESTEPS, TRAK_PROJ = 32, 64, 10, 4096
TRAK_SAMPLES, TRAK_SAMPLE_STEPS, TRAK_JOURNEY_SAMPLES = 32, 10, 4
ATTN_SHAPES = [  # (B, Sq, Skv, H, D)
    (64, 256, 256, 1, 256),  # CIFAR down_1 / up_2 at 16x16, sampling batch 64
    (64, 16, 16, 1, 256),    # CIFAR mid block at 4x4
    (8, 1024, 1024, 14, 32),  # celeba level 1
    (2, 130, 77, 2, 40),     # ragged queries and keys, ragged head dim
]
ATTN_BWD_EXTRA = [  # the registry's other head dims: forward and backward held and repeated
    (4, 256, 256, 4, 40),    # miniSD / imagenette, 8 heads at 40
    (4, 64, 77, 8, 80),      # cross-attention on 77 text tokens at 80
    (4, 64, 64, 2, 160),     # 160, a D that is not a multiple of 16 per half
    (8, 64, 64, 2, 16),      # the tiny configs' mid block
    (4, 256, 256, 2, 64),    # _big
]
# Products the backward kernels form, in units of B*H*Sq*Skv*D x 2 FLOPs: the
# dQ pass S, P.V (the forward again), S, dP, dS.K; the dK/dV pass S, dP, dV, dK.
BWD_UNITS = 18
GN_SHAPES = [(64, 128, 32, 32), (64, 256, 4, 4)]  # CIFAR levels 0 and 3, G=32
# Every GroupNorm of a CIFAR U-Net forward, G=32, as (C, H, W, silu, launches):
# 51 launches (22 resnets x 2, 6 attention pre-norms without SiLU,
# conv_norm_out); a backward runs each once.
GN_CENSUS = [
    (128, 32, 32, True, 8), (256, 16, 16, True, 6), (256, 16, 16, False, 5),
    (256, 4, 4, True, 11), (256, 4, 4, False, 1), (256, 8, 8, True, 7),
    (512, 4, 4, True, 3), (512, 8, 8, True, 3), (512, 16, 16, True, 2),
    (256, 32, 32, True, 2), (128, 16, 16, True, 1), (384, 16, 16, True, 1),
    (384, 32, 32, True, 1),
]
GN_CENSUS_BATCH = 64
PRUNE_RATIOS = (0.3, 0.5)  # magnitude pruning of the seeded CIFAR U-Net in [prune-gn]
# [pipeline]: shapley_pipeline at full width on the stand-in, by class, at its
# default --chunk_size and CIFAR's default batch (128). 6 fit subsets, 3 and 2
# steps, for [ensemble]'s time.
PIPE_FIT, PIPE_TEST, PIPE_STEPS, PIPE_FT_STEPS = 6, 6, 3, 2
PIPE_TEST_SEED = 42  # datamodel seeds 42..47 keep 5 of the stand-in's 10 classes each
PIPE_TAYLOR_STRIDE, PIPE_PRUNE_RATIO = 100, 0.5  # 10 Taylor timesteps: 999, 899, ..., 99
# Efficiency constraint of the closed form: |sum(attrs) - (v1 - v0)| <= this * max(1, |v1 - v0|).
EFFICIENCY_RTOL = 1e-6
# [scores]: the towers card vs CPU, |d| <= TOWER_TOL * max(1, max |CPU|) (about 95 f32
# layers summed in other orders; tests/test_inception_numeric.py's tolerance).
TOWER_TOL, TOWER_CHECK_IMAGES, TOWER_BATCH = 2e-3, 8, 256
# shapley_pipeline --behavior fid_value at full width: shapley seeds 0..1 keep 1-9
# classes, datamodel seeds 42..43 keep 5; every member scored on its own samples.
# Each FID is a 2048-d host sqrtm of 13-21 s: two fit and two test subsets (the
# fewest the fit stage takes) and the two anchors are 6. The global-scores check
# re-scores the full anchor's samples, the same sqrtm input when the port is right:
# each distinct input is rooted once (a memo by the matrix's bytes), so the check
# adds no seventh root unless its features or stats differ.
SCORE_FIT, SCORE_TEST, SCORE_STEPS, SCORE_BATCH = 2, 2, 10, 64
SCORE_SAMPLES, SCORE_SAMPLE_STEPS, SCORE_SEED = 256, 10, 42
# calculate_global_scores --seed SCORE_SEED on the anchor's checkpoint draws the
# anchor's own samples (train_ensemble's default --opt_seed, which the pipeline
# keeps; the same batch and EMA weights), so its FID is the anchor row's up to
# the host's float64 BLAS.
SCORE_FID_RTOL = 1e-6
# [ensemble]: the stacked step against the member loop on the card, f32, TF32
# off: the same f32 ops on other batch shapes (functorch runs a vmapped
# convolution as a grouped one) through a forward and a backward. Losses and
# gradient norms within ENS_RTOL relative, the clipped gradients max |d| <=
# ENS_RTOL max |g| over all tensors; per tensor the change of the weights
# within ENS_MOVE_RTOL of its L2 norm (the CPU tests' rule: Adam turns float
# noise of a gradient element near zero into a visible share of lr).
ENS_MEMBERS, ENS_BATCH, ENS_TIMED, ENS_RTOL, ENS_MOVE_RTOL = 8, 64, 2, 1e-4, 1e-2
ENS_SCAN_STEPS, ENS_SCAN_CHUNK = 6, 3  # run_scanned(6, chunk=3) against run(6)
ENS_TTI_MEMBERS = 2  # miniSD LoRA members stacked, at TTI_BATCH
ENS_MAIN_STEPS, ENS_MAIN_CHUNK = 10, 5  # cli.main --scan_chunk on CIFAR
STEPS, BATCH, N_BATCHES = 100, 64, 2
# [ldm]: the latent-diffusion workload at full CelebA width (get_config("celeba"):
# a 274,056,163-parameter U-Net on 64x64x3 latents of the full VQVAESpec) on a
# CelebA-HQ stand-in of LDM_IMAGES seeded smooth 256x256 PNGs, LDM_IMAGES /
# len(LDM_IDS) a celebrity id; 2 and 10 among the ids test the group codes'
# numeric sort.
LDM_IMAGES, LDM_IDS = 128, (2, 10, 3, 7, 11, 23, 40, 101)
LDM_VQ_STEPS, LDM_VQ_BATCH = 3, 8  # train_vqvae at the full VQVAESpec
# shapley_pipeline --dataset celeba by celebrity: shapley seeds 0..2 keep 5, 3 and 3
# of the 8 groups (48 or more images) and datamodel seeds 42, 43 keep 4, so every
# member trains at batch 32.
LDM_FIT, LDM_TEST, LDM_STEPS, LDM_BATCH = 3, 2, 3, 32
LDM_SAMPLES, LDM_SAMPLE_STEPS = 16, 25  # generate_samples, one batch
LDM_DIV_SAMPLES, LDM_DIV_STEPS, LDM_CLUSTERS = 32, 20, 8  # and 4 x 32 reference images
LDM_ATTN_SHAPES = [  # the CelebA U-Net's attention at training batch 32, head dim 32
    (32, 1024, 1024, 14, 32),  # 32x32 latents
    (32, 256, 256, 21, 32),    # 16x16
    (32, 64, 64, 28, 32),      # 8x8
]
# The VQ-VAE's mid attention, one head of 512 at 64x64 (the plain route): at
# train_vqvae's batch and at the encode's.
VQ_ATTN_SHAPES = [(LDM_VQ_BATCH, 4096, 1, 512), (32, 4096, 1, 512)]
# Card vs CPU at batch 1, f32, TF32 off: 3 DDIM steps of the full-width U-Net
# (30 resnets and 16 attention layers summed in other orders; CIFAR's 22
# resnets hold 5e-4 after one forward) on latents of order 1; the VQ decoder
# on images in [0, 1], as SAMPLE_ATOL; the encoder's latents as the U-Net's
# forward. Codes of the same latents: at least LDM_CODE_AGREEMENT of the 4096
# positions agree (a latent within rounding of two codes may part).
LDM_LATENT_ATOL, LDM_DECODE_ATOL, LDM_ENCODE_ATOL = 2e-3, 2e-3, 1e-3
LDM_CODE_AGREEMENT, LDM_REF_STEPS = 0.99, 3
# The text-to-image tier at full miniSD width on an ArtBench-style stand-in:
# TTI_ARTISTS x TTI_PER_ARTIST smooth 256x256 PNGs; datamodel seeds 0 and 1
# (alpha 0.5) keep 8 of the 16 artists, 128 images, so members train at 64.
TTI_ARTISTS, TTI_PER_ARTIST = 16, 16
TTI_MEMBERS, TTI_STEPS, TTI_BATCH, TTI_RANK = 2, 3, 64, 256
TTI_ENCODE_BATCH = 64  # precompute_latents' batch
TTI_SAMPLES, TTI_SAMPLE_STEPS = 16, 25  # generate_samples_tti, one batch
TTI_PRUNE_RATIO = 0.5
TTI_ATTN_SHAPES = [  # miniSD's attention at training batch 64, 8 heads: self, then cross
    (64, 1024, 1024, 8, 40), (64, 1024, 77, 8, 40),    # 32x32 latents, width 320
    (64, 256, 256, 8, 80), (64, 256, 77, 8, 80),       # 16x16, width 640
    (64, 64, 64, 8, 160), (64, 64, 77, 8, 160),        # 8x8, width 1280
    (64, 16, 16, 8, 160), (64, 16, 77, 8, 160),        # the 4x4 mid block
]
KL_ATTN_SHAPES = [(TTI_ENCODE_BATCH, 1024, 1, 512)]  # the KL encoder's mid attention
KL_DECODE_BATCH = 8  # the KL decoder's GroupNorms, held at this batch
# Card vs CPU at batch 1, f32, TF32 off: 3 DDIM steps of the LoRA'd miniSD
# U-Net (25 resnets and 16 transformers, as the CelebA U-Net's 2e-3 after 3
# steps); the CLIP tower's last hidden state (12 layers of products and
# LayerNorms of width 768, values of order 1); the KL encoder's scaled
# latents and the decoder's images in [0, 1], as the VQ-VAE's.
TTI_LATENT_ATOL, TTI_TEXT_ATOL, TTI_ENCODE_ATOL, TTI_DECODE_ATOL = 2e-3, 1e-4, 1e-3, 2e-3
TTI_REF_STEPS = 3
# Scoring the tier (cut to size: sample counts and steps, never widths). Shapley
# seeds 0..3 keep 9, 6, 6 and 9 of the 16 artists (96 images or more), so those
# members train at batch 64 too; the sparse fine-tunes take shapley seeds 0 and 1.
TTI_SHAPLEY, TTI_FT_MEMBERS = 4, 2
# The 4 stacked shapley members' --microbatch: each slice's forward holds what
# 2 members at batch 64 hold.
TTI_SHAPLEY_MICROBATCH = 32
# compute_model_behaviors: one timed call (reference LoRA against a subset LoRA),
# then a smaller call for every member and each anchor.
TTI_SCORE_SAMPLES, TTI_SCORE_STEPS, TTI_SCORE_NOISES = 16, 25, 3
TTI_MEMBER_SAMPLES, TTI_MEMBER_STEPS, TTI_MEMBER_NOISES = 2, 5, 1
# grad_features_tti: the train source timed on the first TTI_TRAK_EXAMPLES images
# (2 artists: the stand-in is in name order), then on every image at one timestep,
# so that traks' attributions cover the 16 artists for baseline_lds.
TTI_TRAK_EXAMPLES, TTI_TRAK_BATCH, TTI_TRAK_TIMESTEPS, TTI_TRAK_PROJ = 32, 16, 10, 4096
TTI_TRAK_SAMPLES, TTI_TRAK_SAMPLE_STEPS = 16, 10
# Per-sample LoRA gradients, card vs CPU (2 samples, each with its own context,
# one timestep): TRAIN_STEP_RTOL of each sample's largest entry. The CLIP vision
# tower (ViT-L/14, 24 layers of width 1024), card vs CPU at batch 2: TOWER_TOL
# of max(1, max |CPU|); the aesthetic head on the same embeddings within 1e-5.
TTI_CLIP_CHECK, TTI_CLIP_BATCH, TTI_HEAD_ATOL = 2, 32, 1e-5
# The cross-attentions as grad_features_tti runs them: vmap(grad) over a batch of
# TTI_TRAK_BATCH samples, each with its own 77-token context, (Sq, H, D).
TTI_VMAP_ATTN = [(1024, 8, 40), (256, 8, 80), (64, 8, 160), (16, 8, 160)]
# [unlearn]: the single-model jobs at full width. cli.main on the CIFAR stand-in:
# retrain the full set UNL_STEPS steps at batch 64 (then the same command, which
# resumes); retrain and prune_fine_tune (from [pipeline]'s pruned model) on shapley
# seeds UNL_SEEDS by class, UNL_SEED_STEPS steps each, for the readers; ga from the
# full model on seed 1. cli.unlearn on shapley seed 1 (4 of 10 classes kept): gd,
# ga and lora UNL_UNLEARN_STEPS steps, local behaviors of UNL_LOCAL samples x steps,
# gd also global (UNL_GLOBAL); iu, and shapley_groundtruth (7 subsets), on a
# UNL_SMALL_IMAGES-image stand-in of UNL_SMALL_CLASSES classes (cut to size: iu's
# average gradients run over every image of both sets). CelebA: cli.main 3 steps
# at batch 32 on shapley seed 1 (3 of 8 celebrities, 48 images), iu on it.
UNL_SEEDS, UNL_STEPS, UNL_SEED_STEPS, UNL_BATCH = (0, 1, 2), 20, 5, 64
UNL_UNLEARN_STEPS, UNL_LORA_RANK, UNL_UNLEARN_SEED = 10, 16, 1
UNL_LOCAL, UNL_GLOBAL = (16, 20), (64, 20)  # (n_samples, DDIM steps)
UNL_SMALL_IMAGES, UNL_SMALL_CLASSES, UNL_WF_BATCHES, UNL_GT_STEPS = 1500, 3, 16, 5
UNL_LDM_STEPS, UNL_LDM_BATCH = 3, 32
# [local]: per-example attribution and local behaviors on both unconditional
# workloads. grad_features on [ldm]'s CelebA full anchor and tagged latents cache at
# LOC_BATCH (the train source LOC_TRAIN examples x LOC_TIMESTEPS timesteps; generated
# LOC_BATCH samples x LOC_GEN_STEPS DDIM steps; the journey over LOC_JOURNEY_STEPS;
# probe and attn_full one batch each), then traks. B5 at LOC_JL (the CelebA U-Net's
# 274,056,163 gradient coordinates at batch 8): B*D passes 2^31, so int32 offsets
# would wrap in the last row; the kernel is held against the plain version on a
# window of the last LOC_JL_WINDOW coordinates of every row (the rest zero: each
# output row is a sum over its row's coordinates), where the last row's offsets
# b*D + d all pass 2^31.
LOC_BATCH, LOC_TRAIN, LOC_TIMESTEPS, LOC_PROJ = 8, 16, 5, 4096
LOC_GEN_STEPS, LOC_JOURNEY_STEPS = 20, 5
LOC_JL = (8, 274_056_163, 4096)
LOC_JL_WINDOW = 1 << 24
# The CelebA U-Net's attention and GroupNorms under vmap(grad) at LOC_BATCH, one
# sample each: (Sq, H, D) of each level, (C, H, W) of each resnet width.
LOC_VMAP_ATTN = [(1024, 14, 32), (256, 21, 32), (64, 28, 32)]
LOC_VMAP_GN = [(224, 64, 64), (448, 32, 32), (672, 16, 16), (896, 8, 8)]
# sketch_quality on CIFAR (full, attn_full, a probe at each k), then the local
# behaviors on CIFAR and CelebA: LOC_LOCAL samples x LOC_LOCAL_STEPS[dataset] DDIM
# steps, LOC_NOISES loss draws. CelebA takes 10 steps: each step of its local loss
# decodes both models' x0-hat through the VQ decoder.
LOC_SKETCH = dict(max_examples=64, n_gen=32, ks=(16, 64), timesteps=2, steps=20, proj=512)
LOC_LOCAL, LOC_NOISES = 8, 4
LOC_LOCAL_STEPS = {"cifar": 20, "celeba": 10}
# An attention-only backward (TRAK's probe and attn_full modes) skips the 7
# GroupNorms before the first attention block's projections, in the CelebA U-Net
# as in CIFAR's (unet_counts).
LOC_GN_SKIPPED = 7
# [data]: the datasets of workload 1 from seeded stand-ins in their real layouts
# (CIFAR-100's python pickle, MNIST's idx files, the CIFAR-10 stand-in for cifar2),
# the ResNet-18 regroup tower (torchvision's init from a seed) card vs CPU on
# DATA_RESNET_CHECK images and timed at DATA_RESNET_BATCH, cifar100_new regrouped
# from it, and the MNIST U-Net: B1-B4 at its shapes, cli.main 5 steps at batch 64,
# generate_samples 16 x 20 steps.
CIFAR100_TRAIN_IMAGES, MNIST_TRAIN_IMAGES = 50_000, 60_000
DATA_RESNET_CHECK, DATA_RESNET_BATCH = 8, 256
DATA_MNIST_STEPS, DATA_MNIST_BATCH, DATA_MNIST_SAMPLES, DATA_MNIST_SAMPLE_STEPS = 5, 64, 16, 20
MNIST_ATTN_SHAPES = [(64, 64, 64, 1, 256)]  # the 8x8 attention, one head of 256, batch 64
# WoodFisher card vs CPU at CIFAR width: k_vec from 4 images (2 batches of 2) and
# injected draws; the change k - v within WF_RTOL of the CPU's in L2 norm (two
# gradients of 35.7M entries, each TRAIN_STEP_RTOL-close, through two dot products).
WF_RTOL, WF_BATCH, WF_BATCHES = 1e-3, 2, 2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(torch, fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 10, names: list | None = None) -> float:
    """Device time of fn's kernels per call, from torch.profiler: an event-timed
    loop of a call whose host side outlasts its kernels reads the host. The
    names of the kernels that ran are appended to `names` if given. A trace
    that recorded no device activity (the profiler drops one now and then, and
    in one call dropped three in a row) is taken again, up to three times in
    all; then the call is timed with CUDA events instead, and the log says so."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if getattr(e, "self_device_time_total", 0) > 0]
        if events:
            break
    else:
        log("device_ms: torch.profiler recorded no device time in three traces; "
            "this time is event-timed")
        return cuda_ms(torch, fn, iters)
    if names is not None:
        names += [e.key for e in events]
    return sum(e.self_device_time_total for e in events) / 1e3 / iters


def compare(got, want, dtype: str):
    """(max abs error, within tolerance) of a kernel output against its
    plain version: |got - want| <= atol + rtol |want| everywhere."""
    atol, rtol = TOL[dtype]
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    return diff.max().item(), ok


def compare_sum(got, want):
    """(max abs error, within SUM_TOL) for a reduction over many terms."""
    atol, rtol = SUM_TOL
    err = (got.float() - want.float()).abs().max().item()
    return err, err <= atol + rtol * want.float().abs().max().item()


def gn_bwd(ops, *args):
    """(dx, dgamma, dbeta) from the GroupNorm backward kernel's wrapper, which
    returns dx and the (2, B, C) partials; an older tree's wrapper, timed by
    `scripts/gn_census.py --tree`, returns the three."""
    out = ops.group_norm_bwd_kernel(*args)
    return (out[0], *out[1]) if len(out) == 2 else tuple(out)


def bound(nbytes: float, flops: float, dtype: str, rates=PEAK_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rates[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def write_cifar_standin(root: str, n: int, seed: int = 0, classes: int = 10) -> None:
    """A seeded stand-in for CIFAR-10's python layout: <root>/cifar-10-batches-py/
    data_batch_1..5, each a pickled {"data": (n/5, 3072) uint8, "labels": list} of
    labels below `classes`."""
    import numpy as np

    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    rng = np.random.default_rng(seed)
    per = n // 5
    for i in range(1, 6):
        entry = {"data": rng.integers(0, 256, (per, 3072), dtype=np.uint8),
                 "labels": rng.integers(0, classes, per).tolist()}
        with open(os.path.join(base, f"data_batch_{i}"), "wb") as f:
            pickle.dump(entry, f)


def write_cifar100_standin(root: str, n: int = CIFAR100_TRAIN_IMAGES, seed: int = 1) -> None:
    """A seeded stand-in for CIFAR-100's python layout: <root>/cifar-100-python/train,
    a pickled {"data": (n, 3072) uint8, "fine_labels", "coarse_labels"}, n / 100
    images of each fine class in a shuffled order."""
    import numpy as np

    base = os.path.join(root, "cifar-100-python")
    os.makedirs(base)
    rng = np.random.default_rng(seed)
    fine = rng.permutation(np.repeat(np.arange(100), n // 100))
    entry = {"data": rng.integers(0, 256, (len(fine), 3072), dtype=np.uint8),
             "fine_labels": fine.tolist(), "coarse_labels": (fine // 5).tolist()}
    with open(os.path.join(base, "train"), "wb") as f:
        pickle.dump(entry, f)


def write_mnist_standin(root: str, n: int = MNIST_TRAIN_IMAGES, seed: int = 2) -> None:
    """A seeded stand-in for MNIST's idx files: <root>/MNIST/raw/train-images-idx3-ubyte
    (magic 2051, n x 28 x 28 uint8) and train-labels-idx1-ubyte (magic 2049)."""
    import struct

    import numpy as np

    base = os.path.join(root, "MNIST", "raw")
    os.makedirs(base)
    rng = np.random.default_rng(seed)
    with open(os.path.join(base, "train-images-idx3-ubyte"), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28))
        f.write(rng.integers(0, 256, (n, 28, 28), dtype=np.uint8).tobytes())
    with open(os.path.join(base, "train-labels-idx1-ubyte"), "wb") as f:
        f.write(struct.pack(">II", 2049, n))
        f.write(rng.integers(0, 10, n, dtype=np.uint8).tobytes())


def write_celeba_standin(root: str, n: int = LDM_IMAGES, ids=LDM_IDS, seed: int = 0) -> None:
    """A seeded stand-in for CelebA-HQ 256's layout: <root>/celeba_hq/train/ with
    `n` smooth 256x256 RGB PNGs (an 8x8 random image resized bilinearly) and a
    labels.csv of (filename, celeb), n / len(ids) images to each integer id."""
    import numpy as np
    from PIL import Image

    base = os.path.join(root, "celeba_hq", "train")
    os.makedirs(base)
    rng = np.random.default_rng(seed)
    celebs = rng.permutation(np.repeat(np.asarray(ids), n // len(ids)))
    lines = ["filename,celeb"]
    for i in range(n):
        small = Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
        small.resize((256, 256), Image.BILINEAR).save(os.path.join(base, f"{i:05d}.png"))
        lines.append(f"{i:05d}.png,{celebs[i]}")
    with open(os.path.join(base, "labels.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")


def write_artbench_standin(root: str, artists: int = TTI_ARTISTS,
                           per_artist: int = TTI_PER_ARTIST, seed: int = 0) -> None:
    """An ArtBench-style stand-in in Imagenette's layout: <root>/imagenette2/
    train/ with artists x per_artist smooth 256x256 RGB PNGs (an 8x8 random
    image resized bilinearly) named <artist>_<title>_<year>.png, the file
    names the text-to-image trainer takes its artists from."""
    import numpy as np
    from PIL import Image

    base = os.path.join(root, "imagenette2", "train")
    os.makedirs(base)
    rng = np.random.default_rng(seed)
    for a in range(artists):
        for j in range(per_artist):
            small = Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
            small.resize((256, 256), Image.BILINEAR).save(
                os.path.join(base, f"painter-{a:02d}_work-{j:02d}_{1880 + j}.png"))


def reset_counts(ops) -> None:
    for fn in ops.KERNELS.values():
        fn.launches = 0


def unet_counts(forwards: int, backwards: int, jl: int = 0, attention_only: int = 0) -> dict:
    """Launches of the CIFAR U-Net: 6 attention layers and 51 GroupNorms
    (22 resnets x 2, 6 attention pre-norms, conv_norm_out) per forward, and
    one backward launch of each per backward (two attention passes); a
    vmapped forward and backward counts once. `jl` JL projections.
    `attention_only` backwards take the gradient of the attention
    projections alone (TRAK's probe and attn_full modes): autograd then
    skips the 7 GroupNorms before the first attention block's projections
    (down block 0's two resnets, down block 1's first resnet and the
    attention's pre-norm)."""
    gn_bwd = 51 * backwards + 44 * attention_only
    return {"attention_fwd": 6 * forwards, "attention_bwd_dq": 6 * (backwards + attention_only),
            "attention_bwd_dkv": 6 * (backwards + attention_only),
            "group_norm_fwd": 51 * forwards, "group_norm_bwd": gn_bwd, "jl_projection": jl}


def check_attention(torch, F, ops, dev, timed_shapes=ATTN_SHAPES, held=ATTN_BWD_EXTRA,
                    label="kernels", dtypes=("float32", "bfloat16")):
    """The forward kernel against its plain version at `timed_shapes` (timed,
    with SDPA's time, event-timed and by the profiler) and `held` (held
    only), each row repeated bit for bit. The bound counts the two
    products at the tensor cores' rate for the kernel's route (TC_FLOPS);
    the f32 FMA bound of the SIMT kernel it replaced is printed beside it."""
    rows = {}
    for (b, sq, skv, h, d) in timed_shapes + held:
        timed = (b, sq, skv, h, d) in timed_shapes
        for dtype in (getattr(torch, n) for n in dtypes):
            name = str(dtype).split(".")[1]
            g = torch.Generator(device=dev).manual_seed(0)
            q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
                       for s in (sq, skv, skv))
            got = ops.attention_kernel(q, k, v)
            want = ops.attention_plain(q, k, v)
            torch.cuda.synchronize()
            err, ok = compare(got, want, name)
            same = torch.equal(got, ops.attention_kernel(q, k, v))
            head = (f"[{label}] attention B={b} Sq={sq} Skv={skv} H={h} D={d} {name}: "
                    f"max_abs_err={err:.3g} (tol {TOL[name]}), bitwise repeatable={same}")
            if not timed:
                log(head)
            else:
                ms = cuda_ms(torch, lambda: ops.attention_kernel(q, k, v))
                plain_ms = cuda_ms(torch, lambda: ops.attention_plain(q, k, v))
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
                kern_dev = device_ms(torch, lambda: ops.attention_kernel(q, k, v))
                sdpa_kernels = []
                lib_dev = device_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt),
                                    names=sdpa_kernels)
                nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
                flops = 4.0 * b * h * sq * skv * d
                bms, by = bound(nbytes, flops, name, TC_FLOPS)
                fma, fma_by = bound(nbytes, flops, name)
                log(f"{head}; kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                    f"library_ms={lib_ms:.4f} (SDPA) ratio_to_sdpa={ms / lib_ms:.3f}; device "
                    f"time (profiler) kernel={kern_dev:.4f} SDPA={lib_dev:.4f} "
                    f"ratio={kern_dev / lib_dev:.3f}; bound_ms={bms:.4f} ({by}, tensor cores) "
                    f"f32-FMA bound_ms={fma:.4f} ({fma_by}); SDPA's kernels: "
                    f"{', '.join(n[:80] for n in sdpa_kernels)}")
                rows[(b, sq, skv, h, d, name)] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=bms, bound_by=by, device_ms=kern_dev, library_device_ms=lib_dev,
                    fma_bound_ms=fma)
            if not (ok and same):
                raise AssertionError(f"attention kernel disagrees: {err}, tol {TOL[name]}, "
                                     f"repeatable={same}")
    return rows


def check_group_norm(torch, F, ops, dev):
    rows = {}
    for shape in GN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            for silu in (True, False):
                g = torch.Generator(device=dev).manual_seed(1)
                x = (torch.randn(shape, generator=g, device=dev) * 3 + 0.5).to(dtype)
                gamma = torch.randn(shape[1], generator=g, device=dev) + 1
                beta = torch.randn(shape[1], generator=g, device=dev)
                args = (x, gamma, beta, 32, 1e-6, silu, dtype)
                got = ops.group_norm_kernel(*args)
                want = ops.group_norm_silu_plain(*args)
                torch.cuda.synchronize()
                err, ok = compare(got[0], want[0], name)
                stats = [compare(a, w, "float32") for a, w in zip(got[1:], want[1:])]
                stat_err = max(e for e, _ in stats)
                stat_ok = all(o for _, o in stats)
                same = all(torch.equal(a, w) for a, w in zip(got, ops.group_norm_kernel(*args)))
                ms = cuda_ms(torch, lambda: ops.group_norm_kernel(*args))
                dev_ms = device_ms(torch, lambda: ops.group_norm_kernel(*args))
                plain_ms = cuda_ms(torch, lambda: ops.group_norm_silu_plain(*args))

                def library():
                    y = F.group_norm(x, 32, gamma.to(dtype), beta.to(dtype), 1e-6)
                    return F.silu(y) if silu else y

                lib_ms = cuda_ms(torch, library)
                n = x.numel()
                nbytes = 2 * n * x.element_size() + 2 * shape[1] * 4 + 2 * shape[0] * 32 * 4
                bms, by = bound(nbytes, n * (11.0 if silu else 7.0), "float32")
                log(f"[kernels] group_norm {tuple(shape)} G=32 silu={silu} {name}: "
                    f"max_abs_err={err:.3g} (tol {TOL[name]}) stats_err={stat_err:.3g}, "
                    f"bitwise repeatable={same}; kernel_ms={ms:.4f} device_ms={dev_ms:.4f} "
                    f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={bms:.4f} ({by})")
                if not (ok and stat_ok and same):
                    raise AssertionError(f"group norm kernel disagrees: {err}, {stat_err}, "
                                         f"repeatable={same}")
                rows[(shape, name, silu)] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=bms, bound_by=by, device_ms=dev_ms)
    return rows


def check_attention_bwd_once(torch, ops, q, k, v, do, name):
    """Both backward passes against their plain versions, and a second run
    of each bit for bit: (dq_cmp, dkv_cmp, same, (lse, delta))."""
    dq, lse, delta = ops.attention_bwd_dq(q, k, v, do)
    dk, dv = ops.attention_bwd_dkv(q, k, v, do, lse, delta)
    want_dq, want_lse, want_delta = ops.attention_bwd_dq_plain(q, k, v, do)
    want_dk, want_dv = ops.attention_bwd_dkv_plain(q, k, v, do, want_lse, want_delta)
    torch.cuda.synchronize()
    dq_cmp = [compare(dq, want_dq, name), compare(lse, want_lse, "float32"),
              compare(delta, want_delta, "float32")]
    dkv_cmp = [compare(dk, want_dk, name), compare(dv, want_dv, name)]
    dq2, lse2, delta2 = ops.attention_bwd_dq(q, k, v, do)
    same = (all(torch.equal(x, y) for x, y in zip((dq, lse, delta), (dq2, lse2, delta2)))
            and all(torch.equal(x, y) for x, y in zip(
                (dk, dv), ops.attention_bwd_dkv(q, k, v, do, lse, delta))))
    return dq_cmp, dkv_cmp, same, (lse, delta)


def check_attention_bwd(torch, F, ops, dev, timed_shapes=ATTN_SHAPES, held=ATTN_BWD_EXTRA,
                        label="kernels", dtypes=("float32", "bfloat16")):
    """Both backward passes against their plain versions, at `timed_shapes`
    (timed) and `held` (held and repeated only). Returns per-pass
    rows {(shape, dtype): {"dq": {...}, "dkv": {...}}}. The least work of the
    whole backward is 10*B*H*Sq*Skv*D FLOPs (S once, then P.V, dO.V^T, dS.K,
    dS^T.Q, P^T.dO); of the dQ pass alone 6 (S, dO.V^T, dS.K, with delta =
    rowsum(P * dP)), of the dK/dV pass alone 8. The JAX kernels' scheme does
    16, these kernels BWD_UNITS. The bound counts the least work at the tensor
    cores' rate for the kernels' route (TC_FLOPS)."""
    log(f"[{label}] attention_bwd least work 10*B*H*Sq*Skv*D FLOPs (the bound below, at "
        f"{TC_FLOPS['float32'] / 1e12:.0f} TFLOP/s in f32 (3 TF32 products at 495) and "
        f"{TC_FLOPS['bfloat16'] / 1e12:.0f} in bf16, on the tensor cores); the JAX kernels' "
        f"scheme does 16*B*H*Sq*Skv*D, these kernels {BWD_UNITS}")
    for (b, sq, skv, h, d) in held:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            g = torch.Generator(device=dev).manual_seed(3)
            q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
                           for s in (sq, skv, skv, sq))
            dq_cmp, dkv_cmp, same, _ = check_attention_bwd_once(torch, ops, q, k, v, do, name)
            err = max(e for e, _ in dq_cmp + dkv_cmp)
            log(f"[{label}] attention_bwd B={b} Sq={sq} Skv={skv} H={h} D={d} {name}: "
                f"max_abs_err dq={dq_cmp[0][0]:.3g} lse={dq_cmp[1][0]:.3g} "
                f"delta={dq_cmp[2][0]:.3g} dk={dkv_cmp[0][0]:.3g} dv={dkv_cmp[1][0]:.3g} "
                f"(tol {TOL[name]}), bitwise repeatable={same}")
            if not (all(ok for _, ok in dq_cmp + dkv_cmp) and same):
                raise AssertionError(f"attention backward kernels disagree: {err}, "
                                     f"repeatable={same}")
    rows = {}
    for (b, sq, skv, h, d) in timed_shapes:
        for dtype in (getattr(torch, n) for n in dtypes):
            name = str(dtype).split(".")[1]
            g = torch.Generator(device=dev).manual_seed(3)
            q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
                           for s in (sq, skv, skv, sq))
            dq_cmp, dkv_cmp, same, (lse, delta) = check_attention_bwd_once(
                torch, ops, q, k, v, do, name)
            dq_ms = cuda_ms(torch, lambda: ops.attention_bwd_dq(q, k, v, do))
            dkv_ms = cuda_ms(torch, lambda: ops.attention_bwd_dkv(q, k, v, do, lse, delta))
            dq_plain = cuda_ms(torch, lambda: ops.attention_bwd_dq_plain(q, k, v, do))
            dkv_plain = cuda_ms(
                torch, lambda: ops.attention_bwd_dkv_plain(q, k, v, do, lse, delta))
            plain_ms = cuda_ms(torch, lambda: ops.attention_bwd_plain(q, k, v, do))
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
            out = F.scaled_dot_product_attention(qt, kt, vt)
            gt = do.transpose(1, 2)
            lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(
                out, (qt, kt, vt), gt, retain_graph=True))
            lib_dev = device_ms(torch, lambda: torch.autograd.grad(
                out, (qt, kt, vt), gt, retain_graph=True))
            kern_dev = device_ms(torch, lambda: ops.attention_bwd_kernel(q, k, v, do))
            es, unit = q.element_size(), b * h * sq * skv * d
            stats = 2 * b * h * sq * 4
            whole, by = bound((3 * sq + 4 * skv) * b * h * d * es, 10.0 * unit, name, TC_FLOPS)
            dq_b, dq_by = bound((3 * sq + 2 * skv) * b * h * d * es + stats, 6.0 * unit, name,
                                TC_FLOPS)
            dkv_b, dkv_by = bound((2 * sq + 4 * skv) * b * h * d * es + stats, 8.0 * unit, name,
                                  TC_FLOPS)
            err = max(e for e, _ in dq_cmp + dkv_cmp)
            log(f"[{label}] attention_bwd B={b} Sq={sq} Skv={skv} H={h} D={d} {name}: "
                f"max_abs_err dq={dq_cmp[0][0]:.3g} lse={dq_cmp[1][0]:.3g} "
                f"delta={dq_cmp[2][0]:.3g} dk={dkv_cmp[0][0]:.3g} dv={dkv_cmp[1][0]:.3g} "
                f"(tol {TOL[name]}), bitwise repeatable={same}; kernel_ms dq={dq_ms:.4f} "
                f"dkv={dkv_ms:.4f} sum={dq_ms + dkv_ms:.4f}; plain_ms dq={dq_plain:.4f} "
                f"dkv={dkv_plain:.4f} whole={plain_ms:.4f}; library_ms={lib_ms:.4f} "
                f"(SDPA autograd backward), ratio_to_sdpa={(dq_ms + dkv_ms) / lib_ms:.3f}; "
                f"device time (profiler) kernels={kern_dev:.4f} SDPA backward={lib_dev:.4f} "
                f"ratio={kern_dev / lib_dev:.3f}; "
                f"bound_ms whole={whole:.4f} ({by}) dq={dq_b:.4f} ({dq_by}) "
                f"dkv={dkv_b:.4f} ({dkv_by})")
            if not (all(ok for _, ok in dq_cmp + dkv_cmp) and same):
                raise AssertionError(f"attention backward kernels disagree: {err}, "
                                     f"repeatable={same}")
            rows[(b, sq, skv, h, d, name)] = {
                "dq": dict(max_abs_err=max(e for e, _ in dq_cmp), ms=dq_ms,
                           plain_ms=dq_plain, library_ms=None, bound_ms=dq_b,
                           bound_by=dq_by),
                "dkv": dict(max_abs_err=max(e for e, _ in dkv_cmp), ms=dkv_ms,
                            plain_ms=dkv_plain, library_ms=None, bound_ms=dkv_b,
                            bound_by=dkv_by),
            }
    return rows


def check_group_norm_bwd(torch, F, ops, dev):
    """The GroupNorm(+SiLU) backward kernel against its plain version, with
    the autograd backward of F.group_norm (+ F.silu) as the library time."""
    rows = {}
    for shape in GN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            for silu in (True, False):
                g = torch.Generator(device=dev).manual_seed(4)
                x = (torch.randn(shape, generator=g, device=dev) * 3 + 0.5).to(dtype)
                gamma = torch.randn(shape[1], generator=g, device=dev) + 1
                beta = torch.randn(shape[1], generator=g, device=dev)
                dy = torch.randn(shape, generator=g, device=dev).to(dtype)
                _, mean, rstd = ops.group_norm_silu_plain(x, gamma, beta, 32, 1e-6, silu, dtype)
                args = (x, dy, gamma, beta, mean, rstd, 32, silu)
                got = gn_bwd(ops, *args)
                want = ops.group_norm_silu_bwd_plain(*args)
                torch.cuda.synchronize()
                err, ok = compare(got[0], want[0], name)
                sums = [compare_sum(a, w) for a, w in zip(got[1:], want[1:])]
                same = all(torch.equal(a, w) for a, w in zip(got, gn_bwd(ops, *args)))
                ms = cuda_ms(torch, lambda: ops.group_norm_bwd_kernel(*args))
                dev_ms = device_ms(torch, lambda: ops.group_norm_bwd_kernel(*args))
                plain_ms = cuda_ms(torch, lambda: ops.group_norm_silu_bwd_plain(*args))
                xr = x.detach().requires_grad_(True)
                gr, br = (t.to(dtype).detach().requires_grad_(True) for t in (gamma, beta))
                y = F.group_norm(xr, 32, gr, br, 1e-6)
                y = F.silu(y) if silu else y
                lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(
                    y, (xr, gr, br), dy, retain_graph=True))
                n = x.numel()
                nbytes = 3 * n * x.element_size() + 4 * shape[1] * 4 + 2 * shape[0] * 32 * 4
                bms, by = bound(nbytes, n * (21.0 if silu else 10.0), "float32")
                log(f"[kernels] group_norm_bwd {tuple(shape)} G=32 silu={silu} {name}: "
                    f"max_abs_err dx={err:.3g} (tol {TOL[name]}) dgamma={sums[0][0]:.3g} "
                    f"dbeta={sums[1][0]:.3g} (tol {SUM_TOL} of max), bitwise repeatable={same}; "
                    f"kernel_ms={ms:.4f} device_ms={dev_ms:.4f} plain_ms={plain_ms:.4f} "
                    f"library_ms={lib_ms:.4f} bound_ms={bms:.4f} ({by})")
                if not (ok and all(o for _, o in sums) and same):
                    raise AssertionError(f"group norm backward kernel disagrees: {err}, "
                                         f"{sums}, repeatable={same}")
                rows[(shape, name, silu)] = dict(
                    max_abs_err=max(err, *(e for e, _ in sums)), ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=bms, bound_by=by, device_ms=dev_ms)
    return rows


def gn_census_of(torch, spec, device="cpu") -> list:
    """Every GroupNorm of a `spec` U-Net forward as (C, H, W, silu, launches),
    in order of first use, from forward pre-hooks on a batch-1 pass on
    `device` (with a 77-token context for a conditional spec)."""
    from group_attribution_for_diffusion_models_tpu_torch.models import UNet2D

    with torch.device(device):
        model = UNet2D(spec).eval()
    context = ((torch.zeros(1, 77, spec.cross_attention_dim, device=device),)
               if spec.conditional else ())
    return _census(torch, model, lambda: model(
        torch.zeros(1, spec.in_channels, spec.sample_size, spec.sample_size, device=device),
        torch.zeros(1, dtype=torch.long, device=device), *context))


def vq_gn_census(torch, spec, device) -> list:
    """Every GroupNorm of a VQ-VAE encode and decode (the train step's
    forward), as `gn_census_of`."""
    from group_attribution_for_diffusion_models_tpu_torch.models.vqvae import VQVAE

    model = VQVAE(spec).eval().to(device)
    x = torch.zeros(1, spec.in_channels, spec.sample_size, spec.sample_size, device=device)
    return _census(torch, model, lambda: model.decode(model.encode(x), force_not_quantize=True))


def kl_gn_census(torch, spec, device) -> tuple:
    """Every GroupNorm of a KL VAE encode and of a decode, as `gn_census_of`."""
    from group_attribution_for_diffusion_models_tpu_torch.models.vqvae import AutoencoderKL

    with torch.device(device):
        model = AutoencoderKL(spec).eval()
    f = 2 ** (len(spec.block_out_channels) - 1)
    x = torch.zeros(1, spec.in_channels, spec.sample_size, spec.sample_size, device=device)
    z = torch.zeros(1, spec.latent_channels, spec.sample_size // f, spec.sample_size // f,
                    device=device)
    return (_census(torch, model.encoder, lambda: model.encode(x)),
            _census(torch, model.decoder, lambda: model.decode(z)))


def _census(torch, model, run) -> list:
    from group_attribution_for_diffusion_models_tpu_torch.models.layers import GroupNormSiLU

    seen: dict = {}

    def hook(mod, inputs):
        key = (*inputs[0].shape[1:], mod.silu)
        seen[key] = seen.get(key, 0) + 1

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, GroupNormSiLU)]
    with torch.no_grad():
        run()
    for h in handles:
        h.remove()
    return [(c, h, w, silu, n) for (c, h, w, silu), n in seen.items()]


def check_gn_census(torch, ops, dev, census=GN_CENSUS, label="census", cache=None,
                    batch=GN_CENSUS_BATCH, eps=1e-6, dtypes=("float32", "bfloat16"),
                    library=False, what="U-Net pass"):
    """Every GroupNorm shape of a pass (`census`, default the CIFAR U-Net's
    GN_CENSUS) at `batch` and `eps`, in `dtypes`: both kernels held against
    their plain versions (TOL, SUM_TOL) and repeated bit for bit, then timed
    by the profiler's device time: the forward kernel, the backward kernel,
    and the backward as autograd runs it (the kernel, then the sum of its
    partials over the batch); with `library`, also F.group_norm (+ F.silu)
    forward and autograd backward and both plain versions, event-timed. Totals per pass forward and backward, weighted by launches,
    beside their bytes bounds (x read and y written; x and dy read and dx
    written). A shape already in `cache` (a dict this fills) is not held or
    timed again. Returns {dtype: totals}, each with its shapes' rows."""
    cache = {} if cache is None else cache
    out = {}
    for dtype in (getattr(torch, n) for n in dtypes):
        name = str(dtype).split(".")[1]
        tot = dict(fwd_ms=0.0, bwd_kernel_ms=0.0, bwd_ms=0.0, fwd_bound_ms=0.0,
                   bwd_bound_ms=0.0, launches=0)
        rows = []
        for c, h, w, silu, launches in census:
            key = (batch, c, h, w, silu, eps, name)
            if key not in cache:
                cache[key] = _gn_census_shape(torch, ops, dev, c, h, w, silu, dtype, name,
                                              batch, eps, library)
                row = cache[key]
                lib = (f"; library ms forward={row['lib_fwd_ms']:.4f} backward="
                       f"{row['lib_bwd_ms']:.4f}; plain ms forward={row['plain_fwd_ms']:.4f} "
                       f"backward={row['plain_bwd_ms']:.4f}" if library else "")
                log(f"[{label}] group_norm {(batch, c, h, w)} G=32 cpg={c // 32} eps={eps} "
                    f"silu={silu} {name} x{launches}: max_abs_err out={row['out_err']:.3g} "
                    f"dx={row['dx_err']:.3g} (tol {TOL[name]}), mean/rstd/partials="
                    f"{row['stat_err']:.3g}, bitwise repeatable=True; device ms: forward="
                    f"{row['fwd_ms']:.4f} (bound {row['fwd_bound_ms']:.4f}), backward kernel="
                    f"{row['bwd_kernel_ms']:.4f}, with the sum={row['bwd_ms']:.4f} "
                    f"(bound {row['bwd_bound_ms']:.4f}){lib}")
            rows.append(dict(cache[key], shape=(batch, c, h, w), silu=silu, launches=launches))
            for k in tot:
                tot[k] += launches * (1 if k == "launches" else cache[key][k])
        log(f"[{label}] {name} per {what} at batch {batch} "
            f"({tot['launches']} launches): "
            f"forward {tot['fwd_ms']:.4f} ms (bound {tot['fwd_bound_ms']:.4f}), backward "
            f"{tot['bwd_ms']:.4f} ms with the sums, {tot['bwd_kernel_ms']:.4f} kernels alone "
            f"(bound {tot['bwd_bound_ms']:.4f}), device time")
        out[name] = dict(tot, rows=rows)
    return out


def _gn_census_shape(torch, ops, dev, c, h, w, silu, dtype, name, batch=GN_CENSUS_BATCH,
                     eps=1e-6, library=False) -> dict:
    """One census shape: both kernels held and repeated, then timed."""
    import torch.nn.functional as F

    shape = (batch, c, h, w)
    g = torch.Generator(device=dev).manual_seed(8)
    x = (torch.randn(shape, generator=g, device=dev) * 3 + 0.5).to(dtype)
    gamma = torch.randn(c, generator=g, device=dev) + 1
    beta = torch.randn(c, generator=g, device=dev)
    dy = torch.randn(shape, generator=g, device=dev).to(dtype)
    args = (x, gamma, beta, 32, eps, silu, dtype)
    got, want = ops.group_norm_kernel(*args), ops.group_norm_silu_plain(*args)
    bargs = (x, dy, gamma, beta, want[1], want[2], 32, silu)
    got_b = gn_bwd(ops, *bargs)
    want_b = ops.group_norm_silu_bwd_plain(*bargs)
    torch.cuda.synchronize()
    checks = ([compare(got[0], want[0], name), compare(got_b[0], want_b[0], name)]
              + [compare(a, b, "float32") for a, b in zip(got[1:], want[1:])]
              + [compare_sum(a, b) for a, b in zip(got_b[1:], want_b[1:])])
    same = (all(torch.equal(a, b) for a, b in zip(got, ops.group_norm_kernel(*args)))
            and all(torch.equal(a, b) for a, b in zip(got_b, gn_bwd(ops, *bargs))))
    if not (all(ok for _, ok in checks) and same):
        raise AssertionError(f"group norm kernels disagree at {shape} silu={silu} "
                             f"{name}: {checks}, repeatable={same}")
    fwd = device_ms(torch, lambda: ops.group_norm_kernel(*args))
    bwd_kernel = device_ms(torch, lambda: ops.group_norm_bwd_kernel(*bargs))
    xr, gr, br = (t.detach().requires_grad_(True) for t in (x, gamma, beta))
    y = ops.group_norm_silu(xr, gr, br, groups=32, eps=eps, silu=silu)
    bwd = device_ms(torch, lambda: torch.autograd.grad(y, (xr, gr, br), dy, retain_graph=True))
    nbytes = x.numel() * x.element_size()
    row = dict(out_err=checks[0][0], dx_err=checks[1][0],
               stat_err=max(e for e, _ in checks[2:]), fwd_ms=fwd, bwd_kernel_ms=bwd_kernel,
               bwd_ms=bwd, fwd_bound_ms=2 * nbytes / HBM_BYTES_PER_S * 1e3,
               bwd_bound_ms=3 * nbytes / HBM_BYTES_PER_S * 1e3)
    if library:
        del y

        def lib(xx, gg, bb):
            yy = F.group_norm(xx, 32, gg.to(dtype), bb.to(dtype), eps)
            return F.silu(yy) if silu else yy

        # Event-timed: a trace can drop one of a library call's several kernels.
        row["lib_fwd_ms"] = cuda_ms(torch, lambda: lib(x, gamma, beta), iters=5)
        yl = lib(xr, gr, br)
        row["lib_bwd_ms"] = cuda_ms(
            torch, lambda: torch.autograd.grad(yl, (xr, gr, br), dy, retain_graph=True), iters=5)
        del yl
        row["plain_fwd_ms"] = cuda_ms(torch, lambda: ops.group_norm_silu_plain(*args), iters=5)
        row["plain_bwd_ms"] = cuda_ms(
            torch, lambda: ops.group_norm_silu_bwd_plain(*bargs), iters=5)
    return row


def check_prune_gn(torch, np, ops, model, spec, dev, cache):
    """Magnitude pruning of the seeded CIFAR U-Net at PRUNE_RATIOS: the
    GroupNorm census of each pruned pass (the shapes `cache` lacks held and
    timed), then the ratio-0.3 pruned U-Net on the card against the CPU."""
    from group_attribution_for_diffusion_models_tpu_torch.models import UNet2D
    from group_attribution_for_diffusion_models_tpu_torch.pruning import (
        count_params, magnitude_importance, prune_unet)

    if sorted(gn_census_of(torch, spec)) != sorted(GN_CENSUS):
        raise AssertionError("the census helper disagrees with GN_CENSUS")
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    importance = magnitude_importance(state)
    pruned = {}
    for ratio in PRUNE_RATIOS:
        pspec, pstate = prune_unet(spec, state, ratio, importance)
        census = gn_census_of(torch, pspec)
        widths = sorted(set(pspec.pruned_channels.values()))
        log(f"[prune-gn] magnitude ratio {ratio}: {len(pspec.pruned_channels)} resnets, hidden "
            f"widths {widths} (channels a group {[w // 32 for w in widths]}), "
            f"{count_params(state)} -> {count_params(pstate)} params; {len(census)} GroupNorm "
            f"shapes, {sum(n for *_, n in census)} launches a pass, as (C, H, W, silu, launches): "
            f"{census}")
        check_gn_census(torch, ops, dev, census, label="prune-gn", cache=cache)
        pruned[ratio] = pspec, pstate
    pspec, pstate = pruned[PRUNE_RATIOS[0]]
    pmodel = UNet2D(pspec)
    pmodel.load_state_dict(pstate)
    pmodel.eval()
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((4, 3, 32, 32)).astype(np.float32))
    t = torch.tensor([999, 500, 20, 0])
    with torch.no_grad():
        want = pmodel(x, t)
        pmodel.to(dev)
        reset_counts(ops)
        got = pmodel(x.to(dev), t.to(dev)).cpu()
    counts = ops.launch_counts()
    err = (got - want).abs().max().item()
    log(f"[prune-gn] pruned (ratio {PRUNE_RATIOS[0]}) CIFAR UNet2D batch 4 f32, card vs CPU: "
        f"max_abs_err={err:.3g} (tol {CIFAR_FWD_ATOL}), launches {counts}")
    if not (err <= CIFAR_FWD_ATOL and counts == unet_counts(1, 0)):
        raise AssertionError("the pruned CIFAR forward on the card disagrees with the CPU")


def check_pipeline(torch, np, ops, root: str, card: str):
    """shapley_pipeline at full width on the stand-in: arm A (retrain), the
    Taylor prune of its full anchor, arm B (sparse fine-tuning from the pruned
    base, on the same DB and test seeds), each between a counter reset and a
    read, with the launches the code implies. Returns the summed counts."""
    from group_attribution_for_diffusion_models_tpu_torch.cli import prune, shapley_pipeline
    from group_attribution_for_diffusion_models_tpu_torch.config.registry import get_config

    outdir = os.path.join(root, "pipeline")
    # No --chunk_size and no --batch_size: the pipeline's defaults.
    common = ["--dataset", "cifar", "--by_class", "--fit_dist", "shapley",
              "--removal_seed", "0", "--num_fit_subsets", str(PIPE_FIT),
              "--num_test_subsets", str(PIPE_TEST), "--test_seed_start", str(PIPE_TEST_SEED),
              "--training_steps", str(PIPE_STEPS), "--behavior", "eval_loss",
              "--no-save_ckpts", "--device", "cuda", "--outdir", outdir]
    chunk = shapley_pipeline.parse_args(common).chunk_size
    batch = get_config("cifar").train.batch_size

    def calls(n):
        return -(-n // chunk)

    # A train_ensemble call stacks its members (`chunk` at most): one forward
    # and backward a step for all of them; then one eval-loss forward a
    # member. Arm A: the fit calls, the test calls, the full anchor (and the
    # null anchor, 0 steps).
    a_steps = (PIPE_FIT + PIPE_TEST + 1) * PIPE_STEPS  # member-steps
    a_launch = (calls(PIPE_FIT) + calls(PIPE_TEST) + 1) * PIPE_STEPS
    want_a = unet_counts(a_launch + PIPE_FIT + PIPE_TEST + 2, a_launch)
    # Arm B: the fit calls and the anchors; its test rows are arm A's.
    b_steps = (PIPE_FIT + 1) * PIPE_FT_STEPS
    b_launch = (calls(PIPE_FIT) + 1) * PIPE_FT_STEPS
    want_b = unet_counts(b_launch + PIPE_FIT + 2, b_launch)
    # Taylor: one forward and backward a timestep, then the pruned model's check.
    taylor = len(range(999, -1, -PIPE_TAYLOR_STRIDE))
    want_p = unet_counts(taylor + 1, taylor)

    def timed(fn, argv):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(ops)
        t0 = time.perf_counter()
        out = fn(argv)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, ops.launch_counts()

    arms = {}
    a, a_wall, a_counts = timed(shapley_pipeline.main, common)
    log(f"[pipeline] arm A at the defaults, {chunk} members a call at batch {batch}: peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    arms["A retrain"] = (a, a_wall, a_counts, want_a, a_steps)
    full = os.path.join(outdir, "cifar", "retrain", "models", "full")
    p, p_wall, p_counts = timed(prune.main, [
        "--dataset", "cifar", "--load", full, "--pruner", "taylor",
        "--timestep_stride", str(PIPE_TAYLOR_STRIDE), "--pruning_ratio", str(PIPE_PRUNE_RATIO),
        "--outdir", outdir, "--device", "cuda"])
    widths = sorted(set(p["spec"].pruned_channels.values()))
    log(f"[pipeline] prune taylor ratio {PIPE_PRUNE_RATIO} of arm A's full anchor ({taylor} "
        f"timesteps): {p['params_before']} -> {p['params_after']} params, "
        f"hidden widths {widths}, scoring and slicing {p['seconds']:.3f} s, call "
        f"{p_wall:.3f} s, launches {p_counts} (expected {want_p})")
    if p_counts != want_p:
        raise AssertionError(f"prune launches {p_counts}, expected {want_p}")
    b, b_wall, b_counts = timed(shapley_pipeline.main, common + [
        "--method", "prune_fine_tune", "--load", p["model_dir"],
        "--fit_training_steps", str(PIPE_FT_STEPS)])
    arms["B sparse FT"] = (b, b_wall, b_counts, want_b, b_steps)
    for label, (r, wall, counts, want, steps) in arms.items():
        row, attrs = r["row"], r["attrs"]
        resid = abs(attrs.sum() - (r["v1"] - r["v0"]))
        limit = EFFICIENCY_RTOL * max(1.0, abs(r["v1"] - r["v0"]))
        log(f"[pipeline] arm {label} cifar by class f32 on {card}: {row['num_fit_subsets']} fit "
            f"x {row['fit_training_steps']} steps, {row['num_test_subsets']} test rows; training "
            f"{r['train_seconds']:.3f} s ({steps} member-steps at batch {batch}, "
            f"{steps / r['train_seconds']:.3f} member-steps/s), subset_passes_per_hour "
            f"{row['subset_passes_per_hour']}, call {wall:.3f} s; lds_pooled "
            f"{row['lds_pooled']:.4f}, v1 {r['v1']:.6f}, v0 {r['v0']:.6f}, efficiency residual "
            f"{resid:.3g} (limit {limit:.3g}); launches {counts} (expected {want})")
        if counts != want:
            raise AssertionError(f"pipeline arm {label}: launches {counts}, expected {want}")
        if not (attrs.shape == (10,) and np.isfinite(attrs).all() and resid <= limit):
            raise AssertionError(f"pipeline arm {label}: attributions {attrs}")
        if (len(r["x_fit"]), len(r["y_test"])) != (PIPE_FIT, PIPE_TEST):
            raise AssertionError(f"pipeline arm {label}: rows {len(r['x_fit'])}, "
                                 f"{len(r['y_test'])}")
    # Arm B's anchors come from the prune_fine_tune game; both arms fit
    # against the same retrained test rows.
    v1, v0 = shapley_pipeline.anchor_values(b["db"], "cifar", "prune_fine_tune", "eval_loss",
                                            PIPE_FT_STEPS)
    if (v1, v0) != (b["v1"], b["v0"]) or b["v0"] == a["v0"]:
        raise AssertionError("arm B's anchors are not the prune_fine_tune game's")
    if not np.array_equal(a["y_test"], b["y_test"]):
        raise AssertionError("the arms fit against different test rows")
    log(f"[pipeline] both arms against the same {PIPE_TEST} retrained test rows (y_test "
        f"{np.round(a['y_test'], 6).tolist()}); attrs A {np.round(a['attrs'], 6).tolist()}, "
        f"B {np.round(b['attrs'], 6).tolist()}")
    return {k: a_counts[k] + p_counts[k] + b_counts[k] for k in a_counts}


def tower_flops(torch, model, size: int) -> float:
    """FLOPs of one image through `model`'s convolutions and dense layers (2
    a multiply-add), from forward hooks on a batch-1 pass on the CPU; the
    pools, BatchNorms and ReLUs are not counted."""
    total = [0.0]

    def hook(mod, inputs, out):
        total[0] += 2.0 * out.numel() * mod.weight[0].numel()

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    with torch.no_grad():
        model(torch.zeros(1, 3, size, size))
    for h in handles:
        h.remove()
    return total[0]


def check_towers(torch, np, dev, card: str) -> None:
    """The FID InceptionV3 and VGG16Features (seeded random inits, full
    size) on the card against the CPU on TOWER_CHECK_IMAGES seeded 32x32
    images, then timed at TOWER_BATCH: event time, device time, images/s,
    peak memory, beside the bound (the convs' and dense layers' FLOPs at the
    f32 FMA rate, or input, weights and outputs at the HBM rate)."""
    from group_attribution_for_diffusion_models_tpu_torch.attributions.global_scores import (
        load_inception, load_vgg16)

    rng = np.random.default_rng(13)
    imgs = torch.from_numpy(rng.uniform(0, 1, (TOWER_CHECK_IMAGES, 3, 32, 32)).astype(np.float32))
    batch = torch.from_numpy(rng.uniform(0, 1, (TOWER_BATCH, 3, 32, 32)).astype(np.float32))
    for name, build, size in (("InceptionV3 (FID, 1008 classes)", load_inception, 299),
                              ("VGG16Features (fc2, caffe)", load_vgg16, 224)):
        cpu_model = build(None, device="cpu")
        flops = tower_flops(torch, cpu_model, 32)
        with torch.no_grad():
            want = cpu_model(imgs)
        del cpu_model
        model = build(None, device=dev)
        x = batch.to(dev)
        with torch.no_grad():
            got = model(imgs.to(dev))
            if not isinstance(want, dict):
                want, got = {"fc2": want}, {"fc2": got}
            errs = {k: (got[k].cpu() - want[k]).abs().max().item() for k in want}
            limits = {k: TOWER_TOL * max(1.0, want[k].abs().max().item()) for k in want}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(torch, lambda: model(x), iters=5)
            dev_ms = device_ms(torch, lambda: model(x), iters=3)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        weights = sum(p.numel() for p in model.parameters())
        out_numel = sum(v.numel() for v in got.values()) // TOWER_CHECK_IMAGES * TOWER_BATCH
        bms, by = bound((x.numel() + weights + out_numel) * 4, flops * TOWER_BATCH, "float32")
        log(f"[scores] {name} at {size}x{size} from 32x32, f32 (TF32 off), card vs CPU on "
            f"{TOWER_CHECK_IMAGES} images: max_abs_err "
            + ", ".join(f"{k}={errs[k]:.3g} (tol {limits[k]:.3g})" for k in errs)
            + f"; batch {TOWER_BATCH} on {card}: {ms:.3f} ms event, {dev_ms:.3f} ms device "
            f"({TOWER_BATCH / ms * 1e3:.1f} images/s, {ms / TOWER_BATCH:.4f} ms an image), "
            f"{flops / 1e9:.3f} GFLOP an image ({weights} weights), bound {bms:.3f} ms ({by}; "
            f"{bms / TOWER_BATCH:.4f} ms an image), {bms / dev_ms:.3f} of it by device time, "
            f"peak {peak_gib:.2f} GiB")
        if any(errs[k] > limits[k] for k in errs):
            raise AssertionError(f"{name} on the card disagrees with the CPU: {errs}")
        del model, x, got
        torch.cuda.empty_cache()


def check_scores(torch, np, ops, root: str, card: str) -> dict:
    """shapley_pipeline --behavior fid_value at full width on the stand-in,
    then calculate_global_scores on its full anchor's checkpoint, each
    between a counter reset and a read, with the launches the code implies,
    and scipy's sqrtm memoised by its input's bytes. Returns the summed
    counts."""
    from scipy import linalg

    outdir = os.path.join(root, "scores")
    ref_stats = os.path.join(outdir, "inception_ref_stats.pkl")
    roots, calls, sqrtm = {}, [], linalg.sqrtm

    def sqrtm_once(a, *args, **kwargs):
        key = (a.shape, hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest())
        calls.append(key)
        if key not in roots:
            roots[key] = sqrtm(a, *args, **kwargs)
        return roots[key]

    linalg.sqrtm = sqrtm_once
    try:
        return _check_scores(torch, np, ops, outdir, ref_stats, card, roots, calls)
    finally:
        linalg.sqrtm = sqrtm


def _check_scores(torch, np, ops, outdir: str, ref_stats: str, card: str, roots: dict,
                  calls: list) -> dict:
    """check_scores' calls, with the host square roots of `roots` (memo) and
    `calls` (each call's input key)."""
    from group_attribution_for_diffusion_models_tpu_torch.cli import (
        calculate_global_scores, shapley_pipeline)
    from group_attribution_for_diffusion_models_tpu_torch.utils.jsonl import read_records

    members = SCORE_FIT + SCORE_TEST + 2  # and the null and full anchors
    steps = (SCORE_FIT + SCORE_TEST + 1) * SCORE_STEPS
    # The fit call, the test call and the full anchor each stack their members
    # (a forward and backward a step); one forward a DDIM step a member.
    launch = 3 * SCORE_STEPS
    want = unet_counts(launch + members * SCORE_SAMPLE_STEPS, launch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    t0 = time.perf_counter()
    r = shapley_pipeline.main([
        "--dataset", "cifar", "--by_class", "--fit_dist", "shapley", "--removal_seed", "0",
        "--num_fit_subsets", str(SCORE_FIT), "--num_test_subsets", str(SCORE_TEST),
        "--test_seed_start", str(PIPE_TEST_SEED), "--training_steps", str(SCORE_STEPS),
        "--batch_size", str(SCORE_BATCH), "--behavior", "fid_value",
        "--n_samples", str(SCORE_SAMPLES), "--num_inference_steps", str(SCORE_SAMPLE_STEPS),
        "--no-save_ckpts", "--device", "cuda",
        "--outdir", outdir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    pipe_roots = len(roots)
    rows = [x for x in read_records(r["db"]) if "fid_value" in x]
    fids = [x["fid_value"] for x in rows]
    sec, row = r["seconds"], r["row"]
    resid = abs(r["attrs"].sum() - (r["v1"] - r["v0"]))
    limit = EFFICIENCY_RTOL * max(1.0, abs(r["v1"] - r["v0"]))
    log(f"[scores] shapley_pipeline --behavior fid_value cifar by class f32 on {card}: "
        f"{row['num_fit_subsets']} fit and {row['num_test_subsets']} test subsets x "
        f"{SCORE_STEPS} steps at batch {SCORE_BATCH}, two anchors, {SCORE_SAMPLES} samples x "
        f"{SCORE_SAMPLE_STEPS} DDIM steps a member; seconds: training {sec['train']:.3f}, "
        f"sampling {sec['sample']:.3f} ({sec['sample'] / members:.3f} a member), tower "
        f"{sec['tower']:.3f} (synchronised host clock, with the 2048 reference images), "
        f"FID math {sec['fid']:.3f} (host, {pipe_roots} sqrtm of {len(calls)} calls, "
        f"{sec['fid'] / max(1, pipe_roots):.3f} each); "
        f"pipeline clock {r['train_seconds']:.3f} s, subset_passes_per_hour "
        f"{row['subset_passes_per_hour']}, call {wall:.3f} s, peak {peak_gib:.2f} GiB; "
        f"v1 {r['v1']:.6f}, v0 {r['v0']:.6f}, efficiency residual {resid:.3g} (limit "
        f"{limit:.3g}), lds_pooled {row['lds_pooled']:.4f}; launches {counts} (expected {want})")
    log(f"[scores] fid_value per member (seed order of the DB): "
        + ", ".join(f"{x['removal_dist']}:{x['removal_seed']}@{x['training_steps']}="
                    f"{x['fid_value']:.4f}" for x in rows))
    if counts != want:
        raise AssertionError(f"scores path launches {counts}, expected {want}")
    if not (len(fids) == members and all(math.isfinite(f) and f > 0 for f in fids)):
        raise AssertionError(f"scores path: fid values {fids}")
    if not (r["attrs"].shape == (10,) and np.isfinite(r["attrs"]).all() and resid <= limit):
        raise AssertionError(f"scores path: attributions {r['attrs']}")
    (anchor,) = [x for x in rows if x["removal_dist"] == "full"
                 and x["training_steps"] == SCORE_STEPS]

    full = os.path.join(outdir, "cifar", "retrain", "models", "full")
    pipe_calls = len(calls)
    torch.cuda.synchronize()
    reset_counts(ops)
    t0 = time.perf_counter()
    g = calculate_global_scores.main([
        "--dataset", "cifar", "--load", full, "--n_samples", str(SCORE_SAMPLES),
        "--batch_size", str(SCORE_SAMPLES), "--num_inference_steps", str(SCORE_SAMPLE_STEPS),
        "--seed", str(SCORE_SEED), "--pr_extractor", "vgg16", "--ref_stats", ref_stats,
        "--outdir", outdir, "--device", "cuda"])
    torch.cuda.synchronize()
    g_wall = time.perf_counter() - t0
    g_counts = ops.launch_counts()
    g_want = unet_counts(SCORE_SAMPLE_STEPS, 0)
    rel = abs(g["fid_value"] - anchor["fid_value"]) / anchor["fid_value"]
    log(f"[scores] calculate_global_scores on the full anchor's checkpoint: fid "
        f"{g['fid_value']:.6f} (the anchor's pipeline row {anchor['fid_value']:.6f}, rel "
        f"{rel:.3g}, equal={g['fid_value'] == anchor['fid_value']}), is {g['is']:.6f} "
        f"(row {anchor['is']:.6f}) +- {g['is_std']:.4f}, precision {g['precision']}, recall "
        f"{g['recall']} (VGG16 fc2), sampling {g['sampling_time']:.3f} s, scoring "
        f"{g['scoring_time']:.3f} s ({len(calls) - pipe_calls} sqrtm calls, "
        f"{len(roots) - pipe_roots} new roots: its input "
        f"{'is' if len(roots) == pipe_roots else 'is not'} one the pipeline rooted), call "
        f"{g_wall:.3f} s; launches {g_counts} (expected {g_want})")
    if g_counts != g_want:
        raise AssertionError(f"calculate_global_scores launches {g_counts}, expected {g_want}")
    if not (rel <= SCORE_FID_RTOL and abs(g["is"] - anchor["is"]) <= SCORE_FID_RTOL * g["is"]
            and 0.0 <= g["precision"] <= 1.0 and 0.0 <= g["recall"] <= 1.0):
        raise AssertionError("calculate_global_scores disagrees with the anchor's row")
    return {k: counts[k] + g_counts[k] for k in counts}


def model_counts(attn: int, gn: int, forwards: int, backwards: int = 0) -> dict:
    """Kernel launches of a model with `attn` attention layers the kernels take
    and `gn` GroupNorms, per forward and per backward."""
    return {"attention_fwd": attn * forwards, "attention_bwd_dq": attn * backwards,
            "attention_bwd_dkv": attn * backwards, "group_norm_fwd": gn * forwards,
            "group_norm_bwd": gn * backwards, "jl_projection": 0}


def add_counts(*counts: dict) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def expect(label, counts, routes, want, want_routes, phase="ldm") -> None:
    """Kernel launches and plain-route calls of an [ldm] or [tti] main path
    against those reckoned from the spec."""
    log(f"[{phase}] {label} launches {counts} (expected {want}), plain route {routes} "
        f"(expected {want_routes})")
    if counts != want or routes != want_routes:
        raise AssertionError(f"{label}: launches {counts} {routes}, expected {want} "
                             f"{want_routes}")


def timed_call(torch, ops, fn, argv):
    """fn(argv) between a reset of the launch and plain-route counters and a
    read of them: (result, seconds to a device synchronise, launches, route
    calls, peak device memory in GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    for r in ops.PLAIN_ROUTES.values():
        r.launches = 0
    t0 = time.perf_counter()
    out = fn(argv)
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, ops.launch_counts(), ops.route_counts(),
            torch.cuda.max_memory_allocated() / 2**30)


def check_plain_route(torch, F, ops, dev, label="ldm", shapes=VQ_ATTN_SHAPES, backward=True,
                      what="the VQ mid attention"):
    """The plain f32 attention the VAEs' mid attention takes on the card
    (head dim 512, which the kernels do not take): what the route runs,
    forward at `shapes` and, with `backward`, backward at the first (the
    VQ-VAE's train_vqvae batch), timed with SDPA's time and the bound (the
    products at the f32 FMA rate), peak memory beside; the route's counter
    moves once a call."""
    for i, (b, s_, h, d) in enumerate(shapes):
        g = torch.Generator(device=dev).manual_seed(14)
        q, k, v = (torch.randn(b, s_, h, d, generator=g, device=dev) for _ in range(3))
        before = ops.route_counts()["attention_plain_fwd"]
        out = ops.attention_plain_route(q, k, v)
        if ops.route_counts()["attention_plain_fwd"] != before + 1:
            raise AssertionError("the plain route did not count its call")
        del out
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(torch, lambda: ops.attention_plain(q, k, v), iters=3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=3)
        flops = 4.0 * b * h * s_ * s_ * d
        bms, by = bound(4 * q.numel() * 4, flops, "float32")
        log(f"[{label}] plain route attention B={b} S={s_} H={h} D={d} float32 ({what}): "
            f"plain_ms={ms:.3f} (peak {peak:.2f} GiB) library_ms={lib_ms:.3f} "
            f"(SDPA) bound_ms={bms:.3f} ({by}, f32 FMA)")
        if i == 0 and backward:
            do = torch.randn(b, s_, h, d, generator=g, device=dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            bwd_ms = cuda_ms(torch, lambda: ops.attention_bwd_plain(q, k, v, do), iters=3)
            peak = torch.cuda.max_memory_allocated() / 2**30
            qg, kg, vg = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
            o = F.scaled_dot_product_attention(qg, kg, vg)
            lib_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
                o, (qg, kg, vg), do.transpose(1, 2), retain_graph=True), iters=3)
            bms, by = bound(8 * q.numel() * 4, 2.5 * flops, "float32")
            log(f"[{label}] plain route attention backward B={b} S={s_} D={d} float32: "
                f"plain_ms={bwd_ms:.3f} (peak {peak:.2f} GiB) library_ms={lib_bwd:.3f} "
                f"(SDPA autograd) bound_ms={bms:.3f} ({by}, f32 FMA)")
            del o, qg, kg, vg
        del q, k, v
        torch.cuda.empty_cache()


def check_ldm(torch, np, ops, root: str, card: str, dev) -> dict:
    """The latent-diffusion workload at full CelebA width: the kernels at its
    shapes, then its main paths, each between a counter reset and a read with
    the launches (and plain-route calls) reckoned from the spec: train_vqvae,
    shapley_pipeline --dataset celeba, generate_samples (decoded to 256x256
    PNGs), a card-vs-CPU reference of sampling, decode and encode -> quantize,
    and calculate_global_scores_diversity with the full random BLIP tower.
    Returns the summed kernel launches of the main paths."""
    import torch.nn.functional as F
    from PIL import Image

    from group_attribution_for_diffusion_models_tpu_torch.cli import (
        calculate_global_scores_diversity, generate_samples, shapley_pipeline, train_ensemble,
        train_vqvae)
    from group_attribution_for_diffusion_models_tpu_torch.config.registry import get_config
    from group_attribution_for_diffusion_models_tpu_torch.data import create_dataset
    from group_attribution_for_diffusion_models_tpu_torch.diffusion import make_sampler
    from group_attribution_for_diffusion_models_tpu_torch.models import UNet2D
    from group_attribution_for_diffusion_models_tpu_torch.models.blip_vision import (
        load_blip_vision)
    from group_attribution_for_diffusion_models_tpu_torch.models.layers import (
        GroupNormSiLU, SelfAttention2D)
    from group_attribution_for_diffusion_models_tpu_torch.models.vqvae import (
        VQVAE, load_vqvae, make_vq_decode_fn)
    from group_attribution_for_diffusion_models_tpu_torch.utils.ckpt import load_checkpoint

    if any(ops.route_counts().values()):
        raise AssertionError(f"an earlier phase took the plain route: {ops.route_counts()}")
    cfg = get_config("celeba")
    spec, vq = cfg.unet, cfg.vqvae
    with torch.device("meta"):
        unet, vqvae = UNet2D(spec), VQVAE(vq)
    n_attn = sum(isinstance(m, SelfAttention2D) for m in unet.modules())
    n_gn = sum(isinstance(m, GroupNormSiLU) for m in unet.modules())
    n_enc = sum(isinstance(m, GroupNormSiLU) for m in vqvae.encoder.modules())
    n_dec = sum(isinstance(m, GroupNormSiLU) for m in vqvae.decoder.modules())
    n_params = sum(p.numel() for p in unet.parameters())
    log(f"[ldm] celeba U-Net {n_params} params, {n_attn} attention layers, {n_gn} GroupNorms a "
        f"forward; VQ-VAE {sum(p.numel() for p in vqvae.parameters())} params, GroupNorms "
        f"encoder {n_enc}, decoder {n_dec}, one mid attention each (D=512, the plain route)")
    del unet, vqvae

    def encodes(n):  # n VQ encodes: their GroupNorms and plain-route forwards
        return (dict(model_counts(0, n_enc, n)), {"attention_plain_fwd": n,
                                                  "attention_plain_bwd": 0})

    def decodes(n):
        return (dict(model_counts(0, n_dec, n)), {"attention_plain_fwd": n,
                                                  "attention_plain_bwd": 0})

    def timed(fn, argv):
        return timed_call(torch, ops, fn, argv)

    # Kernels at the workload's shapes.
    unet_census = gn_census_of(torch, spec, device=dev)
    vq_census = vq_gn_census(torch, vq, dev)
    if sum(n for *_, n in unet_census) != n_gn or sum(n for *_, n in vq_census) != n_enc + n_dec:
        raise AssertionError("the census helpers disagree with the models' GroupNorms")
    check_attention(torch, F, ops, dev, LDM_ATTN_SHAPES, [], "ldm")
    check_attention_bwd(torch, F, ops, dev, LDM_ATTN_SHAPES, [], "ldm")
    check_gn_census(torch, ops, dev, unet_census, label="ldm", batch=LDM_BATCH,
                    eps=spec.norm_eps, dtypes=("float32",), library=True,
                    what="CelebA U-Net pass")
    check_gn_census(torch, ops, dev, vq_census, label="ldm", batch=LDM_VQ_BATCH, eps=1e-6,
                    dtypes=("float32",), library=True, what="VQ-VAE encode and decode")
    check_plain_route(torch, F, ops, dev)

    outdir = os.path.join(root, "ldm")
    # train_vqvae: each step an encode and a decode, forward and backward.
    vq_out, vq_wall, counts, routes, peak = timed(train_vqvae.main, [
        "--dataset", "celeba", "--outdir", outdir, "--training_steps", str(LDM_VQ_STEPS),
        "--batch_size", str(LDM_VQ_BATCH), "--log_freq", "1", "--device", "cuda"])
    weights = vq_out["weights_out"]
    log(f"[ldm] train_vqvae celeba full VQVAESpec {LDM_VQ_STEPS} steps at batch "
        f"{LDM_VQ_BATCH} f32 on {card}: {vq_out['train_seconds']:.3f} s "
        f"({vq_out['train_seconds'] / LDM_VQ_STEPS:.4f} s a step, the first with warm-up), "
        f"call {vq_wall:.3f} s, peak {peak:.2f} GiB; loss {vq_out['loss']:.5f}, recon "
        f"{vq_out['recon']:.5f}, perplexity {vq_out['perplexity']:.2f}")
    expect("train_vqvae", counts, routes,
           model_counts(0, n_enc + n_dec, LDM_VQ_STEPS, LDM_VQ_STEPS),
           {"attention_plain_fwd": 2 * LDM_VQ_STEPS, "attention_plain_bwd": 2 * LDM_VQ_STEPS})
    if not (math.isfinite(vq_out["loss"]) and os.path.exists(weights)):
        raise AssertionError(f"train_vqvae: loss {vq_out['loss']}, weights {weights}")
    total = counts

    # shapley_pipeline: the first call encodes the stand-in (LDM_IMAGES / 32
    # batches), every other call reads the cache.
    members = LDM_FIT + LDM_TEST + 2
    steps = (LDM_FIT + LDM_TEST + 1) * LDM_STEPS  # member-steps
    # Each train_ensemble call stacks its members (the default --chunk_size at
    # most): one forward and backward a step for all of them.
    chunk = train_ensemble.MEMBERS_PER_CALL
    calls = -(-LDM_FIT // chunk) + -(-LDM_TEST // chunk) + 1
    r, p_wall, counts, routes, peak = timed(shapley_pipeline.main, [
        "--dataset", "celeba", "--by_class", "--fit_dist", "shapley", "--removal_seed", "0",
        "--num_fit_subsets", str(LDM_FIT), "--num_test_subsets", str(LDM_TEST),
        "--test_seed_start", str(PIPE_TEST_SEED), "--training_steps", str(LDM_STEPS),
        "--batch_size", str(LDM_BATCH), "--behavior", "eval_loss",
        "--vqvae_weights", weights, "--device", "cuda", "--outdir", outdir])
    enc_counts, enc_routes = encodes(LDM_IMAGES // 32)
    sec, row = r["seconds"], r["row"]
    resid = abs(r["attrs"].sum() - (r["v1"] - r["v0"]))
    limit = EFFICIENCY_RTOL * max(1.0, abs(r["v1"] - r["v0"]))
    cache = os.path.join(outdir, "celeba", "precomputed_emb", "vqvae_latents.npy")
    log(f"[ldm] shapley_pipeline celeba by celebrity f32 on {card}: {row['num_fit_subsets']} "
        f"fit and {row['num_test_subsets']} test subsets x {LDM_STEPS} steps at batch "
        f"{LDM_BATCH}, two anchors; training {sec['train']:.3f} s ({steps} member-steps, "
        f"{steps / sec['train']:.4f} member-steps/s, {sec['train'] / steps:.4f} s a "
        f"member-step), encode {sec['encode']:.3f} s (one encode of {LDM_IMAGES} images, "
        f"then the cache {np.load(cache).shape}), pipeline clock {r['train_seconds']:.3f} s, "
        f"subset_passes_per_hour {row['subset_passes_per_hour']}, call {p_wall:.3f} s, peak "
        f"{peak:.2f} GiB; v1 {r['v1']:.6f}, v0 {r['v0']:.6f}, efficiency residual "
        f"{resid:.3g} (limit {limit:.3g})")
    expect("shapley_pipeline", counts, routes,
           add_counts(model_counts(n_attn, n_gn, calls * LDM_STEPS + members,
                                   calls * LDM_STEPS), enc_counts),
           enc_routes)
    if not (r["attrs"].shape == (len(LDM_IDS),) and np.isfinite(r["attrs"]).all()
            and resid <= limit and np.isfinite(r["y_fit"]).all()):
        raise AssertionError(f"ldm pipeline: attributions {r['attrs']}")
    total = add_counts(total, counts)

    # generate_samples from the full anchor, decoded to 256x256 PNGs.
    full = os.path.join(outdir, "celeba", "retrain", "models", "full")
    pngs_dir = os.path.join(outdir, "samples")
    g, g_wall, counts, routes, peak = timed(generate_samples.main, [
        "--dataset", "celeba", "--load", full, "--sample_outdir", pngs_dir,
        "--n_samples", str(LDM_SAMPLES), "--batch_size", str(LDM_SAMPLES),
        "--num_inference_steps", str(LDM_SAMPLE_STEPS), "--vqvae_weights", weights,
        "--device", "cuda"])
    dec_counts, dec_routes = decodes(1)
    expect("generate_samples", counts, routes,
           add_counts(model_counts(n_attn, n_gn, LDM_SAMPLE_STEPS), dec_counts), dec_routes)
    total = add_counts(total, counts)
    pngs = sorted(n for n in os.listdir(pngs_dir) if n.endswith(".png"))
    imgs = np.stack([np.asarray(Image.open(os.path.join(pngs_dir, n))) for n in pngs])
    distinct = len({im.tobytes() for im in imgs})
    vq_card = load_vqvae(vq, weights, device=dev)
    latents = torch.randn(LDM_SAMPLES, 3, 64, 64, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(15))
    with torch.no_grad():
        decode_ms = cuda_ms(torch, lambda: vq_card.decode(latents), iters=3)
    log(f"[ldm] generate_samples {LDM_SAMPLES} images x {LDM_SAMPLE_STEPS} DDIM steps + VQ "
        f"decode f32 on {card}: {g['batch_seconds'][0]:.3f} s the batch (decode of "
        f"{LDM_SAMPLES} latents {decode_ms / 1e3:.3f} s of it, timed apart), call "
        f"{g_wall:.3f} s, peak {peak:.2f} GiB; {len(pngs)} PNGs {imgs.shape[1:]}, {distinct} "
        f"distinct, mean {imgs.mean():.2f}, std {imgs.std():.2f}")
    if not (len(pngs) == LDM_SAMPLES and imgs.shape[1:] == (256, 256, 3)
            and distinct == LDM_SAMPLES):
        raise AssertionError("generate_samples did not write distinct 256x256 RGB PNGs")

    # Reference: sampling, decode and encode -> quantize, card against CPU.
    ck = load_checkpoint(full)
    models = {}
    for device in ("cpu", dev):
        m = UNet2D(spec)
        m.load_state_dict(ck["ema_params"])
        models[str(device)] = (m.to(device).eval(), load_vqvae(vq, weights, quiet=True,
                                                                device=device))
    noise = torch.from_numpy(np.random.default_rng(16).standard_normal(
        (1, 3, 64, 64)).astype(np.float32))
    got = {}
    for device, (m, v) in models.items():
        seen = []
        decode = make_vq_decode_fn(vq, vqvae=v)

        def capture(z, decode=decode, seen=seen):
            seen.append(z.clone())
            return decode(z)

        imgs_ = make_sampler(m, cfg.scheduler, (1, 3, 64, 64), device=device,
                             num_inference_steps=LDM_REF_STEPS, decode_fn=capture)(
            init_noise=noise)
        got[device] = (seen[0].cpu(), imgs_.cpu())
    (z_cpu, img_cpu), (z_card, img_card) = got["cpu"], got[str(dev)]
    v_cpu, v_card = models["cpu"][1], models[str(dev)][1]
    with torch.no_grad():
        codes_cpu = v_cpu.quantize(z_cpu)[1]
        codes_card = v_card.quantize(z_card.to(dev))[1].cpu()
        same_in = v_card.decode(z_cpu.to(dev)).cpu()
        want_in = v_cpu.decode(z_cpu)
        x = torch.from_numpy(create_dataset("celeba").images[:1]).permute(0, 3, 1, 2)
        e_cpu, e_card = v_cpu.encode(x), v_card.encode(x.to(dev)).cpu()
        q_cpu, q_card = v_cpu.quantize(e_cpu)[1], v_card.quantize(e_card.to(dev))[1].cpu()
    lat_err = (z_card - z_cpu).abs().max().item()
    agree = (codes_card == codes_cpu).float().mean().item()
    img_err = (img_card - img_cpu).abs().max().item()
    dec_err = ((same_in / 2 + 0.5).clamp(0, 1) - (want_in / 2 + 0.5).clamp(0, 1)).abs().max()
    enc_err = (e_card - e_cpu).abs().max().item()
    enc_agree = (q_card == q_cpu).float().mean().item()
    log(f"[ldm] reference batch 1, card vs CPU (f32, TF32 off): {LDM_REF_STEPS} DDIM steps of "
        f"the full anchor: latents max_abs_err={lat_err:.3g} (tol {LDM_LATENT_ATOL}); their "
        f"codes agree at {agree:.6f} of 4096 positions ({int((1 - agree) * 4096)} differ); "
        f"the sampler's decoded images max_abs_err={img_err:.3g} (tol {LDM_DECODE_ATOL} when "
        f"the codes agree); the decoder on the same latents max_abs_err={dec_err.item():.3g} "
        f"(tol {LDM_DECODE_ATOL}); encode of a stand-in image max_abs_err={enc_err:.3g} (tol "
        f"{LDM_ENCODE_ATOL}), its codes agree at {enc_agree:.6f} "
        f"({int(round((1 - enc_agree) * 4096))} of 4096 differ; at least "
        f"{LDM_CODE_AGREEMENT} required)")
    if not (lat_err <= LDM_LATENT_ATOL and dec_err <= LDM_DECODE_ATOL
            and enc_err <= LDM_ENCODE_ATOL and enc_agree >= LDM_CODE_AGREEMENT
            and agree >= LDM_CODE_AGREEMENT and (agree < 1 or img_err <= LDM_DECODE_ATOL)
            and torch.isfinite(img_card).all()):
        raise AssertionError("the latent path on the card disagrees with the CPU")
    del models, vq_card, ck
    torch.cuda.empty_cache()

    # Diversity entropy with the full random BLIP tower (its seeded weights
    # saved as an HF state dict, the --blip_weights route).
    blip_path = os.path.join(outdir, "blip_random.pt")
    torch.save(load_blip_vision(device="cpu").state_dict(), blip_path)
    d, d_wall, counts, routes, peak = timed(calculate_global_scores_diversity.main, [
        "--dataset", "celeba", "--load", full, "--n_samples", str(LDM_DIV_SAMPLES),
        "--batch_size", str(LDM_DIV_SAMPLES), "--num_inference_steps", str(LDM_DIV_STEPS),
        "--num_clusters", str(LDM_CLUSTERS), "--blip_weights", blip_path,
        "--vqvae_weights", weights, "--outdir", outdir, "--device", "cuda"])
    ds = d["seconds"]
    log(f"[ldm] calculate_global_scores_diversity on the full anchor f32 on {card}: "
        f"{LDM_DIV_SAMPLES} samples x {LDM_DIV_STEPS} DDIM steps + decode {ds['sampling']:.3f} "
        f"s, BLIP tower (full, random) on {LDM_DIV_SAMPLES} + {4 * LDM_DIV_SAMPLES} reference "
        f"images {ds['tower']:.3f} s, Ward clustering into {LDM_CLUSTERS} "
        f"{ds['clustering']:.4f} s; call {d_wall:.3f} s, peak {peak:.2f} GiB; entropy "
        f"{d['entropy']:.6f}, counts {[int(c) for c in d['cluster_count']]}")
    expect("calculate_global_scores_diversity", counts, routes,
           add_counts(model_counts(n_attn, n_gn, LDM_DIV_STEPS), dec_counts), dec_routes)
    if not (math.isfinite(d["entropy"]) and len(d["cluster_count"]) == LDM_CLUSTERS
            and sum(d["cluster_count"]) == LDM_DIV_SAMPLES):
        raise AssertionError(f"diversity: {d['entropy']}, {d['cluster_count']}")
    total = add_counts(total, counts)

    # --remat --remat_policy convs (what the JAX package's CelebA runs use):
    # one member on all the data, from the same seeds with and without it.
    # The recompute reruns every block's GroupNorms (all but conv_norm_out)
    # and attention forward; the 3x3 convolutions' outputs are kept.
    runs = {}
    for tag, extra in (("no remat", []), ("remat convs", ["--remat", "--remat_policy", "convs"])):
        run_dir = os.path.join(outdir, tag.replace(" ", "_"))
        os.makedirs(os.path.join(run_dir, "celeba", "precomputed_emb"))
        shutil.copy(cache, os.path.join(run_dir, "celeba", "precomputed_emb"))
        t, t_wall, counts, routes, peak = timed(train_ensemble.main, [
            "--dataset", "celeba", "--removal_dist", "full", "--num_seeds", "1",
            "--training_steps", str(LDM_STEPS), "--batch_size", str(LDM_BATCH),
            "--vqvae_weights", weights, "--outdir", run_dir, "--device", "cuda", *extra])
        remat = bool(extra)
        want = model_counts(n_attn, n_gn, LDM_STEPS, LDM_STEPS)
        if remat:
            want = add_counts(want, model_counts(n_attn, n_gn - 1, LDM_STEPS))
        log(f"[ldm] train_ensemble celeba 1 member x {LDM_STEPS} steps at batch {LDM_BATCH}, "
            f"{tag}: {t['train_seconds'] / LDM_STEPS:.4f} s a step (the first with warm-up), "
            f"peak {peak:.2f} GiB, call {t_wall:.3f} s")
        expect(f"train_ensemble {tag}", counts, routes, want,
               {"attention_plain_fwd": 0, "attention_plain_bwd": 0})
        runs[tag] = load_checkpoint(t["model_dirs"][0])["params"]
        total = add_counts(total, counts)
    a, b = runs.values()
    same = all(torch.equal(a[k], b[k]) for k in a)
    log(f"[ldm] remat convs against no remat: weights after {LDM_STEPS} steps bitwise "
        f"equal={same}")
    if not same:
        raise AssertionError("--remat_policy convs trained other weights than no remat")
    return total


def tti_counts(n_attn: int, n_gn: int, n_gn_bwd: int, forwards: int, backwards: int = 0) -> dict:
    """Kernel launches of a U-Net with `n_attn` attention calls and `n_gn`
    GroupNorms a forward, `n_gn_bwd` of which run a backward."""
    return {"attention_fwd": n_attn * forwards, "attention_bwd_dq": n_attn * backwards,
            "attention_bwd_dkv": n_attn * backwards, "group_norm_fwd": n_gn * forwards,
            "group_norm_bwd": n_gn_bwd * backwards, "jl_projection": 0}


def meta_copy(torch, cls, module, *args):
    """A CPU `cls(*args)` holding `module`'s parameters and buffers (no init)."""
    with torch.device("meta"):
        copy = cls(*args)
    copy.load_state_dict({k: v.cpu() for k, v in module.state_dict().items()}, assign=True)
    return copy.eval()


def check_tti(torch, np, ops, root: str, card: str, dev) -> dict:
    """The text-to-image tier at full miniSD width (the 860M U-Net, CLIP
    ViT-L/14's text tower, the KL VAE, rank-256 LoRA; seeded random towers)
    on the ArtBench-style stand-in: the kernels at its shapes, then its main
    paths between counter resets and reads, launches reckoned from the specs:
    train_text_to_image_lora (2 members, latents encoded once), prune_lora,
    sparse fine-tunes of the pruned LoRA (the cache reused),
    generate_samples_tti (and its resume); then a card-vs-CPU reference of
    sampling, the text tower, the KL VAE and per-sample LoRA gradients; the
    CLIP vision tower and aesthetic head; and the scoring loop
    (`check_tti_scoring`). Returns the summed launches."""
    import torch.nn.functional as F
    from PIL import Image
    from torch.func import functional_call

    from group_attribution_for_diffusion_models_tpu_torch.cli import (
        generate_samples_tti, prune_lora, train_text_to_image_lora)
    from group_attribution_for_diffusion_models_tpu_torch.config.registry import (
        MINISD_SCHEDULER, MINISD_UNET, MINISD_VAE, PROMPTS_ARTBENCH)
    from group_attribution_for_diffusion_models_tpu_torch.data import create_dataset
    from group_attribution_for_diffusion_models_tpu_torch.diffusion import make_sampler
    from group_attribution_for_diffusion_models_tpu_torch.models import UNet2D, build_unet
    from group_attribution_for_diffusion_models_tpu_torch.models.clip_text import (
        CLIPTextEncoder, load_clip_text, load_tokenizer)
    from group_attribution_for_diffusion_models_tpu_torch.models.layers import (
        CrossAttention, GroupNormSiLU, SpatialTransformer)
    from group_attribution_for_diffusion_models_tpu_torch.models.lora import (
        load_lora_npz, lora_collection, lora_ranks, target_modules)
    from group_attribution_for_diffusion_models_tpu_torch.models.vqvae import (
        AutoencoderKL, load_sd_vae, precompute_latents)

    spec, vae_spec = MINISD_UNET, MINISD_VAE
    with torch.device("meta"):
        unet, vae, text = UNet2D(spec), AutoencoderKL(vae_spec), CLIPTextEncoder()
    n_attn = sum(isinstance(m, CrossAttention) for m in unet.modules())
    n_xf = sum(isinstance(m, SpatialTransformer) for m in unet.modules())
    n_gn = sum(isinstance(m, GroupNormSiLU) for m in unet.modules())
    n_enc = sum(isinstance(m, GroupNormSiLU) for m in vae.encoder.modules())
    n_dec = sum(isinstance(m, GroupNormSiLU) for m in vae.decoder.modules())
    counts_of = {name: sum(p.numel() for p in m.parameters())
                 for name, m in (("unet", unet), ("text", text), ("vae", vae))}
    targets = target_modules(unet)
    lora_params = sum(min(TTI_RANK, m.in_features, m.out_features)
                      * (m.in_features + m.out_features) for _, m in targets)
    # LoRA training: nothing before down block 0's first LoRA'd projection
    # needs a gradient, so its first resnet's two GroupNorms and its first
    # transformer's GroupNorm run no backward; every later one does.
    n_gn_bwd = n_gn - 3
    log(f"[tti] miniSD U-Net {counts_of['unet']} params, {n_xf} transformers ({n_attn} "
        f"attention calls a forward), {n_gn} GroupNorms a forward ({n_gn_bwd} with a backward "
        f"in LoRA training); CLIP text tower {counts_of['text']} params; KL VAE "
        f"{counts_of['vae']} params, GroupNorms encoder {n_enc}, decoder {n_dec}, one mid "
        f"attention each (D=512, the plain route); rank-{TTI_RANK} LoRA {lora_params} params "
        f"in {len(targets)} pairs")
    if (counts_of["unet"], n_attn, counts_of["text"], counts_of["vae"], lora_params) != (
            859_520_964, 32, 123_060_480, 83_653_863, 51_019_776):
        raise AssertionError("the miniSD towers do not have the published sizes")
    del unet, vae, text

    # Kernels at the tier's shapes, f32 (the tier's dtype).
    unet_census = gn_census_of(torch, spec, device=dev)
    enc_census, dec_census = kl_gn_census(torch, vae_spec, dev)
    if (sum(n for *_, n in unet_census) != n_gn or sum(n for *_, n in enc_census) != n_enc
            or sum(n for *_, n in dec_census) != n_dec):
        raise AssertionError("the census helpers disagree with the models' GroupNorms")
    log(f"[tti] GroupNorm shapes (C, H, W, silu, launches): U-Net {unet_census}; KL encoder "
        f"{enc_census}; KL decoder {dec_census}")
    check_attention(torch, F, ops, dev, TTI_ATTN_SHAPES, [], "tti", dtypes=("float32",))
    check_attention_bwd(torch, F, ops, dev, TTI_ATTN_SHAPES, [], "tti", dtypes=("float32",))
    check_gn_census(torch, ops, dev, unet_census, label="tti", batch=TTI_BATCH,
                    eps=spec.norm_eps, dtypes=("float32",), library=True,
                    what="miniSD U-Net pass")
    check_gn_census(torch, ops, dev, enc_census, label="tti", batch=TTI_ENCODE_BATCH, eps=1e-6,
                    dtypes=("float32",), library=True, what="KL encode")
    check_gn_census(torch, ops, dev, dec_census, label="tti", batch=KL_DECODE_BATCH, eps=1e-6,
                    dtypes=("float32",), library=True, what="KL decode")
    check_plain_route(torch, F, ops, dev, "tti", KL_ATTN_SHAPES, backward=False,
                      what="the KL encoder's mid attention")

    def timed(fn, argv):
        return timed_call(torch, ops, fn, argv)

    no_route = {"attention_plain_fwd": 0, "attention_plain_bwd": 0}
    outdir = os.path.join(root, "tti")
    common = ["--dataset", "imagenette", "--outdir", outdir, "--removal_dist", "datamodel",
              "--max_train_steps", str(TTI_STEPS), "--train_batch_size", str(TTI_BATCH),
              "--rank", str(TTI_RANK), "--log_freq", "1", "--device", "cuda"]
    images = TTI_ARTISTS * TTI_PER_ARTIST
    encodes = -(-images // TTI_ENCODE_BATCH)
    sums = ops.group_norm_silu.affine_sums
    r, wall, counts, routes, peak = timed(train_text_to_image_lora.main,
                                          common + ["--num_seeds", str(TTI_MEMBERS)])
    steps = TTI_MEMBERS * TTI_STEPS  # member-steps, stacked: TTI_STEPS launches a site
    sec, step_s = r["seconds"], r["step_seconds"]
    warm = sum(step_s[1:]) / (len(step_s) - 1) / TTI_MEMBERS
    cache = os.path.join(outdir, "precomputed_emb", "vae_latents.npy")
    log(f"[tti] train_text_to_image_lora imagenette (ArtBench-style stand-in, {images} images, "
        f"{TTI_ARTISTS} artists) full miniSD width f32 on {card}: {TTI_MEMBERS} datamodel "
        f"members x {TTI_STEPS} steps, subsets {r['subset_sizes']} images, effective batch "
        f"{r['batch']}" + ("" if r["batch"] == TTI_BATCH else
                           f" (under {TTI_BATCH}: the smallest subset bounds it)")
        + f", rank {TTI_RANK} ({r['lora_params']} LoRA params a member); towers "
        f"{sec['towers']:.3f} s, VAE encode of {images} images {sec['latents']:.3f} s (cache "
        f"{np.load(cache).shape}), caption embedding {sec['embed']:.3f} s, training "
        f"{sec['train']:.3f} s ({steps} member-steps; step seconds "
        f"{[round(x, 4) for x in step_s]}, warm {warm:.4f} s a member-step = "
        f"{1 / warm:.4f} member-steps/s); call {wall:.3f} s, peak {peak:.2f} GiB; losses "
        f"{r['losses']}; GroupNorm affine reductions {ops.group_norm_silu.affine_sums - sums}")
    want = add_counts(tti_counts(n_attn, n_gn, n_gn_bwd, TTI_STEPS, TTI_STEPS),
                      tti_counts(0, n_enc, 0, encodes))
    expect("train_text_to_image_lora", counts, routes, want,
           {"attention_plain_fwd": encodes, "attention_plain_bwd": 0}, phase="tti")
    rows = [json.loads(line) for line in open(r["db"])]
    if not (r["latents_cached"] is False and os.path.exists(cache)
            and all(math.isfinite(x) for x in r["losses"]) and len(rows) == TTI_MEMBERS
            and all(os.path.exists(p) for p in r["lora_paths"]) and len(r["lora_paths"]) == 2
            and ops.group_norm_silu.affine_sums == sums):
        raise AssertionError(f"train_text_to_image_lora: {r}")
    total = counts
    # The encode alone, for its own peak: the trainer's precompute on the stand-in.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        precompute_latents(load_sd_vae(vae_spec, device=dev, quiet=True),
                           create_dataset("imagenette").images)
    torch.cuda.synchronize()
    log(f"[tti] the KL encode of the stand-in alone (load, decode of the PNGs, {encodes} "
        f"batches of {TTI_ENCODE_BATCH}): {time.perf_counter() - t0:.3f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    pruned = os.path.join(outdir, "pruned", "lora_weights.npz")
    t0 = time.perf_counter()
    p = prune_lora.main(["--lora_dir", r["lora_paths"][0], "--pruning_ratio",
                         str(TTI_PRUNE_RATIO), "--save_path", pruned])
    prune_s = time.perf_counter() - t0
    with open(p["info"]) as f:
        info = f.read().splitlines()[1].split(",")
    ranks = sorted(set(p["ranks"].values()))
    log(f"[tti] prune_lora ratio {TTI_PRUNE_RATIO} on member {r['seeds'][0]}: "
        f"{p['params_before']} -> {p['params_after']} params, info.csv actual ratio {info[2]}, "
        f"ranks {ranks[0]}..{ranks[-1]} ({len(ranks)} distinct), {prune_s:.3f} s")
    if not (abs(float(info[2]) - TTI_PRUNE_RATIO) < 1e-3 and len(ranks) > 1):
        raise AssertionError(f"prune_lora: ratio {info[2]}, ranks {ranks}")

    # Sparse fine-tuning of the pruned LoRA on shapley subsets, whose scores
    # shapley_convergence holds against the retrained members'.
    f_out, f_wall, counts, routes, peak = timed(train_text_to_image_lora.main, common + [
        "--num_seeds", str(TTI_FT_MEMBERS), "--removal_dist", "shapley", "--method",
        "pruned_ft", "--lora_dir", pruned])
    f_step = f_out["step_seconds"]
    log(f"[tti] train_text_to_image_lora --method pruned_ft --lora_dir <pruned> "
        f"{TTI_FT_MEMBERS} shapley members x {TTI_STEPS} steps at batch {f_out['batch']} "
        f"({f_out['lora_params']} LoRA params): latents from the cache="
        f"{f_out['latents_cached']}, training {f_out['train_seconds']:.3f} s (step seconds "
        f"{[round(x, 4) for x in f_step]}, {f_step[-1] / TTI_FT_MEMBERS:.4f} s a member-step), "
        f"call {f_wall:.3f} s, peak {peak:.2f} GiB, losses {f_out['losses']}")
    expect("pruned_ft", counts, routes,
           tti_counts(n_attn, n_gn, n_gn_bwd, TTI_STEPS, TTI_STEPS), no_route, phase="tti")
    if not (f_out["latents_cached"] and f_out["batch"] == TTI_BATCH
            and all(lora_ranks(load_lora_npz(path)) == p["ranks"] for path in f_out["lora_paths"])
            and all(math.isfinite(x) for x in f_out["losses"])
            and ops.group_norm_silu.affine_sums == sums):
        raise AssertionError(f"pruned_ft: {f_out}")
    total = add_counts(total, counts)

    samples = os.path.join(outdir, "samples")
    argv = ["--dataset", "imagenette", "--lora_dir", r["lora_paths"][0], "--sample_outdir",
            samples, "--n_samples_per_style", str(TTI_SAMPLES), "--batch_size",
            str(TTI_SAMPLES), "--num_inference_steps", str(TTI_SAMPLE_STEPS), "--device", "cuda"]
    g, g_wall, counts, routes, peak = timed(generate_samples_tti.main, argv)
    expect("generate_samples_tti", counts, routes,
           tti_counts(n_attn, n_gn, 0, TTI_SAMPLE_STEPS), no_route, phase="tti")
    total = add_counts(total, counts)
    imgs = np.stack([np.asarray(Image.open(path)) for path in g["written"]])
    distinct = len({im.tobytes() for im in imgs})
    again, _, counts2, routes2, _ = timed(generate_samples_tti.main, argv)
    log(f"[tti] generate_samples_tti {TTI_SAMPLES} images x {TTI_SAMPLE_STEPS} DDIM steps "
        f"(one batch, prompt-conditioned, LoRA merged) f32 on {card}: "
        f"{g['batch_seconds'][0]:.3f} s the batch ({TTI_SAMPLES / g['batch_seconds'][0]:.4f} "
        f"images/s), call {g_wall:.3f} s, peak {peak:.2f} GiB; {len(imgs)} PNGs "
        f"{imgs.shape[1:]}, {distinct} distinct; a second call wrote {len(again['written'])} "
        f"with launches {counts2}")
    if not (len(imgs) == TTI_SAMPLES and distinct == TTI_SAMPLES and imgs.shape[1:] == (32, 32, 3)
            and not again["written"] and not any(counts2.values()) and not any(routes2.values())):
        raise AssertionError("generate_samples_tti did not write 16 distinct PNGs once")

    # Reference: the same weights and noise on the card and on the CPU.
    base = build_unet(spec, seed=42, device=dev).eval()  # the CLIs' random base (--seed 42)
    models = {"cpu": meta_copy(torch, UNet2D, base, spec), str(dev): base}
    text_card = load_clip_text(None, device=dev, quiet=True)
    text_cpu = meta_copy(torch, CLIPTextEncoder, text_card)
    ids = torch.from_numpy(load_tokenizer()([PROMPTS_ARTBENCH["post_impressionism"],
                                             "a Post-Impressionist painting by painter-03"]))
    with torch.no_grad():
        e_cpu, e_card = text_cpu(ids.long()), text_card(ids.long().to(dev)).cpu()
    text_err = (e_card - e_cpu).abs().max().item()
    noise = torch.from_numpy(np.random.default_rng(17).standard_normal(
        (1, 4, 32, 32)).astype(np.float32))
    got = {}
    for device, m in models.items():
        buffers = lora_collection(load_lora_npz(r["lora_paths"][0], device))
        seen = []

        def eps(x, t, c, m=m, buffers=buffers):
            return functional_call(m, buffers, (x, t, c))

        make_sampler(eps, MINISD_SCHEDULER, (1, 4, 32, 32), device=device,
                     num_inference_steps=TTI_REF_STEPS, decode_fn=lambda z, seen=seen: (
                         seen.append(z.cpu()) or z), encoder_hidden_states=e_cpu[:1])(
            init_noise=noise)
        got[device] = seen[0]
    lat_err = (got[str(dev)] - got["cpu"]).abs().max().item()
    vae_card = load_sd_vae(vae_spec, device=dev, quiet=True)
    vae_cpu = meta_copy(torch, AutoencoderKL, vae_card, vae_spec)
    first = sorted(os.listdir(os.path.join(os.environ["GADM_DATASET_DIR"], "imagenette2",
                                           "train")))[0]
    x = np.asarray(Image.open(os.path.join(os.environ["GADM_DATASET_DIR"], "imagenette2",
                                           "train", first)), np.float32)
    x = torch.from_numpy((x / 255.0 - 0.5) / 0.5).permute(2, 0, 1)[None].contiguous()
    with torch.no_grad():
        z_cpu, z_card = vae_cpu.encode(x), vae_card.encode(x.to(dev)).cpu()
        d_cpu, d_card = vae_cpu.decode(z_cpu), vae_card.decode(z_cpu.to(dev)).cpu()
    enc_err = (z_card - z_cpu).abs().max().item()
    dec_err = ((d_card / 2 + 0.5).clamp(0, 1) - (d_cpu / 2 + 0.5).clamp(0, 1)).abs().max().item()
    log(f"[tti] reference batch 1, card vs CPU (f32, TF32 off), the same weights and noise: "
        f"{TTI_REF_STEPS} DDIM steps of the LoRA'd base with a CLIP context: latents "
        f"max_abs_err={lat_err:.3g} (tol {TTI_LATENT_ATOL}), |latents|max "
        f"{got['cpu'].abs().max().item():.3g}; CLIP text tower on 2 prompts "
        f"max_abs_err={text_err:.3g} (tol {TTI_TEXT_ATOL}); KL encode of a stand-in image "
        f"max_abs_err={enc_err:.3g} (tol {TTI_ENCODE_ATOL}), decode of those latents "
        f"max_abs_err={dec_err:.3g} on [0, 1] (tol {TTI_DECODE_ATOL})")
    if not (lat_err <= TTI_LATENT_ATOL and text_err <= TTI_TEXT_ATOL
            and enc_err <= TTI_ENCODE_ATOL and dec_err <= TTI_DECODE_ATOL
            and torch.isfinite(got[str(dev)]).all()):
        raise AssertionError("the text-to-image towers on the card disagree with the CPU")
    check_lora_gradients(torch, np, ops, models, r["lora_paths"][0], e_cpu, dev,
                         tti_counts(n_attn, n_gn, n_gn_bwd, 1, 1))
    del models, base, text_card, vae_card
    torch.cuda.empty_cache()
    check_vmapped_attention(torch, F, ops, dev, card)
    check_clip_vision(torch, np, dev, card)
    shape_counts = dict(n_attn=n_attn, n_gn=n_gn, n_gn_bwd=n_gn_bwd, n_dec=n_dec)
    return add_counts(total, check_tti_scoring(torch, np, ops, outdir, card, common, timed,
                                               shape_counts, r))



def check_lora_gradients(torch, np, ops, models: dict, lora_path: str, contexts, dev,
                         want_counts: dict) -> None:
    """Per-sample LoRA gradients of the full-width miniSD U-Net (the LoRA
    factors alone, the base fixed) for 2 samples, each with its own text
    context, at one timestep, through vmap(grad): card against CPU (the
    kernels under their vmap rules against the plain versions), one launch
    of each kernel for both samples, no GroupNorm gamma/beta reduction; then
    one timestep at grad_features_tti's batch timed by events and by the
    profiler's device time."""
    from group_attribution_for_diffusion_models_tpu_torch.attributions.methods.trak import (
        PerSampleGradients)
    from group_attribution_for_diffusion_models_tpu_torch.diffusion import (
        add_noise, make_schedule)
    from group_attribution_for_diffusion_models_tpu_torch.config.registry import (
        MINISD_SCHEDULER)
    from group_attribution_for_diffusion_models_tpu_torch.models.lora import load_lora_npz

    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal((2, 4, 32, 32)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((2, 4, 32, 32)).astype(np.float32))
    t = torch.tensor([400, 400])
    got = {}
    for device, model in models.items():
        grads = PerSampleGradients(model, lora=load_lora_npz(lora_path, device),
                                   conditional=True)
        acc = torch.zeros((2, grads.dim), device=device)
        schedule = make_schedule(MINISD_SCHEDULER, device)
        xx, nn_, tt = x.to(device), noise.to(device), t.to(device)
        sums = ops.group_norm_silu.affine_sums
        reset_counts(ops)
        grads.accumulate(acc, add_noise(schedule, xx, nn_, tt), tt, nn_,
                         contexts.to(device))
        if device != "cpu":
            torch.cuda.synchronize()
            counts = ops.launch_counts()
        got[device] = acc.cpu()
    want, card = got["cpu"], got[str(dev)]
    err = ((card - want).abs().amax(dim=1) / want.abs().amax(dim=1)).max().item()
    affine = ops.group_norm_silu.affine_sums - sums
    log(f"[tti] per-sample LoRA gradients ({card.shape[1]} coordinates, JAX leaf order) of "
        f"2 samples with their own contexts, one timestep, card vs CPU (f32, TF32 off): "
        f"max |dg| / max |g| {err:.3g} (tol {TRAIN_STEP_RTOL}); card launches {counts} "
        f"(expected {want_counts}); GroupNorm affine reductions {affine}")
    if not (err <= TRAIN_STEP_RTOL and counts == want_counts and affine == 0):
        raise AssertionError("per-sample LoRA gradients on the card disagree with the CPU")
    # One timestep of grad_features_tti's batch on the card: event time of the
    # vmap(grad) call against its kernels' device time (the device's idle share).
    model = models[str(dev)]
    grads = PerSampleGradients(model, lora=load_lora_npz(lora_path, dev), conditional=True)
    g = torch.Generator(device=dev).manual_seed(22)
    xb, nb = (torch.randn(TTI_TRAK_BATCH, 4, 32, 32, generator=g, device=dev) for _ in range(2))
    tb = torch.full((TTI_TRAK_BATCH,), 400, device=dev)
    ctx = contexts.to(dev)[torch.arange(TTI_TRAK_BATCH, device=dev) % len(contexts)]
    acc = torch.zeros((TTI_TRAK_BATCH, grads.dim), device=dev)

    def step():
        grads.accumulate(acc, xb, tb, nb, ctx)

    ev, dv = cuda_ms(torch, step, iters=3), device_ms(torch, step, iters=2)
    log(f"[tti] one timestep of per-sample LoRA gradients at batch {TTI_TRAK_BATCH} (vmap(grad), "
        f"a context each) on the card: {ev:.1f} ms event, {dv:.1f} ms device, idle share "
        f"{1 - dv / ev:.3f}")
    del grads, acc



def check_vmapped_attention(torch, F, ops, dev, card: str) -> None:
    """The cross-attention under vmap(grad) with a context (K, V) of 77
    tokens for each of TTI_TRAK_BATCH samples, at miniSD's four levels: the
    vmap rules fold the samples into one forward and one launch of each
    backward pass; the gradients against the plain versions on the folded
    tensors (TOL); the vmap(grad) call event-timed and its kernels' device
    time by the profiler, beside the plain forward and backward on the
    folded tensors, SDPA's forward and autograd backward, and the bound
    (4 + 10 units of B*H*Sq*Skv*D FLOPs at the tensor cores' rate, or q, k,
    v, o, do, dq, dk, dv once)."""
    from torch.func import grad, vmap

    b = TTI_TRAK_BATCH
    for sq, h, d in TTI_VMAP_ATTN:
        g = torch.Generator(device=dev).manual_seed(4)
        q, w = (torch.randn(b, 1, sq, h, d, generator=g, device=dev) for _ in range(2))
        k, v = (torch.randn(b, 1, 77, h, d, generator=g, device=dev) for _ in range(2))

        def f(q1, k1, v1, w1):
            return (ops.dot_product_attention(q1, k1, v1) * w1).sum()

        per_sample = vmap(grad(f, argnums=(0, 1, 2)))
        reset_counts(ops)
        got = per_sample(q, k, v, w)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        qf, kf, vf, wf = (t.reshape(-1, *t.shape[2:]) for t in (q, k, v, w))
        want = ops.attention_bwd_plain(qf, kf, vf, wf)
        cmp = [compare(a.reshape(-1, *a.shape[2:]), e, "float32") for a, e in zip(got, want)]
        ms = cuda_ms(torch, lambda: per_sample(q, k, v, w), iters=5)
        dev_ms = device_ms(torch, lambda: per_sample(q, k, v, w), iters=5)
        plain_ms = cuda_ms(torch, lambda: (ops.attention_plain(qf, kf, vf),
                                           ops.attention_bwd_plain(qf, kf, vf, wf)), iters=5)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (qf, kf, vf))

        def sdpa():
            out = F.scaled_dot_product_attention(qt, kt, vt)
            return torch.autograd.grad(out, (qt, kt, vt), wf.transpose(1, 2))

        lib_ms = cuda_ms(torch, sdpa, iters=5)
        unit = b * h * sq * 77 * d
        bms, by = bound((4 * sq + 4 * 77) * b * h * d * 4, 14.0 * unit, "float32", TC_FLOPS)
        log(f"[tti] vmapped cross-attention B={b} (one context each) Sq={sq} Skv=77 H={h} "
            f"D={d} float32, forward and backward under vmap(grad): max_abs_err dq="
            f"{cmp[0][0]:.3g} dk={cmp[1][0]:.3g} dv={cmp[2][0]:.3g} (tol {TOL['float32']}); "
            f"launches {counts}; on {card}: vmap(grad) call {ms:.4f} ms event, "
            f"{dev_ms:.4f} ms device (every kernel of the call); plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} (SDPA forward and autograd backward) "
            f"bound_ms={bms:.4f} ({by})")
        one = {"attention_fwd": 1, "attention_bwd_dq": 1, "attention_bwd_dkv": 1}
        if not (all(ok for _, ok in cmp) and all(counts[k_] == n for k_, n in one.items())):
            raise AssertionError(f"vmapped cross-attention at Sq={sq} D={d}: {cmp} {counts}")
        del q, k, v, w, got, want, qt, kt, vt
        torch.cuda.empty_cache()


def check_clip_vision(torch, np, dev, card: str) -> None:
    """The CLIP ViT-L/14 vision tower (seeded random init) and the aesthetic
    head: card against CPU at batch TTI_CLIP_CHECK from 256x256 images (the
    antialiased resize to 224), then the tower timed at TTI_CLIP_BATCH beside
    its bound (the projections', MLPs' and patch convolution's FLOPs from
    forward hooks plus the attention products, at the f32 FMA rate)."""
    from group_attribution_for_diffusion_models_tpu_torch.models.clip_vision import (
        AestheticHead, CLIPVisionEncoder, load_aesthetic_head, load_clip_vision)

    tower = load_clip_vision(None, device=dev)
    head = load_aesthetic_head(None, device=dev)
    tower_cpu = meta_copy(torch, CLIPVisionEncoder, tower)
    tower_cpu.mean, tower_cpu.std = tower.mean.cpu(), tower.std.cpu()  # not in the state dict
    head_cpu = meta_copy(torch, AestheticHead, head, 768)
    rng = np.random.default_rng(23)
    imgs = torch.from_numpy(rng.uniform(0, 1, (TTI_CLIP_CHECK, 3, 256, 256)).astype(np.float32))
    with torch.no_grad():
        want = tower_cpu(imgs)
        got = tower(imgs.to(dev)).cpu()
        s_want, s_got = head_cpu(want), head(want.to(dev)).cpu()
    err = (got - want).abs().max().item()
    limit = TOWER_TOL * max(1.0, want.abs().max().item())
    h_err = (s_got - s_want).abs().max().item()
    vm = tower_cpu.vision_model
    n = vm.embeddings.position_embedding.weight.shape[0]
    width, layers = vm.pre_layrnorm.weight.shape[0], len(vm.encoder.layers)
    flops = tower_flops(torch, tower_cpu, 224) + 4.0 * n * n * width * layers
    del tower_cpu
    x = torch.from_numpy(rng.uniform(0, 1, (TTI_CLIP_BATCH, 3, 256, 256)).astype(
        np.float32)).to(dev)
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(torch, lambda: tower(x), iters=5)
        dev_ms = device_ms(torch, lambda: tower(x), iters=3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    weights = sum(p.numel() for p in tower.parameters())
    bms, by = bound((x.numel() + weights + TTI_CLIP_BATCH * 768) * 4, flops * TTI_CLIP_BATCH,
                    "float32")
    log(f"[tti] CLIP ViT-L/14 vision tower ({weights} params) from 256x256, f32 (TF32 off), "
        f"card vs CPU at batch {TTI_CLIP_CHECK}: max_abs_err={err:.3g} (tol {limit:.3g}), "
        f"aesthetic head max_abs_err={h_err:.3g} (tol {TTI_HEAD_ATOL}); batch {TTI_CLIP_BATCH} "
        f"on {card}: {ms:.3f} ms event, {dev_ms:.3f} ms device ({ms / TTI_CLIP_BATCH:.4f} ms "
        f"an image, {TTI_CLIP_BATCH / ms * 1e3:.1f} images/s), {flops / 1e9:.3f} GFLOP an "
        f"image, bound {bms:.3f} ms ({by}; {bms / TTI_CLIP_BATCH:.4f} ms an image), "
        f"{bms / dev_ms:.3f} of it by device time, peak {peak:.2f} GiB")
    if not (err <= limit and h_err <= TTI_HEAD_ATOL and torch.isfinite(got).all()):
        raise AssertionError("the CLIP vision tower or the aesthetic head on the card "
                             "disagrees with the CPU")
    del tower, head, x
    torch.cuda.empty_cache()


def check_tti_scoring(torch, np, ops, outdir: str, card: str, common: list, timed,
                      shape: dict, datamodel: dict) -> dict:
    """The tier's scoring loop at full miniSD width on the stand-in: shapley
    members and the full anchor trained (the latents' cache read), the null
    anchor (a LoRA whose up factors are 0: the bare base), each member's mask
    as the LDS CLIs redraw it against the trainer's kept_units;
    compute_model_behaviors timed once, then on every member and anchor, and
    once more, skipped by the duplicate guard; shapley_lds (the efficiency
    constraint) and shapley_convergence; grad_features_tti in every source,
    traks; similarity_baselines pixel, clip and aesthetic; baseline_lds over
    the TRAK and similarity attributions. Launches reckoned from the specs.
    Returns the summed launches."""
    from PIL import Image

    from group_attribution_for_diffusion_models_tpu_torch.cli import (
        baseline_lds, compute_model_behaviors, grad_features_tti, shapley_convergence,
        shapley_lds, similarity_baselines, train_text_to_image_lora, traks)
    from group_attribution_for_diffusion_models_tpu_torch.data.removal import sample_removal
    from group_attribution_for_diffusion_models_tpu_torch.models.lora import (
        load_lora_npz, save_lora_npz)

    n_attn, n_gn, n_gn_bwd, n_dec = (shape[k] for k in ("n_attn", "n_gn", "n_gn_bwd", "n_dec"))
    no_route = {"attention_plain_fwd": 0, "attention_plain_bwd": 0}
    # The members stacked in one program; --microbatch halves what each
    # forward holds, so that they fit the card (two launches a site a step).
    slices = TTI_BATCH // TTI_SHAPLEY_MICROBATCH
    s_out, wall, total, routes, peak = timed(train_text_to_image_lora.main, common + [
        "--removal_dist", "shapley", "--num_seeds", str(TTI_SHAPLEY), "--microbatch",
        str(TTI_SHAPLEY_MICROBATCH)])
    log(f"[tti] train_text_to_image_lora {TTI_SHAPLEY} shapley members stacked x {TTI_STEPS} "
        f"steps, subsets {s_out['subset_sizes']} images, batch {s_out['batch']} in slices of "
        f"{TTI_SHAPLEY_MICROBATCH}: training {s_out['train_seconds']:.3f} s, call {wall:.3f} s, "
        f"peak {peak:.2f} GiB, latents from the cache={s_out['latents_cached']}")
    expect("shapley members", total, routes,
           tti_counts(n_attn, n_gn, n_gn_bwd, slices * TTI_STEPS, slices * TTI_STEPS), no_route,
           phase="tti")
    f_out, wall, counts, routes, _ = timed(train_text_to_image_lora.main, common + [
        "--removal_dist", "full"])
    log(f"[tti] train_text_to_image_lora --removal_dist full (the full anchor and the "
        f"reference LoRA): 1 member x {TTI_STEPS} steps, call {wall:.3f} s")
    expect("full anchor", counts, routes,
           tti_counts(n_attn, n_gn, n_gn_bwd, TTI_STEPS, TTI_STEPS), no_route, phase="tti")
    total = add_counts(total, counts)
    if not (s_out["latents_cached"] and f_out["latents_cached"] and s_out["batch"] == TTI_BATCH
            and all(math.isfinite(x) for x in s_out["losses"] + f_out["losses"])):
        raise AssertionError(f"shapley members or full anchor: {s_out} {f_out}")
    full = f_out["lora_paths"][0]
    null = os.path.join(outdir, "null", "lora_weights.npz")
    save_lora_npz(null, {n: {"down": ab["down"], "up": ab["up"] * 0}
                         for n, ab in load_lora_npz(full).items()})

    # Each member's mask, as collect_group_data redraws it from the behavior
    # row's removal_dist and removal_seed, against the trainer's kept_units.
    members = []
    for row in (json.loads(line) for line in open(datamodel["db"])):
        if row["removal_dist"] == "full":
            continue
        kept, _ = sample_removal(row["removal_dist"], TTI_ARTISTS, seed=row["removal_seed"],
                                 alpha=row["datamodel_alpha"])
        if sorted(kept.tolist()) != row["kept_units"]:
            raise AssertionError(f"redrawn mask {sorted(kept.tolist())} != kept_units of "
                                 f"{row['lora_path']}")
        members.append(row)
    kinds = sorted((r["removal_dist"], r["method"]) for r in members)
    log(f"[tti] {len(members)} members' masks redrawn from (removal_dist, removal_seed) equal "
        f"the trainer's kept_units: {kinds}")
    if len(members) != TTI_MEMBERS + TTI_SHAPLEY + TTI_FT_MEMBERS:
        raise AssertionError(f"members in the trainer's DB: {kinds}")

    # compute_model_behaviors: one timed call at full size.
    score = os.path.join(outdir, "scores")
    db = os.path.join(score, "behaviors.jsonl")
    base = ["--dataset", "imagenette", "--outdir", outdir, "--reference_lora_dir", full,
            "--device", "cuda"]

    def score_counts(n_steps, n_noises):
        return add_counts(tti_counts(n_attn, n_gn, 0, 2 * n_steps + n_noises),
                          model_counts(0, n_dec, 2))

    decode_route = {"attention_plain_fwd": 2, "attention_plain_bwd": 0}
    first = datamodel["lora_paths"][0]
    c, wall, counts, routes, peak = timed(compute_model_behaviors.main, base + [
        "--db", os.path.join(score, "timed.jsonl"), "--lora_dir", first, "--removal_dist",
        "datamodel", "--n_samples", str(TTI_SCORE_SAMPLES), "--num_inference_steps",
        str(TTI_SCORE_STEPS), "--n_noises", str(TTI_SCORE_NOISES)])
    sec, row = c["seconds"], c["row"]
    log(f"[tti] compute_model_behaviors {TTI_SCORE_SAMPLES} paired samples x "
        f"{TTI_SCORE_STEPS} DDIM steps, {TTI_SCORE_NOISES} loss draws, f32 on {card}: "
        f"seconds {', '.join(f'{k} {v:.3f}' for k, v in sec.items())} (generation "
        f"{2 * TTI_SCORE_SAMPLES / sec['generation']:.4f} images/s with the KL decode), "
        f"call {wall:.3f} s, peak {peak:.2f} GiB; ssim {row['ssim_avg']:.4f}, nrmse "
        f"{row['nrmse_avg']:.4f}, clip_similarity {row['clip_similarity_avg']:.4f}, "
        f"clip_prompt_score {row['clip_prompt_score_avg']:.4f}, aesthetic "
        f"{row['aesthetic_score_avg']:.4f}, simple_loss {row['simple_loss_avg']:.5f}")
    expect("compute_model_behaviors", counts, routes,
           score_counts(TTI_SCORE_STEPS, TTI_SCORE_NOISES), decode_route, phase="tti")
    total = add_counts(total, counts)
    images = c["images"]
    if not (images.shape == (TTI_SCORE_SAMPLES, 256, 256, 3) and np.isfinite(images).all()
            and all(math.isfinite(row[f"{m}_avg"]) for m in compute_model_behaviors.METRICS)):
        raise AssertionError("compute_model_behaviors: non-finite behaviors or images")
    gen_dir = os.path.join(score, "generated")
    os.makedirs(gen_dir)
    for i, im in enumerate(images):
        Image.fromarray((im * 255).round().astype(np.uint8)).save(
            os.path.join(gen_dir, f"{i:03d}.png"))

    # Every member and both anchors, smaller.
    small = ["--n_samples", str(TTI_MEMBER_SAMPLES), "--num_inference_steps",
             str(TTI_MEMBER_STEPS), "--n_noises", str(TTI_MEMBER_NOISES)]
    calls = [(r["lora_path"], r["removal_dist"], r["removal_seed"], r["method"], db)
             for r in members]
    calls += [(full, "full", 0, "retrain", os.path.join(score, "full.jsonl")),
              (null, "null", 0, "retrain", os.path.join(score, "null.jsonl"))]
    t0 = time.perf_counter()
    for path, dist, seed, method, out_db in calls:
        c, _, counts, routes, _ = timed(compute_model_behaviors.main, base + small + [
            "--db", out_db, "--lora_dir", path, "--removal_dist", dist, "--removal_seed",
            str(seed), "--method", method])
        expect(f"compute_model_behaviors {dist} {seed} {method}", counts, routes,
               score_counts(TTI_MEMBER_STEPS, TTI_MEMBER_NOISES), decode_route, phase="tti")
        total = add_counts(total, counts)
    log(f"[tti] compute_model_behaviors on {len(calls)} LoRAs (every member, the full and "
        f"null anchors), {TTI_MEMBER_SAMPLES} samples x {TTI_MEMBER_STEPS} steps: "
        f"{time.perf_counter() - t0:.3f} s")
    again, _, counts, routes, _ = timed(compute_model_behaviors.main, base + small + [
        "--db", db, "--lora_dir", calls[0][0], "--removal_dist", calls[0][1],
        "--removal_seed", str(calls[0][2]), "--method", calls[0][3]])
    rows = [json.loads(line) for line in open(db)]
    log(f"[tti] a repeated call: skipped={again['skipped']}, launches {counts}; {len(rows)} "
        f"rows in the behavior DB")
    if not (again["skipped"] and not any(counts.values()) and len(rows) == len(members)):
        raise AssertionError("the duplicate guard did not skip a scored member")

    # Shapley values, their LDS, and the sparse fine-tunes' convergence.
    lds_args = ["--train_db", db, "--test_db", db, "--num_groups", str(TTI_ARTISTS),
                "--train_size_step", "2", "--full_db", os.path.join(score, "full.jsonl"),
                "--null_db", os.path.join(score, "null.jsonl")]
    attrs_dir = os.path.join(score, "attrs")
    attrs = shapley_lds.main(lds_args + ["--save_dir", attrs_dir])
    v1 = [json.loads(line) for line in open(os.path.join(score, "full.jsonl"))][0]
    v0 = [json.loads(line) for line in open(os.path.join(score, "null.jsonl"))][0]
    key = "aesthetic_score_avg"
    gap = v1[key] - v0[key]
    saved = np.load(os.path.join(attrs_dir, f"attrs_shapley_retrain_{key}.npy"))
    eff = abs(saved.sum() - gap)
    log(f"[tti] shapley_lds: {saved.shape[0]} artist attributions, sum {saved.sum():.6g}, "
        f"v1 - v0 = {gap:.6g}, efficiency error {eff:.3g} (tol "
        f"{EFFICIENCY_RTOL * max(1.0, abs(gap)):.3g})")
    if not (saved.shape == (TTI_ARTISTS,) and np.array_equal(saved, attrs)
            and eff <= EFFICIENCY_RTOL * max(1.0, abs(gap))):
        raise AssertionError("shapley_lds: efficiency constraint or shape")
    conv = shapley_convergence.main(lds_args + ["--method", "pruned_ft",
                                                "--train_size_step", "1"])
    log(f"[tti] shapley_convergence pruned_ft against retrain: {conv}")
    if len(conv) != TTI_FT_MEMBERS:
        raise AssertionError(f"shapley_convergence: {conv}")

    # TRAK features of the full LoRA: the train source timed, then every image.
    trak = os.path.join(score, "trak")
    g_common = ["--dataset", "imagenette", "--outdir", outdir, "--lora_dir", full,
                "--proj_dim", str(TTI_TRAK_PROJ), "--batch_size", str(TTI_TRAK_BATCH),
                "--num_inference_steps", str(TTI_TRAK_SAMPLE_STEPS), "--device", "cuda"]
    store = os.path.join(trak, "feats.npz")
    all_images = TTI_ARTISTS * TTI_PER_ARTIST

    def trak_counts(batches, timesteps, sampling=0):
        return add_counts(tti_counts(n_attn, n_gn, n_gn_bwd, batches * timesteps + sampling,
                                     batches * timesteps),
                          {**model_counts(0, 0, 0), "jl_projection": batches})

    runs = [
        ("train", ["--source", "train", "--max_examples", str(TTI_TRAK_EXAMPLES),
                   "--num_timesteps", str(TTI_TRAK_TIMESTEPS),
                   "--save_path", os.path.join(trak, "timed.npz")],
         trak_counts(TTI_TRAK_EXAMPLES // TTI_TRAK_BATCH, TTI_TRAK_TIMESTEPS)),
        ("train, every image", ["--source", "train", "--num_timesteps", "1",
                                "--save_path", store],
         trak_counts(all_images // TTI_TRAK_BATCH, 1)),
        ("generated", ["--source", "generated", "--n_samples", str(TTI_TRAK_SAMPLES),
                       "--num_timesteps", str(TTI_TRAK_TIMESTEPS), "--save_path", store],
         trak_counts(1, TTI_TRAK_TIMESTEPS, TTI_TRAK_SAMPLE_STEPS)),
        ("generated_journey", ["--source", "generated_journey", "--n_samples",
                               str(TTI_TRAK_SAMPLES),
                               "--save_path", os.path.join(trak, "journey.npz")],
         trak_counts(1, TTI_TRAK_SAMPLE_STEPS, TTI_TRAK_SAMPLE_STEPS)),
    ]
    sums = ops.group_norm_silu.affine_sums
    for label, extra, want in runs:
        g, wall, counts, routes, peak = timed(grad_features_tti.main, g_common + extra)
        secs, rows_ = g["batch_seconds"], g["features_shape"][0]
        log(f"[tti] grad_features_tti {label}: features {g['features_shape']} from "
            f"{g['grad_dim']} LoRA gradient coordinates, f32 on {card}: s/batch "
            f"{', '.join(f'{x:.3f}' for x in secs[:4])}{' ...' if len(secs) > 4 else ''} "
            f"(last: {min(rows_, TTI_TRAK_BATCH) / secs[-1]:.2f} examples/s), gradients "
            f"{sum(g['grad_seconds']):.3f} s and JL {sum(g['jl_seconds']):.3f} s over "
            f"{len(secs)} batch(es), sampling {g['sample_seconds']:.3f} s, call {wall:.3f} s, "
            f"peak {peak:.2f} GiB")
        expect(f"grad_features_tti {label}", counts, routes, want, no_route, phase="tti")
        total = add_counts(total, counts)
    with np.load(store) as st:
        ok = (sorted(st.files) == ["gen_features", "group_labels", "train_features"]
              and st["train_features"].shape == (all_images, TTI_TRAK_PROJ)
              and np.isfinite(st["train_features"]).all() and st["train_features"].std() > 0
              and len(np.unique(st["group_labels"])) == TTI_ARTISTS)
    if not (ok and ops.group_norm_silu.affine_sums == sums):
        raise AssertionError("grad_features_tti: the store or the frozen base's GroupNorm sums")
    trak_attrs = traks.main(["--feature_store", store, "--save_dir", os.path.join(trak, "a")])
    paths = [os.path.join(trak, "a", f"attrs_{m}.npy") for m in trak_attrs]

    # The similarity baselines on the stand-in and the generated images.
    for baseline in ("pixel", "clip", "aesthetic"):
        out = os.path.join(score, f"{baseline}.npy")
        t0 = time.perf_counter()
        a = similarity_baselines.main(["--dataset", "imagenette", "--baseline", baseline,
                                       "--generated_dir", gen_dir, "--save_path", out,
                                       "--device", "cuda"])
        log(f"[tti] similarity_baselines {baseline}: {a.shape[0]} artist attributions in "
            f"{time.perf_counter() - t0:.3f} s, range [{a.min():.4g}, {a.max():.4g}]")
        if not (a.shape == (TTI_ARTISTS,) and np.isfinite(a).all()):
            raise AssertionError(f"similarity_baselines {baseline}: {a}")
        paths.append(out)
    lds = baseline_lds.main(["--attrs", *paths, "--test_db", db, "--num_groups",
                             str(TTI_ARTISTS), "--bootstrapped", "--num_bootstrap_iters", "20"])
    log(f"[tti] baseline_lds over {len(lds)} attribution vectors (TRAK family and "
        f"similarity) against {TTI_MEMBERS} datamodel test rows: "
        + ", ".join(f"{os.path.basename(k)} {v[0]:.2f}" for k, v in lds.items()))
    if len(lds) != len(paths):
        raise AssertionError(f"baseline_lds skipped attributions: {sorted(lds)}")
    return total


def check_jl_projection(torch, ops, dev):
    """The JL kernel against its plain version at every shape of JL_SHAPES
    (the three TRAK modes' among them) and, with bf16 G, of JL_BF16_SHAPES;
    two runs bitwise, seeds distinct,
    identity rows bitwise up to JL_IDENTITY_MAX_D; kernel and plain times at
    each shape. Returns the JSON row's numbers, all at the main path's shape
    JL_MAIN but the library yardstick's, which carry their own shape."""
    def rows_err(got, want, g, p):
        err = (got - want).abs().amax(dim=1)
        limit = JL_RTOL * g.float().abs().sum(dim=1) / math.sqrt(p)
        return err.max().item(), bool((err <= limit).all())

    def timed_once(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    out = {}
    runs = [(shape, torch.float32) for shape in JL_SHAPES]
    runs += [(shape, torch.bfloat16) for shape in JL_BF16_SHAPES]
    for (b, d, p), dtype in runs:
        name = str(dtype).split(".")[1]
        g = torch.randn(b, d, generator=torch.Generator(device=dev).manual_seed(7),
                        device=dev).to(dtype)
        got = ops.jl_project_kernel(g, p, seed=3)
        # One timed call: at D = 35.7M the plain version takes seconds.
        want, plain_ms = timed_once(
            lambda: ops.jl_project_plain(g, p, seed=3, tile_d=JL_PLAIN_TILE_D))
        err, ok = rows_err(got, want, g, p)
        same = torch.equal(got, ops.jl_project_kernel(g, p, seed=3))
        other = not torch.equal(got, ops.jl_project_kernel(g, p, seed=4))
        del want
        exact = None
        if d <= JL_IDENTITY_MAX_D:
            eye = torch.eye(min(b * 16, 64), d, device=dev).to(dtype)
            exact = torch.equal(ops.jl_project_kernel(eye, p, seed=5),
                                ops.jl_project_plain(eye, p, seed=5))
            del eye
        ms = cuda_ms(torch, lambda: ops.jl_project_kernel(g, p), iters=3)
        nbytes, flops = b * d * g.element_size() + b * p * 4, 2.0 * b * d * p
        bms, by = bound(nbytes, flops, name, JL_FLOPS)
        fma, fma_by = bound(nbytes, flops, "float32")
        log(f"[kernels] jl_projection B={b} D={d} P={p} {name}: max_abs_err={err:.3g} "
            f"(tol {JL_RTOL} * |G_b|_1 / sqrt(P) per row), identity rows bitwise="
            f"{'not run' if exact is None else exact}, bitwise repeatable={same}, other seed "
            f"differs={other}; kernel_ms={ms:.4f} ({flops / ms / 1e9:.2f} TFLOP/s) "
            f"plain_ms={plain_ms:.4f} (one call, d-tile {JL_PLAIN_TILE_D}) "
            f"bound_ms={bms:.4f} ({by}, tensor cores, {3 if name == 'float32' else 1} bf16 "
            f"piece(s)) f32-FMA bound_ms={fma:.4f} ({fma_by})")
        if not (ok and same and other and exact is not False):
            raise AssertionError(f"JL kernel disagrees at {(b, d, p)}: {err}, identity "
                                 f"{exact}, repeatable {same}, seeds {other}")
        if (b, d, p) == JL_MAIN and name == "float32":
            out = dict(shape=[b, d, p], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bms, bound_by=by, fma_bound_ms=fma)
            lib_g = g[:, :JL_LIBRARY_D].contiguous()
            r = ops.rademacher_rows(0, 0, JL_LIBRARY_D, p, dev)
            lib_ms = cuda_ms(torch, lambda: torch.matmul(lib_g, r))
            lib_kernel_ms = cuda_ms(torch, lambda: ops.jl_project_kernel(lib_g, p))
            log(f"[kernels] jl_projection B={b} D={JL_LIBRARY_D} P={p}: torch.matmul by a "
                f"materialised R (TF32 off; the library yardstick, no single call fits the "
                f"main shape) library_ms={lib_ms:.4f}, kernel_ms={lib_kernel_ms:.4f}")
            out.update(library_ms=lib_ms, library_shape=[b, JL_LIBRARY_D, p],
                       library_kernel_ms=lib_kernel_ms)
            del lib_g, r
        del g, got
        torch.cuda.empty_cache()
    return out


def check_trak_step(torch, np, ops, spec, dev):
    """Full-width CIFAR per-sample gradients (batch 2, one timestep,
    injected noise) through the vmap rules: card against CPU, then against
    a per-example autograd loop on the card; exact launch counts."""
    from group_attribution_for_diffusion_models_tpu_torch.attributions.methods.trak import (
        PerSampleGradients)
    from group_attribution_for_diffusion_models_tpu_torch.config.registry import get_config
    from group_attribution_for_diffusion_models_tpu_torch.diffusion import (
        add_noise, make_schedule)
    from group_attribution_for_diffusion_models_tpu_torch.models import build_unet

    sched = get_config("cifar").scheduler
    model = build_unet(spec, seed=2).eval()
    rng = np.random.default_rng(6)
    images = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((2, 3, 32, 32)).astype(np.float32))
    t = torch.tensor([500, 500])

    def per_sample(device):
        grads = PerSampleGradients(model.to(device))
        acc = torch.zeros((2, grads.dim), device=device)
        schedule = make_schedule(sched, device)
        x, n, tt = images.to(device), noise.to(device), t.to(device)
        grads.accumulate(acc, add_noise(schedule, x, n, tt), tt, n)
        return acc, schedule

    want, _ = per_sample("cpu")
    reset_counts(ops)
    got, schedule = per_sample(dev)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    got = got.cpu()
    norm_rel = ((got.norm(dim=1) - want.norm(dim=1)).abs() / want.norm(dim=1)).max().item()
    gerr = ((got - want).abs().amax(dim=1) / want.abs().amax(dim=1)).max().item()
    log(f"[trak-step] CIFAR UNet2D per-sample gradients ({got.shape[1]} params) batch 2 f32, "
        f"card vs CPU: per-sample norm rel err {norm_rel:.3g}, max |dg| / max |g| {gerr:.3g} "
        f"(tol {TRAIN_STEP_RTOL}); launches {counts}")
    if not (norm_rel <= TRAIN_STEP_RTOL and gerr <= TRAIN_STEP_RTOL
            and counts == unet_counts(1, 1)):
        raise AssertionError("per-sample gradients on the card disagree with the CPU")
    # The same gradients from one autograd call per example, on the card.
    params = list(model.parameters())
    loop = []
    reset_counts(ops)
    for b in range(2):
        x, n, tt = images[b:b + 1].to(dev), noise[b:b + 1].to(dev), t[b:b + 1].to(dev)
        eps = model(add_noise(schedule, x, n, tt), tt)
        g = torch.autograd.grad(torch.mean((eps - n) ** 2), params)
        loop.append(torch.cat([v.reshape(-1) for v in g]).cpu())
    torch.cuda.synchronize()
    loop_counts = ops.launch_counts()
    loop = torch.stack(loop)
    lerr = ((got - loop).abs().amax(dim=1) / loop.abs().amax(dim=1)).max().item()
    log(f"[trak-step] vmap path vs a per-example autograd loop on the card: max |dg| / max |g| "
        f"{lerr:.3g} (tol {TRAK_LOOP_RTOL}); loop launches {loop_counts}")
    if not (lerr <= TRAK_LOOP_RTOL and loop_counts == unet_counts(2, 2)):
        raise AssertionError("the vmap path disagrees with the per-example loop on the card")
    model.cpu()


def check_trak_path(torch, np, ops, grad_features, traks, model_dir: str, root: str,
                    card: str):
    """grad_features.main at full width in each source and mode, then
    traks.main on the store; each call between a counter reset and a read,
    with the launches the code implies asserted. Returns the summed counts."""
    store = os.path.join(root, "trak", "feats.npz")
    common = ["--dataset", "cifar", "--load", model_dir, "--proj_dim", str(TRAK_PROJ),
              "--num_timesteps", str(TRAK_TIMESTEPS), "--batch_size", str(TRAK_BATCH),
              "--num_inference_steps", str(TRAK_SAMPLE_STEPS), "--device", "cuda"]
    n_batches = TRAK_EXAMPLES // TRAK_BATCH
    runs = [  # (label, extra argv, store, expected launches)
        ("train full", ["--source", "train", "--max_examples", str(TRAK_EXAMPLES)], store,
         {k: n_batches * v for k, v in unet_counts(TRAK_TIMESTEPS, TRAK_TIMESTEPS,
                                                     jl=1).items()}),
        ("generated full", ["--source", "generated", "--n_samples", str(TRAK_SAMPLES)], store,
         unet_counts(TRAK_SAMPLE_STEPS + TRAK_TIMESTEPS, TRAK_TIMESTEPS, jl=1)),
        ("train probe", ["--source", "train", "--max_examples", str(TRAK_BATCH),
                         "--grad_mode", "probe"], os.path.join(root, "trak", "probe.npz"),
         unet_counts(TRAK_TIMESTEPS, 0, jl=1, attention_only=TRAK_TIMESTEPS)),
        ("train attn_full", ["--source", "train", "--max_examples", str(TRAK_BATCH),
                             "--grad_mode", "attn_full"], os.path.join(root, "trak", "attn.npz"),
         unet_counts(TRAK_TIMESTEPS, 0, jl=1, attention_only=TRAK_TIMESTEPS)),
        ("generated_journey full", ["--source", "generated_journey", "--n_samples",
                                    str(TRAK_JOURNEY_SAMPLES)],
         os.path.join(root, "trak", "journey.npz"),
         unet_counts(2 * TRAK_SAMPLE_STEPS, TRAK_SAMPLE_STEPS, jl=1)),
    ]
    total = unet_counts(0, 0)
    for label, extra, path, want in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(ops)
        t0 = time.perf_counter()
        summary = grad_features.main(common + extra + ["--save_path", path])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        secs = summary["batch_seconds"]
        rows = summary["features_shape"][0]
        log(f"[trak] grad_features {label}: features {summary['features_shape']} from "
            f"{summary['grad_dim']} gradient coordinates, f32 on {card}: s/batch "
            f"{', '.join(f'{x:.3f}' for x in secs)} (last: "
            f"{min(rows, TRAK_BATCH) / secs[-1]:.2f} examples/s), sampling "
            f"{summary['sample_seconds']:.3f} s, call {wall:.3f} s, peak {peak_gib:.2f} GiB, "
            f"launches {counts}")
        if counts != want:
            raise AssertionError(f"TRAK path ({label}) launches {counts}, expected {want}")
        feats = np.load(path)["train_features" if "train" in label else "gen_features"]
        if not (np.isfinite(feats).all() and feats.std() > 0):
            raise AssertionError(f"TRAK path ({label}): non-finite or constant features")
        total = {k: total[k] + counts[k] for k in total}
    reset_counts(ops)
    attrs = traks.main(["--feature_store", store, "--save_dir", os.path.join(root, "trak",
                                                                              "attrs")])
    if ops.launch_counts() != unet_counts(0, 0):
        raise AssertionError("traks launched a kernel")
    for method, a in attrs.items():
        log(f"[trak] traks {method}: {a.shape[0]} group attributions, finite="
            f"{bool(np.isfinite(a).all())}, range [{a.min():.4g}, {a.max():.4g}]")
        if not (a.shape == (10,) and np.isfinite(a).all()):
            raise AssertionError(f"traks {method}: attributions {a}")
    return total


def check_train_step(torch, np, spec, dev):
    """One train step of the full-width CIFAR U-Net, card against CPU, from
    the same weights and injected images/timesteps/noise; then a second card
    step from the same state must repeat the first bit for bit."""
    from group_attribution_for_diffusion_models_tpu_torch.config.registry import get_config
    from group_attribution_for_diffusion_models_tpu_torch.diffusion import make_schedule
    from group_attribution_for_diffusion_models_tpu_torch.models import UNet2D, build_unet
    from group_attribution_for_diffusion_models_tpu_torch.training import (
        TrainState, make_optimizer, make_train_step)

    sched = get_config("cifar").scheduler
    weights = build_unet(spec, seed=1).state_dict()
    rng = np.random.default_rng(5)
    b = TRAIN_STEP_BATCH
    images = torch.from_numpy(rng.uniform(-1, 1, (b, 3, 32, 32)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, sched.num_train_timesteps, b))
    noise = torch.from_numpy(rng.standard_normal((b, 3, 32, 32)).astype(np.float32))

    def run(device):
        model = UNet2D(spec)
        model.load_state_dict(weights)
        tx = make_optimizer("adam", lr=1e-4, grad_clip_norm=1.0)
        state = TrainState.create(model.to(device), tx)
        step = make_train_step(tx, make_schedule(sched, device), sched)
        metrics = step(state, images.to(device), timesteps=t.to(device), noise=noise.to(device))
        grads = [p.grad.detach().cpu() for p in state.params]
        params = [p.detach().cpu() for p in state.params]
        return metrics["loss"].item(), metrics["grad_norm"].item(), grads, params

    loss_c, norm_c, grads_c, _ = run("cpu")
    loss_g, norm_g, grads_g, params_g = run(dev)
    _, _, grads_g2, params_g2 = run(dev)
    gmax = max(g.abs().max().item() for g in grads_c)
    gerr = max((a - w).abs().max().item() for a, w in zip(grads_g, grads_c))
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    norm_rel = abs(norm_g - norm_c) / norm_c
    same = (all(torch.equal(a, w) for a, w in zip(grads_g, grads_g2))
            and all(torch.equal(a, w) for a, w in zip(params_g, params_g2)))
    log(f"[train-step] CIFAR UNet2D batch {b} f32, card vs CPU: loss {loss_g:.6f} vs "
        f"{loss_c:.6f} (rel {loss_rel:.3g}), grad norm {norm_g:.6f} vs {norm_c:.6f} "
        f"(rel {norm_rel:.3g}), max |dg| {gerr:.3g} of max |g| {gmax:.3g} "
        f"(rel {gerr / gmax:.3g}; tol {TRAIN_STEP_RTOL}); two card steps bitwise equal={same}")
    if not (loss_rel <= TRAIN_STEP_RTOL and norm_rel <= TRAIN_STEP_RTOL
            and gerr <= TRAIN_STEP_RTOL * gmax and same):
        raise AssertionError("the train step on the card disagrees with the CPU")


def device_split(torch, fn) -> dict:
    """Device ms of one call of `fn` by kernel group (the groups of
    scripts/profile_torch_sampling.py), from the trace's intervals, with the
    time the device was busy (their union) under "busy"; a trace with no
    device activity is taken again, up to three times, then {} is returned."""
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    from profile_torch_sampling import device_activity, group

    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        activity = device_activity(prof)
        if activity["by_kernel"]:
            break
    else:
        return {}
    out: dict = {"busy": activity["busy_ms"]}
    for name, (ms, _) in activity["by_kernel"].items():
        out[group(name)] = out.get(group(name), 0.0) + ms
    return out


def split_line(split: dict) -> str:
    conv = split.get("convolution (cuDNN)", 0.0)
    summed = sum(ms for g, ms in split.items() if g != "busy")
    return (f"device busy {split['busy']:.3f} ms (kernels summed {summed:.3f}), "
            f"convolutions {conv:.3f} ms" if split else "no device trace")


def timed_steps(torch, fn, steps: int) -> float:
    """Seconds a call of `fn`, over `steps` calls to a device synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps


def moved_within(start: dict, got: dict, want: dict) -> tuple:
    """(the largest ||got - want|| / ||want - start||, its tensor's name)
    over tensors whose move is not zero: the tests' rule (Adam turns float
    noise of a gradient element near zero into a visible share of lr, so
    single elements are not compared; a tensor's move is). A key
    projection's bias is left out, as the tests leave it out: its gradient
    is zero in exact arithmetic (it shifts all of a query's scores alike),
    so Adam's first step normalises float noise."""
    worst = (0.0, None)
    for n, w in want.items():
        moved = (w - start[n]).double().norm().item()
        if moved > 0 and not str(n).endswith("to_k.bias"):
            worst = max(worst, ((got[n] - w).double().norm().item() / moved, n),
                        key=lambda x: x[0])
    return worst


def check_ensemble(torch, np, ops, dev, card: str, root: str) -> dict:
    """The stacked ensemble at full width. CIFAR: ENS_MEMBERS members at batch
    ENS_BATCH, each with a seeded gamma/beta of its own in every GroupNorm:
    one stacked step (`make_members_step`) against the same member-steps one
    at a time (`make_train_step`) from the same states and draws, losses,
    clipped gradients and weights; the launches (one a kernel site for every
    member); seconds a step, peaks and the convolutions' device time of
    both. Then run_scanned(ENS_SCAN_STEPS, chunk=ENS_SCAN_CHUNK) against run()
    bit for bit under common noise, where two members on one subset must end
    bit-identical. miniSD: ENS_TTI_MEMBERS LoRA members at batch TTI_BATCH in
    one `members_step` against each member alone, the same checks. Then
    cli.main on the CIFAR stand-in with --scan_chunk and with the per-step
    loop. Returns the launches of the two cli.main calls."""
    from group_attribution_for_diffusion_models_tpu_torch.cli import main as main_cli
    from group_attribution_for_diffusion_models_tpu_torch.cli.train_text_to_image_lora import (
        lora_leaves, members_step as lora_members_step)
    from group_attribution_for_diffusion_models_tpu_torch.config.registry import (
        MINISD_SCHEDULER, MINISD_UNET, get_config)
    from group_attribution_for_diffusion_models_tpu_torch.data import sample_removal
    from group_attribution_for_diffusion_models_tpu_torch.diffusion import make_schedule
    from group_attribution_for_diffusion_models_tpu_torch.models import build_unet
    from group_attribution_for_diffusion_models_tpu_torch.models.layers import (
        CrossAttention, GroupNormSiLU)
    from group_attribution_for_diffusion_models_tpu_torch.models.lora import (
        lora_init, stack_lora_trees)
    from group_attribution_for_diffusion_models_tpu_torch.parallel import EnsembleTrainer
    from group_attribution_for_diffusion_models_tpu_torch.training import (
        make_members_step, make_optimizer, make_train_step, unstack_state)
    from group_attribution_for_diffusion_models_tpu_torch.utils.ckpt import get_max_steps

    cfg = get_config("cifar")
    spec, m_count = cfg.unet, ENS_MEMBERS
    images = np.random.default_rng(3).integers(0, 256, (CIFAR_TRAIN_IMAGES, 32, 32, 3),
                                               dtype=np.uint8)
    subsets = [sample_removal("shapley", CIFAR_TRAIN_IMAGES, seed=TRAIN_SEED_START + m)[0]
               for m in range(m_count)]

    def own_gamma_beta(seed):
        """The seeded U-Net on the card with a gamma/beta of its own in every
        GroupNorm (each starts at 1, 0 in every member)."""
        model = build_unet(spec, seed, device=dev)
        g = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            for norm in (x for x in model.modules() if isinstance(x, GroupNormSiLU)):
                norm.weight.copy_(1 + 0.1 * torch.randn(norm.weight.shape, generator=g,
                                                        device=dev))
                norm.bias.copy_(0.1 * torch.randn(norm.bias.shape, generator=g, device=dev))
        return model

    def trainer_of(member_indices, common_noise):
        return EnsembleTrainer(
            tx=make_optimizer("adam", lr=cfg.train.optimizer.lr),
            schedule=make_schedule(cfg.scheduler, dev), spec=cfg.scheduler, images_u8=images,
            member_indices=member_indices, batch_size=ENS_BATCH, device=dev,
            common_noise=common_noise)

    def peak_call(fn):
        """(fn(), launches, peak GiB, GiB above what was allocated before)."""
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(ops)
        out = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        return out, ops.launch_counts(), peak / 2**30, (peak - before) / 2**30

    # --- CIFAR: one stacked step against the member loop ---------------------
    trainer = trainer_of(subsets, common_noise=False)
    stacked = trainer.init_state(own_gamma_beta, seed=0)
    looped = [unstack_state(stacked, m) for m in range(m_count)]
    start = {n: p.detach().clone() for n, p in stacked.params.items()}
    raw, t, noise = trainer.draws(0)
    batch = trainer.batch(raw)
    members_step = make_members_step(trainer.tx, trainer.schedule)
    member_step = make_train_step(trainer.tx, trainer.schedule, trainer.spec)

    def stacked_call():
        return members_step(stacked, batch, t, noise)

    def looped_call():
        return [member_step(s, batch[m], timesteps=t[m], noise=noise[m])
                for m, s in enumerate(looped)]

    s_metrics, s_counts, s_peak, s_above = peak_call(stacked_call)
    l_metrics, l_counts, l_peak, l_above = peak_call(looped_call)
    names = list(stacked.params)
    l_loss = torch.stack([x["loss"] for x in l_metrics])
    loss_rel = ((s_metrics["loss"] - l_loss).abs() / l_loss.abs()).max().item()
    norm_rel = ((s_metrics["grad_norm"] - torch.stack([x["grad_norm"] for x in l_metrics])).abs()
                / s_metrics["grad_norm"]).max().item()
    g_err = g_max = 0.0
    w_rel, w_name = 0.0, None
    for m, state in enumerate(looped):
        member = dict(state.model.named_parameters())
        g_err = max(g_err, max((stacked.params[n].grad[m] - member[n].grad).abs().max().item()
                               for n in names))
        g_max = max(g_max, max(member[n].grad.abs().max().item() for n in names))
        w_rel, w_name = max((w_rel, w_name), moved_within(
            {n: start[n][m] for n in names}, {n: stacked.params[n][m].detach() for n in names},
            {n: member[n].detach() for n in names}), key=lambda x: x[0])
    log(f"[ensemble] CIFAR UNet2D {m_count} members at batch {ENS_BATCH} f32 (TF32 off), a "
        f"gamma/beta of their own, one stacked step vs the {m_count} member-steps one at a time "
        f"from the same states and draws on {card}: losses max rel {loss_rel:.3g}, gradient "
        f"norms max rel {norm_rel:.3g}, clipped gradients max |dg| / max |g| "
        f"{g_err / g_max:.3g} (tol {ENS_RTOL}), weights max ||dw|| / ||move|| {w_rel:.3g} "
        f"({w_name}; tol {ENS_MOVE_RTOL}); launches stacked {s_counts}, looped {l_counts}")
    if not (loss_rel <= ENS_RTOL and norm_rel <= ENS_RTOL and g_err <= ENS_RTOL * g_max
            and w_rel <= ENS_MOVE_RTOL and s_counts == unet_counts(1, 1)
            and l_counts == unet_counts(m_count, m_count)):
        raise AssertionError("the stacked step disagrees with the member loop")
    s_split = device_split(torch, stacked_call)
    l_split = device_split(torch, looped_call)
    s_sec = timed_steps(torch, stacked_call, ENS_TIMED)
    l_sec = timed_steps(torch, looped_call, ENS_TIMED)
    log(f"[ensemble] CIFAR {m_count} members at batch {ENS_BATCH} f32 on {card}: stacked "
        f"{s_sec:.4f} s an ensemble step ({m_count / s_sec:.3f} member-steps/s), looped "
        f"{l_sec:.4f} s ({m_count / l_sec:.3f} member-steps/s), mean of {ENS_TIMED}; peak "
        f"stacked {s_peak:.2f} GiB ({s_above:.2f} above the states), looped {l_peak:.2f} GiB "
        f"({l_above:.2f} above them, the stacked state included); a step's device time by "
        f"group, stacked: {split_line(s_split)}; looped: {split_line(l_split)}")
    log(f"[ensemble] stacked groups (ms) {({k: round(v, 3) for k, v in s_split.items()})}; "
        f"looped {({k: round(v, 3) for k, v in l_split.items()})}")
    del stacked, looped, start, batch, noise, s_metrics, l_metrics
    torch.cuda.empty_cache()

    # --- run_scanned against run, and identical subsets, under common noise ---
    same = [subsets[0], *subsets[:1], *subsets[2:]]
    trainer = trainer_of(same, common_noise=True)
    a = trainer.init_state(own_gamma_beta, seed=1)
    t0 = time.perf_counter()
    a, _ = trainer.run(a, ENS_SCAN_STEPS, seed=7)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    want = [x.cpu() for x in (list(a.params.values()) + a.ema + a.opt_state.mu
                              + a.opt_state.nu)]
    del a
    b = trainer.init_state(own_gamma_beta, seed=1)
    t0 = time.perf_counter()
    b, metrics = trainer.run_scanned(b, ENS_SCAN_STEPS, seed=7, chunk=ENS_SCAN_CHUNK)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    got = list(b.params.values()) + b.ema + b.opt_state.mu + b.opt_state.nu
    bitwise = all(torch.equal(x.cpu(), y) for x, y in zip(got, want))
    twins = all(torch.equal(x[0], x[1]) for x in got)
    others = not torch.equal(got[0][0], got[0][2])
    log(f"[ensemble] run_scanned({ENS_SCAN_STEPS}, chunk={ENS_SCAN_CHUNK}) vs run("
        f"{ENS_SCAN_STEPS}), {m_count} members under common noise, members 0 and 1 on one "
        f"subset: states bitwise equal={bitwise} (run {run_s / ENS_SCAN_STEPS:.4f} s a step, "
        f"run_scanned {scan_s / ENS_SCAN_STEPS:.4f}; metrics {tuple(metrics['loss'].shape)}); "
        f"members 0 and 1 bitwise equal={twins}, member 2 differs={others}")
    if not (bitwise and twins and others and metrics["loss"].shape == (ENS_SCAN_STEPS, m_count)):
        raise AssertionError("run_scanned, run or the common-noise twins disagree")
    del b, got, want, trainer
    torch.cuda.empty_cache()

    # --- miniSD: stacked LoRA members against each member alone --------------
    model = build_unet(MINISD_UNET, seed=3, device=dev).eval().requires_grad_(False)
    n_gn = sum(isinstance(x, GroupNormSiLU) for x in model.modules())
    n_attn = sum(isinstance(x, CrossAttention) for x in model.modules())
    rng = torch.Generator(device=dev).manual_seed(4)
    trees = []
    for m in range(ENS_TTI_MEMBERS):
        tree = lora_init(model, TTI_RANK, generator=torch.Generator(device=dev).manual_seed(m))
        for ab in tree.values():  # a live side branch: up is 0 at init
            ab["up"] = 1e-2 * torch.randn(ab["up"].shape, generator=rng, device=dev)
        trees.append(tree)
    n_img, artists = TTI_ARTISTS * TTI_PER_ARTIST, TTI_ARTISTS
    latents = torch.randn((n_img, 4, 32, 32), generator=rng, device=dev)
    emb = torch.randn((artists, 77, MINISD_UNET.cross_attention_dim), generator=rng, device=dev)
    img_artist = torch.arange(n_img, device=dev) // TTI_PER_ARTIST
    mm = ENS_TTI_MEMBERS
    idx = torch.randint(0, n_img, (mm, TTI_BATCH), generator=rng, device=dev)
    tt = torch.randint(0, MINISD_SCHEDULER.num_train_timesteps, (mm, TTI_BATCH), generator=rng,
                       device=dev)
    nn_ = torch.randn((mm, TTI_BATCH, 4, 32, 32), generator=rng, device=dev)
    schedule = make_schedule(MINISD_SCHEDULER, dev)

    def lora_run(members, count=True):
        tx = make_optimizer("adamw", lr=3e-4, weight_decay=1e-6, lr_schedule="cosine",
                            total_steps=TTI_STEPS)
        tree = stack_lora_trees([trees[m] for m in members])
        leaves = lora_leaves(tree)
        for leaf in leaves:
            leaf.requires_grad_(True)
        opt = tx.init(leaves)
        sel = torch.tensor(members, device=dev)

        def call():
            return lora_members_step(model, tree, tx, opt, latents, emb, img_artist,
                                     idx[sel], tt[sel], nn_[sel], schedule)
        return call, tree, opt, leaves

    call, tree, opt, leaves = lora_run(list(range(mm)))
    loss, ls_counts, ls_peak, ls_above = peak_call(call)
    s_mu = [x.clone() for x in opt.mu]
    s_leaves = [x.detach().clone() for x in leaves]
    alone, la_counts, la_peak, mu_err, mu_max, lw_rel = [], None, 0.0, 0.0, 0.0, 0.0
    for m in range(mm):
        a_call, a_tree, a_opt, a_leaves = lora_run([m])
        a_loss, counts, peak, _ = peak_call(a_call)
        la_counts = counts if la_counts is None else add_counts(la_counts, counts)
        la_peak = max(la_peak, peak)
        alone.append((a_call, a_loss))
        for i, (got_mu, want_mu) in enumerate(zip(s_mu, a_opt.mu)):
            mu_err = max(mu_err, (got_mu[m] - want_mu[0]).abs().max().item())
            mu_max = max(mu_max, want_mu.abs().max().item())
        start_m = {i: lora_leaves(stack_lora_trees([trees[m]]))[i][0] for i in range(len(leaves))}
        lw_rel = max(lw_rel, moved_within(start_m, {i: s_leaves[i][m] for i in start_m},
                                          {i: a_leaves[i][0].detach() for i in start_m})[0])
    a_losses = torch.cat([x for _, x in alone])
    l_rel = ((loss - a_losses).abs() / a_losses.abs()).max().item()
    want_one = tti_counts(n_attn, n_gn, n_gn - 3, 1, 1)
    log(f"[ensemble] miniSD {mm} LoRA members (rank {TTI_RANK}) at batch {TTI_BATCH} f32, the "
        f"base frozen, one members_step vs each member alone on {card}: losses max rel "
        f"{l_rel:.3g}, first moments max |d| / max |m| {mu_err / mu_max:.3g} (tol {ENS_RTOL}), "
        f"LoRA leaves max ||dw|| / ||move|| {lw_rel:.3g} (tol {ENS_MOVE_RTOL}); launches "
        f"stacked {ls_counts}, alone {la_counts}")
    if not (l_rel <= ENS_RTOL and mu_err <= ENS_RTOL * mu_max and lw_rel <= ENS_MOVE_RTOL
            and ls_counts == want_one and la_counts == add_counts(*[want_one] * mm)):
        raise AssertionError("stacked LoRA members disagree with each member alone")
    ls_split = device_split(torch, call)
    la_split = device_split(torch, lambda: [c() for c, _ in alone])
    ls_sec = timed_steps(torch, call, ENS_TIMED)
    la_sec = timed_steps(torch, lambda: [c() for c, _ in alone], ENS_TIMED)
    log(f"[ensemble] miniSD {mm} LoRA members at batch {TTI_BATCH} f32 on {card}: stacked "
        f"{ls_sec:.4f} s an ensemble step ({mm / ls_sec:.4f} member-steps/s), alone "
        f"{la_sec:.4f} s ({mm / la_sec:.4f}), mean of {ENS_TIMED}; peak stacked "
        f"{ls_peak:.2f} GiB ({ls_above:.2f} above the base), alone {la_peak:.2f} GiB; a step's "
        f"device time, stacked: {split_line(ls_split)}; alone: {split_line(la_split)}")
    del model, trees, tree, opt, leaves, alone, latents, nn_, s_mu, s_leaves
    torch.cuda.empty_cache()

    # --- cli.main --scan_chunk on the CIFAR stand-in, and its per-step loop ---
    total = unet_counts(0, 0)
    for tag, extra in (("--scan_chunk", ["--scan_chunk", str(ENS_MAIN_CHUNK)]),
                       ("per-step loop", [])):
        outdir = os.path.join(root, "ensemble_main", "scan" if extra else "loop")
        r, wall, counts, _, peak = timed_call(torch, ops, main_cli.main, [
            "--dataset", "cifar", "--removal_dist", "full", "--training_steps",
            str(ENS_MAIN_STEPS), "--batch_size", str(ENS_BATCH), "--log_freq",
            str(ENS_MAIN_CHUNK), "--ckpt_freq", "0", "--sample_freq", "0", "--outdir", outdir,
            "--device", "cuda", *extra])
        train_s = r["train_seconds"] - r["ckpt_seconds"]
        log(f"[ensemble] cli.main cifar retrain full {ENS_MAIN_STEPS} steps at batch "
            f"{r['batch_size']} f32, {tag} on {card}: {ENS_MAIN_STEPS / train_s:.3f} "
            f"member-steps/s without the checkpoint's {r['ckpt_seconds']:.3f} s, call "
            f"{wall:.3f} s, peak {peak:.2f} GiB, loss {r['loss']:.5f}, launches {counts}")
        if not (counts == unet_counts(ENS_MAIN_STEPS, ENS_MAIN_STEPS)
                and math.isfinite(r["loss"])
                and get_max_steps(r["model_dir"]) == ENS_MAIN_STEPS):
            raise AssertionError(f"cli.main {tag}: launches {counts}, loss {r['loss']}")
        total = add_counts(total, counts)
    return total


def check_training_path(torch, np, ops, train_ensemble, root: str, card: str):
    """train_ensemble.main at full width: a warm-up run, then the timed run
    with the launch counters reset just before and read just after."""
    from group_attribution_for_diffusion_models_tpu_torch.utils.ckpt import (
        get_max_steps, load_checkpoint)
    from group_attribution_for_diffusion_models_tpu_torch.utils.jsonl import read_records

    def argv(outdir, steps):
        return ["--dataset", "cifar", "--removal_dist", "shapley",
                "--seed_start", str(TRAIN_SEED_START), "--num_seeds", str(TRAIN_MEMBERS),
                "--batch_size", str(TRAIN_BATCH),
                "--training_steps", str(steps), "--eval_loss",
                "--n_samples", str(TRAIN_SAMPLES),
                "--num_inference_steps", str(TRAIN_SAMPLE_STEPS),
                "--outdir", outdir, "--device", "cuda"]

    t0 = time.perf_counter()
    train_ensemble.main(argv(os.path.join(root, "warm"), TRAIN_WARM_STEPS))
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    t0 = time.perf_counter()
    summary = train_ensemble.main(argv(os.path.join(root, "run"), TRAIN_STEPS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    m, steps = TRAIN_MEMBERS, TRAIN_STEPS
    member_steps = m * steps
    train_s = summary["train_seconds"]
    if summary["batch_size"] != TRAIN_BATCH:
        raise AssertionError(f"members trained at batch {summary['batch_size']}")
    log(f"[train] train_ensemble cifar {m} members x {steps} steps at batch "
        f"{summary['batch_size']} "
        f"f32 on {card}: {train_s / steps:.4f} s per ensemble step, "
        f"{member_steps / train_s:.3f} member-steps/s ({train_s:.3f} s of training; "
        f"eval + {TRAIN_SAMPLES} samples x {TRAIN_SAMPLE_STEPS} steps per member "
        f"{summary['sample_seconds']:.3f} s of sampling), call {wall:.3f} s "
        f"(warm-up call of {TRAIN_WARM_STEPS} steps {warm_s:.3f} s), peak {peak_gib:.2f} GiB")
    # The members are stacked: one launch a kernel site a step for all of them;
    # the eval loss and the samples run member by member.
    want = unet_counts(steps + m * (1 + TRAIN_SAMPLE_STEPS), steps)
    log(f"[train] launches {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"training path launches {counts}, expected {want}")
    losses = np.asarray(summary["losses"])
    evals = np.asarray(summary["eval_losses"])
    samples = summary["samples"]
    log(f"[train] losses {losses.round(5).tolist()}; eval losses {evals.round(5).tolist()}; "
        f"samples {samples.shape} in [{samples.min():.3f}, {samples.max():.3f}]")
    if not (len(losses) == m and np.isfinite(losses).all() and len(evals) == m
            and np.isfinite(evals).all() and np.isfinite(samples).all()
            and samples.shape == (m, TRAIN_SAMPLES, 3, 32, 32)):
        raise AssertionError("training path: non-finite or missing losses or samples")
    dirs = summary["model_dirs"]
    ckpts = [get_max_steps(d) for d in dirs]
    rows = list(read_records(summary["db"]))
    first = [load_checkpoint(d)["params"] for d in dirs[:2]]
    subsets = [np.load(os.path.join(d, "remaining_idx.npy")) for d in dirs[:2]]
    differ = max((first[0][k] - first[1][k]).abs().max().item() for k in first[0])
    log(f"[train] checkpoints at step {ckpts}; {len(rows)} DB rows for seeds "
        f"{sorted(r['removal_seed'] for r in rows)}; members 0 and 1 keep "
        f"{len(subsets[0])} and {len(subsets[1])} images, their weights differ by up to "
        f"{differ:.3g}")
    seeds = list(range(TRAIN_SEED_START, TRAIN_SEED_START + m))
    if not (ckpts == [steps] * m and len(rows) == m
            and sorted(r["removal_seed"] for r in rows) == seeds):
        raise AssertionError("training path: checkpoints or DB rows missing")
    if np.array_equal(subsets[0], subsets[1]) or not differ > 0:
        raise AssertionError("members on different subsets ended with equal weights")
    return counts


def check_woodfisher(torch, np, spec, dev) -> None:
    """One WoodFisher inverse-HVP at full CIFAR width, card against CPU, from
    the same weights, images, vector and injected draws (WF_BATCHES batches of
    WF_BATCH)."""
    from group_attribution_for_diffusion_models_tpu_torch.config.registry import get_config
    from group_attribution_for_diffusion_models_tpu_torch.diffusion import make_schedule
    from group_attribution_for_diffusion_models_tpu_torch.models import UNet2D, build_unet
    from group_attribution_for_diffusion_models_tpu_torch.unlearn import woodfisher_inv_hvp

    sched = get_config("cifar").scheduler
    weights = build_unet(spec, seed=2).state_dict()
    rng = np.random.default_rng(6)
    n = WF_BATCH * WF_BATCHES
    images = rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)
    draws = [(torch.from_numpy(rng.integers(0, sched.num_train_timesteps, WF_BATCH)),
              torch.from_numpy(rng.standard_normal((WF_BATCH, 3, 32, 32)).astype(np.float32)))
             for _ in range(WF_BATCHES)]
    dim = sum(w.numel() for w in weights.values())
    vector = torch.from_numpy(rng.standard_normal(dim).astype(np.float32))

    def run(device):
        model = UNet2D(spec)
        model.load_state_dict(weights)
        model.to(device)
        k = woodfisher_inv_hvp(model, make_schedule(sched, device), sched, images,
                               vector.to(device), num_batches=WF_BATCHES, batch_size=WF_BATCH,
                               draws=draws)
        return (k.cpu() - vector)

    want, got = run("cpu"), run(dev)
    rel = (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)).item()
    log(f"[unlearn] WoodFisher k_vec, CIFAR UNet2D ({dim} params) {WF_BATCHES} batches of "
        f"{WF_BATCH}, injected draws, card vs CPU: |k - v| {torch.linalg.vector_norm(want):.6g}, "
        f"relative L2 error of k - v {rel:.3g} (tol {WF_RTOL})")
    if not (rel <= WF_RTOL and torch.isfinite(got).all()):
        raise AssertionError("WoodFisher on the card disagrees with the CPU")


def check_unlearn(torch, np, ops, root: str, card: str, dev, vq_weights: str) -> dict:
    """The single-model jobs at full width: cli.main (retrain, its resume,
    prune_fine_tune from [pipeline]'s pruned model, ga), cli.unlearn (iu, gd,
    ga, lora; local and global behaviors), CelebA's main and iu in VQ latents,
    and the readers (attribute, empirical_verification, shapley_groundtruth),
    each between a counter reset and a read with the launches the code implies.
    Returns the summed kernel launches."""
    from group_attribution_for_diffusion_models_tpu_torch.cli import (
        attribute, empirical_verification, main as main_cli, shapley_groundtruth,
        train_ensemble, unlearn)
    from group_attribution_for_diffusion_models_tpu_torch.config import constants
    from group_attribution_for_diffusion_models_tpu_torch.config.registry import get_config
    from group_attribution_for_diffusion_models_tpu_torch.models import UNet2D
    from group_attribution_for_diffusion_models_tpu_torch.models.layers import (
        GroupNormSiLU, SelfAttention2D)
    from group_attribution_for_diffusion_models_tpu_torch.models.lora import target_modules
    from group_attribution_for_diffusion_models_tpu_torch.utils.ckpt import load_checkpoint

    check_woodfisher(torch, np, get_config("cifar").unet, dev)
    outdir = os.path.join(root, "unlearn")
    pipe = os.path.join(root, "pipeline")
    pruned = os.path.join(pipe, "cifar", "prune", "models", "full")
    zero = unet_counts(0, 0)
    no_routes = {name: 0 for name in ops.PLAIN_ROUTES}
    total = dict(zero)
    peaks = []

    def call(label, fn, argv, want):
        nonlocal total
        out, wall, counts, routes, peak = timed_call(torch, ops, fn, argv)
        expect(label, counts, routes, want, no_routes, phase="unlearn")
        total = add_counts(total, counts)
        peaks.append(peak)
        return out, wall, peak

    def main_argv(*extra):
        return ["--dataset", "cifar", "--outdir", outdir, "--batch_size", str(UNL_BATCH),
                "--ckpt_freq", "0", "--sample_freq", "0", "--device", "cuda", *extra]

    # cli.main: the full model, then the same command, which resumes.
    full_argv = main_argv("--method", "retrain", "--removal_dist", "full",
                          "--training_steps", str(UNL_STEPS))
    r, wall, peak = call("main retrain", main_cli.main, full_argv,
                         unet_counts(UNL_STEPS, UNL_STEPS))
    fit_s = r["train_seconds"] - r["ckpt_seconds"]
    log(f"[unlearn] cli.main cifar retrain full {UNL_STEPS} steps at batch {r['batch_size']} f32 "
        f"on {card}: training {r['train_seconds']:.3f} s ({UNL_STEPS / fit_s:.3f} member-steps/s "
        f"without the checkpoint's {r['ckpt_seconds']:.3f} s), call {wall:.3f} s, peak "
        f"{peak:.2f} GiB, loss {r['loss']:.5f}")
    full = r["model_dir"]
    again, wall2, _ = call("main resume", main_cli.main, full_argv, zero)
    log(f"[unlearn] the same command again: resumed {again['resumed']} at step "
        f"{again['start_step']}, {again['steps_run']} steps run, call {wall2:.3f} s")
    if not (r["steps_run"] == UNL_STEPS and math.isfinite(r["loss"]) and again["resumed"]
            and again["start_step"] == UNL_STEPS and again["row"] is None):
        raise AssertionError("cli.main did not train, or its second call did not resume")

    # Retrain and prune_fine_tune on shapley seeds, for the readers; ga from the full model.
    for method, extra in (("retrain", []), ("prune_fine_tune", ["--pruned_model_dir", pruned])):
        for seed in UNL_SEEDS:
            r, wall, _ = call(f"main {method} seed {seed}", main_cli.main, main_argv(
                "--method", method, "--removal_dist", "shapley", "--removal_seed", str(seed),
                "--by_class", "--training_steps", str(UNL_SEED_STEPS), *extra),
                unet_counts(UNL_SEED_STEPS, UNL_SEED_STEPS))
            log(f"[unlearn] cli.main {method} shapley seed {seed}: {len(r['row']['remaining_idx'])} "
                f"images kept, {UNL_SEED_STEPS} steps {r['train_seconds']:.3f} s, call "
                f"{wall:.3f} s, loss {r['loss']:.5f}, spec pruned "
                f"{bool(r['spec'].pruned_channels)}")
            if method == "prune_fine_tune" and not r["spec"].pruned_channels:
                raise AssertionError("prune_fine_tune did not take the pruned spec")
    r, wall, _ = call("main ga", main_cli.main, main_argv(
        "--method", "ga", "--removal_dist", "shapley", "--removal_seed", str(UNL_UNLEARN_SEED),
        "--by_class", "--load", full, "--training_steps", str(UNL_SEED_STEPS)),
        unet_counts(UNL_SEED_STEPS, UNL_SEED_STEPS))
    log(f"[unlearn] cli.main ga on the {len(r['row']['removed_idx'])} removed images of shapley "
        f"seed {UNL_UNLEARN_SEED}: {r['train_seconds']:.3f} s, call {wall:.3f} s, loss "
        f"{r['loss']:.5f}")

    # cli.unlearn on the full model.
    def unlearn_argv(method, behavior, samples, *extra):
        n, k = samples
        return ["--dataset", "cifar", "--method", method, "--load", full, "--outdir", outdir,
                "--removal_dist", "shapley", "--removal_seed", str(UNL_UNLEARN_SEED),
                "--by_class", "--model_behavior", behavior, "--n_samples", str(n),
                "--num_inference_steps", str(k), "--batch_size", str(UNL_BATCH),
                "--training_steps", str(UNL_UNLEARN_STEPS), "--device", "cuda", *extra]

    def report(label, out, wall, peak):
        log(f"[unlearn] cli.unlearn {label} f32 on {card}: unlearning "
            f"{out['unlearn_seconds']:.3f} s, sampling {out['sampling_seconds']:.3f} s, scoring "
            f"{out['scoring_seconds']:.3f} s, call {wall:.3f} s, peak {peak:.2f} GiB; scores "
            f"{ {k: v for k, v in out['scores'].items() if not isinstance(v, list)} }")
        vals = [v for v in out["scores"].values() if not isinstance(v, list)]
        if not (vals or out["row"]["model_behavior"] == "none") or not all(
                math.isfinite(v) for v in vals):
            raise AssertionError(f"cli.unlearn {label}: scores {out['scores']}")

    n, k = UNL_LOCAL
    steps = UNL_UNLEARN_STEPS
    for method in ("gd", "ga"):
        out, wall, peak = call(f"unlearn {method} local", unlearn.main,
                               unlearn_argv(method, "local", UNL_LOCAL),
                               unet_counts(steps + 2 * k, steps))
        report(f"{method} local ({steps} steps, {n} paired samples x {k} steps)", out, wall, peak)
    sums = ops.group_norm_silu.affine_sums
    out, wall, peak = call("unlearn lora local", unlearn.main,
                           unlearn_argv("lora", "local", UNL_LOCAL, "--lora_rank",
                                        str(UNL_LORA_RANK)),
                           unet_counts(steps + 2 * k, 0, attention_only=steps))
    report(f"lora local (rank {UNL_LORA_RANK}, {steps} steps, the base frozen; GroupNorm "
           f"affine reductions {ops.group_norm_silu.affine_sums - sums})", out, wall, peak)
    if ops.group_norm_silu.affine_sums != sums:
        raise AssertionError("LoRA unlearning reduced a frozen GroupNorm's gamma/beta")
    with torch.device("meta"):
        lora_targets = {f"{name}.weight"
                        for name, _ in target_modules(UNet2D(get_config("cifar").unet))}
    sd = out["state_dict"]
    base = load_checkpoint(full)["params"]
    moved = sorted(n_ for n_ in base if not torch.equal(sd[n_].cpu(), base[n_]))
    if not (moved and set(moved) <= lora_targets):
        raise AssertionError(f"lora merge moved {moved[:4]}..., not only attention projections")
    gn, gk = UNL_GLOBAL
    out, wall, peak = call("unlearn gd global", unlearn.main,
                           unlearn_argv("gd", "global", UNL_GLOBAL),
                           unet_counts(steps + gk, steps))
    report(f"gd global ({gn} samples x {gk} steps; FID, IS, P&R against {4 * gn} training "
           "images)", out, wall, peak)

    # iu and the exact game on a small stand-in: UNL_SMALL_CLASSES classes.
    small = os.path.join(root, "datasets_small")
    write_cifar_standin(small, UNL_SMALL_IMAGES, seed=3, classes=UNL_SMALL_CLASSES)
    cifar_root, constants.DATASET_DIR = constants.DATASET_DIR, small
    try:
        argv = unlearn_argv("iu", "local", UNL_LOCAL, "--wf_batches", str(UNL_WF_BATCHES))
        out, wall, counts, routes, peak = timed_call(torch, ops, unlearn.main, argv)
        n_rm, n_kp = len(out["row"]["removed_idx"]), len(out["row"]["remaining_idx"])
        bs = min(UNL_BATCH, 32)

        def full_batches(m):
            return max(m // bs, 1)

        wf = min(UNL_WF_BATCHES, n_kp // max(bs // 4, 1))
        nb = full_batches(n_rm) + full_batches(n_kp) + wf
        expect("unlearn iu local", counts, routes, unet_counts(nb + 2 * k, nb), no_routes,
               phase="unlearn")
        total = add_counts(total, counts)
        peaks.append(peak)
        sec = out["iu_seconds"]
        report(f"iu local on the {UNL_SMALL_IMAGES}-image stand-in ({n_rm} removed, {n_kp} kept; "
               f"g_removed {sec['g_removed']:.3f} s, g_remaining {sec['g_remaining']:.3f} s, "
               f"WoodFisher {sec['woodfisher']:.3f} s over {wf} batches of {bs // 4})",
               out, wall, peak)
        members = 2**UNL_SMALL_CLASSES - 1
        # The enumerated subsets train in stacked train_ensemble calls of the
        # default --chunk_size.
        gt_steps = -(-members // train_ensemble.MEMBERS_PER_CALL) * UNL_GT_STEPS
        g, wall, peak = call("shapley_groundtruth", shapley_groundtruth.main, [
            "--dataset", "cifar", "--outdir", os.path.join(outdir, "groundtruth"),
            "--training_steps", str(UNL_GT_STEPS), "--batch_size", str(UNL_BATCH),
            "--fit_counts", "4,8", "--num_estimate_seeds", "2", "--device", "cuda"],
            unet_counts(gt_steps + members + 1, gt_steps))
    finally:
        constants.DATASET_DIR = cifar_root
    exact, v1, v0 = g["exact"], g["v1"], g["v0"]
    resid = abs(exact.sum() - (v1 - v0))
    limit = EFFICIENCY_RTOL * max(1.0, abs(v1 - v0))
    log(f"[unlearn] shapley_groundtruth cifar {UNL_SMALL_CLASSES} classes ({members} subsets x "
        f"{UNL_GT_STEPS} steps + the null model) on {card}: train {g['summary']['train_time_s']} "
        f"s, call {wall:.3f} s; exact {np.round(exact, 6).tolist()}, v1 {v1:.6f}, v0 {v0:.6f}, "
        f"efficiency residual {resid:.3g} (limit {limit:.3g}); curve "
        f"{[(c['dist'], c['fit_subsets'], c['mse']) for c in g['summary']['convergence']]}")
    if not (exact.shape == (UNL_SMALL_CLASSES,) and np.isfinite(exact).all() and resid <= limit):
        raise AssertionError(f"shapley_groundtruth: exact {exact}, residual {resid}")

    # The readers on the rows written above (datamodel on [pipeline]'s test rows).
    db = os.path.join(outdir, "cifar_train_db.jsonl")
    attrs, wall, _ = call("attribute shapley", attribute.main, [
        "--dataset", "cifar", "--by_class", "--attribution_method", "shapley",
        "--train_db", db, "--method", "retrain", "--model_behavior_key", "loss",
        "--save_path", os.path.join(outdir, "attrs", "shapley.npy")], zero)
    dm, wall_dm, _ = call("attribute datamodel", attribute.main, [
        "--dataset", "cifar", "--by_class", "--attribution_method", "datamodel",
        "--train_db", os.path.join(pipe, "cifar_pipeline_db.jsonl"), "--method", "retrain",
        "--model_behavior_key", "eval_loss",
        "--save_path", os.path.join(outdir, "attrs", "datamodel.npy")], zero)
    ev, wall_ev, _ = call("empirical_verification", empirical_verification.main, [
        "--db", db, "--baseline_method", "retrain", "--method", "prune_fine_tune",
        "--removal_dist", "shapley", "--model_behavior_key", "loss"], zero)
    log(f"[unlearn] attribute shapley ({len(UNL_SEEDS)} retrain rows, loss) {wall:.3f} s: "
        f"{np.round(attrs, 5).tolist()}; datamodel ([pipeline]'s test rows, eval_loss) "
        f"{wall_dm:.3f} s: {np.round(dm, 5).tolist()}; empirical_verification retrain vs "
        f"prune_fine_tune over seeds {ev['seeds']} {wall_ev:.3f} s: pearson {ev['pearson']:.4f}, "
        f"spearman {ev['spearman']:.4f}")
    if not (attrs.shape == dm.shape == (10,) and np.isfinite(attrs).all()
            and np.isfinite(dm).all() and ev["seeds"] == list(UNL_SEEDS)
            and math.isfinite(ev["pearson"])):
        raise AssertionError("the readers' outputs are missing or not finite")

    # CelebA: cli.main and iu in VQ latents, [ldm]'s weights and latents cache.
    cfg = get_config("celeba")
    with torch.device("meta"):
        ldm_unet = UNet2D(cfg.unet)
    n_attn = sum(isinstance(m, SelfAttention2D) for m in ldm_unet.modules())
    n_gn = sum(isinstance(m, GroupNormSiLU) for m in ldm_unet.modules())
    cache = os.path.join(root, "ldm", "celeba", "precomputed_emb")
    shutil.copytree(cache, os.path.join(outdir, "celeba", "precomputed_emb"))
    ldm_common = ["--dataset", "celeba", "--outdir", outdir, "--vqvae_weights", vq_weights,
                  "--removal_dist", "shapley", "--removal_seed", str(UNL_UNLEARN_SEED),
                  "--by_class", "--batch_size", str(UNL_LDM_BATCH), "--device", "cuda"]
    r, wall, peak = call("celeba main retrain", main_cli.main, ldm_common + [
        "--method", "retrain", "--training_steps", str(UNL_LDM_STEPS), "--ckpt_freq", "0"],
        model_counts(n_attn, n_gn, UNL_LDM_STEPS, UNL_LDM_STEPS))
    log(f"[unlearn] cli.main celeba retrain {UNL_LDM_STEPS} steps at batch {r['batch_size']} f32 "
        f"on {card}: training {r['train_seconds']:.3f} s (checkpoint {r['ckpt_seconds']:.3f} s), "
        f"latents {r['encode_seconds']:.3f} s, call {wall:.3f} s, peak {peak:.2f} GiB, loss "
        f"{r['loss']:.5f}")
    n_rm, n_kp = len(r["row"]["removed_idx"]), len(r["row"]["remaining_idx"])
    bs = UNL_LDM_BATCH
    nb = (max(n_rm // bs, 1) + max(n_kp // bs, 1)
          + min(UNL_WF_BATCHES, n_kp // (bs // 4)))
    out, wall, peak = call("celeba unlearn iu", unlearn.main, ldm_common + [
        "--method", "iu", "--load", r["model_dir"], "--model_behavior", "none",
        "--wf_batches", str(UNL_WF_BATCHES)], model_counts(n_attn, n_gn, nb, nb))
    sec = out["iu_seconds"]
    report(f"iu celeba in VQ latents ({n_rm} removed, {n_kp} kept; g_removed "
           f"{sec['g_removed']:.3f} s, g_remaining {sec['g_remaining']:.3f} s, WoodFisher "
           f"{sec['woodfisher']:.3f} s; {nb} forward and backward passes at batch <= {bs})",
           out, wall, peak)
    log(f"[unlearn] launches of the phase {total}, peak of its calls {max(peaks):.2f} GiB")
    return total


def check_local_jl(torch, np, ops, dev, card: str) -> None:
    """B5 at LOC_JL, the CelebA U-Net's per-sample gradients at batch 8: B*D
    passes 2^31. The kernel against the plain version (its d-tile loop over
    the window's coordinates) on a G that is zero outside the last
    LOC_JL_WINDOW coordinates of every row, where the last row's offsets
    b*D + d all pass 2^31; two runs bitwise; then timed on a random G of the
    full shape beside its bound."""
    b, d, p = LOC_JL
    w0 = d - LOC_JL_WINDOW
    if (b - 1) * d + w0 < 2**31 or b * d <= 2**31:
        raise AssertionError("LOC_JL's window does not pass the 2^31 offset")
    gen = torch.Generator(device=dev).manual_seed(11)
    g = torch.zeros(b, d, device=dev)
    g[:, w0:] = torch.randn(b, LOC_JL_WINDOW, generator=gen, device=dev)
    got = ops.jl_project_kernel(g, p, seed=3)
    same = torch.equal(got, ops.jl_project_kernel(g, p, seed=3))
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = torch.zeros(b, p, device=dev)
    for d0 in range(w0, d, JL_PLAIN_TILE_D):
        d1 = min(d, d0 + JL_PLAIN_TILE_D)
        want += g[:, d0:d1] @ ops.rademacher_rows(3, d0, d1, p, dev)
    want *= float(np.float32(1.0 / math.sqrt(p)))
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    err = (got - want).abs().amax(dim=1)
    limit = JL_RTOL * g.abs().sum(dim=1) / math.sqrt(p)
    ok = bool((err <= limit).all())
    del g
    torch.cuda.empty_cache()
    g = torch.randn(b, d, generator=gen, device=dev)
    ms = cuda_ms(torch, lambda: ops.jl_project_kernel(g, p), iters=3)
    nbytes, flops = b * d * 4 + b * p * 4, 2.0 * b * d * p
    bms, by = bound(nbytes, flops, "float32", JL_FLOPS)
    log(f"[local] jl_projection B={b} D={d} P={p} float32 (B*D = {b * d} > 2^31): kernel vs "
        f"plain on the last {LOC_JL_WINDOW} coordinates of every row (last row's offsets "
        f"{(b - 1) * d + w0}..{b * d - 1}): max_abs_err={err.max().item():.3g} per row "
        f"{[round(e, 7) for e in err.tolist()]} (tol {JL_RTOL} * |G_b|_1 / sqrt(P)), bitwise "
        f"repeatable={same}; on {card}: kernel_ms={ms:.4f} at the full shape "
        f"({flops / ms / 1e9:.2f} TFLOP/s), plain_ms={plain_ms:.4f} (one call over the window "
        f"alone, d-tile {JL_PLAIN_TILE_D}), bound_ms={bms:.4f} ({by}); library none (R would be "
        f"{d * p * 4 / 1e12:.1f} TB)")
    del g
    torch.cuda.empty_cache()
    if not (ok and same):
        raise AssertionError(f"JL kernel at {LOC_JL} disagrees past the 2^31 offset: {err}")


def check_local_vmapped(torch, F, ops, dev, card: str) -> None:
    """The CelebA U-Net's attention (head dim 32 at its three levels) and
    GroupNorms (its four resnet widths, G=32, SiLU, eps 1e-5) under
    vmap(grad) at LOC_BATCH, as grad_features runs them: one launch of each
    kernel for the batch; dq, dk, dv and dx against the plain versions on the
    folded tensors (TOL), the per-sample dgamma and dbeta against the plain
    backward's (B, C) partials (SUM_TOL); the vmap(grad) call event-timed
    beside the plain forward and backward, the library call on the folded
    tensors (SDPA's forward and autograd backward; F.group_norm + F.silu's,
    whose gamma/beta gradient is the batch's sum, a yardstick) and the bound."""
    from torch.func import grad, vmap

    b = LOC_BATCH
    one_attn = {"attention_fwd": 1, "attention_bwd_dq": 1, "attention_bwd_dkv": 1}
    for sq, h, d in LOC_VMAP_ATTN:
        gen = torch.Generator(device=dev).manual_seed(5)
        q, k, v, w = (torch.randn(b, 1, sq, h, d, generator=gen, device=dev) for _ in range(4))

        def f(q1, k1, v1, w1):
            return (ops.dot_product_attention(q1, k1, v1) * w1).sum()

        per_sample = vmap(grad(f, argnums=(0, 1, 2)))
        reset_counts(ops)
        got = per_sample(q, k, v, w)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        qf, kf, vf, wf = (t.reshape(-1, *t.shape[2:]) for t in (q, k, v, w))
        want = ops.attention_bwd_plain(qf, kf, vf, wf)
        cmp = [compare(a.reshape(-1, *a.shape[2:]), e, "float32") for a, e in zip(got, want)]
        ms = cuda_ms(torch, lambda: per_sample(q, k, v, w), iters=5)
        dev_ms = device_ms(torch, lambda: per_sample(q, k, v, w), iters=5)
        plain_ms = cuda_ms(torch, lambda: (ops.attention_plain(qf, kf, vf),
                                           ops.attention_bwd_plain(qf, kf, vf, wf)), iters=5)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (qf, kf, vf))

        def sdpa():
            out = F.scaled_dot_product_attention(qt, kt, vt)
            return torch.autograd.grad(out, (qt, kt, vt), wf.transpose(1, 2))

        lib_ms = cuda_ms(torch, sdpa, iters=5)
        bms, by = bound(8 * b * sq * h * d * 4, 14.0 * b * h * sq * sq * d, "float32", TC_FLOPS)
        log(f"[local] vmapped attention B={b} Sq=Skv={sq} H={h} D={d} float32 (CelebA, one "
            f"sample each) under vmap(grad): max_abs_err dq={cmp[0][0]:.3g} dk={cmp[1][0]:.3g} "
            f"dv={cmp[2][0]:.3g} (tol {TOL['float32']}); launches {counts}; on {card}: "
            f"vmap(grad) call {ms:.4f} ms event, {dev_ms:.4f} ms device (every kernel of the "
            f"call), plain_ms={plain_ms:.4f} library_ms="
            f"{lib_ms:.4f} (SDPA forward and autograd backward) bound_ms={bms:.4f} ({by})")
        if not (all(ok for _, ok in cmp) and all(counts[n] == c for n, c in one_attn.items())):
            raise AssertionError(f"vmapped attention at Sq={sq}: {cmp} {counts}")
        del q, k, v, w, got, want, qt, kt, vt
        torch.cuda.empty_cache()

    one_gn = {"group_norm_fwd": 1, "group_norm_bwd": 1}
    for c, hh, ww in LOC_VMAP_GN:
        gen = torch.Generator(device=dev).manual_seed(6)
        x, w = (torch.randn(b, c, hh, ww, generator=gen, device=dev) for _ in range(2))
        gamma, beta = (torch.randn(c, generator=gen, device=dev) * 0.2 + s for s in (1.0, 0.0))

        def f(x1, gam, bet, w1):
            return (ops.group_norm_silu(x1[None], gam, bet, groups=32, eps=1e-5, silu=True)
                    * w1[None]).sum()

        per_sample = vmap(grad(f, argnums=(0, 1, 2)), in_dims=(0, None, None, 0))
        reset_counts(ops)
        got = per_sample(x, gamma, beta, w)
        torch.cuda.synchronize()
        counts = ops.launch_counts()

        def plain():
            _, mean, rstd = ops.group_norm_silu_plain(x, gamma, beta, 32, 1e-5, True,
                                                      torch.float32)
            return ops.group_norm_silu_bwd_plain(x, w, gamma, beta, mean, rstd, 32, True)

        want = plain()
        cmp = [compare(got[0], want[0], "float32"), compare_sum(got[1], want[1]),
               compare_sum(got[2], want[2])]
        ms = cuda_ms(torch, lambda: per_sample(x, gamma, beta, w), iters=5)
        dev_ms = device_ms(torch, lambda: per_sample(x, gamma, beta, w), iters=5)
        plain_ms = cuda_ms(torch, plain, iters=5)
        xt = x.detach().requires_grad_(True)
        gt, bt = (t.detach().requires_grad_(True) for t in (gamma, beta))

        def library():
            out = F.silu(F.group_norm(xt, 32, gt, bt, eps=1e-5))
            return torch.autograd.grad(out, (xt, gt, bt), w)

        lib_ms = cuda_ms(torch, library, iters=5)
        bms, by = bound(5 * x.numel() * 4 + 2 * 2 * b * c * 4, 20.0 * x.numel(), "float32")
        log(f"[local] vmapped GroupNorm+SiLU B={b} C={c} {hh}x{ww} G=32 (cpg {c // 32}) float32 "
            f"(CelebA, one sample each, a dgamma/dbeta per sample) under vmap(grad): "
            f"max_abs_err dx={cmp[0][0]:.3g} (tol {TOL['float32']}) dgamma={cmp[1][0]:.3g} "
            f"dbeta={cmp[2][0]:.3g} (tol {SUM_TOL}); launches {counts}; on {card}: vmap(grad) "
            f"call {ms:.4f} ms event, {dev_ms:.4f} ms device, plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} "
            f"(F.group_norm + F.silu forward and autograd backward on the batch, summed "
            f"gamma/beta) bound_ms={bms:.4f} ({by})")
        if not (all(ok for _, ok in cmp) and all(counts[n] == k for n, k in one_gn.items())):
            raise AssertionError(f"vmapped GroupNorm at C={c}: {cmp} {counts}")
        del x, w, got, want, xt
        torch.cuda.empty_cache()


def check_local(torch, np, ops, root: str, card: str, dev) -> dict:
    """Per-example attribution and local behaviors on both unconditional
    workloads, at full width: B5 past 2^31 and the CelebA kernels under
    vmap(grad), then grad_features in VQ latents (every source, probe and
    attn_full) and traks on [ldm]'s CelebA full anchor; sketch_quality on
    CIFAR against [pipeline]'s DB; calculate_local_scores and
    calculate_local_loss on CIFAR and CelebA ([unlearn]'s cli.main models:
    the full model against shapley seed 1's). Each call between a counter
    reset and a read with the launches reckoned from the specs. Returns the
    summed launches."""
    import torch.nn.functional as F

    from group_attribution_for_diffusion_models_tpu_torch.cli import (
        calculate_local_loss, calculate_local_scores, grad_features, sketch_quality, traks)
    from group_attribution_for_diffusion_models_tpu_torch.config.registry import get_config
    from group_attribution_for_diffusion_models_tpu_torch.models import UNet2D
    from group_attribution_for_diffusion_models_tpu_torch.models.layers import (
        GroupNormSiLU, SelfAttention2D)
    from group_attribution_for_diffusion_models_tpu_torch.models.vqvae import VQVAE

    check_local_jl(torch, np, ops, dev, card)
    check_local_vmapped(torch, F, ops, dev, card)
    cfg = get_config("celeba")
    with torch.device("meta"):
        unet, vqvae = UNet2D(cfg.unet), VQVAE(cfg.vqvae)
    n_attn = sum(isinstance(m, SelfAttention2D) for m in unet.modules())
    n_gn = sum(isinstance(m, GroupNormSiLU) for m in unet.modules())
    n_enc = sum(isinstance(m, GroupNormSiLU) for m in vqvae.encoder.modules())
    n_dec = sum(isinstance(m, GroupNormSiLU) for m in vqvae.decoder.modules())
    del unet, vqvae
    zero = unet_counts(0, 0)
    no_routes = {name: 0 for name in ops.PLAIN_ROUTES}
    total = dict(zero)
    peaks = []

    def call(label, fn, argv, want, want_routes=no_routes):
        nonlocal total
        out, wall, counts, routes, peak = timed_call(torch, ops, fn, argv)
        expect(label, counts, routes, want, want_routes, phase="local")
        total = add_counts(total, counts)
        peaks.append(peak)
        return out, wall, peak

    def ldm(forwards, backwards=0, attention_only=0, jl=0):
        counts = model_counts(n_attn, n_gn, forwards, backwards + attention_only)
        counts["group_norm_bwd"] -= LOC_GN_SKIPPED * attention_only
        counts["jl_projection"] = jl
        return counts

    ldm_dir = os.path.join(root, "ldm")
    full_ldm = os.path.join(ldm_dir, "celeba", "retrain", "models", "full")
    vq_weights = os.path.join(ldm_dir, "celeba", "vqvae", "vqvae_weights.npy")
    store = os.path.join(root, "local", "celeba_feats.npz")
    common = ["--dataset", "celeba", "--outdir", ldm_dir, "--vqvae_weights", vq_weights,
              "--load", full_ldm, "--proj_dim", str(LOC_PROJ), "--num_timesteps",
              str(LOC_TIMESTEPS), "--batch_size", str(LOC_BATCH), "--device", "cuda"]
    n_batches = LOC_TRAIN // LOC_BATCH
    runs = [  # (label, extra argv, store, expected launches)
        ("train full", ["--source", "train", "--max_examples", str(LOC_TRAIN)], store,
         ldm(n_batches * LOC_TIMESTEPS, n_batches * LOC_TIMESTEPS, jl=n_batches)),
        ("generated full", ["--source", "generated", "--n_samples", str(LOC_BATCH),
                            "--num_inference_steps", str(LOC_GEN_STEPS)], store,
         ldm(LOC_GEN_STEPS + LOC_TIMESTEPS, LOC_TIMESTEPS, jl=1)),
        ("train probe", ["--source", "train", "--max_examples", str(LOC_BATCH), "--grad_mode",
                         "probe"], os.path.join(root, "local", "probe.npz"),
         ldm(LOC_TIMESTEPS, attention_only=LOC_TIMESTEPS, jl=1)),
        ("train attn_full", ["--source", "train", "--max_examples", str(LOC_BATCH),
                             "--grad_mode", "attn_full"], os.path.join(root, "local", "attn.npz"),
         ldm(LOC_TIMESTEPS, attention_only=LOC_TIMESTEPS, jl=1)),
        ("generated_journey full", ["--source", "generated_journey", "--n_samples",
                                    str(LOC_BATCH), "--num_inference_steps",
                                    str(LOC_JOURNEY_STEPS)],
         os.path.join(root, "local", "journey.npz"),
         ldm(2 * LOC_JOURNEY_STEPS, LOC_JOURNEY_STEPS, jl=1)),
    ]
    for label, extra, path, want in runs:
        out, wall, peak = call(f"grad_features celeba {label}", grad_features.main,
                               common + extra + ["--save_path", path], want)
        split = ", ".join(f"{t:.3f} = {g:.3f} + {j:.3f}" for t, g, j in zip(
            out["batch_seconds"], out["grad_seconds"], out["jl_seconds"]))
        log(f"[local] grad_features celeba {label}: features {out['features_shape']} from "
            f"{out['grad_dim']} gradient coordinates in VQ latents, f32 on {card}: s/batch "
            f"{split} (gradients + JL), sampling {out['sample_seconds']:.3f} s, call "
            f"{wall:.3f} s, peak {peak:.2f} GiB")
        feats = np.load(path)["train_features" if "train" in label else "gen_features"]
        if not (np.isfinite(feats).all() and feats.std() > 0):
            raise AssertionError(f"grad_features celeba ({label}): non-finite or constant rows")
    attrs, wall, _ = call("traks celeba", traks.main, [
        "--feature_store", store, "--save_dir", os.path.join(root, "local", "attrs")], zero)
    for method, a in attrs.items():
        log(f"[local] traks {method} on the latent store: {a.shape[0]} group attributions, "
            f"range [{a.min():.4g}, {a.max():.4g}]")
        if not np.isfinite(a).all():
            raise AssertionError(f"traks {method}: attributions {a}")

    # sketch_quality on CIFAR: [unlearn]'s full model, [pipeline]'s datamodel rows.
    sk = LOC_SKETCH
    cifar_full = os.path.join(root, "unlearn", "cifar", "retrain", "models", "full")
    cifar_rem = os.path.join(root, "unlearn", "cifar", "retrain", "models", "shapley",
                             f"shapley_seed={UNL_UNLEARN_SEED}")
    n_b = sk["max_examples"] // TRAK_BATCH + 2  # the warm batch, train, one generated batch
    steps = n_b * sk["timesteps"]
    variants = 2 + len(sk["ks"])
    report, wall, peak = call("sketch_quality cifar", sketch_quality.main, [
        "--dataset", "cifar", "--load", cifar_full, "--outdir", os.path.join(root, "local"),
        "--sketch_ks", *map(str, sk["ks"]), "--proj_dim", str(sk["proj"]), "--num_timesteps",
        str(sk["timesteps"]), "--n_gen", str(sk["n_gen"]), "--batch_size", str(TRAK_BATCH),
        "--num_inference_steps", str(sk["steps"]), "--max_examples", str(sk["max_examples"]),
        "--test_db", os.path.join(root, "pipeline", "cifar_pipeline_db.jsonl"),
        "--save_path", os.path.join(root, "local", "sketch_quality.json"), "--device", "cuda"],
        unet_counts(sk["steps"] + variants * steps, steps, jl=variants * n_b,
                    attention_only=(variants - 1) * steps))
    log(f"[local] sketch_quality cifar ({report['n_train']} train x {report['n_gen']} "
        f"generated, {sk['timesteps']} timesteps, P={sk['proj']}) f32 on {card}: call "
        f"{wall:.3f} s, peak {peak:.2f} GiB; timings {report['timings']}; "
        + "; ".join(f"{n}: rho example/group vs full {r['spearman_example_vs_full']:.4f}/"
                    f"{r['spearman_group_vs_full']:.4f}, vs attn_full "
                    f"{r['spearman_example_vs_attn_full']:.4f}/"
                    f"{r['spearman_group_vs_attn_full']:.4f}, lds {r['lds']:.2f}"
                    for n, r in report["variants"].items()))
    v = report["variants"]
    if not (set(v) == {"full", "attn_full", *(f"probe_k{k}" for k in sk["ks"])}
            and v["full"]["spearman_example_vs_full"] > 0.999
            and all(math.isfinite(r["lds"]) for r in v.values())):
        raise AssertionError(f"sketch_quality report {v}")

    # The local behaviors: CIFAR, then CelebA in VQ latents (decoded to pixels).
    n, noises = LOC_LOCAL, LOC_NOISES
    ldm_rem = os.path.join(root, "unlearn", "celeba", "retrain", "models", "shapley",
                           f"shapley_seed={UNL_UNLEARN_SEED}")
    for name, full_dir, rem_dir, extra in (
            ("cifar", cifar_full, cifar_rem, []),
            ("celeba", full_ldm, ldm_rem, ["--vqvae_weights", vq_weights])):
        k = LOC_LOCAL_STEPS[name]
        argv = ["--dataset", name, "--full_model_dir", full_dir, "--removal_model_dir", rem_dir,
                "--n_samples", str(n), "--num_inference_steps", str(k), "--outdir",
                os.path.join(root, "local"), "--device", "cuda", *extra]
        latent = name == "celeba"
        if latent:
            want_s = add_counts(ldm(2 * k + noises), model_counts(0, n_dec, 2),
                                model_counts(0, n_enc, 1))
            routes_s = {"attention_plain_fwd": 3, "attention_plain_bwd": 0}
            want_l = add_counts(ldm(4 * k), model_counts(0, n_dec, 2 * k))
            routes_l = {"attention_plain_fwd": 2 * k, "attention_plain_bwd": 0}
        else:
            want_s, routes_s = unet_counts(2 * k + noises, 0), no_routes
            want_l, routes_l = unet_counts(4 * k, 0), no_routes
        out, wall, peak = call(f"calculate_local_scores {name}", calculate_local_scores.main,
                               argv + ["--n_noises", str(noises)], want_s, routes_s)
        row = out["row"]
        log(f"[local] calculate_local_scores {name} ({n} paired samples x {k} DDIM steps, "
            f"{noises} loss draws) f32 on {card}: generation {out['generation_seconds']:.3f} s, "
            f"loss {out['loss_seconds']:.3f} s, call {wall:.3f} s, peak {peak:.2f} GiB; avg_mse "
            f"{row['avg_mse']:.5f}, avg_nrmse {row['avg_nrmse']:.4f}, avg_ssim "
            f"{row['avg_ssim']:.4f}, avg_total_loss {row['avg_total_loss']:.5f}, "
            f"{len(row['removed_idx'])} removed")
        vals = [row[key] for key in row if key.startswith(("avg_", "generated_image_"))]
        if not (len(vals) == 4 + 4 * n and all(math.isfinite(x) for x in vals)
                and row["removed_idx"]):
            raise AssertionError(f"calculate_local_scores {name}: row {row}")
        out, wall, peak = call(f"calculate_local_loss {name}", calculate_local_loss.main, argv,
                               want_l, routes_l)
        row = out["row"]
        log(f"[local] calculate_local_loss {name} ({n} samples, {k} steps, x0-hat at each"
            f"{', decoded' if latent else ''}) f32 on {card}: call {wall:.3f} s, peak "
            f"{peak:.2f} GiB; per_step_mse {np.round(row['per_step_mse'], 5).tolist()}, "
            f"per_step_ssim {np.round(row['per_step_ssim'], 4).tolist()}")
        if not (len(row["per_step_mse"]) == len(row["timesteps"]) == k
                and all(math.isfinite(x) for x in row["per_step_mse"] + row["per_step_ssim"])):
            raise AssertionError(f"calculate_local_loss {name}: row {row}")
    log(f"[local] launches of the phase {total}, peak of its calls {max(peaks):.2f} GiB")
    return total


def check_data(torch, np, ops, root: str, data_root: str, card: str, dev) -> dict:
    """Workload 1's other datasets at full size from their stand-ins, the
    ResNet-18 regroup tower card vs CPU and timed, cifar100_new regrouped
    from it, and the MNIST U-Net: B1-B4 at its shapes against their plain
    versions, cli.main and generate_samples at full width, each call between
    a counter reset and a read with the launches reckoned from the spec.
    Returns the summed launches of the main paths."""
    import torch.nn.functional as F

    from group_attribution_for_diffusion_models_tpu_torch.cli import generate_samples
    from group_attribution_for_diffusion_models_tpu_torch.cli import main as main_cli
    from group_attribution_for_diffusion_models_tpu_torch.config.registry import get_config
    from group_attribution_for_diffusion_models_tpu_torch.data import create_dataset
    from group_attribution_for_diffusion_models_tpu_torch.data import datasets as datasets_module
    from group_attribution_for_diffusion_models_tpu_torch.data.datasets import (
        CIFAR100_NEW_GROUPS)
    from group_attribution_for_diffusion_models_tpu_torch.models import UNet2D
    from group_attribution_for_diffusion_models_tpu_torch.models import resnet as resnet_module
    from group_attribution_for_diffusion_models_tpu_torch.models.layers import (
        GroupNormSiLU, SelfAttention2D)
    from group_attribution_for_diffusion_models_tpu_torch.models.resnet import (
        init_resnet18, resize_bilinear, resnet18_embed)

    for name, n_images, n_labels in (("cifar2", 2 * CIFAR_TRAIN_IMAGES // 10, 2),
                                     ("cifar100", CIFAR100_TRAIN_IMAGES // 5, 20),
                                     ("cifar100_f", 10_100, 100),
                                     ("mnist", MNIST_TRAIN_IMAGES, 10)):
        t0 = time.perf_counter()
        ds = create_dataset(name)
        secs = time.perf_counter() - t0
        counts = np.bincount(ds.labels)
        log(f"[data] create_dataset {name}: images {ds.images.shape} {ds.images.dtype} in "
            f"[{ds.images.min():.3f}, {ds.images.max():.3f}], {len(counts)} labels, per label "
            f"{counts.min()}..{counts.max()}, {secs:.3f} s")
        # cifar2 keeps two of the stand-in's uniformly drawn classes: about 20%.
        if not (len(counts) == n_labels and ds.images.shape[1:3] == (32, 32)
                and (abs(len(ds) - n_images) <= 0.05 * n_images if name == "cifar2"
                     else len(ds) == n_images)):
            raise AssertionError(f"create_dataset {name}: {ds.images.shape}, {counts}")

    # The ResNet-18 regroup tower, torchvision's init from a seed: card vs CPU, timed.
    tower = init_resnet18(seed=0).eval().requires_grad_(False)
    flops = tower_flops(torch, tower, 224)
    x = np.random.default_rng(3).uniform(0, 1, (DATA_RESNET_CHECK, 32, 32, 3)).astype(np.float32)
    want = resnet18_embed(tower, x)
    tower.to(dev)
    got = resnet18_embed(tower, x)
    err = float(np.abs(got - want).max())
    tol = TOWER_TOL * max(1.0, float(np.abs(want).max()))
    xb = torch.rand(DATA_RESNET_BATCH, 3, 32, 32, device=dev)
    with torch.no_grad():
        ms = cuda_ms(torch, lambda: tower(resize_bilinear(xb, 224)), iters=5)
    bms, by = bound(DATA_RESNET_BATCH * 3 * 32 * 32 * 4, DATA_RESNET_BATCH * flops, "float32")
    log(f"[data] ResNet-18 ({sum(p.numel() for p in tower.parameters())} params, torchvision "
        f"init, seed 0) embeddings of {DATA_RESNET_CHECK} images 32 -> 224, card vs CPU: "
        f"max_abs_err={err:.3g} (tol {tol:.3g}); batch {DATA_RESNET_BATCH} f32 on {card}: "
        f"{ms:.4f} ms a batch, {ms / DATA_RESNET_BATCH:.4f} ms an image "
        f"({flops / 1e9:.3f} GFLOP an image, {DATA_RESNET_BATCH * flops / ms / 1e9:.2f} "
        f"TFLOP/s), bound {bms / DATA_RESNET_BATCH:.4f} ms an image ({by}, f32 FMA)")
    if not err <= tol:
        raise AssertionError("the ResNet-18 tower on the card disagrees with the CPU")
    del xb

    # cifar100_new: the 10,000 animal images embedded on the card and k-means'd on
    # the host into 40 groups, through create_dataset with the tower's weights file.
    weights = os.path.join(root, "data", "resnet18.pth")
    os.makedirs(os.path.dirname(weights))
    torch.save({k: v.cpu() for k, v in tower.state_dict().items()}, weights)
    del tower
    os.environ["GADM_RESNET18_WEIGHTS"] = weights
    seconds = {}

    def timed(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if name == "embedding":
                torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            return out
        return run

    embed, regroup = resnet_module.resnet18_embed, datasets_module.cifar100_regroup
    resnet_module.resnet18_embed = timed("embedding", embed)
    datasets_module.cifar100_regroup = timed("k-means", regroup)
    try:
        t0 = time.perf_counter()
        ds = create_dataset("cifar100_new", device=dev)
        secs = time.perf_counter() - t0
    finally:
        resnet_module.resnet18_embed, datasets_module.cifar100_regroup = embed, regroup
    cache = os.path.join(data_root, "cifar100_new_targets.npy")
    sizes = np.bincount(ds.labels, minlength=CIFAR100_NEW_GROUPS)
    log(f"[data] create_dataset cifar100_new: {len(ds)} images in {len(sizes)} k-means groups "
        f"(sizes {sizes.min()}..{sizes.max()}), {secs:.3f} s: ResNet-18 embedding of the "
        f"{len(ds)} images on {card} {seconds['embedding']:.3f} s, k-means (40 groups, 10 "
        f"restarts, host) {seconds['k-means']:.3f} s; the cache written")
    if not (len(ds) == CIFAR100_TRAIN_IMAGES // 5 and len(sizes) == CIFAR100_NEW_GROUPS
            and sizes.min() > 0 and os.path.exists(cache)
            and np.array_equal(np.load(cache), ds.labels)):
        raise AssertionError("cifar100_new was not regrouped into 40 groups and cached")
    del os.environ["GADM_RESNET18_WEIGHTS"]

    # The MNIST U-Net: kernels at its shapes, then cli.main and generate_samples.
    spec = get_config("mnist").unet
    with torch.device("meta"):
        unet = UNet2D(spec)
    dims = [m.to_q.out_features // m.num_heads for m in unet.modules()
            if isinstance(m, SelfAttention2D)]
    n_attn = sum(ops.kernel_takes(d) for d in dims)  # the mid block's D=512: the plain route
    n_plain = len(dims) - n_attn
    n_gn = sum(isinstance(m, GroupNormSiLU) for m in unet.modules())
    log(f"[data] MNIST U-Net {sum(p.numel() for p in unet.parameters())} params, attention "
        f"head dims {dims} ({n_attn} for the kernels, {n_plain} on the plain route), {n_gn} "
        f"GroupNorms a forward")
    del unet
    census = gn_census_of(torch, spec, device=dev)
    if sum(c[-1] for c in census) != n_gn:
        raise AssertionError("the census disagrees with the MNIST U-Net's GroupNorms")
    check_attention(torch, F, ops, dev, MNIST_ATTN_SHAPES, [], "data", dtypes=("float32",))
    check_attention_bwd(torch, F, ops, dev, MNIST_ATTN_SHAPES, [], "data", dtypes=("float32",))
    check_gn_census(torch, ops, dev, census, label="data", batch=DATA_MNIST_BATCH,
                    dtypes=("float32",), library=True, what="MNIST U-Net pass")

    outdir = os.path.join(root, "data")
    total = unet_counts(0, 0)
    out, wall, counts, routes, peak = timed_call(torch, ops, main_cli.main, [
        "--dataset", "mnist", "--outdir", outdir, "--method", "retrain", "--removal_dist",
        "full", "--training_steps", str(DATA_MNIST_STEPS), "--batch_size",
        str(DATA_MNIST_BATCH), "--ckpt_freq", "0", "--sample_freq", "0", "--device", "cuda"])
    expect("main mnist", counts, routes,
           model_counts(n_attn, n_gn, DATA_MNIST_STEPS, DATA_MNIST_STEPS),
           {"attention_plain_fwd": n_plain * DATA_MNIST_STEPS,
            "attention_plain_bwd": n_plain * DATA_MNIST_STEPS}, "data")
    total = add_counts(total, counts)
    fit_s = out["train_seconds"] - out["ckpt_seconds"]
    log(f"[data] cli.main mnist retrain {DATA_MNIST_STEPS} steps at batch {out['batch_size']} "
        f"f32 on {card}: training {out['train_seconds']:.3f} s ({DATA_MNIST_STEPS / fit_s:.3f} "
        f"member-steps/s without the checkpoint's {out['ckpt_seconds']:.3f} s, the first step "
        f"with warm-up), call {wall:.3f} s, peak {peak:.2f} GiB, loss {out['loss']:.5f}")
    if not (out["steps_run"] == DATA_MNIST_STEPS and math.isfinite(out["loss"])):
        raise AssertionError("cli.main on mnist did not train")
    pngs = os.path.join(outdir, "samples")
    g, wall, counts, routes, peak = timed_call(torch, ops, generate_samples.main, [
        "--dataset", "mnist", "--load", out["model_dir"], "--sample_outdir", pngs,
        "--n_samples", str(DATA_MNIST_SAMPLES), "--batch_size", str(DATA_MNIST_SAMPLES),
        "--num_inference_steps", str(DATA_MNIST_SAMPLE_STEPS), "--device", "cuda"])
    expect("generate_samples mnist", counts, routes,
           model_counts(n_attn, n_gn, DATA_MNIST_SAMPLE_STEPS),
           {"attention_plain_fwd": n_plain * DATA_MNIST_SAMPLE_STEPS,
            "attention_plain_bwd": 0}, "data")
    total = add_counts(total, counts)
    from PIL import Image

    names = sorted(f for f in os.listdir(pngs) if f.endswith(".png"))
    imgs = np.stack([np.asarray(Image.open(os.path.join(pngs, f))) for f in names])
    log(f"[data] generate_samples mnist {DATA_MNIST_SAMPLES} x {DATA_MNIST_SAMPLE_STEPS} DDIM "
        f"steps f32 on {card}: {g['batch_seconds'][0]:.3f} s a batch, call {wall:.3f} s, peak "
        f"{peak:.2f} GiB; {len(names)} PNGs {imgs.shape[1:]} {imgs.dtype}, std {imgs.std():.2f}")
    if not (len(names) == DATA_MNIST_SAMPLES and imgs.shape[1:] == (32, 32)
            and imgs.std() > 0):
        raise AssertionError("generate_samples did not write the 32x32 gray PNGs")
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        return run(torch, tmp)


def run(torch, tmp: str) -> int:
    import numpy as np

    t_start = time.perf_counter()
    # The port reads its dataset root once, on import: the stand-in goes first.
    data_root = os.path.join(tmp, "datasets")
    write_cifar_standin(data_root, CIFAR_TRAIN_IMAGES)
    write_cifar100_standin(data_root)
    write_mnist_standin(data_root)
    write_celeba_standin(data_root)
    write_artbench_standin(data_root)
    os.environ["GADM_DATASET_DIR"] = data_root
    data_s = time.perf_counter() - t_start

    import torch.nn.functional as F
    from PIL import Image

    from group_attribution_for_diffusion_models_tpu_torch import ops
    from group_attribution_for_diffusion_models_tpu_torch.cli import (
        generate_samples, grad_features, train_ensemble, traks)
    from group_attribution_for_diffusion_models_tpu_torch.config.registry import get_config
    from group_attribution_for_diffusion_models_tpu_torch.diffusion import make_sampler
    from group_attribution_for_diffusion_models_tpu_torch.models import build_unet
    from group_attribution_for_diffusion_models_tpu_torch.ops import _build
    from group_attribution_for_diffusion_models_tpu_torch.utils.ckpt import save_checkpoint

    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"[card] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"[build] {len(libs)} libraries from csrc/ in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(os.path.basename(p) for p in libs.values())
        + f"; CIFAR-10 ({CIFAR_TRAIN_IMAGES} images), CIFAR-100 ({CIFAR100_TRAIN_IMAGES}), "
        f"MNIST ({MNIST_TRAIN_IMAGES}), CelebA-HQ ({LDM_IMAGES} images) and "
        f"ArtBench-style ({TTI_ARTISTS * TTI_PER_ARTIST} images) stand-ins written in "
        f"{data_s:.1f} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # As train_ensemble sets it: cuDNN's default backward algorithms may sum
    # with atomics, and identical members must stay bit-identical.
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    attn_rows = check_attention(torch, F, ops, dev)
    attn_bwd_rows = check_attention_bwd(torch, F, ops, dev)
    gn_rows = check_group_norm(torch, F, ops, dev)
    gn_bwd_rows = check_group_norm_bwd(torch, F, ops, dev)
    gn_cache: dict = {}
    check_gn_census(torch, ops, dev, cache=gn_cache)
    jl_row = check_jl_projection(torch, ops, dev)
    log(f"[kernels] phase (with [census]) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

    spec = get_config("cifar").unet
    model = build_unet(spec, seed=0).eval()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 3, 32, 32)).astype(np.float32))
    t = torch.tensor([999, 500, 20, 0])
    with torch.no_grad():
        want = model(x, t)
        model.to(dev)
        reset_counts(ops)
        got = model(x.to(dev), t.to(dev)).cpu()
    counts = ops.launch_counts()
    err = (got - want).abs().max().item()
    log(f"[forward] CIFAR UNet2D ({sum(p.numel() for p in model.parameters())} params) "
        f"batch 4 f32, card vs CPU: max_abs_err={err:.3g} (tol {CIFAR_FWD_ATOL}), "
        f"|out|max={want.abs().max().item():.3g}, launches {counts}")
    if not (err <= CIFAR_FWD_ATOL and counts == unet_counts(1, 0)):
        raise AssertionError("CIFAR forward on the card disagrees with the CPU")

    model.cpu()
    check_prune_gn(torch, np, ops, model, spec, dev, gn_cache)
    check_train_step(torch, np, spec, dev)
    log(f"[forward] phase (with [prune-gn], [train-step]) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ens_counts = check_ensemble(torch, np, ops, dev, card, tmp)
    log(f"[ensemble] phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    model_dir, out = os.path.join(tmp, "model"), os.path.join(tmp, "samples")
    sd = model.cpu().state_dict()
    save_checkpoint(model_dir, 0, sd, sd, unet_spec=spec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    t0 = time.perf_counter()
    summary = generate_samples.main([
        "--dataset", "cifar", "--load", model_dir, "--sample_outdir", out,
        "--n_samples", str(BATCH * N_BATCHES), "--batch_size", str(BATCH),
        "--num_inference_steps", str(STEPS), "--device", "cuda",
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sample_counts = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    secs = [summary["batch_seconds"][b] for b in range(N_BATCHES)]
    log(f"[main] generate_samples cifar {N_BATCHES} batches of {BATCH} images x {STEPS} "
        f"DDIM steps f32 on {card}: s/batch {', '.join(f'{s:.3f}' for s in secs)} "
        f"(last: {BATCH / secs[-1]:.2f} images/s), call {wall:.3f} s, "
        f"peak {peak_gib:.2f} GiB, launches {sample_counts}")
    if sample_counts != unet_counts(N_BATCHES * STEPS, 0):
        raise AssertionError(f"main path launches {sample_counts}")
    pngs = sorted(n for n in os.listdir(out) if n.endswith(".png"))
    imgs = np.stack([np.asarray(Image.open(os.path.join(out, n))) for n in pngs])
    log(f"[main] {len(pngs)} PNGs {imgs.shape[1:]} {imgs.dtype}, "
        f"mean {imgs.mean():.2f}, std {imgs.std():.2f}")
    if (len(pngs) != BATCH * N_BATCHES or imgs.shape[1:] != (32, 32, 3)
            or not np.isfinite(imgs).all() or imgs.std() == 0):
        raise AssertionError("generate_samples did not write the distinct 32x32 RGB PNGs")

    # Reference: the sampler on the card against the CPU from the same noise.
    model.eval()
    cfg = get_config("cifar")
    noise = torch.from_numpy(rng.standard_normal((2, 3, 32, 32)).astype(np.float32))
    cpu_imgs = make_sampler(model, cfg.scheduler, (2, 3, 32, 32), device="cpu",
                            num_inference_steps=5)(init_noise=noise)
    model.to(dev)
    gpu_imgs = make_sampler(model, cfg.scheduler, (2, 3, 32, 32), device=dev,
                            num_inference_steps=5)(init_noise=noise).cpu()
    err = (gpu_imgs - cpu_imgs).abs().max().item()
    log(f"[reference] 5 DDIM steps, batch 2, card vs CPU: max_abs_err={err:.3g} "
        f"(tol {SAMPLE_ATOL}), finite={bool(torch.isfinite(gpu_imgs).all())}")
    if not (err <= SAMPLE_ATOL and torch.isfinite(gpu_imgs).all()):
        raise AssertionError("sampling on the card disagrees with the CPU")
    log(f"[main] phase (with [reference]) {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    train_counts = check_training_path(torch, np, ops, train_ensemble, tmp, card)
    log(f"[train] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_trak_step(torch, np, ops, spec, dev)
    trak_counts = check_trak_path(torch, np, ops, grad_features, traks, model_dir, tmp, card)
    log(f"[trak] phase (with [trak-step]) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pipe_counts = check_pipeline(torch, np, ops, tmp, card)
    log(f"[pipeline] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_towers(torch, np, dev, card)
    score_counts = check_scores(torch, np, ops, tmp, card)
    log(f"[scores] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ldm_counts = check_ldm(torch, np, ops, tmp, card, dev)
    log(f"[ldm] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tti_counts_ = check_tti(torch, np, ops, tmp, card, dev)
    log(f"[tti] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    unlearn_counts = check_unlearn(torch, np, ops, tmp, card, dev, os.path.join(
        tmp, "ldm", "celeba", "vqvae", "vqvae_weights.npy"))
    log(f"[unlearn] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    local_counts = check_local(torch, np, ops, tmp, card, dev)
    log(f"[local] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    data_counts = check_data(torch, np, ops, tmp, data_root, card, dev)
    log(f"[data] phase {time.perf_counter() - t0:.1f} s")

    # launches: the eleven main paths, sampling, cli.main's scanned and
    # per-step loops, training, TRAK, the estimation loop, the sample behaviors, the latent-diffusion workload, the
    # text-to-image tier, the single-model jobs, per-example attribution and
    # local behaviors, and workload 1's other datasets.
    launches = add_counts(sample_counts, ens_counts, train_counts, trak_counts, pipe_counts,
                          score_counts, ldm_counts, tti_counts_, unlearn_counts, local_counts,
                          data_counts)
    main_attn_bwd = attn_bwd_rows[(64, 256, 256, 1, 256, "float32")]
    src = "group_attribution_for_diffusion_models_tpu_torch/csrc/"
    ref = "group_attribution_for_diffusion_models_tpu/ops/"
    kernels = [
        # also the head-packed _hp_fwd_kernel (attention.py:309), same function
        dict(name="attention_fwd", route="cuda", source=src + "attention.cu",
             replaces=ref + "attention.py:82", launches=launches["attention_fwd"],
             **attn_rows[(64, 256, 256, 1, 256, "float32")]),
        # also _hp_bwd_dq_kernel (attention.py:332)
        dict(name="attention_bwd_dq", route="cuda", source=src + "attention_bwd.cu",
             replaces=ref + "attention.py:101", launches=launches["attention_bwd_dq"],
             **main_attn_bwd["dq"]),
        # also _hp_bwd_dkv_kernel (attention.py:377)
        dict(name="attention_bwd_dkv", route="cuda", source=src + "attention_bwd.cu",
             replaces=ref + "attention.py:134", launches=launches["attention_bwd_dkv"],
             **main_attn_bwd["dkv"]),
        dict(name="group_norm_silu_fwd", route="cuda", source=src + "group_norm.cu",
             replaces=ref + "group_norm.py:68", launches=launches["group_norm_fwd"],
             **gn_rows[((64, 128, 32, 32), "float32", True)]),
        dict(name="group_norm_silu_bwd", route="cuda", source=src + "group_norm_bwd.cu",
             replaces=ref + "group_norm.py:90", launches=launches["group_norm_bwd"],
             **gn_bwd_rows[((64, 128, 32, 32), "float32", True)]),
        # every number at the main path's shape but library_ms, torch.matmul
        # by a materialised R, a yardstick at library_shape, beside the
        # kernel's time there (library_kernel_ms)
        dict(name="jl_projection", route="cuda", source=src + "jl_projection.cu",
             replaces=ref + "jl_projection.py:42", launches=launches["jl_projection"],
             **jl_row),
    ]
    for row in kernels:
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']}: no launch on the main paths")
        for key in ("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err"):
            if row[key] is not None and not math.isfinite(row[key]):
                raise AssertionError(f"{row['name']}: {key} is not finite")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
