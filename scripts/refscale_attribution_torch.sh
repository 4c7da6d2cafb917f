#!/usr/bin/env bash
# The PyTorch/CUDA port's twin of refscale_attribution.sh: the same
# reference-protocol-scale attribution run, driving
# group_attribution_for_diffusion_models_tpu_torch. 500 paired-Shapley fit
# subsets + 300 datamodel test subsets, class-level over the 32-class
# templated+amplitude+size-ramp synthetic, retrained in stacked chunks of
# CHUNK members (one launch of each kernel for the chunk), behavior the
# fixed-probe eval loss at low timesteps (t in [0, 100)), the efficiency
# constraint anchored on the measured full/null models.
#
# Runs on the CUDA card; DEVICE=cpu runs the kernels' plain versions on the
# CPU. The recorded protocol is STEPS=300 CHUNK=16 FIT=500 TEST=300
# (docs/refscale_summary.json; its run on an H100 is
# docs/refscale_summary_h100.json).
set -euxo pipefail

OUT=${OUT:-/tmp/refscale}
DATASET=${DATASET:-synthetic_2048x32_c32_tpl_mix_sizes}
STEPS=${STEPS:-400}
CHUNK=${CHUNK:-16}
FIT=${FIT:-500}
TEST=${TEST:-300}
mkdir -p "$OUT"

python -m group_attribution_for_diffusion_models_tpu_torch.cli.shapley_pipeline \
  --dataset "$DATASET" --by_class \
  --fit_dist shapley_paired --num_fit_subsets "$FIT" --removal_seed 100 \
  --num_test_subsets "$TEST" --test_seed_start 5000 \
  --training_steps "$STEPS" --batch_size 64 --chunk_size "$CHUNK" \
  --behavior eval_loss --eval_t_min 0 --eval_t_max 100 \
  --outdir "$OUT" --log_freq 200 --no-save_ckpts ${DEVICE:+--device "$DEVICE"}
