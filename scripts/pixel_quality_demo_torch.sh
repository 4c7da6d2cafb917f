#!/usr/bin/env bash
# The PyTorch/CUDA port's twin of pixel_quality_demo.sh: pixel-space
# attribution quality on the templated heterogeneous synthetic, driving
# group_attribution_for_diffusion_models_tpu_torch. One command runs the
# whole Shapley estimation loop: class-level Shapley fit subsets + held-out
# datamodel test subsets retrained in stacked chunks, deterministic
# probe-loss behaviors, measured full/null efficiency-constraint anchors,
# Spearman LDS.
#
# Runs on the CUDA card; DEVICE=cpu runs the kernels' plain versions on the
# CPU.
set -euxo pipefail

OUT=${OUT:-/tmp/pixel_tpl_demo}
DATASET=${DATASET:-synthetic_2048x32_tpl_mix_big}
FIT=${FIT:-128}
TEST=${TEST:-24}
STEPS=${STEPS:-800}
FIT_DIST=${FIT_DIST:-shapley_paired}
mkdir -p "$OUT"

python -m group_attribution_for_diffusion_models_tpu_torch.cli.shapley_pipeline \
  --dataset "$DATASET" --by_class \
  --num_fit_subsets "$FIT" --num_test_subsets "$TEST" \
  --fit_dist "$FIT_DIST" \
  --training_steps "$STEPS" --batch_size 64 \
  --behavior eval_loss --eval_t_min 100 --eval_t_max 600 \
  --chunk_size 16 --log_freq 50 --outdir "$OUT" ${DEVICE:+--device "$DEVICE"}
