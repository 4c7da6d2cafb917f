#!/usr/bin/env bash
# The PyTorch/CUDA port's twin of refscale_fid.sh: the protocol-scale
# pipeline with a generated-sample behavior, driving
# group_attribution_for_diffusion_models_tpu_torch. Every member pays DDIM
# sampling and InceptionV3 scoring inside the loop: 200 fit / 100 test
# subsets, class-level, --behavior fid_value with NSAMP DDIM-sampled images
# per member scored against cached training-set Inception statistics.
#
# Runs on the CUDA card; DEVICE=cpu runs the kernels' plain versions on the
# CPU.
set -euxo pipefail

OUT=${OUT:-/tmp/refscale_fid}
DATASET=${DATASET:-synthetic_2048x32_c32_tpl_mix_sizes}
STEPS=${STEPS:-300}
CHUNK=${CHUNK:-16}
FIT=${FIT:-200}
TEST=${TEST:-100}
NSAMP=${NSAMP:-50}
INFER=${INFER:-100}
mkdir -p "$OUT"

python -m group_attribution_for_diffusion_models_tpu_torch.cli.shapley_pipeline \
  --dataset "$DATASET" --by_class \
  --fit_dist shapley_paired --num_fit_subsets "$FIT" --removal_seed 100 \
  --num_test_subsets "$TEST" --test_seed_start 5000 \
  --training_steps "$STEPS" --batch_size 64 --chunk_size "$CHUNK" \
  --behavior fid_value --n_samples "$NSAMP" --num_inference_steps "$INFER" \
  --outdir "$OUT" --log_freq 200 --no-save_ckpts \
  --exp_name refscale_fid_pipeline ${DEVICE:+--device "$DEVICE"}
