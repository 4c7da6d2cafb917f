#!/usr/bin/env bash
# The PyTorch/CUDA port's twin of latent_quality_demo.sh: latent-space
# attribution quality (the CelebA-style LDM workload), driving
# group_attribution_for_diffusion_models_tpu_torch. It (1) trains a small
# VQ-VAE on the templated synthetic, (2) runs the one-command Shapley
# estimation pipeline in that VQ's latent space, reporting LDS against
# held-out datamodel subsets with measured full/null anchors. Spatial
# template classes (`_tpl`) are the signal that survives an encoder.
#
# Runs on the CUDA card; DEVICE=cpu runs the kernels' plain versions on the
# CPU.
set -euxo pipefail

OUT=${OUT:-/tmp/latent_tpl_demo}
DATASET=${DATASET:-synthetic_2048x32_tpl_mix}
FIT=${FIT:-64}
TEST=${TEST:-24}
STEPS=${STEPS:-800}
FIT_DIST=${FIT_DIST:-shapley_paired}
VQ_STEPS=${VQ_STEPS:-3000}
mkdir -p "$OUT"

VQW="$OUT/vqvae_weights.npy"
if [ ! -f "$VQW" ]; then
  python -m group_attribution_for_diffusion_models_tpu_torch.cli.train_vqvae \
    --dataset "${DATASET}_ldm" --outdir "$OUT/vqvae" --weights_out "$VQW" \
    --training_steps "$VQ_STEPS" --batch_size 64 ${DEVICE:+--device "$DEVICE"}
fi

python -m group_attribution_for_diffusion_models_tpu_torch.cli.shapley_pipeline \
  --dataset "${DATASET}_ldm" --behavior eval_loss --by_class \
  --num_fit_subsets "$FIT" --num_test_subsets "$TEST" \
  --fit_dist "$FIT_DIST" \
  --training_steps "$STEPS" --batch_size 64 --chunk_size 16 --log_freq 100 \
  --vqvae_weights "$VQW" --outdir "$OUT" ${DEVICE:+--device "$DEVICE"}
