#!/usr/bin/env bash
# The PyTorch/CUDA port's twin of refscale_sparseft.sh: sparse fine-tuning
# fits against the retrain ground truth at protocol scale, driving
# group_attribution_for_diffusion_models_tpu_torch.
#
# It reuses the DB of refscale_attribution_torch.sh (500 paired-Shapley
# retrain fits + 300 datamodel retrain tests): it prunes the recorded full
# model (diff-pruning importance, timestep stride 10), then runs the SAME
# 500 fit subsets as prune_fine_tune members fine-tuned from the shared
# pruned base for SPARSE_STEPS steps each, scored against the same 300
# retrain test rows.
#
# Runs on the CUDA card; DEVICE=cpu runs the kernels' plain versions on the
# CPU.
set -euxo pipefail

OUT=${OUT:-/tmp/refscale}
DATASET=${DATASET:-synthetic_2048x32_c32_tpl_mix_sizes}
STEPS=${STEPS:-300}          # retrain budget (must match the recorded DB)
SPARSE_STEPS=${SPARSE_STEPS:-100}
RATIO=${RATIO:-0.3}
CHUNK=${CHUNK:-16}
FIT=${FIT:-500}
TEST=${TEST:-300}

FULL="$OUT/$DATASET/retrain/models/full"
test -d "$FULL"

# 1) structural pruning of the recorded full model.
if [ ! -d "$OUT/$DATASET/prune/models/full" ]; then
  python -m group_attribution_for_diffusion_models_tpu_torch.cli.prune \
    --dataset "$DATASET" --load "$FULL" --pruning_ratio "$RATIO" \
    --pruner diff-pruning --timestep_stride 10 --outdir "$OUT" \
    ${DEVICE:+--device "$DEVICE"}
fi

# 2) sparse-FT fit subsets against the existing retrain test DB. Test
# subsets + anchors are skipped where their rows already exist.
python -m group_attribution_for_diffusion_models_tpu_torch.cli.shapley_pipeline \
  --dataset "$DATASET" --by_class \
  --method prune_fine_tune --load "$OUT/$DATASET/prune/models/full" \
  --fit_dist shapley_paired --num_fit_subsets "$FIT" --removal_seed 100 \
  --num_test_subsets "$TEST" --test_seed_start 5000 \
  --training_steps "$STEPS" --fit_training_steps "$SPARSE_STEPS" \
  --batch_size 64 --chunk_size "$CHUNK" \
  --behavior eval_loss --eval_t_min 0 --eval_t_max 100 \
  --outdir "$OUT" --log_freq 200 --no-save_ckpts \
  --exp_name sparseft_pipeline ${DEVICE:+--device "$DEVICE"}
