#!/usr/bin/env bash
# The PyTorch/CUDA port's twin of sketch_quality_realscale.sh: the
# real-scale probe-sketch quality table, driving
# group_attribution_for_diffusion_models_tpu_torch. k in {16,64,256} at
# proj_dim 4096, 10 timesteps, over the full 2048-example templated
# size-ramp synthetic with the attention-bearing big arch. Trains the
# full-data model + a 48-subset class-level datamodel test DB (low-t eval
# band), then reports Spearman-vs-exact-features AND LDS side by side for
# full grads, attn-only exact grads, and each sketch k.
#
# Runs on the CUDA card; DEVICE=cpu runs the kernels' plain versions on the
# CPU. The table goes to $OUT/sketch_quality_realscale.json (the JAX run's
# is docs/sketch_quality_realscale.json, which this script never writes).
set -euxo pipefail

OUT=${OUT:-/tmp/sqb}
DATASET=${DATASET:-synthetic_2048x32_c32_tpl_mix_sizes_big}
DB=$OUT/db.jsonl
STEPS=${STEPS:-800}
TEST=${TEST:-48}
mkdir -p "$OUT"

# 1) full-data model (the attribution subject).
python -m group_attribution_for_diffusion_models_tpu_torch.cli.main \
  --dataset "$DATASET" --method retrain --removal_dist full \
  --training_steps "$STEPS" --batch_size 64 --outdir "$OUT" --db "$DB" \
  --log_freq 100 --sample_freq 0 ${DEVICE:+--device "$DEVICE"}

# 2) class-level datamodel test subsets with the low-t eval behavior,
# CHUNK members stacked in one train_ensemble call.
CHUNK=${CHUNK:-16}
for start in $(seq 5000 "$CHUNK" $((5000 + TEST - 1))); do
  n=$((5000 + TEST - start)); [ "$n" -gt "$CHUNK" ] && n=$CHUNK
  python -m group_attribution_for_diffusion_models_tpu_torch.cli.train_ensemble \
    --dataset "$DATASET" --removal_dist datamodel --by_class \
    --seed_start "$start" --num_seeds "$n" --training_steps "$STEPS" \
    --batch_size 64 --n_samples 0 --eval_loss --eval_t_min 0 --eval_t_max 100 \
    --outdir "$OUT" --db "$DB" --no-save_ckpts --log_freq 200 \
    ${DEVICE:+--device "$DEVICE"}
done

# 3) the table.
MODEL_DIR=$(find "$OUT/$DATASET" -type d -path "*models/full*" | sort | head -1)
test -n "$MODEL_DIR"
python -m group_attribution_for_diffusion_models_tpu_torch.cli.sketch_quality \
  --dataset "$DATASET" --load "$MODEL_DIR" --outdir "$OUT" \
  --sketch_ks 16 64 256 --proj_dim 4096 --num_timesteps 10 \
  --n_gen 64 --num_inference_steps 50 --batch_size 64 \
  --test_db "$DB" --model_behavior_key eval_loss \
  --save_path "$OUT/sketch_quality_realscale.json" ${DEVICE:+--device "$DEVICE"}
