#!/usr/bin/env bash
# The PyTorch/CUDA port's twin of pruning_ratio_sweep.sh: sparse-FT fidelity
# and runtime vs pruning ratio, driving
# group_attribution_for_diffusion_models_tpu_torch. Train the full model
# once, magnitude-prune it at several ratios, sparse-fine-tune the SAME
# matched Shapley removal subsets from each pruned start, and report
# per-ratio Pearson/Spearman fidelity of sFT behaviors against full
# retraining plus the retrain->sFT wall-clock speed-up. Each stage's
# subset members train stacked, CHUNK a train_ensemble call.
#
# Runs on the CUDA card; DEVICE=cpu runs the kernels' plain versions on the
# CPU. A failing step fails the script, the runtime report too.
set -euxo pipefail

OUT=${OUT:-/tmp/prune_sweep}
DATASET=${DATASET:-synthetic_2048x32_mix}
N=${N:-32}
RETRAIN_STEPS=${RETRAIN_STEPS:-600}
SFT_STEPS=${SFT_STEPS:-200}
RATIOS=${RATIOS:-"0.25 0.5 0.75"}
BATCH=${BATCH:-64}
PKG=group_attribution_for_diffusion_models_tpu_torch
mkdir -p "$OUT"
DB=$OUT/db.jsonl

# 1) Full-data model (the pruning source and the v1 anchor).
FULL_DIR=$OUT/$DATASET/retrain/models/full
if [ ! -d "$FULL_DIR" ]; then
  python -m $PKG.cli.main \
    --dataset "$DATASET" --method retrain --removal_dist full \
    --outdir "$OUT" --training_steps "$RETRAIN_STEPS" --db "$DB" \
    --log_freq 200 --scan_chunk 100 ${DEVICE:+--device "$DEVICE"}
fi

# 2) Retrain baseline rows: N matched Shapley subsets, full budget, CHUNK
# members a call, without per-member checkpoints (only the behavior rows
# feed the fidelity report).
CHUNK=${CHUNK:-16}
START=0
while [ "$START" -lt "$N" ]; do
  NS=$((N - START < CHUNK ? N - START : CHUNK))
  python -m $PKG.cli.train_ensemble \
    --dataset "$DATASET" --removal_dist shapley \
    --seed_start "$START" --num_seeds "$NS" \
    --training_steps "$RETRAIN_STEPS" --batch_size "$BATCH" \
    --eval_loss --eval_t_min 100 --eval_t_max 600 --no-save_ckpts \
    --outdir "$OUT" --db "$DB" --log_freq 100 ${DEVICE:+--device "$DEVICE"}
  START=$((START + NS))
done

# 3) Per ratio: prune -> sparse-FT the same subsets -> fidelity + runtime.
for R in $RATIOS; do
  ROUT=$OUT/ratio_$R
  mkdir -p "$ROUT"
  PRUNE_DIR=$ROUT/$DATASET/prune/models/full
  if [ ! -d "$PRUNE_DIR" ]; then
    python -m $PKG.cli.prune \
      --dataset "$DATASET" --load "$FULL_DIR" --pruning_ratio "$R" \
      --pruner magnitude --outdir "$ROUT" ${DEVICE:+--device "$DEVICE"}
  fi
  START=0
  while [ "$START" -lt "$N" ]; do
    NS=$((N - START < CHUNK ? N - START : CHUNK))
    python -m $PKG.cli.train_ensemble \
      --dataset "$DATASET" --method prune_fine_tune --removal_dist shapley \
      --seed_start "$START" --num_seeds "$NS" \
      --training_steps "$SFT_STEPS" --batch_size "$BATCH" \
      --eval_loss --eval_t_min 100 --eval_t_max 600 --no-save_ckpts \
      --load "$PRUNE_DIR" --outdir "$ROUT" --db "$ROUT/db.jsonl" \
      --log_freq 100 ${DEVICE:+--device "$DEVICE"}
    START=$((START + NS))
  done
  cat "$DB" "$ROUT/db.jsonl" > "$ROUT/merged.jsonl"
  echo "=== ratio $R fidelity ==="
  python -m $PKG.cli.empirical_verification \
    --db "$ROUT/merged.jsonl" --baseline_method retrain \
    --method prune_fine_tune --removal_dist shapley \
    --model_behavior_key eval_loss ${DEVICE:+--device "$DEVICE"} | tee "$ROUT/fidelity.txt"
  echo "=== ratio $R runtime ==="
  # The report reads rows only: it has no --device.
  python -m $PKG.cli.runtime_report --db "$ROUT/merged.jsonl" \
    --baseline_method retrain | tee "$ROUT/runtime.txt"
done
