#!/usr/bin/env bash
# Run the JAX package's recorded experiment protocols on the PyTorch/CUDA
# port through the _torch twins, on the CUDA card, each at the args its JAX
# summary records, and write a record of each run beside the JAX figures it
# repeats (scripts/protocol_record_torch.py): <summary>_h100.json in RECORDS.
#
#   GADM_COMMIT=<commit> scripts/protocol_runs_torch.sh groundtruth refscale sparseft curves sketch
#
# sketch_draws tables the sketch protocol's full model at two more opt seeds.
# refscale writes the DB that sparseft and curves read (under WORK), so they
# run in that order in one call. Each run's output goes to RECORDS/<run>.log.
set -euo pipefail

WORK=${WORK:-/tmp/protocol_runs}
RECORDS=${RECORDS:-$WORK/records}
DATASET=synthetic_2048x32_c32_tpl_mix_sizes
RS_DB=$WORK/refscale/${DATASET}_pipeline_db.jsonl
PKG=group_attribution_for_diffusion_models_tpu_torch
mkdir -p "$RECORDS" "$WORK"

record() {
  python scripts/protocol_record_torch.py "$@"
}

logged() {  # <log> <command...>: the command's output to the terminal and the log
  local log=$1
  shift
  "$@" 2>&1 | tee "$log"
}

for run in "$@"; do
  start=$SECONDS
  case $run in
    groundtruth)
      # docs/groundtruth_chip_c8_sizes_lowt600_summary.json's args.
      cli="python -m $PKG.cli.shapley_groundtruth --dataset synthetic_512x8_c8_tpl_mix_sizes \
--training_steps 600 --chunk_size 64 --eval_t_min 0 --eval_t_max 100 --log_freq 100 \
--fit_counts 10,24,50,100,200 --num_estimate_seeds 3 --estimate_dists shapley,shapley_paired \
--outdir $WORK/gt"
      logged "$RECORDS/groundtruth.log" bash -xc "$cli"
      record --out "$RECORDS/groundtruth_chip_c8_sizes_lowt600_summary_h100.json" --cli "$cli" \
        --db "$WORK/gt/synthetic_512x8_c8_tpl_mix_sizes_groundtruth_db.jsonl" \
        --match removal_dist=groundtruth_summary --log "$RECORDS/groundtruth.log" \
        --jax docs/groundtruth_chip_c8_sizes_lowt600_summary.json --rule groundtruth \
        --wall_s $((SECONDS - start))
      ;;
    refscale)
      # docs/refscale_summary.json's cli.
      cli="STEPS=300 CHUNK=16 FIT=500 TEST=300 OUT=$WORK/refscale scripts/refscale_attribution_torch.sh"
      logged "$RECORDS/refscale.log" env STEPS=300 CHUNK=16 FIT=500 TEST=300 \
        OUT="$WORK/refscale" bash scripts/refscale_attribution_torch.sh
      record --out "$RECORDS/refscale_summary_h100.json" --cli "$cli" --db "$RS_DB" \
        --match exp_name=shapley_pipeline --log "$RECORDS/refscale.log" \
        --jax docs/refscale_summary.json --rule pipeline --wall_s $((SECONDS - start))
      ;;
    sparseft)
      # docs/refscale_sparseft_summary.json's cli: the script's defaults.
      cli="OUT=$WORK/refscale scripts/refscale_sparseft_torch.sh"
      logged "$RECORDS/sparseft.log" env OUT="$WORK/refscale" bash scripts/refscale_sparseft_torch.sh
      record --out "$RECORDS/refscale_sparseft_summary_h100.json" --cli "$cli" --db "$RS_DB" \
        --match exp_name=sparseft_pipeline --log "$RECORDS/sparseft.log" \
        --jax docs/refscale_sparseft_summary.json --jax_key sparse_ft --rule pipeline \
        --wall_s $((SECONDS - start))
      ;;
    curves)
      for method in retrain prune_fine_tune; do
        suffix=$([ "$method" = retrain ] || echo "_$method")
        steps=$([ "$method" = retrain ] && echo 300 || echo 100)
        curve=$WORK/refscale_prefix_curve$suffix.json
        cli="python scripts/refscale_prefix_curve_torch.py $RS_DB $DATASET $steps $method --out $curve"
        logged "$RECORDS/curve$suffix.log" bash -xc "$cli"
        record --out "$RECORDS/refscale_prefix_curve${suffix}_h100.json" --cli "$cli" \
          --include "$curve" --log "$RECORDS/curve$suffix.log" \
          --jax "docs/refscale_prefix_curve$suffix.json" --rule curve
      done
      ;;
    sketch)
      # docs/sketch_quality_realscale.json: the script's defaults.
      cli="OUT=$WORK/sqb scripts/sketch_quality_realscale_torch.sh"
      logged "$RECORDS/sketch.log" env OUT="$WORK/sqb" bash scripts/sketch_quality_realscale_torch.sh
      record --out "$RECORDS/sketch_quality_realscale_h100.json" --cli "$cli" \
        --include "$WORK/sqb/sketch_quality_realscale.json" --log "$RECORDS/sketch.log" \
        --jax docs/sketch_quality_realscale.json --rule sketch --wall_s $((SECONDS - start))
      ;;
    sketch_draws)
      # The sketch table's group Spearman against `full` of other trained
      # models: the full model of the sketch protocol at opt seeds 1 and 2,
      # each tabled as the twin tables it (no test DB, so no LDS).
      sq_ds=synthetic_2048x32_c32_tpl_mix_sizes_big
      for seed in 1 2; do
        out=$WORK/sqb_seed$seed
        cli="python -m $PKG.cli.main --dataset $sq_ds --method retrain --removal_dist full \
--training_steps 800 --batch_size 64 --outdir $out --log_freq 100 --sample_freq 0 --opt_seed $seed \
&& python -m $PKG.cli.sketch_quality --dataset $sq_ds --load $out/$sq_ds/retrain/models/full \
--outdir $out --sketch_ks 16 64 256 --proj_dim 4096 --num_timesteps 10 --n_gen 64 \
--num_inference_steps 50 --batch_size 64 --save_path $out/sketch_quality_realscale.json"
        logged "$RECORDS/sketch_seed$seed.log" bash -xc "$cli"
        record --out "$RECORDS/sketch_quality_realscale_seed${seed}_h100.json" --cli "$cli" \
          --include "$out/sketch_quality_realscale.json" --log "$RECORDS/sketch_seed$seed.log" \
          --jax docs/sketch_quality_realscale.json --rule sketch --wall_s $((SECONDS - start))
      done
      ;;
    *)
      echo "unknown run $run (groundtruth, refscale, sparseft, curves, sketch, sketch_draws)" >&2
      exit 2
      ;;
  esac
  echo "[$run] $((SECONDS - start)) s"
done
