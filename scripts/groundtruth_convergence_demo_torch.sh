#!/usr/bin/env bash
# The PyTorch/CUDA port's twin of groundtruth_convergence_demo.sh: exact
# attribution values from EXHAUSTIVE subset retraining, then KernelSHAP
# estimate quality at increasing fit-subset counts, driving
# group_attribution_for_diffusion_models_tpu_torch.
#
# 8 classes -> 255 non-empty subsets, every one retrained as a member of a
# stacked chunk of CHUNK members (one launch of each kernel for the chunk),
# + the untrained null anchor. The estimate sweep reuses the enumerated
# values by lookup, so it trains nothing more.
#
# Runs on the CUDA card; DEVICE=cpu runs the kernels' plain versions on the
# CPU. The recorded low-t protocol
# (docs/groundtruth_chip_c8_sizes_lowt600_summary.json, its "args") runs the
# CLI itself, with --eval_t_min 0 --eval_t_max 100; its run on an H100 is
# docs/groundtruth_chip_c8_sizes_lowt600_summary_h100.json.
set -euxo pipefail

OUT=${OUT:-/tmp/groundtruth_demo}
DATASET=${DATASET:-synthetic_1024x32_c8_tpl_mix_big}
STEPS=${STEPS:-400}
CHUNK=${CHUNK:-32}
FIT_COUNTS=${FIT_COUNTS:-10,24,50,100,200}
mkdir -p "$OUT"

python -m group_attribution_for_diffusion_models_tpu_torch.cli.shapley_groundtruth \
  --dataset "$DATASET" --training_steps "$STEPS" --chunk_size "$CHUNK" \
  --eval_t_min 100 --eval_t_max 600 --log_freq 100 \
  --fit_counts "$FIT_COUNTS" --outdir "$OUT" ${DEVICE:+--device "$DEVICE"}
