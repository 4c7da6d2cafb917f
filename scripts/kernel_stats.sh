#!/bin/sh
# Registers, spills and SASS instruction counts of the port's CUDA kernels.
#
# Compiles each group_attribution_for_diffusion_models_tpu_torch/csrc/*.cu
# for sm_90a with the flags ops/_build.py uses, prints what ptxas reports for
# every kernel (registers a thread, spill bytes), and counts the instructions
# that show how the kernel computes and loads: HMMA (tensor-core products),
# FFMA (f32 fused multiply-adds), UBLKCP (TMA bulk copies), LDGSTS
# (cp.async), LDSM (ldmatrix). Run from the repository root on a machine with
# the CUDA toolkit (nvcc on PATH or under CUDA_HOME):
#
#     sh scripts/kernel_stats.sh [out_dir]
set -e
out=${1:-$(mktemp -d)}
mkdir -p "$out"
nvcc=$(command -v nvcc || echo "${CUDA_HOME:-/usr/local/cuda}/bin/nvcc")
cuobjdump=$(dirname "$nvcc")/cuobjdump
for src in group_attribution_for_diffusion_models_tpu_torch/csrc/*.cu; do
  name=$(basename "$src" .cu)
  echo "== $name"
  "$nvcc" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -cubin -Xptxas -v \
    -o "$out/$name.cubin" "$src" 2>&1 |
    sed -n -e "s/.*Compiling entry function '\([^']*\)'.*/  \1/p" \
           -e 's/.*\(Used [0-9]* registers\).*/    \1/p' \
           -e 's/.*, \([0-9]* bytes spill stores, [0-9]* bytes spill loads\)/    \1/p'
  "$cuobjdump" -sass "$out/$name.cubin" > "$out/$name.sass"
  printf '  SASS:'
  for op in HMMA FFMA UBLKCP LDGSTS LDSM; do
    printf ' %s %s' "$op" "$(grep -c "$op" "$out/$name.sass" || true)"
  done
  echo
done
