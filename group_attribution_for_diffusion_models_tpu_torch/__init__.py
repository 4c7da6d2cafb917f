"""PyTorch/CUDA port of group_attribution_for_diffusion_models_tpu for one
NVIDIA H100.

The package mirrors the JAX package's module layout (``config``,
``diffusion``, ``ops``, ``models``, ``utils``, ``cli``). It imports torch and
never JAX; the JAX package is the reference its tests hold it against. The
attention and GroupNorm(+SiLU) kernels are hand-written CUDA for sm_90a
(``csrc/``), built with nvcc at first use; on CPU tensors each op runs its
plain PyTorch version.
"""
