// GroupNorm(+SiLU) forward for Hopper (sm_90a), NCHW.
//
// Replaces the TPU kernel ops/group_norm.py::_fwd_kernel of the JAX package:
// per (sample, group) f32 statistics mean = E[x], var = E[x^2] - mean^2 (no
// clamp, as the JAX kernel computes them), y = (x - mean) * rstd * gamma + beta,
// an optional SiLU, the output in its own dtype, and mean/rstd (B, G) in f32
// for the backward pass.
//
// What bounds it: bytes. It does about ten operations per element and no
// matrix product, so the least time is one read of x and one write of y at
// the card's memory rate.
//
// Design: the TPU kernel holds one sample's (HW, C) slice in VMEM and forms
// group sums with a one-hot (C, G) matrix product. In NCHW one group of one
// sample is one contiguous run of (C/G)*HW elements, so here one block owns
// one (b, g): it streams the run once for the two sums (a warp-shuffle block
// reduction), then streams it again to normalise and write. At the U-Net's
// sizes (<= 12288 elements, 48 KB in f32) the second read hits the L1/L2
// cache, so device memory sees about one read and one write. B*G blocks
// (2048 at CIFAR sampling, B=64, G=32) fill the card's 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Sum of a and b over the block; every thread gets the totals.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kThreads / 32], sb[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  a = lane < kThreads / 32 ? sa[lane] : 0.f;
  b = lane < kThreads / 32 ? sb[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
group_norm_fwd_kernel(const Tin* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, Tout* __restrict__ y,
                      float* __restrict__ mean_out, float* __restrict__ rstd_out, int C,
                      int HW, int G, float eps, int silu) {
  const int bg = blockIdx.x;  // b * G + g
  const int g = bg % G;
  const int cpg = C / G;
  const int n = cpg * HW;
  const Tin* xg = x + static_cast<int64_t>(bg) * n;
  Tout* yg = y + static_cast<int64_t>(bg) * n;

  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float xv = to_f32(xg[i]);
    s1 += xv;
    s2 += xv * xv;
  }
  block_sum2(s1, s2);
  const float mean = s1 / static_cast<float>(n);
  const float var = s2 / static_cast<float>(n) - mean * mean;
  const float rstd = 1.f / sqrtf(var + eps);
  if (threadIdx.x == 0) {
    mean_out[bg] = mean;
    rstd_out[bg] = rstd;
  }

  const float* gam = gamma + g * cpg;
  const float* bet = beta + g * cpg;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int c = i / HW;
    float v = (to_f32(xg[i]) - mean) * rstd * gam[c] + bet[c];
    if (silu) v = v / (1.f + expf(-v));
    store(yg + i, v);
  }
}

template <typename Tin, typename Tout>
cudaError_t launch(const void* x, const float* gamma, const float* beta, void* y,
                   float* mean, float* rstd, int B, int C, int HW, int G, float eps,
                   int silu, cudaStream_t stream) {
  group_norm_fwd_kernel<Tin, Tout><<<B * G, kThreads, 0, stream>>>(
      static_cast<const Tin*>(x), gamma, beta, static_cast<Tout*>(y), mean, rstd, C, HW,
      G, eps, silu);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gadm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: contiguous (B, C, H*W); gamma, beta: (C,) f32; y: contiguous like x in
// out_dtype; mean, rstd: (B, G) f32. Dtypes: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t.
int gadm_group_norm_fwd(const void* x, const float* gamma, const float* beta, void* y,
                        float* mean, float* rstd, int in_dtype, int out_dtype, int B,
                        int C, int HW, int G, float eps, int silu, int device,
                        void* stream) {
  if (B <= 0 || G <= 0 || C % G != 0 || HW <= 0 ||
      static_cast<int64_t>(C / G) * HW > INT32_MAX)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch<float, float>(x, gamma, beta, y, mean, rstd, B, C, HW, G, eps, silu, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(x, gamma, beta, y, mean, rstd, B, C, HW, G, eps,
                                        silu, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(x, gamma, beta, y, mean, rstd, B, C, HW, G, eps,
                                        silu, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, y, mean, rstd, B, C, HW,
                                                G, eps, silu, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
