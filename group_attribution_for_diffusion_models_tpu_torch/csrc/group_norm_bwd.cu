// GroupNorm(+SiLU) backward for Hopper (sm_90a), NCHW.
//
// Replaces the TPU kernel ops/group_norm.py::_bwd_kernel of the JAX package.
// From x, the upstream gradient g and the forward's mean/rstd (B, G) it
// recomputes x_hat = (x - mean) * rstd and, with SiLU, y = x_hat * gamma + beta
// and dy = g * s * (1 + y (1 - s)), s = sigmoid(y) (else dy = g); then
//   dx = rstd * (dy * gamma - mean_g(dy * gamma) - x_hat * mean_g(dy * gamma * x_hat))
// in x's dtype, and per-(sample, channel) partial dgamma = sum_hw dy * x_hat and
// dbeta = sum_hw dy in f32, which the caller sums over the batch (as
// _pallas_bwd does outside its kernel).
//
// What bounds it: bytes. About 25 operations per element and no matrix
// product, so the least time is one read of x and g and one write of dx at the
// card's memory rate.
//
// Design: the TPU kernel holds a sample's (HW, C) slice in VMEM and forms group
// sums with one-hot (C, G) matrix products. In NCHW one (sample, group) is one
// contiguous run of (C/G)*HW elements, so one block owns one (b, g), as in the
// forward. Pass 1 walks the group channel by channel: each channel's dbeta and
// dgamma are block sums (warp shuffles, then shared memory), written by thread
// 0 to the partial arrays; the group sums follow without another pass over
// the data, since sum(dy * gamma) = sum_c gamma_c dbeta_c and
// sum(dy * gamma * x_hat) = sum_c gamma_c dgamma_c. Pass 2 recomputes dy and
// writes dx; its re-read of x and g hits the L1/L2 cache at the U-Net's sizes
// (<= 12288 elements a group). Each sum runs in a fixed order and each output
// has one writer: no atomics, so two runs give bit-identical gradients.

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

// Sum of a and b over the block; every thread gets the same totals. Ends with
// a barrier, so the next call may reuse the scratch.
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
  __syncthreads();
}

// dy and x_hat of one element.
__device__ __forceinline__ float grad_in(float xv, float gv, float mean, float rstd,
                                         float gam, float bet, int silu, float& xhat) {
  xhat = (xv - mean) * rstd;
  if (!silu) return gv;
  const float y = xhat * gam + bet;
  const float s = 1.f / (1.f + expf(-y));
  return gv * s * (1.f + y * (1.f - s));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
group_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                      T* __restrict__ dx, float* __restrict__ dgamma_p,
                      float* __restrict__ dbeta_p, int C, int HW, int G, int silu) {
  const int bg = blockIdx.x;  // b * G + g
  const int b = bg / G;
  const int grp = bg - b * G;
  const int cpg = C / G;
  const int n = cpg * HW;
  const int64_t base = static_cast<int64_t>(bg) * n;
  const T* xg = x + base;
  const T* gg = g + base;
  const float mean = mean_in[bg];
  const float rstd = rstd_in[bg];

  float s1 = 0.f, s2 = 0.f;  // sum(dy * gamma), sum(dy * gamma * x_hat)
  for (int cc = 0; cc < cpg; ++cc) {
    const int c = grp * cpg + cc;
    const float gam = gamma[c], bet = beta[c];
    float db = 0.f, dg = 0.f;
    for (int i = threadIdx.x; i < HW; i += kThreads) {
      float xhat;
      const float dy = grad_in(to_f32(xg[cc * HW + i]), to_f32(gg[cc * HW + i]), mean, rstd,
                               gam, bet, silu, xhat);
      db += dy;
      dg += dy * xhat;
    }
    block_sum2(db, dg);
    if (threadIdx.x == 0) {
      dbeta_p[static_cast<int64_t>(b) * C + c] = db;
      dgamma_p[static_cast<int64_t>(b) * C + c] = dg;
    }
    s1 += gam * db;
    s2 += gam * dg;
  }
  const float m1 = s1 / static_cast<float>(n);
  const float m2 = s2 / static_cast<float>(n);

  T* dxg = dx + base;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int c = grp * cpg + i / HW;
    const float gam = gamma[c];
    float xhat;
    const float dy = grad_in(to_f32(xg[i]), to_f32(gg[i]), mean, rstd, gam, beta[c], silu, xhat);
    store(dxg + i, rstd * (dy * gam - m1 - xhat * m2));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* g, const float* gamma, const float* beta,
                   const float* mean, const float* rstd, void* dx, float* dgamma_p,
                   float* dbeta_p, int B, int C, int HW, int G, int silu, cudaStream_t stream) {
  group_norm_bwd_kernel<T><<<B * G, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), gamma, beta, mean, rstd,
      static_cast<T*>(dx), dgamma_p, dbeta_p, C, HW, G, silu);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gadm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, g: contiguous (B, C, H*W) in one dtype (0 = float32, 1 = bfloat16);
// gamma, beta: (C,) f32; mean, rstd: (B, G) f32 from the forward; dx:
// contiguous like x; dgamma_p, dbeta_p: (B, C) f32. Returns a cudaError_t.
int gadm_group_norm_bwd(const void* x, const void* g, const float* gamma, const float* beta,
                        const float* mean, const float* rstd, void* dx, float* dgamma_p,
                        float* dbeta_p, int dtype, int B, int C, int HW, int G, int silu,
                        int device, void* stream) {
  if (B <= 0 || G <= 0 || C % G != 0 || HW <= 0 ||
      static_cast<int64_t>(C / G) * HW > INT32_MAX)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, g, gamma, beta, mean, rstd, dx, dgamma_p, dbeta_p, B, C, HW, G,
                         silu, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, g, gamma, beta, mean, rstd, dx, dgamma_p, dbeta_p, B, C,
                                 HW, G, silu, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
