// GroupNorm(+SiLU) forward for Hopper (sm_90a), NCHW.
//
// Replaces the TPU kernel ops/group_norm.py::_fwd_kernel of the JAX package:
// per (sample, group) f32 statistics mean = E[x], var = E[x^2] - mean^2 (no
// clamp, as the JAX kernel computes them), y = (x - mean) * rstd * gamma + beta,
// an optional SiLU, the output in its own dtype, and mean/rstd (B, G) in f32
// for the backward pass. gamma and beta are R rows of C: one row for the
// whole batch, or one for each of R equal runs of samples (the members of an
// ensemble folded into the batch under vmap).
//
// What bounds it: bytes. It does about ten operations per element and no
// matrix product, so the least time is one read of x and one write of y at
// the card's memory rate.
//
// Design: the TPU kernel holds one sample's (HW, C) slice in VMEM and forms
// group sums with a one-hot (C, G) matrix product. In NCHW one group of one
// sample is one contiguous run, cut into size classes (group_norm_common.cuh):
// - flat (groups of up to 16384 f32 or 32768 bf16 elements, HW a multiple of
//   16 bytes): 16-byte loads, one warp a group up to 8 units of 32 vectors,
//   else up to 16 warps a group; the group stays in registers from the sums
//   to the output pass, so x is read from memory once. The two sums are warp
//   shuffles, then (several warps) one block barrier over [warps][2] in
//   shared memory, summed in a fixed order by every thread.
// - stream (larger groups or other shapes): one block a group sums the run,
//   then walks it again channel by channel to normalise and write, loading
//   gamma and beta once a channel.
// No atomics: every sum runs in a fixed order, so the output is bitwise
// repeatable.

#include "group_norm_common.cuh"

#include <math.h>

namespace {

using gn::Shape;

template <typename Tin, typename Tout, int UPW>
__global__ void __launch_bounds__(512)
group_norm_fwd_flat(const Tin* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, Tout* __restrict__ y,
                    float* __restrict__ mean_out, float* __restrict__ rstd_out, const Shape s,
                    const float eps, const int silu) {
  constexpr int V = gn::Vec<Tin>::N;
  __shared__ float red[gn::kFwdCut.max_wpg][2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gl = warp / s.wpg, w = warp - gl * s.wpg;
  const int bg = blockIdx.x * s.gpb + gl;  // b * G + g
  // Only the one-warp-a-group case (wpg == 1) has groups past the end; it has
  // no block barrier.
  if (bg >= s.B * s.G) return;
  const int b = bg / s.G, grp = bg - b * s.G;
  const Tin* xg = x + static_cast<int64_t>(bg) * s.n;
  const int u0 = w * s.upw;
  const int nu = min(s.upw, s.units - u0);  // this warp's units

  uint4 raw[UPW];
#pragma unroll
  for (int k = 0; k < UPW; ++k) {
    const int j = (u0 + k) * 32 + lane;
    raw[k] = (k < nu && j < s.nvec) ? gn::load16(xg + static_cast<int64_t>(j) * V)
                                    : make_uint4(0u, 0u, 0u, 0u);
  }
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < UPW; ++k) {
    float f[V];
    gn::unpack(raw[k], f);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s1 += f[i];
      s2 += f[i] * f[i];
    }
  }
  gn::warp_sum2(s1, s2);
  if (s.wpg > 1) {
    if (lane == 0) {
      red[w][0] = s1;
      red[w][1] = s2;
    }
    __syncthreads();
    s1 = s2 = 0.f;
    for (int i = 0; i < s.wpg; ++i) {
      s1 += red[i][0];
      s2 += red[i][1];
    }
  }
  const float mean = s1 / static_cast<float>(s.n);
  const float var = s2 / static_cast<float>(s.n) - mean * mean;
  const float rstd = 1.f / sqrtf(var + eps);
  if (w == 0 && lane == 0) {
    mean_out[bg] = mean;
    rstd_out[bg] = rstd;
  }

  const int64_t aff = static_cast<int64_t>(b / s.spr) * s.C + grp * s.cpg;
  const float* gam = gamma + aff;
  const float* bet = beta + aff;
  Tout* yg = y + static_cast<int64_t>(bg) * s.n;
  int cu = (u0 / s.upc) * s.cpu, r = u0 % s.upc;  // unit u0's first channel
#pragma unroll
  for (int k = 0; k < UPW; ++k) {
    const int j = (u0 + k) * 32 + lane;
    if (k < nu && j < s.nvec) {
      const int c = cu + (lane >> s.lsh);
      const float a = rstd * __ldg(gam + c), bb = __ldg(bet + c);
      float f[V];
      gn::unpack(raw[k], f);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float v = fmaf(f[i] - mean, a, bb);
        f[i] = silu ? gn::silu(v) : v;
      }
      gn::store_vec<V>(yg + static_cast<int64_t>(j) * V, f);
    }
    if (++r == s.upc) {
      r = 0;
      cu += s.cpu;
    }
  }
}

template <typename Tin, typename Tout, int V>
__global__ void __launch_bounds__(gn::kStreamThreads)
group_norm_fwd_stream(const Tin* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, Tout* __restrict__ y,
                      float* __restrict__ mean_out, float* __restrict__ rstd_out, const Shape s,
                      const float eps, const int silu) {
  constexpr int kWarps = gn::kStreamThreads / 32;
  __shared__ float red[kWarps][2];
  const int bg = blockIdx.x;
  const int b = bg / s.G, grp = bg - b * s.G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Tin* xg = x + static_cast<int64_t>(bg) * s.n;

  float s1 = 0.f, s2 = 0.f;
  for (int j0 = tid; j0 < s.nvec; j0 += 4 * gn::kStreamThreads) {
    float f[4][V];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + q * gn::kStreamThreads;
      if (j < s.nvec) {
        gn::load_f<V>(xg + static_cast<int64_t>(j) * V, f[q]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) f[q][i] = 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s1 += f[q][i];
        s2 += f[q][i] * f[q][i];
      }
  }
  gn::warp_sum2(s1, s2);
  if (lane == 0) {
    red[warp][0] = s1;
    red[warp][1] = s2;
  }
  __syncthreads();
  s1 = s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    s1 += red[i][0];
    s2 += red[i][1];
  }
  const float mean = s1 / static_cast<float>(s.n);
  const float var = s2 / static_cast<float>(s.n) - mean * mean;
  const float rstd = 1.f / sqrtf(var + eps);
  if (tid == 0) {
    mean_out[bg] = mean;
    rstd_out[bg] = rstd;
  }

  const int64_t aff = static_cast<int64_t>(b / s.spr) * s.C + grp * s.cpg;
  Tout* yg = y + static_cast<int64_t>(bg) * s.n;
  for (int c = 0; c < s.cpg; ++c) {
    const float a = rstd * gamma[aff + c], bb = beta[aff + c];
    const int64_t base = static_cast<int64_t>(c) * s.hwv;
    for (int i = tid; i < s.hwv; i += gn::kStreamThreads) {
      float f[V];
      gn::load_f<V>(xg + (base + i) * V, f);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float v = fmaf(f[e] - mean, a, bb);
        f[e] = silu ? gn::silu(v) : v;
      }
      gn::store_f<V>(yg + (base + i) * V, f);
    }
  }
}

template <typename Tin, typename Tout>
cudaError_t launch(const void* x, const float* gamma, const float* beta, void* y,
                   float* mean, float* rstd, int B, int C, int HW, int G, int R, float eps,
                   int silu, cudaStream_t stream) {
  Shape s{};
  const gn::Plan p = gn::make_plan(s, B, C, HW, G, R, sizeof(Tin),
                                   gn::aligned16(x) && gn::aligned16(y), gn::kFwdCut);
  auto xt = static_cast<const Tin*>(x);
  auto yt = static_cast<Tout*>(y);
  if (p.kind == gn::kStream) {
    if (p.vec)
      group_norm_fwd_stream<Tin, Tout, gn::Vec<Tin>::N><<<p.blocks, p.threads, 0, stream>>>(
          xt, gamma, beta, yt, mean, rstd, s, eps, silu);
    else
      group_norm_fwd_stream<Tin, Tout, 1><<<p.blocks, p.threads, 0, stream>>>(
          xt, gamma, beta, yt, mean, rstd, s, eps, silu);
    return cudaGetLastError();
  }
  switch (p.upw_t) {
    case 1:
      group_norm_fwd_flat<Tin, Tout, 1><<<p.blocks, p.threads, 0, stream>>>(
          xt, gamma, beta, yt, mean, rstd, s, eps, silu);
      break;
    case 2:
      group_norm_fwd_flat<Tin, Tout, 2><<<p.blocks, p.threads, 0, stream>>>(
          xt, gamma, beta, yt, mean, rstd, s, eps, silu);
      break;
    case 4:
      group_norm_fwd_flat<Tin, Tout, 4><<<p.blocks, p.threads, 0, stream>>>(
          xt, gamma, beta, yt, mean, rstd, s, eps, silu);
      break;
    default:
      group_norm_fwd_flat<Tin, Tout, 8><<<p.blocks, p.threads, 0, stream>>>(
          xt, gamma, beta, yt, mean, rstd, s, eps, silu);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gadm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: contiguous (B, C, H*W); gamma, beta: contiguous (R, C) f32, R dividing
// B (sample b reads row b / (B / R)); y: contiguous like x in out_dtype;
// mean, rstd: (B, G) f32. Dtypes: 0 = float32, 1 = bfloat16. Returns a
// cudaError_t.
int gadm_group_norm_fwd(const void* x, const float* gamma, const float* beta, void* y,
                        float* mean, float* rstd, int in_dtype, int out_dtype, int B,
                        int C, int HW, int G, int R, float eps, int silu, int device,
                        void* stream) {
  if (B <= 0 || G <= 0 || C % G != 0 || HW <= 0 || R <= 0 || B % R != 0 ||
      static_cast<int64_t>(C / G) * HW > INT32_MAX)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch<float, float>(x, gamma, beta, y, mean, rstd, B, C, HW, G, R, eps, silu, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(x, gamma, beta, y, mean, rstd, B, C, HW, G, R, eps,
                                        silu, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(x, gamma, beta, y, mean, rstd, B, C, HW, G, R, eps,
                                        silu, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, y, mean, rstd, B, C, HW, G,
                                                R, eps, silu, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
