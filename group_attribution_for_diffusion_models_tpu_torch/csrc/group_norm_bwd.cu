// GroupNorm(+SiLU) backward for Hopper (sm_90a), NCHW.
//
// Replaces the TPU kernel ops/group_norm.py::_bwd_kernel of the JAX package.
// From x, the upstream gradient g and the forward's mean/rstd (B, G) it
// recomputes x_hat = (x - mean) * rstd and, with SiLU, y = x_hat * gamma + beta
// and dy = g * s * (1 + y (1 - s)), s = sigmoid(y) (else dy = g); then
//   dx = rstd * (dy * gamma - mean_g(dy * gamma) - x_hat * mean_g(dy * gamma * x_hat))
// in x's dtype, and per-(sample, channel) partial dgamma = sum_hw dy * x_hat and
// dbeta = sum_hw dy in f32, into one (2, B, C) buffer that the caller sums
// over the batch in one reduction (as _pallas_bwd does outside its kernel).
// gamma and beta are R rows of C; sample b reads row b / (B / R).
//
// What bounds it: bytes. About 25 operations per element and no matrix
// product, so the least time is one read of x and g and one write of dx at the
// card's memory rate.
//
// Design: the TPU kernel holds a sample's (HW, C) slice in VMEM and forms group
// sums with one-hot (C, G) matrix products. Here one (sample, group) is one
// contiguous run, cut into the forward's size classes (group_norm_common.cuh).
// The group sums need no pass of their own: sum(dy * gamma) = sum_c gamma_c
// dbeta_c and sum(dy * gamma * x_hat) = sum_c gamma_c dgamma_c. So each warp
// reduces, by shuffles, the dbeta/dgamma partials of every channel it touched
// into its row of a [warps][2][cpg] array in shared memory; after one barrier
// one warp sums the rows in a fixed order, writes the partials and forms the
// two group sums; a second barrier hands them to every thread. Two barriers a
// group up to 256 channels a group (the flat class takes at most 64; the
// stream class fills the array kChunk = 256 channels a pass, two barriers a
// pass, so any cpg fits 16 KB).
// The dx pass runs from registers in the flat class (groups of up to 16384
// f32 or 32768 bf16 elements with HW a multiple of 16 bytes: x and g are
// read from memory once); the stream class (larger groups, other shapes)
// reads x and g again, channel by channel.
// Each sum runs in a fixed order and each output has one writer: no atomics,
// so two runs give bit-identical gradients.

#include "group_norm_common.cuh"

#include <math.h>

#include <algorithm>

namespace {

using gn::Shape;

// dy and x_hat of one element.
__device__ __forceinline__ float grad_in(float xv, float gv, float mean, float rstd,
                                         float gam, float bet, int silu, float& xhat) {
  xhat = (xv - mean) * rstd;
  if (!silu) return gv;
  const float y = xhat * gam + bet;
  const float s = gn::sigmoid(y);
  return gv * s * (1.f + y * (1.f - s));
}

// After the group's barrier, one warp: sums the rows of ps ([rows][2][nc]:
// dgamma, then dbeta partials of the group's channels c0 .. c0 + nc) in
// order, writes them to part (2, B, C) at sample b, and adds gamma_c dbeta_c
// and gamma_c dgamma_c to the lane's a1 and a2.
__device__ __forceinline__ void sum_partials(const float* ps, int rows, int nc, int c0,
                                             const Shape& s, int b, int grp, const float* gam,
                                             float* __restrict__ part, float& a1, float& a2,
                                             int lane) {
  const int64_t o = static_cast<int64_t>(b) * s.C + grp * s.cpg + c0;
  const int64_t half = static_cast<int64_t>(s.B) * s.C;
  for (int t = lane; t < nc; t += 32) {
    float dg = 0.f, db = 0.f;
    for (int i = 0; i < rows; ++i) {
      dg += ps[(2 * i) * nc + t];
      db += ps[(2 * i + 1) * nc + t];
    }
    part[o + t] = dg;
    part[half + o + t] = db;
    const float gc = gam[c0 + t];
    a1 += gc * db;
    a2 += gc * dg;
  }
}

// One warp: the group sums sum_c gamma_c dbeta_c and sum_c gamma_c dgamma_c
// from the lanes' a1 and a2, into s12.
__device__ __forceinline__ void group_sums(float a1, float a2, float* s12, int lane) {
  gn::warp_sum2(a1, a2);
  if (lane == 0) {
    s12[0] = a1;
    s12[1] = a2;
  }
}

// At most 1024 threads a block, so at most 64 registers a thread: x and dy
// take 8 * UPW of them.
template <typename T, int UPW>
__global__ void __launch_bounds__(1024)
group_norm_bwd_flat(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                    T* __restrict__ dx, float* __restrict__ part, const Shape s,
                    const int silu) {
  constexpr int V = gn::Vec<T>::N;
  // f32: pass 1 leaves dy in place of g (the same 16 bytes), so pass 2 does
  // not run the SiLU chain again; bf16 dy would need twice the registers.
  constexpr bool kKeepDy = sizeof(T) == 4;
  extern __shared__ float smem[];  // per group of the block: [wpg][2][cpg], then 2
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gl = warp / s.wpg, w = warp - gl * s.wpg;
  const int bg = blockIdx.x * s.gpb + gl;
  // Only the one-warp-a-group case (wpg == 1) has groups past the end; it has
  // no block barrier.
  if (bg >= s.B * s.G) return;
  float* ps = smem + gl * (s.wpg * 2 * s.cpg + 2);
  float* pw = ps + w * 2 * s.cpg;
  float* s12 = ps + s.wpg * 2 * s.cpg;
  for (int i = lane; i < 2 * s.cpg; i += 32) pw[i] = 0.f;
  __syncwarp();

  const int b = bg / s.G, grp = bg - b * s.G;
  const int64_t base = static_cast<int64_t>(bg) * s.n;
  const float mean = mean_in[bg], rstd = rstd_in[bg];
  const int64_t aff = static_cast<int64_t>(b / s.spr) * s.C + grp * s.cpg;
  const float* gam = gamma + aff;
  const float* bet = beta + aff;
  const int u0 = w * s.upw;
  const int nu = min(s.upw, s.units - u0);

  uint4 rx[UPW], rg[UPW];
#pragma unroll
  for (int k = 0; k < UPW; ++k) {
    const int j = (u0 + k) * 32 + lane;
    const bool in = k < nu && j < s.nvec;
    rx[k] = in ? gn::load16(x + base + static_cast<int64_t>(j) * V) : make_uint4(0u, 0u, 0u, 0u);
    rg[k] = in ? gn::load16(g + base + static_cast<int64_t>(j) * V) : make_uint4(0u, 0u, 0u, 0u);
  }

  // Pass 1: dbeta/dgamma of each channel run, reduced over its lanes (a
  // segment of 1 << lsh lanes, the whole warp when lsh == 5) when the run ends.
  const int seg = 1 << s.lsh;
  float db = 0.f, dg = 0.f;
  int cu = (u0 / s.upc) * s.cpu, r = u0 % s.upc;
#pragma unroll
  for (int k = 0; k < UPW; ++k) {
    if (k < nu) {
      const int j = (u0 + k) * 32 + lane;
      const int c = cu + (lane >> s.lsh);
      if (j < s.nvec) {
        const float gc = __ldg(gam + c), bc = __ldg(bet + c);
        float fx[V], fg[V];
        gn::unpack(rx[k], fx);
        gn::unpack(rg[k], fg);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          float xhat;
          const float dy = grad_in(fx[i], fg[i], mean, rstd, gc, bc, silu, xhat);
          db += dy;
          dg += dy * xhat;
          fg[i] = dy;
        }
        if constexpr (kKeepDy)
          rg[k] = make_uint4(__float_as_uint(fg[0]), __float_as_uint(fg[1]),
                             __float_as_uint(fg[2]), __float_as_uint(fg[3]));
      }
      if (r + 1 == s.upc || k + 1 == nu) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          if (o < seg) {
            db += __shfl_xor_sync(0xffffffffu, db, o);
            dg += __shfl_xor_sync(0xffffffffu, dg, o);
          }
        }
        if ((lane & (seg - 1)) == 0 && c < s.cpg) {
          pw[c] = dg;
          pw[s.cpg + c] = db;
        }
        db = dg = 0.f;
      }
    }
    if (++r == s.upc) {
      r = 0;
      cu += s.cpu;
    }
  }
  if (s.wpg > 1) __syncthreads(); else __syncwarp();
  if (w == 0) {
    float a1 = 0.f, a2 = 0.f;
    sum_partials(ps, s.wpg, s.cpg, 0, s, b, grp, gam, part, a1, a2, lane);
    group_sums(a1, a2, s12, lane);
  }
  if (s.wpg > 1) __syncthreads(); else __syncwarp();
  const float m1 = s12[0] / static_cast<float>(s.n);
  const float m2 = s12[1] / static_cast<float>(s.n);

  // Pass 2: dx from the registers.
  T* dxg = dx + base;
  cu = (u0 / s.upc) * s.cpu;
  r = u0 % s.upc;
#pragma unroll
  for (int k = 0; k < UPW; ++k) {
    const int j = (u0 + k) * 32 + lane;
    if (k < nu && j < s.nvec) {
      const int c = cu + (lane >> s.lsh);
      const float gc = __ldg(gam + c), bc = __ldg(bet + c);
      float fx[V], fg[V];
      gn::unpack(rx[k], fx);
      gn::unpack(rg[k], fg);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float xhat = (fx[i] - mean) * rstd;
        const float dy = kKeepDy ? fg[i] : grad_in(fx[i], fg[i], mean, rstd, gc, bc, silu, xhat);
        fx[i] = rstd * (dy * gc - m1 - xhat * m2);
      }
      gn::store_vec<V>(dxg + static_cast<int64_t>(j) * V, fx);
    }
    if (++r == s.upc) {
      r = 0;
      cu += s.cpu;
    }
  }
}

constexpr int kChunk = 256;  // stream: channels a pass of the shared partials

template <typename T, int V>
__global__ void __launch_bounds__(gn::kStreamThreads)
group_norm_bwd_stream(const T* __restrict__ x, const T* __restrict__ g,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                      T* __restrict__ dx, float* __restrict__ part, const Shape s,
                      const int silu) {
  constexpr int kWarps = gn::kStreamThreads / 32;
  extern __shared__ float smem[];  // [kWarps][2][min(cpg, kChunk)], then 2
  const int bg = blockIdx.x;
  const int b = bg / s.G, grp = bg - b * s.G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* s12 = smem + kWarps * 2 * min(s.cpg, kChunk);
  const int64_t base = static_cast<int64_t>(bg) * s.n;
  const float mean = mean_in[bg], rstd = rstd_in[bg];
  const int64_t aff = static_cast<int64_t>(b / s.spr) * s.C + grp * s.cpg;
  const float* gam = gamma + aff;
  const float* bet = beta + aff;

  float a1 = 0.f, a2 = 0.f;  // warp 0's lanes: the group sums so far
  for (int c0 = 0; c0 < s.cpg; c0 += kChunk) {
    const int nc = min(kChunk, s.cpg - c0);
    float* pw = smem + warp * 2 * nc;
    if (c0 > 0) __syncthreads();  // warp 0 has read the previous pass
    for (int c = c0; c < c0 + nc; ++c) {
      const float gc = gam[c], bc = bet[c];
      const int64_t cb = base + static_cast<int64_t>(c) * s.hwv * V;
      float db = 0.f, dg = 0.f;
      for (int i = tid; i < s.hwv; i += gn::kStreamThreads) {
        float fx[V], fg[V];
        gn::load_f<V>(x + cb + static_cast<int64_t>(i) * V, fx);
        gn::load_f<V>(g + cb + static_cast<int64_t>(i) * V, fg);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          float xhat;
          const float dy = grad_in(fx[e], fg[e], mean, rstd, gc, bc, silu, xhat);
          db += dy;
          dg += dy * xhat;
        }
      }
      gn::warp_sum2(db, dg);
      if (lane == 0) {
        pw[c - c0] = dg;
        pw[nc + c - c0] = db;
      }
    }
    __syncthreads();
    if (warp == 0) sum_partials(smem, kWarps, nc, c0, s, b, grp, gam, part, a1, a2, lane);
  }
  if (warp == 0) group_sums(a1, a2, s12, lane);
  __syncthreads();
  const float m1 = s12[0] / static_cast<float>(s.n);
  const float m2 = s12[1] / static_cast<float>(s.n);

  for (int c = 0; c < s.cpg; ++c) {
    const float gc = gam[c], bc = bet[c];
    const int64_t cb = base + static_cast<int64_t>(c) * s.hwv * V;
    for (int i = tid; i < s.hwv; i += gn::kStreamThreads) {
      float fx[V], fg[V];
      gn::load_f<V>(x + cb + static_cast<int64_t>(i) * V, fx);
      gn::load_f<V>(g + cb + static_cast<int64_t>(i) * V, fg);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float xhat;
        const float dy = grad_in(fx[e], fg[e], mean, rstd, gc, bc, silu, xhat);
        fx[e] = rstd * (dy * gc - m1 - xhat * m2);
      }
      gn::store_f<V>(dx + cb + static_cast<int64_t>(i) * V, fx);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* g, const float* gamma, const float* beta,
                   const float* mean, const float* rstd, void* dx, float* part, int B, int C,
                   int HW, int G, int R, int silu, cudaStream_t stream) {
  Shape s{};
  const gn::Plan p = gn::make_plan(s, B, C, HW, G, R, sizeof(T),
                                   gn::aligned16(x) && gn::aligned16(g) && gn::aligned16(dx),
                                   gn::kBwdCut);
  auto xt = static_cast<const T*>(x);
  auto gt = static_cast<const T*>(g);
  auto dxt = static_cast<T*>(dx);
  if (p.kind == gn::kStream) {
    const size_t smem =
        ((gn::kStreamThreads / 32) * 2 * std::min(s.cpg, kChunk) + 2) * sizeof(float);
    if (p.vec)
      group_norm_bwd_stream<T, gn::Vec<T>::N><<<p.blocks, p.threads, smem, stream>>>(
          xt, gt, gamma, beta, mean, rstd, dxt, part, s, silu);
    else
      group_norm_bwd_stream<T, 1><<<p.blocks, p.threads, smem, stream>>>(
          xt, gt, gamma, beta, mean, rstd, dxt, part, s, silu);
    return cudaGetLastError();
  }
  const size_t smem = s.gpb * (s.wpg * 2 * s.cpg + 2) * sizeof(float);
  switch (p.upw_t) {
    case 1:
      group_norm_bwd_flat<T, 1><<<p.blocks, p.threads, smem, stream>>>(
          xt, gt, gamma, beta, mean, rstd, dxt, part, s, silu);
      break;
    case 2:
      group_norm_bwd_flat<T, 2><<<p.blocks, p.threads, smem, stream>>>(
          xt, gt, gamma, beta, mean, rstd, dxt, part, s, silu);
      break;
    default:  // kBwdCut: at most 4 units a warp
      group_norm_bwd_flat<T, 4><<<p.blocks, p.threads, smem, stream>>>(
          xt, gt, gamma, beta, mean, rstd, dxt, part, s, silu);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gadm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, g: contiguous (B, C, H*W) in one dtype (0 = float32, 1 = bfloat16);
// gamma, beta: contiguous (R, C) f32, R dividing B; mean, rstd: (B, G) f32
// from the forward; dx: contiguous like x; part: (2, B, C) f32, the dgamma
// then the dbeta partials. Returns a cudaError_t.
int gadm_group_norm_bwd(const void* x, const void* g, const float* gamma, const float* beta,
                        const float* mean, const float* rstd, void* dx, float* part,
                        int dtype, int B, int C, int HW, int G, int R, int silu, int device,
                        void* stream) {
  if (B <= 0 || G <= 0 || C % G != 0 || HW <= 0 || R <= 0 || B % R != 0 ||
      static_cast<int64_t>(C / G) * HW > INT32_MAX)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, g, gamma, beta, mean, rstd, dx, part, B, C, HW, G, R, silu, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, g, gamma, beta, mean, rstd, dx, part, B, C, HW, G, R,
                                 silu, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
