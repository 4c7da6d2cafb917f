// Attention forward, softmax(Q K^T / sqrt(D)) V, for Hopper (sm_90a).
//
// Replaces the TPU kernels ops/attention.py::_flash_kernel (transposed
// (B*H, D, S) layout) and ::_hp_fwd_kernel (head-packed (B, S, H*D) layout)
// of the JAX package. Both compute the same function; here one kernel reads
// q/k/v through their strides straight from (B, S, H, D), so neither layout
// nor any transpose reaches device memory.
//
// What bounds it: at the CIFAR shape (B=64, S=256, H=1, D=256) the two
// products are 4*B*H*Sq*Skv*D = 4.3 GFLOP on 67 MB of q/k/v/o, so f32 inputs
// are bound by operations (the card's f32 FMA rate, no tensor cores) and
// bf16 inputs by bytes.
//
// Design: the TPU kernel holds a whole K/V slice in VMEM; 227 KB of shared
// memory cannot (f32 K+V at S=256, D=256 is 512 KB). So one block owns
// kBQ=64 query rows of one (b, h), keeps them in shared memory as f32, and
// loops over kBK=32-key tiles with an online softmax: a running row max and
// sum in f32 and an f32 output accumulator in registers, rescaled when the
// max moves. K and V tiles share one buffer (K for the scores, then V for
// the product). Every product is an f32 FMA (bf16 inputs are widened on the
// load), with float4 shared-memory reads and row strides of D+4 floats, which
// keep the 8 threads of a quarter-warp on distinct banks for any D % 8 == 0.
// Keys >= Skv score -inf; query rows >= Sq read zeros and are not stored.
// At D=256 the block needs 110 KB of dynamic shared memory, set through
// cudaFuncAttributeMaxDynamicSharedMemorySize once per instantiation and
// device (for the bucket's largest D); two blocks fit on an SM.
// A wgmma/TMA version is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 thread grid
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per tile (one per lane in the softmax)
constexpr int kLdP = kBK + 4;  // row stride of the probability tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// dst[r * ld + d] = src[r * row_stride + d] as f32 for r < valid, else 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                                          int64_t row_stride, int rows, int valid, int D) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    dst[r * ld + d] = r < valid ? to_f32(src[r * row_stride + d]) : 0.f;
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ constexpr int smem_floats(int D) {
  return (kBQ + kBK) * (D + 4) + kBQ * kLdP + 3 * kBQ;
}

// DMAX: the head-dim bucket (64, 128, 256) that sizes the accumulator.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H, int Sq,
                     int Skv, int D, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                     int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                     int64_t v_ss, int64_t v_sh, float scale) {
  constexpr int kC = DMAX / 64;  // 64-column chunks of the output row
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 4;
  float* Qs = smem;              // kBQ x ld
  float* KVs = Qs + kBQ * ld;    // kBK x ld, K then V
  float* Ps = KVs + kBK * ld;    // kBQ x kLdP scores, then probabilities
  float* m_s = Ps + kBQ * kLdP;  // running row max
  float* l_s = m_s + kBQ;        // running row sum
  float* a_s = l_s + kBQ;        // this tile's rescale factor

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  load_tile(Qs, ld, q + b * q_sb + h * q_sh + q0 * q_ss, q_ss, kBQ, min(kBQ, Sq - q0), D);
  if (tid < kBQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // Thread (ty, tx) owns output rows ty + 16 r and columns 4 tx + 64 c + e.
  float acc[4][kC][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][c][e] = 0.f;

  for (int k0 = 0; k0 < Skv; k0 += kBK) {
    const int kv_valid = min(kBK, Skv - k0);
    __syncthreads();  // the previous tile's P.V is done with KVs and Ps
    load_tile(KVs, ld, kb + k0 * k_ss, k_ss, kBK, kv_valid, D);
    __syncthreads();

    // Scores: thread (ty, tx) computes rows ty + 16 r, keys tx + 16 c.
    float s[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) s[r][0] = s[r][1] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[2];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * r) * ld + d]);
#pragma unroll
      for (int c = 0; c < 2; ++c)
        kv[c] = *reinterpret_cast<const float4*>(&KVs[(tx + 16 * c) * ld + d]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          s[r][c] = fmaf(qv[r].x, kv[c].x, s[r][c]);
          s[r][c] = fmaf(qv[r].y, kv[c].y, s[r][c]);
          s[r][c] = fmaf(qv[r].z, kv[c].z, s[r][c]);
          s[r][c] = fmaf(qv[r].w, kv[c].w, s[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = tx + 16 * c;
        Ps[(ty + 16 * r) * kLdP + key] = key < kv_valid ? s[r][c] * scale : -INFINITY;
      }
    __syncthreads();  // scores complete; K no longer needed

    // Online softmax: warp w updates rows 8 w .. 8 w + 7, one key per lane.
    // Every tile holds at least one valid key, so m_new is finite.
#pragma unroll
    for (int i = 0; i < kBQ / 8; ++i) {
      const int row = warp * (kBQ / 8) + i;
      const float sv = Ps[row * kLdP + lane];
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, warp_max(sv));
      const float p = expf(sv - m_new);
      const float sum = warp_sum(p);
      Ps[row * kLdP + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        a_s[row] = alpha;
        l_s[row] = l_s[row] * alpha + sum;
        m_s[row] = m_new;
      }
    }
    load_tile(KVs, ld, vb + k0 * v_ss, v_ss, kBK, kv_valid, D);
    __syncthreads();

    // acc = alpha * acc + P V over this tile's keys.
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float alpha = a_s[ty + 16 * r];
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][c][e] *= alpha;
    }
    for (int j = 0; j < kBK; j += 4) {
      float p[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * r) * kLdP + j]);
        p[r][0] = pv.x;
        p[r][1] = pv.y;
        p[r][2] = pv.z;
        p[r][3] = pv.w;
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int col = 4 * tx + 64 * c;
        if (col < D) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float4 vv = *reinterpret_cast<const float4*>(&KVs[(j + jj) * ld + col]);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              acc[r][c][0] = fmaf(p[r][jj], vv.x, acc[r][c][0]);
              acc[r][c][1] = fmaf(p[r][jj], vv.y, acc[r][c][1]);
              acc[r][c][2] = fmaf(p[r][jj], vv.z, acc[r][c][2]);
              acc[r][c][3] = fmaf(p[r][jj], vv.w, acc[r][c][3]);
            }
          }
        }
      }
    }
  }

  // o is a contiguous (B, Sq, H, D) tensor.
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty + 16 * r;
    if (q0 + row >= Sq) continue;
    const float inv = 1.f / l_s[row];
    T* orow = o + ((static_cast<int64_t>(b) * Sq + q0 + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = 4 * tx + 64 * c;
      if (col < D) {
#pragma unroll
        for (int e = 0; e < 4; ++e) store(orow + col + e, acc[r][c][e] * inv);
      }
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                   int Sq, int Skv, int D, const int64_t* st, float scale, int device,
                   cudaStream_t stream) {
  auto kernel = attention_fwd_kernel<T, DMAX>;
  // Devices (ids < 64) whose shared-memory limit for this instantiation is
  // already raised. A race only sets the same attribute twice.
  static uint64_t configured = 0;
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (!(configured & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float) * smem_floats(DMAX)));
    if (err != cudaSuccess) return err;
    configured |= bit;
  }
  const size_t smem = sizeof(float) * smem_floats(D);
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Sq, Skv, D, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B, int H,
                     int Sq, int Skv, int D, const int64_t* st, float scale, int device,
                     cudaStream_t stream) {
  if (D <= 64) return launch<T, 64>(q, k, v, o, B, H, Sq, Skv, D, st, scale, device, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, B, H, Sq, Skv, D, st, scale, device, stream);
  return launch<T, 256>(q, k, v, o, B, H, Sq, Skv, D, st, scale, device, stream);
}

}  // namespace

extern "C" {

const char* gadm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v: (B, S, H, D) with unit stride on D; strides in elements, in the
// order q (b, s, h), k (b, s, h), v (b, s, h). o: contiguous (B, Sq, H, D).
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
int gadm_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
                       int B, int H, int Sq, int Skv, int D, const int64_t* strides,
                       float scale, int device, void* stream) {
  if (D <= 0 || D > 256 || D % 8 != 0 || B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, H, Sq, Skv, D, strides, scale, device, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, H, Sq, Skv, D, strides, scale, device, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
