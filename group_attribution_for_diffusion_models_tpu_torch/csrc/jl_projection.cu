// Johnson-Lindenstrauss random projection for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/jl_projection.py::_jl_kernel of the JAX
// package: Y = G R / sqrt(P) for per-sample gradient rows G (B, D), f32 or
// bf16, with a Rademacher R (D, P) that is generated inside the kernel and
// never stored. Accumulation is f32.
//
// The sign R[d, p] is a function of (seed, d, p) alone, not of tiles, grid
// order, the split of D or the batch size (the TPU kernel seeds per tile):
//   fmix32(h)  = murmur3's finalizer (xor-shift 16, * 0x85EBCA6B, xor-shift 13,
//                * 0xC2B2AE35, xor-shift 16), all in uint32
//   seed_key   = fmix32(seed ^ 0x9E3779B9)
//   key(g)     = fmix32(seed_key ^ g * 0x9E3779B9)       for g = p / 32
//   word(d, g) = fmix32(key(g) ^ d * 0x27D4EB2F)
//   R[d, p]    = -1 if bit p % 32 of word(d, p / 32) is set, else +1
// ops/jl_projection.py::jl_project_plain computes the same bits in int64.
//
// What bounds it: operations. One batch of the CIFAR U-Net's gradients is
// 2 * 32 * 35,746,307 * 4096 = 9.4e12 FLOPs against 4.6 GB of G, about 140 ms
// at the f32 FMA peak and 1.4 ms at the memory rate. So the design spends
// nothing on R's bytes and keeps the FMA pipes fed:
// - a thread owns 4 neighbouring columns for 32 batch rows, 128 f32
//   accumulators in registers; one hash word gives the 4 signs of a d, so the
//   hash costs about a tenth of the 128 FMAs it feeds;
// - a block of 128 threads covers 512 columns and one chunk of D; G's
//   (32 rows x 32 d) tiles pass through shared memory, double-buffered, and
//   every thread reads them as broadcast float4s;
// - D is split into chunks across blockIdx.y, so P / 512 column tiles still
//   fill the 132 SMs, and each chunk's partial Y goes to its own slice of a
//   (splits, B, P) buffer. A second kernel sums the slices in a fixed order
//   and scales by 1/sqrt(P): no atomics, two runs agree bit for bit.
// G is read with 64-bit offsets where it is ragged (no padded copy of G);
// rows >= B and d outside the chunk read as 0. Tensor cores (+-1 is exact in
// bf16, and G splits into bf16 pieces) are left for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4;                      // columns a thread owns
constexpr int kBlockCols = kThreads * kCols;  // 512 columns a block
constexpr int kRows = 32;                     // batch rows a block
constexpr int kTileD = 32;                    // d per shared-memory tile
constexpr int kLoads = kTileD * kRows / kThreads;
constexpr int kPad = 4;                       // keeps float4 rows aligned

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__host__ __device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    jl_partial_kernel(const T* __restrict__ g, float* __restrict__ partial, int B, int64_t D,
                      int P, int64_t chunk, uint32_t seed_key) {
  __shared__ __align__(16) float tile[2][kTileD][kRows + kPad];
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kBlockCols + tid * kCols;
  const int b0 = blockIdx.z * kRows;
  const int64_t d_begin = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t d_end = min(D, d_begin + chunk);
  const uint32_t key = fmix32(seed_key ^ (static_cast<uint32_t>(p0 >> 5) * 0x9E3779B9u));
  const int shift = p0 & 31;  // p0 % 4 == 0: the thread's 4 columns share one word

  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  // Element i of a tile: row (tid + i * kThreads) / kTileD, d column the rest,
  // so a warp reads 32 neighbouring d of one row.
  float staged[kLoads];
  auto load = [&](int64_t d0) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads;
      const int b = b0 + e / kTileD;
      const int64_t d = d0 + e % kTileD;
      staged[i] = (b < B && d < d_end) ? to_f32(g[static_cast<int64_t>(b) * D + d]) : 0.f;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads;
      tile[buf][e % kTileD][e / kTileD] = staged[i];
    }
  };

  load(d_begin);
  stage(0);
  __syncthreads();
  int buf = 0;
  for (int64_t d0 = d_begin; d0 < d_end; d0 += kTileD) {
    const bool more = d0 + kTileD < d_end;
    if (more) load(d0 + kTileD);
#pragma unroll 2
    for (int j = 0; j < kTileD; ++j) {
      const uint32_t w =
          fmix32(key ^ (static_cast<uint32_t>(d0 + j) * 0x27D4EB2Fu)) >> shift;
      float r[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c)  // +-1.0f: the word's bit becomes the sign bit
        r[c] = __uint_as_float(0x3F800000u | ((w << (31 - c)) & 0x80000000u));
      const float4* gv = reinterpret_cast<const float4*>(&tile[buf][j][0]);
#pragma unroll
      for (int q = 0; q < kRows / 4; ++q) {
        const float4 x = gv[q];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc[4 * q + 0][c] = fmaf(x.x, r[c], acc[4 * q + 0][c]);
          acc[4 * q + 1][c] = fmaf(x.y, r[c], acc[4 * q + 1][c]);
          acc[4 * q + 2][c] = fmaf(x.z, r[c], acc[4 * q + 2][c]);
          acc[4 * q + 3][c] = fmaf(x.w, r[c], acc[4 * q + 3][c]);
        }
      }
    }
    if (more) stage(buf ^ 1);  // the other buffer was last read before the barrier below
    __syncthreads();
    buf ^= 1;
  }

  float* out = partial + static_cast<int64_t>(blockIdx.y) * B * P;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = b0 + r;
    if (b >= B) break;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (p0 + c < P) out[static_cast<int64_t>(b) * P + p0 + c] = acc[r][c];
  }
}

// out[i] = scale * sum over the splits of partial[s][i], s in order.
__global__ void jl_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                 int splits, int64_t n, float scale) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[k * n + i];
  out[i] = s * scale;
}

template <typename T>
cudaError_t launch(const void* g, float* partial, float* out, int B, int64_t D, int P,
                   int64_t chunk, int splits, uint32_t seed, float scale, cudaStream_t stream) {
  const dim3 grid((P + kBlockCols - 1) / kBlockCols, splits, (B + kRows - 1) / kRows);
  jl_partial_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(g), partial, B, D,
                                                      P, chunk, fmix32(seed ^ 0x9E3779B9u));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = static_cast<int64_t>(B) * P;
  jl_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(partial, out,
                                                                                splits, n, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gadm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// g: contiguous (B, D) in one dtype (0 = float32, 1 = bfloat16), D < 2^32;
// partial: (splits, B, P) f32 scratch; out: (B, P) f32. Chunk s of D is
// [s * chunk, min(D, (s + 1) * chunk)), splits * chunk >= D. Returns a
// cudaError_t.
int gadm_jl_project(const void* g, float* partial, float* out, int dtype, int B, int64_t D,
                    int P, int64_t chunk, int splits, uint32_t seed, float scale, int device,
                    void* stream) {
  if (B <= 0 || D <= 0 || D > UINT32_MAX || P <= 0 || chunk <= 0 || splits <= 0 ||
      splits > 65535 || (B + kRows - 1) / kRows > 65535 || chunk * splits < D)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(g, partial, out, B, D, P, chunk, splits, seed, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(g, partial, out, B, D, P, chunk, splits, seed, scale, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
