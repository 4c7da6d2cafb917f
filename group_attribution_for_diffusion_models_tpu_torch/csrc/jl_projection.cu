// Johnson-Lindenstrauss random projection for Hopper (sm_90a) on the tensor
// cores.
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
// 2 * 32 * 35,746,307 * 4096 = 9.37e12 FLOPs against 4.57 GB of G (1.37 ms
// at 3.35 TB/s). +-1 is exact in bf16, and an f32 g is exactly the sum of
// three bf16 pieces, g1 = rn(g), g2 = rn(g - g1), g3 = rn(g - g1 - g2) (for
// normal g), so the products run on the tensor cores: mma.sync m16n8k16 in
// bf16 with f32 accumulators, three products an f32 element (one for bf16
// G), each exact; only the f32 sums differ from the plain version's, by order.
// That is 28.4 ms at 989/3 TFLOP/s (139.9 ms at the f32 FMA rate). The design
// keeps everything but the products below their issue time:
// - a block of 8 warps owns 32 batch rows (two m-tiles) and 512 columns, a
//   warp 64 of them (8 n-tiles): 2 x 8 f32 accumulators of 16 x 8, and one
//   k16 step is 2 x 8 x 3 = 48 mma for a warp;
// - R's fragments are built in registers: per k16 step a warp needs the words
//   of 16 d for its 2 column groups, one hash per lane; 8 shuffles and 8
//   shifts give a lane the words of its 4 depths, and each bf16 +-1 pair of a
//   fragment is a byte permute and a LOP3 (the bits moved to the halves'
//   signs, ORed with 0x3F80);
// - G crosses shared memory once per block in d-tiles of 64 (32 rows), split
//   there into three bf16 planes that every warp reads by ldmatrix (rows of
//   72 bf16, 9 x 16 bytes, so ldmatrix's 8 rows hit distinct banks). The tile
//   loads are register-staged and double-buffered: tile t + 1's global loads
//   are issued before tile t's products and split into the other buffer after
//   them, one barrier a tile. Rows of G are as aligned as D makes them (D is
//   odd for the CIFAR U-Net: 4-byte rows in f32, 2-byte in bf16), below the
//   16 bytes TMA and the 16-byte cp.async need, and the split reads every
//   element into a register anyway; a warp reads 32 neighbouring d of a row;
// - D is split into chunks across blockIdx.y, so P / 512 column tiles and
//   B / 32 row tiles still fill the 132 SMs (two blocks an SM), and each
//   chunk's partial Y goes to its own slice of a (splits, B, P) buffer. A
//   second kernel sums the slices in a fixed order and scales by 1/sqrt(P):
//   no atomics, two runs agree bit for bit.
// G is read with 64-bit offsets where it is ragged (no padded copy of G);
// rows >= B and d outside the chunk read as 0. nvcc -Xptxas -v
// (scripts/kernel_stats.sh): 128 registers a thread (two blocks an SM), 60
// bytes spilled for f32 G and 12 for bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int kWarpCols = 64;                            // columns a warp owns
constexpr int kBlockCols = (kThreads / 32) * kWarpCols;  // 512 columns a block
constexpr int kBatchRows = 32;                           // batch rows a block (2 m-tiles)
constexpr int kTileD = 64;                               // d per shared-memory tile
constexpr int kLdP = kTileD + 8;                         // plane row stride (bf16)
constexpr int kLoads = kTileD * kBatchRows / kThreads;   // G elements a thread stages

template <typename T>
constexpr int kPieces = sizeof(T) == 4 ? 3 : 1;

__host__ __device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// The bf16 pair (+-1 for k, +-1 for k + 1) of one B-fragment register for
// column 8 jj + g of a word group: a and b are the words of depths k and k + 1
// shifted left by 7 - g, so the column's bit is bit 7 of byte jj. One byte
// permute puts byte jj of a in byte 1 and of b in byte 3; the bits then sit
// at 15 and 31, the two halves' signs.
template <int JJ>
__device__ __forceinline__ uint32_t sign_pair(uint32_t a, uint32_t b) {
  constexpr uint32_t sel = JJ | (JJ << 4) | ((4 + JJ) << 8) | ((4 + JJ) << 12);
  return (__byte_perm(a, b, sel) & 0x80008000u) | 0x3F803F80u;
}

__device__ __forceinline__ void split3(float x, __nv_bfloat16 (&p)[3]) {
  p[0] = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(p[0]);
  p[1] = __float2bfloat16_rn(r);
  p[2] = __float2bfloat16_rn(r - __bfloat162float(p[1]));
}

__device__ __forceinline__ void split3(__nv_bfloat16 x, __nv_bfloat16 (&p)[1]) { p[0] = x; }

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    jl_partial_kernel(const T* __restrict__ g, float* __restrict__ partial, int B, int64_t D,
                      int P, int64_t chunk, uint32_t seed_key) {
  constexpr int NP = kPieces<T>;
  __shared__ __align__(16) __nv_bfloat16 planes[2][NP][kBatchRows * kLdP];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int lg = lane >> 2;  // fragment row / column within an n-tile
  const int lt = lane & 3;
  const int p_warp = blockIdx.x * kBlockCols + warp * kWarpCols;
  const int b0 = blockIdx.z * kBatchRows;
  const int64_t d_begin = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t d_end = min(D, d_begin + chunk);
  // This lane hashes depth (lane % 16) of its k16 step for column group lane / 16.
  const uint32_t key =
      fmix32(seed_key ^ (static_cast<uint32_t>((p_warp >> 5) + (lane >> 4)) * 0x9E3779B9u));
  const int a_off = (lane & 15) * kLdP + ((lane >> 4) << 3);  // ldmatrix row of this lane

  float acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  // Element i of a tile: row (tid + i * kThreads) / kTileD, d column the rest.
  T staged[kLoads];
  auto load = [&](int64_t d0) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads;
      const int b = b0 + e / kTileD;
      const int64_t d = d0 + e % kTileD;
      staged[i] = (b < B && d < d_end) ? g[static_cast<int64_t>(b) * D + d] : T(0.f);
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads;
      const int at = (e / kTileD) * kLdP + e % kTileD;
      __nv_bfloat16 piece[NP];
      split3(staged[i], piece);
#pragma unroll
      for (int p = 0; p < NP; ++p) planes[buf][p][at] = piece[p];
    }
  };

  load(d_begin);
  stage(0);
  __syncthreads();
  int buf = 0;
  for (int64_t d0 = d_begin; d0 < d_end; d0 += kTileD) {
    const bool more = d0 + kTileD < d_end;
    if (more) load(d0 + kTileD);
#pragma unroll
    for (int ks = 0; ks < kTileD / 16; ++ks) {
      // R: one word a lane, then the words of depths 2t, 2t+1, 2t+8, 2t+9 of
      // both column groups, shifted so column 8 jj + g's bit is bit 7 of byte jj.
      const uint32_t word =
          fmix32(key ^ (static_cast<uint32_t>(d0 + ks * 16 + (lane & 15)) * 0x27D4EB2Fu));
      uint32_t w[2][4];
#pragma unroll
      for (int grp = 0; grp < 2; ++grp)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[grp][i] = __shfl_sync(0xffffffffu, word, 16 * grp + 2 * lt + (i & 1) + 8 * (i >> 1))
                      << (7 - lg);
      uint32_t rb[8][2];
#pragma unroll
      for (int grp = 0; grp < 2; ++grp) {
        rb[4 * grp + 0][0] = sign_pair<0>(w[grp][0], w[grp][1]);
        rb[4 * grp + 0][1] = sign_pair<0>(w[grp][2], w[grp][3]);
        rb[4 * grp + 1][0] = sign_pair<1>(w[grp][0], w[grp][1]);
        rb[4 * grp + 1][1] = sign_pair<1>(w[grp][2], w[grp][3]);
        rb[4 * grp + 2][0] = sign_pair<2>(w[grp][0], w[grp][1]);
        rb[4 * grp + 2][1] = sign_pair<2>(w[grp][2], w[grp][3]);
        rb[4 * grp + 3][0] = sign_pair<3>(w[grp][0], w[grp][1]);
        rb[4 * grp + 3][1] = sign_pair<3>(w[grp][2], w[grp][3]);
      }
      // G: the pieces of one m-tile at this depth, then its products, the
      // smallest piece first.
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        uint32_t ga[NP][4];
#pragma unroll
        for (int p = 0; p < NP; ++p)
          ldsm_x4(ga[p], &planes[buf][p][m * 16 * kLdP + a_off + ks * 16]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int p = NP - 1; p >= 0; --p) mma_bf16(acc[m][j], ga[p], rb[j]);
      }
    }
    if (more) stage(buf ^ 1);  // the other buffer was last read before the barrier below
    __syncthreads();
    buf ^= 1;
  }

  // acc[m][j][e]: row 16 m + g + 8 (e / 2), column p_warp + 8 j + 2 t + e % 2.
  float* out = partial + static_cast<int64_t>(blockIdx.y) * B * P;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int b = b0 + 16 * m + lg + 8 * (e >> 1);
      if (b >= B) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = p_warp + 8 * j + 2 * lt + (e & 1);
        if (p < P) out[static_cast<int64_t>(b) * P + p] = acc[m][j][e];
      }
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
  const dim3 grid((P + kBlockCols - 1) / kBlockCols, splits, (B + kBatchRows - 1) / kBatchRows);
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
      splits > 65535 || (B + kBatchRows - 1) / kBatchRows > 65535 || chunk * splits < D)
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
