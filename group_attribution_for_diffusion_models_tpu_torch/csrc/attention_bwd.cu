// Attention backward for Hopper (sm_90a): the dQ pass and the dK/dV pass.
//
// Replaces the TPU kernels ops/attention.py::_flash_bwd_dq_kernel and
// ::_flash_bwd_dkv_kernel (transposed (B*H, D, S) layout) and
// ::_hp_bwd_dq_kernel and ::_hp_bwd_dkv_kernel (head-packed (B, S, H*D)) of
// the JAX package. They compute the same two functions; here each pass is one
// kernel that reads q/k/v/dO through their strides straight from (B, S, H, D),
// so neither TPU layout reaches device memory. The scheme is the one the TPU
// kernels use (FlashAttention-2): nothing but the operands is kept from the
// forward, no (Sq, Skv) matrix is written, and
//
//   dQ pass, per (b, h, 64-query tile):  the forward again (online softmax
//     over 32-key tiles) gives O and lse = m + log(sum p); delta = rowsum(dO.O);
//     then, over the key tiles once more, P = exp(S - lse), dP = dO V^T,
//     dS = P (dP - delta), dQ += dS K. Writes dQ, lse and delta (B, H, Sq) f32.
//   dK/dV pass, per (b, h, 32-key tile): over 32-query tiles,
//     P^T = exp(K Q^T - lse), dP^T = V dO^T, dS^T = P^T (dP^T - delta),
//     dV += P^T dO, dK += dS^T Q.
//
// What bounds it: at the CIFAR shape (B=64, S=256, H=1, D=256) the function
// needs 10*B*H*Sq*Skv*D = 10.7 GFLOP (S once, then P.V, dO.V^T, dS.K, dS^T.Q,
// P^T.dO) on 134 MB of q/k/v/dO/dq/dk/dv in f32, so f32 inputs are bound by
// operations (the card's f32 FMA rate; these kernels use no tensor cores) and
// bf16 inputs by bytes. This scheme does 18*B*H*Sq*Skv*D: the dQ pass forms S
// twice (once for the softmax statistics, once for dS) and the dK/dV pass
// forms S and dP again. The JAX kernels do 16, holding a whole K/V slice in
// VMEM.
//
// Design: as in attention.cu, every product is an f32 FMA (bf16 is widened on
// the load), tiles sit in shared memory as f32 with row strides of D+4 floats
// (quarter-warps on distinct banks for any D % 8 == 0), and the accumulators
// live in registers, sized by the head-dim bucket DMAX (64, 128, 256). At
// D=256 the dQ pass keeps Q, dO (64 rows each), K and V (32 rows each) and one
// 64x32 score tile: 205 KB, one block per SM. The dK/dV pass keeps K, V, Q and
// dO tiles of 32 rows and two 32x32 tiles: 139 KB. Every output element has
// one owner thread and every sum runs in a fixed order: no atomics, so two
// runs give bit-identical gradients. Keys >= Skv get P = 0 and are not
// stored; query rows >= Sq read zeros, get lse = +inf (so P = 0) and are not
// stored. A wgmma/TMA version is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 thread grid
constexpr int kBQ = 64;        // dQ pass: query rows per block
constexpr int kBK = 32;        // keys per tile (one per lane in the softmax)
constexpr int kLdP = kBK + 4;  // row stride of a 32-wide score tile
constexpr int kBKV = 32;       // dK/dV pass: key rows per block
constexpr int kBQ2 = 32;       // dK/dV pass: query rows per tile

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

// Sum over the 16 lanes of a half-warp (the tx threads of one row).
__device__ __forceinline__ float half_warp_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[i][j] = sum_d A[(ty + 16 i) * ld + d] * B[(tx + 16 j) * ld + d], i < RA, j < RB.
template <int RA, int RB>
__device__ __forceinline__ void dot_rows(float (&out)[RA][RB], const float* A,
                                         const float* B, int ld, int D, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RA; ++i)
#pragma unroll
    for (int j = 0; j < RB; ++j) out[i][j] = 0.f;
  for (int d = 0; d < D; d += 4) {
    float4 av[RA], bv[RB];
#pragma unroll
    for (int i = 0; i < RA; ++i)
      av[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * ld + d]);
#pragma unroll
    for (int j = 0; j < RB; ++j)
      bv[j] = *reinterpret_cast<const float4*>(&B[(tx + 16 * j) * ld + d]);
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        out[i][j] = fmaf(av[i].x, bv[j].x, out[i][j]);
        out[i][j] = fmaf(av[i].y, bv[j].y, out[i][j]);
        out[i][j] = fmaf(av[i].z, bv[j].z, out[i][j]);
        out[i][j] = fmaf(av[i].w, bv[j].w, out[i][j]);
      }
  }
}

// acc[i][c][e] += sum_j W[(ty + 16 i) * kLdP + j] * X[j * ld + 4 tx + 64 c + e] over
// j < 32: rows ty + 16 i of a 32-wide weight tile times a 32-row operand tile.
template <int RA, int KC>
__device__ __forceinline__ void accumulate(float (&acc)[RA][KC][4], const float* W,
                                           const float* X, int ld, int D, int ty, int tx) {
  for (int j = 0; j < kBK; j += 4) {
    float w[RA][4];
#pragma unroll
    for (int i = 0; i < RA; ++i) {
      const float4 wv = *reinterpret_cast<const float4*>(&W[(ty + 16 * i) * kLdP + j]);
      w[i][0] = wv.x;
      w[i][1] = wv.y;
      w[i][2] = wv.z;
      w[i][3] = wv.w;
    }
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const int col = 4 * tx + 64 * c;
      if (col < D) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 xv = *reinterpret_cast<const float4*>(&X[(j + jj) * ld + col]);
#pragma unroll
          for (int i = 0; i < RA; ++i) {
            acc[i][c][0] = fmaf(w[i][jj], xv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(w[i][jj], xv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(w[i][jj], xv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(w[i][jj], xv.w, acc[i][c][3]);
          }
        }
      }
    }
  }
}

__host__ __device__ constexpr int dq_smem_floats(int D) {
  return (2 * kBQ + 2 * kBK) * (D + 4) + kBQ * kLdP + 5 * kBQ;
}

__host__ __device__ constexpr int dkv_smem_floats(int D) {
  return (2 * kBKV + 2 * kBQ2) * (D + 4) + 2 * kBKV * kLdP + 2 * kBQ2;
}

struct Strides {
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, g_sh;
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        T* __restrict__ dq, float* __restrict__ lse_out,
                        float* __restrict__ delta_out, int H, int Sq, int Skv, int D,
                        Strides st, float scale) {
  constexpr int kC = DMAX / 64;  // 64-column chunks of a row
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 4;
  float* Qs = smem;               // kBQ x ld
  float* Gs = Qs + kBQ * ld;      // kBQ x ld, dO
  float* Ks = Gs + kBQ * ld;      // kBK x ld
  float* Vs = Ks + kBK * ld;      // kBK x ld
  float* Ps = Vs + kBK * ld;      // kBQ x kLdP: scores, p, then dS
  float* m_s = Ps + kBQ * kLdP;   // running row max
  float* l_s = m_s + kBQ;         // running row sum
  float* a_s = l_s + kBQ;         // this tile's rescale factor
  float* lse_s = a_s + kBQ;
  float* dl_s = lse_s + kBQ;      // delta

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q_valid = min(kBQ, Sq - q0);

  const T* kb = k + b * st.k_sb + h * st.k_sh;
  const T* vb = v + b * st.v_sb + h * st.v_sh;
  load_tile(Qs, ld, q + b * st.q_sb + h * st.q_sh + q0 * st.q_ss, st.q_ss, kBQ, q_valid, D);
  load_tile(Gs, ld, g + b * st.g_sb + h * st.g_sh + q0 * st.g_ss, st.g_ss, kBQ, q_valid, D);
  if (tid < kBQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // Thread (ty, tx) owns rows ty + 16 r and columns 4 tx + 64 c + e.
  float acc[4][kC][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][c][e] = 0.f;

  // Pass 1: the forward, O = softmax(S) V with an online softmax.
  for (int k0 = 0; k0 < Skv; k0 += kBK) {
    const int kv_valid = min(kBK, Skv - k0);
    __syncthreads();  // the previous tile is done with Ks, Vs and Ps
    load_tile(Ks, ld, kb + k0 * st.k_ss, st.k_ss, kBK, kv_valid, D);
    load_tile(Vs, ld, vb + k0 * st.v_ss, st.v_ss, kBK, kv_valid, D);
    __syncthreads();
    float s[4][2];
    dot_rows<4, 2>(s, Qs, Ks, ld, D, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = tx + 16 * c;
        Ps[(ty + 16 * r) * kLdP + key] = key < kv_valid ? s[r][c] * scale : -INFINITY;
      }
    __syncthreads();
    // Warp w updates rows 8 w .. 8 w + 7, one key per lane; every tile holds
    // at least one valid key, so m_new is finite.
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
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float alpha = a_s[ty + 16 * r];
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][c][e] *= alpha;
    }
    accumulate<4, kC>(acc, Ps, Vs, ld, D, ty, tx);
  }

  // lse = m + log(l); delta = rowsum(dO * O), O = acc / l.
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty + 16 * r;
    const float inv = 1.f / l_s[row];
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = 4 * tx + 64 * c;
      if (col < D) {
#pragma unroll
        for (int e = 0; e < 4; ++e) part = fmaf(acc[r][c][e] * inv, Gs[row * ld + col + e], part);
      }
    }
    part = half_warp_sum(part);
    if (tx == 0) {
      const float lse = m_s[row] + logf(l_s[row]);
      lse_s[row] = lse;
      dl_s[row] = part;
      if (row < q_valid) {
        const int64_t at = (static_cast<int64_t>(b) * H + h) * Sq + q0 + row;
        lse_out[at] = lse;
        delta_out[at] = part;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][c][e] = 0.f;

  // Pass 2: dS = P (dP - delta) per key tile, dQ += dS K.
  for (int k0 = 0; k0 < Skv; k0 += kBK) {
    const int kv_valid = min(kBK, Skv - k0);
    __syncthreads();  // lse_s/dl_s written; the previous tile is done with Ks, Ps
    load_tile(Ks, ld, kb + k0 * st.k_ss, st.k_ss, kBK, kv_valid, D);
    load_tile(Vs, ld, vb + k0 * st.v_ss, st.v_ss, kBK, kv_valid, D);
    __syncthreads();
    float s[4][2], dp[4][2];
    dot_rows<4, 2>(s, Qs, Ks, ld, D, ty, tx);
    dot_rows<4, 2>(dp, Gs, Vs, ld, D, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty + 16 * r;
      const float lse = lse_s[row];
      const float delta = dl_s[row];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = tx + 16 * c;
        const float p = key < kv_valid ? expf(s[r][c] * scale - lse) : 0.f;
        Ps[row * kLdP + key] = p * (dp[r][c] - delta);
      }
    }
    __syncthreads();
    accumulate<4, kC>(acc, Ps, Ks, ld, D, ty, tx);
  }

  // dq is a contiguous (B, Sq, H, D) tensor.
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty + 16 * r;
    if (row >= q_valid) continue;
    T* out = dq + ((static_cast<int64_t>(b) * Sq + q0 + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = 4 * tx + 64 * c;
      if (col < D) {
#pragma unroll
        for (int e = 0; e < 4; ++e) store(out + col + e, acc[r][c][e] * scale);
      }
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int H, int Sq, int Skv,
                         int D, Strides st, float scale) {
  constexpr int kC = DMAX / 64;
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 4;
  float* Ks = smem;                // kBKV x ld
  float* Vs = Ks + kBKV * ld;      // kBKV x ld
  float* Qs = Vs + kBKV * ld;      // kBQ2 x ld
  float* Gs = Qs + kBQ2 * ld;      // kBQ2 x ld, dO
  float* Pt = Gs + kBQ2 * ld;      // kBKV x kLdP: P^T
  float* St = Pt + kBKV * kLdP;    // kBKV x kLdP: dS^T
  float* lse_s = St + kBKV * kLdP; // kBQ2
  float* dl_s = lse_s + kBQ2;      // kBQ2

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int k0 = blockIdx.y * kBKV;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int kv_valid = min(kBKV, Skv - k0);

  load_tile(Ks, ld, k + b * st.k_sb + h * st.k_sh + k0 * st.k_ss, st.k_ss, kBKV, kv_valid, D);
  load_tile(Vs, ld, v + b * st.v_sb + h * st.v_sh + k0 * st.v_ss, st.v_ss, kBKV, kv_valid, D);
  const T* qb = q + b * st.q_sb + h * st.q_sh;
  const T* gb = g + b * st.g_sb + h * st.g_sh;
  const float* lse_b = lse + (static_cast<int64_t>(b) * H + h) * Sq;
  const float* dl_b = delta + (static_cast<int64_t>(b) * H + h) * Sq;

  // Thread (ty, tx) owns key rows ty + 16 r and columns 4 tx + 64 c + e.
  float acc_k[2][kC][4], acc_v[2][kC][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[r][c][e] = acc_v[r][c][e] = 0.f;

  for (int q0 = 0; q0 < Sq; q0 += kBQ2) {
    const int q_valid = min(kBQ2, Sq - q0);
    __syncthreads();  // the previous tile is done with Qs, Gs, Pt, St
    load_tile(Qs, ld, qb + q0 * st.q_ss, st.q_ss, kBQ2, q_valid, D);
    load_tile(Gs, ld, gb + q0 * st.g_ss, st.g_ss, kBQ2, q_valid, D);
    if (tid < kBQ2) {
      lse_s[tid] = tid < q_valid ? lse_b[q0 + tid] : INFINITY;  // P = 0 beyond Sq
      dl_s[tid] = tid < q_valid ? dl_b[q0 + tid] : 0.f;
    }
    __syncthreads();
    // Keys ty + 16 r against queries tx + 16 c.
    float s[2][2], dp[2][2];
    dot_rows<2, 2>(s, Ks, Qs, ld, D, ty, tx);
    dot_rows<2, 2>(dp, Vs, Gs, ld, D, ty, tx);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qi = tx + 16 * c;
        const float p = key < kv_valid ? expf(s[r][c] * scale - lse_s[qi]) : 0.f;
        Pt[key * kLdP + qi] = p;
        St[key * kLdP + qi] = p * (dp[r][c] - dl_s[qi]);
      }
    }
    __syncthreads();
    accumulate<2, kC>(acc_v, Pt, Gs, ld, D, ty, tx);
    accumulate<2, kC>(acc_k, St, Qs, ld, D, ty, tx);
  }

  // dk, dv are contiguous (B, Skv, H, D) tensors.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = ty + 16 * r;
    if (key >= kv_valid) continue;
    const int64_t at = ((static_cast<int64_t>(b) * Skv + k0 + key) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = 4 * tx + 64 * c;
      if (col < D) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          store(dk + at + col + e, acc_k[r][c][e] * scale);
          store(dv + at + col + e, acc_v[r][c][e]);
        }
      }
    }
  }
}

// Raise a kernel's dynamic shared-memory limit once per device (ids < 64).
// A race only sets the same attribute twice.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, uint64_t& configured, int device, int bytes) {
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (configured & bit) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) configured |= bit;
  return err;
}

template <typename T, int DMAX>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* g, void* dq,
                      float* lse, float* delta, int B, int H, int Sq, int Skv, int D,
                      const Strides& st, float scale, int device, cudaStream_t stream) {
  auto kernel = attention_bwd_dq_kernel<T, DMAX>;
  static uint64_t configured = 0;
  cudaError_t err = allow_smem(kernel, configured, device,
                               static_cast<int>(sizeof(float) * dq_smem_floats(DMAX)));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, sizeof(float) * dq_smem_floats(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<T*>(dq), lse, delta, H, Sq, Skv, D, st, scale);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* g,
                       const float* lse, const float* delta, void* dk, void* dv, int B,
                       int H, int Sq, int Skv, int D, const Strides& st, float scale,
                       int device, cudaStream_t stream) {
  auto kernel = attention_bwd_dkv_kernel<T, DMAX>;
  static uint64_t configured = 0;
  cudaError_t err = allow_smem(kernel, configured, device,
                               static_cast<int>(sizeof(float) * dkv_smem_floats(DMAX)));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Skv + kBKV - 1) / kBKV);
  kernel<<<grid, kThreads, sizeof(float) * dkv_smem_floats(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, Sq,
      Skv, D, st, scale);
  return cudaGetLastError();
}

Strides strides_from(const int64_t* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]};
}

bool bad_shape(int B, int H, int Sq, int Skv, int D) {
  return D <= 0 || D > 256 || D % 8 != 0 || B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0;
}

template <typename T>
cudaError_t dispatch_dq(const void* q, const void* k, const void* v, const void* g, void* dq,
                        float* lse, float* delta, int B, int H, int Sq, int Skv, int D,
                        const Strides& st, float scale, int device, cudaStream_t s) {
  if (D <= 64)
    return launch_dq<T, 64>(q, k, v, g, dq, lse, delta, B, H, Sq, Skv, D, st, scale, device, s);
  if (D <= 128)
    return launch_dq<T, 128>(q, k, v, g, dq, lse, delta, B, H, Sq, Skv, D, st, scale, device, s);
  return launch_dq<T, 256>(q, k, v, g, dq, lse, delta, B, H, Sq, Skv, D, st, scale, device, s);
}

template <typename T>
cudaError_t dispatch_dkv(const void* q, const void* k, const void* v, const void* g,
                         const float* lse, const float* delta, void* dk, void* dv, int B,
                         int H, int Sq, int Skv, int D, const Strides& st, float scale,
                         int device, cudaStream_t s) {
  if (D <= 64)
    return launch_dkv<T, 64>(q, k, v, g, lse, delta, dk, dv, B, H, Sq, Skv, D, st, scale,
                             device, s);
  if (D <= 128)
    return launch_dkv<T, 128>(q, k, v, g, lse, delta, dk, dv, B, H, Sq, Skv, D, st, scale,
                              device, s);
  return launch_dkv<T, 256>(q, k, v, g, lse, delta, dk, dv, B, H, Sq, Skv, D, st, scale,
                            device, s);
}

}  // namespace

extern "C" {

const char* gadm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, g (= dO): (B, Sq, H, D); k, v: (B, Skv, H, D); unit stride on D; strides
// in elements, in the order q (b, s, h), k (b, s, h), v (b, s, h), g (b, s, h).
// dq: contiguous (B, Sq, H, D); lse, delta: contiguous (B, H, Sq) f32.
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
int gadm_attention_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                          void* dq, float* lse, float* delta, int dtype, int B, int H,
                          int Sq, int Skv, int D, const int64_t* strides, float scale,
                          int device, void* stream) {
  if (bad_shape(B, H, Sq, Skv, D)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Strides st = strides_from(strides);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dq<float>(q, k, v, g, dq, lse, delta, B, H, Sq, Skv, D, st, scale,
                              device, s);
  if (dtype == 1)
    return dispatch_dq<__nv_bfloat16>(q, k, v, g, dq, lse, delta, B, H, Sq, Skv, D, st,
                                      scale, device, s);
  return cudaErrorInvalidValue;
}

// As above, with lse and delta from gadm_attention_bwd_dq. dk, dv: contiguous
// (B, Skv, H, D).
int gadm_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                           const float* lse, const float* delta, void* dk, void* dv,
                           int dtype, int B, int H, int Sq, int Skv, int D,
                           const int64_t* strides, float scale, int device, void* stream) {
  if (bad_shape(B, H, Sq, Skv, D)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Strides st = strides_from(strides);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dkv<float>(q, k, v, g, lse, delta, dk, dv, B, H, Sq, Skv, D, st, scale,
                               device, s);
  if (dtype == 1)
    return dispatch_dkv<__nv_bfloat16>(q, k, v, g, lse, delta, dk, dv, B, H, Sq, Skv, D, st,
                                       scale, device, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
