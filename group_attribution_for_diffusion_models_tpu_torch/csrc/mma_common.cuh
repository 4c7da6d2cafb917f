// Pieces shared by the attention kernels (attention.cu, attention_bwd.cu) and
// the JL projection (jl_projection.cu), for Hopper (sm_90a): asynchronous
// tile fills on mbarriers (TMA bulk copies or cp.async), ldmatrix, mma.sync
// in bf16 (m16n8k16) and TF32 (m16n8k8, with the 3-term split of f32), and the
// attention kernels' score block. Every kernel that includes it runs blocks
// of kThreads threads. ops/_build.py hashes this header into the library
// name of every source that includes it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 64;      // rows an attention block owns: queries (forward, dQ pass) or keys

// Rows of a streamed tile (K/V in the forward and the dQ pass, Q/dO in the dK/dV pass), by
// input type and head-dim bucket: as many as keep one block per SM at D = 256
// and two at D <= 128.
template <typename T, int DMAX>
constexpr int kTile = (sizeof(T) == 4 ? 16 : 32) * (DMAX == 64 ? 2 : 1);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Tiles reach shared memory asynchronously and complete on an mbarrier per
// buffer (every thread arrives once per fill), so the next tile loads while
// this one is used. Rows of at least kBulkRowBytes go by bulk copies (the TMA
// engine, one request a row, issued by warp 0); shorter rows, where a request
// a row costs more than the row, by 16-byte cp.async from every thread, each
// thread's arrival deferred until its copies land. A fill is the work of the
// whole block, or of a group of `n` threads (a multiple of 32, thread `tid` of
// the group) on a barrier initialised for n arrivals.
constexpr int kBulkRowBytes = 1024;

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count = kThreads) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Start a fill of `bytes` on bar: with bulk copies, thread 0 arrives first and
// announces the bytes the copies will complete.
__device__ __forceinline__ void fill_begin(uint64_t* bar, bool bulk, int bytes, int tid) {
  if (bulk && tid == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
  __syncwarp();
}

__device__ __forceinline__ void fill_begin(uint64_t* bar, bool bulk, int bytes) {
  fill_begin(bar, bulk, bytes, threadIdx.x);
}

// End a fill: every other thread's arrival (after its cp.async copies land).
__device__ __forceinline__ void fill_end(uint64_t* bar, bool bulk, int tid) {
  if (!bulk)
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
                 : "memory");
  else if (tid != 0)
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void fill_end(uint64_t* bar, bool bulk) {
  fill_end(bar, bulk, threadIdx.x);
}

// Rows [0, valid) of dst (row stride ld) from src, rows [valid, rows) zeros,
// between fill_begin and fill_end on bar.
template <typename T>
__device__ __forceinline__ void fill_rows(T* dst, int ld, const T* src, int64_t row_stride,
                                          int rows, int valid, int D, bool bulk, uint64_t* bar,
                                          int tid, int n) {
  const int row_bytes = D * static_cast<int>(sizeof(T));
  const int per_row = row_bytes / 16;  // 16-byte pieces, 1 .. 64
  if (bulk) {
    if (tid < 32)
      for (int r = tid; r < valid; r += 32)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];\n" ::"r"(smem_addr(dst + r * ld)),
            "l"(src + r * row_stride), "r"(row_bytes), "r"(smem_addr(bar))
            : "memory");
    if (valid < rows) {
      for (int i = tid; i < (rows - valid) * per_row; i += n) {
        const int r = valid + i / per_row;
        reinterpret_cast<uint4*>(dst + r * ld)[i % per_row] = make_uint4(0, 0, 0, 0);
      }
      // order these stores before later bulk copies into the same rows
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    return;
  }
  // A warp copies `span` rows at a time, a lane one piece of a row (or every
  // 32nd piece of a long row); src-size 0 writes zeros.
  constexpr int kV = 16 / sizeof(T);
  const int warp = tid >> 5, lane = tid & 31;
  const int span = per_row >= 32 ? 1 : 32 / per_row;
  const int sub = per_row >= 32 ? 0 : lane / per_row;
  const int c0 = per_row >= 32 ? lane : lane - sub * per_row;
  if (sub >= span) return;
  for (int r = warp * span + sub; r < rows; r += (n / 32) * span) {
    const bool in = r < valid;
    for (int c = c0 * kV; c < D; c += 32 * kV)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_addr(dst + r * ld + c)),
                   "l"(in ? src + r * row_stride + c : src), "r"(in ? 16 : 0)
                   : "memory");
  }
}

template <typename T>
__device__ __forceinline__ void fill_rows(T* dst, int ld, const T* src, int64_t row_stride,
                                          int rows, int valid, int D, bool bulk, uint64_t* bar) {
  fill_rows(dst, ld, src, row_stride, rows, valid, D, bulk, bar, threadIdx.x, kThreads);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// The MMA of each input type. A fragments cover 16 rows x kK (depth), B
// fragments kK x 8 columns; lane = 4 g + t. A thread's accumulator c[0..3]
// holds rows g, g, g+8, g+8 and columns 2t, 2t+1, 2t, 2t+1 of a 16 x 8 tile.
// Pointers passed to the loads point at the fragment's first element of a
// row-major shared tile with row stride ld.
template <typename T>
struct Mma;

template <>
struct Mma<float> {  // TF32 m16n8k8, 3-term split
  static constexpr int kK = 8;      // depth of one mma
  static constexpr int kA = 4;      // A-fragment elements a thread holds
  static constexpr int kSPad = 4;   // row padding of an f32 score tile
  static constexpr int kTerms = 2;  // score-stage accumulators per tile
  // Row padding of an operand tile of depth D: a row stride of 8 or 24 words
  // mod 32 keeps the 8-byte loads of load_a/load_b_nk and the 4-byte loads of
  // load_b_kn on distinct banks.
  __host__ __device__ static constexpr int row_pad(int D) { return D % 16 == 0 ? 8 : 0; }
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };
  using AX = A;  // A at f32 accuracy
  // Row (0 or 8) and column of A-fragment element e for a lane with t = lane % 4.
  __device__ static constexpr int arow(int e) { return (e & 1) << 3; }
  __device__ static constexpr int acol(int e, int t) { return t + ((e >> 1) << 2); }
  // x_hi = rna_tf32(x), x_lo = rna_tf32(x - x_hi); for finite x, rounding to
  // nearest with ties away from zero is adding half of the 13 dropped bits to
  // the magnitude and clearing them (two integer ops, where cvt.rna.tf32.f32
  // costs several).
  __device__ static uint32_t rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }
  __device__ static void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = rna(x);
    lo = rna(x - __uint_as_float(hi));
  }
  __device__ static void make_a(A& a, const float (&v)[kA]) {
#pragma unroll
    for (int e = 0; e < kA; ++e) split(v[e], a.hi[e], a.lo[e]);
  }
  __device__ static void make_ax(AX& a, const float (&v)[kA]) { make_a(a, v); }
  // load_a and load_b_nk, the score stage's pair, give the mma's depth slots
  // t and t + 4 the depths 2t and 2t + 1 (the same order on both sides), so
  // each lane reads 8 bytes a row.
  // Each load takes X + its lane offset (a_lane, b_nk_lane, b_kn_lane).
  __device__ static int a_lane(int lane, int ld) { return (lane >> 2) * ld + 2 * (lane & 3); }
  __device__ static int b_nk_lane(int lane, int ld) { return a_lane(lane, ld); }
  __device__ static int b_kn_lane(int lane, int ld) { return (lane & 3) * ld + (lane >> 2); }
  __device__ static void load_a(A& a, const float* X, int ld) {
    const float2 u = *reinterpret_cast<const float2*>(X);
    const float2 w = *reinterpret_cast<const float2*>(X + 8 * ld);
    split(u.x, a.hi[0], a.lo[0]);
    split(w.x, a.hi[1], a.lo[1]);
    split(u.y, a.hi[2], a.lo[2]);
    split(w.y, a.hi[3], a.lo[3]);
  }
  // B[k][n] = X[n * ld + k]
  __device__ static void load_b_nk(B& b, const float* X, int) {
    const float2 u = *reinterpret_cast<const float2*>(X);
    split(u.x, b.hi[0], b.lo[0]);
    split(u.y, b.hi[1], b.lo[1]);
  }
  // B[k][n] = X[k * ld + n]
  __device__ static void load_b_kn(B& b, const float* X, int ld) {
    split(X[0], b.hi[0], b.lo[0]);
    split(X[4 * ld], b.hi[1], b.lo[1]);
  }
  __device__ static void mma(float (&c)[4], const A& a, const B& b) {
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.hi, b.lo);
    mma_tf32(c, a.hi, b.hi);
  }
  __device__ static void mma_ax(float (&c)[4], const AX& a, const B& b) { mma(c, a, b); }
  // The large product and the two small ones into two accumulators (two
  // mma chains), and their sum.
  __device__ static void mma_terms(float (&c)[kTerms][4], const A& a, const B& b) {
    mma_tf32(c[1], a.lo, b.hi);
    mma_tf32(c[0], a.hi, b.hi);
    mma_tf32(c[1], a.hi, b.lo);
  }
  __device__ static float sum_terms(const float (&c)[kTerms][4], int e) {
    return c[0][e] + c[1][e];
  }
};

template <>
struct Mma<__nv_bfloat16> {  // bf16 m16n8k16
  static constexpr int kK = 16;
  static constexpr int kA = 8;
  static constexpr int kSPad = 8;
  static constexpr int kTerms = 1;
  // An odd number of 16-byte pieces a row: ldmatrix's 8 rows on distinct banks.
  __host__ __device__ static constexpr int row_pad(int) { return 8; }
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t r[2];
  };
  struct AX {
    A hi, lo;
  };
  __device__ static constexpr int arow(int e) { return (e & 2) << 2; }
  __device__ static constexpr int acol(int e, int t) { return 2 * t + (e & 1) + ((e & 4) << 1); }
  __device__ static void make_a(A& a, const float (&v)[kA]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a.r[i] = pack_bf16(v[2 * i], v[2 * i + 1]);
  }
  __device__ static void make_ax(AX& a, const float (&v)[kA]) {
    float lo[kA];
#pragma unroll
    for (int e = 0; e < kA; ++e) lo[e] = v[e] - __bfloat162float(__float2bfloat16(v[e]));
    make_a(a.hi, v);
    make_a(a.lo, lo);
  }
  __device__ static int a_lane(int lane, int ld) { return (lane & 15) * ld + ((lane >> 4) << 3); }
  __device__ static int b_nk_lane(int lane, int ld) {
    return (lane & 7) * ld + (((lane >> 3) & 1) << 3);
  }
  __device__ static int b_kn_lane(int lane, int ld) { return (lane & 15) * ld; }
  __device__ static void load_a(A& a, const __nv_bfloat16* X, int) { ldsm_x4(a.r, X); }
  __device__ static void load_b_nk(B& b, const __nv_bfloat16* X, int) { ldsm_x2(b.r, X); }
  __device__ static void load_b_kn(B& b, const __nv_bfloat16* X, int) { ldsm_x2_trans(b.r, X); }
  __device__ static void mma(float (&c)[4], const A& a, const B& b) { mma_bf16(c, a.r, b.r); }
  __device__ static void mma_ax(float (&c)[4], const AX& a, const B& b) {
    mma_bf16(c, a.lo.r, b.r);
    mma_bf16(c, a.hi.r, b.r);
  }
  __device__ static void mma_terms(float (&c)[kTerms][4], const A& a, const B& b) {
    mma_bf16(c[0], a.r, b.r);
  }
  __device__ static float sum_terms(const float (&c)[kTerms][4], int e) { return c[0][e]; }
};

// Shared-memory geometry of the attention kernels for head dim D.
template <typename T, int DMAX>
struct Layout {
  static constexpr int kBK = kTile<T, DMAX>;
  static constexpr int kLdS = kBK + Mma<T>::kSPad;  // row stride of an f32 score tile
  __host__ __device__ static int depth(int D) {     // D rounded up to the mma depth
    return (D + Mma<T>::kK - 1) / Mma<T>::kK * Mma<T>::kK;
  }
  __host__ __device__ static int ld(int D) { return depth(D) + Mma<T>::row_pad(depth(D)); }
  // Both backward passes: 64 block rows x 2 operands, 2 buffers x 2 operands of
  // kBK rows, two 64 x kLdS score tiles, 4 x 64 floats of row or column
  // statistics, 2 mbarriers.
  __host__ __device__ static int bytes(int D) {
    return (2 * kRows + 4 * kBK) * ld(D) * static_cast<int>(sizeof(T)) +
           (2 * kRows * kLdS + 4 * kRows) * static_cast<int>(sizeof(float)) + 16;
  }
};

// Zero the pad columns [D, depth(D)) of the first `rows` rows (bf16 with D % 16 != 0).
template <typename T>
__device__ __forceinline__ void zero_pad(T* tiles, int ld, int rows, int D, int Dp) {
  const int pad = Dp - D;
  if (pad == 0) return;
  for (int i = threadIdx.x; i < rows * pad; i += kThreads) {
    const int r = i / pad;
    tiles[r * ld + D + (i - r * pad)] = T(0.f);
  }
}

// A fragments of rows [m0, m0 + 16) of a row-major tile (row stride ld) with
// every element split as it loads (f32) or read by ldmatrix (bf16): load(a, k)
// takes depth k.
template <typename T>
struct TileA {
  const T* p;  // the tile's row m0, plus the lane offset
  int ld;
  __device__ TileA(const T* rows, int ld_, int lane) : p(rows + Mma<T>::a_lane(lane, ld_)), ld(ld_) {}
  __device__ void load(typename Mma<T>::A& a, int k) const { Mma<T>::load_a(a, p + k, ld); }
};

// A warp's 16 x kBK score block over depth steps [ks0, ks1): out[j] is the 16 x 8
// tile j; A fragments from `src` (TileA or a source of pre-split fragments),
// B = the streamed tile read as B[k][n] = Bt[n][k] by the MMA policy M.
// Fragments are double-buffered in registers (the next step's loads are issued
// before this step's products), and each tile, product term and (with few
// tiles) step parity has its own accumulator; they are summed in a fixed order.
template <typename T, int NJ, typename Src, typename M = Mma<T>>
__device__ __forceinline__ void score_block(float (&out)[NJ][4], const Src& src, const T* Bt,
                                            int ld, int ks0, int ks1, int lane) {
  constexpr int P = NJ * M::kTerms >= 8 ? 1 : 2;
  float c[P][NJ][M::kTerms][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < M::kTerms; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[p][j][i][e] = 0.f;
  const int n = ks1 - ks0;
  if (n > 0) {
    const int ka = ks0 * M::kK;
    const T* pb = Bt + M::b_nk_lane(lane, ld) + ks0 * M::kK;
    typename M::A a0, a1;
    typename M::B b0[NJ], b1[NJ];
    src.load(a0, ka);
#pragma unroll
    for (int j = 0; j < NJ; ++j) M::load_b_nk(b0[j], pb + j * 8 * ld, ld);
    for (int i = 0; i < n; i += 2) {
      const int o1 = min(i + 1, n - 1) * M::kK;
      const int o2 = min(i + 2, n - 1) * M::kK;
      src.load(a1, ka + o1);
#pragma unroll
      for (int j = 0; j < NJ; ++j) M::load_b_nk(b1[j], pb + j * 8 * ld + o1, ld);
#pragma unroll
      for (int j = 0; j < NJ; ++j) M::mma_terms(c[0][j], a0, b0[j]);
      src.load(a0, ka + o2);
#pragma unroll
      for (int j = 0; j < NJ; ++j) M::load_b_nk(b0[j], pb + j * 8 * ld + o2, ld);
      if (i + 1 < n) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) M::mma_terms(c[P - 1][j], a1, b1[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[j][e] = P == 1 ? M::sum_terms(c[0][j], e)
                         : M::sum_terms(c[0][j], e) + M::sum_terms(c[P - 1][j], e);
}

// Write a warp's 16 x (8 NJ) score block to rows [m0, m0 + 16) of an f32 tile.
template <int NJ>
__device__ __forceinline__ void store_scores(float* S, int ldS, int m0, const float (&s)[NJ][4],
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    *reinterpret_cast<float2*>(&S[(m0 + g) * ldS + 8 * j + 2 * t]) = make_float2(s[j][0], s[j][1]);
    *reinterpret_cast<float2*>(&S[(m0 + g + 8) * ldS + 8 * j + 2 * t]) =
        make_float2(s[j][2], s[j][3]);
  }
}

struct Strides {
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, g_sh;
};

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

// (b, s, h) strides of n = 3 (q, k, v) or 4 (and dO) tensors.
Strides strides_from(const int64_t* s, int n = 4) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
                 n > 3 ? s[9] : 0, n > 3 ? s[10] : 0, n > 3 ? s[11] : 0};
}

bool bad_shape(int B, int H, int Sq, int Skv, int D) {
  return D <= 0 || D > 256 || D % 8 != 0 || B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0;
}

// cp.async moves 16 bytes: every base pointer and (b, s, h) stride must keep
// rows 16-byte aligned (a stride over a dimension of size 1 is never used).
// Tensors in the order q, k, v (, dO): q and dO have Sq rows, k and v Skv.
bool misaligned(const void* const* ptrs, int n, const int64_t* strides, int elem, int B, int H,
                int Sq, int Skv) {
  for (int i = 0; i < n; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return true;
    const int sizes[3] = {B, i == 0 || i == 3 ? Sq : Skv, H};
    for (int d = 0; d < 3; ++d)
      if (sizes[d] > 1 && (strides[3 * i + d] * elem) % 16 != 0) return true;
  }
  return false;
}

}  // namespace
