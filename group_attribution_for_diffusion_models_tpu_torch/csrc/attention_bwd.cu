// Attention backward for Hopper (sm_90a) on the tensor cores: the dQ pass and
// the dK/dV pass.
//
// Replaces the TPU kernels ops/attention.py::_flash_bwd_dq_kernel and
// ::_hp_bwd_dq_kernel (the dQ pass) and ::_flash_bwd_dkv_kernel and
// ::_hp_bwd_dkv_kernel (the dK/dV pass) of the JAX package, in both of their
// layouts: each pass is one kernel that reads q/k/v/dO through their strides
// straight from (B, S, H, D). The scheme is the TPU kernels' (FlashAttention-2):
// the residuals are (q, k, v), no (Sq, Skv) matrix reaches device memory, and
//
//   dQ pass, per (b, h, 64-query block), over key tiles twice:
//     1. S = Q K^T, online softmax, O = P V: lse = m + log(sum p), then
//        delta = rowsum(dO * O);
//     2. S and dP = dO V^T again, dS = P (dP - delta), dQ += dS K.
//     Writes dQ, lse and delta ((B, H, Sq) f32).
//   dK/dV pass, per (b, h, 64-key block), over query tiles:
//     S^T = K Q^T, dP^T = V dO^T, P^T = exp(S^T - lse), dS^T = P^T (dP^T - delta),
//     dV += P^T dO, dK += dS^T Q.
//
// Work: the function needs 10 units of B*H*Sq*Skv*D FLOPs (S, P.V, dO.V^T,
// dS.K, dS^T.Q, P^T.dO, two FLOPs each); this scheme forms 18 (the dQ pass
// 5 products, S and P.V of the forward again; the dK/dV pass 4), as the
// residuals stay (q, k, v). Every product runs on the tensor cores with
// mma.sync and f32 accumulators:
//
//   bf16 inputs: m16n8k16 in bf16. P and dS are rounded to bf16 before their
//     second product (dV += P^T dO, dK += dS^T Q, dQ += dS K), as the TPU
//     kernels do. O = P V of the dQ pass's first half takes P as two bf16
//     terms (P = hi + lo), so that delta keeps f32 accuracy: 19 units of
//     MMA work.
//   f32 inputs: m16n8k8 in TF32 with the 3-term split of every operand, P and
//     dS included: x_hi = rna_tf32(x), x_lo = rna_tf32(x - x_hi), and
//     a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (CUTLASS's OpMultiplyAddFastF32).
//     One TF32 term keeps 10 mantissa bits and misses the f32 tolerance;
//     three keep about 21 (tests/test_torch_attention_split.py emulates both).
//     54 units of TF32 work.
//
// What bounds it on the H100 (989 TFLOP/s bf16 and 495 TF32 on the tensor
// cores, 3.35 TB/s): at the CIFAR shape (B=64, S=256, H=1, D=256) the least
// work, 10 units = 10.7 GFLOP, takes 0.0651 ms at 495/3 TFLOP/s in f32 and
// 0.0109 ms at 989 in bf16; the bytes (q, k, v, dO read, dq, dk, dv written,
// 117 MB in f32) take 0.0350 ms in f32 and 0.0175 ms in bf16. So f32 is bound
// by operations and bf16 by bytes; chip_smoke.py states both bounds and the
// measured times (PERF.md).
//
// Design. 8 warps; a block owns 64 rows (queries, or keys) and streams tiles
// of the other side: 16 rows in f32 and 32 in bf16 (twice that at D <= 64).
// Tiles are double-buffered: each buffer's fill completes on an mbarrier, and
// the next tile loads while the products run on this one. Rows of 1 KB or
// more (f32 at D = 256) go by bulk copies (TMA, one request a row, from warp
// 0), shorter rows by 16-byte cp.async from every thread (past Sq or Skv,
// zeros). Operands stay at their stored width in shared memory, rows padded
// so the fragment loads hit distinct banks: f32 rows of D or D + 8 floats (a
// stride of 8 or 24 words mod 32; the score stage's loads take 8 bytes, as
// the mma's depth slots t and t + 4 take depths 2t and 2t + 1 on both sides),
// bf16 rows of D rounded up to 16 (zeros in the pad) + 8, read by ldmatrix.
// Each step has two stages between barriers:
//   score stage: warp (r, h), r = warp % 4, h = warp / 4, forms a 16-row by
//     tile-wide score block over the whole depth D: h = 0 S, h = 1 dP (in the
//     dQ pass's first half, h splits the depth of S in two and the halves are
//     summed in a fixed order). Fragments are double-buffered in registers.
//     Scores go to shared memory in f32.
//   accumulate stage: warp (r, h) reads its 16 rows of scores, forms P and dS
//     in registers as the A fragment, and accumulates its half of the D
//     columns: O or dQ (16 x D/2), or dK and dV (2 x 16 x D/2), in registers,
//     loading 4 or 8 B fragments ahead of their products.
// Shared memory at D = 256: 214,032 bytes in f32 (Q, dO, 2 x K/V tiles of 16
// rows, two 64 x 20 score tiles, statistics, 2 mbarriers), 156,688 in bf16
// (tiles of 32 rows): one block per SM, so the CIFAR shape's 256 blocks per
// pass run in 1.94 waves on 132 SMs. At D <= 128 two blocks share an SM.
// Every output element has one owner thread and every sum runs in a fixed
// order: no atomics, and two runs give bit-identical gradients. Keys >= Skv
// get P = 0; query rows >= Sq read zeros, get P = 0 in the dK/dV pass and are
// not stored.
//
// nvcc -Xptxas -v (sm_90a, CUDA 12.8), registers a thread (spill bytes):
// dQ f32 197 / 128 / 123 at D <= 256 / 128 / 64, bf16 195 / 128 / 121; dK/dV
// f32 234 / 128 (120 stored, 144 loaded) / 118, bf16 242 / 128 / 123; no
// other spills, 1 barrier each. cuobjdump: HMMA.1688.F32.TF32 and
// HMMA.16816.F32.BF16 carry every product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 64;      // rows a block owns: queries (dQ pass) or keys (dK/dV pass)

// Rows of a streamed tile (K/V in the dQ pass, Q/dO in the dK/dV pass), by
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
// thread's arrival deferred until its copies land.
constexpr int kBulkRowBytes = 1024;

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(kThreads));
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
__device__ __forceinline__ void fill_begin(uint64_t* bar, bool bulk, int bytes) {
  if (bulk && threadIdx.x == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
  __syncwarp();
}

// End a fill: every other thread's arrival (after its cp.async copies land).
__device__ __forceinline__ void fill_end(uint64_t* bar, bool bulk) {
  if (!bulk)
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
                 : "memory");
  else if (threadIdx.x != 0)
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Rows [0, valid) of dst (row stride ld) from src, rows [valid, rows) zeros,
// between fill_begin and fill_end on bar.
template <typename T>
__device__ __forceinline__ void fill_rows(T* dst, int ld, const T* src, int64_t row_stride,
                                          int rows, int valid, int D, bool bulk, uint64_t* bar) {
  const int row_bytes = D * static_cast<int>(sizeof(T));
  const int per_row = row_bytes / 16;  // 16-byte pieces, 1 .. 64
  if (bulk) {
    if (threadIdx.x < 32)
      for (int r = threadIdx.x; r < valid; r += 32)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];\n" ::"r"(smem_addr(dst + r * ld)),
            "l"(src + r * row_stride), "r"(row_bytes), "r"(smem_addr(bar))
            : "memory");
    if (valid < rows) {
      for (int i = threadIdx.x; i < (rows - valid) * per_row; i += kThreads) {
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
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int span = per_row >= 32 ? 1 : 32 / per_row;
  const int sub = per_row >= 32 ? 0 : lane / per_row;
  const int c0 = per_row >= 32 ? lane : lane - sub * per_row;
  if (sub >= span) return;
  for (int r = warp * span + sub; r < rows; r += (kThreads / 32) * span) {
    const bool in = r < valid;
    for (int c = c0 * kV; c < D; c += 32 * kV)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_addr(dst + r * ld + c)),
                   "l"(in ? src + r * row_stride + c : src), "r"(in ? 16 : 0)
                   : "memory");
  }
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

// Shared-memory geometry of both passes for head dim D.
template <typename T, int DMAX>
struct Layout {
  static constexpr int kBK = kTile<T, DMAX>;
  static constexpr int kLdS = kBK + Mma<T>::kSPad;  // row stride of an f32 score tile
  __host__ __device__ static int depth(int D) {     // D rounded up to the mma depth
    return (D + Mma<T>::kK - 1) / Mma<T>::kK * Mma<T>::kK;
  }
  __host__ __device__ static int ld(int D) { return depth(D) + Mma<T>::row_pad(depth(D)); }
  // 64 block rows x 2 operands, 2 buffers x 2 operands of kBK rows, two 64 x
  // kLdS score tiles, 4 x 64 floats of row or column statistics, 2 mbarriers.
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

// A warp's 16 x kBK score block over depth steps [ks0, ks1): out[j] is the 16 x 8
// tile j; A rows from A (row-major), B = the streamed tile read as B[k][n] = Bt[n][k].
// Fragments are double-buffered in registers (the next step's loads are issued
// before this step's products), and each tile, product term and (with few
// tiles) step parity has its own accumulator; they are summed in a fixed order.
template <typename T, int NJ>
__device__ __forceinline__ void score_block(float (&out)[NJ][4], const T* A, const T* Bt,
                                            int ld, int ks0, int ks1, int lane) {
  using M = Mma<T>;
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
    const T* pa = A + M::a_lane(lane, ld) + ks0 * M::kK;
    const T* pb = Bt + M::b_nk_lane(lane, ld) + ks0 * M::kK;
    typename M::A a0, a1;
    typename M::B b0[NJ], b1[NJ];
    M::load_a(a0, pa, ld);
#pragma unroll
    for (int j = 0; j < NJ; ++j) M::load_b_nk(b0[j], pb + j * 8 * ld, ld);
    for (int i = 0; i < n; i += 2) {
      const int o1 = min(i + 1, n - 1) * M::kK;
      const int o2 = min(i + 2, n - 1) * M::kK;
      M::load_a(a1, pa + o1, ld);
#pragma unroll
      for (int j = 0; j < NJ; ++j) M::load_b_nk(b1[j], pb + j * 8 * ld + o1, ld);
#pragma unroll
      for (int j = 0; j < NJ; ++j) M::mma_terms(c[0][j], a0, b0[j]);
      M::load_a(a0, pa + o2, ld);
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

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, DMAX == 256 ? 1 : 2)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        T* __restrict__ dq, float* __restrict__ lse_out,
                        float* __restrict__ delta_out, int H, int Sq, int Skv, int D,
                        Strides st, float scale) {
  using M = Mma<T>;
  using L = Layout<T, DMAX>;
  constexpr int BK = L::kBK;
  constexpr int LDS = L::kLdS;
  constexpr int NJ = BK / 8;       // 8-column tiles of a score block
  constexpr int KS = BK / M::kK;   // mma depth steps over a streamed tile
  constexpr int NT = DMAX / 16;    // 8-column tiles of half of D, at most
  constexpr int G = NT < 8 ? NT : 8;  // B fragments loaded ahead of their products
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = L::depth(D);
  const int ld = L::ld(D);
  T* Qs = reinterpret_cast<T*>(smem);  // kRows x ld
  T* Gs = Qs + kRows * ld;             // kRows x ld, dO
  T* Ks = Gs + kRows * ld;             // 2 buffers of BK x ld
  T* Vs = Ks + 2 * BK * ld;            // 2 buffers of BK x ld
  float* S0 = reinterpret_cast<float*>(Vs + 2 * BK * ld);  // kRows x LDS: S (part)
  float* S1 = S0 + kRows * LDS;                             // kRows x LDS: dP or S (part)
  float* dpart = S1 + kRows * LDS;                          // 2 x kRows: delta halves
  uint64_t* bars = reinterpret_cast<uint64_t*>(dpart + 4 * kRows);  // one per buffer

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int q0 = blockIdx.y * kRows;
  const int q_valid = min(kRows, Sq - q0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lr = lane >> 2;          // fragment row
  const int lc = lane & 3;           // fragment column pair
  const int m0 = (warp & 3) * 16;    // this warp's 16 rows
  const int half = warp >> 2;        // score: S or dP; accumulate: which half of D
  const int r0 = m0 + lr;            // a thread's rows r0 and r0 + 8
  const int nks = Dp / M::kK;
  const int ntiles = D / 8;
  const int nt_first = (ntiles + 1) / 2;
  const int nt_begin = half ? nt_first : 0;
  const int nt_count = half ? ntiles - nt_first : nt_first;
  // Column of this half's tile j; tiles past the half's count load a valid
  // column and skip their products.
  auto col_of = [&](int j) { return min(nt_begin + j, ntiles - 1) * 8; };
  const int nkt = (Skv + BK - 1) / BK;

  const T* kb = k + b * st.k_sb + h * st.k_sh;
  const T* vb = v + b * st.v_sb + h * st.v_sh;
  const int row_bytes = D * static_cast<int>(sizeof(T));
  const bool bulk = row_bytes >= kBulkRowBytes;
  // K and V rows of a tile into buffer buf (fill_begin before, fill_end after).
  auto load_kv = [&](int tile, int buf) {
    const int k0 = tile * BK;
    const int valid = min(BK, Skv - k0);
    fill_rows(Ks + buf * BK * ld, ld, kb + k0 * st.k_ss, st.k_ss, BK, valid, D, bulk, &bars[buf]);
    fill_rows(Vs + buf * BK * ld, ld, vb + k0 * st.v_ss, st.v_ss, BK, valid, D, bulk, &bars[buf]);
  };
  auto kv_bytes = [&](int tile) { return 2 * min(BK, Skv - tile * BK) * row_bytes; };

  if (threadIdx.x == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
  }
  zero_pad(Qs, ld, 2 * kRows + 4 * BK, D, Dp);
  __syncthreads();
  fill_begin(&bars[0], bulk, kv_bytes(0) + 2 * q_valid * row_bytes);
  fill_rows(Qs, ld, q + b * st.q_sb + h * st.q_sh + q0 * st.q_ss, st.q_ss, kRows, q_valid, D,
            bulk, &bars[0]);
  fill_rows(Gs, ld, g + b * st.g_sb + h * st.g_sh + q0 * st.g_ss, st.g_ss, kRows, q_valid, D,
            bulk, &bars[0]);
  load_kv(0, 0);
  fill_end(&bars[0], bulk);

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};

  // Steps 0 .. nkt-1: the forward (first half); nkt .. 2 nkt-1: dS and dQ.
  for (int step = 0; step < 2 * nkt; ++step) {
    const bool first = step < nkt;
    const int tile = first ? step : step - nkt;
    const int kv_valid = min(BK, Skv - tile * BK);
    const int buf = step & 1;
    mbar_wait(&bars[buf], (step >> 1) & 1);  // this step's tiles are in
    __syncthreads();                          // every warp is done with the last step
    if (step + 1 < 2 * nkt) {
      const int next = step + 1 < nkt ? step + 1 : step + 1 - nkt;
      fill_begin(&bars[buf ^ 1], bulk, kv_bytes(next));
      load_kv(next, buf ^ 1);
      fill_end(&bars[buf ^ 1], bulk);
    }
    if (step == nkt) {  // lse, delta, then dQ from zero
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + 8 * i;
        lse_r[i] = m_run[i] + logf(l_run[i]);
        delta_r[i] = dpart[row] + dpart[kRows + row];
        if (half == 0 && lc == 0 && row < q_valid) {
          const int64_t at = (static_cast<int64_t>(b) * H + h) * Sq + q0 + row;
          lse_out[at] = lse_r[i];
          delta_out[at] = delta_r[i];
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
    const T* Kt = Ks + buf * BK * ld;
    const T* Vt = Vs + buf * BK * ld;

    // Score stage. First half: S over half of the depth each (h = 0 the
    // first steps). Second half: h = 0 S, h = 1 dP, over all of it.
    {
      float s[NJ][4];
      if (first) {
        const int mid = (nks + 1) / 2;
        score_block<T, NJ>(s, Qs + m0 * ld, Kt, ld, half ? mid : 0, half ? nks : mid, lane);
      } else {
        score_block<T, NJ>(s, (half ? Gs : Qs) + m0 * ld, half ? Vt : Kt, ld, 0, nks, lane);
      }
      store_scores<NJ>(half ? S1 : S0, LDS, m0, s, lane);
    }
    __syncthreads();

    // Accumulate stage: rows r0, r0 + 8; columns of tiles nt_begin .. + nt_count.
    if (first) {
      float sv[KS][M::kA];
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int e = 0; e < M::kA; ++e) {
          const int row = r0 + M::arow(e);
          const int col = ks * M::kK + M::acol(e, lc);
          const float x = col < kv_valid ? (S0[row * LDS + col] + S1[row * LDS + col]) * scale
                                         : -INFINITY;
          sv[ks][e] = x;
          mx[M::arow(e) >> 3] = fmaxf(mx[M::arow(e) >> 3], x);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_run[i], mx[i]);  // finite: a tile holds a valid key
        alpha[i] = expf(m_run[i] - m_new);            // 0 on the first tile
        m_run[i] = m_new;
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int e = 0; e < M::kA; ++e) {
          const int i = M::arow(e) >> 3;
          sv[ks][e] = expf(sv[ks][e] - m_run[i]);
          sum[i] += sv[ks][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        l_run[i] = l_run[i] * alpha[i] + sum[i];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }
      const T* pv = Vt + M::b_kn_lane(lane, ld);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        typename M::AX a;
        M::make_ax(a, sv[ks]);
#pragma unroll
        for (int j0 = 0; j0 < NT; j0 += G) {
          typename M::B bv[G];
#pragma unroll
          for (int j = 0; j < G; ++j)
            M::load_b_kn(bv[j], pv + ks * M::kK * ld + col_of(j0 + j), ld);
#pragma unroll
          for (int j = 0; j < G; ++j)
            if (j0 + j < nt_count) M::mma_ax(acc[j0 + j], a, bv[j]);
        }
      }
      if (step == nkt - 1) {  // delta = rowsum(dO * O), O = acc / l: this half's part
        float part[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j < nt_count) {
            const int col = (nt_begin + j) * 8 + 2 * lc;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const T* gr = Gs + (r0 + 8 * i) * ld + col;
              part[i] = fmaf(acc[j][2 * i] / l_run[i], to_f32(gr[0]), part[i]);
              part[i] = fmaf(acc[j][2 * i + 1] / l_run[i], to_f32(gr[1]), part[i]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          part[i] += __shfl_xor_sync(0xffffffffu, part[i], 1);
          part[i] += __shfl_xor_sync(0xffffffffu, part[i], 2);
          if (lc == 0) dpart[half * kRows + r0 + 8 * i] = part[i];
        }
      }
    } else {
      const T* pk = Kt + M::b_kn_lane(lane, ld);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        float ds[M::kA];
#pragma unroll
        for (int e = 0; e < M::kA; ++e) {
          const int i = M::arow(e) >> 3;
          const int row = r0 + M::arow(e);
          const int col = ks * M::kK + M::acol(e, lc);
          const float p = col < kv_valid ? expf(S0[row * LDS + col] * scale - lse_r[i]) : 0.f;
          ds[e] = p * (S1[row * LDS + col] - delta_r[i]);
        }
        typename M::A a;
        M::make_a(a, ds);
#pragma unroll
        for (int j0 = 0; j0 < NT; j0 += G) {
          typename M::B bk[G];
#pragma unroll
          for (int j = 0; j < G; ++j)
            M::load_b_kn(bk[j], pk + ks * M::kK * ld + col_of(j0 + j), ld);
#pragma unroll
          for (int j = 0; j < G; ++j)
            if (j0 + j < nt_count) M::mma(acc[j0 + j], a, bk[j]);
        }
      }
    }
  }

  // dq is a contiguous (B, Sq, H, D) tensor.
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt_count) {
      const int col = (nt_begin + j) * 8 + 2 * lc;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + 8 * i;
        if (row < q_valid)
          store2(dq + ((static_cast<int64_t>(b) * Sq + q0 + row) * H + h) * D + col,
                 acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
      }
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, DMAX == 256 ? 1 : 2)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int H, int Sq, int Skv,
                         int D, Strides st, float scale) {
  using M = Mma<T>;
  using L = Layout<T, DMAX>;
  constexpr int BQ = L::kBK;
  constexpr int LDS = L::kLdS;
  constexpr int NJ = BQ / 8;
  constexpr int KS = BQ / M::kK;
  constexpr int NT = DMAX / 16;
  constexpr int G = NT < 4 ? NT : 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = L::depth(D);
  const int ld = L::ld(D);
  T* Ks = reinterpret_cast<T*>(smem);  // kRows x ld
  T* Vs = Ks + kRows * ld;             // kRows x ld
  T* Qs = Vs + kRows * ld;             // 2 buffers of BQ x ld
  T* Gs = Qs + 2 * BQ * ld;            // 2 buffers of BQ x ld, dO
  float* S0 = reinterpret_cast<float*>(Gs + 2 * BQ * ld);  // kRows x LDS: S^T
  float* S1 = S0 + kRows * LDS;                             // kRows x LDS: dP^T
  float* stats = S1 + kRows * LDS;  // 2 buffers of BQ lse then BQ delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(stats + 4 * kRows);

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int k0 = blockIdx.y * kRows;
  const int kv_valid = min(kRows, Skv - k0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lr = lane >> 2;
  const int lc = lane & 3;
  const int m0 = (warp & 3) * 16;
  const int half = warp >> 2;
  const int r0 = m0 + lr;
  const int nks = Dp / M::kK;
  const int ntiles = D / 8;
  const int nt_first = (ntiles + 1) / 2;
  const int nt_begin = half ? nt_first : 0;
  const int nt_count = half ? ntiles - nt_first : nt_first;
  auto col_of = [&](int j) { return min(nt_begin + j, ntiles - 1) * 8; };
  const int nqt = (Sq + BQ - 1) / BQ;

  const T* qb = q + b * st.q_sb + h * st.q_sh;
  const T* gb = g + b * st.g_sb + h * st.g_sh;
  const float* lse_b = lse + (static_cast<int64_t>(b) * H + h) * Sq;
  const float* dl_b = delta + (static_cast<int64_t>(b) * H + h) * Sq;
  const int row_bytes = D * static_cast<int>(sizeof(T));
  const bool bulk = row_bytes >= kBulkRowBytes;
  // Q and dO rows of a tile into buffer buf (fill_begin before, fill_end after).
  auto load_q = [&](int tile, int buf) {
    const int q0 = tile * BQ;
    const int valid = min(BQ, Sq - q0);
    fill_rows(Qs + buf * BQ * ld, ld, qb + q0 * st.q_ss, st.q_ss, BQ, valid, D, bulk, &bars[buf]);
    fill_rows(Gs + buf * BQ * ld, ld, gb + q0 * st.g_ss, st.g_ss, BQ, valid, D, bulk, &bars[buf]);
  };
  auto q_bytes = [&](int tile) { return 2 * min(BQ, Sq - tile * BQ) * row_bytes; };
  // lse (threads < BQ) and delta (BQ .. 2 BQ - 1) of a tile, 0 past Sq: read
  // into a register a step ahead, stored after that step's products.
  auto read_stat = [&](int tile) {
    const int i = threadIdx.x & (BQ - 1), at = tile * BQ + i;
    return at < Sq ? (threadIdx.x < BQ ? lse_b : dl_b)[at] : 0.f;
  };

  if (threadIdx.x == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
  }
  zero_pad(Ks, ld, 2 * kRows + 4 * BQ, D, Dp);
  if (threadIdx.x < 2 * BQ) stats[threadIdx.x] = read_stat(0);
  __syncthreads();
  fill_begin(&bars[0], bulk, q_bytes(0) + 2 * kv_valid * row_bytes);
  fill_rows(Ks, ld, k + b * st.k_sb + h * st.k_sh + k0 * st.k_ss, st.k_ss, kRows, kv_valid, D,
            bulk, &bars[0]);
  fill_rows(Vs, ld, v + b * st.v_sb + h * st.v_sh + k0 * st.v_ss, st.v_ss, kRows, kv_valid, D,
            bulk, &bars[0]);
  load_q(0, 0);
  fill_end(&bars[0], bulk);

  float acc_k[NT][4], acc_v[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  for (int tile = 0; tile < nqt; ++tile) {
    const int buf = tile & 1;
    const int q_valid = min(BQ, Sq - tile * BQ);
    mbar_wait(&bars[buf], (tile >> 1) & 1);  // this tile is in
    __syncthreads();                          // every warp is done with the last one
    const bool next = tile + 1 < nqt;
    float stat_next = 0.f;
    if (next) {
      fill_begin(&bars[buf ^ 1], bulk, q_bytes(tile + 1));
      load_q(tile + 1, buf ^ 1);
      fill_end(&bars[buf ^ 1], bulk);
      if (threadIdx.x < 2 * BQ) stat_next = read_stat(tile + 1);
    }
    const T* Qt = Qs + buf * BQ * ld;
    const T* Gt = Gs + buf * BQ * ld;
    const float* lse_t = stats + buf * 2 * BQ;
    const float* dl_t = lse_t + BQ;

    // Score stage: h = 0 S^T = K Q^T, h = 1 dP^T = V dO^T.
    {
      float s[NJ][4];
      score_block<T, NJ>(s, (half ? Vs : Ks) + m0 * ld, half ? Gt : Qt, ld, 0, nks, lane);
      store_scores<NJ>(half ? S1 : S0, LDS, m0, s, lane);
    }
    __syncthreads();

    // Accumulate stage: key rows r0, r0 + 8; query columns of this tile.
    const T* pg = Gt + M::b_kn_lane(lane, ld);
    const T* pq = Qt + M::b_kn_lane(lane, ld);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      float pv[M::kA], ds[M::kA];
#pragma unroll
      for (int e = 0; e < M::kA; ++e) {
        const int row = r0 + M::arow(e);
        const int col = ks * M::kK + M::acol(e, lc);
        const float p = row < kv_valid && col < q_valid
                            ? expf(S0[row * LDS + col] * scale - lse_t[col])
                            : 0.f;
        pv[e] = p;
        ds[e] = p * (S1[row * LDS + col] - dl_t[col]);
      }
      typename M::A ap, ad;
      M::make_a(ap, pv);
      M::make_a(ad, ds);
#pragma unroll
      for (int j0 = 0; j0 < NT; j0 += G) {
        typename M::B bg[G], bq[G];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int off = ks * M::kK * ld + col_of(j0 + j);
          M::load_b_kn(bg[j], pg + off, ld);
          M::load_b_kn(bq[j], pq + off, ld);
        }
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (j0 + j < nt_count) {
            M::mma(acc_v[j0 + j], ap, bg[j]);
            M::mma(acc_k[j0 + j], ad, bq[j]);
          }
        }
      }
    }
    if (next && threadIdx.x < 2 * BQ) stats[(buf ^ 1) * 2 * BQ + threadIdx.x] = stat_next;
  }

  // dk, dv are contiguous (B, Skv, H, D) tensors.
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt_count) {
      const int col = (nt_begin + j) * 8 + 2 * lc;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + 8 * i;
        if (row < kv_valid) {
          const int64_t at = ((static_cast<int64_t>(b) * Skv + k0 + row) * H + h) * D + col;
          store2(dk + at, acc_k[j][2 * i] * scale, acc_k[j][2 * i + 1] * scale);
          store2(dv + at, acc_v[j][2 * i], acc_v[j][2 * i + 1]);
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
  cudaError_t err = allow_smem(kernel, configured, device, Layout<T, DMAX>::bytes(DMAX));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, Layout<T, DMAX>::bytes(D), stream>>>(
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
  cudaError_t err = allow_smem(kernel, configured, device, Layout<T, DMAX>::bytes(DMAX));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Skv + kRows - 1) / kRows);
  kernel<<<grid, kThreads, Layout<T, DMAX>::bytes(D), stream>>>(
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

// cp.async moves 16 bytes: every base pointer and (b, s, h) stride must keep
// rows 16-byte aligned (a stride over a dimension of size 1 is never used).
bool misaligned(const void* const* ptrs, const int64_t* strides, int elem, int B, int H,
                int Sq, int Skv) {
  for (int i = 0; i < 4; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return true;
    const int sizes[3] = {B, i == 0 || i == 3 ? Sq : Skv, H};
    for (int d = 0; d < 3; ++d)
      if (sizes[d] > 1 && (strides[3 * i + d] * elem) % 16 != 0) return true;
  }
  return false;
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
// in elements, in the order q (b, s, h), k (b, s, h), v (b, s, h), g (b, s, h);
// pointers and strides keep rows 16-byte aligned.
// dq: contiguous (B, Sq, H, D); lse, delta: contiguous (B, H, Sq) f32.
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
int gadm_attention_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                          void* dq, float* lse, float* delta, int dtype, int B, int H,
                          int Sq, int Skv, int D, const int64_t* strides, float scale,
                          int device, void* stream) {
  if (bad_shape(B, H, Sq, Skv, D) || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  const void* ptrs[] = {q, k, v, g};
  if (misaligned(ptrs, strides, dtype == 0 ? 4 : 2, B, H, Sq, Skv))
    return cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Strides st = strides_from(strides);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dq<float>(q, k, v, g, dq, lse, delta, B, H, Sq, Skv, D, st, scale,
                              device, s);
  return dispatch_dq<__nv_bfloat16>(q, k, v, g, dq, lse, delta, B, H, Sq, Skv, D, st, scale,
                                    device, s);
}

// As above, with lse and delta from gadm_attention_bwd_dq. dk, dv: contiguous
// (B, Skv, H, D).
int gadm_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                           const float* lse, const float* delta, void* dk, void* dv,
                           int dtype, int B, int H, int Sq, int Skv, int D,
                           const int64_t* strides, float scale, int device, void* stream) {
  if (bad_shape(B, H, Sq, Skv, D) || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  const void* ptrs[] = {q, k, v, g};
  if (misaligned(ptrs, strides, dtype == 0 ? 4 : 2, B, H, Sq, Skv))
    return cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Strides st = strides_from(strides);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dkv<float>(q, k, v, g, lse, delta, dk, dv, B, H, Sq, Skv, D, st, scale,
                               device, s);
  return dispatch_dkv<__nv_bfloat16>(q, k, v, g, lse, delta, dk, dv, B, H, Sq, Skv, D, st,
                                     scale, device, s);
}

}  // extern "C"
