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
// nvcc -Xptxas -v (sm_90a, CUDA 12.8; scripts/kernel_stats.sh), registers a
// thread (spill bytes): dQ f32 194 / 127 / 114 at D <= 256 / 128 / 64, bf16
// 193 / 128 / 121; dK/dV f32 232 / 128 (116 stored, 140 loaded) / 118, bf16
// 240 / 128 / 123; no other spills, 1 barrier each. cuobjdump: HMMA.1688.F32.TF32 and
// HMMA.16816.F32.BF16 carry every product. The mbarrier fills, fragment
// loads, mma wrappers and the score block are in mma_common.cuh.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

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
        score_block<T, NJ>(s, TileA<T>(Qs + m0 * ld, ld, lane), Kt, ld, half ? mid : 0,
                           half ? nks : mid, lane);
      } else {
        score_block<T, NJ>(s, TileA<T>((half ? Gs : Qs) + m0 * ld, ld, lane), half ? Vt : Kt, ld,
                           0, nks, lane);
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
      score_block<T, NJ>(s, TileA<T>((half ? Vs : Ks) + m0 * ld, ld, lane), half ? Gt : Qt, ld, 0,
                         nks, lane);
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
  if (misaligned(ptrs, 4, strides, dtype == 0 ? 4 : 2, B, H, Sq, Skv))
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
  if (misaligned(ptrs, 4, strides, dtype == 0 ? 4 : 2, B, H, Sq, Skv))
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
