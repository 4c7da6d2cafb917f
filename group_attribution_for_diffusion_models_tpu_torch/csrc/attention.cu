// Attention forward, softmax(Q K^T / sqrt(D)) V, for Hopper (sm_90a) on the
// tensor cores.
//
// Replaces the TPU kernels ops/attention.py::_flash_kernel (transposed
// (B*H, D, S) layout) and ::_hp_fwd_kernel (head-packed (B, S, H*D) layout)
// of the JAX package. Both compute the same function; here one kernel reads
// q/k/v through their strides straight from (B, S, H, D), so neither layout
// nor any transpose reaches device memory. The residuals stay (q, k, v).
//
// What bounds it on the H100: the two products are 4*B*H*Sq*Skv*D FLOPs. At
// the CIFAR shape (B=64, S=256, H=1, D=256) that is 4.29 GFLOP on 67.1 MB of
// q/k/v/o in f32: 0.0260 ms at 495/3 TFLOP/s (three TF32 products an f32 one)
// against 0.0200 ms of bytes, so f32 is bound by operations; in bf16 the
// 33.5 MB take 0.0100 ms against 0.0043 ms of products at 989 TFLOP/s, so bf16
// is bound by bytes.
//
// Design. Every product is mma.sync with f32 accumulators: bf16 inputs
// m16n8k16 with ldmatrix, P rounded to bf16 before P V as the TPU kernel does;
// f32 inputs m16n8k8 TF32 with the 3-term split, a.b ~ a_lo.b_hi + a_hi.b_lo +
// a_hi.b_hi (one term keeps 10 mantissa bits and misses the f32 tolerance).
// The split truncates (MmaF32Trunc below: two operations an element). A block
// owns 64 query rows of one (b, h); its 8 warps form two key streams of 4
// warps, 16 rows a warp, and stream s takes key tiles s, s + 2, ... (16 keys
// in f32, 32 in bf16, twice that at D <= 64). A warp forms its rows' scores
// over the whole depth and keeps them in registers: the online softmax (f32,
// exp2 of scores in log2 units) works on the score fragments, which become
// P V's A fragments in place (in f32 with the depth slots t, t + 4 taking keys
// 2t, 2t + 1, and V's rows read in that order), and O (16 rows x D) stays in
// registers. So no score crosses shared memory and no barrier spans the
// block inside the key loop: each stream waits on its own mbarriers and syncs
// its 4 warps (named barriers) only to free a tile for the next load. At the
// end stream 1 leaves its (m, l, O) in shared memory and stream 0 joins the
// two partial softmax states, in stream order.
//   Q is split once a block: it lands in shared memory as f32 and every thread
// rewrites its elements as two TF32 planes, hi and lo, read as ready
// fragments. K and V tiles arrive on an mbarrier each; K of a stream's next
// tile loads while this tile's softmax and P V run, V while the next scores
// run. Rows of 1 KB or more go by bulk copies (TMA, one request a row, from
// the stream's first warp), shorter rows by 16-byte cp.async from the
// stream's threads (past Sq or Skv, zeros). bf16 rows are D rounded up to 16
// (zeros in the pad) + 8, read by ldmatrix. mbarrier fills, fragment loads,
// the mma wrappers and the score block are in mma_common.cuh.
// Shared memory at D = 256: 202,280 bytes in f32 (Q's two planes, a K and a V
// tile of 16 rows for each stream, 5 mbarriers), 101,416 in bf16: one block
// per SM (O in registers takes 128 of them a thread at D = 256). nvcc
// -Xptxas -v (scripts/kernel_stats.sh): f32 255 / 180 / 128 registers a
// thread at D <= 256 / 128 / 64, bf16 241 / 172 / 126, no spills.
// Every output element has one owner thread and every sum runs in a fixed
// order: no atomics, and two runs give the same bits. Keys >= Skv get P = 0;
// query rows >= Sq read zeros and are not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

// A fragments of Q split once into TF32 planes (by MmaF32Trunc::split below):
// the fragment layout of Mma<float>::load_a, without the split.
struct SplitA {
  const uint32_t* hi;  // row m0 of the hi plane, plus the lane offset
  const uint32_t* lo;
  int ld;
  __device__ SplitA(const uint32_t* hi_rows, const uint32_t* lo_rows, int ld_, int lane)
      : hi(hi_rows + Mma<float>::a_lane(lane, ld_)),
        lo(lo_rows + Mma<float>::a_lane(lane, ld_)),
        ld(ld_) {}
  __device__ void load(Mma<float>::A& a, int k) const {
    const uint2 u = *reinterpret_cast<const uint2*>(hi + k);
    const uint2 w = *reinterpret_cast<const uint2*>(hi + k + 8 * ld);
    const uint2 x = *reinterpret_cast<const uint2*>(lo + k);
    const uint2 y = *reinterpret_cast<const uint2*>(lo + k + 8 * ld);
    a.hi[0] = u.x, a.hi[1] = w.x, a.hi[2] = u.y, a.hi[3] = w.y;
    a.lo[0] = x.x, a.lo[1] = y.x, a.lo[2] = x.y, a.lo[3] = y.y;
  }
};

// The f32 forward's TF32 split: the tensor cores ignore the 13 low bits of a
// TF32 operand (they truncate), so x's own bits serve as x_hi = trunc(x), and
// x_lo = x - x_hi is exact in f32 and is truncated the same way: two
// operations an element, where Mma<float>'s rounded split takes five. Each
// product keeps a relative error below about 3 * 2^-20 (tests/
// test_torch_attention_split.py emulates it against the f32 tolerance).
struct MmaF32Trunc : Mma<float> {
  __device__ static void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = __float_as_uint(x);
    lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
  }
  __device__ static void make_a(A& a, const float (&v)[kA]) {
#pragma unroll
    for (int e = 0; e < kA; ++e) split(v[e], a.hi[e], a.lo[e]);
  }
  __device__ static void load_b_nk(B& b, const float* X, int) {
    const float2 u = *reinterpret_cast<const float2*>(X);
    split(u.x, b.hi[0], b.lo[0]);
    split(u.y, b.hi[1], b.lo[1]);
  }
};

// The MMA policy of the forward: MmaF32Trunc in f32, Mma<bf16> in bf16.
template <typename T>
struct FwdMma : Mma<T> {};
template <>
struct FwdMma<float> : MmaF32Trunc {};

// Q planes: two (TF32 hi and lo words) in f32, one in bf16.
template <typename T>
constexpr int kQPlanes = sizeof(T) == 4 ? 2 : 1;

// Shared-memory geometry of the forward for head dim D. The block's 8 warps
// form two key streams of 4 warps, 16 query rows a warp; each stream holds one
// K and one V tile of kBK keys. An f32 V tile's row stride is D + 4 (4 mod 8
// words): the accumulate stage's B loads, rows 2t and 2t + 1 of lane (g, t),
// then hit distinct banks; bf16 V tiles are read by ldmatrix like K.
template <typename T, int DMAX>
struct FwdLayout {
  using L = Layout<T, DMAX>;
  static constexpr int kBK = L::kBK;
  __host__ __device__ static int ld(int D) { return L::ld(D); }
  __host__ __device__ static int ldv(int D) { return sizeof(T) == 4 ? D + 4 : L::ld(D); }
  // Q's planes, K0, K1, V0, V1, then 5 mbarriers (Q, K0, K1, V0, V1).
  __host__ __device__ static int bytes(int D) {
    return ((kQPlanes<T> * kRows + 2 * kBK) * ld(D) + 2 * kBK * ldv(D)) *
               static_cast<int>(sizeof(T)) + 40;
  }
  // Stream 1's partial O (kRows x D f32) reuses the tiles' space, at least
  // 2 kBK x 2 D elements (ld and ldv are at least D).
  static_assert(2 * kBK * 2 * sizeof(T) >= kRows * sizeof(float),
                "the key tiles cannot hold a stream's partial output");
};

constexpr int kStreamThreads = kThreads / 2;  // 4 warps a key stream

// Barrier among the 4 warps of key stream h (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void stream_sync(int h) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + h), "r"(kStreamThreads) : "memory");
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, DMAX == 64 ? 2 : 1)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, int H, int Sq, int Skv, int D, Strides st,
                     float scale) {
  using M = FwdMma<T>;
  using FL = FwdLayout<T, DMAX>;
  constexpr bool kSplit = sizeof(T) == 4;
  constexpr int BK = FL::kBK;
  constexpr int NJ = BK / 8;          // 8-key tiles of a score block
  constexpr int KS = BK / M::kK;      // mma depth steps over a key tile
  constexpr int NT = DMAX / 8;        // 8-column tiles of D, at most
  constexpr int G = NT < 8 ? NT : 8;  // V fragments loaded ahead of their products
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = Layout<T, DMAX>::depth(D);
  const int ld = FL::ld(D);
  const int ldv = FL::ldv(D);
  T* Qs = reinterpret_cast<T*>(smem);         // kQPlanes x kRows x ld; f32 Q lands in plane 1
  T* Ks = Qs + kQPlanes<T> * kRows * ld;      // stream s's K tile: Ks + s BK ld
  T* Vs = Ks + 2 * BK * ld;                   // stream s's V tile: Vs + s BK ldv
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + 2 * BK * ldv);  // Q, K0, K1, V0, V1

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int q0 = blockIdx.y * kRows;
  const int q_valid = min(kRows, Sq - q0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lg = lane >> 2;                           // fragment row
  const int lc = lane & 3;                            // fragment column pair
  const int m0 = (warp & 3) * 16;                     // this warp's 16 rows
  const int stream = warp >> 2;                       // key tiles stream, stream + 2, ...
  const int sid = threadIdx.x & (kStreamThreads - 1);  // thread of the stream
  const int r0 = m0 + lg;                             // a thread's rows r0 and r0 + 8
  const int nks = Dp / M::kK;
  const int ntiles = D / 8;
  // Column of tile j; tiles past D load a valid column and skip their products.
  auto col_of = [&](int j) { return min(j, ntiles - 1) * 8; };
  const int nkt = (Skv + BK - 1) / BK;
  const float scale2 = scale * 1.4426950408889634f;  // scores in log2 units, for exp2f

  const T* kb = k + b * st.k_sb + h * st.k_sh;
  const T* vb = v + b * st.v_sb + h * st.v_sh;
  const int row_bytes = D * static_cast<int>(sizeof(T));
  const bool bulk = row_bytes >= kBulkRowBytes;
  T* Kt = Ks + stream * BK * ld;
  T* Vt = Vs + stream * BK * ldv;
  // K (which = 0) or V (1) rows of key tile `tile` into this stream's buffer,
  // by the stream's threads, on the buffer's barrier.
  auto load = [&](int which, int tile) {
    const int k0 = tile * BK;
    const int valid = min(BK, Skv - k0);
    uint64_t* bar = &bars[1 + 2 * which + stream];
    fill_begin(bar, bulk, valid * row_bytes, sid);
    if (which == 0)
      fill_rows(Kt, ld, kb + k0 * st.k_ss, st.k_ss, BK, valid, D, bulk, bar, sid,
                kStreamThreads);
    else
      fill_rows(Vt, ldv, vb + k0 * st.v_ss, st.v_ss, BK, valid, D, bulk, bar, sid,
                kStreamThreads);
    fill_end(bar, bulk, sid);
  };

  if (threadIdx.x == 0) {
    mbar_init(&bars[0]);
    for (int i = 1; i < 5; ++i) mbar_init(&bars[i], kStreamThreads);
  }
  zero_pad(Qs, ld, kQPlanes<T> * kRows + 2 * BK, D, Dp);  // Q and K tiles; bf16 V too
  if (!kSplit) zero_pad(Vs, ldv, 2 * BK, D, Dp);
  __syncthreads();
  fill_begin(&bars[0], bulk, q_valid * row_bytes);
  fill_rows(Qs + (kQPlanes<T> - 1) * kRows * ld, ld, q + b * st.q_sb + h * st.q_sh + q0 * st.q_ss,
            st.q_ss, kRows, q_valid, D, bulk, &bars[0]);
  fill_end(&bars[0], bulk);
  if (stream < nkt) {
    load(0, stream);
    load(1, stream);
  }
  mbar_wait(&bars[0], 0);
  if constexpr (kSplit) {  // each thread splits its own elements of Q in place
    uint32_t* hi = reinterpret_cast<uint32_t*>(Qs);
    uint32_t* lo = hi + kRows * ld;
    for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
      const int at = (i / D) * ld + i % D;
      M::split(__uint_as_float(lo[at]), hi[at], lo[at]);
    }
  }
  __syncthreads();  // Q's planes are complete

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int tile = stream, i = 0; tile < nkt; tile += 2, ++i) {
    const int kv_valid = min(BK, Skv - tile * BK);
    mbar_wait(&bars[1 + stream], i & 1);  // K of this tile is in

    // Score stage: S of rows m0 .. m0 + 15 and the tile's keys, over all of D.
    float s[NJ][4];
    if constexpr (kSplit) {
      const uint32_t* hi = reinterpret_cast<const uint32_t*>(Qs) + m0 * ld;
      score_block<T, NJ, SplitA, M>(s, SplitA(hi, hi + kRows * ld, ld, lane), Kt, ld, 0, nks,
                                    lane);
    } else {
      score_block<T, NJ>(s, TileA<T>(Qs + m0 * ld, ld, lane), Kt, ld, 0, nks, lane);
    }
    stream_sync(stream);  // the stream's warps are done with K
    if (tile + 2 < nkt) load(0, tile + 2);

    // Online softmax in registers, in log2 units: s[j][e] is row r0 + 8 (e / 2),
    // key 8 j + 2 lc + e % 2.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = 8 * j + 2 * lc + (e & 1) < kv_valid ? s[j][e] * scale2 : -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);  // finite: a tile holds a valid key
      alpha[r] = exp2f(m_run[r] - m_new);           // 0 on the first tile
      m_run[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_run[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + sum[r];
    }
    if (alpha[0] != 1.f || alpha[1] != 1.f) {  // a row's max moved (x 1 keeps the bits)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }
    }

    // Accumulate stage: O += P V, P straight from the score fragments. f32:
    // depth slots t and t + 4 of k-step j take keys 8 j + 2t and 8 j + 2t + 1
    // (V rows read in the same order); bf16: k-step j is score tiles 2 j, 2 j + 1.
    mbar_wait(&bars[3 + stream], i & 1);  // V of this tile is in
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      typename M::A a;
      if constexpr (kSplit) {
        const float pv[4] = {s[ks][0], s[ks][2], s[ks][1], s[ks][3]};
        M::make_a(a, pv);
      } else {
        const float pv[8] = {s[2 * ks][0],     s[2 * ks][1],     s[2 * ks][2],
                             s[2 * ks][3],     s[2 * ks + 1][0], s[2 * ks + 1][1],
                             s[2 * ks + 1][2], s[2 * ks + 1][3]};
        M::make_a(a, pv);  // P rounded to bf16
      }
#pragma unroll
      for (int j0 = 0; j0 < NT; j0 += G) {
        typename M::B bv[G];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if constexpr (kSplit) {
            const float* x = Vt + (8 * ks + 2 * lc) * ldv + lg + col_of(j0 + j);
            M::split(x[0], bv[j].hi[0], bv[j].lo[0]);
            M::split(x[ldv], bv[j].hi[1], bv[j].lo[1]);
          } else {
            M::load_b_kn(bv[j], Vt + M::b_kn_lane(lane, ld) + ks * M::kK * ld + col_of(j0 + j),
                         ld);
          }
        }
#pragma unroll
        for (int j = 0; j < G; ++j)
          if (j0 + j < ntiles) M::mma(acc[j0 + j], a, bv[j]);
      }
    }
    stream_sync(stream);  // the stream's warps are done with V
    if (tile + 2 < nkt) load(1, tile + 2);
  }

  // The two streams' partial softmax states (m, l, O over disjoint keys) are
  // joined by stream 0: stream 1 leaves its own in shared memory (Q's and
  // the tiles' space), stream 0 rescales both to the common max, sums them in
  // stream order and stores.
  __syncthreads();
  float* ml = reinterpret_cast<float*>(Qs);  // stream 1's m, then l, kRows each
  float* Op = reinterpret_cast<float*>(Ks);  // stream 1's O, kRows x D
  if (stream == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (lc == 0) {
        ml[row] = m_run[r];
        ml[kRows + row] = l_run[r];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < ntiles)
          *reinterpret_cast<float2*>(&Op[row * D + 8 * j + 2 * lc]) =
              make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
  __syncthreads();
  if (stream == 1) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= q_valid) continue;
    const float m1 = ml[row];
    const float m = fmaxf(m_run[r], m1);
    const float a0 = exp2f(m_run[r] - m);
    const float a1 = exp2f(m1 - m);  // 0 when stream 1 had no tile
    const float inv = 1.f / (l_run[r] * a0 + ml[kRows + row] * a1);
    T* orow = o + ((static_cast<int64_t>(b) * Sq + q0 + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < ntiles) {
        const int col = 8 * j + 2 * lc;
        const float2 p = *reinterpret_cast<const float2*>(&Op[row * D + col]);
        store2(orow + col, (acc[j][2 * r] * a0 + p.x * a1) * inv,
               (acc[j][2 * r + 1] * a0 + p.y * a1) * inv);
      }
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
                   int Skv, int D, const Strides& st, float scale, int device,
                   cudaStream_t stream) {
  using FL = FwdLayout<T, DMAX>;
  auto kernel = attention_fwd_kernel<T, DMAX>;
  static uint64_t configured = 0;
  const cudaError_t err = allow_smem(kernel, configured, device, FL::bytes(DMAX));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, FL::bytes(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Sq, Skv, D, st, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
                     int Skv, int D, const Strides& st, float scale, int device,
                     cudaStream_t stream) {
  if (D <= 64) return launch<T, 64>(q, k, v, o, B, H, Sq, Skv, D, st, scale, device, stream);
  if (D <= 128) return launch<T, 128>(q, k, v, o, B, H, Sq, Skv, D, st, scale, device, stream);
  return launch<T, 256>(q, k, v, o, B, H, Sq, Skv, D, st, scale, device, stream);
}

}  // namespace

extern "C" {

const char* gadm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v: (B, S, H, D) with unit stride on D; strides in elements, in the
// order q (b, s, h), k (b, s, h), v (b, s, h); pointers and strides keep rows
// 16-byte aligned. o: contiguous (B, Sq, H, D). dtype: 0 = float32,
// 1 = bfloat16. Returns a cudaError_t.
int gadm_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype, int B,
                       int H, int Sq, int Skv, int D, const int64_t* strides, float scale,
                       int device, void* stream) {
  if (bad_shape(B, H, Sq, Skv, D) || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  const void* ptrs[] = {q, k, v};
  if (misaligned(ptrs, 3, strides, dtype == 0 ? 4 : 2, B, H, Sq, Skv))
    return cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Strides st = strides_from(strides, 3);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, o, B, H, Sq, Skv, D, st, scale, device, s);
  return dispatch<__nv_bfloat16>(q, k, v, o, B, H, Sq, Skv, D, st, scale, device, s);
}

}  // extern "C"
