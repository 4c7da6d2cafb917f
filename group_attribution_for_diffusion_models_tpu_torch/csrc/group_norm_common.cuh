// Shared by the GroupNorm(+SiLU) forward (group_norm.cu) and backward
// (group_norm_bwd.cu) kernels: 16-byte loads and stores of f32/bf16, warp
// sums, and the host's choice of size class, so that both directions cut a
// group the same way.
//
// x is NCHW, so one (sample b, group g) is one contiguous run of
// n = cpg * HW elements (cpg = C / G channels of HW each). gamma and beta are
// R rows of C (R divides B); sample b reads row b / (B / R).
//
// Size classes, chosen on the host from n, HW and alignment:
//   flat:   x read as 16-byte vectors (4 f32 or 8 bf16), a group's nvec
//           vectors cut into units of 32 consecutive vectors, one vector a
//           lane. A warp owns a contiguous run of units and holds them in
//           registers from the statistics to the output pass, so x (and, in
//           the backward, dy) is read from memory once. A unit lies in one
//           channel (HW/V a multiple of 32) or covers 32/(HW/V) whole
//           channels (HW/V a power of two below 32), so a vector's channel
//           follows from its unit and lane by shifts and a counter, with no
//           division per element. Up to 128 units (n <= 16384 f32, 32768
//           bf16; the CIFAR U-Net's largest group is 12288):
//             - small groups: one warp a group, 4 groups a block, no block
//               barrier (forward: up to 8 units, n <= 1024 f32, the U-Net's
//               4x4 and 8x8 levels; backward: up to 2 units);
//             - larger ones: several warps a group, one group a block
//               (forward: 4 units a warp, up to 16 warps, else 8 units;
//               backward, which holds x and dy: 2 units a warp, up to 32
//               warps, else 4, to keep registers, and so warps in flight,
//               within what hides the memory's latency).
//   stream: any other shape (larger groups, HW*elsize not a multiple of 16,
//           an unaligned pointer, or HW/V neither a multiple of 32 nor a
//           power of two): one block of 8 warps a group walks it channel by
//           channel, 16 bytes a load where HW allows it, else one element,
//           and reads it again for the output pass.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gn {

constexpr int kFlatMaxUnits = 128;  // units a group in the flat class
constexpr int kFlatMaxCpg = 64;     // channels a group (shared partials of the backward)
constexpr int kWarpGroups = 4;     // groups a block in the one-warp-a-group case
constexpr int kStreamThreads = 256;

// Everything a kernel needs to cut the batch; computed once on the host.
struct Shape {
  int B, C, G, cpg, n;  // n = cpg * HW elements a group
  int spr;              // samples per gamma/beta row: sample b reads row b / spr
  int hwv, nvec;        // vectors (V elements, or 1 in the scalar stream) a channel, a group
  int units, upw;       // flat: units a group, units a warp (at most the template's)
  int wpg, gpb;         // flat: warps a group, groups a block
  int upc, cpu, lsh;    // flat: units a channel, channels a unit, log2(lanes a channel segment)
};

enum Kind { kFlat, kStream };

struct Plan {
  Kind kind;
  int upw_t;    // flat: register slots a warp (1, 2, 4 or 8)
  int vec;      // stream: 1 if 16-byte vectors, 0 if scalar
  int threads, blocks;
};

inline bool is_pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// How a direction cuts the flat class: the most units of a one-warp group,
// then units a warp (doubled up to 8 until the warps fit max_wpg).
struct FlatCut {
  int warp_units, upw, max_wpg;
};
constexpr FlatCut kFwdCut{8, 4, 16};
constexpr FlatCut kBwdCut{2, 2, 32};

// elsize: bytes of x's element; aligned: every pointer the kernel reads or
// writes a group at is 16-byte aligned.
inline Plan make_plan(Shape& s, int B, int C, int HW, int G, int R, int elsize, bool aligned,
                      FlatCut cut) {
  s.B = B;
  s.C = C;
  s.G = G;
  s.cpg = C / G;
  s.n = s.cpg * HW;
  s.spr = B / R;
  const int V = 16 / elsize;
  const bool vec = aligned && (HW * elsize) % 16 == 0;
  s.hwv = vec ? HW / V : HW;
  s.nvec = s.cpg * s.hwv;
  s.units = (s.nvec + 31) / 32;
  const bool flat = vec && s.cpg <= kFlatMaxCpg &&
                    (s.hwv % 32 == 0 || (s.hwv < 32 && is_pow2(s.hwv))) &&
                    s.units <= kFlatMaxUnits;
  Plan p{};
  if (!flat) {
    p.kind = kStream;
    p.vec = vec;
    p.threads = kStreamThreads;
    p.blocks = B * G;
    return p;
  }
  p.kind = kFlat;
  if (s.hwv >= 32) {
    s.upc = s.hwv / 32;
    s.cpu = 1;
    s.lsh = 5;
  } else {
    s.upc = 1;
    s.cpu = 32 / s.hwv;
    s.lsh = 0;
    while ((1 << s.lsh) < s.hwv) ++s.lsh;
  }
  if (s.units <= cut.warp_units) {  // one warp a group
    s.wpg = 1;
    s.gpb = kWarpGroups;
    s.upw = s.units;
  } else {
    int upw = cut.upw;
    while ((s.units + upw - 1) / upw > cut.max_wpg) upw *= 2;
    s.wpg = (s.units + upw - 1) / upw;
    s.gpb = 1;
    s.upw = (s.units + s.wpg - 1) / s.wpg;
  }
  p.upw_t = s.upw <= 1 ? 1 : s.upw <= 2 ? 2 : s.upw <= 4 ? 4 : 8;
  p.threads = 32 * s.wpg * s.gpb;
  p.blocks = (B * G + s.gpb - 1) / s.gpb;
  return p;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);  // elements in 16 bytes
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// The 16 bytes of r as f32: 4 f32 or 8 bf16 (a bf16 is the f32's high half).
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

// V values to V consecutive elements at p (aligned to V elements), in
// 16-byte stores (8-byte for 4 bf16).
template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&f)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
}
template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&f)[V]) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]), pack_bf16x2(f[4], f[5]),
                   pack_bf16x2(f[6], f[7]));
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]));
  }
}

// V elements at p as f32: one 16-byte load, or one element when V == 1.
template <int V, typename T>
__device__ __forceinline__ void load_f(const T* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = to_f32(*p);
  } else {
    unpack(load16(p), f);
  }
}
template <int V, typename T>
__device__ __forceinline__ void store_f(T* p, const float (&f)[V]) {
  if constexpr (V == 1) {
    store1(p, f[0]);
  } else {
    store_vec<V>(p, f);
  }
}

// a and b summed over the warp; every lane gets the totals.
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// sigmoid(v) by the fast exp and divide: within a few ulp of the IEEE
// quotient for |v| < 88; 0 below -88, where exp(-v) overflows.
__device__ __forceinline__ float sigmoid(float v) { return __fdividef(1.f, 1.f + __expf(-v)); }
__device__ __forceinline__ float silu(float v) { return v * sigmoid(v); }

}  // namespace gn
