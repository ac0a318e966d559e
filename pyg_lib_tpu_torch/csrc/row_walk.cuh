// The row walker of K1 (spmm_chunked.cu) and K7 (spmm_range_fused.cu).
//
// A warp adds the x rows of one slot range [lo, hi) into its accumulator,
// in slot order, each lane over its own features of the block's slice:
//
//   acc[f] += w[p] * x[c_p, f]   for p = lo .. hi - 1,
//
// with c_p = cols[p] (or p itself: K1's msgs_padded entry) and w[p] = 1 on
// an unweighted call. K1 walks each row's one range, K7 each row's S ranges
// one after another, so the two kernels share this loop and cannot drift
// apart. Sums run in f32 per feature in slot order (a weight by fmaf), so
// the bits do not depend on how the lanes split the features.
//
// Two layouts of a lane's features, chosen by the launcher (walk_dispatch):
// * the vector branch: a lane holds W = 16 / sizeof(T) neighbouring
//   elements and loads them with one 16-byte __ldg per slot, so a warp
//   covers a 512-byte slice of the row (128 f32, 256 bf16 or 512 int8
//   features) and a block one (tile, slice) pair. It takes x, out and
//   scale at 16-byte aligned addresses and a row pitch F * sizeof(T) that
//   is a multiple of 16 bytes and at least 512;
// * the scalar branch: W = 1, a lane holds NV elements 32 apart (NV the
//   least power of two up to 4 with 32 * NV >= F), one plain load each:
//   any F and any address (views, x[:, :F] slices, bf16 rows of odd F,
//   rows narrower than a slice).
// In the vector branch a warp loads CHUNK slots before it adds them; the
// scalar branch takes a slot at a time, its loop unrolled.
//
// Both kernels leave a slot run longer than a cut length out of their row
// walk and sum it in pieces (row_pieces.cuh).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace pygt {

constexpr int CHUNK = 4;  // slots loaded before they are added
static_assert(32 % CHUNK == 0, "a group of 32 column ids holds whole chunks");

template <int N>
using Int = std::integral_constant<int, N>;

// Blocks of 256 threads an SM that a kernel of a branch is built for,
// which caps its registers at 65536 / (256 * blocks): 32 for the scalar
// branch at NV <= 2, 48 for the unweighted f32 vector branch, 64 for the
// rest. Left to choose, ptxas capped the scalar branch at NV = 4 and the
// bf16 or weighted vector branch at 32 or 48 registers and spilled; these
// caps spill nowhere and keep the F=47 scalar and f32 vector kernels at
// the occupancy they were fastest at (PERF.md).
template <typename T, int W, int NV, bool WEIGHTED>
constexpr int walk_blocks() {
  if (W == 1) return NV <= 2 ? 8 : 4;
  return sizeof(T) == 4 && !WEIGHTED ? 5 : 4;
}

// Row c of a lane's column base xl (x + fl), rows `pitch` bytes apart:
// one 32 x 32 -> 64-bit multiply-add a slot (mad.wide.s32). Left to
// itself the compiler sometimes did a 64-bit multiply and a separate add,
// which cost K1's scalar branch up to 20% at F=47 (PERF.md).
template <typename T>
__device__ __forceinline__ const T* row_at(const T* xl, int c, int pitch) {
  const T* p;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(p) : "r"(c), "r"(pitch), "l"(xl));
  return p;
}

__device__ __forceinline__ uint32_t word(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// A lane's 16 bytes of a row (W elements), and element k of them as f32
// (exact: bf16 and int8 widen).
template <typename T>
struct Vec16 {
  static constexpr int W = 16 / sizeof(T);

  static __device__ __forceinline__ uint4 load(const T* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }

  static __device__ __forceinline__ float get(const uint4& r, int k) {
    if constexpr (std::is_same<T, float>::value) {
      return __uint_as_float(word(r, k));
    } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      const uint32_t u = word(r, k / 2);  // element 2i in the low half
      return __uint_as_float(k % 2 ? u & 0xffff0000u : u << 16);
    } else {
      const uint32_t u = word(r, k / 4);  // element 4i + j in byte j
      return static_cast<float>(static_cast<int>(u << (24 - 8 * (k % 4))) >>
                                24);
    }
  }
};

// One warp's walk over slot ranges; W and NV fix the lane's features:
// fl + v * 32 * W + k for v < NV, k < W, fl = the block's first feature +
// lane * W.
template <typename T, int W, int NV, bool GATHER, bool WEIGHTED>
struct RowWalk {
  using P = Vec16<T>;
  static_assert(W == 1 || W == P::W, "a lane loads 16 bytes or one element");
  const int F, fl, lane;
  bool ok[NV];

  __device__ __forceinline__ RowWalk(int F_, int fl_, int lane_)
      : F(F_), fl(fl_), lane(lane_) {
#pragma unroll
    for (int v = 0; v < NV; ++v) ok[v] = fl + v * 32 * W < F;
  }

  // acc += the slots [lo, hi), in order.
  __device__ __forceinline__ void run(const T* __restrict__ x,
                                      const int* __restrict__ cols,
                                      const float* __restrict__ w, int lo,
                                      int hi, float (&acc)[NV][W]) const {
    if constexpr (W == 1)
      run_scalar(x, cols, w, lo, hi, acc);
    else
      run_vector(x, cols, w, lo, hi, acc);
  }

  // The vector branch: CHUNK slots' 16-byte loads, then their adds.
  __device__ __forceinline__ void run_vector(const T* __restrict__ x,
                                             const int* __restrict__ cols,
                                             const float* __restrict__ w,
                                             int lo, int hi,
                                             float (&acc)[NV][W]) const {
    const T* xl = x + fl;
    const int pitch = F * static_cast<int>(sizeof(T));
    for (int base = lo; base < hi; base += 32) {
      const int n = min(32, hi - base);
      const int mine = (GATHER && lane < n) ? cols[base + lane] : 0;
      const float wmine = (WEIGHTED && lane < n) ? w[base + lane] : 1.0f;
#pragma unroll
      for (int s0 = 0; s0 < 32; s0 += CHUNK) {
        if (s0 >= n) break;  // the same for the whole warp
        uint4 raw[CHUNK][NV];
#pragma unroll
        for (int s = 0; s < CHUNK; ++s) {
          const T* p = row_at(
              xl, GATHER ? __shfl_sync(FULL, mine, s0 + s) : base + s0 + s,
              pitch);
#pragma unroll
          for (int v = 0; v < NV; ++v)
            if (s0 + s < n && ok[v]) raw[s][v] = P::load(p + v * 32 * W);
        }
#pragma unroll
        for (int s = 0; s < CHUNK; ++s) {
          const float ws = WEIGHTED ? __shfl_sync(FULL, wmine, s0 + s) : 1.0f;
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            if (!(s0 + s < n && ok[v])) continue;
#pragma unroll
            for (int k = 0; k < W; ++k) {
              const float e = P::get(raw[s][v], k);
              acc[v][k] = WEIGHTED ? fmaf(ws, e, acc[v][k]) : acc[v][k] + e;
            }
          }
        }
      }
    }
  }

  // The scalar branch: a slot at a time, unrolled by 4 (by 2 at NV = 4,
  // which spilled at 4). Loading CHUNK slots before adding them took more
  // registers and fewer resident warps, and lost at F=47 (PERF.md).
  __device__ __forceinline__ void run_scalar(const T* __restrict__ x,
                                             const int* __restrict__ cols,
                                             const float* __restrict__ w,
                                             int lo, int hi,
                                             float (&acc)[NV][W]) const {
    const T* xl = x + fl;
    const int pitch = F * static_cast<int>(sizeof(T));
    for (int base = lo; base < hi; base += 32) {
      const int n = min(32, hi - base);
      const int mine = (GATHER && lane < n) ? cols[base + lane] : 0;
      const float wmine = (WEIGHTED && lane < n) ? w[base + lane] : 1.0f;
#pragma unroll(NV < 4 ? 4 : 2)
      for (int j = 0; j < n; ++j) {
        const float wj = WEIGHTED ? __shfl_sync(FULL, wmine, j) : 1.0f;
        const T* src =
            row_at(xl, GATHER ? __shfl_sync(FULL, mine, j) : base + j, pitch);
#pragma unroll
        for (int v = 0; v < NV; ++v)
          if (ok[v]) {
            const float e = to_f32(src[32 * v]);
            acc[v][0] = WEIGHTED ? fmaf(wj, e, acc[v][0]) : acc[v][0] + e;
          }
      }
    }
  }

  // out[row] = acc (times scale per feature if given), written once.
  __device__ __forceinline__ void write(float* __restrict__ out,
                                        const float* __restrict__ scale,
                                        int64_t row,
                                        const float (&acc)[NV][W]) const {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (!ok[v]) continue;
      const int f = fl + v * 32 * W;
      float* dst = out + row * F + f;
      if constexpr (W % 4 == 0) {
#pragma unroll
        for (int k = 0; k < W; k += 4) {
          float4 q = make_float4(acc[v][k], acc[v][k + 1], acc[v][k + 2],
                                 acc[v][k + 3]);
          if (scale != nullptr) {
            const float4 s =
                __ldg(reinterpret_cast<const float4*>(scale + f + k));
            q = make_float4(q.x * s.x, q.y * s.y, q.z * s.z, q.w * s.w);
          }
          *reinterpret_cast<float4*>(dst + k) = q;
        }
      } else {
#pragma unroll
        for (int k = 0; k < W; ++k)
          dst[k] = scale != nullptr ? acc[v][k] * scale[f + k] : acc[v][k];
      }
    }
  }
};

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Calls go(Int<W>(), Int<NV>()) with the branch x, out, scale and F allow:
// the vector branch (W = 16 / sizeof(T), NV = 1) when the three addresses
// and the row pitch are multiples of 16 bytes and a row fills a warp's
// 512-byte slice, else the scalar branch. On narrower rows most of the
// vector branch's lanes idle and its registers (fewer resident warps) cost
// more than its fewer loads save: K1m at F=4, GAT's softmax row sums, took
// 0.138 ms in the vector branch and 0.092 in the scalar one (PERF.md).
template <typename T, typename Go>
inline void walk_dispatch(const void* x, const void* out, const void* scale,
                          int F, Go&& go) {
  const int64_t pitch = static_cast<int64_t>(F) * sizeof(T);
  if (aligned16(x) && aligned16(out) && aligned16(scale) && pitch % 16 == 0 &&
      pitch >= 512) {
    go(Int<static_cast<int>(16 / sizeof(T))>(), Int<1>());
    return;
  }
  switch (pick_vpl(F, 4)) {
    case 1:
      go(Int<1>(), Int<1>());
      break;
    case 2:
      go(Int<1>(), Int<2>());
      break;
    default:
      go(Int<1>(), Int<4>());
  }
}

// Blocks of a launch: the tiles, times the slices of 32 * W * NV features.
inline dim3 walk_grid(int num_tiles, int F, int W, int NV) {
  return dim3(num_tiles, (F + 32 * W * NV - 1) / (32 * W * NV));
}

}  // namespace pygt
