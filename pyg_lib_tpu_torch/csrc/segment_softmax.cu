// K6: per-row softmax in the chunked plan's padded edge coordinates
// (SpmmPlan).
//
// Replaces the three TPU kernels of pyg_lib_tpu/ops/pallas/
// segment_softmax_kernel.py, `_rowmax_kernel`, `_expsum_kernel` and
// `_normalize_kernel` (launched by `_softmax_padded`, driven by
// `segment_softmax_planned`), with one launch:
//
//   m_p      = src[p]          (idx == null: src is the padded slab)
//            = src[idx[p]]     (otherwise; idx = plan.edge_perm)
//   max_r    = max_{p in [lo_r, hi_r)} m_p
//   sum_r    = sum_{p in [lo_r, hi_r)} exp(m_p - max_r)
//   out[q_p] = exp(m_p - max_r) / sum_r,   q_p = p or idx[p]
//
// per feature, where [lo_r, hi_r) = tile_ptr[t, 0, r : r + 2] are row r's
// padded slots. In the padded mode every pad slot of a tile is written 0,
// as `_normalize_kernel` does; in the index mode the output is in the
// original edge order and pad slots have no place in it. Values keep the
// input's type (f32 or bf16) and everything inside is f32. A -inf message
// gives 0 beside a finite maximum and a row of -inf gives NaN, as the XLA
// composite `softmax_csr` does (the TPU kernel, through a one-hot matmul
// over -inf, can turn a whole chunk column into NaN instead).
//
// Bound on the card: bytes. Each input read once and each output written
// once is 2 * E_pad * F * elem bytes plus tile_ptr, over the 3.35 TB/s of
// HBM (NVIDIA H100 SXM data sheet, 700 W); two exp per element are far
// below the card's arithmetic rates.
//
// Design against that bound:
// * one launch where the TPU needs three grid passes, and no [R, F] row
//   statistics in memory: pass A keeps an online (max, sum) per feature in
//   registers, the sum rescaled by exp(old - new) when the max grows; pass
//   B re-reads the row's slots (from L2 for all but hub rows) and writes
//   the result once;
// * one warp per row of a 128-row tile, one block per (tile, F-block);
// * lanes follow the wider axis. An attention layer's softmax is as wide
//   as its head count (4), so with F <= 16 the 32 lanes take 32 slots and
//   loop over the features, and the warp merges its 32 (max, sum) pairs
//   with shuffles; wider F puts the lanes over features (coalesced rows);
// * the optional index reads src[edge_perm[p]] and writes out[edge_perm[p]]
//   for `softmax_csr`, so the permuted [E, F] copy and the edge_pos gather
//   back are never written.
// A hub row holds one warp for its whole length (twice): splitting long
// rows across warps is later work.
#include "common.cuh"

namespace pygt {
namespace {

constexpr int K6_WARPS = 8;
constexpr int NARROW_F = 16;  // widest F that puts lanes over slots

// Fold value x into the running (m, s): s is the sum of exp(v - m).
__device__ __forceinline__ void online(float& m, float& s, float x) {
  const float mn = fmaxf(m, x);
  s = (m == mn ? s : s * expf(m - mn)) + (x == mn ? 1.0f : expf(x - mn));
  m = mn;
}

// Merge another lane's (m2, s2) into (m, s); symmetric, so every lane of a
// butterfly ends with the same bits.
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = (m == mn ? s : s * expf(m - mn)) + (m2 == mn ? s2 : s2 * expf(m2 - mn));
  m = mn;
}

// Slots of tile t after its last row's range, up to the next tile's first
// slot (or E_pad): the tile's pad slots, which the padded mode writes 0.
__device__ __forceinline__ void pad_range(const int* tile_ptr, int t,
                                          int num_tiles, int e_pad, int& lo,
                                          int& hi) {
  lo = tile_ptr[static_cast<int64_t>(t) * PTR_SUB * TP + TR];
  hi = t + 1 < num_tiles
           ? tile_ptr[static_cast<int64_t>(t + 1) * PTR_SUB * TP]
           : e_pad;
}

// F > NARROW_F: lanes over features, VPL values per lane.
template <typename T, int VPL>
__global__ void __launch_bounds__(K6_WARPS * 32)
    softmax_wide(const T* __restrict__ src, const int* __restrict__ idx,
                 const int* __restrict__ tile_ptr, T* __restrict__ out,
                 int num_tiles, int e_pad, int F) {
  const int t = blockIdx.x;
  const int f0 = blockIdx.y * (32 * VPL);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int* ptr = tile_ptr + static_cast<int64_t>(t) * PTR_SUB * TP;

  bool ok[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) ok[v] = f0 + lane + 32 * v < F;

  for (int r = warp; r < TR; r += K6_WARPS) {
    const int lo = ptr[r];
    const int hi = ptr[r + 1];
    if (lo >= hi) continue;
    float m[VPL], s[VPL];
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      m[v] = neg_inf();
      s[v] = 0.0f;
    }
    for (int base = lo; base < hi; base += 32) {
      const int n = min(32, hi - base);
      int mine = 0;
      if (lane < n) mine = idx != nullptr ? idx[base + lane] : base + lane;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int64_t c = __shfl_sync(FULL, mine, j);
        const T* a = src + c * F + f0 + lane;
#pragma unroll
        for (int v = 0; v < VPL; ++v)
          if (ok[v]) online(m[v], s[v], to_f32(a[32 * v]));
      }
    }
    for (int base = lo; base < hi; base += 32) {
      const int n = min(32, hi - base);
      int mine = 0;
      if (lane < n) mine = idx != nullptr ? idx[base + lane] : base + lane;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int64_t c = __shfl_sync(FULL, mine, j);
        const T* a = src + c * F + f0 + lane;
        T* o = out + c * F + f0 + lane;
#pragma unroll
        for (int v = 0; v < VPL; ++v)
          if (ok[v])
            o[32 * v] = from_f32<T>(expf(to_f32(a[32 * v]) - m[v]) / s[v]);
      }
    }
  }
  if (idx == nullptr) {
    int plo, phi;
    pad_range(tile_ptr, t, num_tiles, e_pad, plo, phi);
    for (int p = plo + warp; p < phi; p += K6_WARPS) {
      T* o = out + static_cast<int64_t>(p) * F + f0 + lane;
#pragma unroll
      for (int v = 0; v < VPL; ++v)
        if (ok[v]) o[32 * v] = from_f32<T>(0.0f);
    }
  }
}

// F <= NF <= NARROW_F: lanes over slots, each lane loops over the features.
template <typename T, int NF>
__global__ void __launch_bounds__(K6_WARPS * 32)
    softmax_narrow(const T* __restrict__ src, const int* __restrict__ idx,
                   const int* __restrict__ tile_ptr, T* __restrict__ out,
                   int num_tiles, int e_pad, int F) {
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int* ptr = tile_ptr + static_cast<int64_t>(t) * PTR_SUB * TP;

  for (int r = warp; r < TR; r += K6_WARPS) {
    const int lo = ptr[r];
    const int hi = ptr[r + 1];
    if (lo >= hi) continue;
    float m[NF], s[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      m[f] = neg_inf();
      s[f] = 0.0f;
    }
    for (int p = lo + lane; p < hi; p += 32) {
      const int64_t c = idx != nullptr ? idx[p] : p;
      const T* a = src + c * F;
#pragma unroll
      for (int f = 0; f < NF; ++f)
        if (f < F) online(m[f], s[f], to_f32(a[f]));
    }
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      if (f >= F) continue;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float m2 = __shfl_xor_sync(FULL, m[f], off);
        const float s2 = __shfl_xor_sync(FULL, s[f], off);
        merge(m[f], s[f], m2, s2);
      }
    }
    for (int p = lo + lane; p < hi; p += 32) {
      const int64_t c = idx != nullptr ? idx[p] : p;
      const T* a = src + c * F;
      T* o = out + c * F;
#pragma unroll
      for (int f = 0; f < NF; ++f)
        if (f < F) o[f] = from_f32<T>(expf(to_f32(a[f]) - m[f]) / s[f]);
    }
  }
  if (idx == nullptr) {
    int plo, phi;
    pad_range(tile_ptr, t, num_tiles, e_pad, plo, phi);
    const int64_t first = static_cast<int64_t>(plo) * F;
    const int64_t last = static_cast<int64_t>(phi) * F;
    for (int64_t k = first + threadIdx.x; k < last; k += K6_WARPS * 32)
      out[k] = from_f32<T>(0.0f);
  }
}

template <typename T>
void launch(const void* src, const int* idx, const int* tile_ptr, void* out,
            int num_tiles, int e_pad, int F, cudaStream_t st) {
  const T* s = static_cast<const T*>(src);
  T* o = static_cast<T*>(out);
  const dim3 block(K6_WARPS * 32);
  if (F <= NARROW_F) {
    const dim3 grid(num_tiles);
    const int nf = pick_vpl(32 * F, NARROW_F);  // least power of 2 >= F
    switch (nf) {
      case 1:
        softmax_narrow<T, 1><<<grid, block, 0, st>>>(s, idx, tile_ptr, o,
                                                     num_tiles, e_pad, F);
        break;
      case 2:
        softmax_narrow<T, 2><<<grid, block, 0, st>>>(s, idx, tile_ptr, o,
                                                     num_tiles, e_pad, F);
        break;
      case 4:
        softmax_narrow<T, 4><<<grid, block, 0, st>>>(s, idx, tile_ptr, o,
                                                     num_tiles, e_pad, F);
        break;
      case 8:
        softmax_narrow<T, 8><<<grid, block, 0, st>>>(s, idx, tile_ptr, o,
                                                     num_tiles, e_pad, F);
        break;
      default:
        softmax_narrow<T, 16><<<grid, block, 0, st>>>(s, idx, tile_ptr, o,
                                                      num_tiles, e_pad, F);
    }
    return;
  }
  const int vpl = pick_vpl(F, 4);
  const dim3 grid(num_tiles, (F + 32 * vpl - 1) / (32 * vpl));
  switch (vpl) {
    case 1:
      softmax_wide<T, 1><<<grid, block, 0, st>>>(s, idx, tile_ptr, o,
                                                 num_tiles, e_pad, F);
      break;
    case 2:
      softmax_wide<T, 2><<<grid, block, 0, st>>>(s, idx, tile_ptr, o,
                                                 num_tiles, e_pad, F);
      break;
    default:
      softmax_wide<T, 4><<<grid, block, 0, st>>>(s, idx, tile_ptr, o,
                                                 num_tiles, e_pad, F);
  }
}

}  // namespace
}  // namespace pygt

// src [M, F] (f32 or bf16 by dtype; M >= e_pad when idx is null), idx
// [e_pad] int32 or null, tile_ptr [num_tiles, 8, 256] int32, out like src
// ([e_pad, F] written in full when idx is null; else the rows idx names).
// Returns cudaGetLastError() after the launch.
extern "C" int pygt_segment_softmax(const void* src, int dtype,
                                    const void* idx, const void* tile_ptr,
                                    void* out, int num_tiles, int e_pad,
                                    int F, void* stream) {
  using namespace pygt;
  const int* ix = static_cast<const int*>(idx);
  const int* tp = static_cast<const int*>(tile_ptr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      launch<float>(src, ix, tp, out, num_tiles, e_pad, F, st);
      break;
    case BF16:
      launch<__nv_bfloat16>(src, ix, tp, out, num_tiles, e_pad, F, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
