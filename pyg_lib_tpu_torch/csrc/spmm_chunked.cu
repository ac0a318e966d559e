// K1: gather-fused segment sum over the chunked plan (SpmmPlan).
//
// Replaces the TPU kernel pyg_lib_tpu/ops/pallas/spmm_chunked.py
// `_chunked_kernel` (launched by `_segment_sum_chunked`) together with the
// XLA row gather `x[col_padded]` that feeds it in `spmm_plan_apply`:
//
//   out[r, f] = scale[f] * sum_{p in [lo_r, hi_r)} x[col_padded[p], f]
//
// where [lo_r, hi_r) = tile_ptr[t, 0, r : r + 2] are row r's padded slots
// (r local to its 128-row tile t) and `scale` is optional (int8 mode).
//
// Bound on the card: bytes. The sum does one add per gathered element, far
// below the 67 TFLOP/s of f32 CUDA cores, while every edge reads a whole
// x row (peaks of the NVIDIA H100 SXM data sheet, at its 700 W power
// limit). Each input read once and each output written once is
// N*F*elem + E_pad*4 + rows*F*4 bytes over the 3.35 TB/s of HBM;
// what the kernel really moves is one x row per edge, E*F*elem bytes,
// mostly from HBM since a 512-wide f32 table at 262k rows is ten times the
// 50 MB L2.
//
// Design against that bound:
// * the gather is fused: the TPU path wrote the padded message slab
//   [E_pad, F] to memory and read it back (9.2 GB in f32 at the bench
//   shape); here each x row goes straight from memory into registers;
// * one block per (tile, F-block), one warp per output row: the 32 lanes
//   read 32 neighbouring features of a row (coalesced), and each lane
//   keeps VPL independent loads in flight per edge;
// * column ids are read 32 at a time and broadcast with shuffles;
// * each output row is written once, with no atomics and no zero fill:
//   every row of a real tile owns its (possibly empty) slot range, and
//   rows past num_rows are skipped. Sums run in f32 in slot order, so
//   the result is deterministic.
#include "common.cuh"

namespace pygt {
namespace {

constexpr int K1_WARPS = 8;

template <typename T, int VPL>
__global__ void __launch_bounds__(K1_WARPS * 32)
    chunked_sum_kernel(const T* __restrict__ x,
                       const int* __restrict__ col_padded,
                       const int* __restrict__ tile_ptr,
                       const float* __restrict__ scale,
                       float* __restrict__ out, int num_rows, int F) {
  const int t = blockIdx.x;
  const int f0 = blockIdx.y * (32 * VPL);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int* ptr = tile_ptr + static_cast<int64_t>(t) * PTR_SUB * TP;

  bool ok[VPL];
  float sc[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int f = f0 + lane + 32 * v;
    ok[v] = f < F;
    sc[v] = (scale != nullptr && ok[v]) ? scale[f] : 1.0f;
  }

  for (int r = warp; r < TR; r += K1_WARPS) {
    const int64_t row = static_cast<int64_t>(t) * TR + r;
    if (row >= num_rows) break;
    const int lo = ptr[r];
    const int hi = ptr[r + 1];
    float acc[VPL];
#pragma unroll
    for (int v = 0; v < VPL; ++v) acc[v] = 0.0f;
    for (int base = lo; base < hi; base += 32) {
      const int n = min(32, hi - base);
      const int mine = lane < n ? col_padded[base + lane] : 0;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int64_t c = __shfl_sync(FULL, mine, j);
        const T* src = x + c * F + f0 + lane;
#pragma unroll
        for (int v = 0; v < VPL; ++v)
          if (ok[v]) acc[v] += to_f32(src[32 * v]);
      }
    }
    float* dst = out + row * F + f0 + lane;
#pragma unroll
    for (int v = 0; v < VPL; ++v)
      if (ok[v]) dst[32 * v] = scale != nullptr ? acc[v] * sc[v] : acc[v];
  }
}

template <typename T>
void launch(const void* x, const int* col_padded, const int* tile_ptr,
            const float* scale, float* out, int num_tiles, int num_rows,
            int F, cudaStream_t stream) {
  const int vpl = pick_vpl(F, 8);
  const dim3 grid(num_tiles, (F + 32 * vpl - 1) / (32 * vpl));
  const dim3 block(K1_WARPS * 32);
  const T* xt = static_cast<const T*>(x);
  switch (vpl) {
    case 1:
      chunked_sum_kernel<T, 1><<<grid, block, 0, stream>>>(
          xt, col_padded, tile_ptr, scale, out, num_rows, F);
      break;
    case 2:
      chunked_sum_kernel<T, 2><<<grid, block, 0, stream>>>(
          xt, col_padded, tile_ptr, scale, out, num_rows, F);
      break;
    case 4:
      chunked_sum_kernel<T, 4><<<grid, block, 0, stream>>>(
          xt, col_padded, tile_ptr, scale, out, num_rows, F);
      break;
    default:
      chunked_sum_kernel<T, 8><<<grid, block, 0, stream>>>(
          xt, col_padded, tile_ptr, scale, out, num_rows, F);
  }
}

}  // namespace
}  // namespace pygt

// x [N, F] (f32, bf16 or int8 by x_dtype), col_padded [E_pad] int32,
// tile_ptr [num_tiles, 8, 256] int32, scale [F] f32 or null,
// out [num_rows, F] f32. Returns cudaGetLastError() after the launch.
extern "C" int pygt_spmm_chunked(const void* x, int x_dtype,
                                 const void* col_padded, const void* tile_ptr,
                                 const void* scale, void* out, int num_tiles,
                                 int num_rows, int F, void* stream) {
  using namespace pygt;
  const int* cp = static_cast<const int*>(col_padded);
  const int* tp = static_cast<const int*>(tile_ptr);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case F32:
      launch<float>(x, cp, tp, sc, o, num_tiles, num_rows, F, s);
      break;
    case BF16:
      launch<__nv_bfloat16>(x, cp, tp, sc, o, num_tiles, num_rows, F, s);
      break;
    case I8:
      launch<int8_t>(x, cp, tp, sc, o, num_tiles, num_rows, F, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
