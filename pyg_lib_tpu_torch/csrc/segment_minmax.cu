// K4: exact segmented max with first-winner position over the chunked plan
// (SpmmPlan).
//
// Replaces the TPU kernel pyg_lib_tpu/ops/pallas/segment_minmax_kernel.py
// `_minmax_kernel` (launched by `_minmax_padded`, driven by
// `segment_max_planned_exact`), together with the XLA gather that feeds it
// its padded messages (`take(x, col_padded)` in `spmm`, `take(src,
// edge_perm)` in the planned `segment_max_csr`):
//
//   m_p       = s * src[p]          (idx == null: src is the padded slab)
//             = s * src[idx[p]]     (otherwise), s = -1 if negate else 1
//   vals[r,f] = max_{p in [lo_r, hi_r)} m_p[f]
//   pos[r,f]  = the least p that holds it
//
// where [lo_r, hi_r) = tile_ptr[t, 0, r : r + 2] are row r's padded slots.
// A row with no slots gets (-inf, POS_NONE). A slot is taken when its value
// is greater than the best so far, or equal to it while no slot has been
// taken: so a row whose true maximum is -inf reports its first slot, as the
// TPU kernel does through its position tie-break, and on a tie (-0.0 and
// +0.0 included) the first slot wins and its own bits are the value.
//
// Bound on the card: bytes. One compare per gathered element, far below
// the 67 TFLOP/s of f32 CUDA cores (NVIDIA H100 SXM data sheet, 700 W).
// Each input read once and each output written once is N*F*4 + E_pad*4 +
// rows*F*8 bytes over 3.35 TB/s of HBM; what the kernel really moves is
// one source row per slot, E*F*4 bytes, mostly from HBM at the bench
// shape (a 512 MB table, ten times the 50 MB L2).
//
// Design against that bound, as K1 (spmm_chunked.cu):
// * the gather is fused: at F=512 on the bench graph the padded slab would
//   be 9.2 GB written and read back; here each source row goes straight
//   from memory into registers;
// * one block per (128-row tile, F-block), one warp per output row: the
//   32 lanes read 32 neighbouring features of a row (coalesced), each lane
//   keeps VPL (at most 4: the 8-wide variant spilled) independent loads
//   in flight per slot;
// * slots are walked in order, so the first winner needs no extra
//   comparison of positions; each row is written once, with no atomics.
#include "common.cuh"

namespace pygt {
namespace {

constexpr int K4_WARPS = 8;
constexpr int POS_NONE = 1 << 30;

template <int VPL>
__global__ void __launch_bounds__(K4_WARPS * 32)
    segment_max_kernel(const float* __restrict__ src,
                       const int* __restrict__ idx,
                       const int* __restrict__ tile_ptr, int negate,
                       float* __restrict__ vals, int* __restrict__ pos,
                       int num_rows, int F) {
  const int t = blockIdx.x;
  const int f0 = blockIdx.y * (32 * VPL);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int* ptr = tile_ptr + static_cast<int64_t>(t) * PTR_SUB * TP;

  bool ok[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) ok[v] = f0 + lane + 32 * v < F;

  for (int r = warp; r < TR; r += K4_WARPS) {
    const int64_t row = static_cast<int64_t>(t) * TR + r;
    if (row >= num_rows) break;
    const int lo = ptr[r];
    const int hi = ptr[r + 1];
    float best[VPL];
    int bpos[VPL];
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      best[v] = neg_inf();
      bpos[v] = POS_NONE;
    }
    for (int base = lo; base < hi; base += 32) {
      const int n = min(32, hi - base);
      int mine = 0;
      if (lane < n) mine = idx != nullptr ? idx[base + lane] : base + lane;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int64_t c = __shfl_sync(FULL, mine, j);
        const float* s = src + c * F + f0 + lane;
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          if (!ok[v]) continue;
          const float raw = s[32 * v];
          const float m = negate ? -raw : raw;
          if (m > best[v] || (m == best[v] && bpos[v] == POS_NONE)) {
            best[v] = m;
            bpos[v] = base + j;
          }
        }
      }
    }
    float* dv = vals + row * F + f0 + lane;
    int* dp = pos + row * F + f0 + lane;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      if (ok[v]) {
        dv[32 * v] = best[v];
        dp[32 * v] = bpos[v];
      }
    }
  }
}

}  // namespace
}  // namespace pygt

// src [M, F] f32 (M >= E_pad when idx is null), idx [E_pad] int32 or null,
// tile_ptr [num_tiles, 8, 256] int32, vals [num_rows, F] f32 and
// pos [num_rows, F] int32 (written in full). Returns cudaGetLastError()
// after the launch.
extern "C" int pygt_segment_max(const void* src, const void* idx,
                                const void* tile_ptr, int negate, void* vals,
                                void* pos, int num_tiles, int num_rows, int F,
                                void* stream) {
  using namespace pygt;
  const int vpl = pick_vpl(F, 4);  // the 8-wide variant spilled
  const dim3 grid(num_tiles, (F + 32 * vpl - 1) / (32 * vpl));
  const dim3 block(K4_WARPS * 32);
  const float* s = static_cast<const float*>(src);
  const int* ix = static_cast<const int*>(idx);
  const int* tp = static_cast<const int*>(tile_ptr);
  float* v = static_cast<float*>(vals);
  int* p = static_cast<int*>(pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vpl) {
    case 1:
      segment_max_kernel<1><<<grid, block, 0, st>>>(s, ix, tp, negate, v, p,
                                                     num_rows, F);
      break;
    case 2:
      segment_max_kernel<2><<<grid, block, 0, st>>>(s, ix, tp, negate, v, p,
                                                     num_rows, F);
      break;
    default:
      segment_max_kernel<4><<<grid, block, 0, st>>>(s, ix, tp, negate, v, p,
                                                     num_rows, F);
  }
  return static_cast<int>(cudaGetLastError());
}
