// K7: fused multi-range SpMM over S column ranges (FusedRangePlan).
//
// Replaces the TPU kernel pyg_lib_tpu/ops/pallas/spmm_range_fused.py
// `_fused_kernel` (launched by `_fused_call`, driven by `fused_range_apply`)
// together with the S per-range XLA gathers `take(x[lo_s:hi_s],
// col_padded_s)` and weight products that feed it:
//
//   out[r, f] = scale[f] * sum_s sum_{p in [lo_rs, hi_rs)}
//                 w[p] * x[cols[p], f]
//
// where [lo_rs, hi_rs) = slot_base[s] + tile_ptrs[t, s, r : r + 2] are row
// r's slots in range s (r local to its 128-row tile t), `cols` holds every
// range's padded column ids one after another with lo_s already added, `w`
// the weights laid out the same way (null: all 1) and `scale` the int8
// column scale (null: 1), applied once at the end.
//
// The per-range arrays come concatenated at build time (one device array
// each, and each range's first slot in `slot_base`), not as S pointers. A
// range with no edges in a tile has no chunks there: its rows' slot ranges
// in that tile are empty, so they add nothing. The TPU's step tables
// (`step_tile`, `blocks`, `posb`) are its grid schedule and are not read.
//
// Bound on the card: bytes. One multiply-add per gathered element, far
// below the 67 TFLOP/s of f32 CUDA cores (NVIDIA H100 SXM data sheet, 700 W).
// Each input read once and each output written once is N*F*elem + the
// slot tables + rows*F*4 bytes over the 3.35 TB/s of HBM; what the kernel
// really moves is one x row per edge, E*F*elem bytes.
//
// Design against that bound, K1's (spmm_chunked.cu) over S slot runs:
// * the gathers are fused: the TPU path wrote S padded message slabs;
// * a block takes one (128-row tile, 512-byte slice of the row) pair; a
//   warp walks each of its rows' S slot ranges in turn with K1's walker
//   (row_walk.cuh): 16-byte loads a lane, CHUNK slots in flight, column
//   ids and weights read 32 at a time and broadcast with shuffles, and
//   the same scalar branch for addresses or row pitches that do not allow
//   16-byte loads and for rows narrower than a slice;
// * each output row is written once, after its last range, with no atomics
//   and no partial [N, F] outputs (a row with a cut run, below, once
//   more): sums run in f32 in range and slot order, so the result is
//   deterministic;
// * a row's slot run in one range of more than long_len slots (a hub row:
//   the transpose of a Zipf graph has rows of over a million edges) is
//   left out of the row's walk and cut into pieces of at most long_len
//   slots (k7_pieces in the wrapper), a warp each, by a second kernel
//   whose sums go to a partial table; a third adds each such row's
//   pieces in order, scaled, to what the walk wrote (both kernels in
//   row_pieces.cuh, which K1 shares). A warp walking such
//   a row alone took 382 ms at F=349 where torch.sparse.mm took 13.5
//   (PERF.md). The walk itself only tests each run's length, on bounds it
//   reads anyway, and the pieces are the same in both branches, so the
//   two still give the same bits.
#include "row_pieces.cuh"
#include "row_walk.cuh"

namespace pygt {
namespace {

constexpr int K7_WARPS = 8;

// A block per (tile, slice of the row): a warp per row, its ranges' runs
// of up to long_len slots.
template <typename T, int W, int NV, bool WEIGHTED>
__global__ void __launch_bounds__(K7_WARPS * 32,
                                  walk_blocks<T, W, NV, WEIGHTED>())
    range_fused_kernel(const T* __restrict__ x, const int* __restrict__ cols,
                       const float* __restrict__ w,
                       const int* __restrict__ tile_ptrs,
                       const int* __restrict__ slot_base, int S, int S8,
                       const float* __restrict__ scale,
                       float* __restrict__ out, int num_rows, int F,
                       int long_len) {
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int* ptrs = tile_ptrs + static_cast<int64_t>(t) * S8 * TP;
  const RowWalk<T, W, NV, true, WEIGHTED> walk(
      F, blockIdx.y * (32 * W * NV) + lane * W, lane);
  for (int r = warp; r < TR; r += K7_WARPS) {
    const int64_t row = static_cast<int64_t>(t) * TR + r;
    if (row >= num_rows) break;
    float acc[NV][W] = {};
    for (int s = 0; s < S; ++s) {
      const int* ptr = ptrs + s * TP;
      const int b = slot_base[s];
      const int lo = ptr[r], hi = ptr[r + 1];
      if (hi - lo <= long_len)  // a longer run is cut into pieces
        walk.run(x, cols, w, b + lo, b + hi, acc);
    }
    walk.write(out, scale, row, acc);
  }
}

template <typename T, bool WEIGHTED>
void launch(const void* x, const int* cols, const float* w,
            const int* tile_ptrs, const int* slot_base, int S, int S8,
            const float* scale, float* out, int num_tiles, int num_rows,
            int F, const Pieces& pc, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  walk_dispatch<T>(x, out, scale, F, [&](auto wv, auto nv) {
    constexpr int W = decltype(wv)::value, NV = decltype(nv)::value;
    range_fused_kernel<T, W, NV, WEIGHTED>
        <<<walk_grid(num_tiles, F, W, NV), K7_WARPS * 32, 0, st>>>(
            xt, cols, w, tile_ptrs, slot_base, S, S8, scale, out, num_rows,
            F, pc.long_len);
    launch_pieces<T, W, NV, true, WEIGHTED>(xt, cols, w, pc, F, st);
  });
  launch_merge(pc, scale, out, F, st);
}

template <typename T>
void launch_any(const void* x, const int* cols, const float* w,
                const int* tile_ptrs, const int* slot_base, int S, int S8,
                const float* scale, float* out, int num_tiles, int num_rows,
                int F, const Pieces& pc, cudaStream_t st) {
  if (w != nullptr)
    launch<T, true>(x, cols, w, tile_ptrs, slot_base, S, S8, scale, out,
                    num_tiles, num_rows, F, pc, st);
  else
    launch<T, false>(x, cols, w, tile_ptrs, slot_base, S, S8, scale, out,
                     num_tiles, num_rows, F, pc, st);
}

}  // namespace
}  // namespace pygt

// x [N, F] (f32, bf16 or int8 by x_dtype), cols [sum E_pad_s] int32 (global
// column ids), w like cols f32 or null, tile_ptrs [num_tiles, S8, 256]
// int32, slot_base [S] int32, scale [F] f32 or null, out [num_rows, F] f32
// (written in full). A row's slot runs of more than long_len slots in
// one range come as a derived table (k7_pieces in the wrapper): pieces
// [num_pieces, 3] int32 (row, first slot, end slot; at most long_len
// slots each), a row's pieces in range and slot order, and long_rows
// [num_long, 3] int32 (row, first piece, piece count) for each row with
// such a run; part [num_pieces, F] f32 is scratch.
// Returns cudaGetLastError() after the launches.
extern "C" int pygt_spmm_range_fused(const void* x, int x_dtype,
                                     const void* cols, const void* w,
                                     const void* tile_ptrs,
                                     const void* slot_base, int S, int S8,
                                     const void* scale, void* out,
                                     int num_tiles, int num_rows, int F,
                                     int long_len, const void* pieces,
                                     int num_pieces, const void* long_rows,
                                     int num_long, void* part, void* stream) {
  using namespace pygt;
  const int* c = static_cast<const int*>(cols);
  const float* wt = static_cast<const float*>(w);
  const int* tp = static_cast<const int*>(tile_ptrs);
  const int* sb = static_cast<const int*>(slot_base);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  const Pieces pc{long_len,
                  static_cast<const int*>(pieces),
                  num_pieces,
                  static_cast<const int*>(long_rows),
                  num_long,
                  static_cast<float*>(part)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case F32:
      launch_any<float>(x, c, wt, tp, sb, S, S8, sc, o, num_tiles, num_rows,
                        F, pc, st);
      break;
    case BF16:
      launch_any<__nv_bfloat16>(x, c, wt, tp, sb, S, S8, sc, o, num_tiles,
                                num_rows, F, pc, st);
      break;
    case I8:
      if (wt != nullptr) return static_cast<int>(cudaErrorInvalidValue);
      launch<int8_t, false>(x, c, wt, tp, sb, S, S8, sc, o, num_tiles,
                            num_rows, F, pc, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
