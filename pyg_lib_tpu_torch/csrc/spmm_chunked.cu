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
// With `col_padded` null the same kernel reduces messages that are already
// in padded coordinates, out[r, f] = sum_p msgs[p, f] (the TPU kernel's own
// input, `segment_sum_chunked`): the padded-space sum of an attention layer
// and the row sums of the softmax backward.
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
// Design against that bound (measured in PERF.md):
// * the gather is fused: the TPU path wrote the padded message slab
//   [E_pad, F] to memory and read it back (9.2 GB in f32 at the bench
//   shape); here each x row goes straight from memory into registers;
// * a block takes one (128-row tile, 512-byte slice of the row) pair, with
//   blockIdx.x (the tile) running fastest; a warp walks its rows' slots in
//   order (row_walk.cuh, the walker K7 shares), a lane loads 16 bytes of
//   the slice per slot with one __ldg and the warp loads CHUNK slots
//   before it adds them. Column ids are read 32 at a time and broadcast
//   with shuffles. A scalar branch of the same kernel takes an x (or out,
//   or scale) address or a row pitch that does not allow 16-byte loads,
//   and rows narrower than a slice, with NV plain loads a lane over
//   32 * NV features. A ring of 1-D TMA
//   bulk copies of whole 512-feature row slices into shared memory, one
//   mbarrier a stage, lost this design's A/B on the H100 by 16%
//   (tools/time_segment.py, PERF.md);
// * each output row is written once, with no atomics and no zero fill:
//   every row of a real tile owns its (possibly empty) slot range, and
//   rows past num_rows are skipped (a cut row, below, once more). Sums
//   run in f32 in slot order, so the result is deterministic and the same
//   whichever branch runs;
// * a row of more than long_len slots (a hub row: the transpose of a Zipf
//   graph has rows of millions of edges) is left out of the walk, which
//   writes 0 there, and cut into pieces of at most long_len slots
//   (k1_pieces in the wrapper), a warp each (walk_pieces_kernel), whose
//   sums a third launch adds in slot order onto the row (merge_pieces;
//   both in row_pieces.cuh, as K7 cuts its long runs). The walk only tests
//   each row's length on bounds it reads anyway: a row that is not cut
//   gets the same bits as before the cut existed.
#include "row_pieces.cuh"
#include "row_walk.cuh"

namespace pygt {
namespace {

constexpr int K1_WARPS = 8;

template <typename T, int W, int NV, bool GATHER>
__global__ void __launch_bounds__(K1_WARPS * 32,
                                  walk_blocks<T, W, NV, false>())
    chunked_sum_kernel(const T* __restrict__ x,
                       const int* __restrict__ col_padded,
                       const int* __restrict__ tile_ptr,
                       const float* __restrict__ scale,
                       float* __restrict__ out, int num_rows, int F,
                       int long_len) {
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int* ptr = tile_ptr + static_cast<int64_t>(t) * PTR_SUB * TP;
  const RowWalk<T, W, NV, GATHER, false> walk(
      F, blockIdx.y * (32 * W * NV) + lane * W, lane);
  for (int r = warp; r < TR; r += K1_WARPS) {
    const int64_t row = static_cast<int64_t>(t) * TR + r;
    if (row >= num_rows) break;
    float acc[NV][W] = {};
    if (ptr[r + 1] - ptr[r] <= long_len)  // a longer row is cut into pieces
      walk.run(x, col_padded, nullptr, ptr[r], ptr[r + 1], acc);
    walk.write(out, scale, row, acc);
  }
}

template <typename T, bool GATHER>
void launch(const void* x, const int* col_padded, const int* tile_ptr,
            const float* scale, float* out, int num_tiles, int num_rows,
            int F, const Pieces& pc, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  walk_dispatch<T>(x, out, scale, F, [&](auto w, auto nv) {
    constexpr int W = decltype(w)::value, NV = decltype(nv)::value;
    chunked_sum_kernel<T, W, NV, GATHER>
        <<<walk_grid(num_tiles, F, W, NV), K1_WARPS * 32, 0, stream>>>(
            xt, col_padded, tile_ptr, scale, out, num_rows, F, pc.long_len);
    launch_pieces<T, W, NV, GATHER, false>(xt, col_padded, nullptr, pc, F,
                                           stream);
  });
  launch_merge(pc, scale, out, F, stream);
}

template <typename T>
void launch_any(const void* x, const int* col_padded, const int* tile_ptr,
                const float* scale, float* out, int num_tiles, int num_rows,
                int F, const Pieces& pc, cudaStream_t stream) {
  if (col_padded != nullptr)
    launch<T, true>(x, col_padded, tile_ptr, scale, out, num_tiles,
                    num_rows, F, pc, stream);
  else
    launch<T, false>(x, col_padded, tile_ptr, scale, out, num_tiles,
                     num_rows, F, pc, stream);
}

}  // namespace
}  // namespace pygt

// x [N, F] (f32, bf16 or int8 by x_dtype), col_padded [E_pad] int32 or
// null (then x is the padded messages [>= E_pad, F]), tile_ptr
// [num_tiles, 8, 256] int32, scale [F] f32 or null, out [num_rows, F] f32
// (written in full). Rows of more than long_len slots come as a derived
// table (k1_pieces in the wrapper): pieces [num_pieces, 3] int32 (row,
// first slot, end slot; at most long_len slots each, a row's in slot
// order) and long_rows [num_long, 3] int32 (row, first piece, piece
// count); part [num_pieces, F] f32 is scratch.
// Returns cudaGetLastError() after the launches.
extern "C" int pygt_spmm_chunked(const void* x, int x_dtype,
                                 const void* col_padded, const void* tile_ptr,
                                 const void* scale, void* out, int num_tiles,
                                 int num_rows, int F, int long_len,
                                 const void* pieces, int num_pieces,
                                 const void* long_rows, int num_long,
                                 void* part, void* stream) {
  using namespace pygt;
  const int* cp = static_cast<const int*>(col_padded);
  const int* tp = static_cast<const int*>(tile_ptr);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  const Pieces pc{long_len,
                  static_cast<const int*>(pieces),
                  num_pieces,
                  static_cast<const int*>(long_rows),
                  num_long,
                  static_cast<float*>(part)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case F32:
      launch_any<float>(x, cp, tp, sc, o, num_tiles, num_rows, F, pc, s);
      break;
    case BF16:
      launch_any<__nv_bfloat16>(x, cp, tp, sc, o, num_tiles, num_rows, F, pc,
                                s);
      break;
    case I8:
      launch_any<int8_t>(x, cp, tp, sc, o, num_tiles, num_rows, F, pc, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
