// The long slot runs of K1 (spmm_chunked.cu) and K7 (spmm_range_fused.cu).
//
// A warp walking a run alone takes as long as the run: a hub row of a
// power-law graph's transpose has millions of slots, and one warp took
// 382 ms at F=349 over rows of 1.4M slots where torch.sparse.mm took 13.5
// (PERF.md). So both kernels leave a run longer than a cut length out of
// their row walk, and the wrapper cuts each such run into pieces of at
// most that length (the piece table, Pieces). walk_pieces_kernel sums each
// piece with a warp of its own, with the row walker, into a partial
// table; merge_pieces adds a row's pieces in slot order onto what the walk
// wrote. The pieces are the same in both of the walker's branches, so the
// two still give the same bits.
#pragma once

#include "row_walk.cuh"

namespace pygt {

// The cut runs of one call, as the wrapper derives them (k1_pieces,
// k7_pieces): runs of more than long_len slots, which the row walk skips.
struct Pieces {
  int long_len;
  const int* pieces;  // [num_pieces, 3]: row, first slot, end slot; a
                      // row's pieces in slot order, at most long_len each
  int num_pieces;
  const int* long_rows;  // [num_long, 3]: row, first piece, piece count
  int num_long;
  float* part;  // [num_pieces, F] scratch: each piece's sum
};

constexpr int PIECE_WARPS = 8;  // pieces (warps) of a piece-kernel block
constexpr int MERGE_WARPS = 8;  // warps of a merge block

// A block per (PIECE_WARPS pieces, slice of the row): a warp per piece,
// its sum written unscaled to row q of the partial table.
template <typename T, int W, int NV, bool GATHER, bool WEIGHTED>
__global__ void __launch_bounds__(PIECE_WARPS * 32,
                                  walk_blocks<T, W, NV, WEIGHTED>())
    walk_pieces_kernel(const T* __restrict__ x, const int* __restrict__ cols,
                       const float* __restrict__ w,
                       const int* __restrict__ pieces, int num_pieces,
                       float* __restrict__ part, int F) {
  const int q = blockIdx.x * PIECE_WARPS + (threadIdx.x >> 5);
  if (q >= num_pieces) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const RowWalk<T, W, NV, GATHER, WEIGHTED> walk(
      F, blockIdx.y * (32 * W * NV) + lane * W, lane);
  float acc[NV][W] = {};
  walk.run(x, cols, w, pieces[3 * q + 1], pieces[3 * q + 2], acc);
  walk.write(part, nullptr, q, acc);
}

// A block per (row with cut runs, 32 features): warp i adds the i-th of
// MERGE_WARPS equal runs of the row's consecutive pieces, in order, and
// warp 0 adds the warps' sums in order, times the column scale if given,
// onto what the walk wrote. Pieces in slot order, bracketed by warp: one
// thread walking a hub row's thousands of pieces alone waited on each
// load in turn.
static __global__ void __launch_bounds__(MERGE_WARPS * 32)
    merge_pieces(const int* __restrict__ long_rows,
                 const float* __restrict__ part,
                 const float* __restrict__ scale, float* __restrict__ out,
                 int F) {
  __shared__ float sums[MERGE_WARPS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f = blockIdx.y * 32 + lane;
  const int* lr = long_rows + 3 * blockIdx.x;  // (row, first piece, count)
  const int per = (lr[2] + MERGE_WARPS - 1) / MERGE_WARPS;
  const int lo = lr[1] + min(lr[2], warp * per);
  const int hi = lr[1] + min(lr[2], (warp + 1) * per);
  float acc = 0.0f;
  if (f < F) {
#pragma unroll 4
    for (int q = lo; q < hi; ++q) acc += part[static_cast<int64_t>(q) * F + f];
  }
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp != 0 || f >= F) return;
  float total = sums[0][lane];
#pragma unroll
  for (int i = 1; i < MERGE_WARPS; ++i) total += sums[i][lane];
  float* dst = out + static_cast<int64_t>(lr[0]) * F + f;
  *dst += scale != nullptr ? total * scale[f] : total;
}

// The piece kernel for the branch (W, NV) the walk took.
template <typename T, int W, int NV, bool GATHER, bool WEIGHTED>
void launch_pieces(const T* x, const int* cols, const float* w,
                   const Pieces& pc, int F, cudaStream_t st) {
  if (pc.num_pieces > 0)
    walk_pieces_kernel<T, W, NV, GATHER, WEIGHTED>
        <<<walk_grid((pc.num_pieces + PIECE_WARPS - 1) / PIECE_WARPS, F, W,
                     NV),
           PIECE_WARPS * 32, 0, st>>>(x, cols, w, pc.pieces, pc.num_pieces,
                                      pc.part, F);
}

// The merge, after the walk and the piece kernel.
inline void launch_merge(const Pieces& pc, const float* scale, float* out,
                         int F, cudaStream_t st) {
  if (pc.num_long > 0)
    merge_pieces<<<dim3(pc.num_long, (F + 31) / 32), MERGE_WARPS * 32, 0,
                   st>>>(pc.long_rows, pc.part, scale, out, F);
}

}  // namespace pygt
