// K5: gather-fused exact max over the dedup min/max plan (DedupMinmaxPlan).
//
// Replaces the TPU kernel pyg_lib_tpu/ops/pallas/spmm_dedup_minmax.py
// `_dedup_minmax_kernel` (launched by `_dedup_minmax_tpu`, driven by
// `dedup_minmax_apply`), together with the XLA gather `x[uniq_cols]` that
// feeds it:
//
//   m_e       = s * x[uniq_cols[c*UC + lid_e]]   for every edge e of chunk c
//               (s = -1 if negate else 1), going to row tile*128 + row_e
//   vals[r,f] = max over the edges of row r of m_e[f]
//   pos[r,f]  = the least unique slot c*UC + lid_e that holds it
//
// with vals carrying that slot's own bits. A row with no edges gets (-inf,
// POS_NONE). -0.0 and +0.0 count as equal, as in the TPU kernel's
// comparisons: the least slot wins.
//
// Bound on the card: bytes. One compare per gathered element, far below
// the 67 TFLOP/s of f32 CUDA cores (NVIDIA H100 SXM data sheet, 700 W).
// Each input read once and each output written once is N*F*4 + the plan
// tables + rows*F*8 bytes over 3.35 TB/s of HBM; what the kernel really
// moves is each chunk's used unique rows (about 3.0 GB at the bench shape,
// six times x, partly from L2) and the outputs once.
//
// Design against that bound:
// * one block per (unit, F-block of K5_FB features), a unit being a tile's
//   chunks, walked in
//   order: the block keeps the tile's [128, FB] (value, slot) accumulator
//   in shared memory from its first chunk to its last and writes vals and
//   pos straight from it, once, with no atomics and no [N, F] scratch. A
//   tile's F-blocks are neighbouring blocks, so whole x rows are read at
//   about the same time. Only a tile of more than K5_SEG chunks (a hub
//   tile; the wrapper derives the unit table) is cut into units of K5_SEG
//   chunks, each writing its accumulator to a partial table sized by the
//   cut tiles alone; a second launch merges each cut tile's partials in
//   order;
// * per chunk, the used unique rows are copied once into shared memory by
//   cp.async, 16 bytes a copy where F and x allow it (else 4), each warp
//   loading its rows' columns at once, and every edge reads its row from
//   there: the plan's reuse becomes shared-memory reuse, not HBM traffic.
//   The walk's edge runs are found while the copies are on their way;
// * the winner is carried, not re-read: a chunk's edges of one row come in
//   increasing slot order (the plan sorts them by column, and the wrapper
//   checks it), and chunks in slot order, so "the greater value, or the
//   first one taken" is "the least slot among the maxima", and the value
//   is the slot's own bits (-0.0 and +0.0 compare equal as floats). A
//   chunk's real edges are cut into about equal runs, a warp each, at row
//   starts, so a warp owns its rows in the chunk and updates the
//   accumulator without atomics; it fetches ILP edges' rows, slots and
//   values at a time and keeps the current row's best in registers. With
//   negate the walk keeps the least x, the first of equals, and writes it
//   negated: the greatest -x, the least slot, -x's bits.
#include "common.cuh"

namespace pygt {
namespace {

constexpr int K5_WARPS = 16;
constexpr int K5_FB = 64;         // features a block takes (F-block)
constexpr int ILP = 8;            // edges a warp fetches together
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may use
constexpr int POS_NONE = 1 << 30;

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
                 "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying the chunk's n used unique rows, F-block slice [f0, f0 +
// FB) of x, into slab [uc, FB]: W = 4 floats a copy (F % 4 == 0 and x
// 16-byte aligned) or 1. Warp w takes rows w, w + K5_WARPS, ...: its lanes
// load up to 32 of their columns at once, then start the rows' copies,
// 32 / LPR rows an instruction.
template <int FB, int W>
__device__ __forceinline__ void stage(const float* __restrict__ x,
                                      const int* __restrict__ uq, int n,
                                      int F, int f0, float* slab, int warp,
                                      int lane) {
  constexpr int PER_ROW = FB / W;                      // copies a row
  constexpr int LPR = PER_ROW < 32 ? PER_ROW : 32;     // lanes a row
  constexpr int RPI = 32 / LPR;                        // rows an instruction
  const int sub = lane / LPR, kl = lane % LPR;
  for (int base = warp; base < n; base += K5_WARPS * 32) {
    const int mine = base + K5_WARPS * lane;
    const int col_of = mine < n ? uq[mine] : 0;
    const int cnt = min(32, (n - base + K5_WARPS - 1) / K5_WARPS);
    for (int j0 = 0; j0 < cnt; j0 += RPI) {
      const int j = j0 + sub;
      const int r = __shfl_sync(FULL, col_of, j & 31);
      if (j >= cnt) continue;
      float* dst = slab + (base + K5_WARPS * j) * FB;
      const float* src = x + static_cast<int64_t>(r) * F + f0;
#pragma unroll
      for (int k = kl; k < PER_ROW; k += LPR)
        if (f0 + k * W < F) cp_async(dst + k * W, src + k * W, 4 * W);
    }
  }
}

// The least edge e >= s of a chunk's n real (row-sorted) edges that starts
// a row (e == 0, e == n, or its row differs from edge e - 1's).
__device__ __forceinline__ int row_start(const int* __restrict__ meta, int s,
                                         int n, int lane) {
  if (s <= 0) return 0;
  for (int b = s; b < n; b += 32) {
    const int e = b + lane;
    const bool starts = e >= n || meta[e] != meta[e - 1];
    const unsigned m = __ballot_sync(FULL, starts);
    if (m) return b + __ffs(m) - 1;
  }
  return n;
}

// units [U, 4] int32: tile, first chunk, end chunk, partial index (-1: the
// unit is its tile's only one, and writes vals and pos); chunks [C, 2]
// int32: each chunk's real edges and used unique slots. Block b takes
// F-block b % nfb of unit b / nfb: the blocks of one tile run together and
// read whole x rows between them. NEG (negate): the walk keeps the least
// x, the first of equals, and writes it negated: the greatest -x.
template <int FB, int W, bool NEG>
__global__ void __launch_bounds__(K5_WARPS * 32)
    k5_units(const float* __restrict__ x, const int* __restrict__ uniq_cols,
             const int* __restrict__ edge_meta,
             const int* __restrict__ units, const int* __restrict__ chunks,
             int ec, int uc, float* __restrict__ vals,
             int* __restrict__ pos, float* __restrict__ part_val,
             int* __restrict__ part_pos, int num_rows, int F, int nfb) {
  constexpr int VPL = FB / 32;
  extern __shared__ float smem[];
  float* acc_v = smem;                                     // [TR, FB]
  int* acc_p = reinterpret_cast<int*>(smem + TR * FB);      // [TR, FB]
  float* slab = smem + 2 * TR * FB;                        // [uc, FB]

  const int* un = units + 4 * static_cast<int64_t>(blockIdx.x / nfb);
  const int t = un[0], c_lo = un[1], c_hi = un[2], p = un[3];
  const int f0 = (blockIdx.x % nfb) * FB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  bool ok[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) ok[v] = f0 + lane + 32 * v < F;
  // b beats a (a taken at an earlier slot)
  auto beats = [](float b, float a) { return NEG ? b < a : b > a; };

  for (int i = threadIdx.x; i < TR * FB; i += blockDim.x) {
    acc_v[i] = NEG ? -neg_inf() : neg_inf();
    acc_p[i] = POS_NONE;
  }

  for (int c = c_lo; c < c_hi; ++c) {
    stage<FB, W>(x, uniq_cols + static_cast<int64_t>(c) * uc,
                 chunks[2 * c + 1], F, f0, slab, warp, lane);
    cp_async_commit();
    // While the rows are on their way: the chunk's real edges (row-sorted,
    // before its pad edges) in about equal runs, one a warp, each cut where
    // a row starts, and the run's first 32 edges.
    const int n = chunks[2 * c];
    const int* meta = edge_meta + static_cast<int64_t>(c) * META_SUB * ec;
    const int per = (n + K5_WARPS - 1) / K5_WARPS;
    const int e_lo = row_start(meta, warp * per, n, lane);
    const int e_hi = row_start(meta, min(n, (warp + 1) * per), n, lane);
    // Each edge's unique id and row, packed: lid << 8 | row (row < 128).
    int edge = e_lo + lane < e_hi
                   ? meta[ec + e_lo + lane] << 8 | meta[e_lo + lane]
                   : 0;
    cp_async_wait<0>();
    __syncthreads();  // every thread's copies of chunk c have landed
    int cur = -1;
    float bv[VPL];
    int bp[VPL];
    // The current row's best into the accumulator, whose slots are all
    // less (earlier chunks): it wins only by a better value.
    auto flush = [&]() {
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int at = cur * FB + lane + 32 * v;
        if (ok[v] && (acc_p[at] == POS_NONE || beats(bv[v], acc_v[at]))) {
          acc_v[at] = bv[v];
          acc_p[at] = bp[v];
        }
      }
    };
    for (int e0 = e_lo; e0 < e_hi; e0 += 32) {
      if (e0 > e_lo) {
        const int e = e0 + lane;
        edge = e < e_hi ? meta[ec + e] << 8 | meta[e] : 0;
      }
      const int count = min(32, e_hi - e0);
      for (int j = 0; j < count; j += ILP) {
        int r[ILP], u[ILP];
        float m[ILP][VPL];
#pragma unroll
        for (int q = 0; q < ILP; ++q) {
          const int packed = __shfl_sync(FULL, edge, (j + q) & 31);
          r[q] = packed & 0xff;
          u[q] = packed >> 8;
#pragma unroll
          for (int v = 0; v < VPL; ++v)
            m[q][v] = slab[u[q] * FB + lane + 32 * v];
        }
#pragma unroll
        for (int q = 0; q < ILP; ++q) {
          if (j + q >= count) break;  // the same for the whole warp
          const int slot = c * uc + u[q];
          if (r[q] != cur) {  // a row's first edge in the run is taken
            if (cur >= 0) flush();
            cur = r[q];
#pragma unroll
            for (int v = 0; v < VPL; ++v) {
              bv[v] = m[q][v];
              bp[v] = slot;
            }
            continue;
          }
#pragma unroll
          for (int v = 0; v < VPL; ++v)
            if (beats(m[q][v], bv[v])) {
              bv[v] = m[q][v];
              bp[v] = slot;
            }
        }
      }
    }
    if (cur >= 0) flush();
    __syncthreads();  // the slab is free for a later chunk
  }

  // Leave the tile: its rows, F-block slice by slice, consecutive threads
  // on consecutive features.
  const int rows = min(TR, num_rows - t * TR);
  const int fw = min(FB, F - f0);
  float* ov = p >= 0 ? part_val + static_cast<int64_t>(p) * TR * F
                     : vals + static_cast<int64_t>(t) * TR * F;
  int* op = p >= 0 ? part_pos + static_cast<int64_t>(p) * TR * F
                   : pos + static_cast<int64_t>(t) * TR * F;
  for (int i = threadIdx.x; i < rows * FB; i += blockDim.x) {
    const int r = i / FB, f = i % FB;
    if (f >= fw) continue;
    const int64_t at = static_cast<int64_t>(r) * F + f0 + f;
    ov[at] = NEG ? __int_as_float(__float_as_int(acc_v[i]) ^ 0x80000000)
                 : acc_v[i];
    op[at] = acc_p[i];
  }
}

// merges [M, 3] int32: a cut tile, its first partial, its partial count.
// One thread per (row, feature) of the tile takes the partials in order
// (their slots rise with the partial): a later one wins only by a greater
// value.
__global__ void k5_merge(const int* __restrict__ merges,
                         const float* __restrict__ part_val,
                         const int* __restrict__ part_pos,
                         float* __restrict__ vals, int* __restrict__ pos,
                         int num_rows, int F) {
  const int* m = merges + 3 * static_cast<int64_t>(blockIdx.x);
  const int t = m[0], first = m[1], count = m[2];
  const int rows = min(TR, num_rows - t * TR);
  const int64_t i = static_cast<int64_t>(blockIdx.y) * blockDim.x +
                    threadIdx.x;
  if (i >= static_cast<int64_t>(rows) * F) return;
  float bv = neg_inf();
  int bp = POS_NONE;
  for (int q = first; q < first + count; ++q) {
    const int64_t at = static_cast<int64_t>(q) * TR * F + i;
    const int op = part_pos[at];
    const float ov = part_val[at];
    if (op != POS_NONE && (bp == POS_NONE || ov > bv)) {
      bv = ov;
      bp = op;
    }
  }
  const int64_t at = static_cast<int64_t>(t) * TR * F + i;
  vals[at] = bv;
  pos[at] = bp;
}

struct Args {
  const float* x;
  const int *uq, *meta, *units, *chunks;
  int num_units, ec, uc;
  float* part_val;
  int* part_pos;
  float* vals;
  int* pos;
  int num_rows, F;
};

template <int FB, int W, bool NEG>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = k5_units<FB, W, NEG>;
  const int smem = TR * FB * 8 + a.uc * FB * 4;  // accumulator, slab
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nfb = (a.F + FB - 1) / FB;
  kernel<<<static_cast<unsigned>(a.num_units) * nfb, K5_WARPS * 32, smem,
           stream>>>(a.x, a.uq, a.meta, a.units, a.chunks, a.ec, a.uc,
                     a.vals, a.pos, a.part_val, a.part_pos, a.num_rows, a.F,
                     nfb);
  return cudaGetLastError();
}

template <int W, bool NEG>
cudaError_t launch_fb(const Args& a, int fb, cudaStream_t stream) {
  return fb == K5_FB ? launch<K5_FB, W, NEG>(a, stream)
                     : launch<K5_FB / 2, W, NEG>(a, stream);
}

}  // namespace
}  // namespace pygt

// x [N, F] f32, uniq_cols [C*uc] int32, edge_meta [C, 8, ec] int32 (a
// chunk's edges of one row in increasing unique slot); the derived tables
// (k5_units in the wrapper): units [num_units, 4] int32 (tile, first
// chunk, end chunk, partial index or -1), every tile's chunks in order,
// chunks [C, 2] int32 (real edges, used unique slots), and merges
// [num_merges, 3] int32 (cut tile, first partial, partial count);
// part_val [partials, 128, F] f32 and part_pos [partials, 128, F] int32
// scratch (null when no tile is cut); vals [num_rows, F] f32 and pos
// [num_rows, F] int32 (written in full). The F-block is K5_FB features, or
// half that where F needs no more or shared memory holds no more. Returns
// the first CUDA error (0 on success).
extern "C" int pygt_dedup_max(const void* x, const void* uniq_cols,
                              const void* edge_meta, const void* units,
                              int num_units, const void* chunks,
                              const void* merges, int num_merges, int ec,
                              int uc, int negate, void* part_val,
                              void* part_pos, void* vals, void* pos,
                              int num_rows, int F, void* stream) {
  using namespace pygt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int fb = 32 * pick_vpl(F, K5_FB / 32);
  if (fb == K5_FB && TR * fb * 8 + uc * fb * 4 > MAX_SMEM) fb /= 2;
  if (TR * fb * 8 + uc * fb * 4 > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(x),
               static_cast<const int*>(uniq_cols),
               static_cast<const int*>(edge_meta),
               static_cast<const int*>(units),
               static_cast<const int*>(chunks),
               num_units, ec, uc, static_cast<float*>(part_val),
               static_cast<int*>(part_pos), static_cast<float*>(vals),
               static_cast<int*>(pos), num_rows, F};
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && F % 4 == 0;
  cudaError_t err =
      vec ? (negate ? launch_fb<4, true>(a, fb, s)
                    : launch_fb<4, false>(a, fb, s))
          : (negate ? launch_fb<1, true>(a, fb, s)
                    : launch_fb<1, false>(a, fb, s));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_merges > 0) {
    const dim3 grid(num_merges, (TR * F + 255) / 256);
    k5_merge<<<grid, 256, 0, s>>>(static_cast<const int*>(merges),
                                  a.part_val, a.part_pos, a.vals, a.pos,
                                  num_rows, F);
  }
  return static_cast<int>(cudaGetLastError());
}
