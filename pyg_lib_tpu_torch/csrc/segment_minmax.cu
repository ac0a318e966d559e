// K4: exact segmented max with first-winner position over the chunked plan
// (SpmmPlan), and K4s: the same pass that also sums each row.
//
// Replaces the TPU kernel pyg_lib_tpu/ops/pallas/segment_minmax_kernel.py
// `_minmax_kernel` (launched by `_minmax_padded`, driven by
// `segment_max_planned_exact`; with its `sum_ref` output, `with_sum=True`,
// driven by `segment_max_sum_planned_exact`), together with the XLA gather
// that feeds it its padded messages (`take(x, col_padded)` in `spmm`,
// `take(src, edge_perm)` in the planned `segment_max_csr` and in
// `fused_scatter_reduce`):
//
//   m_p       = s * src[p]          (idx == null: src is the padded slab)
//             = s * src[idx[p]]     (otherwise), s = -1 if negate else 1
//   vals[r,f] = max_{p in [lo_r, hi_r)} m_p[f]
//   pos[r,f]  = the least p that holds it
//   sums[r,f] = sum_{p in [lo_r, hi_r)} m_p[f]   (K4s only)
//
// where [lo_r, hi_r) = tile_ptr[t, 0, r : r + 2] are row r's padded slots.
// K4s is the template's SUM instantiation: each lane adds its values in
// slot order beside the max update, a piece writes its sum beside its
// (value, slot), and the merge adds a row's piece sums in piece order; the
// sum-less instantiation's code is unchanged. An empty row sums to 0.
// A row with no slots gets (-inf, POS_NONE). A slot is taken when its value
// is greater than the best so far, or equal to it while no slot has been
// taken: so a row whose true maximum is -inf reports its first slot, as the
// TPU kernel does through its position tie-break, and on a tie (-0.0 and
// +0.0 included) the first slot wins and its own bits are the value.
//
// Bound on the card: bytes. One compare (and for K4s one add) per gathered
// element, far below the 67 TFLOP/s of f32 CUDA cores (NVIDIA H100 SXM data
// sheet, 700 W). Each input read once and each output written once is
// N*F*4 + E_pad*4 + rows*F*8 bytes (rows*F*12 for K4s) over 3.35 TB/s of
// HBM; what the kernel really moves is
// one source row piece per slot, E*F*4 bytes, mostly from HBM at the bench
// shape (a 512 MB table, ten times the 50 MB L2).
//
// Design against that bound:
// * the gather is fused: each source row goes straight from memory into
//   registers, and the padded slab never exists;
// * a block takes one (128-row tile, slice of 128 features); blockIdx.x
//   (the tile) runs fastest. A warp walks a row's slots in order, a lane a
//   float4 of the slice, and loads CHUNK slots before it compares them,
//   with 16-byte loads. Narrower slices, whose slice of x would stay in
//   L2, and slot groups that split a warp over a row's slots lost this
//   design's A/B (tools/time_segment.py on the H100, PERF.md): their
//   merges and per-row work cost more than their L2 hits saved;
// * a row of more than LONG slots is cut into pieces of LONG slots (a
//   table the wrapper derives), one warp each in blocks past the tiles,
//   each written to a partial table; a second launch merges a row's pieces
//   in order by the rule: a taken slot beats POS_NONE, the greater value
//   wins, an equal value with the smaller slot wins. The rule is
//   associative and keeps the first winner and its bits;
// * each row is written once, with no atomics. A scalar branch of the same
//   kernel takes an F or a src address that does not allow float4, over
//   a slice of 32, 64 or 128 features (the least that holds F).
#include "common.cuh"

namespace pygt {
namespace {

constexpr int K4_WARPS = 8;
constexpr int POS_NONE = 1 << 30;
constexpr int LONG = 512;  // slots above which a row is cut (K4_LONG)
constexpr int CHUNK = 4;   // slots loaded before they are compared

template <int W>
struct Load;

template <>
struct Load<4> {
  static __device__ __forceinline__ void get(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};

template <>
struct Load<1> {
  static __device__ __forceinline__ void get(const float* p, float* v) {
    v[0] = __ldg(p);
  }
};

// A warp's (best, pos), and with SUM its sums, for its NV vectors of W
// features a lane: a slice of 32 * W * NV features.
template <int W, int NV, bool SUM>
struct K4 {
  static constexpr int FW = 32 * W * NV;

  float best[NV][W];
  int bpos[NV][W];
  float acc[NV][W];

  // Slots [lo, hi) of one row (or piece), in order, with the first-winner
  // update: a slot is taken when its value is greater than the best so
  // far, or equal to it while no slot has been taken.
  __device__ __forceinline__ void run(const float* __restrict__ src,
                                      const int* __restrict__ idx, int lo,
                                      int hi, int negate, int F, int fl,
                                      const bool (&ok)[NV], int lane) {
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int k = 0; k < W; ++k) {
        best[v][k] = neg_inf();
        bpos[v][k] = POS_NONE;
        if constexpr (SUM) acc[v][k] = 0.0f;
      }
    for (int base = lo; base < hi; base += 32) {
      const int n = min(32, hi - base);
      int mine = 0;
      if (lane < n) mine = idx != nullptr ? idx[base + lane] : base + lane;
#pragma unroll
      for (int s0 = 0; s0 < 32; s0 += CHUNK) {
        if (s0 >= n) break;  // the same for the whole warp
        float raw[CHUNK][NV][W];
#pragma unroll
        for (int s = 0; s < CHUNK; ++s) {
          const int64_t c = __shfl_sync(FULL, mine, s0 + s);
          const float* p = src + c * F + fl;
#pragma unroll
          for (int v = 0; v < NV; ++v)
            if (s0 + s < n && ok[v]) Load<W>::get(p + v * 32 * W, raw[s][v]);
        }
#pragma unroll
        for (int s = 0; s < CHUNK; ++s) {
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            if (!(s0 + s < n && ok[v])) continue;
#pragma unroll
            for (int k = 0; k < W; ++k) {
              const float m = negate ? -raw[s][v][k] : raw[s][v][k];
              if constexpr (SUM) acc[v][k] += m;
              if (m > best[v][k] ||
                  (m == best[v][k] && bpos[v][k] == POS_NONE)) {
                best[v][k] = m;
                bpos[v][k] = base + s0 + s;
              }
            }
          }
        }
      }
    }
  }

  __device__ __forceinline__ void write(float* __restrict__ vals,
                                        int* __restrict__ pos,
                                        float* __restrict__ sums, int64_t row,
                                        int F, int fl,
                                        const bool (&ok)[NV]) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (!ok[v]) continue;
      const int64_t at = row * F + fl + v * 32 * W;
      if constexpr (W == 4) {
        *reinterpret_cast<float4*>(vals + at) =
            make_float4(best[v][0], best[v][1], best[v][2], best[v][3]);
        *reinterpret_cast<int4*>(pos + at) =
            make_int4(bpos[v][0], bpos[v][1], bpos[v][2], bpos[v][3]);
        if constexpr (SUM)
          *reinterpret_cast<float4*>(sums + at) =
              make_float4(acc[v][0], acc[v][1], acc[v][2], acc[v][3]);
      } else {
        vals[at] = best[v][0];
        pos[at] = bpos[v][0];
        if constexpr (SUM) sums[at] = acc[v][0];
      }
    }
  }
};

// Blocks [0, num_tiles) take a tile each, a warp per row of up to LONG
// slots; the blocks past them take a piece of a longer row per warp,
// written to the partial tables. sums and part_sum are read only with SUM.
template <int W, int NV, bool SUM>
__global__ void __launch_bounds__(K4_WARPS * 32, 1)
    segment_max_kernel(const float* __restrict__ src,
                       const int* __restrict__ idx,
                       const int* __restrict__ tile_ptr, int negate,
                       float* __restrict__ vals, int* __restrict__ pos,
                       float* __restrict__ sums, int num_tiles, int num_rows,
                       int F, const int* __restrict__ pieces, int num_pieces,
                       float* __restrict__ part_val,
                       int* __restrict__ part_pos,
                       float* __restrict__ part_sum) {
  using S = K4<W, NV, SUM>;
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int fl = blockIdx.y * S::FW + lane * W;  // lane's first feature
  bool ok[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) ok[v] = fl + v * 32 * W < F;
  S st;
  if (t >= num_tiles) {
    const int q = (t - num_tiles) * K4_WARPS + warp;
    if (q >= num_pieces) return;
    st.run(src, idx, pieces[3 * q + 1], pieces[3 * q + 2], negate, F, fl, ok,
           lane);
    st.write(part_val, part_pos, part_sum, q, F, fl, ok);
    return;
  }
  const int* ptr = tile_ptr + static_cast<int64_t>(t) * PTR_SUB * TP;
  for (int r = warp; r < TR; r += K4_WARPS) {
    const int64_t row = static_cast<int64_t>(t) * TR + r;
    if (row >= num_rows) break;
    const int lo = ptr[r];
    const int hi = ptr[r + 1];
    if (hi - lo > LONG) continue;  // cut into pieces
    st.run(src, idx, lo, hi, negate, F, fl, ok, lane);
    st.write(vals, pos, sums, row, F, fl, ok);
  }
}

// Takes (ov, op) over (bv, bp) by the merge rule.
__device__ __forceinline__ void merge(float& bv, int& bp, float ov, int op) {
  if (op != POS_NONE && (bp == POS_NONE || ov > bv || (ov == bv && op < bp))) {
    bv = ov;
    bp = op;
  }
}

// One thread per (row longer than LONG slots, feature): the row's pieces
// merged in order, the result written to (vals, pos); with SUM the piece
// sums are added in piece order and written to sums.
template <bool SUM>
__global__ void segment_max_pieces(const int* __restrict__ long_rows,
                                   const float* __restrict__ part_val,
                                   const int* __restrict__ part_pos,
                                   const float* __restrict__ part_sum,
                                   float* __restrict__ vals,
                                   int* __restrict__ pos,
                                   float* __restrict__ sums, int F) {
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const int* lr = long_rows + 3 * blockIdx.x;  // (row, first piece, count)
  float bv = neg_inf();
  int bp = POS_NONE;
  float total = 0.0f;
  for (int q = lr[1]; q < lr[1] + lr[2]; ++q) {
    const int64_t at = static_cast<int64_t>(q) * F + f;
    merge(bv, bp, part_val[at], part_pos[at]);
    if constexpr (SUM) total += part_sum[at];
  }
  const int64_t out = static_cast<int64_t>(lr[0]) * F + f;
  vals[out] = bv;
  pos[out] = bp;
  if constexpr (SUM) sums[out] = total;
}

template <int W, int NV, bool SUM>
void launch(const float* s, const int* ix, const int* tp, int negate,
            float* v, int* p, float* sm, int num_tiles, int num_rows, int F,
            const int* pieces, int num_pieces, float* part_val, int* part_pos,
            float* part_sum, cudaStream_t st) {
  constexpr int FW = K4<W, NV, SUM>::FW;
  const dim3 grid(num_tiles + (num_pieces + K4_WARPS - 1) / K4_WARPS,
                  (F + FW - 1) / FW);
  segment_max_kernel<W, NV, SUM><<<grid, K4_WARPS * 32, 0, st>>>(
      s, ix, tp, negate, v, p, sm, num_tiles, num_rows, F, pieces,
      num_pieces, part_val, part_pos, part_sum);
}

// Both launches of one call: the tile and piece pass with the branch F and
// the src address allow, then the merge of the long rows' pieces.
template <bool SUM>
int run(const void* src, const void* idx, const void* tile_ptr, int negate,
        void* vals, void* pos, void* sums, int num_tiles, int num_rows, int F,
        const void* pieces, int num_pieces, const void* long_rows,
        int num_long, void* part_val, void* part_pos, void* part_sum,
        void* stream) {
  const float* s = static_cast<const float*>(src);
  const int* ix = static_cast<const int*>(idx);
  const int* tp = static_cast<const int*>(tile_ptr);
  const int* pc = static_cast<const int*>(pieces);
  float* v = static_cast<float*>(vals);
  int* p = static_cast<int*>(pos);
  float* sm = static_cast<float*>(sums);
  float* pv = static_cast<float*>(part_val);
  int* pp = static_cast<int*>(part_pos);
  float* ps = static_cast<float*>(part_sum);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && F % 4 == 0) {
    launch<4, 1, SUM>(s, ix, tp, negate, v, p, sm, num_tiles, num_rows, F,
                      pc, num_pieces, pv, pp, ps, st);
  } else {  // a slice as narrow as F allows: fewer registers, more warps
    switch (pick_vpl(F, 4)) {
      case 1:
        launch<1, 1, SUM>(s, ix, tp, negate, v, p, sm, num_tiles, num_rows,
                          F, pc, num_pieces, pv, pp, ps, st);
        break;
      case 2:
        launch<1, 2, SUM>(s, ix, tp, negate, v, p, sm, num_tiles, num_rows,
                          F, pc, num_pieces, pv, pp, ps, st);
        break;
      default:
        launch<1, 4, SUM>(s, ix, tp, negate, v, p, sm, num_tiles, num_rows,
                          F, pc, num_pieces, pv, pp, ps, st);
    }
  }
  if (num_long > 0) {
    const dim3 grid(num_long, (F + 127) / 128);
    segment_max_pieces<SUM><<<grid, 128, 0, st>>>(
        static_cast<const int*>(long_rows), pv, pp, ps, v, p, sm, F);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace pygt

// src [M, F] f32 (M >= E_pad when idx is null), idx [E_pad] int32 or null,
// tile_ptr [num_tiles, 8, 256] int32, vals [num_rows, F] f32 and
// pos [num_rows, F] int32 (written in full). The rows longer than LONG
// slots come as a derived table (k4_pieces in the wrapper): pieces
// [num_pieces, 3] int32 (row, first slot, end slot), LONG slots each but
// a row's last, a row's pieces in order, and long_rows [num_long, 3] int32
// (row, first piece, piece count); part_val [num_pieces, F] f32 and
// part_pos [num_pieces, F] int32 are scratch. Returns cudaGetLastError()
// after the launches.
extern "C" int pygt_segment_max(const void* src, const void* idx,
                                const void* tile_ptr, int negate, void* vals,
                                void* pos, int num_tiles, int num_rows, int F,
                                const void* pieces, int num_pieces,
                                const void* long_rows, int num_long,
                                void* part_val, void* part_pos,
                                void* stream) {
  return pygt::run<false>(src, idx, tile_ptr, negate, vals, pos, nullptr,
                          num_tiles, num_rows, F, pieces, num_pieces,
                          long_rows, num_long, part_val, part_pos, nullptr,
                          stream);
}

// K4s: as pygt_segment_max, and sums [num_rows, F] f32 (written in full)
// with part_sum [num_pieces, F] f32 scratch beside part_val.
extern "C" int pygt_segment_max_sum(const void* src, const void* idx,
                                    const void* tile_ptr, int negate,
                                    void* vals, void* pos, void* sums,
                                    int num_tiles, int num_rows, int F,
                                    const void* pieces, int num_pieces,
                                    const void* long_rows, int num_long,
                                    void* part_val, void* part_pos,
                                    void* part_sum, void* stream) {
  return pygt::run<true>(src, idx, tile_ptr, negate, vals, pos, sums,
                         num_tiles, num_rows, F, pieces, num_pieces,
                         long_rows, num_long, part_val, part_pos, part_sum,
                         stream);
}
