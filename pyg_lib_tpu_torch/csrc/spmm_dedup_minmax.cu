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
// with vals re-read from x at that slot, so its bits are the slot's own.
// A row with no edges gets (-inf, POS_NONE). -0.0 and +0.0 count as equal,
// as in the TPU kernel's comparisons: the least slot wins.
//
// Bound on the card: bytes. One compare per gathered element, far below
// the 67 TFLOP/s of f32 CUDA cores (NVIDIA H100 SXM data sheet, 700 W).
// Each input read once and each output written once is N*F*4 + the plan
// tables + rows*F*8 bytes over 3.35 TB/s of HBM.
//
// Design against that bound, and against hub tiles:
// * one block per (segment of SEG consecutive chunks, F-block), as K2. On
//   a power-law graph one tile can own thousands of chunks; a block per
//   tile would leave one block to run it alone, so tiles are cut into
//   segments and the blocks that share a tile merge their results;
// * per chunk, the UC unique rows are read once into shared memory
//   (F-blocked), and every edge reads its row from there: the plan's
//   reuse becomes shared-memory reuse, not HBM traffic;
// * the merge is exact and order-free: each candidate is one 64-bit key,
//   (order-preserving bits of the value) << 32 | (0xFFFFFFFF - slot), so
//   the largest key is the largest value and, among equal values, the
//   least slot. Both zeros map to the key of +0.0. A warp walks 32
//   row-sorted edges in order and keeps the best key of the current row
//   in registers, then merges it into the tile's [128, FB] shared
//   accumulator with a shared atomicMax; the block merges the accumulator
//   into the [N, F] key table with a global atomicMax (or a plain store
//   when it held all of the tile's chunks);
// * a second pass decodes each key into the slot and re-reads the value
//   from x, so values and slots match the TPU kernel bit for bit.
#include "common.cuh"

namespace pygt {
namespace {

using u64 = unsigned long long;

constexpr int K5_WARPS = 16;
constexpr int SEG = 4;  // chunks per block
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may use
constexpr int POS_NONE = 1 << 30;

__device__ __forceinline__ u64 merge_key(float v, int slot) {
  uint32_t u = __float_as_uint(v);
  if ((u << 1) == 0u) u = 0u;  // -0.0 -> +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<u64>(u) << 32) |
         static_cast<u64>(0xffffffffu - static_cast<uint32_t>(slot));
}

template <int VPL>
__global__ void __launch_bounds__(K5_WARPS * 32)
    dedup_max_kernel(const float* __restrict__ x,
                     const int* __restrict__ uniq_cols,
                     const int* __restrict__ edge_meta,
                     const int* __restrict__ chunk_tile, int num_chunks,
                     int ec, int uc, int negate, u64* __restrict__ keys,
                     int num_rows, int F) {
  constexpr int FB = 32 * VPL;
  extern __shared__ u64 smem[];
  u64* acc = smem;                                      // [TR, FB]
  float* slab = reinterpret_cast<float*>(smem + TR * FB);  // [uc, FB]

  const int seg_lo = blockIdx.x * SEG;
  const int seg_hi = min(seg_lo + SEG, num_chunks);
  const int f0 = blockIdx.y * FB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  bool ok[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) ok[v] = f0 + lane + 32 * v < F;

  for (int i = threadIdx.x; i < TR * FB; i += blockDim.x) acc[i] = 0ull;

  for (int c_lo = seg_lo; c_lo < seg_hi;) {
    const int t = chunk_tile[c_lo];
    int c_hi = c_lo + 1;
    while (c_hi < seg_hi && chunk_tile[c_hi] == t) ++c_hi;
    const bool first = c_lo == 0 || chunk_tile[c_lo - 1] != t;
    const bool whole = first && (c_hi == num_chunks || chunk_tile[c_hi] != t);
    const int rows = min(TR, num_rows - t * TR);

    for (int c = c_lo; c < c_hi; ++c) {
      __syncthreads();  // the previous slab is no longer read
      const int* uq = uniq_cols + static_cast<int64_t>(c) * uc;
      for (int u = warp; u < uc; u += K5_WARPS) {
        const float* src = x + static_cast<int64_t>(uq[u]) * F + f0 + lane;
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          const float raw = ok[v] ? src[32 * v] : 0.0f;
          slab[u * FB + lane + 32 * v] = negate ? -raw : raw;
        }
      }
      __syncthreads();
      const int* meta = edge_meta + static_cast<int64_t>(c) * META_SUB * ec;
      for (int e0 = warp * 32; e0 < ec; e0 += K5_WARPS * 32) {
        const int e = e0 + lane;
        const int row = e < ec ? meta[e] : TR;  // TR marks a pad edge
        const int lid = e < ec ? meta[ec + e] : 0;
        unsigned live = __ballot_sync(FULL, row < TR);
        int cur = -1;
        u64 best[VPL];
#pragma unroll
        for (int v = 0; v < VPL; ++v) best[v] = 0ull;
        while (live) {
          const int l = __ffs(live) - 1;
          live &= live - 1;
          const int r = __shfl_sync(FULL, row, l);
          const int u = __shfl_sync(FULL, lid, l);
          if (r != cur) {  // warp-uniform: r and cur come from shuffles
            if (cur >= 0) {
#pragma unroll
              for (int v = 0; v < VPL; ++v)
                if (ok[v]) atomicMax(&acc[cur * FB + lane + 32 * v], best[v]);
            }
            cur = r;
#pragma unroll
            for (int v = 0; v < VPL; ++v) best[v] = 0ull;
          }
          const int slot = c * uc + u;
#pragma unroll
          for (int v = 0; v < VPL; ++v) {
            const u64 k = merge_key(slab[u * FB + lane + 32 * v], slot);
            best[v] = k > best[v] ? k : best[v];
          }
        }
        if (cur >= 0) {
#pragma unroll
          for (int v = 0; v < VPL; ++v)
            if (ok[v]) atomicMax(&acc[cur * FB + lane + 32 * v], best[v]);
        }
      }
    }
    __syncthreads();

    // Leave the tile: each warp merges and re-zeroes its rows; the next
    // tile's first chunk starts with a barrier before any edge is merged.
    for (int r = warp; r < TR; r += K5_WARPS) {
      u64* dst = keys + (static_cast<int64_t>(t) * TR + r) * F + f0 + lane;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        u64& k = acc[r * FB + lane + 32 * v];
        if (r < rows && ok[v] && k != 0ull) {
          if (whole)
            dst[32 * v] = k;
          else
            atomicMax(dst + 32 * v, k);
        }
        k = 0ull;
      }
    }
    c_lo = c_hi;
  }
}

__global__ void dedup_decode_kernel(const u64* __restrict__ keys,
                                    const float* __restrict__ x,
                                    const int* __restrict__ uniq_cols,
                                    int negate, float* __restrict__ vals,
                                    int* __restrict__ pos, int64_t total,
                                    int F) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const u64 k = keys[i];
    if (k == 0ull) {
      vals[i] = neg_inf();
      pos[i] = POS_NONE;
      continue;
    }
    const int slot =
        static_cast<int>(0xffffffffu - static_cast<uint32_t>(k));
    const float v =
        x[static_cast<int64_t>(uniq_cols[slot]) * F + i % F];
    vals[i] = negate ? -v : v;
    pos[i] = slot;
  }
}

template <int VPL>
cudaError_t launch_vpl(const float* x, const int* uniq_cols,
                       const int* edge_meta, const int* chunk_tile,
                       int num_chunks, int ec, int uc, int negate, u64* keys,
                       int num_rows, int F, cudaStream_t stream) {
  constexpr int FB = 32 * VPL;
  const int smem = TR * FB * 8 + uc * FB * 4;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  auto kernel = dedup_max_kernel<VPL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((num_chunks + SEG - 1) / SEG, (F + FB - 1) / FB);
  kernel<<<grid, K5_WARPS * 32, smem, stream>>>(x, uniq_cols, edge_meta,
                                                chunk_tile, num_chunks, ec,
                                                uc, negate, keys, num_rows, F);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pygt

// x [N, F] f32, uniq_cols [C*uc] int32, edge_meta [C, 8, ec] int32,
// chunk_tile [C] int32 (non-decreasing), keys [num_rows, F] 64-bit,
// zero-filled (scratch), vals [num_rows, F] f32 and pos [num_rows, F] int32
// (written in full). Launches the merge kernel and the decode kernel;
// returns the first CUDA error (0 on success).
extern "C" int pygt_dedup_max(const void* x, const void* uniq_cols,
                              const void* edge_meta, const void* chunk_tile,
                              int num_chunks, int ec, int uc, int negate,
                              void* keys, void* vals, void* pos, int num_rows,
                              int F, void* stream) {
  using namespace pygt;
  const float* xf = static_cast<const float*>(x);
  const int* uq = static_cast<const int*>(uniq_cols);
  const int* meta = static_cast<const int*>(edge_meta);
  const int* ct = static_cast<const int*>(chunk_tile);
  u64* k = static_cast<u64*>(keys);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      pick_vpl(F, 2) == 1
          ? launch_vpl<1>(xf, uq, meta, ct, num_chunks, ec, uc, negate, k,
                          num_rows, F, s)
          : launch_vpl<2>(xf, uq, meta, ct, num_chunks, ec, uc, negate, k,
                          num_rows, F, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(num_rows) * F;
  const int64_t blocks = (total + 255) / 256;
  dedup_decode_kernel<<<static_cast<unsigned>(blocks < 65536 * 16
                                                  ? blocks
                                                  : 65536 * 16),
                        256, 0, s>>>(k, xf, uq, negate,
                                     static_cast<float*>(vals),
                                     static_cast<int*>(pos), total, F);
  return static_cast<int>(cudaGetLastError());
}
