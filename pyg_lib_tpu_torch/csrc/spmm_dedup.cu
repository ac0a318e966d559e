// K2 and K2h: gather-fused sum over the deduplicated plan (DedupSpmmPlan).
//
// Replaces the TPU kernels pyg_lib_tpu/ops/pallas/spmm_dedup.py
// `_dedup_kernel` (launched by `_dedup_sum_tpu`) and `_dedup_kernel_hot`
// (launched by `_dedup_sum_tpu_hot`), together with the XLA gathers
// `x[uniq_cols]` and `x[hot_cols]` that feed them in `dedup_plan_apply`:
//
//   out[tile*128 + row_e] += w_e * x[uniq_cols[c*UC + lid_e]]
//       for every edge e = (row_e, lid_e, w_e) of edge_meta[c], c a chunk
//       of the tile (w_e = 1 unless the plan is weighted);
//   out[r] += sum_h hot_w[r, h] * x[hot_cols[h]]      (hot plans only)
//
// and `out *= scale` per column in int8 mode.
//
// Bound on the card: bytes. Each input read once and the output written
// once is N*F*elem + the plan tables (hot_w is T*128*H bytes in int8, 1 GiB
// at the bench shape) + rows*F*4 over 3.35 TB/s of HBM. The arithmetic is
// one multiply-add per edge and feature, far below the CUDA cores' 67
// TFLOP/s in f32 (peaks of the NVIDIA H100 SXM data sheet, at its 700 W
// power limit).
//
// Design against that bound:
// * one block per (segment of SEG consecutive chunks, F-block). A tile's
//   chunks are consecutive (chunk_tile is non-decreasing), and on a
//   power-law graph one tile can own thousands of them (the hub rows of a
//   transposed plan): cutting the chunk list into segments spreads such a
//   tile over many blocks instead of leaving one block to run it alone;
// * per chunk, the UC unique rows are gathered once into shared memory
//   (F-blocked so slab plus accumulator fit: (128 + UC) * FB * 4 bytes),
//   and every edge re-reads its row from there: the plan's reuse becomes
//   shared-memory reuse, not HBM traffic;
// * the [128, FB] accumulator lives in shared memory; edges of a chunk
//   are sorted by column, not row, so warps add into it with shared
//   atomics, and the f32 summation order varies from run to run;
// * hot plans: the block that holds a tile's first chunk adds the tile's
//   hot term. Each warp owns one row, scans its hot_w row 256 bytes at a
//   time, and finds the non-zero entries with a ballot. Only those read
//   their hot row of x (the hot slab, H*F*elem bytes, stays in L2). This
//   row scan replaces the TPU's dense [128, H] x [H, F] product, which at
//   the bench shape is 1.1 TFLOP of work for about E non-zeros;
// * when a block leaves a tile it stores the accumulator if it held all
//   of the tile's chunks, and adds it with global atomics otherwise (the
//   wrapper zero-fills the output).
#include "common.cuh"

namespace pygt {
namespace {

constexpr int K2_WARPS = 16;
constexpr int SEG = 4;  // chunks per block
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may use

template <typename H>
struct HotEntry;
template <>
struct HotEntry<int8_t> {
  static constexpr int PER = 8;  // entries per 8-byte word pair
  __device__ static float get(uint32_t w0, uint32_t w1, int k) {
    const uint32_t w = k < 4 ? w0 : w1;
    return static_cast<float>(
        static_cast<int8_t>((w >> (8 * (k & 3))) & 0xffu));
  }
};
template <>
struct HotEntry<__nv_bfloat16> {
  static constexpr int PER = 4;
  __device__ static float get(uint32_t w0, uint32_t w1, int k) {
    const uint32_t w = k < 2 ? w0 : w1;
    return __bfloat162float(__ushort_as_bfloat16(
        static_cast<unsigned short>((w >> (16 * (k & 1))) & 0xffffu)));
  }
};
template <>
struct HotEntry<float> {
  static constexpr int PER = 2;
  __device__ static float get(uint32_t w0, uint32_t w1, int k) {
    return __uint_as_float(k == 0 ? w0 : w1);
  }
};

template <typename T, typename H, int VPL>
__global__ void __launch_bounds__(K2_WARPS * 32)
    dedup_sum_kernel(const T* __restrict__ x,
                     const int* __restrict__ uniq_cols,
                     const int* __restrict__ edge_meta,
                     const int* __restrict__ chunk_tile, int num_chunks,
                     int ec, int uc, int weighted,
                     const int* __restrict__ hot_cols,
                     const H* __restrict__ hot_w, int num_hot,
                     const float* __restrict__ scale, float* __restrict__ out,
                     int num_rows, int F) {
  constexpr int FB = 32 * VPL;
  extern __shared__ float smem[];
  float* acc = smem;             // [TR, FB]
  float* slab = smem + TR * FB;  // [uc, FB]

  const int seg_lo = blockIdx.x * SEG;
  const int seg_hi = min(seg_lo + SEG, num_chunks);
  const int f0 = blockIdx.y * FB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  bool ok[VPL];
  float sc[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    ok[v] = f0 + lane + 32 * v < F;
    sc[v] = (scale != nullptr && ok[v]) ? scale[f0 + lane + 32 * v] : 1.0f;
  }

  for (int i = threadIdx.x; i < TR * FB; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();

  for (int c_lo = seg_lo; c_lo < seg_hi;) {
    const int t = chunk_tile[c_lo];
    int c_hi = c_lo + 1;
    while (c_hi < seg_hi && chunk_tile[c_hi] == t) ++c_hi;
    const bool first = c_lo == 0 || chunk_tile[c_lo - 1] != t;
    const bool whole = first && (c_hi == num_chunks || chunk_tile[c_hi] != t);
    const int rows = min(TR, num_rows - t * TR);

    // Hot level: warp-owned rows of a zeroed accumulator, so plain stores.
    if (hot_w != nullptr && first) {
      const int row_bytes = num_hot * static_cast<int>(sizeof(H));
      for (int r = warp; r < rows; r += K2_WARPS) {
        const int64_t row = static_cast<int64_t>(t) * TR + r;
        const char* hrow = reinterpret_cast<const char*>(hot_w) +
                           row * static_cast<int64_t>(row_bytes);
        float a[VPL];
#pragma unroll
        for (int v = 0; v < VPL; ++v) a[v] = 0.0f;
        for (int b0 = 0; b0 < row_bytes; b0 += 32 * 8) {
          const int off = b0 + lane * 8;
          const uint2 word = off < row_bytes
                                 ? *reinterpret_cast<const uint2*>(hrow + off)
                                 : make_uint2(0u, 0u);
          unsigned live = __ballot_sync(FULL, (word.x | word.y) != 0u);
          while (live) {
            const int l = __ffs(live) - 1;
            live &= live - 1;
            const uint32_t w0 = __shfl_sync(FULL, word.x, l);
            const uint32_t w1 = __shfl_sync(FULL, word.y, l);
#pragma unroll
            for (int k = 0; k < HotEntry<H>::PER; ++k) {
              const float w = HotEntry<H>::get(w0, w1, k);
              if (w == 0.0f) continue;
              const int h = (b0 + l * 8) / static_cast<int>(sizeof(H)) + k;
              const T* src =
                  x + static_cast<int64_t>(hot_cols[h]) * F + f0 + lane;
#pragma unroll
              for (int v = 0; v < VPL; ++v)
                if (ok[v]) a[v] += w * to_f32(src[32 * v]);
            }
          }
        }
#pragma unroll
        for (int v = 0; v < VPL; ++v) acc[r * FB + lane + 32 * v] = a[v];
      }
    }

    for (int c = c_lo; c < c_hi; ++c) {
      __syncthreads();  // the previous slab is no longer read
      const int* uq = uniq_cols + static_cast<int64_t>(c) * uc;
      for (int u = warp; u < uc; u += K2_WARPS) {
        const T* src = x + static_cast<int64_t>(uq[u]) * F + f0 + lane;
#pragma unroll
        for (int v = 0; v < VPL; ++v)
          slab[u * FB + lane + 32 * v] = ok[v] ? to_f32(src[32 * v]) : 0.0f;
      }
      __syncthreads();
      const int* meta = edge_meta + static_cast<int64_t>(c) * META_SUB * ec;
      for (int e0 = warp * 32; e0 < ec; e0 += K2_WARPS * 32) {
        const int e = e0 + lane;
        const int row = e < ec ? meta[e] : -1;  // -1 marks a pad edge
        const int lid = e < ec ? meta[ec + e] : 0;
        const float w =
            (weighted && e < ec) ? __int_as_float(meta[2 * ec + e]) : 1.0f;
        unsigned live = __ballot_sync(FULL, row >= 0);
        while (live) {
          const int l = __ffs(live) - 1;
          live &= live - 1;
          const int r = __shfl_sync(FULL, row, l);
          const int u = __shfl_sync(FULL, lid, l);
          const float wl = __shfl_sync(FULL, w, l);
#pragma unroll
          for (int v = 0; v < VPL; ++v)
            atomicAdd(&acc[r * FB + lane + 32 * v],
                      wl * slab[u * FB + lane + 32 * v]);
        }
      }
    }
    __syncthreads();

    // Leave the tile: each warp flushes and re-zeroes the rows the hot
    // level of the next tile will write, so no barrier is needed here.
    for (int r = warp; r < TR; r += K2_WARPS) {
      float* dst = out + (static_cast<int64_t>(t) * TR + r) * F + f0 + lane;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        float& s = acc[r * FB + lane + 32 * v];
        if (r < rows && ok[v]) {
          if (whole)
            dst[32 * v] = s * sc[v];
          else
            atomicAdd(dst + 32 * v, s * sc[v]);
        }
        s = 0.0f;
      }
    }
    c_lo = c_hi;
  }
}

struct Args {
  const void* x;
  const int* uniq_cols;
  const int* edge_meta;
  const int* chunk_tile;
  int num_chunks, ec, uc, weighted;
  const int* hot_cols;
  const void* hot_w;
  int num_hot;
  const float* scale;
  float* out;
  int num_rows, F;
};

template <typename T, typename H, int VPL>
cudaError_t launch_vpl(const Args& a, cudaStream_t stream) {
  constexpr int FB = 32 * VPL;
  const int smem = (TR + a.uc) * FB * static_cast<int>(sizeof(float));
  auto kernel = dedup_sum_kernel<T, H, VPL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.num_chunks + SEG - 1) / SEG, (a.F + FB - 1) / FB);
  kernel<<<grid, K2_WARPS * 32, smem, stream>>>(
      static_cast<const T*>(a.x), a.uniq_cols, a.edge_meta, a.chunk_tile,
      a.num_chunks, a.ec, a.uc, a.weighted, a.hot_cols,
      static_cast<const H*>(a.hot_w), a.num_hot, a.scale, a.out, a.num_rows,
      a.F);
  return cudaGetLastError();
}

template <typename T, typename H>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  // The widest F-block (up to 128 features) whose slab and accumulator
  // fit in one block's shared memory.
  int vpl = pick_vpl(a.F, 4);
  while (vpl > 1 && (TR + a.uc) * 32 * vpl * 4 > MAX_SMEM) vpl /= 2;
  if ((TR + a.uc) * 32 * vpl * 4 > MAX_SMEM) return cudaErrorInvalidValue;
  switch (vpl) {
    case 1:
      return launch_vpl<T, H, 1>(a, stream);
    case 2:
      return launch_vpl<T, H, 2>(a, stream);
    default:
      return launch_vpl<T, H, 4>(a, stream);
  }
}

template <typename T>
cudaError_t launch_hot(const Args& a, int hot_dtype, cudaStream_t stream) {
  switch (hot_dtype) {
    case F32:
      return launch<T, float>(a, stream);
    case BF16:
      return launch<T, __nv_bfloat16>(a, stream);
    case I8:
      return launch<T, int8_t>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace pygt

// x [N, F] (f32, bf16 or int8 by x_dtype), uniq_cols [C*uc] int32,
// edge_meta [C, 8, ec] int32, chunk_tile [C] int32 (non-decreasing),
// hot_cols [H] int32 and hot_w [num_tiles*128, H] (by hot_dtype) or both
// null, scale [F] f32 or null, out [num_rows, F] f32, zero-filled.
// Returns the CUDA error of the launch (0 on success).
extern "C" int pygt_dedup_sum(const void* x, int x_dtype,
                              const void* uniq_cols, const void* edge_meta,
                              const void* chunk_tile, int num_chunks, int ec,
                              int uc, int weighted, const void* hot_cols,
                              const void* hot_w, int hot_dtype, int num_hot,
                              const void* scale, void* out, int num_rows,
                              int F, void* stream) {
  using namespace pygt;
  const Args a{x,
               static_cast<const int*>(uniq_cols),
               static_cast<const int*>(edge_meta),
               static_cast<const int*>(chunk_tile),
               num_chunks,
               ec,
               uc,
               weighted,
               static_cast<const int*>(hot_cols),
               hot_w,
               hot_w != nullptr ? num_hot : 0,
               static_cast<const float*>(scale),
               static_cast<float*>(out),
               num_rows,
               F};
  const int hd = hot_w != nullptr ? hot_dtype : static_cast<int>(I8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (x_dtype) {
    case F32:
      err = launch_hot<float>(a, hd, s);
      break;
    case BF16:
      err = launch_hot<__nv_bfloat16>(a, hd, s);
      break;
    case I8:
      err = launch_hot<int8_t>(a, hd, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
