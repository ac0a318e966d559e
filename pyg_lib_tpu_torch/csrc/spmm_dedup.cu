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
// Bound on the card: bytes. x read once, the tables (for a hot plan the
// row list of hot_w's non-zeros below, 8 bytes an entry, in place of the
// dense hot_w) and the output written once, over 3.35 TB/s of HBM. The
// arithmetic is one multiply-add per edge and feature, far below the CUDA
// cores' 67 TFLOP/s in f32 (peaks of the NVIDIA H100 SXM data sheet, at
// its 700 W power limit).
//
// The kernels read two tables the wrapper derives from the plan once and
// caches (ops/kernels/spmm_dedup.py `cold_edges`, `hot_list`); the plan
// stays the JAX package's. Design against the bound (not the TPU
// kernel's block structure):
// * cold chunks: the chunk list is cut into equal contiguous ranges, as
//   many as WAVES times the blocks the card holds at once (SM count times
//   blocks per SM), divided by the F-blocks. A tile's chunks are
//   consecutive (chunk_tile is non-decreasing), so a hub tile of
//   thousands of chunks (the transpose plan of a power-law graph) is
//   shared by tens of blocks;
// * per chunk, its unique rows of x are copied into a shared slab with
//   cp.async, and every edge re-reads its row from there: the plan's
//   reuse becomes shared-memory reuse, not HBM traffic. The chunk's edges
//   and unique ids come the same way, and the next chunk's copies run
//   while this chunk's edges accumulate (two buffers of each, one barrier
//   per chunk), so no global load stands between a barrier and the work.
//   FB, the F-block, is the widest up to 64 features whose shared memory
//   fits: at 128, one block of 16 warps fills an SM and cannot hide the
//   copies. A plan whose uc leaves no room for two slabs at 32 features
//   runs with one, the next chunk's rows copied after this chunk's sum;
// * a chunk's edges come sorted by row and are split evenly over the
//   warps. A warp sums a run of edges into one row in registers and adds
//   it to the [128, FB] shared accumulator once, with a plain add inside
//   its share and a shared atomic (a compare-and-swap loop on this card)
//   for its first and last run, whose row a neighbouring warp may hold;
// * when a block leaves a tile it writes the accumulator: every row with
//   plain stores if it held all of the tile's chunks, else with global
//   atomics. A tile shared between blocks is zeroed first by a small
//   kernel, one block per range boundary inside a tile. So the cold pass
//   writes every row, and nothing is zero-filled as a whole (a zero-fill
//   cost K2h 0.16 ms at the bench shape; flushing only the rows a block
//   touched, tracked by row flags, was no faster);
// * the hot term (K2h) then reads a row list, not hot_w: hot_ptr [R + 1],
//   hot_src [nnz] (the row of x, hot_cols resolved) and hot_val [nnz] (the
//   count or weight sum, exact in f32). A warp owns a row and an F-slice
//   of up to 512 features (lanes across F, up to 16 values a lane, as
//   float4 for f32), walks the row's list once, reads each listed row of
//   x (the hot rows stay in L2) and adds the sum onto the row the cold
//   pass wrote. It replaces the TPU's dense hot_w[tile] @ hot_slab, 1.1
//   TFLOP at the bench shape for 2.8M non-zeros.
#include <type_traits>

#include "common.cuh"

namespace pygt {
namespace {

constexpr int K2_WARPS = 16;   // warps of a cold-pass block
constexpr int HOT_WARPS = 4;   // warps (rows) of a hot-pass block
constexpr int WAVES = 8;       // cold blocks per block the card holds at once
constexpr int MAX_SMEM = 232448;  // shared memory a block may use

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// First chunk of range b of nb equal ranges over c chunks (nb <= c, so
// no range is empty).
__device__ __forceinline__ int range_lo(int b, int nb, int c) {
  return static_cast<int>(static_cast<int64_t>(b) * c / nb);
}

// The hot term: one warp per (row, F-slice of 32 * VPL features), added
// onto the row the cold pass wrote (its load issued first).
template <typename T, int VPL>
__global__ void __launch_bounds__(HOT_WARPS * 32)
    hot_rows_kernel(const T* __restrict__ x, const int* __restrict__ hot_ptr,
                    const int* __restrict__ hot_src,
                    const float* __restrict__ hot_val,
                    const float* __restrict__ scale, float* __restrict__ out,
                    int num_rows, int F) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * HOT_WARPS + (threadIdx.x >> 5);
  if (row >= num_rows) return;  // the whole warp
  const int f0 = blockIdx.y * 32 * VPL + lane;
  float* o = out + static_cast<int64_t>(row) * F + f0;
  float acc[VPL], cold[VPL];
  bool ok[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    acc[v] = 0.0f;
    ok[v] = f0 + 32 * v < F;
    cold[v] = ok[v] ? o[32 * v] : 0.0f;
  }
  const int lo = hot_ptr[row];
  const int hi = hot_ptr[row + 1];
  for (int base = lo; base < hi; base += 32) {
    const int n = min(32, hi - base);
    const int src = lane < n ? hot_src[base + lane] : 0;
    const float w = lane < n ? hot_val[base + lane] : 0.0f;
#pragma unroll 2
    for (int l = 0; l < n; ++l) {
      const int s = __shfl_sync(FULL, src, l);
      const float wl = __shfl_sync(FULL, w, l);
      const T* p = x + static_cast<int64_t>(s) * F + f0;
#pragma unroll
      for (int v = 0; v < VPL; ++v)
        if (ok[v]) acc[v] = fmaf(wl, to_f32(p[32 * v]), acc[v]);
    }
  }
#pragma unroll
  for (int v = 0; v < VPL; ++v)
    if (ok[v])
      o[32 * v] = cold[v] + (scale != nullptr ? acc[v] * scale[f0 + 32 * v]
                                              : acc[v]);
}

// The hot term for f32 rows whose F is a multiple of 4 (16-byte aligned):
// as hot_rows_kernel, with lanes on float4 groups, VPL / 4 of them.
template <int VPL>
__global__ void __launch_bounds__(HOT_WARPS * 32)
    hot_rows_f4_kernel(const float* __restrict__ x,
                       const int* __restrict__ hot_ptr,
                       const int* __restrict__ hot_src,
                       const float* __restrict__ hot_val,
                       const float* __restrict__ scale,
                       float* __restrict__ out, int num_rows, int F) {
  constexpr int Q = VPL / 4;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * HOT_WARPS + (threadIdx.x >> 5);
  if (row >= num_rows) return;  // the whole warp
  const int f0 = blockIdx.y * 32 * VPL + 4 * lane;
  float4* o = reinterpret_cast<float4*>(out + static_cast<int64_t>(row) * F +
                                        f0);
  float4 acc[Q], cold[Q];
  bool ok[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    acc[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    ok[q] = f0 + 128 * q < F;
    cold[q] = ok[q] ? o[32 * q] : acc[q];
  }
  const int lo = hot_ptr[row];
  const int hi = hot_ptr[row + 1];
  for (int base = lo; base < hi; base += 32) {
    const int n = min(32, hi - base);
    const int src = lane < n ? hot_src[base + lane] : 0;
    const float w = lane < n ? hot_val[base + lane] : 0.0f;
#pragma unroll 2
    for (int l = 0; l < n; ++l) {
      const int s = __shfl_sync(FULL, src, l);
      const float wl = __shfl_sync(FULL, w, l);
      const float4* p = reinterpret_cast<const float4*>(
          x + static_cast<int64_t>(s) * F + f0);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (!ok[q]) continue;
        const float4 v = p[32 * q];
        acc[q].x = fmaf(wl, v.x, acc[q].x);
        acc[q].y = fmaf(wl, v.y, acc[q].y);
        acc[q].z = fmaf(wl, v.z, acc[q].z);
        acc[q].w = fmaf(wl, v.w, acc[q].w);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (!ok[q]) continue;
    float4 sc = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    if (scale != nullptr)
      sc = *reinterpret_cast<const float4*>(scale + f0 + 128 * q);
    o[32 * q] = make_float4(cold[q].x + acc[q].x * sc.x,
                            cold[q].y + acc[q].y * sc.y,
                            cold[q].z + acc[q].z * sc.z,
                            cold[q].w + acc[q].w * sc.w);
  }
}

// Zero the tiles that straddle a range boundary: block b - 1 takes the
// boundary between ranges b - 1 and b, and only the first boundary inside
// a tile zeroes it.
__global__ void zero_shared_tiles_kernel(const int* __restrict__ chunk_tile,
                                         int num_chunks, int num_ranges,
                                         float* __restrict__ out,
                                         int num_rows, int F) {
  const int b = blockIdx.x + 1;
  const int lo = range_lo(b, num_ranges, num_chunks);
  const int t = chunk_tile[lo];
  if (chunk_tile[lo - 1] != t) return;
  const int prev = range_lo(b - 1, num_ranges, num_chunks);
  if (chunk_tile[prev] == t && prev > 0 && chunk_tile[prev - 1] == t) return;
  const int64_t n = static_cast<int64_t>(min(TR, num_rows - t * TR)) * F;
  float* dst = out + static_cast<int64_t>(t) * TR * F;
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) dst[i] = 0.0f;
}

// Shared memory of a cold-pass block (bytes): the accumulator, `slabs`
// slabs (1 or 2), two copies of a chunk's unique column ids, two of its
// edges (packed codes and, if weighted, weights).
template <typename T>
int cold_smem(int vpl, int slabs, int uc, int ec, bool weighted) {
  const int fb = 32 * vpl;
  return TR * fb * 4 + slabs * uc * fb * static_cast<int>(sizeof(T)) +
         2 * uc * 4 + 2 * (weighted ? 2 : 1) * ec * 4;
}

// The cold chunks: one block per (chunk range, F-block of 32 * VPL).
// Chunk c's edges are edge_code[edge_ptr[c] : edge_ptr[c + 1]], sorted by
// row, each (unique id << 7 | local row), at most ec of them; they name
// its first num_uniq[c] unique ids (the rest pad the chunk). copy_bytes
// is the cp.async width of the slab copies (16, 8 or 4; 0 copies with
// plain loads where a row of x is not 4-byte aligned). With two slabs the
// next chunk's rows are copied while this chunk's edges accumulate; with
// one (a plan whose uc leaves no room for two) they are copied after.
template <typename T, int VPL>
__global__ void __launch_bounds__(K2_WARPS * 32)
    cold_chunks_kernel(const T* __restrict__ x,
                       const int* __restrict__ uniq_cols,
                       const int* __restrict__ chunk_tile, int num_chunks,
                       int num_ranges, int uc,
                       const int* __restrict__ edge_ptr,
                       const int* __restrict__ edge_code,
                       const float* __restrict__ edge_w,
                       const int* __restrict__ num_uniq, int ec,
                       int copy_bytes, bool two_slabs,
                       const float* __restrict__ scale,
                       float* __restrict__ out, int num_rows, int F) {
  constexpr int FB = 32 * VPL;
  constexpr int THREADS = K2_WARPS * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const bool weighted = edge_w != nullptr;
  const int sm = two_slabs ? 1 : 0;  // chunk c's slab: c & sm
  float* acc = reinterpret_cast<float*>(smem);            // [TR, FB]
  T* slabs = reinterpret_cast<T*>(acc + TR * FB);         // [1 or 2, uc, FB]
  int* uniqs =
      reinterpret_cast<int*>(slabs + (sm + 1) * uc * FB);  // [2, uc]
  int* codes = uniqs + 2 * uc;                            // [2, ec]
  float* ws = reinterpret_cast<float*>(codes + 2 * ec);   // [2, ec] or none

  const int c_lo = range_lo(blockIdx.x, num_ranges, num_chunks);
  const int c_hi = range_lo(blockIdx.x + 1, num_ranges, num_chunks);
  const int f0 = blockIdx.y * FB;
  const int fw = min(FB, F - f0);  // features of this F-block
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  bool ok[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) ok[v] = lane + 32 * v < fw;
  // In the flush, thread i holds column i % FB of every (THREADS / FB)-th
  // row.
  const int fj = threadIdx.x % FB;
  const bool fok = fj < fw;
  const float fsc = (scale != nullptr && fok) ? scale[f0 + fj] : 1.0f;

  for (int i = threadIdx.x; i < TR * FB; i += THREADS) acc[i] = 0.0f;

  // Chunk c's nu unique rows (features [f0, f0 + fw), from its unique ids
  // in shared memory) and its edges [e_lo, e_hi) into slab c & sm and
  // buffer c & 1.
  auto gather = [&](int c, int nu, int e_lo, int e_hi) {
    const int* uq = uniqs + (c & 1) * uc;
    T* slab = slabs + (c & sm) * uc * FB;
    if (copy_bytes != 0) {
      const int per_row = FB * static_cast<int>(sizeof(T)) / copy_bytes;
      const int live = fw * static_cast<int>(sizeof(T));
      for (int i = threadIdx.x; i < nu * per_row; i += THREADS) {
        const int u = i / per_row;
        const int k = (i - u * per_row) * copy_bytes;
        if (k >= live) continue;
        const char* src = reinterpret_cast<const char*>(
                              x + static_cast<int64_t>(uq[u]) * F + f0) + k;
        cp_async(reinterpret_cast<char*>(slab + u * FB) + k, src, copy_bytes);
      }
    } else {
      for (int i = threadIdx.x; i < nu * FB; i += THREADS) {
        const int u = i / FB;
        const int j = i - u * FB;
        if (j < fw) slab[i] = x[static_cast<int64_t>(uq[u]) * F + f0 + j];
      }
    }
    for (int k = threadIdx.x; k < e_hi - e_lo; k += THREADS) {
      cp_async(codes + (c & 1) * ec + k, edge_code + e_lo + k, 4);
      if (weighted) cp_async(ws + (c & 1) * ec + k, edge_w + e_lo + k, 4);
    }
  };
  auto fetch_uniq = [&](int c) {
    const int* src = uniq_cols + static_cast<int64_t>(c) * uc;
    for (int k = threadIdx.x; k < uc; k += THREADS)
      cp_async(uniqs + (c & 1) * uc + k, src + k, 4);
  };

  // Write the accumulator into tile t and clear it: plain stores if the
  // block holds all of the tile's chunks, else atomics.
  auto flush = [&](int t, bool shared) {
    const int rows = min(TR, num_rows - t * TR);
    float* dst = out + static_cast<int64_t>(t) * TR * F + f0 + fj;
#pragma unroll 4
    for (int r = threadIdx.x / FB; r < TR; r += THREADS / FB) {
      float& s = acc[r * FB + fj];
      if (fok && r < rows) {
        if (!shared)
          dst[static_cast<int64_t>(r) * F] = s * fsc;
        else
          atomicAdd(dst + static_cast<int64_t>(r) * F, s * fsc);
      }
      s = 0.0f;
    }
  };

  // Prologue: chunk c_lo's unique ids, then its slab and edges and the
  // next chunk's unique ids. p0..p2: edge_ptr[c .. c + 2], n1: num_uniq[c
  // + 1], kept ahead in registers so no global load waits between a
  // barrier and the copies.
  fetch_uniq(c_lo);
  cp_async_commit();
  int p0 = edge_ptr[c_lo];
  int p1 = edge_ptr[c_lo + 1];
  int p2 = c_lo + 1 < c_hi ? edge_ptr[c_lo + 2] : p1;
  int n1 = c_lo + 1 < c_hi ? num_uniq[c_lo + 1] : 0;
  const int n0 = num_uniq[c_lo];
  cp_async_wait_all();
  __syncthreads();
  gather(c_lo, n0, p0, p1);
  if (c_lo + 1 < c_hi) fetch_uniq(c_lo + 1);
  cp_async_commit();

  int t = chunk_tile[c_lo];  // tile held in the accumulator
  bool t_shared = c_lo > 0 && chunk_tile[c_lo - 1] == t;
  for (int c = c_lo; c < c_hi; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c's slab and edges are in; c - 1 is summed
    const int tn = c + 1 < c_hi ? chunk_tile[c + 1] : -1;
    const int p3 = c + 2 < c_hi ? edge_ptr[c + 3] : p2;
    const int n2 = c + 2 < c_hi ? num_uniq[c + 2] : 0;
    auto prefetch = [&] {
      if (c + 1 < c_hi) {
        gather(c + 1, n1, p1, p2);
        if (c + 2 < c_hi) fetch_uniq(c + 2);
      }
      cp_async_commit();
    };
    if (two_slabs) prefetch();

    // The chunk's n edges, in row order, split evenly over the warps. A
    // run of edges into one row sums in registers and is added once:
    // with a plain add inside the warp's share (no other warp holds that
    // row), with a shared atomic for its first and last run, whose row a
    // neighbouring warp may hold too.
    const T* slab = slabs + (c & sm) * uc * FB;
    const int* code = codes + (c & 1) * ec;
    const float* wt = ws + (c & 1) * ec;
    const int n = p1 - p0;
    const int e_end = (warp + 1) * n / K2_WARPS;
    int cur = -1;
    bool first = true;
    float run[VPL];
    auto add_run = [&](bool atomic) {
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        if (!ok[v]) continue;
        float* a = &acc[cur * FB + lane + 32 * v];
        if (atomic)
          atomicAdd(a, run[v]);
        else
          *a += run[v];
      }
    };
    for (int base = warp * n / K2_WARPS; base < e_end; base += 32) {
      const int m = min(32, e_end - base);
      const int pk = lane < m ? code[base + lane] : 0;
      const float wv = (weighted && lane < m) ? wt[base + lane] : 1.0f;
#pragma unroll 1
      for (int l = 0; l < m; ++l) {
        const int k = __shfl_sync(FULL, pk, l);
        const float wl = __shfl_sync(FULL, wv, l);
        const int r = k & (TR - 1);
        const int u = k >> 7;
        if (r != cur) {
          if (cur >= 0) {
            add_run(first);
            first = false;
          }
          cur = r;
#pragma unroll
          for (int v = 0; v < VPL; ++v) run[v] = 0.0f;
        }
#pragma unroll
        for (int v = 0; v < VPL; ++v)
          run[v] = fmaf(wl, to_f32(slab[u * FB + lane + 32 * v]), run[v]);
      }
    }
    if (cur >= 0) add_run(true);

    if (tn != t) {  // leave tile t after chunk c
      __syncthreads();
      flush(t, t_shared || (tn == -1 && c_hi < num_chunks &&
                            chunk_tile[c_hi] == t));
      t = tn;
      t_shared = false;
    }
    if (!two_slabs) {
      __syncthreads();  // chunk c's slab is read
      prefetch();
    }
    p0 = p1;
    p1 = p2;
    p2 = p3;
    n1 = n2;
  }
}

struct Args {
  const void* x;
  const int* uniq_cols;
  const int* chunk_tile;
  int num_chunks, uc;
  const int* edge_ptr;
  const int* edge_code;
  const float* edge_w;
  const int* num_uniq;
  int ec;
  const int* hot_ptr;
  const int* hot_src;
  const float* hot_val;
  const float* scale;
  float* out;
  int num_rows, F;
};

template <typename T, int VPL>
cudaError_t launch_hot(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.num_rows + HOT_WARPS - 1) / HOT_WARPS,
                  (a.F + 32 * VPL - 1) / (32 * VPL));
  const uintptr_t align = reinterpret_cast<uintptr_t>(a.x) |
                          reinterpret_cast<uintptr_t>(a.out) |
                          reinterpret_cast<uintptr_t>(a.scale);
  if constexpr (std::is_same<T, float>::value && VPL >= 4) {
    if (a.F % 4 == 0 && align % 16 == 0) {
      hot_rows_f4_kernel<VPL><<<grid, HOT_WARPS * 32, 0, stream>>>(
          static_cast<const float*>(a.x), a.hot_ptr, a.hot_src, a.hot_val,
          a.scale, a.out, a.num_rows, a.F);
      return cudaGetLastError();
    }
  }
  hot_rows_kernel<T, VPL><<<grid, HOT_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(a.x), a.hot_ptr, a.hot_src, a.hot_val, a.scale,
      a.out, a.num_rows, a.F);
  return cudaGetLastError();
}

template <typename T, int VPL>
cudaError_t launch_cold(const Args& a, int slabs, cudaStream_t stream) {
  constexpr int FB = 32 * VPL;
  const int smem = cold_smem<T>(VPL, slabs, a.uc, a.ec, a.edge_w != nullptr);
  auto kernel = cold_chunks_kernel<T, VPL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      K2_WARPS * 32, smem);
  if (err != cudaSuccess) return err;
  const int fblocks = (a.F + FB - 1) / FB;
  const int64_t want =
      (static_cast<int64_t>(WAVES) * sms * (per_sm > 0 ? per_sm : 1) +
       fblocks - 1) / fblocks;
  const int ranges = static_cast<int>(
      want < 1 ? 1 : (want > a.num_chunks ? a.num_chunks : want));
  // Byte width of the slab copies: the widest that divides a row of x
  // and its start.
  const int row_bytes = a.F * static_cast<int>(sizeof(T));
  const uintptr_t base = reinterpret_cast<uintptr_t>(a.x);
  int copy_bytes = 0;
  for (int cb = 16; cb >= 4 && copy_bytes == 0; cb /= 2)
    if (row_bytes % cb == 0 && base % cb == 0) copy_bytes = cb;
  if (ranges > 1) {
    zero_shared_tiles_kernel<<<ranges - 1, 256, 0, stream>>>(
        a.chunk_tile, a.num_chunks, ranges, a.out, a.num_rows, a.F);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  kernel<<<dim3(ranges, fblocks), K2_WARPS * 32, smem, stream>>>(
      static_cast<const T*>(a.x), a.uniq_cols, a.chunk_tile, a.num_chunks,
      ranges, a.uc, a.edge_ptr, a.edge_code, a.edge_w, a.num_uniq, a.ec,
      copy_bytes, slabs == 2, a.scale, a.out, a.num_rows, a.F);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  // The cold pass writes every row; for a hot plan the hot pass then adds
  // onto them. The cold pass's F-block: the widest, up to 64 features
  // (128 holds one block of 16 warps on an SM, too few to hide the
  // copies), for which two slabs fit; one slab at 32 features if two do
  // not.
  const bool weighted = a.edge_w != nullptr;
  int vpl = pick_vpl(a.F, 2), slabs = 2;
  while (cold_smem<T>(vpl, slabs, a.uc, a.ec, weighted) > MAX_SMEM) {
    if (vpl > 1)
      vpl /= 2;
    else if (slabs == 2)
      slabs = 1;
    else
      return cudaErrorInvalidValue;
  }
  const cudaError_t err = vpl == 1 ? launch_cold<T, 1>(a, slabs, stream)
                                   : launch_cold<T, 2>(a, slabs, stream);
  if (err != cudaSuccess || a.hot_ptr == nullptr) return err;
  switch (pick_vpl(a.F, 16)) {
    case 1:
      return launch_hot<T, 1>(a, stream);
    case 2:
      return launch_hot<T, 2>(a, stream);
    case 4:
      return launch_hot<T, 4>(a, stream);
    case 8:
      return launch_hot<T, 8>(a, stream);
    default:
      return launch_hot<T, 16>(a, stream);
  }
}

}  // namespace
}  // namespace pygt

// x [N, F] (f32, bf16 or int8 by x_dtype), uniq_cols [C*uc] int32,
// chunk_tile [C] int32 (non-decreasing, every tile has a chunk); the cold
// edges edge_ptr [C + 1] int32, edge_code [E] int32 (per chunk sorted by
// row, unique id << 7 | local row, at most ec a chunk), edge_w [E] f32 or
// null and num_uniq [C] int32 (the unique ids a chunk's edges name);
// hot_ptr [num_tiles*128 + 1] int32, hot_src [nnz] int32 and hot_val
// [nnz] f32 (the row list of hot_w's non-zeros) or all three null;
// scale [F] f32 or null; out [num_rows, F] f32 (need not be zeroed).
// Returns the CUDA error of the launches (0 on success).
extern "C" int pygt_dedup_sum(const void* x, int x_dtype,
                              const void* uniq_cols, const void* chunk_tile,
                              int num_chunks, int uc, const void* edge_ptr,
                              const void* edge_code, const void* edge_w,
                              const void* num_uniq, int ec,
                              const void* hot_ptr,
                              const void* hot_src, const void* hot_val,
                              const void* scale, void* out, int num_rows,
                              int F, void* stream) {
  using namespace pygt;
  const Args a{x,
               static_cast<const int*>(uniq_cols),
               static_cast<const int*>(chunk_tile),
               num_chunks,
               uc,
               static_cast<const int*>(edge_ptr),
               static_cast<const int*>(edge_code),
               static_cast<const float*>(edge_w),
               static_cast<const int*>(num_uniq),
               ec,
               static_cast<const int*>(hot_ptr),
               static_cast<const int*>(hot_src),
               static_cast<const float*>(hot_val),
               static_cast<const float*>(scale),
               static_cast<float*>(out),
               num_rows,
               F};
  if (num_chunks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (x_dtype) {
    case F32:
      err = launch<float>(a, s);
      break;
    case BF16:
      err = launch<__nv_bfloat16>(a, s);
      break;
    case I8:
      err = launch<int8_t>(a, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
