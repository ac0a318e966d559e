// The backward of the padded-batch models' row gather x[min(row, N-1)]:
//
//   grad_x[r, f] = sum_{p in [indptr[r], indptr[r+1])} g[perm[p], f]
//
// where perm sorts the E edges stably by source row min(row, N-1) and
// indptr [N + 1] holds each row's first sorted position (the wrapper,
// ops/kernels/gather_rows.py, makes both with a device sort). Summed in
// f32 in edge order and written once in g's type (f32 or bf16); every row
// is written, with zeros where no edge reads it.
//
// Replaces no TPU kernel: the JAX package's gather is jnp.take, an XLA
// gather whose transpose XLA writes. It replaces PyTorch's backward of
// x[idx] (indexing_backward_kernel), which walks each row's duplicates
// one after another in one warp: a padded batch clamps all its pad edges
// (17-18% of a products batch) onto row N-1, and one warp walked them all.
//
// Bound on the card: bytes, E*F*elem of g and E*8 of perm read, N*F*elem
// written, over 3.35 TB/s. It is merge_path_sum.cuh's sum read through
// perm: equal stretches of one merge path a warp, so a row read by many
// edges (the pad row, a hub source) is shared by as many warps as its
// length asks; cp.async copies of whole g rows in flight; the partials of
// a shared row added in slot order by a second launch. No atomics and no
// memset: the same batch gives the same bits every run. g[perm] is never
// written out.
#include "merge_path_sum.cuh"

namespace pygt {
namespace {

template <typename T, int W, int NV>
__global__ void __launch_bounds__(msum::WARPS * 32, 1)
    gather_rows_bwd_stream(const T* __restrict__ g,
                           const int64_t* __restrict__ perm,
                           const int64_t* __restrict__ indptr,
                           int64_t num_el, T* __restrict__ out,
                           int64_t num_rows, int F, int units,
                           float* __restrict__ part,
                           int64_t* __restrict__ code) {
  msum::stream<T, W, NV, true>(g, perm, indptr, num_el, out, num_rows, F,
                               units, part, code);
}

template <typename T, int W>
__global__ void __launch_bounds__(msum::WARPS * 32, 1)
    gather_rows_bwd_fixup(const float* __restrict__ part,
                          const int64_t* __restrict__ code, int slots,
                          T* __restrict__ out, int F) {
  msum::fixup<T, W>(part, code, slots, out, F);
}

}  // namespace
}  // namespace pygt

// g [num_el, F] (f32 or bf16 by dtype), perm [num_el] int64 (entries in
// [0, num_el)), indptr [num_rows + 1] int64 over perm's positions,
// out [num_rows, F] in g's type (written in full); `units` warps share the
// work, and part [2 * units, F] f32 and code [2 * units] int64 are their
// scratch (no contents needed). Returns cudaGetLastError() after the two
// launches.
extern "C" int pygt_gather_rows_backward(const void* g, int dtype,
                                         const void* perm, const void* indptr,
                                         int64_t num_el, void* out,
                                         int64_t num_rows, int F, int units,
                                         void* part, void* code,
                                         void* stream) {
  using namespace pygt;
  const int64_t* pm = static_cast<const int64_t*>(perm);
  const int64_t* ip = static_cast<const int64_t*>(indptr);
  float* pt = static_cast<float*>(part);
  int64_t* cd = static_cast<int64_t*>(code);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return msum::dispatch(g, dtype, F, units, [&](auto shape) {
    using S = decltype(shape);
    using T = typename S::Type;
    T* o = static_cast<T*>(out);
    gather_rows_bwd_stream<T, S::w, S::nv>
        <<<msum::stream_grid(units, F, S::w * S::nv), msum::block(), 0, s>>>(
            static_cast<const T*>(g), pm, ip, num_el, o, num_rows, F, units,
            pt, cd);
    gather_rows_bwd_fixup<T, S::w><<<msum::fixup_grid(units, F, S::w),
                                     msum::block(), 0, s>>>(pt, cd, 2 * units,
                                                            o, F);
  });
}
