// K3: sorted segment sum straight from (src [E, F], indptr), no plan.
//
// Replaces the TPU kernel pyg_lib_tpu/ops/pallas/segment_csr_kernel.py
// `_kernel` (launched by `segment_sum_csr_pallas`):
//
//   out[r, f] = sum_{e in [indptr[r], indptr[r+1]) ∩ [0, E)} src[e, f]
//
// summed in f32 and written once in src's type (f32 or bf16). Positions
// outside [indptr[0], indptr[-1]) belong to no row and are read by no warp.
// indptr is non-decreasing (the op checks a host indptr).
//
// The merge-path sum of merge_path_sum.cuh over src's rows in order: its
// bound (bytes) and its design (equal stretches of one merge path a warp,
// a cp.async ring of 16-byte copies, ordered partials of the rows a warp
// shares, no float atomics) are written there.
#include "merge_path_sum.cuh"

namespace pygt {
namespace {

template <typename T, int W, int NV>
__global__ void __launch_bounds__(msum::WARPS * 32, 1)
    k3_stream(const T* __restrict__ src, const int64_t* __restrict__ indptr,
              int64_t num_el, T* __restrict__ out, int64_t num_rows, int F,
              int units, float* __restrict__ part,
              int64_t* __restrict__ code) {
  msum::stream<T, W, NV, false>(src, nullptr, indptr, num_el, out, num_rows,
                                F, units, part, code);
}

template <typename T, int W>
__global__ void __launch_bounds__(msum::WARPS * 32, 1)
    k3_fixup(const float* __restrict__ part,
             const int64_t* __restrict__ code, int slots, T* __restrict__ out,
             int F) {
  msum::fixup<T, W>(part, code, slots, out, F);
}

}  // namespace
}  // namespace pygt

// src [num_el, F] (f32 or bf16 by dtype), indptr [num_rows + 1] int64,
// out [num_rows, F] in src's type (written in full); `units` warps share
// the work, and part [2 * units, F] f32 and code [2 * units] int64 are
// their scratch (no contents needed). Returns cudaGetLastError() after
// the two launches.
extern "C" int pygt_segment_sum_csr(const void* src, int dtype,
                                    const void* indptr, int64_t num_el,
                                    void* out, int64_t num_rows, int F,
                                    int units, void* part, void* code,
                                    void* stream) {
  using namespace pygt;
  const int64_t* ip = static_cast<const int64_t*>(indptr);
  float* pt = static_cast<float*>(part);
  int64_t* cd = static_cast<int64_t*>(code);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return msum::dispatch(src, dtype, F, units, [&](auto shape) {
    using S = decltype(shape);
    using T = typename S::Type;
    T* o = static_cast<T*>(out);
    k3_stream<T, S::w, S::nv>
        <<<msum::stream_grid(units, F, S::w * S::nv), msum::block(), 0, s>>>(
            static_cast<const T*>(src), ip, num_el, o, num_rows, F, units, pt,
            cd);
    k3_fixup<T, S::w><<<msum::fixup_grid(units, F, S::w), msum::block(), 0,
                        s>>>(pt, cd, 2 * units, o, F);
  });
}
