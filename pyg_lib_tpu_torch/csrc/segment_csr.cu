// K3: sorted segment sum straight from (src [E, F], indptr), no plan.
//
// Replaces the TPU kernel pyg_lib_tpu/ops/pallas/segment_csr_kernel.py
// `_kernel` (launched by `segment_sum_csr_pallas`):
//
//   out[r, f] = sum_{e in [indptr[r], indptr[r+1]) ∩ [0, E)} src[e, f]
//
// summed in f32 and written in src's type (f32 or bf16). Positions outside
// [indptr[0], indptr[-1]) belong to no row.
//
// Bound on the card: bytes. One add per element read, far below the
// 67 TFLOP/s of f32 CUDA cores (NVIDIA H100 SXM data sheet, 700 W). Each
// input read once and each output written once is E*F*elem + (R+1)*8 +
// R*F*elem bytes over 3.35 TB/s of HBM, and the kernel reads each src row
// exactly once, in order.
//
// Design against that bound:
// * one warp per output row, the 32 lanes over neighbouring features
//   (coalesced), each lane VPL features, one block per (8 rows, F-block);
//   a row's src rows are contiguous, so the warp streams them and keeps
//   several rows' loads in flight;
// * each row is written once, with no atomics and no zero fill. A long
//   row serialises one warp: at the bench shape rows hold about 16 edges,
//   but a hub row of a power-law CSR would hold one warp for its whole
//   length (a split over several warps is later work).
#include "common.cuh"

namespace pygt {
namespace {

constexpr int K3_WARPS = 8;

template <typename T, int VPL>
__global__ void __launch_bounds__(K3_WARPS * 32)
    segment_sum_csr_kernel(const T* __restrict__ src,
                           const int64_t* __restrict__ indptr,
                           int64_t num_el, T* __restrict__ out,
                           int64_t num_rows, int F) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * K3_WARPS + (threadIdx.x >> 5);
  if (row >= num_rows) return;
  const int lane = threadIdx.x & 31;
  const int f0 = blockIdx.y * (32 * VPL);
  bool ok[VPL];
  float acc[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    ok[v] = f0 + lane + 32 * v < F;
    acc[v] = 0.0f;
  }
  int64_t lo = indptr[row];
  int64_t hi = indptr[row + 1];
  lo = lo < 0 ? 0 : (lo > num_el ? num_el : lo);
  hi = hi > num_el ? num_el : hi;
  const T* s = src + lo * F + f0 + lane;
#pragma unroll 4
  for (int64_t e = lo; e < hi; ++e, s += F) {
#pragma unroll
    for (int v = 0; v < VPL; ++v)
      if (ok[v]) acc[v] += to_f32(s[32 * v]);
  }
  T* dst = out + row * F + f0 + lane;
#pragma unroll
  for (int v = 0; v < VPL; ++v)
    if (ok[v]) dst[32 * v] = from_f32<T>(acc[v]);
}

template <typename T>
void launch(const void* src, const int64_t* indptr, int64_t num_el,
            void* out, int64_t num_rows, int F, cudaStream_t stream) {
  const int vpl = pick_vpl(F, 8);
  const dim3 grid(static_cast<unsigned>((num_rows + K3_WARPS - 1) / K3_WARPS),
                  (F + 32 * vpl - 1) / (32 * vpl));
  const dim3 block(K3_WARPS * 32);
  const T* s = static_cast<const T*>(src);
  T* o = static_cast<T*>(out);
  switch (vpl) {
    case 1:
      segment_sum_csr_kernel<T, 1><<<grid, block, 0, stream>>>(
          s, indptr, num_el, o, num_rows, F);
      break;
    case 2:
      segment_sum_csr_kernel<T, 2><<<grid, block, 0, stream>>>(
          s, indptr, num_el, o, num_rows, F);
      break;
    case 4:
      segment_sum_csr_kernel<T, 4><<<grid, block, 0, stream>>>(
          s, indptr, num_el, o, num_rows, F);
      break;
    default:
      segment_sum_csr_kernel<T, 8><<<grid, block, 0, stream>>>(
          s, indptr, num_el, o, num_rows, F);
  }
}

}  // namespace
}  // namespace pygt

// src [num_el, F] (f32 or bf16 by dtype), indptr [num_rows + 1] int64,
// out [num_rows, F] in src's type (written in full). Returns
// cudaGetLastError() after the launch.
extern "C" int pygt_segment_sum_csr(const void* src, int dtype,
                                    const void* indptr, int64_t num_el,
                                    void* out, int64_t num_rows, int F,
                                    void* stream) {
  using namespace pygt;
  const int64_t* ip = static_cast<const int64_t*>(indptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      launch<float>(src, ip, num_el, out, num_rows, F, s);
      break;
    case BF16:
      launch<__nv_bfloat16>(src, ip, num_el, out, num_rows, F, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
