// F1: greedy farthest point sampling of every cloud of a batch, in one
// launch.
//
// Replaces the XLA loop of pyg_lib_tpu/ops/geometry.py `_fps_one` (a
// `lax.fori_loop` of m - 1 dependent steps per cloud, one host round trip
// per cloud); it has no Pallas counterpart. For each cloud c of points
// P[lo, lo + n) (rows of D floats), starting from `start`:
//
//   dist[p] = +inf;  pick[0] = start
//   for i in 1 .. m-1:
//     dist[p] = min(dist[p], |P[p] - P[pick[i-1]]|^2)   for every p
//     pick[i] = the lowest p among those with the largest dist[p]
//
// and out[off + i] = lo + pick[i] (int32). The squared distance is
// summed left to right over the D coordinates, each difference, square
// and sum rounded once (__fsub_rn, __fmul_rn, __fadd_rn: nvcc would
// otherwise contract the products into FMAs), so the kernel gives
// exactly the indices of its plain version in ops/kernels/fps.py, which
// does the same arithmetic in the same order, and of jnp.argmax's
// lowest-index rule, also when every distance left is 0.
//
// Bound on the card: latency. The m - 1 steps of a cloud depend on each
// other, and each ends in a block-wide argmax. The bytes (each point read
// once, each index written once) take well under a microsecond over
// 3.35 TB/s, and the n * m * (3D + 2) operations of a PointNet++ batch
// a few microseconds over 67 TFLOP/s (NVIDIA H100 SXM data sheet, 700 W);
// the chain of m reductions is what the time is made of, and
// fps_floor_kernel below runs that chain alone to measure it.
//
// Design, simple and correct first:
// * one block of THREADS threads per cloud runs all of its steps; clouds
//   run side by side on the SMs. The running minimum distances sit in
//   registers (ITEMS per thread, a template argument) when the cloud has
//   at most THREADS * ITEMS points, else in a global scratch buffer
//   (`scratch + lo`; a shared-memory tier for mid-size clouds read no
//   faster on 32,768 points, PERF.md);
// * each thread keeps its best (distance, index) over its points in
//   increasing index order with a strict >, so it holds the lowest index
//   of its maxima; a warp butterfly and then warp 0 over the warps'
//   results combine pairs by (larger distance, then lower index), a total
//   order on the candidates, so every lane ends with the same winner;
// * the picked point is read back through L1 by every thread.
#include <stdint.h>

#include "common.cuh"

namespace pygt {
namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int NO_INDEX = 0x7fffffff;

__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// Squared distance of point p to point l (D coordinates each), summed left
// to right with one rounding per operation.
__device__ __forceinline__ float sqdist(const float* __restrict__ p,
                                        const float* __restrict__ l, int D) {
  float s = 0.f;
  for (int d = 0; d < D; ++d) {
    const float t = __fsub_rn(__ldg(p + d), __ldg(l + d));
    s = __fadd_rn(s, __fmul_rn(t, t));
  }
  return s;
}

// The block's winner of every thread's (v, i); all threads return it.
__device__ __forceinline__ int block_argmax(float v, int i, float* sv,
                                            int* si) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    better(v, i, __shfl_xor_sync(FULL, v, o), __shfl_xor_sync(FULL, i, o));
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) {
    sv[w] = v;
    si[w] = i;
  }
  __syncthreads();
  if (w == 0) {
    v = lane < WARPS ? sv[lane] : neg_inf();
    i = lane < WARPS ? si[lane] : NO_INDEX;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      better(v, i, __shfl_xor_sync(FULL, v, o), __shfl_xor_sync(FULL, i, o));
    if (lane == 0) si[WARPS] = i;
  }
  __syncthreads();
  return si[WARPS];
}

// table: per cloud {lo, n, m, start, off} (int64). Clouds of at most
// THREADS * ITEMS points keep their distances in registers, larger ones in
// scratch + lo.
template <int ITEMS>
__global__ void __launch_bounds__(THREADS)
    fps_kernel(const float* __restrict__ pos, int D,
               const int64_t* __restrict__ table, int32_t* __restrict__ out,
               float* __restrict__ scratch) {
  __shared__ float sv[WARPS];
  __shared__ int si[WARPS + 1];
  const int64_t* t = table + 5 * static_cast<int64_t>(blockIdx.x);
  const int64_t lo = t[0], n = t[1], m = t[2], off = t[4];
  const float* P = pos + lo * D;
  int last = static_cast<int>(t[3]);
  int32_t* o = out + off;
  if (threadIdx.x == 0) o[0] = static_cast<int32_t>(lo + last);
  if (n <= static_cast<int64_t>(THREADS) * ITEMS) {
    float dist[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) dist[k] = __int_as_float(0x7f800000);
    for (int64_t s = 1; s < m; ++s) {
      const float* L = P + static_cast<int64_t>(last) * D;
      float bv = neg_inf();
      int bi = NO_INDEX;
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const int p = threadIdx.x + k * THREADS;
        if (p < n) {
          dist[k] = fminf(dist[k], sqdist(P + static_cast<int64_t>(p) * D,
                                          L, D));
          if (dist[k] > bv) {
            bv = dist[k];
            bi = p;
          }
        }
      }
      last = block_argmax(bv, bi, sv, si);
      if (threadIdx.x == 0) o[s] = static_cast<int32_t>(lo + last);
    }
    return;
  }
  float* dist = scratch + lo;
  for (int64_t p = threadIdx.x; p < n; p += THREADS)
    dist[p] = __int_as_float(0x7f800000);
  for (int64_t s = 1; s < m; ++s) {
    const float* L = P + static_cast<int64_t>(last) * D;
    float bv = neg_inf();
    int bi = NO_INDEX;
    for (int64_t p = threadIdx.x; p < n; p += THREADS) {
      const float d = fminf(dist[p], sqdist(P + p * D, L, D));
      dist[p] = d;
      if (d > bv) {
        bv = d;
        bi = static_cast<int>(p);
      }
    }
    last = block_argmax(bv, bi, sv, si);
    if (threadIdx.x == 0) o[s] = static_cast<int32_t>(lo + last);
  }
}

// F1's latency floor, for measurement: per cloud of the same table, the
// same m - 1 dependent block-wide argmaxes, with no distance work. Each
// thread offers one (value, index), the value a hash of its index and the
// last winner, so every step waits for the one before; out gets the
// winners.
__global__ void __launch_bounds__(THREADS)
    fps_floor_kernel(const int64_t* __restrict__ table,
                     int32_t* __restrict__ out) {
  __shared__ float sv[WARPS];
  __shared__ int si[WARPS + 1];
  const int64_t* t = table + 5 * static_cast<int64_t>(blockIdx.x);
  const int64_t lo = t[0], m = t[2], off = t[4];
  int last = static_cast<int>(t[3]);
  int32_t* o = out + off;
  if (threadIdx.x == 0) o[0] = static_cast<int32_t>(lo + last);
  for (int64_t s = 1; s < m; ++s) {
    const unsigned h = (threadIdx.x ^ static_cast<unsigned>(last)) *
                       2654435761u;
    last = block_argmax(__uint_as_float(0x3f800000u | (h >> 9)),
                        static_cast<int>(threadIdx.x), sv, si);
    if (threadIdx.x == 0) o[s] = static_cast<int32_t>(lo + last);
  }
}

template <int ITEMS>
int launch(const float* pos, int D, const int64_t* table, int clouds,
           int32_t* out, float* scratch, cudaStream_t stream) {
  fps_kernel<ITEMS><<<clouds, THREADS, 0, stream>>>(pos, D, table, out,
                                                     scratch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace pygt

// pos [N, D] f32; table [clouds, 5] int64 of {lo, n, m, start, off} with
// 1 <= n and 1 <= m; out [Σ m] int32 (written in full). `items` (1, 2, 4,
// 8 or 16) sets the registers a thread gives its distances; a cloud with
// more than 512 * items points keeps them in scratch [N] f32 at its own
// rows. Returns cudaGetLastError() after the launch.
extern "C" int pygt_fps(const void* pos, int D, const void* table, int clouds,
                        void* out, void* scratch, int items, void* stream) {
  using namespace pygt;
  const float* p = static_cast<const float*>(pos);
  const int64_t* t = static_cast<const int64_t*>(table);
  int32_t* o = static_cast<int32_t*>(out);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (clouds <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (items) {
    case 1:
      return launch<1>(p, D, t, clouds, o, sc, s);
    case 2:
      return launch<2>(p, D, t, clouds, o, sc, s);
    case 4:
      return launch<4>(p, D, t, clouds, o, sc, s);
    case 8:
      return launch<8>(p, D, t, clouds, o, sc, s);
    case 16:
      return launch<16>(p, D, t, clouds, o, sc, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// F1's latency floor (fps_floor_kernel) over the same table and out, one
// block a cloud. Returns cudaGetLastError() after the launch.
extern "C" int pygt_fps_floor(const void* table, int clouds, void* out,
                              void* stream) {
  using namespace pygt;
  if (clouds <= 0) return static_cast<int>(cudaErrorInvalidValue);
  fps_floor_kernel<<<clouds, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(table), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
