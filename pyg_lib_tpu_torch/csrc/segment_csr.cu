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
// Bound on the card: bytes. One add per element read, far below the
// 67 TFLOP/s of f32 CUDA cores (NVIDIA H100 SXM data sheet, 700 W). Each
// input read once and each output written once is E*F*elem + (R+1)*8 +
// R*F*elem bytes over 3.35 TB/s of HBM; the kernel reads each src row
// exactly once, in order.
//
// Design against that bound:
// * equal work per warp, whatever the row lengths: the R row ends and the
//   E edges form one merge path of R + E items (Merrill and Garland's CSR
//   split), and `units` warps each take an equal stretch of it, found by
//   a binary search of indptr. Empty rows cost an item each and a hub row
//   is shared by as many warps as its length asks;
// * 16-byte copies in flight without registers: a lane copies a float4
//   (8 bf16) per vector, NV vectors per edge row, by cp.async into its own
//   slots of a ring of STAGES edge rows in shared memory, and adds the row
//   that arrived while STAGES - 1 more are on their way (14 KB a warp at
//   F=512 f32, across row ends). Few deep streams beat many shallow ones:
//   8 warps an SM with 8 stages read about 1% faster than 48 with 4 in
//   the A/B of tools/time_segment.py. A scalar branch of the same kernel,
//   with plain loads, takes an F or a src address that does not allow
//   16-byte vectors;
// * a row whose edges all fall in one warp's stretch is written directly.
//   The at most two rows a warp shares with its neighbours (its first row,
//   begun by an earlier warp, and its last, ended by a later one) go as f32
//   partial sums to a scratch table, two slots per warp, with a code per
//   slot: -1 unused, r where row r's run of partials starts, -2 - r where
//   it goes on. A second launch sums each run in slot order and rounds
//   once. No float atomics: the same inputs give the same bits every run.
#include "common.cuh"

namespace pygt {
namespace {

constexpr int K3_WARPS = 2;  // warps (stretches) per block
constexpr int STAGES = 8;    // edge rows a warp has in flight (a power of two)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// W elements of T as one vector (Raw), added into f32 sums and stored; the
// scalar vector (W = 1) is also loaded directly.
template <typename T, int W>
struct Vec;

template <>
struct Vec<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ void add(float* a, Raw v) {
    a[0] += v.x;
    a[1] += v.y;
    a[2] += v.z;
    a[3] += v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* a) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ void add(float* a, Raw v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      a[2 * k] += f.x;
      a[2 * k + 1] += f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* a) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h[k] = __floats2bfloat162_rn(a[2 * k], a[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <typename T>
struct Vec<T, 1> {
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ void add(float* a, Raw v) {
    a[0] += to_f32(v);
  }
  static __device__ __forceinline__ void store(T* p, const float* a) {
    *p = from_f32<T>(a[0]);
  }
};

// W f32 partial sums to and from the scratch table.
template <int W>
__device__ __forceinline__ void store_f32(float* p, const float* a) {
  if constexpr (W == 1) {
    *p = a[0];
  } else {
#pragma unroll
    for (int k = 0; k < W; k += 4)
      *reinterpret_cast<float4*>(p + k) =
          make_float4(a[k], a[k + 1], a[k + 2], a[k + 3]);
  }
}

template <int W>
__device__ __forceinline__ void load_f32(const float* p, float* a) {
  if constexpr (W == 1) {
    a[0] = *p;
  } else {
#pragma unroll
    for (int k = 0; k < W; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + k);
      a[k] = v.x;
      a[k + 1] = v.y;
      a[k + 2] = v.z;
      a[k + 3] = v.w;
    }
  }
}

// indptr[r] clamped to [0, num_el], less `base` and clamped to [0, total]:
// the position of row r's first edge in the stream of real edges.
struct Rows {
  const int64_t* indptr;
  int64_t num_el, base, total;
  __device__ __forceinline__ int64_t at(int64_t r) const {
    int64_t c = indptr[r];
    c = c < 0 ? 0 : (c > num_el ? num_el : c);
    c -= base;
    return c < 0 ? 0 : (c > total ? total : c);
  }
};

// The merge-path point of diagonal d: i rows ended and j = d - i edges
// taken, i the least with at(i + 1) + i >= d (k3_split in the wrapper).
__device__ __forceinline__ void split_at(const Rows& rows, int64_t num_rows,
                                         int64_t d, int64_t& i, int64_t& j) {
  int64_t lo = d - rows.total > 0 ? d - rows.total : 0;
  int64_t hi = d < num_rows ? d : num_rows;
  while (lo < hi) {
    const int64_t p = (lo + hi) >> 1;
    if (rows.at(p + 1) + p < d)
      lo = p + 1;
    else
      hi = p;
  }
  i = lo;
  j = d - lo;
}

template <typename T, int W, int NV>
__global__ void __launch_bounds__(K3_WARPS * 32, 1)
    k3_stream(const T* __restrict__ src, const int64_t* __restrict__ indptr,
              int64_t num_el, T* __restrict__ out, int64_t num_rows, int F,
              int units, float* __restrict__ part,
              int64_t* __restrict__ code) {
  using V = Vec<T, W>;
  const int unit = blockIdx.x * K3_WARPS + (threadIdx.x >> 5);
  if (unit >= units) return;
  const int lane = threadIdx.x & 31;
  const int f0 = blockIdx.y * (32 * NV * W) + lane * W;
  bool ok[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) ok[v] = f0 + 32 * v * W < F;

  int64_t first = indptr[0], last = indptr[num_rows];
  first = first < 0 ? 0 : (first > num_el ? num_el : first);
  last = last < 0 ? 0 : (last > num_el ? num_el : last);
  const Rows rows{indptr, num_el, first, last > first ? last - first : 0};
  const int64_t diag = num_rows + rows.total;
  int64_t i0, j0, i1, j1;
  split_at(rows, num_rows, diag * unit / units, i0, j0);
  split_at(rows, num_rows, diag * (unit + 1) / units, i1, j1);
  const bool head = i0 < i1 && rows.at(i0) < j0;
  const int64_t tail_start = i1 < num_rows ? rows.at(i1) : rows.total;
  const bool tail = i1 < num_rows && j1 > tail_start;
  if (blockIdx.y == 0 && lane == 0) {
    code[2 * unit] = head ? -2 - i0 : -1;
    code[2 * unit + 1] = !tail ? -1 : (tail_start >= j0 ? i1 : -2 - i1);
  }

  const T* s = src + rows.base * F + f0;
  float acc[NV][W];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int k = 0; k < W; ++k) acc[v][k] = 0.0f;
  // The ring: edge j0 + k in stage k % STAGES, each lane's own vectors
  // (no lane reads another's, so waiting on its own copies suffices).
  constexpr bool ASYNC = sizeof(T) * W == 16;
  __shared__ typename V::Raw ring[ASYNC ? K3_WARPS : 1][ASYNC ? STAGES : 1]
                                  [NV][32];
  const int warp = threadIdx.x >> 5;
  auto issue = [&](int64_t e) {
    if constexpr (ASYNC) {
      if (e < j1) {
#pragma unroll
        for (int v = 0; v < NV; ++v)
          if (ok[v])
            cp_async16(&ring[warp][(e - j0) & (STAGES - 1)][v][lane],
                       s + e * F + 32 * v * W);
      }
      cp_async_commit();
    }
  };
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) issue(j0 + k);

  int64_t row = i0;
  // Row ends 32 at a time, lane k holding the end of row rb + k.
  int64_t rb = row;
  int64_t my_end = rb + lane < num_rows ? rows.at(rb + lane + 1) : rows.total;
  int64_t end = row < i1 ? __shfl_sync(FULL, my_end, 0) : j1;
  // Row `row` ends in this stretch: written, or a partial if an earlier
  // warp began it; then the next row.
  auto flush = [&]() {
    if (row == i0 && head) {
      float* p = part + static_cast<int64_t>(2 * unit) * F + f0;
#pragma unroll
      for (int v = 0; v < NV; ++v)
        if (ok[v]) store_f32<W>(p + 32 * v * W, acc[v]);
    } else {
      T* o = out + row * F + f0;
#pragma unroll
      for (int v = 0; v < NV; ++v)
        if (ok[v]) V::store(o + 32 * v * W, acc[v]);
    }
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int k = 0; k < W; ++k) acc[v][k] = 0.0f;
    if (++row - rb == 32) {
      rb = row;
      my_end = rb + lane < num_rows ? rows.at(rb + lane + 1) : rows.total;
    }
    end = row < i1 ? __shfl_sync(FULL, my_end, static_cast<int>(row - rb))
                   : j1;
  };
  for (int64_t e = j0; e < j1; ++e) {
    while (row < i1 && end <= e) flush();
    if constexpr (ASYNC) {
      issue(e + STAGES - 1);
      cp_async_wait<STAGES - 1>();
#pragma unroll
      for (int v = 0; v < NV; ++v)
        if (ok[v]) V::add(acc[v], ring[warp][(e - j0) & (STAGES - 1)][v][lane]);
    } else {
#pragma unroll
      for (int v = 0; v < NV; ++v)
        if (ok[v]) V::add(acc[v], V::load(s + e * F + 32 * v * W));
    }
  }
  while (row < i1) flush();
  if (tail) {
    float* p = part + static_cast<int64_t>(2 * unit + 1) * F + f0;
#pragma unroll
    for (int v = 0; v < NV; ++v)
      if (ok[v]) store_f32<W>(p + 32 * v * W, acc[v]);
  }
}

// One warp per slot that starts a run: adds the run's partials in slot
// order (skipping unused slots) and writes the row once, rounded to T.
template <typename T, int W>
__global__ void __launch_bounds__(K3_WARPS * 32, 1)
    k3_fixup(const float* __restrict__ part,
             const int64_t* __restrict__ code, int slots, T* __restrict__ out,
             int F) {
  const int slot = blockIdx.x * K3_WARPS + (threadIdx.x >> 5);
  if (slot >= slots) return;
  const int64_t r = code[slot];
  if (r < 0) return;
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.y * (32 * W) + lane * W;
  const bool ok = f < F;
  float acc[W], nxt[4][W];
  if (ok) load_f32<W>(part + static_cast<int64_t>(slot) * F + f, acc);
  const int64_t more = -2 - r;
  for (int t = slot + 1; t < slots; t += 32) {
    const int64_t c = t + lane < slots ? code[t + lane] : r;
    unsigned add = __ballot_sync(FULL, c == more);
    const unsigned stop = __ballot_sync(FULL, c != more && c != -1);
    if (stop) add &= (1u << (__ffs(stop) - 1)) - 1u;
    while (add) {  // up to 4 partials loaded, then added in slot order
      int k[4];
      int n = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        k[q] = add ? __ffs(add) - 1 : -1;
        if (add) {
          add &= add - 1u;
          ++n;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (ok && q < n)
          load_f32<W>(part + static_cast<int64_t>(t + k[q]) * F + f, nxt[q]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (ok && q < n)
#pragma unroll
          for (int w = 0; w < W; ++w) acc[w] += nxt[q][w];
    }
    if (stop) break;
  }
  if (ok) Vec<T, W>::store(out + r * F + f, acc);
}

template <typename T, int W, int NV>
void launch_vpl(const T* src, const int64_t* indptr, int64_t num_el, T* out,
                int64_t num_rows, int F, int units, float* part,
                int64_t* code, cudaStream_t stream) {
  const dim3 block(K3_WARPS * 32);
  const dim3 grid((units + K3_WARPS - 1) / K3_WARPS,
                  (F + 32 * NV * W - 1) / (32 * NV * W));
  k3_stream<T, W, NV><<<grid, block, 0, stream>>>(
      src, indptr, num_el, out, num_rows, F, units, part, code);
  const int slots = 2 * units;
  const dim3 grid2((slots + K3_WARPS - 1) / K3_WARPS,
                   (F + 32 * W - 1) / (32 * W));
  k3_fixup<T, W><<<grid2, block, 0, stream>>>(part, code, slots, out, F);
}

template <typename T, int W>
void launch(const void* src, const int64_t* indptr, int64_t num_el,
            void* out, int64_t num_rows, int F, int units, float* part,
            int64_t* code, cudaStream_t stream) {
  const T* s = static_cast<const T*>(src);
  T* o = static_cast<T*>(out);
  switch (pick_vpl(F / W, 4)) {
    case 1:
      launch_vpl<T, W, 1>(s, indptr, num_el, o, num_rows, F, units, part,
                          code, stream);
      break;
    case 2:
      launch_vpl<T, W, 2>(s, indptr, num_el, o, num_rows, F, units, part,
                          code, stream);
      break;
    default:
      launch_vpl<T, W, 4>(s, indptr, num_el, o, num_rows, F, units, part,
                          code, stream);
  }
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
  // 16-byte vectors need F a multiple of the vector and an aligned src
  // (a view with a storage offset may not be).
  const bool aligned = reinterpret_cast<uintptr_t>(src) % 16 == 0;
  if (units <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case F32:
      if (aligned && F % 4 == 0)
        launch<float, 4>(src, ip, num_el, out, num_rows, F, units, pt, cd, s);
      else
        launch<float, 1>(src, ip, num_el, out, num_rows, F, units, pt, cd, s);
      break;
    case BF16:
      if (aligned && F % 8 == 0)
        launch<__nv_bfloat16, 8>(src, ip, num_el, out, num_rows, F, units, pt,
                                 cd, s);
      else
        launch<__nv_bfloat16, 1>(src, ip, num_el, out, num_rows, F, units, pt,
                                 cd, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
