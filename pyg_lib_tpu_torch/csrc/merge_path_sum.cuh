// The merge-path segment sum that K3 (segment_csr.cu) and the row gather's
// backward (gather_rows.cu) share:
//
//   out[r, f] = sum_{p in [indptr[r], indptr[r+1]) ∩ [0, E)} src[at(p), f]
//
// summed in f32 and written once in src's type (f32 or bf16), with
// at(p) = p for K3 and at(p) = perm[p] for the gather's backward, which
// reads each cotangent row through the permutation that sorts the edges by
// source row. Positions outside [indptr[0], indptr[-1]) belong to no row
// and are read by no warp. indptr is non-decreasing.
//
// Bound on the card: bytes. One add per element read, far below the
// 67 TFLOP/s of f32 CUDA cores (NVIDIA H100 SXM data sheet, 700 W). Each
// input read once and each output written once is E*F*elem + (R+1)*8 +
// R*F*elem bytes (and E*8 of perm) over 3.35 TB/s of HBM; the kernel reads
// each src row exactly once.
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
//   16-byte vectors. Through perm, each lane holds the perm entries of the
//   next 32 positions and of the 32 after, so a row's address is a shuffle
//   away when its copy is issued;
// * a row whose edges all fall in one warp's stretch is written directly.
//   The at most two rows a warp shares with its neighbours (its first row,
//   begun by an earlier warp, and its last, ended by a later one) go as f32
//   partial sums to a scratch table, two slots per warp, with a code per
//   slot: -1 unused, r where row r's run of partials starts, -2 - r where
//   it goes on. A second launch sums each run in slot order and rounds
//   once. No float atomics: the same inputs give the same bits every run.
//
// Each source wraps stream() and fixup() in __global__ kernels of its own
// names, so that a profile tells the two callers apart.
#pragma once

#include "common.cuh"

namespace pygt {
namespace msum {

constexpr int WARPS = 2;   // warps (stretches) per block
constexpr int STAGES = 8;  // edge rows a warp has in flight (a power of two)

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

// The src row of each stream position, asked for in order from the
// stretch's first position, one at a time and by the whole warp.
template <bool GATHER>
struct SrcRows;

template <>
struct SrcRows<false> {
  __device__ __forceinline__ SrcRows(const int64_t*, int64_t, int64_t, int) {}
  __device__ __forceinline__ int64_t next(int64_t e) { return e; }
};

template <>
struct SrcRows<true> {
  // Lane k holds perm[pb + k] (cur) and perm[pb + 32 + k] (nxt).
  const int64_t* perm;
  int64_t pb, end, cur, nxt;
  int lane;
  __device__ __forceinline__ SrcRows(const int64_t* p, int64_t j0,
                                     int64_t j1, int l)
      : perm(p), pb(j0), end(j1), lane(l) {
    cur = load(pb);
    nxt = load(pb + 32);
  }
  __device__ __forceinline__ int64_t load(int64_t b) const {
    return b + lane < end ? perm[b + lane] : 0;
  }
  __device__ __forceinline__ int64_t next(int64_t e) {
    if (e - pb == 32) {
      pb += 32;
      cur = nxt;
      nxt = load(pb + 32);
    }
    return __shfl_sync(FULL, cur, static_cast<int>(e - pb));
  }
};

// One warp's stretch of the merge path (blockIdx.x * WARPS + warp) over one
// F-block (blockIdx.y); perm is read only when GATHER.
template <typename T, int W, int NV, bool GATHER>
__device__ __forceinline__ void stream(
    const T* __restrict__ src, const int64_t* __restrict__ perm,
    const int64_t* __restrict__ indptr, int64_t num_el, T* __restrict__ out,
    int64_t num_rows, int F, int units, float* __restrict__ part,
    int64_t* __restrict__ code) {
  using V = Vec<T, W>;
  const int unit = blockIdx.x * WARPS + (threadIdx.x >> 5);
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

  const T* s = src + (GATHER ? 0 : rows.base * F) + f0;
  SrcRows<GATHER> src_rows(GATHER ? perm + rows.base : nullptr, j0, j1,
                           lane);
  float acc[NV][W];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int k = 0; k < W; ++k) acc[v][k] = 0.0f;
  // The ring: edge j0 + k in stage k % STAGES, each lane's own vectors
  // (no lane reads another's, so waiting on its own copies suffices).
  constexpr bool ASYNC = sizeof(T) * W == 16;
  __shared__ typename V::Raw ring[ASYNC ? WARPS : 1][ASYNC ? STAGES : 1][NV]
                                  [32];
  const int warp = threadIdx.x >> 5;
  auto issue = [&](int64_t e) {
    if constexpr (ASYNC) {
      if (e < j1) {
        const T* r = s + src_rows.next(e) * F;
#pragma unroll
        for (int v = 0; v < NV; ++v)
          if (ok[v])
            cp_async16(&ring[warp][(e - j0) & (STAGES - 1)][v][lane],
                       r + 32 * v * W);
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
      const T* r = s + src_rows.next(e) * F;
#pragma unroll
      for (int v = 0; v < NV; ++v)
        if (ok[v]) V::add(acc[v], V::load(r + 32 * v * W));
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
__device__ __forceinline__ void fixup(const float* __restrict__ part,
                                      const int64_t* __restrict__ code,
                                      int slots, T* __restrict__ out, int F) {
  const int slot = blockIdx.x * WARPS + (threadIdx.x >> 5);
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

// What a launch is instantiated for: element type, vector width, vectors
// per lane.
template <typename T, int W, int NV>
struct Shape {
  using Type = T;
  static constexpr int w = W, nv = NV;
};

template <typename T, int W, typename L>
void by_vpl(int F, L& launch) {
  switch (pick_vpl(F / W, 4)) {
    case 1:
      launch(Shape<T, W, 1>{});
      break;
    case 2:
      launch(Shape<T, W, 2>{});
      break;
    default:
      launch(Shape<T, W, 4>{});
  }
}

// Calls launch(Shape<T, W, NV>{}) for src's type: 16-byte vectors where F
// and src's address allow them (a view with a storage offset may not be
// aligned), else scalars; NV from pick_vpl. Returns cudaErrorInvalidValue
// for another dtype or no units, else cudaGetLastError() after the launch.
template <typename L>
int dispatch(const void* src, int dtype, int F, int units, L&& launch) {
  if (units <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = reinterpret_cast<uintptr_t>(src) % 16 == 0;
  switch (dtype) {
    case F32:
      if (aligned && F % 4 == 0)
        by_vpl<float, 4>(F, launch);
      else
        by_vpl<float, 1>(F, launch);
      break;
    case BF16:
      if (aligned && F % 8 == 0)
        by_vpl<__nv_bfloat16, 8>(F, launch);
      else
        by_vpl<__nv_bfloat16, 1>(F, launch);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The grids of stream() (a block per WARPS stretches and per F-block of
// 32 * VW elements, VW = W * NV) and of fixup() (per WARPS slots and per
// 32 * W elements).
inline dim3 block() { return dim3(WARPS * 32); }
inline dim3 stream_grid(int units, int F, int vw) {
  return dim3((units + WARPS - 1) / WARPS, (F + 32 * vw - 1) / (32 * vw));
}
inline dim3 fixup_grid(int units, int F, int w) {
  return dim3((2 * units + WARPS - 1) / WARPS, (F + 32 * w - 1) / (32 * w));
}

}  // namespace msum
}  // namespace pygt
