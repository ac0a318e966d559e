// K6: per-row softmax in the chunked plan's padded edge coordinates
// (SpmmPlan).
//
// Replaces the three TPU kernels of pyg_lib_tpu/ops/pallas/
// segment_softmax_kernel.py, `_rowmax_kernel`, `_expsum_kernel` and
// `_normalize_kernel` (launched by `_softmax_padded`, driven by
// `segment_softmax_planned`):
//
//   m_p      = src[p]          (idx == null: src is the padded slab)
//            = src[idx[p]]     (otherwise; idx = plan.edge_perm)
//   max_r    = max_{p in [lo_r, hi_r)} m_p
//   sum_r    = sum_{p in [lo_r, hi_r)} exp(m_p - max_r)
//   out[q_p] = exp(m_p - max_r) / sum_r,   q_p = p or idx[p]
//
// per feature, where [lo_r, hi_r) = tile_ptr[t, 0, r : r + 2] are row r's
// padded slots. In the padded mode every slot of no row is written 0, as
// `_normalize_kernel` does; in the index mode the output is in the
// original edge order and pad slots have no place in it. Values keep the
// input's type (f32 or bf16) and everything inside is f32. A -inf message
// gives 0 beside a finite maximum and a row of -inf gives NaN, as the XLA
// composite `softmax_csr` does (the TPU kernel, through a one-hot matmul
// over -inf, can turn a whole chunk column into NaN instead).
//
// Bound on the card: bytes. Each input read once and each output written
// once is 2 * E_pad * F * elem bytes plus the row bounds, over the 3.35
// TB/s of HBM (NVIDIA H100 SXM data sheet, 700 W); two exp per element are
// far below the card's arithmetic rates.
//
// Design against that bound, and against hub rows:
// * equal work per warp, whatever the row lengths: the slots [0, E_pad)
//   are cut into stretches of `stretch` slots (a multiple of 32), one warp
//   each. The rows come as the wrapper's derived table of the non-empty
//   rows' bounds, in slot order; a warp finds its first row by binary
//   search and keeps the next 32 rows' bounds in its lanes;
// * pass 1 (statistics): with F <= 16 a lane takes one slot of each group
//   of 32 and loads its F values at once (16 bytes for 4 f32 heads); the
//   lanes find their rows among the 32 held by 5 shuffles, and a segmented
//   scan by row gives each row's max, then its sum of exp(m - max), both
//   within the group. A row that goes on past the group is carried to the
//   next, merged by the online (max, sum) rule. Wider F puts the lanes
//   over features (16-byte loads of 4 values where F and the address allow
//   it) and walks the stretch's slots in order with the online rule;
// * each row's (max, sum) goes to a [rows, F] pair table when the row lies
//   within one stretch. A row cut by stretch ends leaves a partial pair in
//   a scratch table, two slots a warp (2w its first row when it began in
//   an earlier stretch, 2w + 1 its last row when it goes on past), and a
//   second launch merges each such row's partials, a warp a row and
//   feature, in a fixed order: a hub row is shared by as many warps as its
//   length asks. No float atomics: the same inputs give the same bits
//   every run;
// * pass 3 (normalise) takes the same stretches, gives each slot its
//   row's pair and writes exp(m - max) / sum once (0 at a pad slot in the
//   padded mode);
// * the optional index reads src[edge_perm[p]] and writes out[edge_perm[p]]
//   for `softmax_csr`, so the permuted [E, F] copy and the edge_pos gather
//   back are never written.
#include <type_traits>

#include "common.cuh"

namespace pygt {
namespace {

constexpr int K6_WARPS = 8;
constexpr int NARROW_F = 16;  // widest F that puts lanes over slots
constexpr int NO_SLOT = 0x7fffffff;

// Fold value x into the running (m, s): s is the sum of exp(v - m).
__device__ __forceinline__ void online(float& m, float& s, float x) {
  const float mn = fmaxf(m, x);
  s = (m == mn ? s : s * expf(m - mn)) + (x == mn ? 1.0f : expf(x - mn));
  m = mn;
}

// Merge (m2, s2) into (m, s).
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = (m == mn ? s : s * expf(m - mn)) + (m2 == mn ? s2 : s2 * expf(m2 - mn));
  m = mn;
}

// N values of T at p, as f32: one vector load when `vec` (p aligned to
// the N values' size, up to 16 bytes), else the first n one by one (0
// past them).
template <typename T, int N>
__device__ __forceinline__ void load_vals(const T* p, bool vec, int n,
                                          float (&v)[N]) {
  constexpr int B = N * static_cast<int>(sizeof(T));
  if constexpr (B >= 4) {
    if (vec) {
      constexpr int W = B >= 16 ? 16 : B;
      using Raw = typename std::conditional<
          W == 16, uint4, typename std::conditional<W == 8, uint2,
                                                    unsigned>::type>::type;
      Raw raw[B / W];
#pragma unroll
      for (int i = 0; i < B / W; ++i)
        raw[i] = __ldg(reinterpret_cast<const Raw*>(p) + i);
      const T* t = reinterpret_cast<const T*>(raw);
#pragma unroll
      for (int f = 0; f < N; ++f) v[f] = to_f32(t[f]);
      return;
    }
  }
#pragma unroll
  for (int f = 0; f < N; ++f) v[f] = f < n ? to_f32(p[f]) : 0.0f;
}

template <typename T, int N>
__device__ __forceinline__ void store_vals(T* p, bool vec, int n,
                                           const float (&v)[N]) {
  constexpr int B = N * static_cast<int>(sizeof(T));
  if constexpr (B >= 4) {
    if (vec) {
      constexpr int W = B >= 16 ? 16 : B;
      using Raw = typename std::conditional<
          W == 16, uint4, typename std::conditional<W == 8, uint2,
                                                    unsigned>::type>::type;
      Raw raw[B / W];
      T* t = reinterpret_cast<T*>(raw);
#pragma unroll
      for (int f = 0; f < N; ++f) t[f] = from_f32<T>(v[f]);
#pragma unroll
      for (int i = 0; i < B / W; ++i) reinterpret_cast<Raw*>(p)[i] = raw[i];
      return;
    }
  }
#pragma unroll
  for (int f = 0; f < N; ++f)
    if (f < n) p[f] = from_f32<T>(v[f]);
}

// The non-empty rows in slot order: row q holds slots [lo[q], hi[q]).
struct Rows {
  const int* lo;
  const int* hi;
  int count;

  // The first row that ends after slot s (count if none).
  __device__ __forceinline__ int first_after(int s) const {
    int a = 0, b = count;
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (hi[mid] > s)
        b = mid;
      else
        a = mid + 1;
    }
    return a;
  }
};

// 32 consecutive rows from rb, lane k holding row rb + k's bounds.
struct Window {
  int rb, lo_l, hi_l;

  __device__ __forceinline__ void load(const Rows& rows, int lane, int from) {
    const int q = rb + lane;
    if (lane >= from) {
      lo_l = q < rows.count ? rows.lo[q] : NO_SLOT;
      hi_l = q < rows.count ? rows.hi[q] : NO_SLOT;
    }
  }

  // The window row that holds slot s, -1 if none (called by every lane).
  __device__ __forceinline__ int find(int s) const {
    int k = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1)
      if (__shfl_sync(FULL, lo_l, k + step) <= s) k += step;
    const int lo = __shfl_sync(FULL, lo_l, k);
    const int hi = __shfl_sync(FULL, hi_l, k);
    return lo <= s && s < hi ? k : -1;
  }

  // Drop the rows that end at or before slot `end`, load the next ones.
  __device__ __forceinline__ void advance(const Rows& rows, int lane,
                                          int end) {
    const int n = __popc(__ballot_sync(FULL, hi_l <= end));
    if (n == 0) return;
    rb += n;
    lo_l = __shfl_down_sync(FULL, lo_l, n);
    hi_l = __shfl_down_sync(FULL, hi_l, n);
    load(rows, lane, 32 - n);
  }
};

// Where warp w's statistics of row q go: its partial slot 2w (the row
// began in an earlier stretch and ends in this one) or 2w + 1 (it goes on
// past this stretch), else the pair table.
__device__ __forceinline__ float2* stat_at(float2* pair, float2* part,
                                           int64_t q, int lo, int hi,
                                           int start, int end, int w, int F) {
  if (hi > end) return part + static_cast<int64_t>(2 * w + 1) * F;
  if (lo < start) return part + static_cast<int64_t>(2 * w) * F;
  return pair + q * F;
}

// Pass 1, F <= NF <= NARROW_F: a lane per slot of each group of 32.
template <typename T, int NF>
__global__ void __launch_bounds__(K6_WARPS * 32)
    k6_stats_narrow(const T* __restrict__ src, const int* __restrict__ idx,
                    Rows rows, int e_pad, int stretch, int units, int F,
                    bool vec, float2* __restrict__ pair,
                    float2* __restrict__ part) {
  const int w = blockIdx.x * K6_WARPS + (threadIdx.x >> 5);
  if (w >= units) return;
  const int lane = threadIdx.x & 31;
  const int start = w * stretch;
  const int end = min(start + stretch, e_pad);
  Window win;
  win.rb = rows.first_after(start);
  win.load(rows, lane, 0);
  bool open = false;  // the last group's last row goes on into this one
  float cm[NF], cs[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    cm[f] = neg_inf();
    cs[f] = 0.0f;
  }
  for (int g = start; g < end; g += 32) {
    const int s = g + lane;
    const int found = win.find(s);
    const int k = s < end ? found : -1;
    float x[NF];
    if (k >= 0) {
      const int64_t c = idx != nullptr ? idx[s] : s;
      load_vals<T, NF>(src + c * F, vec, F, x);
    } else {
#pragma unroll
      for (int f = 0; f < NF; ++f) x[f] = neg_inf();
    }
    const int kc = max(k, 0);
    const int lo_k = __shfl_sync(FULL, win.lo_l, kc);
    const int hi_k = __shfl_sync(FULL, win.hi_l, kc);
    // Segments: runs of lanes on one row; each ends at `last`.
    const int k_next = __shfl_down_sync(FULL, k, 1);
    const bool last = lane == 31 || k_next != k;
    const unsigned ends = __ballot_sync(FULL, last);
    const int end_lane = __ffs(ends >> lane) - 1 + lane;
    int pk[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) pk[i] = __shfl_up_sync(FULL, k, 1 << i);
    float m[NF], sm[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      m[f] = x[f];
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const float o = __shfl_up_sync(FULL, m[f], 1 << i);
        if (lane >= (1 << i) && pk[i] == k) m[f] = fmaxf(m[f], o);
      }
      m[f] = __shfl_sync(FULL, m[f], end_lane);  // the segment's max
      sm[f] = x[f] == m[f] ? 1.0f : expf(x[f] - m[f]);
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const float o = __shfl_up_sync(FULL, sm[f], 1 << i);
        if (lane >= (1 << i) && pk[i] == k) sm[f] += o;
      }
    }
    const int k0 = __shfl_sync(FULL, k, 0);
    if (last && k >= 0) {
      if (open && k == k0) {  // the carried row, begun in an earlier group
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          float a = cm[f], b = cs[f];
          merge(a, b, m[f], sm[f]);
          m[f] = a;
          sm[f] = b;
        }
      }
      if (hi_k <= g + 32 || g + 32 >= end) {
        float2* at = stat_at(pair, part, win.rb + k, lo_k, hi_k, start, end,
                             w, F);
#pragma unroll
        for (int f = 0; f < NF; ++f)
          if (f < F) at[f] = make_float2(m[f], sm[f]);
      }
    }
    const int k31 = __shfl_sync(FULL, k, 31);
    const int hi31 = __shfl_sync(FULL, hi_k, 31);
    open = k31 >= 0 && hi31 > g + 32;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      cm[f] = __shfl_sync(FULL, m[f], 31);
      cs[f] = __shfl_sync(FULL, sm[f], 31);
    }
    win.advance(rows, lane, g + 32);
  }
}

// Pass 1, F > NARROW_F: lanes over features, W values of a vector and NV
// vectors a lane, a slice of 32 * W * NV features a block.
template <typename T, int W, int NV>
__global__ void __launch_bounds__(K6_WARPS * 32)
    k6_stats_wide(const T* __restrict__ src, const int* __restrict__ idx,
                  Rows rows, int e_pad, int stretch, int units, int F,
                  bool vec, float2* __restrict__ pair,
                  float2* __restrict__ part) {
  const int w = blockIdx.x * K6_WARPS + (threadIdx.x >> 5);
  if (w >= units) return;
  const int lane = threadIdx.x & 31;
  const int fl = blockIdx.y * (32 * W * NV) + lane * W;
  const int start = w * stretch;
  const int end = min(start + stretch, e_pad);
  int q = rows.first_after(start);
  int lo = q < rows.count ? rows.lo[q] : NO_SLOT;
  int hi = q < rows.count ? rows.hi[q] : NO_SLOT;
  float m[NV][W], sm[NV][W];
  auto reset = [&]() {
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int j = 0; j < W; ++j) {
        m[v][j] = neg_inf();
        sm[v][j] = 0.0f;
      }
  };
  auto finish = [&]() {
    float2* at = stat_at(pair, part, q, lo, hi, start, end, w, F);
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const int f = fl + 32 * W * v + j;
        if (f < F) at[f] = make_float2(m[v][j], sm[v][j]);
      }
    reset();
    ++q;
    lo = q < rows.count ? rows.lo[q] : NO_SLOT;
    hi = q < rows.count ? rows.hi[q] : NO_SLOT;
  };
  reset();
  for (int p = start; p < end; ++p) {
    while (p >= hi) finish();
    if (p < lo) continue;  // a slot of no row
    const int64_t c = idx != nullptr ? idx[p] : p;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int f = fl + 32 * W * v;
      if (f >= F) continue;
      float x[W];
      load_vals<T, W>(src + c * F + f, vec, F - f, x);
#pragma unroll
      for (int j = 0; j < W; ++j) online(m[v][j], sm[v][j], x[j]);
    }
  }
  if (lo < end) finish();  // the row the stretch ends in
}

// One warp per (row cut by stretch ends, feature): the row's partials are
// slots 2 w_a + 1, 2 w + 1 for w_a < w < w_b, then 2 w_b; lane l merges
// partials l, l + 32, ... in order, then the lanes merge by a butterfly
// (the merge is symmetric, so every lane ends with the same bits).
__global__ void k6_fixup(const int* __restrict__ cut,
                         const float2* __restrict__ part,
                         float2* __restrict__ pair, int F) {
  const int f = blockIdx.y * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (f >= F) return;
  const int lane = threadIdx.x & 31;
  const int* c = cut + 3 * static_cast<int64_t>(blockIdx.x);
  const int wa = c[1], wb = c[2];
  float m = neg_inf(), sum = 0.0f;
  for (int i = lane; i <= wb - wa; i += 32) {
    const int w = wa + i;
    const float2 b =
        part[static_cast<int64_t>(w < wb ? 2 * w + 1 : 2 * w) * F + f];
    merge(m, sum, b.x, b.y);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(FULL, m, off);
    const float s2 = __shfl_xor_sync(FULL, sum, off);
    merge(m, sum, m2, s2);
  }
  if (lane == 0) pair[static_cast<int64_t>(c[0]) * F + f] = make_float2(m, sum);
}

// Pass 3, F <= NF <= NARROW_F: a lane per slot, its row's pairs, the
// quotient written once.
template <typename T, int NF>
__global__ void __launch_bounds__(K6_WARPS * 32)
    k6_norm_narrow(const T* __restrict__ src, const int* __restrict__ idx,
                   Rows rows, int e_pad, int stretch, int units, int F,
                   bool vec, const float2* __restrict__ pair,
                   T* __restrict__ out) {
  const int w = blockIdx.x * K6_WARPS + (threadIdx.x >> 5);
  if (w >= units) return;
  const int lane = threadIdx.x & 31;
  const int start = w * stretch;
  const int end = min(start + stretch, e_pad);
  Window win;
  win.rb = rows.first_after(start);
  win.load(rows, lane, 0);
  for (int g = start; g < end; g += 32) {
    const int s = g + lane;
    const int k = win.find(s);
    if (s < end) {
      float y[NF];
      int64_t c = s;
      if (k >= 0) {
        c = idx != nullptr ? idx[s] : s;
        float x[NF], st[2 * NF];
        load_vals<T, NF>(src + c * F, vec, F, x);
        load_vals<float, 2 * NF>(
            reinterpret_cast<const float*>(pair) +
                2 * (static_cast<int64_t>(win.rb + k) * F),
            NF == F, 2 * F, st);
#pragma unroll
        for (int f = 0; f < NF; ++f)
          y[f] = expf(x[f] - st[2 * f]) / st[2 * f + 1];
      } else {
#pragma unroll
        for (int f = 0; f < NF; ++f) y[f] = 0.0f;
      }
      if (k >= 0 || idx == nullptr) store_vals<T, NF>(out + c * F, vec, F, y);
    }
    win.advance(rows, lane, g + 32);
  }
}

// Pass 3, F > NARROW_F: lanes over features, as k6_stats_wide.
template <typename T, int W, int NV>
__global__ void __launch_bounds__(K6_WARPS * 32)
    k6_norm_wide(const T* __restrict__ src, const int* __restrict__ idx,
                 Rows rows, int e_pad, int stretch, int units, int F,
                 bool vec, const float2* __restrict__ pair,
                 T* __restrict__ out) {
  const int w = blockIdx.x * K6_WARPS + (threadIdx.x >> 5);
  if (w >= units) return;
  const int lane = threadIdx.x & 31;
  const int fl = blockIdx.y * (32 * W * NV) + lane * W;
  const int start = w * stretch;
  const int end = min(start + stretch, e_pad);
  int q = rows.first_after(start);
  int lo = q < rows.count ? rows.lo[q] : NO_SLOT;
  int hi = q < rows.count ? rows.hi[q] : NO_SLOT;
  float2 st[NV][W];
  auto fetch = [&]() {
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const int f = fl + 32 * W * v + j;
        st[v][j] = q < rows.count && f < F
                       ? pair[static_cast<int64_t>(q) * F + f]
                       : make_float2(0.0f, 1.0f);
      }
  };
  fetch();
  for (int p = start; p < end; ++p) {
    while (p >= hi) {
      ++q;
      lo = q < rows.count ? rows.lo[q] : NO_SLOT;
      hi = q < rows.count ? rows.hi[q] : NO_SLOT;
      fetch();
    }
    const bool real = p >= lo;
    if (!real && idx != nullptr) continue;
    const int64_t c = real && idx != nullptr ? idx[p] : p;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int f = fl + 32 * W * v;
      if (f >= F) continue;
      float y[W];
      if (real) {
        load_vals<T, W>(src + c * F + f, vec, F - f, y);
#pragma unroll
        for (int j = 0; j < W; ++j)
          y[j] = expf(y[j] - st[v][j].x) / st[v][j].y;
      } else {
#pragma unroll
        for (int j = 0; j < W; ++j) y[j] = 0.0f;
      }
      store_vals<T, W>(out + c * F + f, vec, F - f, y);
    }
  }
}

struct Args {
  const int* idx;
  Rows rows;
  int e_pad, stretch, units, F;
  float2* pair;
  float2* part;
};

template <typename T, int NF>
void launch_narrow(const T* s, T* o, const Args& a, bool vec, bool norm,
                   cudaStream_t st) {
  const dim3 grid((a.units + K6_WARPS - 1) / K6_WARPS);
  if (norm)
    k6_norm_narrow<T, NF><<<grid, K6_WARPS * 32, 0, st>>>(
        s, a.idx, a.rows, a.e_pad, a.stretch, a.units, a.F, vec, a.pair, o);
  else
    k6_stats_narrow<T, NF><<<grid, K6_WARPS * 32, 0, st>>>(
        s, a.idx, a.rows, a.e_pad, a.stretch, a.units, a.F, vec, a.pair,
        a.part);
}

template <typename T, int W, int NV>
void launch_wide(const T* s, T* o, const Args& a, bool vec, bool norm,
                 cudaStream_t st) {
  const dim3 grid((a.units + K6_WARPS - 1) / K6_WARPS,
                  (a.F + 32 * W * NV - 1) / (32 * W * NV));
  if (norm)
    k6_norm_wide<T, W, NV><<<grid, K6_WARPS * 32, 0, st>>>(
        s, a.idx, a.rows, a.e_pad, a.stretch, a.units, a.F, vec, a.pair, o);
  else
    k6_stats_wide<T, W, NV><<<grid, K6_WARPS * 32, 0, st>>>(
        s, a.idx, a.rows, a.e_pad, a.stretch, a.units, a.F, vec, a.pair,
        a.part);
}

// One of the two passes over the slots (norm: pass 3), with the branch F
// and the addresses allow.
template <typename T>
void pass(const void* src, void* out, const Args& a, bool norm,
          cudaStream_t st) {
  const T* s = static_cast<const T*>(src);
  T* o = static_cast<T*>(out);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(out);
  if (a.F <= NARROW_F) {
    const int nf = pick_vpl(32 * a.F, NARROW_F);  // least power of 2 >= F
    const int bytes = nf * static_cast<int>(sizeof(T));
    const bool vec = nf == a.F && addr % (bytes < 16 ? bytes : 16) == 0;
    switch (nf) {
      case 1: launch_narrow<T, 1>(s, o, a, vec, norm, st); break;
      case 2: launch_narrow<T, 2>(s, o, a, vec, norm, st); break;
      case 4: launch_narrow<T, 4>(s, o, a, vec, norm, st); break;
      case 8: launch_narrow<T, 8>(s, o, a, vec, norm, st); break;
      default: launch_narrow<T, 16>(s, o, a, vec, norm, st);
    }
    return;
  }
  if (a.F % 4 == 0 && addr % (4 * sizeof(T)) == 0) {
    launch_wide<T, 4, 1>(s, o, a, true, norm, st);
    return;
  }
  switch (pick_vpl(a.F, 4)) {
    case 1: launch_wide<T, 1, 1>(s, o, a, false, norm, st); break;
    case 2: launch_wide<T, 1, 2>(s, o, a, false, norm, st); break;
    default: launch_wide<T, 1, 4>(s, o, a, false, norm, st);
  }
}

template <typename T>
void run(const void* src, void* out, const Args& a, const int* cut,
         int num_cut, cudaStream_t st) {
  pass<T>(src, out, a, false, st);
  if (num_cut > 0) {
    const dim3 grid(num_cut, (a.F + 3) / 4);
    k6_fixup<<<grid, 128, 0, st>>>(cut, a.part, a.pair, a.F);
  }
  pass<T>(src, out, a, true, st);
}

}  // namespace
}  // namespace pygt

// src [M, F] (f32 or bf16 by dtype; M >= e_pad when idx is null), idx
// [e_pad] int32 or null, out like src ([e_pad, F] written in full when idx
// is null; else the rows idx names). The derived tables (k6_rows and
// k6_cut in the wrapper): rows [2, num_rows] int32, the non-empty rows'
// first slots then their end slots, in slot order; cut [num_cut, 3] int32,
// each row that crosses a stretch end (its index in rows, its first and
// last stretch). stretch: slots a warp, a positive multiple of 32. pair
// [num_rows, F] and part [2 * ceil(e_pad / stretch), F] of (f32, f32) are
// scratch. Returns cudaGetLastError() after the launches.
extern "C" int pygt_segment_softmax(const void* src, int dtype,
                                    const void* idx, const void* rows,
                                    int num_rows, const void* cut,
                                    int num_cut, int e_pad, int F,
                                    int stretch, void* pair, void* part,
                                    void* out, void* stream) {
  using namespace pygt;
  if (stretch <= 0 || stretch % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* r = static_cast<const int*>(rows);
  Args a{static_cast<const int*>(idx), Rows{r, r + num_rows, num_rows},
         e_pad, stretch, (e_pad + stretch - 1) / stretch, F,
         static_cast<float2*>(pair), static_cast<float2*>(part)};
  const int* ct = static_cast<const int*>(cut);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      run<float>(src, out, a, ct, num_cut, st);
      break;
    case BF16:
      run<__nv_bfloat16>(src, out, a, ct, num_cut, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
