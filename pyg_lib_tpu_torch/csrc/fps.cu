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
// other, and each ends in an argmax over the whole cloud. The bytes (each
// point read once, each index written once) take well under a
// millisecond over 3.35 TB/s, and the (m - 1) * n * (3D + 2) operations
// of one cloud of 100,000 points at ratio 0.1 0.164 ms over 67 TFLOP/s
// (NVIDIA H100 SXM data sheet, 700 W); the chain of m argmaxes, and for a
// large cloud each step's pass over its points, is what the time is made
// of. fps_floor_block and fps_floor_cluster below run the chain alone,
// with no distance work, to measure it.
//
// Three tiers, one launch a batch; a batch takes the tier of its largest
// cloud (the planner, `_f1_plan` in ops/kernels/fps.py, picks the tier,
// the cluster size C, the threads, ITEMS and the shared memory):
//
// * S (small clouds of D = REG_D, a point cloud's 3 coordinates: at most
//   S_THREADS * 16 points): one block a cloud. Each thread holds its
//   ITEMS points' coordinates and running distances in registers, ITEMS *
//   (D + 1) <= 64 floats, and keeps its best (distance, index) in increasing index
//   order with a strict >, so the lowest index of its maxima, and that
//   point's coordinates beside it. A step is one warp butterfly, one
//   block barrier and one butterfly over the warps' candidates: the lane
//   that holds its warp's winner writes the candidate and its coordinates
//   to shared memory (double-buffered by step parity, so the one barrier
//   suffices), and every warp then reduces the candidates itself and
//   reads the winner's coordinates from its warp's slot. Bound: the chain
//   of m - 1 such steps (fps_floor_block).
// * C (clouds whose slices fit a cluster's shared memory): one
//   thread-block cluster of C blocks (2 to 16; 16 is a non-portable size)
//   a cloud. Block r holds the contiguous slice [r * S, (r + 1) * S), S =
//   ceil(n / C), in dynamic shared memory: the D coordinates as D arrays
//   of S floats (thread j reads word j: no bank conflicts) and the running
//   distances. A step: the walk over the slice; the block's argmax
//   (butterfly, block barrier, warp 0 over the warps); then warp 0 alone
//   exchanges with the other blocks through distributed shared memory:
//   lane r writes the block's candidate (distance, index and the point's
//   coordinates) into slot `rank` of block r's inbox and arrives on block
//   r's mbarrier (release, cluster scope), waits on its own mbarrier for
//   the C candidates (acquire), and reduces them in the same total order,
//   so every block holds the same winner; a second block barrier hands it
//   to the block. Inboxes and mbarriers are double-buffered by step
//   parity. A cluster barrier a step (every thread of every block
//   arriving) cost 2.0 µs a step at C = 8 and 512 threads, 6.8 at C = 16
//   and 1024; this exchange 1.07 and 1.36 (tools/time_fps.py).
//   Bound: the chain of m - 1 steps, each two block barriers and one
//   exchange (fps_floor_cluster), and each block's pass over its slice in
//   shared memory.
// * G (clouds beyond the cluster's shared memory): the same cluster and
//   exchange; each block streams its slice's coordinates from device
//   memory (L2 holds 12 MB for 10^6 points at D = 3) and keeps its
//   distances in `scratch` at the cloud's own rows. Bound: each block's
//   pass over its slice through L2 a step (about 77 GB/s an SM).
//
// The kernels hold points in registers for D = REG_D alone, the D of every
// point cloud the port samples (tier S, and the winner's coordinates that
// tiers C and G carry through the exchange). Any other D takes tier C or
// G in their runtime-D form, at any cloud size: warp 0 reads the winner's
// coordinates from the owning block's shared memory (C) or from pos (G)
// into a small shared array, and the walk loops over D at run time. At D
// = 3 that form took 59.5 ms on one cloud of 100,000 and 364.8 on one of
// 1,000,000, against 25.4 and 175.4 in registers (tools/time_fps.py).
//
// Measured on NVIDIA H100 80GB HBM3, 700 W (tools/time_fps.py, both
// designs through their bare C interfaces; PERF.md section 6 has the
// smoke's): PointNet++'s 32 clouds of 1,024 at ratio 0.5, 0.317-0.320 ms
// (profiler: 0.296 ms of kernel; the one-block design 0.504-0.506),
// floor 0.202-0.205; its 32 clouds of 512 at ratio 0.25, 0.070-0.073
// (0.090-0.091 before); one cloud of 100,000 at ratio 0.1, 25.4-25.5 ms
// (622.2-622.4 before), floor 10.65; eight such clouds in one launch
// 25.4-25.5 ms (637.9-638.2 before); one cloud of 1,000,000 at ratio
// 0.01, 175.4 ms (6,130-6,135 before), floor 13.6.
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

#ifndef F1_S_THREADS
#define F1_S_THREADS 256
#endif
#ifndef F1_C_THREADS
#define F1_C_THREADS 512
#endif
#ifndef F1_G_THREADS
#define F1_G_THREADS 1024
#endif

namespace cg = cooperative_groups;

namespace pygt {
namespace {

constexpr int S_THREADS = F1_S_THREADS;  // tier S: threads of a block
constexpr int C_THREADS = F1_C_THREADS;  // tier C: threads of a block
constexpr int G_THREADS = F1_G_THREADS;  // tier G: threads of a block
constexpr int REG_D = 3;  // the D whose points the kernels hold in registers
constexpr int NO_INDEX = 0x7fffffff;

__device__ __forceinline__ float pos_inf() {
  return __int_as_float(0x7f800000);
}

__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// The winner of (v, i) over each group of G lanes (G a power of two up to
// 32); every lane ends with its group's winner.
template <int G>
__device__ __forceinline__ void group_best(float& v, int& i) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    better(v, i, __shfl_xor_sync(FULL, v, o), __shfl_xor_sync(FULL, i, o));
}

__device__ __forceinline__ void group_best(float& v, int& i, int g) {
  for (int o = g / 2; o > 0; o >>= 1)
    better(v, i, __shfl_xor_sync(FULL, v, o), __shfl_xor_sync(FULL, i, o));
}

// Adds (x - l)^2 to s, each operation rounded once.
__device__ __forceinline__ float add_sq(float s, float x, float l) {
  const float t = __fsub_rn(x, l);
  return __fadd_rn(s, __fmul_rn(t, t));
}

// Tier S. table: per cloud {lo, n, m, start, off} (int64); one block a
// cloud of at most S_THREADS * ITEMS points of REG_D coordinates.
template <int ITEMS>
__global__ void __launch_bounds__(S_THREADS)
    fps_block_kernel(const float* __restrict__ pos,
                     const int64_t* __restrict__ table,
                     int32_t* __restrict__ out) {
  constexpr int WARPS = S_THREADS / 32, D = REG_D;
  __shared__ float sv[2][WARPS];
  __shared__ int si[2][WARPS];
  __shared__ float sx[2][WARPS][D];
  const int64_t* t = table + 5 * static_cast<int64_t>(blockIdx.x);
  const int64_t lo = t[0], m = t[2], off = t[4];
  const int n = static_cast<int>(t[1]);
  const float* P = pos + lo * D;
  int last = static_cast<int>(t[3]);
  int32_t* o = out + off;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float x[ITEMS][D], dist[ITEMS], L[D];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int p = threadIdx.x + k * S_THREADS;
    dist[k] = pos_inf();
#pragma unroll
    for (int d = 0; d < D; ++d)
      x[k][d] = p < n ? __ldg(P + static_cast<int64_t>(p) * D + d) : 0.f;
  }
#pragma unroll
  for (int d = 0; d < D; ++d)
    L[d] = __ldg(P + static_cast<int64_t>(last) * D + d);
  if (threadIdx.x == 0) o[0] = static_cast<int32_t>(lo + last);
  for (int64_t s = 1; s < m; ++s) {
    const int par = static_cast<int>(s & 1);
    float bv = neg_inf();
    int bi = NO_INDEX;
    float bx[D];
#pragma unroll
    for (int d = 0; d < D; ++d) bx[d] = 0.f;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int p = threadIdx.x + k * S_THREADS;
      if (p < n) {
        float q = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) q = add_sq(q, x[k][d], L[d]);
        dist[k] = fminf(dist[k], q);
        if (dist[k] > bv) {
          bv = dist[k];
          bi = p;
#pragma unroll
          for (int d = 0; d < D; ++d) bx[d] = x[k][d];
        }
      }
    }
    float v = bv;
    int i = bi;
    group_best<32>(v, i);
    // The lane that holds its warp's winner writes it with its
    // coordinates (lane 0 for a warp without points).
    const unsigned own = __ballot_sync(FULL, bi == i);
    if (lane == __ffs(own) - 1) {
      sv[par][w] = v;
      si[par][w] = i;
#pragma unroll
      for (int d = 0; d < D; ++d) sx[par][w][d] = bx[d];
    }
    __syncthreads();
    v = sv[par][lane & (WARPS - 1)];
    i = si[par][lane & (WARPS - 1)];
    group_best<WARPS>(v, i);
    last = i;
    // Point i belongs to thread i % S_THREADS.
    const int ww = (i & (S_THREADS - 1)) >> 5;
#pragma unroll
    for (int d = 0; d < D; ++d) L[d] = sx[par][ww][d];
    if (threadIdx.x == 0) o[s] = static_cast<int32_t>(lo + last);
  }
}

// Distributed shared memory by PTX: the address of a shared variable,
// its counterpart in block `rank` of the cluster, a store there, an
// mbarrier arrive there (release, cluster scope), and a wait on a local
// mbarrier's phase (acquire, cluster scope).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t at_rank(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(uint32_t a, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(a), "f"(v)
               : "memory");
}
__device__ __forceinline__ void st_cluster(uint32_t a, int v) {
  asm volatile("st.shared::cluster.s32 [%0], %1;" ::"r"(a), "r"(v)
               : "memory");
}
__device__ __forceinline__ void arrive_cluster(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
          bar)
      : "memory");
}
__device__ __forceinline__ void wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// Inboxes and barriers of the push exchange: each step, warp 0 of every
// block writes its block's candidate (value, index, coordinates) into
// slot `rank` of every block's inbox[par] and arrives on that block's
// bar[par]; a block's warp 0 waits for the C arrivals and reduces its
// inbox. bar[par] completes a phase a use: the k-th use of bar[1] is step
// 2k + 1, of bar[0] step 2k + 2, so step s waits on parity ((s - 1) >> 1)
// & 1. A
// block writes inbox[par] of another two steps on only after that block's
// candidate of the step between has reached it, which the other sends
// after reading its inbox.
template <int DR>
struct Inbox {
  uint64_t bar[2];
  float v[2][16];
  int i[2][16];
  float x[2][16][DR];
};

// Warp 0: the cluster's winner of the blocks' candidates (v, i; x the DR
// floats carried with i) of step s into v and i, and its floats into x,
// in every lane.
template <int DR>
__device__ __forceinline__ void push_exchange(Inbox<DR>& box, int64_t s,
                                              int C, int rank, float& v,
                                              int& i, float* x) {
  const int lane = threadIdx.x & 31, par = static_cast<int>(s & 1);
  __syncwarp();
  if (lane < C) {
    const uint32_t r = static_cast<uint32_t>(lane);
    st_cluster(at_rank(smem_addr(&box.v[par][rank]), r), v);
    st_cluster(at_rank(smem_addr(&box.i[par][rank]), r), i);
#pragma unroll
    for (int d = 0; d < DR; ++d)
      st_cluster(at_rank(smem_addr(&box.x[par][rank][d]), r), x[d]);
    arrive_cluster(at_rank(smem_addr(&box.bar[par]), r));
  }
  wait_cluster(smem_addr(&box.bar[par]),
               static_cast<uint32_t>(((s - 1) >> 1) & 1));
  const int from = lane & (C - 1);
  v = box.v[par][from];
  i = box.i[par][from];
  const int offered = i;
  float rx[DR];
#pragma unroll
  for (int d = 0; d < DR; ++d) rx[d] = box.x[par][from][d];
  group_best(v, i, C);
  // The lowest lane that read the winner's slot holds its coordinates.
  const int owner = __ffs(__ballot_sync(FULL, offered == i)) - 1;
#pragma unroll
  for (int d = 0; d < DR; ++d) x[d] = __shfl_sync(FULL, rx[d], owner);
}

// Tiers C (RESIDENT, C_THREADS a block) and G (G_THREADS). One cluster a
// cloud; block `rank` of the cluster walks the slice [rank * S, rank * S +
// cnt). A step: the walk; the block's argmax (butterfly, barrier, warp 0
// over the warps); warp 0's push exchange with the other blocks (only
// warp 0 of each block takes part); a block barrier after which every
// thread reads the winner from shared memory. DM == REG_D carries the
// winner's coordinates through the exchange and holds them in registers
// (D == DM); DM == 0 takes any D (d_rt): warp 0 reads the winner's
// coordinates from the owning block's shared memory (C) or from pos (G)
// into lc. Dynamic shared memory: RESIDENT, D * S coordinates, S
// distances, then DM == 0's D floats; else DM == 0's D floats.
template <int DM, bool RESIDENT>
__global__ void __launch_bounds__(RESIDENT ? C_THREADS : G_THREADS)
    fps_cluster_kernel(const float* __restrict__ pos, int d_rt,
                       const int64_t* __restrict__ table,
                       int32_t* __restrict__ out,
                       float* __restrict__ scratch) {
  constexpr int THREADS = RESIDENT ? C_THREADS : G_THREADS;
  constexpr int WARPS = THREADS / 32;
  constexpr int DR = DM > 0 ? DM : 1;
  extern __shared__ float smem[];
  __shared__ float wv[WARPS];
  __shared__ int wi[WARPS];
  __shared__ int win;
  __shared__ float wx[DR];
  __shared__ __align__(8) Inbox<DR> box;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int D = DM > 0 ? DM : d_rt;
  const int64_t* t = table + 5 * static_cast<int64_t>(blockIdx.x / C);
  const int64_t lo = t[0], m = t[2], off = t[4];
  const int n = static_cast<int>(t[1]);
  const float* P = pos + lo * D;
  int last = static_cast<int>(t[3]);
  int32_t* o = out + off;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int S = (n + C - 1) / C, base = rank * S;
  const int cnt = max(0, min(S, n - base));
  float* xs = smem;
  float* ds = RESIDENT ? smem + static_cast<int64_t>(D) * S
                       : scratch + lo + base;
  float* lc = RESIDENT ? smem + static_cast<int64_t>(D + 1) * S : smem;
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                       smem_addr(&box.bar[k])),
                   "r"(C)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int j = threadIdx.x; j < cnt; j += THREADS) {
    if (RESIDENT)
      for (int d = 0; d < D; ++d)
        xs[d * S + j] = __ldg(P + static_cast<int64_t>(base + j) * D + d);
    ds[j] = pos_inf();
  }
  float L[DR];
  if (DM > 0) {
#pragma unroll
    for (int d = 0; d < DR; ++d)
      L[d] = __ldg(P + static_cast<int64_t>(last) * D + d);
  } else {
    for (int d = threadIdx.x; d < D; d += THREADS)
      lc[d] = __ldg(P + static_cast<int64_t>(last) * D + d);
  }
  // Every block's barriers are set up, and every block runs, before any
  // block writes to another.
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) o[0] = static_cast<int32_t>(lo + last);
  for (int64_t s = 1; s < m; ++s) {
    float v = neg_inf();
    int i = NO_INDEX;
    for (int j = threadIdx.x; j < cnt; j += THREADS) {
      const float* pj = P + static_cast<int64_t>(base + j) * D;
      float q = 0.f;
      if (DM > 0) {
#pragma unroll
        for (int d = 0; d < DR; ++d)
          q = add_sq(q, RESIDENT ? xs[d * S + j] : __ldg(pj + d), L[d]);
      } else {
        for (int d = 0; d < D; ++d)
          q = add_sq(q, RESIDENT ? xs[d * S + j] : __ldg(pj + d), lc[d]);
      }
      const float dd = fminf(ds[j], q);
      ds[j] = dd;
      if (dd > v) {
        v = dd;
        i = base + j;
      }
    }
    // wv, wi, win and wx need no second buffer: warp 0 reads wv and wi,
    // and writes win and wx, between the two block barriers of a step.
    group_best<32>(v, i);
    if (lane == 0) {
      wv[w] = v;
      wi[w] = i;
    }
    __syncthreads();
    if (w == 0) {
      v = wv[lane & (WARPS - 1)];
      i = wi[lane & (WARPS - 1)];
      group_best<WARPS>(v, i);
      float x[DR];
#pragma unroll
      for (int d = 0; d < DR; ++d)
        x[d] = (DM > 0 && i != NO_INDEX)
                   ? (RESIDENT ? xs[d * S + i - base]
                               : __ldg(P + static_cast<int64_t>(i) * D + d))
                   : 0.f;
      push_exchange<DR>(box, s, C, rank, v, i, x);
      if (lane == 0) {
        win = i;
#pragma unroll
        for (int d = 0; d < DR; ++d) wx[d] = x[d];
      }
      if (DM == 0) {
        // Every thread read lc in this step's walk before the barrier.
        const int owner = i / S;
        const float* src = RESIDENT ? cluster.map_shared_rank(xs, owner)
                                    : P;
        const int64_t at =
            RESIDENT ? i - owner * S : i * static_cast<int64_t>(D);
        const int stride = RESIDENT ? S : 1;
        for (int d = lane; d < D; d += 32)
          lc[d] = src[at + static_cast<int64_t>(d) * stride];
      }
    }
    __syncthreads();
    last = win;
    if (DM > 0) {
#pragma unroll
      for (int d = 0; d < DR; ++d) L[d] = wx[d];
    }
    if (rank == 0 && threadIdx.x == 0) o[s] = static_cast<int32_t>(lo + last);
  }
  // No block leaves while another may still touch its shared memory.
  cluster.sync();
}

// F1's latency floor, tier S: per cloud of the same table, the same m - 1
// dependent steps of fps_block_kernel with no distance work. Each thread
// offers one (value, index), the value a hash of its index and the last
// winner; the lane holding its warp's winner writes it with one
// "coordinate" (the index), which the next step's hash reads, so every
// step waits for the one before; out gets the winners.
__global__ void __launch_bounds__(S_THREADS)
    fps_floor_block(const int64_t* __restrict__ table,
                    int32_t* __restrict__ out) {
  constexpr int WARPS = S_THREADS / 32;
  __shared__ float sv[2][WARPS];
  __shared__ int si[2][WARPS];
  __shared__ int sx[2][WARPS];
  const int64_t* t = table + 5 * static_cast<int64_t>(blockIdx.x);
  const int64_t lo = t[0], m = t[2], off = t[4];
  int last = static_cast<int>(t[3]);
  int32_t* o = out + off;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (threadIdx.x == 0) o[0] = static_cast<int32_t>(lo + last);
  for (int64_t s = 1; s < m; ++s) {
    const int par = static_cast<int>(s & 1);
    const unsigned h =
        (threadIdx.x ^ static_cast<unsigned>(last)) * 2654435761u;
    float v = __uint_as_float(0x3f800000u | (h >> 9));
    int i = static_cast<int>(threadIdx.x);
    const int mine = i;
    group_best<32>(v, i);
    if (mine == i) {
      sv[par][w] = v;
      si[par][w] = i;
      sx[par][w] = mine;
    }
    __syncthreads();
    v = sv[par][lane & (WARPS - 1)];
    i = si[par][lane & (WARPS - 1)];
    group_best<WARPS>(v, i);
    last = sx[par][i >> 5];
    if (threadIdx.x == 0) o[s] = static_cast<int32_t>(lo + last);
  }
}

// F1's latency floor, tiers C and G: per cloud, one cluster runs the m - 1
// dependent steps of fps_cluster_kernel with no distance work: each
// thread offers one (value, index), the block's argmax, warp 0's push
// exchange with one "coordinate" (the index), which the next step's hash
// reads, and the block barrier after it. Launched with the plan's shared
// memory, so that its blocks sit on the SMs as the kernel's do.
template <bool RESIDENT>
__global__ void __launch_bounds__(RESIDENT ? C_THREADS : G_THREADS)
    fps_floor_cluster(const int64_t* __restrict__ table,
                      int32_t* __restrict__ out) {
  constexpr int THREADS = RESIDENT ? C_THREADS : G_THREADS;
  constexpr int WARPS = THREADS / 32;
  __shared__ float wv[WARPS];
  __shared__ int wi[WARPS];
  __shared__ int win;
  __shared__ __align__(8) Inbox<1> box;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t* t = table + 5 * static_cast<int64_t>(blockIdx.x / C);
  const int64_t lo = t[0], m = t[2], off = t[4];
  int last = static_cast<int>(t[3]);
  int32_t* o = out + off;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int mine = rank * THREADS + static_cast<int>(threadIdx.x);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                       smem_addr(&box.bar[k])),
                   "r"(C)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) o[0] = static_cast<int32_t>(lo + last);
  for (int64_t s = 1; s < m; ++s) {
    const unsigned h = (static_cast<unsigned>(mine) ^
                        static_cast<unsigned>(last)) * 2654435761u;
    float v = __uint_as_float(0x3f800000u | (h >> 9));
    int i = mine;
    group_best<32>(v, i);
    if (lane == 0) {
      wv[w] = v;
      wi[w] = i;
    }
    __syncthreads();
    if (w == 0) {
      v = wv[lane & (WARPS - 1)];
      i = wi[lane & (WARPS - 1)];
      group_best<WARPS>(v, i);
      float x[1] = {__int_as_float(i)};
      push_exchange<1>(box, s, C, rank, v, i, x);
      if (lane == 0) win = __float_as_int(x[0]);
    }
    __syncthreads();
    last = win;
    if (rank == 0 && threadIdx.x == 0) o[s] = static_cast<int32_t>(lo + last);
  }
  cluster.sync();
}

template <int ITEMS>
int launch_block(const float* pos, const int64_t* table, int clouds,
                 int32_t* out, cudaStream_t stream) {
  fps_block_kernel<ITEMS><<<clouds, S_THREADS, 0, stream>>>(pos, table, out);
  return static_cast<int>(cudaGetLastError());
}

int launch_items(int items, const float* pos, const int64_t* table,
                 int clouds, int32_t* out, cudaStream_t stream) {
  switch (items) {
    case 1:
      return launch_block<1>(pos, table, clouds, out, stream);
    case 2:
      return launch_block<2>(pos, table, clouds, out, stream);
    case 4:
      return launch_block<4>(pos, table, clouds, out, stream);
    case 8:
      return launch_block<8>(pos, table, clouds, out, stream);
    case 16:
      return launch_block<16>(pos, table, clouds, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

using ClusterFn = void (*)(const float*, int, const int64_t*, int32_t*,
                           float*);

template <bool RESIDENT>
ClusterFn cluster_fn(int D) {
  return D == REG_D ? fps_cluster_kernel<REG_D, RESIDENT>
                    : fps_cluster_kernel<0, RESIDENT>;
}

// A launch configuration of `C`-block clusters over `clouds` clouds, and
// the kernel's attributes for it (16-block clusters, `smem` bytes of
// dynamic shared memory).
cudaError_t cluster_config(const void* fn, int clouds, int C, int threads,
                           int smem, cudaStream_t stream,
                           cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(clouds) * C);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = static_cast<size_t>(smem);
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(C);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

bool cluster_size_ok(int C) { return C == 2 || C == 4 || C == 8 || C == 16; }

int tier_threads(int tier) {
  return tier == 0 ? S_THREADS
                   : tier == 1 ? C_THREADS : tier == 2 ? G_THREADS : 0;
}

// A refused call's error, with the runtime's last error cleared (a later
// launch checked with cudaGetLastError() would read it again), else
// cudaGetLastError().
int refused(cudaError_t e) {
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace
}  // namespace pygt

// pos [N, D] f32; table [clouds, 5] int64 of {lo, n, m, start, off} with
// 1 <= n and 1 <= m; out [Σ m] int32 (written in full). `tier`: 0 (S:
// one block of `threads` == S_THREADS a cloud, `items` register points a
// thread, 1, 2, 4, 8 or 16; D == 3 only), 1 (C: a cluster of `cluster`
// blocks a cloud, 2, 4, 8 or 16, of `threads` == C_THREADS each, `smem`
// bytes of dynamic shared memory holding the slices) or 2 (G: the same
// with G_THREADS, the slices streamed from pos and their distances in
// scratch [N] f32 at the clouds' own rows). `items` is read in tier S
// only. Returns the launch's error, else cudaGetLastError() after it.
extern "C" int pygt_fps(const void* pos, int D, const void* table,
                        int clouds, void* out, void* scratch, int tier,
                        int cluster, int threads, int items, int smem,
                        void* stream) {
  using namespace pygt;
  const float* p = static_cast<const float*>(pos);
  const int64_t* t = static_cast<const int64_t*>(table);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (clouds <= 0 || D <= 0 || threads != tier_threads(tier))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tier == 0)
    return D == REG_D ? launch_items(items, p, t, clouds, o, s)
                      : static_cast<int>(cudaErrorInvalidValue);
  if (!cluster_size_ok(cluster) || smem < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const ClusterFn fn = tier == 1 ? cluster_fn<true>(D) : cluster_fn<false>(D);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config(reinterpret_cast<const void*>(fn), clouds,
                                 cluster, threads, smem, s, &cfg, &attr);
  if (e == cudaSuccess)
    e = cudaLaunchKernelEx(&cfg, fn, p, D, t, o,
                           static_cast<float*>(scratch));
  return refused(e);
}

// How many clusters of the kernel pygt_fps launches for (D, tier 1 or 2,
// cluster, smem) the card holds at once, into *active. Returns the
// query's error.
extern "C" int pygt_fps_active_clusters(int D, int tier, int cluster,
                                        int smem, int* active) {
  using namespace pygt;
  *active = 0;
  if (D <= 0 || (tier != 1 && tier != 2) || !cluster_size_ok(cluster) ||
      smem < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const ClusterFn fn = tier == 1 ? cluster_fn<true>(D) : cluster_fn<false>(D);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config(reinterpret_cast<const void*>(fn), 1,
                                 cluster, tier_threads(tier), smem, 0, &cfg,
                                 &attr);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(active,
                                       reinterpret_cast<const void*>(fn),
                                       &cfg);
  return refused(e);
}

// F1's latency floor over the same table and out, in the form of `tier`:
// 0 runs fps_floor_block (one block of S_THREADS a cloud), 1 and 2
// fps_floor_cluster (one cluster of `cluster` blocks of the tier's threads
// a cloud, with `smem` bytes of dynamic shared memory a block). Returns
// the launch's error, else cudaGetLastError() after it.
extern "C" int pygt_fps_floor(const void* table, int clouds, void* out,
                              int tier, int cluster, int smem, void* stream) {
  using namespace pygt;
  const int64_t* t = static_cast<const int64_t*>(table);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (clouds <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (tier == 0) {
    fps_floor_block<<<clouds, S_THREADS, 0, s>>>(t, o);
    return static_cast<int>(cudaGetLastError());
  }
  if ((tier != 1 && tier != 2) || !cluster_size_ok(cluster) || smem < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  void (*fn)(const int64_t*, int32_t*) =
      tier == 1 ? fps_floor_cluster<true> : fps_floor_cluster<false>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config(reinterpret_cast<const void*>(fn), clouds,
                                 cluster, tier_threads(tier), smem, s, &cfg,
                                 &attr);
  if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, fn, t, o);
  return refused(e);
}
