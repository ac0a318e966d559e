// Shared pieces of the planned-SpMM kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pygt {

constexpr int TR = 128;      // output rows per tile (the plans' tile height)
constexpr int TP = 256;      // lanes of one tile_ptr row
constexpr int PTR_SUB = 8;   // sublane copies of each tile_ptr row
constexpr int META_SUB = 8;  // rows of one edge_meta block
constexpr unsigned FULL = 0xffffffffu;

// Element type codes shared with the Python wrappers.
enum DType : int { F32 = 0, BF16 = 1, I8 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

// Values per lane of an F-block: the least power of two up to `cap` with
// 32 * vpl >= F.
inline int pick_vpl(int F, int cap) {
  int v = 1;
  while (v < cap && 32 * v < F) v *= 2;
  return v;
}

}  // namespace pygt
