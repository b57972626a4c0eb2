// Shared helpers of the port's kernels: element loads/stores in float32 or
// bfloat16, and the dtype codes the ctypes wrappers pass (kernels/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

enum ReproDtype : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
// round to nearest even, as jnp's and torch's float32 -> bfloat16 casts do
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
