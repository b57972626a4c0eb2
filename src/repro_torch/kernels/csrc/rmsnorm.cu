// RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py:rmsnorm_kernel (body
// _rmsnorm_kernel): y = x * rsqrt(mean(x^2) + eps) * scale in float32, cast
// back to x's dtype.
//
// Bound on this card: bytes.  Per row it reads d inputs and writes d outputs
// and does ~4 flops per element, far below the ~295 flops per byte at which
// an H100 stops being memory bound.  At [4096, 4096] bf16 that is 67 MB, about
// 20 us at 3.35 TB/s.
//
// Design: one 256-thread block per row; the row is read once from device
// memory into registers-through-L1 (second pass hits L1/L2 for d <= 8192),
// the sum of squares is reduced in float32 with warp shuffles and one
// shared-memory step, and each thread writes its strided elements.
// Neighbouring threads touch neighbouring addresses on both passes.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const float* __restrict__ scale,
                               T* __restrict__ out, int d, float eps) {
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = out + row * d;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = load_f32(xr + i);
    ss += v * v;
  }
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);

  __shared__ float warp_sums[kThreads / 32];
  __shared__ float inv_rms;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    inv_rms = rsqrtf(total / (float)d + eps);
  }
  __syncthreads();
  const float r = inv_rms;
  for (int i = threadIdx.x; i < d; i += kThreads)
    store_from_f32(yr + i, load_f32(xr + i) * r * scale[i]);
}

}  // namespace

extern "C" int repro_rmsnorm(const void* x, const void* scale, void* out,
                             long long rows, int d, float eps, int dtype,
                             void* stream) {
  if (rows == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)rows);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kFloat32)
    rmsnorm_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)x, (const float*)scale, (float*)out, d, eps);
  else if (dtype == kBFloat16)
    rmsnorm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)scale, (__nv_bfloat16*)out, d,
        eps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
