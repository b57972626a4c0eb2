// Fused AdamW over flat float32 vectors for Hopper (sm_90a), in place.
//
// Replaces the TPU kernel repro/kernels/fused_adam.py:fused_adam_kernel (body
// _fused_adam_body), and with it the host numpy update the reference's
// train step runs per stage (optim/adam.py:adam_update_flat_np).
//
// Bound on this card: bytes.  Each element reads grad, master, mu and nu and
// writes master, mu and nu: 28 bytes for ~12 flops.  A stage of 610.8 M
// elements moves 17.1 GB, ~5.1 ms at 3.35 TB/s.
//
// Design: the arithmetic of each element is fixed; only how bytes move is
// tuned.  Every operation is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), which the compiler never
// contracts into an FMA, in numpy's association:
//   mu  = b1*mu + (1-b1)*g
//   nu  = b2*nu + ((1-b2)*g)*g
//   upd = (mu/b1t) / (sqrt(nu/b2t) + eps) + wd*master
//   master = master - lr*upd
// The scalars arrive at run time, rounded to float32 on the host exactly as
// adam_update_flat_np rounds them, so the result is bitwise equal to it.
// Bytes: when the four operands share their offset from a 16-byte boundary
// (always, for the flat stage buffers), the body moves float4s with
// streaming loads and stores (__ldcs/__stcs: each byte is touched once),
// kUnroll float4s per operand per thread per iteration (256 bytes in
// flight per thread), over a grid of the blocks that are resident on the
// card at once; a scalar head and tail cover an unaligned start and
// n % 4.  Operands with different offsets take a scalar grid-stride loop.
// Updates are in place (no output buffers).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

struct AdamScalars {
  float b1, omb1, b2, omb2, b1t, b2t, eps, lr, wd;
};

// one element: w, m, v in; master, mu, nu out
__device__ __forceinline__ void adam(const AdamScalars& c, float g, float& w,
                                     float& m, float& v) {
  m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g));
  v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(__fmul_rn(c.omb2, g), g));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c.b2t)), c.eps);
  const float upd =
      __fadd_rn(__fdiv_rn(__fdiv_rn(m, c.b1t), denom), __fmul_rn(c.wd, w));
  w = __fsub_rn(w, __fmul_rn(c.lr, upd));
}

__device__ __forceinline__ void adam_at(const AdamScalars& c,
                                        const float* __restrict__ grad,
                                        float* __restrict__ master,
                                        float* __restrict__ mu,
                                        float* __restrict__ nu, long long i) {
  float w = master[i], m = mu[i], v = nu[i];
  adam(c, grad[i], w, m, v);
  master[i] = w;
  mu[i] = m;
  nu[i] = v;
}

// elements [0, head) and [head + 4*n4, n) one per thread; [head, head +
// 4*n4) as n4 float4s.  n4 == 0 and head == 0 with a grid-stride scalar
// loop over everything when the operands are not co-aligned (vec false).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(const float* __restrict__ grad, float* __restrict__ master,
                  float* __restrict__ mu, float* __restrict__ nu, long long n,
                  int head, long long n4, AdamScalars c) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * kThreads;
  if (!kVec) {
    for (long long i = tid; i < n; i += nthreads)
      adam_at(c, grad, master, mu, nu, i);
    return;
  }
  const long long tail0 = head + 4 * n4;
  if (tid < head) adam_at(c, grad, master, mu, nu, tid);
  if (tid < n - tail0) adam_at(c, grad, master, mu, nu, tail0 + tid);

  const float4* g4 = reinterpret_cast<const float4*>(grad + head);
  float4* w4 = reinterpret_cast<float4*>(master + head);
  float4* m4 = reinterpret_cast<float4*>(mu + head);
  float4* v4 = reinterpret_cast<float4*>(nu + head);
  for (long long i0 = (long long)blockIdx.x * kThreads * kUnroll + threadIdx.x;
       i0 < n4; i0 += nthreads * kUnroll) {
    float4 g[kUnroll], w[kUnroll], m[kUnroll], v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + (long long)u * kThreads;
      if (i < n4) {
        g[u] = __ldcs(g4 + i);
        w[u] = __ldcs(w4 + i);
        m[u] = __ldcs(m4 + i);
        v[u] = __ldcs(v4 + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + (long long)u * kThreads;
      if (i < n4) {
        adam(c, g[u].x, w[u].x, m[u].x, v[u].x);
        adam(c, g[u].y, w[u].y, m[u].y, v[u].y);
        adam(c, g[u].z, w[u].z, m[u].z, v[u].z);
        adam(c, g[u].w, w[u].w, m[u].w, v[u].w);
        __stcs(w4 + i, w[u]);
        __stcs(m4 + i, m[u]);
        __stcs(v4 + i, v[u]);
      }
    }
  }
}

// blocks of a kernel resident on the whole card at once (cached per kernel)
template <bool kVec>
int resident_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fused_adam_kernel<kVec>, kThreads, 0) != cudaSuccess)
      return 0;
    blocks = sms * per_sm;
  }
  return blocks;
}

}  // namespace

extern "C" int repro_fused_adam(const void* grad, void* master, void* mu,
                                void* nu, long long n, float b1, float omb1,
                                float b2, float omb2, float b1t, float b2t,
                                float eps, float lr, float wd, void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  const AdamScalars c{b1, omb1, b2, omb2, b1t, b2t, eps, lr, wd};
  // byte offset of each operand from a 16-byte boundary
  const uintptr_t off = ((uintptr_t)grad & 15);
  const bool vec = ((uintptr_t)master & 15) == off &&
                   ((uintptr_t)mu & 15) == off && ((uintptr_t)nu & 15) == off;
  // a start off the boundary leaves 1-3 elements before the first float4
  const long long head =
      vec ? std::min<long long>(((16 - off) & 15) / 4, n) : 0;
  const long long body = vec ? (n - head) / 4 : 0;
  const int resident = vec ? resident_blocks<true>() : resident_blocks<false>();
  if (resident == 0) {
    const cudaError_t e = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : cudaErrorUnknown);
  }
  const long long per_thread = vec ? (body + kUnroll - 1) / kUnroll : n;
  const long long want = std::max<long long>(
      1, std::min<long long>((per_thread + kThreads - 1) / kThreads, resident));
  const int blocks = (int)want;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    fused_adam_kernel<true><<<blocks, kThreads, 0, st>>>(
        (const float*)grad, (float*)master, (float*)mu, (float*)nu, n,
        (int)head, body, c);
  else
    fused_adam_kernel<false><<<blocks, kThreads, 0, st>>>(
        (const float*)grad, (float*)master, (float*)mu, (float*)nu, n, 0, 0,
        c);
  return (int)cudaGetLastError();
}
