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
// Design: one thread per element over a grid-stride loop, neighbouring
// threads on neighbouring addresses, updating in place (no output buffers).
// Every operation is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn, __fsqrt_rn), which the compiler never contracts into
// an FMA, in numpy's association:
//   mu  = b1*mu + (1-b1)*g
//   nu  = b2*nu + ((1-b2)*g)*g
//   upd = (mu/b1t) / (sqrt(nu/b2t) + eps) + wd*master
//   master = master - lr*upd
// The scalars arrive at run time, rounded to float32 on the host exactly as
// adam_update_flat_np rounds them, so the result is bitwise equal to it.
#include <cuda_runtime.h>

namespace {

struct AdamScalars {
  float b1, omb1, b2, omb2, b1t, b2t, eps, lr, wd;
};

__global__ void fused_adam_kernel(const float* __restrict__ grad,
                                  float* __restrict__ master,
                                  float* __restrict__ mu,
                                  float* __restrict__ nu, long long n,
                                  AdamScalars c) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float g = grad[i];
    const float w = master[i];
    const float m = __fadd_rn(__fmul_rn(c.b1, mu[i]), __fmul_rn(c.omb1, g));
    const float v =
        __fadd_rn(__fmul_rn(c.b2, nu[i]), __fmul_rn(__fmul_rn(c.omb2, g), g));
    const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c.b2t)), c.eps);
    const float upd =
        __fadd_rn(__fdiv_rn(__fdiv_rn(m, c.b1t), denom), __fmul_rn(c.wd, w));
    master[i] = __fsub_rn(w, __fmul_rn(c.lr, upd));
    mu[i] = m;
    nu[i] = v;
  }
}

}  // namespace

extern "C" int repro_fused_adam(const void* grad, void* master, void* mu,
                                void* nu, long long n, float b1, float omb1,
                                float b2, float omb2, float b1t, float b2t,
                                float eps, float lr, float wd, void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  constexpr int kThreads = 256;
  // enough blocks to fill 132 SMs several times over; the loop covers the rest
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132 * 32 ? want : 132 * 32);
  const AdamScalars c{b1, omb1, b2, omb2, b1t, b2t, eps, lr, wd};
  fused_adam_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)grad, (float*)master, (float*)mu, (float*)nu, n, c);
  return (int)cudaGetLastError();
}
