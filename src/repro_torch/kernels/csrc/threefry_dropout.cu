// Content-addressed dropout for Hopper (sm_90a): the mask of each sample is
// jax.random.bernoulli's, bit for bit, and the scale the jitted reference's.
//
// Replaces no Pallas kernel: the reference computes dropout in XLA
// (repro/models/layers.py:dropout), which fuses the threefry draws, the
// compare and the scale into one loop.  This is that loop.  For x [B, n]
// (n = the elements of one sample), sample b, flat index i < n:
//   key_b   = threefry2x32(key, (0, sample_ids[b]))         (fold_in)
//   bits    = y0 ^ y1 of threefry2x32(key_b, (i >> 32, i & 0xFFFFFFFF))
//   u       = bitcast_f32((bits >> 9) | 0x3F800000) - 1.0f
//   out[b,i] = u < p ? round(fl32(x[b,i]) * r) : 0
// with p = fl32(1 - rate) and r the float32 reciprocal the reference
// multiplies by (kernels/threefry.py:dropout_scalars).  The backward is the
// same function of the cotangent, so the mask is regenerated from the keys,
// never stored.
//
// Bound on this card: integer operations.  A threefry2x32 hash is 20 rounds
// of add, rotate, xor plus 12 key additions: 72 32-bit integer operations,
// 3 more make the uniform's bits; 75 an element against 4 bytes moved an
// element in bf16.  An SM issues 128 integer lanes a clock, split between
// the ALU pipe (logic, shifts, IADD3) and the multiply-add pipe (IMAD,
// which the compiler also uses for adds); at 132 SMs, ~1.98 GHz that is
// ~0.038 ms for [1, 4096, 4096], ~1.9x the ~0.020 ms its bytes take at
// 3.35 TB/s.  The rotations and xors run on the ALU pipe alone, so how
// the adds are split between the two pipes sets how close this comes.
//
// Design: one thread per kPerThread elements of one sample, strided by the
// block width so that a warp's loads and stores are contiguous.  A thread
// folds its sample's id once (one hash, amortized over its elements), then
// hashes each element's counter; the rotations are single funnel shifts
// (SHF), the key schedule's constants are formed once a thread, and the
// scale is __fmul_rn (no contraction) rounded to nearest even into bf16.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr unsigned kParity = 0x1BD11BDAu;

__device__ __forceinline__ unsigned rotl(unsigned x, int r) {
  return __funnelshift_l(x, x, r);
}

#define TF_ROUND(r)  \
  x0 += x1;          \
  x1 = rotl(x1, r);  \
  x1 ^= x0;

// threefry2x32 of (x0, x1) under the key (k0, k1, k2 = k0 ^ k1 ^ parity);
// kp1..kp5 are the second word's injections with their round numbers added
// (k2 + 1, k0 + 2, k1 + 3, k2 + 4, k0 + 5), hoisted by the caller
__device__ __forceinline__ void threefry2x32(unsigned k0, unsigned k1,
                                             unsigned k2, unsigned kp1,
                                             unsigned kp2, unsigned kp3,
                                             unsigned kp4, unsigned kp5,
                                             unsigned& x0, unsigned& x1) {
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1;
  x1 += kp1;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2;
  x1 += kp2;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0;
  x1 += kp3;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1;
  x1 += kp4;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2;
  x1 += kp5;
}

#undef TF_ROUND

__device__ __forceinline__ void threefry2x32(unsigned k0, unsigned k1,
                                             unsigned& x0, unsigned& x1) {
  const unsigned k2 = k0 ^ k1 ^ kParity;
  threefry2x32(k0, k1, k2, k2 + 1u, k0 + 2u, k1 + 3u, k2 + 4u, k0 + 5u, x0,
               x1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
threefry_dropout_kernel(const T* __restrict__ x, T* __restrict__ out,
                        const int* __restrict__ sample_ids, long long n,
                        long long blocks_per_sample, unsigned key0,
                        unsigned key1, float p, float r) {
  const long long b = blockIdx.x / blocks_per_sample;
  const long long first = (blockIdx.x - b * blocks_per_sample)
                              * (long long)(kThreads * kPerThread)
                          + threadIdx.x;
  // fold_in(key, sample id): the sample's key
  unsigned s0 = 0u, s1 = (unsigned)sample_ids[b];
  threefry2x32(key0, key1, s0, s1);
  const unsigned s2 = s0 ^ s1 ^ kParity;
  const unsigned sp1 = s2 + 1u, sp2 = s0 + 2u, sp3 = s1 + 3u, sp4 = s2 + 4u,
                 sp5 = s0 + 5u;
  const T* xb = x + b * n;
  T* ob = out + b * n;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = first + (long long)k * kThreads;
    if (i < n) {
      unsigned y0 = (unsigned)(i >> 32), y1 = (unsigned)i;
      threefry2x32(s0, s1, s2, sp1, sp2, sp3, sp4, sp5, y0, y1);
      const unsigned bits = y0 ^ y1;
      const float u = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u),
                                1.0f);
      const float v = load_f32(xb + i);
      store_from_f32(ob + i, u < p ? __fmul_rn(v, r) : 0.0f);
    }
  }
}

}  // namespace

extern "C" int repro_threefry_dropout(const void* x, void* out,
                                      const void* sample_ids, long long B,
                                      long long n, unsigned key0,
                                      unsigned key1, float p, float r,
                                      int dtype, void* stream) {
  if (B == 0 || n == 0) return (int)cudaGetLastError();
  const long long per_block = (long long)kThreads * kPerThread;
  const long long blocks_per_sample = (n + per_block - 1) / per_block;
  const long long blocks = B * blocks_per_sample;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kFloat32)
    threefry_dropout_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)x, (float*)out, (const int*)sample_ids, n,
        blocks_per_sample, key0, key1, p, r);
  else if (dtype == kBFloat16)
    threefry_dropout_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)out, (const int*)sample_ids,
        n, blocks_per_sample, key0, key1, p, r);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
