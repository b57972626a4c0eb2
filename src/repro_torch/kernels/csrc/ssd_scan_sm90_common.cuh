// What the two tensor-core SSD scans (ssd_scan_sm90.cu, bf16 x, B and C;
// ssd_scan_sm90_f32.cu, float32) share: the widths both take, the
// cp.async and mma.sync wrappers, the split of a float32 pair into three
// bf16 pieces, the chunk's decay sums in double, and the state pass, whose
// float32 workspace is the same in both.  Each including file gets its own
// copy (internal linkage), as with the rest of its kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // rows of a chunk tile (i or j)
constexpr int kMaxChunk = 256;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kStateThreads = 256;
constexpr int kPassThreads = 256;
constexpr int kPassBatch = 8;      // chunk states a state_pass thread loads
                                   // before it uses them

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's groups are in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// d += a.b: a 16x16 (row), b 16x8 (col), bf16; d 16x8 float32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (u, v) as three bf16 pairs, u in the low half of each: u = u_hi + u_mid
// + u_lo to 2^-26 |u|, all 24 bits of a float32.  Each piece is rounded to
// nearest even and each remainder (u - u_hi, then minus u_mid) is exact.
__device__ __forceinline__ void split3(float u, float v, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
  const float2 hf = __bfloat1622float2(h);
  u -= hf.x;
  v -= hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(u, v);
  const float2 mf = __bfloat1622float2(m);
  hi = as_u32(h);
  mid = as_u32(m);
  lo = as_u32(__floats2bfloat162_rn(u - mf.x, v - mf.y));
}

// cum[r] = sum_{k <= r} (double)(dt_k A) and dts[r] = dt_k for the `rows`
// rows of a chunk, one a thread; ends with a barrier
__device__ void chunk_cumsum(double* cum, float* dts, double* warp_tot,
                             const float* dt, long long dt_ss, float Ah,
                             int rows) {
  static_assert(kStateThreads == kMaxChunk, "one row a thread");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = threadIdx.x;
  const float d = r < rows ? dt[r * dt_ss] : 0.f;
  double v = (double)(d * Ah);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += warp_tot[w];
  if (r < rows) {
    cum[r] = v;
    dts[r] = d;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// H_{c+1} = seg_c H_c + S_c from H_0 = 0, in float32 (the multiply and the
// add each rounded, as the reference's state update), each H_c (c >= 1)
// written over S_c once S_c is read.  Four neighbouring elements a thread;
// the S_c of kPassBatch chunks are loaded before the first is used.  With
// `fin` (may be null) also the final state H_nc = seg_{nc-1} H_{nc-1} +
// S_{nc-1}, the reference's scan carry, in the workspace's own layout
// ([b*h][PN]): S_{nc-1} is read before H_{nc-1} overwrites it.  At nc == 1
// that is S_0, and slot 0 gets H_0 = 0, which no chunk_out reads.
__global__ void __launch_bounds__(kPassThreads)
    ssd_state_pass_kernel(float* __restrict__ ws,
                          const float* __restrict__ seg, int nc, int PN,
                          long long quads, float* __restrict__ fin) {
  const long long idx = (long long)blockIdx.x * kPassThreads + threadIdx.x;
  if (idx >= quads) return;
  const long long per_bh = PN >> 2;
  const long long bh = idx / per_bh;
  float4* slot = reinterpret_cast<float4*>(ws + bh * nc * PN) + idx % per_bh;
  const float* sg = seg + bh * nc;
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 + 1 < nc; c0 += kPassBatch) {
    float4 sv[kPassBatch];
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k)
      if (c0 + k + 1 < nc) sv[k] = slot[(long long)(c0 + k) * per_bh];
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k) {
      const int c = c0 + k;
      if (c + 1 < nc) {
        if (c > 0) slot[(long long)c * per_bh] = h;
        const float d = sg[c];
        h.x = __fadd_rn(__fmul_rn(d, h.x), sv[k].x);
        h.y = __fadd_rn(__fmul_rn(d, h.y), sv[k].y);
        h.z = __fadd_rn(__fmul_rn(d, h.z), sv[k].z);
        h.w = __fadd_rn(__fmul_rn(d, h.w), sv[k].w);
      }
    }
  }
  float4* last = slot + (long long)(nc - 1) * per_bh;
  if (fin) {
    const float4 sv = *last;
    const float d = sg[nc - 1];
    reinterpret_cast<float4*>(fin)[idx] =
        make_float4(__fadd_rn(__fmul_rn(d, h.x), sv.x),
                    __fadd_rn(__fmul_rn(d, h.y), sv.y),
                    __fadd_rn(__fmul_rn(d, h.z), sv.z),
                    __fadd_rn(__fmul_rn(d, h.w), sv.w));
  }
  *last = h;
}

}  // namespace
