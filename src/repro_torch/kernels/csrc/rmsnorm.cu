// RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py:rmsnorm_kernel (body
// _rmsnorm_kernel): over each row of d elements, the sum of squares in
// float32, r = rsqrt(sum / d + eps), and each output (x * r) * scale rounded
// once to x's dtype.  Only the order of the sum differs from the reference.
//
// Bound on this card: bytes.  A row reads d inputs and writes d outputs (the
// d scale values are read by every row, from L1/L2) and does ~4 flops an
// element, far below the ~295 flops a byte at which an H100 stops being
// memory bound: [4096, 4096] bf16 moves 67 MB, 20.0 us at 3.35 TB/s;
// whisper-base's [1500, 512] moves 3 MB, 0.92 us, below a launch's own
// latency, so there the design aims at one round trip to memory a row.
//
// Every route holds its share of a row in registers and reads x once from
// device memory, as 16-byte vectors (8 bf16 or 4 float32 a load) where the
// width, the base and the row stride allow, else through the same code with
// one-element vectors.  Rows are row_stride elements apart, so a view such as
// MLA's kv[..., :512] of a 576-wide tensor is read in place; the output is
// contiguous.  The scale is read in its own dtype, float32 or bf16 (bf16 to
// float32 is exact), with the row's loads, before the reduction, where the
// registers allow.
//  * warp route (up to kernels/rmsnorm.py:WARP_ROUTE_MAX_VECTORS vectors a
//    lane; the limit and the times behind it are written there): a warp a
//    row, several rows a block.  The sum is reduced with __shfl_xor_sync
//    alone: no shared memory, no __syncthreads.
//  * block route (wider rows, up to kMaxVectors vectors a thread): a block a
//    row, its threads following d at a few vectors each (2 up to 384
//    threads, then 4 or 8 up to kBlockMaxThreads: kernels/rmsnorm.py:
//    block_plan, set from measurement); warp shuffles, one shared-memory
//    step that every warp reads back and reduces alike, and the write from
//    registers.
//  * two-pass route (rows wider than kBlockMaxThreads x kMaxVectors vectors:
//    no published configuration's norm): the first port's block a row, with
//    16-byte vectors; the second pass reads x again, from L2.
// The wrapper (kernels/rmsnorm.py:plan) picks the route and its shape; this
// entry checks that they cover the row and that the vectors are aligned, and
// returns an error otherwise.  Its arguments come as one packed record
// (RmsnormLaunch), which costs the host one ctypes conversion, not fourteen.
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kRouteWarp = 0, kRouteBlock = 1, kRouteTwoPass = 2;
constexpr int kMaxVectors = 8;          // vectors a thread holds: the cap
constexpr int kWarpMaxThreads = 256;    // a warp route block: up to 8 rows
constexpr int kBlockMaxThreads = 512;   // block and two-pass routes

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Vec<T, N> load_vec(const T* p) {
  return *reinterpret_cast<const Vec<T, N>*>(p);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
// round to nearest even, as jnp's and torch's float32 -> bfloat16 casts do
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// two floats rounded to bf16 (cvt.rn.bf16x2.f32: to nearest even, as
// __float2bfloat16_rn), a in the low half
__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// VEC values rounded once to T and stored as one vector (8 bf16 as one
// uint4: a vector of __nv_bfloat162 is stored 4 bytes at a time)
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[VEC]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && VEC == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(
        pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
        pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
  } else {
    Vec<T, VEC> y;
#pragma unroll
    for (int e = 0; e < VEC; ++e) y.v[e] = from_f32<T>(f[e]);
    *reinterpret_cast<Vec<T, VEC>*>(p) = y;
  }
}

// VEC scale values in float32, in loads of at most 16 bytes
template <typename S, int VEC>
__device__ __forceinline__ void scale_f32(const S* p, float (&f)[VEC]) {
  constexpr int kLoad = VEC * (int)sizeof(S) > 16 ? 16 / (int)sizeof(S) : VEC;
#pragma unroll
  for (int c = 0; c < VEC / kLoad; ++c) {
    const Vec<S, kLoad> u = load_vec<S, kLoad>(p + c * kLoad);
#pragma unroll
    for (int q = 0; q < kLoad; ++q) f[c * kLoad + q] = to_f32(u.v[q]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The block's sum in every thread: each warp's sum goes to shared memory,
// and after one __syncthreads every warp reduces the same warp sums in the
// same order.  blockDim.x is a multiple of 32.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[32];
  const int lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_sum(lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.f);
}

// A thread's share of one row: vectors t, t + n, ..., t + (NV - 1) n of the
// row's nvec vectors of VEC elements, held in registers between the load and
// the store, with the scale's matching values (in loads of at most 16
// bytes).  The scale is loaded with x where its share is at most HOLD
// bytes (kHoldScale), else at the store, from L1/L2: the warp route holds up
// to the cap, 128 bytes (up to 255 registers a thread); the block route up
// to 64, since at 128 beside 8 vectors of x it spilled at its 128
// registers a thread (and the warp route at 64 did, at 4 vectors of bf16).
template <typename T, typename S, int VEC, int NV, int HOLD>
struct RowShare {
  static constexpr int kScaleLoad =
      VEC * (int)sizeof(S) > 16 ? 16 / (int)sizeof(S) : VEC;
  static constexpr bool kHoldScale = NV * VEC * (int)sizeof(S) <= HOLD;
  Vec<T, VEC> x[NV];
  Vec<S, kScaleLoad> s[NV][VEC / kScaleLoad];

  // loads the share; returns its sum of squares in float32
  __device__ __forceinline__ float load(const T* xr, const S* scale, int nvec,
                                        int t, int n) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = t + i * n;
      if (j < nvec) {
        x[i] = load_vec<T, VEC>(xr + j * VEC);
        if constexpr (kHoldScale) load_scale(scale, i, j);
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (t + i * n < nvec) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float v = to_f32(x[i].v[e]);
          ss = fmaf(v, v, ss);
        }
      }
    }
    return ss;
  }

  __device__ __forceinline__ void load_scale(const S* scale, int i, int j) {
#pragma unroll
    for (int c = 0; c < VEC / kScaleLoad; ++c)
      s[i][c] = load_vec<S, kScaleLoad>(scale + j * VEC + c * kScaleLoad);
  }

  // writes (x * r) * scale of the share, rounded once to T
  __device__ __forceinline__ void store(T* yr, const S* scale, int nvec,
                                        int t, int n, float r) const {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = t + i * n;
      if (j < nvec) {
        float f[VEC];
        if constexpr (kHoldScale) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            f[e] = to_f32(s[i][e / kScaleLoad].v[e % kScaleLoad]);
        } else {
          scale_f32<S, VEC>(scale + j * VEC, f);
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = (to_f32(x[i].v[e]) * r) * f[e];
        store_vec<T, VEC>(yr + j * VEC, f);
      }
    }
  }
};

template <typename T, typename S, int VEC, int NV>
__global__ void __launch_bounds__(kWarpMaxThreads)
    rmsnorm_warp_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                        T* __restrict__ out, long long rows, int d,
                        long long row_stride, float eps) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: its shuffles stay full
  const int lane = threadIdx.x & 31, nvec = d / VEC;
  RowShare<T, S, VEC, NV, kMaxVectors * 16> share;
  const float ss =
      warp_sum(share.load(x + row * row_stride, scale, nvec, lane, 32));
  share.store(out + row * d, scale, nvec, lane, 32,
              rsqrtf(ss / (float)d + eps));
}

template <typename T, typename S, int VEC, int NV>
__global__ void __launch_bounds__(kBlockMaxThreads)
    rmsnorm_block_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                         T* __restrict__ out, int d, long long row_stride,
                         float eps) {
  const long long row = blockIdx.x;
  const int nvec = d / VEC;
  RowShare<T, S, VEC, NV, kMaxVectors * 16 / 2> share;
  const float ss = block_sum(share.load(x + row * row_stride, scale, nvec,
                                        threadIdx.x, blockDim.x));
  share.store(out + row * d, scale, nvec, threadIdx.x, blockDim.x,
              rsqrtf(ss / (float)d + eps));
}

template <typename T, typename S, int VEC>
__global__ void __launch_bounds__(kBlockMaxThreads)
    rmsnorm_two_pass_kernel(const T* __restrict__ x,
                            const S* __restrict__ scale, T* __restrict__ out,
                            int d, long long row_stride, float eps) {
  const long long row = blockIdx.x;
  const T* xr = x + row * row_stride;
  T* yr = out + row * d;
  const int nvec = d / VEC;
  float ss = 0.f;
  for (int j = threadIdx.x; j < nvec; j += blockDim.x) {
    const Vec<T, VEC> v = load_vec<T, VEC>(xr + j * VEC);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float f = to_f32(v.v[e]);
      ss = fmaf(f, f, ss);
    }
  }
  const float r = rsqrtf(block_sum(ss) / (float)d + eps);
  for (int j = threadIdx.x; j < nvec; j += blockDim.x) {
    const Vec<T, VEC> v = load_vec<T, VEC>(xr + j * VEC);
    float f[VEC];
    scale_f32<S, VEC>(scale + j * VEC, f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[e] = (to_f32(v.v[e]) * r) * f[e];
    store_vec<T, VEC>(yr + j * VEC, f);
  }
}

struct Args {
  const void* x;
  const void* scale;
  void* out;
  long long rows;
  int d;
  long long row_stride;
  float eps;
};

template <typename T, typename S, int VEC, int NV>
void launch_held(const Args& a, int route, int threads, cudaStream_t s) {
  const T* x = (const T*)a.x;
  const S* scale = (const S*)a.scale;
  T* out = (T*)a.out;
  if (route == kRouteWarp) {
    const int rows_a_block = threads / 32;
    const unsigned grid =
        (unsigned)((a.rows + rows_a_block - 1) / rows_a_block);
    rmsnorm_warp_kernel<T, S, VEC, NV><<<grid, threads, 0, s>>>(
        x, scale, out, a.rows, a.d, a.row_stride, a.eps);
  } else {
    rmsnorm_block_kernel<T, S, VEC, NV><<<(unsigned)a.rows, threads, 0, s>>>(
        x, scale, out, a.d, a.row_stride, a.eps);
  }
}

template <typename T, typename S, int VEC>
int launch_vec(const Args& a, int route, int vectors, int threads,
               cudaStream_t s) {
  if (route == kRouteTwoPass) {
    rmsnorm_two_pass_kernel<T, S, VEC><<<(unsigned)a.rows, threads, 0, s>>>(
        (const T*)a.x, (const S*)a.scale, (T*)a.out, a.d, a.row_stride, a.eps);
    return 0;
  }
  switch (vectors) {
    case 1: launch_held<T, S, VEC, 1>(a, route, threads, s); return 0;
    case 2: launch_held<T, S, VEC, 2>(a, route, threads, s); return 0;
    case 4: launch_held<T, S, VEC, 4>(a, route, threads, s); return 0;
    case 8: launch_held<T, S, VEC, 8>(a, route, threads, s); return 0;
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename S>
int launch_types(const Args& a, int route, int vec, int vectors, int threads,
                 cudaStream_t s) {
  constexpr int kWide = 16 / (int)sizeof(T);
  if (vec == kWide)
    return launch_vec<T, S, kWide>(a, route, vectors, threads, s);
  if (vec == 1) return launch_vec<T, S, 1>(a, route, vectors, threads, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The launch record kernels/rmsnorm.py:LAUNCH packs (80 bytes, no padding):
// one argument crosses ctypes instead of fourteen, each of which cost the
// host a conversion.  x: rows of d elements, row_stride elements apart;
// out: [rows, d] contiguous; scale: d values.  dtype and scale_dtype:
// ReproDtype codes.  route, vec (elements a vector: 16 bytes' worth, or 1),
// vectors (a thread holds, a power of two up to kMaxVectors; 1 on the
// two-pass route) and threads (a block) as kernels/rmsnorm.py:plan gives
// them.
struct RmsnormLaunch {
  const void* x;
  const void* scale;
  void* out;
  void* stream;
  long long rows;
  long long row_stride;
  int d;
  float eps;
  int dtype;
  int scale_dtype;
  int route;
  int vec;
  int vectors;
  int threads;
};
static_assert(sizeof(RmsnormLaunch) == 80, "kernels/rmsnorm.py:LAUNCH");

extern "C" int repro_rmsnorm(const void* record) {
  RmsnormLaunch a;
  memcpy(&a, record, sizeof a);  // the record's bytes need no alignment
  if (a.rows == 0) return (int)cudaGetLastError();
  const bool types_ok =
      (a.dtype == kFloat32 || a.dtype == kBFloat16) &&
      (a.scale_dtype == kFloat32 || a.scale_dtype == kBFloat16);
  if (!types_ok || a.d <= 0 || a.vec <= 0 || a.d % a.vec != 0 ||
      a.threads < 32 || a.threads % 32 != 0 || a.vectors < 1 ||
      a.vectors > kMaxVectors)
    return (int)cudaErrorInvalidValue;
  const long long nvec = a.d / a.vec;
  if (a.route == kRouteWarp) {
    if (a.threads > kWarpMaxThreads || 32LL * a.vectors < nvec)
      return (int)cudaErrorInvalidValue;
  } else if (a.route == kRouteBlock || a.route == kRouteTwoPass) {
    if (a.threads > kBlockMaxThreads || a.rows > 0x7fffffffLL ||
        (a.route == kRouteBlock && (long long)a.threads * a.vectors < nvec))
      return (int)cudaErrorInvalidValue;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (a.vec > 1) {
    const long long esize = a.dtype == kFloat32 ? 4 : 2;
    const int sbytes = a.vec * (a.scale_dtype == kFloat32 ? 4 : 2);
    if ((uintptr_t)a.x % 16 != 0 || (uintptr_t)a.out % 16 != 0 ||
        (uintptr_t)a.scale % (sbytes < 16 ? sbytes : 16) != 0 ||
        (a.row_stride * esize) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  }
  const Args args{a.x, a.scale, a.out, a.rows, a.d, a.row_stride, a.eps};
  cudaStream_t s = (cudaStream_t)a.stream;
  const int route = a.route, vec = a.vec, vectors = a.vectors;
  const int threads = a.threads;
  int err;
  if (a.dtype == kFloat32)
    err = a.scale_dtype == kFloat32
              ? launch_types<float, float>(args, route, vec, vectors, threads,
                                           s)
              : launch_types<float, __nv_bfloat16>(args, route, vec, vectors,
                                                   threads, s);
  else
    err = a.scale_dtype == kFloat32
              ? launch_types<__nv_bfloat16, float>(args, route, vec, vectors,
                                                   threads, s)
              : launch_types<__nv_bfloat16, __nv_bfloat16>(
                    args, route, vec, vectors, threads, s);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
