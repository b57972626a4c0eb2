// Flash-attention forward for Hopper (sm_90a) on the CUDA cores: the route
// for bf16 at head_dim 16 or 32.  bf16 at head_dim 64 or 128 (every model
// the port trains) takes the tensor-core kernel in flash_attention_sm90.cu,
// and float32 the 3xTF32 tensor-core kernel in flash_attention_tf32.cu; the
// float32 kernels here run only when launched explicitly
// (kernels/flash_attention.py:flash_attention_cuda_cores).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_kernel (body _flash_kernel), together with the GQA repeat
// and head folding its wrapper repro/kernels/ops.py:flash_attention does
// around it.  Causal or bidirectional, scale d^-0.5, online softmax with
// float32 running max m, sum l and accumulator, causal mask -1e30, kv tiles
// above the diagonal skipped, l floored at 1e-30.
//
// Bound on this card: operations.  Causal attention at [1, 4096, 32, 128]
// needs ~4*hd flops per (query, key) pair below the diagonal, 137 GFLOP, which
// is ~139 us at the 989 TFLOP/s of bf16 tensor cores (the q, k, v and o bytes,
// 134 MB, take ~40 us); in float32 against the 67 TFLOP/s of the CUDA cores
// it is ~2.05 ms, and 0.834 ms as three TF32 products on the tensor cores
// (flash_attention_tf32.cu).  This kernel runs its products as float32 FMAs
// on the CUDA cores, so it sits well above either bound.
//
// Design: one 256-thread block per (batch*head, 64-row q tile).  Four
// neighbouring threads share a q row, each owning every fourth head dim, so
// the partial q.k dots are finished with two warp shuffles and the K/V reads
// from shared memory are conflict-free broadcasts.  K/V tiles of 32 keys are
// staged in shared memory as float32 (bf16 inputs convert on load, as the
// reference converts them).  Inputs are read through their strides with kv
// head h / (H / Hkv): no repeat and no transpose copies.  Ragged edges are
// masked, so S needs no block multiple.
#include "common.cuh"

#include <math.h>

#include <type_traits>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr int kThreadsPerRow = 4;
constexpr int kThreads = kBlockQ * kThreadsPerRow;

struct Strides {
  long long b, s, h;  // element strides of [B, S, heads, hd]; hd stride is 1
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int rep, Strides qs, Strides ks, Strides vs, int causal,
                 float sm_scale) {
  constexpr int kDims = HD / kThreadsPerRow;
  __shared__ float k_tile[kBlockK][HD];
  __shared__ float v_tile[kBlockK][HD];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, hk = h / rep;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int part = tid % kThreadsPerRow;
  const int qi = q0 + tid / kThreadsPerRow;
  const bool row_valid = qi < S;

  float qr[kDims], acc[kDims];
  const T* qp = q + b * qs.b + (long long)qi * qs.s + h * qs.h;
#pragma unroll
  for (int i = 0; i < kDims; ++i) {
    qr[i] = row_valid ? load_f32(qp + part + kThreadsPerRow * i) : 0.f;
    acc[i] = 0.f;
  }
  float m = -1e30f, l = 0.f;

  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  // causal: keys past the tile's last row are masked for every row in it
  const int kv_end = causal ? min(S, q0 + kBlockQ) : S;

  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();
    for (int idx = tid; idx < kBlockK * HD; idx += kThreads) {
      const int j = idx / HD, d = idx % HD, kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < S) {
        kv = load_f32(kb + (long long)kj * ks.s + d);
        vv = load_f32(vb + (long long)kj * vs.s + d);
      }
      k_tile[j][d] = kv;
      v_tile[j][d] = vv;
    }
    __syncthreads();

    float s[kBlockK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kDims; ++i)
        dot += qr[i] * k_tile[j][part + kThreadsPerRow * i];
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kj = k0 + j;
      float sj = dot * sm_scale;
      if (kj >= S) sj = -INFINITY;                  // ragged kv edge
      else if (causal && kj > qi) sj = -1e30f;      // the reference's mask
      s[j] = sj;
      tile_max = fmaxf(tile_max, sj);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = alpha * l + psum;
#pragma unroll
    for (int i = 0; i < kDims; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
#pragma unroll
      for (int i = 0; i < kDims; ++i)
        acc[i] += s[j] * v_tile[j][part + kThreadsPerRow * i];
    }
    m = m_new;
  }

  if (row_valid) {
    const float denom = fmaxf(l, 1e-30f);
    T* op = o + (((long long)b * S + qi) * H + h) * HD;
#pragma unroll
    for (int i = 0; i < kDims; ++i)
      store_from_f32(op + part + kThreadsPerRow * i, acc[i] / denom);
  }
}

template <typename T>
int launch(int hd, dim3 grid, cudaStream_t st, const void* q, const void* k,
           const void* v, void* o, int S, int H, int rep, Strides qs,
           Strides ks, Strides vs, int causal, float sm_scale) {
#define REPRO_FLASH_LAUNCH(HD_)                                             \
  flash_fwd_kernel<T, HD_><<<grid, kThreads, 0, st>>>(                      \
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, rep, qs, ks, vs,   \
      causal, sm_scale);
#define REPRO_FLASH_CASE(HD_) \
  case HD_:                   \
    REPRO_FLASH_LAUNCH(HD_)   \
    break;
  // bf16 at head_dim 64 and 128 is flash_attention_sm90.cu's route
  constexpr bool kWide = std::is_same<T, float>::value;
  switch (hd) {
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    case 64:
      if constexpr (kWide) {
        REPRO_FLASH_LAUNCH(64)
        break;
      }
      return (int)cudaErrorInvalidValue;
    case 128:
      if constexpr (kWide) {
        REPRO_FLASH_LAUNCH(128)
        break;
      }
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_CASE
#undef REPRO_FLASH_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, S, H, hd]; k, v: [B, S, Hkv, hd] (any strides, unit hd stride);
// o: [B, S, H, hd] contiguous, in the inputs' dtype: float32 at head_dim
// 16-128, bf16 at 16 or 32.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H,
    int Hkv, int hd, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int causal, float sm_scale, int dtype,
    void* stream) {
  if (B == 0 || S == 0 || H == 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + kBlockQ - 1) / kBlockQ));
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t st = (cudaStream_t)stream;
  const int rep = H / Hkv;
  if (dtype == kFloat32)
    return launch<float>(hd, grid, st, q, k, v, o, S, H, rep, qs, ks, vs,
                         causal, sm_scale);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(hd, grid, st, q, k, v, o, S, H, rep, qs, ks,
                                 vs, causal, sm_scale);
  return (int)cudaErrorInvalidValue;
}
