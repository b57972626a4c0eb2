// Flash-attention forward for Hopper (sm_90a) on the tensor cores: float32
// q/k/v at head_dim 16, 32, 64 or 128, both products as three TF32 products
// (3xTF32) through mma.sync, to float32 accuracy.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_kernel (body _flash_kernel), together with the GQA repeat
// and head folding its wrapper repro/kernels/ops.py:flash_attention does
// around it, for float32 inputs.  It computes what that kernel computes:
// raw scores q.k^T scaled by d^-0.5, causal mask -1e30 with kv tiles above
// the diagonal skipped, online softmax with float32 running max m, sum l and
// accumulator, o = acc / max(l, 1e-30).  bf16 at head_dim 64/128 takes
// flash_attention_sm90.cu, bf16 at 16/32 the CUDA-core flash_attention.cu
// (whose float32 kernels stay reachable only explicitly).
//
// Bound on this card: operations.  Causal attention needs 4*hd flops per
// (query, key) pair at or below the diagonal: 137.5 GFLOP at
// [1, 4096, 32, 128].  float32 accuracy from the tensor cores takes three
// TF32 products for each of them, 412 GFLOP, 0.834 ms at the 494.7 TFLOP/s
// of dense TF32 (the q, k, v and o bytes, 268 MB, take 0.080 ms).  Against
// the 67 TFLOP/s of the CUDA cores in float32 the same work is 2.05 ms.
//
// Precision.  One TF32 product (10 explicit mantissa bits) misses the
// flash_attention tier (rtol 1e-4, atol 1e-5) on most elements.  Each
// operand x goes in as hi = tf32(x) and lo = tf32(x - hi), both rounded to
// nearest with ties away from zero (cvt.rna.tf32.f32's rounding, done by an
// integer add and a mask), and each product as lo.hi + hi.lo, then hi.hi
// (CUTLASS's 3xTF32 order), dropping lo.lo: ~2^-22 of each term.  The
// products are then nearly exact, but the tensor core adds them to its
// float32 accumulator with truncation, not rounding, so a long chain of
// mma.sync into one accumulator drifts: with every product of a row
// chained into s and into acc, a peaked softmax (q x 4) falls outside the
// tier of a float64 evaluation.  So no chain is long: the products of two
// 8-dim steps of q.k^T, and of one 32-key tile of P.V, are summed from
// zero and then added to s or acc by a rounded float32 add
// (benchmarks/torch_flash_tf32_chains.py measures both).
// tests/test_torch_flash_tf32.py emulates this arithmetic on the CPU.
//
// Design:
// - One 256-thread block per (batch*head, 128-row q tile), q tiles launched
//   longest first (the last diagonal tile first) so causal work balances
//   over the SMs.  Each of 8 warps owns 16 q rows for the whole kv loop.
// - q, and K/V tiles of 32 keys, are copied raw (float32) into shared
//   memory by 16-byte cp.async, K/V double-buffered: tile j + 1 is in
//   flight while tile j is computed (138 KB at head_dim 128).  Rows past S
//   are zero-filled; keys >= S are masked to -inf and rows >= S are not
//   stored.  Inputs are read through their strides with kv head
//   h / (H / Hkv): no repeat copies.  32-key tiles, not 64, keep the
//   scores, P's fragments and the accumulator in registers without
//   spilling (one block of 8 warps an SM).
// - Both products use mma.sync m16n8k8 (tf32 in, float32 accumulators).
//   The hi/lo split is made at fragment load, per warp.  The k slots of
//   Q.K^T hold head dims (2t, 2t+1) of a lane's 8-dim step in slots
//   (t, t + 4), so q and K fragments load as float2 (row pitch hd + 8
//   floats: conflict-free).  P.V takes P straight from the score
//   accumulators, which hold keys (2t, 2t+1) of rows g and g + 8: with key
//   2t in k slot t and key 2t + 1 in slot t + 4 the A fragment is
//   (c0, c2, c1, c3), no shuffle, and the B fragment reads V rows 2t and
//   2t + 1 (row pitch hd + 4 floats: conflict-free).  Sums over head dims
//   and over keys do not depend on the slot order.  Eight head-dim tiles'
//   P.V sums run side by side, so their mma.sync chains overlap.
// - Softmax in registers: masks only on tiles that cross the diagonal or
//   S, row max of the raw scores by quad shuffles, one FFMA and one ex2 per
//   score with log2(e)*scale folded in, the accumulator rescaled once per
//   tile, l summed per lane and reduced across the quad at the end.
// - Why mma.sync and not wgmma: wgmma takes tf32 only K-major from shared
//   memory, so V would need a transpose there, and hi/lo copies of every
//   tile.  Splitting K and V once per block into such copies (instead of
//   per warp at fragment load) gave the same time and spilled at head_dim
//   128, so the kernel's pace is not its split arithmetic; wgmma is the
//   later work its numbers point to.
#include <cuda_runtime.h>
#include <stdint.h>

#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = kWarps * 16;  // q rows of a block
constexpr int kBlockN = 32;           // keys of a K/V tile
constexpr int kGroup = 2;             // head-dim steps of a fresh q.k sum

template <int HD>
struct Layout {
  static constexpr int kPitchQK = HD + 8;  // floats a row of q and K
  static constexpr int kPitchV = HD + 4;   // floats a row of V
  static constexpr int kK = kBlockM * kPitchQK;           // K stages
  static constexpr int kV = kK + 2 * kBlockN * kPitchQK;  // V stages
  static constexpr int kFloats = kV + 2 * kBlockN * kPitchV;
  static constexpr int kBytes = kFloats * 4;
};
// the largest layout (head_dim 128): 138,240 bytes of the 232,448 a block
// may have
static_assert(Layout<128>::kBytes <= 232448, "shared memory");
static_assert((16 / 8) % kGroup == 0, "kGroup divides every head_dim's steps");

struct Strides {
  long long b, s, h;  // element strides of [B, S, heads, hd]; hd stride 1
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to dst, or 16 zero bytes where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
// from zero: cvt.rna.tf32.f32's rounding
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to ~2^-22 |x|
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// d += a.b: a 16x8 (row), b 8x8 (col), tf32; d 16x8 float32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b as three TF32 products: a_lo.b_hi, a_hi.b_lo, then a_hi.b_hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4], float b0,
                                     float b1) {
  uint32_t b0_hi, b0_lo, b1_hi, b1_lo;
  split(b0, b0_hi, b0_lo);
  split(b1, b1_hi, b1_lo);
  mma(d, a_lo, b0_hi, b1_hi);
  mma(d, a_hi, b0_lo, b1_lo);
  mma(d, a_hi, b0_hi, b1_hi);
}

// the A fragment (rows g, g + 8; k slots t, t + 4) of four floats
__device__ __forceinline__ void split_a(float a0, float a1, float a2,
                                        float a3, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split(a0, hi[0], lo[0]);
  split(a1, hi[1], lo[1]);
  split(a2, hi[2], lo[2]);
  split(a3, hi[3], lo[3]);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      int S, int H, int rep, Strides qs, Strides ks,
                      Strides vs, int causal, float scale_log2) {
  using L = Layout<HD>;
  constexpr int kChunks = HD / 4;  // 16-byte pieces of a row
  // head-dim tiles whose P.V sums run side by side
  constexpr int kChains = HD / 8 < 8 ? HD / 8 : 8;
  extern __shared__ __align__(16) float smem[];
  float* const sq = smem;
  float* const sk = smem + L::kK;
  float* const sv = smem + L::kV;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, hk = h / rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const float* const qb = q + b * qs.b + h * qs.h;
  const float* const kb = k + b * ks.b + hk * ks.h;
  const float* const vb = v + b * vs.b + hk * vs.h;
  for (int idx = tid; idx < kBlockM * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 4, qi = q0 + r;
    cp_async16(sq + r * L::kPitchQK + c,
               qb + (long long)min(qi, S - 1) * qs.s + c, qi < S);
  }
  auto load_kv = [&](int tile) {
    const int k0 = tile * kBlockN;
    float* const dk = sk + (tile & 1) * kBlockN * L::kPitchQK;
    float* const dv = sv + (tile & 1) * kBlockN * L::kPitchV;
    for (int idx = tid; idx < kBlockN * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = (idx % kChunks) * 4, kj = k0 + r;
      const long long row = min(kj, S - 1);
      cp_async16(dk + r * L::kPitchQK + c, kb + row * ks.s + c, kj < S);
      cp_async16(dv + r * L::kPitchV + c, vb + row * vs.s + c, kj < S);
    }
    cp_async_commit();
  };
  // causal: keys past the block's last row are masked for every row in it
  const int kv_end = causal ? min(S, q0 + kBlockM) : S;
  const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;
  load_kv(0);  // one group with q

  const int wrow = warp * 16;        // the warp's first row in the block
  const int row0 = q0 + wrow + g;    // this lane's rows: row0, row0 + 8
  const float* const fq = sq + (wrow + g) * L::kPitchQK + 2 * t;
  float acc[HD / 8][4] = {};         // o: rows g, g + 8; dims 8nd + 2t, +1
  float m[2] = {-1e30f, -1e30f};     // running max, log2 domain
  float l[2] = {0.f, 0.f};           // this lane's part of the running sum

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait_all();
    __syncthreads();  // tile landed; every warp is done with tile - 1
    if (tile + 1 < n_tiles) load_kv(tile + 1);
    const int k0 = tile * kBlockN;
    const float* const fk =
        sk + (tile & 1) * kBlockN * L::kPitchQK + g * L::kPitchQK + 2 * t;
    const float* const fv =
        sv + (tile & 1) * kBlockN * L::kPitchV + 2 * t * L::kPitchV + g;

    // s = q.K^T, raw: key 8nt + 2t (+1) of rows g, g + 8.  The products
    // of kGroup head-dim steps are summed from zero, then added to s.
    float s[kBlockN / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 8; kk += kGroup) {
      uint32_t a_hi[kGroup][4], a_lo[kGroup][4];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const float2 q_g =
            *reinterpret_cast<const float2*>(fq + 8 * (kk + j));
        const float2 q_g8 = *reinterpret_cast<const float2*>(
            fq + 8 * L::kPitchQK + 8 * (kk + j));
        split_a(q_g.x, q_g8.x, q_g.y, q_g8.y, a_hi[j], a_lo[j]);
      }
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        float part[4] = {};
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const float2 kf = *reinterpret_cast<const float2*>(
              fk + nt * 8 * L::kPitchQK + 8 * (kk + j));
          mma3(part, a_hi[j], a_lo[j], kf.x, kf.y);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] += part[i];
      }
    }

    // masks only where the tile crosses S or this warp's diagonal
    const bool edge = k0 + kBlockN > S ||
                      (causal && k0 + kBlockN - 1 > q0 + wrow);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (edge) {
          const int key = k0 + 8 * nt + 2 * t + (i & 1);
          if (key >= S)
            s[nt][i] = -INFINITY;
          else if (causal && key > row0 + 8 * (i >> 1))
            s[nt][i] = -1e30f;  // the reference's mask
        }
        mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = exp2f(fmaf(s[nt][i], scale_log2, -m[i >> 1]));
        l[i >> 1] += s[nt][i];
      }
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }

    // acc += P.V: key 8kt + 2t in k slot t, key 8kt + 2t + 1 in slot t + 4.
    // Each head-dim tile sums the kv tile's products from zero, then adds
    // them to acc.
    uint32_t p_hi[kBlockN / 8][4], p_lo[kBlockN / 8][4];
#pragma unroll
    for (int kt = 0; kt < kBlockN / 8; ++kt)
      split_a(s[kt][0], s[kt][2], s[kt][1], s[kt][3], p_hi[kt], p_lo[kt]);
#pragma unroll
    for (int n0 = 0; n0 < HD / 8; n0 += kChains) {
      float part[kChains][4] = {};
#pragma unroll
      for (int kt = 0; kt < kBlockN / 8; ++kt)
#pragma unroll
        for (int j = 0; j < kChains; ++j) {
          const float* const vr = fv + kt * 8 * L::kPitchV + 8 * (n0 + j);
          mma3(part[j], p_hi[kt], p_lo[kt], vr[0], vr[L::kPitchV]);
        }
#pragma unroll
      for (int j = 0; j < kChains; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n0 + j][i] += part[j][i];
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* const orow = o + (((long long)b * S + row) * H + h) * HD + 2 * t;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd)
      *reinterpret_cast<float2*>(orow + 8 * nd) =
          make_float2(acc[nd][2 * r] / denom, acc[nd][2 * r + 1] / denom);
  }
}

template <int HD>
int launch(dim3 grid, cudaStream_t st, const float* q, const float* k,
           const float* v, float* o, int S, int H, int rep, Strides qs,
           Strides ks, Strides vs, int causal, float scale_log2) {
  auto kernel = flash_fwd_tf32_kernel<HD>;
  const int bytes = Layout<HD>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, bytes, st>>>(q, k, v, o, S, H, rep, qs, ks, vs,
                                        causal, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, S, H, hd]; k, v: [B, S, Hkv, hd], float32, hd 16, 32, 64 or 128,
// unit hd stride, every other stride and the base pointers a multiple of 16
// bytes (cp.async); o: [B, S, H, hd] contiguous float32.
extern "C" int repro_flash_attention_tf32(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H,
    int Hkv, int hd, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int causal, float sm_scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + kBlockM - 1) / kBlockM));
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t st = (cudaStream_t)stream;
  const int rep = H / Hkv;
  // log2(e) folded into the scale, rounded to float32 once
  const float scale_log2 = sm_scale * 1.44269504088896341f;
  const float *fq = (const float*)q, *fk = (const float*)k,
              *fv = (const float*)v;
  float* fo = (float*)o;
  switch (hd) {
    case 16:
      return launch<16>(grid, st, fq, fk, fv, fo, S, H, rep, qs, ks, vs,
                        causal, scale_log2);
    case 32:
      return launch<32>(grid, st, fq, fk, fv, fo, S, H, rep, qs, ks, vs,
                        causal, scale_log2);
    case 64:
      return launch<64>(grid, st, fq, fk, fv, fo, S, H, rep, qs, ks, vs,
                        causal, scale_log2);
    case 128:
      return launch<128>(grid, st, fq, fk, fv, fo, S, H, rep, qs, ks, vs,
                         causal, scale_log2);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
