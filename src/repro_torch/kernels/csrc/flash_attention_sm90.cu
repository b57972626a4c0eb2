// Flash-attention forward for Hopper (sm_90a) on the tensor cores: bf16
// q/k/v at head_dim 64 or 128, wgmma for both products, TMA for every load.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_kernel (body _flash_kernel), together with the GQA repeat
// and head folding its wrapper repro/kernels/ops.py:flash_attention does
// around it, for the dtypes and widths the models train with.  It computes
// what that kernel computes: scores q.k^T.d^-0.5, causal mask -1e30 with kv
// tiles above the diagonal skipped, online softmax with float32 running max
// m, sum l and accumulator, o = acc / max(l, 1e-30) rounded once to bf16.
// float32 inputs and head_dim 16/32 take the CUDA-core kernel in
// flash_attention.cu.
//
// Bound on this card: operations.  Causal attention needs 4*hd flops per
// (query, key) pair at or below the diagonal: 137.5 GFLOP at
// [1, 4096, 32, 128], 0.139 ms at the 989 TFLOP/s of bf16 tensor cores (the
// q, k, v and o bytes, 134 MB, take 0.040 ms).
//
// Design:
// - One CTA per (batch*head, 128-row q tile), q tiles launched longest
//   first (the last diagonal tile first) so causal work balances over the
//   SMs.  Two consumer warpgroups each own 64 q rows; a producer
//   warpgroup, one thread of which issues every load, hands its registers
//   to them (setmaxnreg 24 / 240): at 384 threads ptxas allows 168 a
//   thread, too few for S, P_hi, P_lo and O at once without spilling.
// - TMA: q once per CTA, K and V tiles of 128 keys into a ring of two
//   stages guarded by full/empty mbarriers.  The tensor maps view each
//   operand as the strided 4-D array (hd, heads, S, B), built on the host
//   per call and passed as __grid_constant__; boxes are 64 wide (128
//   bytes) with 128-byte swizzle, so head_dim 128 loads as two panels.
//   TMA zero-fills rows past S; keys >= S are masked to -inf and rows >= S
//   are not stored.  GQA reads kv head h / (H / Hkv): no repeat copies.
// - S = Q.K^T: wgmma m64n128k16 with both operands K-major in shared memory.
//   bf16 x bf16 products are exact in fp32, so the scores differ from the
//   reference only in summation order.
// - Softmax in registers, in the accumulator layout wgmma returns (each
//   thread owns rows lane/4 and lane/4 + 8 of its warp's 16): masks only
//   on edge tiles, row max of the raw scores by quad shuffles, then one
//   FFMA and one ex2 per score with log2(e)*scale folded in; acc rescaled
//   once per kv tile.
// - O += P.V: the reference keeps p in fp32.  P is split into two bf16
//   halves, P_hi = bf16(P) and P_lo = bf16(P - P_hi), and each goes through
//   a register-A wgmma against the same V tile (V MN-major through the
//   descriptor's transpose bit: no transpose copy).  That keeps ~16 bits of
//   P for 1.5x the P.V flops; P rounded once (FlashAttention-3's choice)
//   falls outside the flash_attention_bf16 tier where outputs cancel.  The
//   split rounds by integer adds: the conversion instructions it replaces
//   issue at a quarter rate and, beside the exp2s, held up each tile more
//   than the tensor cores did.
// - The epilogue divides by l, rounds to bf16, stages the tile in the q
//   buffer and writes 16-byte row pieces.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <math.h>

namespace {

constexpr int kBlockM = 128;  // q rows per CTA, 64 per consumer warpgroup
constexpr int kBlockN = 128;  // keys per kv tile
constexpr int kStages = 2;    // K/V ring depth
constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kPanel = 64;                 // bf16 per 128-byte swizzled row
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// arrive once and expect ``bytes`` of TMA traffic on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the barrier's phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}

// barrier among ``threads`` threads of the block (ids 1.. are free)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 2^x (MUFU.EX2); results below 2^-126 flush to 0, weights that no float32
// sum of the row can see
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (all in 16-byte units), layout
// type 1 (SWIZZLE_128B) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// x rounded to bf16, in the high 16 bits (the low 16 are not cleared):
// round to nearest, ties away from zero, by one integer add on the CUDA
// cores instead of the conversion unit, which the softmax's exp2 already
// loads.  For P's split the tie rule does not matter: P_lo = P - P_hi is
// exact, so it carries whatever P_hi leaves.
__device__ __forceinline__ uint32_t bf16_round_bits(float x) {
  return __float_as_uint(x) + 0x8000u;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 128] (+)= A . B, A and B K-major in shared memory (128-byte
// swizzle), bf16 in, fp32 accumulate; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A . B, A in registers (the accumulator layout of
// wgmma_ss_n128 packed to bf16 pairs), B MN-major in shared memory (128-byte
// swizzle), bf16 in, fp32 accumulate.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A . B, A in registers (the accumulator layout of
// wgmma_ss_n128 packed to bf16 pairs), B MN-major in shared memory (128-byte
// swizzle), bf16 in, fp32 accumulate.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// O += P_hi.V + P_lo.V for the V tile at shared address v_s, P's halves as
// bf16 pairs in the register-A layout.  V is MN-major: rows 16c..16c
// + 15 of the tile are two 8-row groups 1024 bytes apart (SBO), and
// head_dim 128 spans two 64-wide panels (LBO).
template <int HD>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 2],
                                         uint32_t (&p_hi)[8][4],
                                         uint32_t (&p_lo)[8][4],
                                         uint32_t v_s) {
  constexpr uint32_t kPanelBytes = kBlockN * kPanel * 2;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint64_t dv = sw128_desc(v_s + c * 16 * 128, kPanelBytes, 1024);
    if constexpr (HD == 128) {
      wgmma_rs_n128(acc, p_hi[c], dv);
      wgmma_rs_n128(acc, p_lo[c], dv);
    } else {
      wgmma_rs_n64(acc, p_hi[c], dv);
      wgmma_rs_n64(acc, p_lo[c], dv);
    }
  }
}

// Shared memory of one CTA: q, then the K ring, then the V ring, then the
// barriers (q, full[kStages], empty[kStages]).  Every tile starts on a
// 1024-byte boundary, as the 128-byte swizzle atom (8 rows x 128 bytes)
// needs; a tile of head_dim 128 is two 64-wide panels, one after the other.
template <int HD>
struct Layout {
  static constexpr uint32_t kQBytes = kBlockM * HD * 2;
  static constexpr uint32_t kKVBytes = kBlockN * HD * 2;
  static constexpr uint32_t kQPanel = kBlockM * kPanel * 2;
  static constexpr uint32_t kKVPanel = kBlockN * kPanel * 2;
  static constexpr uint32_t kK = kQBytes;
  static constexpr uint32_t kV = kK + kStages * kKVBytes;
  static constexpr uint32_t kBars = kV + kStages * kKVBytes;
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ o, int S, int H, int rep,
                      int causal, float sm_scale) {
  static_assert(kBlockM == kBlockN, "causal tile count assumes square tiles");
  using L = Layout<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t q_bar = base + L::kBars;
  auto full_bar = [&](int s) { return q_bar + 8 * (1 + s); };
  auto empty_bar = [&](int s) { return q_bar + 8 * (1 + kStages + s); };

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int q0 = qt * kBlockM;
  const int n_kv = causal ? qt + 1 : (S + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup: one thread
    // hands its registers to the consumers (24 + 2 x 240 per lane = 3 x 168)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_bar, L::kQBytes);
      for (int p = 0; p < HD / kPanel; ++p)
        tma_load_4d(base + p * L::kQPanel, &tq, q_bar, p * kPanel, h, q0, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty_bar(s), (j / kStages - 1) & 1);
        mbar_expect_tx(full_bar(s), 2 * L::kKVBytes);
        for (int p = 0; p < HD / kPanel; ++p) {
          tma_load_4d(base + L::kK + s * L::kKVBytes + p * L::kKVPanel, &tk,
                      full_bar(s), p * kPanel, h / rep, j * kBlockN, b);
          tma_load_4d(base + L::kV + s * L::kKVBytes + p * L::kKVPanel, &tv,
                      full_bar(s), p * kPanel, h / rep, j * kBlockN, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  // consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63; in the wgmma
  // accumulator layout this thread holds rows row_lo (registers 4i, 4i+1)
  // and row_lo + 8 (4i+2, 4i+3), columns 8i + 2 (lane % 4) + {0, 1}
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int row_lo = q0 + wg * 64 + warp * 16 + lane / 4;
  const int col_lane = (lane % 4) * 2;
  const uint32_t q_wg = base + wg * 64 * 128;
  const float scale_log2 = sm_scale * kLog2e;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m_lo = -1e30f, m_hi = -1e30f, l_lo = 0.f, l_hi = 0.f;

  mbar_wait(q_bar, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kStages;
    const uint32_t k_s = base + L::kK + s * L::kKVBytes;
    const uint32_t v_s = base + L::kV + s * L::kKVBytes;
    mbar_wait(full_bar(s), (j / kStages) & 1);

    float sc[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n128(
          sc,
          sw128_desc(q_wg + (kk / 4) * L::kQPanel + (kk % 4) * 32, 16, 1024),
          sw128_desc(k_s + (kk / 4) * L::kKVPanel + (kk % 4) * 32, 16, 1024),
          kk > 0);
    wgmma_commit();
    wgmma_wait_all();

    // mask the ragged kv edge (-inf) and, on the diagonal tile, keys past
    // the row (-1e30, as the reference; in q.k units here, and either
    // way exp gives 0); the row max of the raw scores, scaled after (the
    // scale is positive)
    const int k0 = j * kBlockN;
    const bool edge = k0 + kBlockN > S ||
                      (causal && k0 + kBlockN - 1 > q0 + wg * 64);
    if (edge) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int key = k0 + (i / 4) * 8 + col_lane + (i & 1);
        const int row = row_lo + ((i & 2) ? 8 : 0);
        sc[i] = key >= S ? -INFINITY
                         : (causal && key > row ? -1e30f : sc[i]);
      }
    }
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (i & 2) mx_hi = fmaxf(mx_hi, sc[i]);
      else mx_lo = fmaxf(mx_lo, sc[i]);
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    // m, l and p in the exp2 domain: p = 2^(s * d^-0.5 * log2(e) - m)
    const float mn_lo = fmaxf(m_lo, mx_lo * scale_log2);
    const float mn_hi = fmaxf(m_hi, mx_hi * scale_log2);
    const float a_lo = ex2(m_lo - mn_lo), a_hi = ex2(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;  // this thread's share of the row
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const float p = ex2(fmaf(sc[i], scale_log2, (i & 2) ? -mn_hi : -mn_lo));
      sc[i] = p;
      if (i & 2) sum_hi += p;
      else sum_lo += p;
    }
    l_lo = l_lo * a_lo + sum_lo;
    l_hi = l_hi * a_hi + sum_hi;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= (i & 2) ? a_hi : a_lo;

    // P as the A operand: keys 16c.. of the accumulator are exactly the
    // m64k16 register fragment {(lo, c0), (hi, c0), (lo, c0+8), (hi, c0+8)}
    uint32_t p_hi[8][4], p_lo[8][4];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x0 = sc[8 * c + 2 * e], x1 = sc[8 * c + 2 * e + 1];
        const uint32_t h0 = bf16_round_bits(x0), h1 = bf16_round_bits(x1);
        p_hi[c][e] = __byte_perm(h0, h1, 0x7632);
        // P - P_hi is exact in fp32
        p_lo[c][e] = __byte_perm(
            bf16_round_bits(x0 - __uint_as_float(h0 & 0xFFFF0000u)),
            bf16_round_bits(x1 - __uint_as_float(h1 & 0xFFFF0000u)), 0x7632);
      }
    }
    wgmma_fence();
    issue_pv<HD>(acc, p_hi, p_lo, v_s);
    wgmma_commit();
    wgmma_wait_all();
    mbar_arrive(empty_bar(s));
  }

  // epilogue: o = acc / max(l, 1e-30) in bf16, staged (swizzled by 16-byte
  // chunk) in this warpgroup's q rows, then written as 16-byte row pieces
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float d_lo = fmaxf(l_lo, 1e-30f), d_hi = fmaxf(l_hi, 1e-30f);
  uint8_t* stage = smem + wg * 64 * 128;
  auto staged = [&](int r, int col) {
    return (col / kPanel) * L::kQPanel + r * 128 +
           ((((col % kPanel) / 8) ^ (r % 8)) * 16) + (col % 8) * 2;
  };
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int r = warp * 16 + lane / 4 + ((i & 2) ? 8 : 0);
    const float d = (i & 2) ? d_hi : d_lo;
    *reinterpret_cast<uint32_t*>(stage + staged(r, (i / 4) * 8 + col_lane)) =
        pack_bf16(acc[i] / d, acc[i + 1] / d);
  }
  named_sync(1 + wg, 128);
  constexpr int kChunks = HD / 8;
  for (int idx = threadIdx.x % 128; idx < 64 * kChunks; idx += 128) {
    const int r = idx / kChunks, ch = idx % kChunks;
    const int row = q0 + wg * 64 + r;
    if (row >= S) continue;
    *reinterpret_cast<uint4*>(o + (((long long)b * S + row) * H + h) * HD +
                              ch * 8) =
        *reinterpret_cast<const uint4*>(stage + staged(r, ch * 8));
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the strided [B, S, heads, hd] bf16 array as the 4-D tensor (hd, heads, S,
// B), loaded in boxes of 64 x 1 x rows x 1 with 128-byte swizzle
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int hd,
              int heads, int S, int B, long long s_h, long long s_s,
              long long s_b, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s_h * 2, (cuuint64_t)s_s * 2,
                                 (cuuint64_t)s_b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kPanel, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(dim3 grid, cudaStream_t st, const CUtensorMap& tq,
           const CUtensorMap& tk, const CUtensorMap& tv, void* o, int S,
           int H, int rep, int causal, float sm_scale) {
  auto kernel = flash_fwd_sm90_kernel<HD>;
  const int bytes = (int)Layout<HD>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, bytes, st>>>(tq, tk, tv, (__nv_bfloat16*)o, S, H,
                                        rep, causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, S, H, hd]; k, v: [B, S, Hkv, hd], bf16, hd 64 or 128, any strides
// with unit hd stride, every other stride and the base pointers a multiple
// of 16 bytes (TMA); o: [B, S, H, hd] contiguous bf16.
extern "C" int repro_flash_attention_sm90(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H,
    int Hkv, int hd, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int causal, float sm_scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || H % Hkv != 0 || (hd != 64 && hd != 128))
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, encode, q, hd, H, S, B, q_sh, q_ss, q_sb, kBlockM) ||
      !make_map(&tk, encode, k, hd, Hkv, S, B, k_sh, k_ss, k_sb, kBlockN) ||
      !make_map(&tv, encode, v, hd, Hkv, S, B, v_sh, v_ss, v_sb, kBlockN))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + kBlockM - 1) / kBlockM));
  cudaStream_t st = (cudaStream_t)stream;
  const int rep = H / Hkv;
  if (hd == 128)
    return launch<128>(grid, st, tq, tk, tv, o, S, H, rep, causal, sm_scale);
  return launch<64>(grid, st, tq, tk, tv, o, S, H, rep, causal, sm_scale);
}
