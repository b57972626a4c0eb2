// Flash-attention forward for Hopper (sm_90a) on the tensor cores: bf16
// q/k/v at head_dim 16 or 32, both products through mma.sync m16n8k16
// (bf16 in, float32 accumulators).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_kernel (body _flash_kernel), together with the GQA repeat
// and head folding its wrapper repro/kernels/ops.py:flash_attention does
// around it, for bf16 inputs at the small head_dims (every tiny config has
// head_dim 16).  It computes what that kernel computes: raw scores q.k^T
// scaled by d^-0.5, causal mask -1e30 with kv tiles above the diagonal
// skipped, online softmax with float32 running max m, sum l and
// accumulator, o = acc / max(l, 1e-30) rounded once to bf16.  bf16 at
// head_dim 64/128 takes flash_attention_sm90.cu, float32 at any head_dim
// flash_attention_tf32.cu.
//
// Bound on this card: operations.  Causal attention needs 4*hd flops per
// (query, key) pair at or below the diagonal: 268.5 M pairs at
// [1, 4096, 32, hd], 34.4 GFLOP at head_dim 32, 0.0348 ms at the 989
// TFLOP/s of bf16 tensor cores (0.0174 ms at head_dim 16; the q, k, v and o
// bytes, 33.6 MB at head_dim 32, take 0.010 ms).  Beside that bound sits a
// floor the roofline does not count: one exponential per pair, 268.5 M ex2
// at the SFU's 16 a clock an SM (132 SMs, ~1.98 GHz) take ~0.064 ms at
// either head_dim, and the softmax's few float32 and integer operations per
// pair around each one take about as long again at the issue rate.  At
// these widths the products are the small part: the design keeps the
// per-score work to what the function needs.
//
// Design:
// - One 256-thread block per (batch*head, 128-row q tile), q tiles launched
//   longest first (the last diagonal tile first) so causal work balances
//   over the SMs.  Each of 8 warps owns 16 q rows for the whole kv loop;
//   its Q fragments (A of m16n8k16) are read once from global memory into
//   registers.  A warp skips the kv tiles that lie wholly above its rows.
// - K/V tiles of 64 keys are copied raw (bf16) into shared memory by
//   16-byte cp.async, in a ring of 3 stages: tiles j + 1 and j + 2 are in
//   flight while tile j is computed.  Rows are padded to hd + 8 elements,
//   so ldmatrix's eight 16-byte row reads hit distinct banks.  Rows past S
//   are zero-filled; keys >= S are masked to -inf and rows >= S are not
//   stored.  Inputs are read through their strides with kv head
//   h / (H / Hkv): no repeat copies.
// - S = Q.K^T: bf16 products are exact in float32, so one product a pair
//   suffices (one k-step at head_dim 16, two at 32).  K's B fragments come
//   by ldmatrix from the row-major tile (a key's dims are a B column).
// - Softmax in registers: masks only on tiles that cross S or the warp's
//   diagonal, row max of the raw scores by quad shuffles, one FFMA and one
//   ex2 per score with log2(e)*scale folded in, the accumulator rescaled
//   once per tile, l summed per lane and reduced across the quad at the
//   end.
// - O += P.V takes P straight from the score accumulators: the m16n8 C
//   layout of two neighbouring key tiles is the m16n8k16 A layout once
//   pairs are packed to bf16x2.  The reference keeps p in float32, so P
//   goes in as two bf16 halves, P_hi = bf16(P) and P_lo = bf16(P - P_hi),
//   two products per key step; one rounding of P puts ~3% of the outputs
//   outside flash_attention_bf16 where they cancel
//   (tests/test_torch_flash_bf16_mma.py counts it).  Each pair of halves
//   is one cvt.rn.bf16x2.f32 (round to nearest even): here, unlike in
//   flash_attention_sm90.cu, that issued fewer instructions a score than
//   rounding by integer adds and was the faster of the two.  V's B
//   fragments come by ldmatrix.trans from the same row-major tile.
// - The epilogue divides by l and writes bf16 pairs straight to o.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = kWarps * 16;  // q rows of a block
constexpr int kBlockN = 64;           // keys of a K/V tile
constexpr int kStages = 3;            // K/V ring depth

template <int HD>
struct Layout {
  static constexpr int kPitch = HD + 8;             // bf16 a K or V row
  static constexpr int kTile = kBlockN * kPitch;    // bf16 a K or V tile
  static constexpr int kChunks = HD / 8;            // 16-byte pieces a row
  // 16-byte pieces of a K and a V tile together, and each thread's share
  static constexpr int kPieces = 2 * kBlockN * kChunks;
  static constexpr int kPerThread = kPieces / kThreads;
};
static_assert(Layout<16>::kPieces % kThreads == 0 &&
                  Layout<32>::kPieces % kThreads == 0,
              "every thread copies the same number of pieces a tile");

struct Strides {
  long long b, s, h;  // element strides of [B, S, heads, hd]; hd stride 1
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared dst, or 16 zero bytes where !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a.b: a 16x16 (row), b 16x8 (col), bf16; d 16x8 float32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x (MUFU.EX2); results below 2^-126 flush to 0, weights that no float32
// sum of the row can see
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (p0, p1) as bf16x2 halves, p0 in the low half: hi = bf16(p), then
// lo = bf16(p - hi), each pair rounded to nearest even by one conversion
// instruction; p - hi is exact in float32, so lo carries what hi leaves and
// hi + lo is p to 2^-16 of it
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(hi) : "f"(p1), "f"(p0));
  const float r0 = p0 - __uint_as_float(hi << 16);
  const float r1 = p1 - __uint_as_float(hi & 0xFFFF0000u);
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(lo) : "f"(r1), "f"(r0));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_bf16_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o, int S, int H,
                          int rep, Strides qs, Strides ks, Strides vs,
                          int causal, float scale_log2) {
  using L = Layout<HD>;
  constexpr int kSteps = HD / 16;  // k-steps of Q.K^T
  constexpr int kDimTiles = HD / 8;  // n8 tiles of the accumulator
  // bf16 K and V tiles, addressed through shared-state-space offsets only
  __shared__ __align__(128) uint16_t sk[kStages * L::kTile];
  __shared__ __align__(128) uint16_t sv[kStages * L::kTile];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, hk = h / rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // this thread's pieces of every K/V tile, fixed for the block: piece
  // tid + i * kThreads of the tile's K pieces then V pieces, each at tile
  // row r (key k0 + r) and head dims c..c+7; src is row 0 of the piece's
  // column, stride the operand's row stride
  const __nv_bfloat16* src[L::kPerThread];
  long long stride[L::kPerThread];
  uint32_t dst[L::kPerThread];  // shared offset within a stage
  int rows[L::kPerThread];
#pragma unroll
  for (int i = 0; i < L::kPerThread; ++i) {
    const int piece = tid + i * kThreads;
    const bool is_v = piece >= kBlockN * L::kChunks;
    const int within = piece % (kBlockN * L::kChunks);
    const int r = within / L::kChunks, c = (within % L::kChunks) * 8;
    src[i] = is_v ? v + b * vs.b + hk * vs.h + c
                  : k + b * ks.b + hk * ks.h + c;
    stride[i] = is_v ? vs.s : ks.s;
    dst[i] = (is_v ? smem_u32(sv) : smem_u32(sk)) + (r * L::kPitch + c) * 2;
    rows[i] = r;
  }
  const uint32_t sk0 = smem_u32(sk), sv0 = smem_u32(sv);
  auto load_kv = [&](int tile) {
    const int k0 = tile * kBlockN;
    const uint32_t off = (tile % kStages) * L::kTile * 2;
#pragma unroll
    for (int i = 0; i < L::kPerThread; ++i) {
      const int kj = k0 + rows[i];
      // a key past S reads nothing (zero-fill) from a valid address
      cp_async16(dst[i] + off, src[i] + (long long)min(kj, S - 1) * stride[i],
                 kj < S);
    }
  };
  // causal: keys past the block's last row are masked for every row in it
  const int kv_end = causal ? min(S, q0 + kBlockM) : S;
  const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) load_kv(j);
    cp_async_commit();
  }

  const int wrow = warp * 16;        // the warp's first row in the block
  const int row0 = q0 + wrow + g;    // this lane's rows: row0, row0 + 8
  // Q's A fragments: rows g, g + 8; dims 16kk + 2t (+1) and + 8
  uint32_t qa[kSteps][4];
  {
    const __nv_bfloat16* const qb = q + b * qs.b + h * qs.h + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const __nv_bfloat16* const qr = qb + (long long)min(row, S - 1) * qs.s;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          qa[kk][r + 2 * c] =
              row < S
                  ? *reinterpret_cast<const uint32_t*>(qr + 16 * kk + 8 * c)
                  : 0u;
    }
  }
  // ldmatrix row addresses of this lane.  K (no transpose): matrix
  // i = lane / 8 of a load is key rows 8nt + lane % 8, dims 8(c + i) of
  // the flattened (n-tile, dim-octet) list.  V (transposed): matrix i is
  // keys 16j + 8(i % 2) + lane % 8, dims 8(nd + i / 2).
  const int lr = lane & 7, li = lane >> 3;
  const uint32_t v_lane =
      ((8 * (li & 1) + lr) * L::kPitch + 8 * (li >> 1)) * 2;

  float acc[kDimTiles][4] = {};      // o: rows g, g + 8; dims 8nd + 2t, +1
  float m[2] = {-1e30f, -1e30f};     // running max, log2 domain
  float l[2] = {0.f, 0.f};           // this lane's part of the running sum

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile landed; every warp is done with tile - 1
    if (tile + kStages - 1 < n_tiles) load_kv(tile + kStages - 1);
    cp_async_commit();
    const int k0 = tile * kBlockN;
    // a tile wholly above this warp's rows adds nothing to them
    if (causal && k0 > q0 + wrow + 15) continue;
    const uint32_t stage = (tile % kStages) * L::kTile * 2;

    // s = q.K^T, raw: key 8nt + 2t (+1) of rows g, g + 8
    float s[kBlockN / 8][4] = {};
#pragma unroll
    for (int f = 0; f < (kBlockN / 8) * kDimTiles; f += 4) {
      // matrices f..f+3 of the (n-tile, dim-octet) list
      const int fi = f + li, nt = fi / kDimTiles, c = fi % kDimTiles;
      uint32_t kf[4];
      ldsm_x4(kf, sk0 + stage + ((8 * nt + lr) * L::kPitch + 8 * c) * 2);
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const int n = (f + i) / kDimTiles, kk = ((f + i) % kDimTiles) / 2;
        mma(s[n], qa[kk], kf[i], kf[i + 1]);
      }
    }

    // masks only where the tile crosses S or this warp's diagonal, under
    // one branch (per-score branches would cost every tile)
    if (k0 + kBlockN > S || (causal && k0 + kBlockN - 1 > q0 + wrow)) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // the reference's mask is -1e30; keys >= S get -inf
          const int key = k0 + 8 * nt + 2 * t + (i & 1);
          const bool above = causal && key > row0 + 8 * (i >> 1);
          s[nt][i] = key >= S ? -INFINITY : (above ? -1e30f : s[nt][i]);
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
    float alpha[2], neg_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      neg_m[r] = -m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = ex2(fmaf(s[nt][i], scale_log2, neg_m[i >> 1]));
        l[i >> 1] += s[nt][i];
      }
#pragma unroll
    for (int nd = 0; nd < kDimTiles; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }

    // acc += P_hi.V + P_lo.V, 16 keys a step: keys 16j + 2t (+1) of rows
    // g, g + 8 (a0, a1) are n-tile 2j's accumulators, keys + 8 (a2, a3)
    // n-tile 2j + 1's
#pragma unroll
    for (int j = 0; j < kBlockN / 16; ++j) {
      uint32_t p_hi[4], p_lo[4];
      split_pair(s[2 * j][0], s[2 * j][1], p_hi[0], p_lo[0]);
      split_pair(s[2 * j][2], s[2 * j][3], p_hi[1], p_lo[1]);
      split_pair(s[2 * j + 1][0], s[2 * j + 1][1], p_hi[2], p_lo[2]);
      split_pair(s[2 * j + 1][2], s[2 * j + 1][3], p_hi[3], p_lo[3]);
#pragma unroll
      for (int nd = 0; nd < kDimTiles; nd += 2) {
        uint32_t vf[4];  // b0, b1 of dim tiles nd and nd + 1
        ldsm_x4_trans(vf, sv0 + stage + v_lane +
                              (16 * j * L::kPitch + 8 * nd) * 2);
        mma(acc[nd], p_hi, vf[0], vf[1]);
        mma(acc[nd + 1], p_hi, vf[2], vf[3]);
        mma(acc[nd], p_lo, vf[0], vf[1]);
        mma(acc[nd + 1], p_lo, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* const orow =
        o + (((long long)b * S + row) * H + h) * HD + 2 * t;
#pragma unroll
    for (int nd = 0; nd < kDimTiles; ++nd)
      *reinterpret_cast<uint32_t*>(orow + 8 * nd) =
          pack_bf16(acc[nd][2 * r] / denom, acc[nd][2 * r + 1] / denom);
  }
}

template <int HD>
int launch(dim3 grid, cudaStream_t st, const __nv_bfloat16* q,
           const __nv_bfloat16* k, const __nv_bfloat16* v, __nv_bfloat16* o,
           int S, int H, int rep, Strides qs, Strides ks, Strides vs,
           int causal, float scale_log2) {
  flash_fwd_bf16_mma_kernel<HD><<<grid, kThreads, 0, st>>>(
      q, k, v, o, S, H, rep, qs, ks, vs, causal, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, S, H, hd]; k, v: [B, S, Hkv, hd], bf16, hd 16 or 32, unit hd
// stride, every other stride and the base pointers a multiple of 16 bytes
// (cp.async); o: [B, S, H, hd] contiguous bf16.
extern "C" int repro_flash_attention_bf16_mma(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H,
    int Hkv, int hd, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int causal, float sm_scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + kBlockM - 1) / kBlockM));
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  cudaStream_t st = (cudaStream_t)stream;
  const int rep = H / Hkv;
  // log2(e) folded into the scale, rounded to float32 once
  const float scale_log2 = sm_scale * 1.44269504088896341f;
  const auto *bq = (const __nv_bfloat16*)q, *bk = (const __nv_bfloat16*)k,
             *bv = (const __nv_bfloat16*)v;
  auto* bo = (__nv_bfloat16*)o;
  switch (hd) {
    case 16:
      return launch<16>(grid, st, bq, bk, bv, bo, S, H, rep, qs, ks, vs,
                        causal, scale_log2);
    case 32:
      return launch<32>(grid, st, bq, bk, bv, bo, S, H, rep, qs, ks, vs,
                        causal, scale_log2);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
