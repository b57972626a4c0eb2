// Mamba2 SSD chunk scan (forward, from a zero state) for Hopper (sm_90a) on
// the tensor cores: bf16 x, B and C, chunk-parallel.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:ssd_scan_kernel (body
// _ssd_kernel), together with the group-to-head broadcast its wrapper
// repro/kernels/ops.py:ssd_scan does around it, for bf16 at p <= 64,
// n <= 128 (multiples of 16) and chunk a multiple of 64: mamba2-2.7b's p 64,
// n 128, chunk 256.  float32 at those widths takes ssd_scan_sm90_f32.cu,
// other widths the CUDA-core kernel in ssd_scan.cu.  Per (batch, head),
// with dA_j = dt_j A, cum the running sum of dA inside a chunk, w_j = dt_j
// exp(cum_last - cum_j) and L_ij = exp(cum_i - cum_j) for i >= j:
//   S_c     = sum_j x_j w_j B_j^T                       (chunk's state part)
//   H_0 = 0, H_{c+1} = exp(cum_last_c) H_c + S_c        (entering states)
//   y_i     = sum_{j<=i} ((C_i.B_j) L_ij dt_j) x_j + exp(cum_i) C_i.H_c^T
// Mamba2's chunk-parallel form (ref.ssd_chunked writes it in tensors): only
// the short recurrence over H is sequential, so the chunks of one head run
// in parallel instead of in a loop inside one block.
//
// Bound on this card: bytes.  The compulsory bytes (x, B, C, dt read once,
// y written once, x, B and C as strided views of one [1, 4096, 5376] bf16
// activation) are ~87 MB, 0.0261 ms at 3.35 TB/s.  The scan is causal:
// each (chunk, B/C group) costs c(c+1) n flops over the pairs i >= j for
// C.B^T, each (chunk, head) c(c+1) p for M.x plus 4 c p n for the
// entering-state term and the state update.  At the main path's
// [1, 4096, 80, 64] with n = 128, c = 256, g = 1 that is 16.3 GFLOP,
// 0.0164 ms at the 989 TFLOP/s of bf16 tensor cores.
// What this design adds: a float32 workspace of b.h.nc.p.n elements
// (42 MB at the main shape) that holds S and then, in place, H: written
// twice, S read once and each H read by the chunk's four row-tile blocks,
// ~280 MB, ~0.085 ms at 3.35 TB/s where L2 serves none of the repeats,
// plus each row's decay sum (double) and dt (float), 3.9 MB;
// and the products of the bf16 pieces below: 64.7 GFLOP issued
// (chunk_state 16.1, C.H^T 15.1, C.B^T 13.4, M.x 20.1) against the 16.3
// counted, 0.065 ms at the peak.
//
// Three kernels, launched in order on the caller's stream:
// 1. ssd_chunk_state_kernel, one 256-thread block per (chunk, batch*head):
//    cum in double (to `cum`, with dt gathered to `dts`, for chunk_out),
//    w, exp(cum_last) to `seg`, and S_c = (x o w)^T B with the 64-row tiles
//    of x and B double-buffered through cp.async.  Each of 8 warps owns
//    16 p x 64 n of S_c.
// 2. ssd_state_pass_kernel (ssd_scan_sm90_common.cuh, shared with the
//    float32 route), one thread per four (batch*head, p, n) elements:
//    walks the chunks in order, replacing S_c by H_c (c >= 1) in place, in
//    float32, with the S_c of 8 chunks loaded before the first is used.
//    Slot 0 keeps S_0: H_0 = 0 is never read.
// 3. ssd_chunk_out_kernel, one 128-thread block per (chunk, batch*head,
//    64-row tile i), three an SM, longest (last) tiles launched first: each
//    of 4 warps owns 16 rows i.  C_i, cum and dt arrive in one cp.async
//    group while H_c is loaded into registers; C_i stays in registers as A
//    fragments.  The entering state term comes first: H_c is split into
//    its bf16 pieces on the way into shared memory (into the x and B
//    tiles' buffers), and C_i H_c^T is scaled by exp(cum_i).  Then for
//    each tile j <= i (B_j and x_j double-buffered through cp.async)
//    S = C_i B_j^T in float32 accumulators, M = S o L o dt_j, masked on the
//    diagonal tile before exp, and y += M x_j with M taken straight from
//    the accumulators: the m16n8 accumulator fragment has the layout of
//    the A fragment of the next mma (FlashAttention-2's register reuse),
//    so M never goes through shared memory.  y is rounded once to bf16.
//
// Tensor cores: mma.sync m16n8k16, bf16 inputs, float32 accumulators, fed
// by ldmatrix (.trans where the operand is stored k-major: x in both
// products, B in chunk_state; H is stored [p][n], the layout the B operand
// takes as it is).  Shared tiles are padded by 16 bytes a row so the eight
// rows of each ldmatrix phase hit distinct banks.  B and C are read at
// group h / (H / G) and x as the strided view it is: every row stride and
// base is a multiple of 16 bytes (the wrapper checks), which cp.async of
// 16 bytes needs.  No broadcast and no contiguous copies.
//
// Precision: x, B and C arrive in bf16, so C.B^T and every product with x,
// B or C as one operand is exact.  The float32 operands (x o w of
// chunk_state, M, H) go in as three bf16 pieces, v_hi = bf16(v), v_mid =
// bf16(v - v_hi), v_lo = bf16(v - v_hi - v_mid), which keep all 24 bits of
// v.  One rounding costs ~2^-9 of each term and two pieces ~2^-18; both
// put elements outside the ssd_scan_bf16 tier (atol 1e-5) where y cancels
// to near zero from terms that sum to ~10-20 in magnitude (the emulation
// in tests/test_torch_ssd_sm90.py shows it), so the third piece is paid
// for (+50% on the split products).  cum is
// accumulated in double (dt A formed in float32, as the reference forms
// it) and each difference is rounded to float32 before expf, as in
// ssd_scan.cu.
//
// Why mma.sync and not wgmma: the per-row weights of M are applied between
// the two products, which mma.sync's register fragments allow directly;
// the tiles are small (16 x 64 per warp); and a first tensor-core version
// that is right comes before the warpgroup pipeline (TMA + wgmma, producer
// warp) that reaches the card's full rate, which is later work once this
// kernel's numbers show the products set its pace.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <math.h>

#include "ssd_scan_sm90_common.cuh"

namespace {

constexpr int kRowX = kMaxP + 8;   // bf16 row pitch of x tiles (144 bytes)
constexpr int kRowN = kMaxN + 8;   // bf16 row pitch of B, C, H tiles (272)
constexpr int kOutThreads = 128;

struct Args {
  const __nv_bfloat16* x;   // [b, s, h, p], unit p stride
  const float* dt;          // [b, s, h]
  const float* A;           // [h]
  const __nv_bfloat16* B;   // [b, s, g, n], unit n stride
  const __nv_bfloat16* C;   // [b, s, g, n], unit n stride
  __nv_bfloat16* y;         // [b, s, h, p] contiguous
  float* ws;                // [b*h, nc, p, n]: S_c, then H_c in place
  float* seg;               // [b*h, nc] exp(cum_last)
  double* cum;              // [b*h, nc, chunk] the decay's running sums
  float* dts;               // [b*h, nc, chunk] dt, gathered
  int S_len, H, G, P, N, chunk, nc;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg, c_sb, c_ss, c_sg;
};

struct StateSmem {
  __nv_bfloat16 x[2][kTile][kRowX];
  __nv_bfloat16 b[2][kTile][kRowN];
  double cum[kMaxChunk];
  float w[kMaxChunk];
  double warp_tot[kStateThreads / 32];
};

// H_c's three pieces take the x and B buffers (73.7 KB in all: three
// blocks an SM): the state term is done before the first x and B tiles
// are loaded
struct OutSmem {
  __nv_bfloat16 c[kTile][kRowN];
  __nv_bfloat16 b[2][kTile][kRowN];   // H_mid, H_lo before the first tile
  union {
    __nv_bfloat16 x[2][kTile][kRowX];
    __nv_bfloat16 h[kMaxP][kRowN];    // H_hi before the first tile
  };
  double cum[kMaxChunk];
  float dts[kMaxChunk];
};
static_assert(kMaxP <= kTile && sizeof(__nv_bfloat16[kMaxP][kRowN]) <=
                                    sizeof(__nv_bfloat16[2][kTile][kRowX]),
              "H pieces share the B and x tiles' buffers");

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d[2i], d[2i+1] += (a_hi + a_mid + a_lo).b_i for the two 8-wide column
// tiles b_i = (b[i][0], b[i][1]) and (b[i][2], b[i][3]), i < pairs.  Each
// piece goes over every accumulator before the next piece, so neighbouring
// products never wait on each other.
template <int kPairs>
__device__ __forceinline__ void mma3(float (&d)[2 * kPairs][4],
                                     const uint32_t (&a)[3][4],
                                     const uint32_t (&b)[kPairs][4],
                                     int pairs) {
#pragma unroll
  for (int k3 = 0; k3 < 3; ++k3)
#pragma unroll
    for (int i = 0; i < kPairs; ++i)
      if (i < pairs) {
        mma(d[2 * i], a[k3], b[i][0], b[i][1]);
        mma(d[2 * i + 1], a[k3], b[i][2], b[i][3]);
      }
}

// 64 rows of `cols` bf16 (a multiple of 8), row stride `ss` elements, into
// dst rows of pitch kRow, 16 bytes per cp.async
template <int kRow, int kThreads>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[kRow],
                                          const __nv_bfloat16* src,
                                          long long ss, int rows, int cols) {
  const int per_row = cols >> 3;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += kThreads) {
    const int r = idx / per_row, k = (idx % per_row) << 3;
    cp_async16(&dst[r][k], src + r * ss + k);
  }
}

// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kStateThreads, 2)
    ssd_chunk_state_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StateSmem& sm = *reinterpret_cast<StateSmem*>(smem_raw);
  const int ci = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H, grp = h / (a.H / a.G);
  const int c = a.chunk, ntiles = c / kTile;
  const long long s0 = (long long)ci * c;
  const __nv_bfloat16* xc = a.x + b * a.x_sb + h * a.x_sh + s0 * a.x_ss;
  const __nv_bfloat16* Bc = a.B + b * a.b_sb + grp * a.b_sg + s0 * a.b_ss;

  auto load = [&](int jt, int buf) {
    load_tile<kRowX, kStateThreads>(sm.x[buf], xc + jt * kTile * a.x_ss,
                                    a.x_ss, kTile, a.P);
    load_tile<kRowN, kStateThreads>(sm.b[buf], Bc + jt * kTile * a.b_ss,
                                    a.b_ss, kTile, a.N);
    cp_async_commit();
  };
  load(0, 0);

  chunk_cumsum(sm.cum, sm.w, sm.warp_tot,
               a.dt + b * a.dt_sb + h * a.dt_sh + s0 * a.dt_ss, a.dt_ss,
               a.A[h], c);
  // cum and dt for chunk_out, then w = dt exp(cum_last - cum) in place of dt
  const double cum_last = sm.cum[c - 1];
  const long long crow = ((long long)bh * a.nc + ci) * c;
  if (threadIdx.x < c) {
    const float d = sm.w[threadIdx.x];
    a.cum[crow + threadIdx.x] = sm.cum[threadIdx.x];
    a.dts[crow + threadIdx.x] = d;
    sm.w[threadIdx.x] = d * expf((float)(cum_last - sm.cum[threadIdx.x]));
  }
  if (threadIdx.x == 0)
    a.seg[(long long)bh * a.nc + ci] = expf((float)cum_last);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, q = lane >> 3, r = lane & 7;
  const int p0 = (warp & 3) * 16, n0 = (warp >> 2) * 64;
  const bool active = p0 < a.P && n0 < a.N;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int jt = 0; jt < ntiles; ++jt) {
    const int buf = jt & 1;
    if (jt + 1 < ntiles) {
      load(jt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the tile, and w, visible to every warp
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        // A = (x o w)^T: rows p, k = j; x is stored [j][p], so .trans
        uint32_t xa[4], aw[3][4];
        ldsm_x4_t(xa, &sm.x[buf][kk * 16 + r + (q >> 1) * 8][p0 + (q & 1) * 8]);
        const float* wj = sm.w + jt * kTile + kk * 16 + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {   // e >= 2: columns k + 8
          __nv_bfloat162 xv;
          *reinterpret_cast<uint32_t*>(&xv) = xa[e];
          const float2 xf = __bfloat1622float2(xv);
          const int k = e >= 2 ? 8 : 0;
          split3(xf.x * wj[k], xf.y * wj[k + 1], aw[0][e], aw[1][e],
                 aw[2][e]);
        }
        // B_j stored [j][n] = [k][n]: .trans; pairs of 8-wide n tiles
        const int pairs = min(4, (a.N - n0) / 16);
        uint32_t bb[4][4];
#pragma unroll
        for (int np = 0; np < 4; ++np)
          if (np < pairs)
            ldsm_x4_t(bb[np], &sm.b[buf][kk * 16 + r + (q & 1) * 8][n0 + np * 16 + (q >> 1) * 8]);
        mma3<4>(acc, aw, bb, pairs);
      }
    }
    __syncthreads();  // the buffer is free for the load two tiles on
  }

  if (!active) return;
  float* Sb = a.ws + ((long long)bh * a.nc + ci) * a.P * a.N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = n0 + nt * 8 + 2 * t;
    if (n < a.N) {
      *reinterpret_cast<float2*>(Sb + (p0 + g) * a.N + n) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(Sb + (p0 + g + 8) * a.N + n) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kOutThreads, 3)
    ssd_chunk_out_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  OutSmem& sm = *reinterpret_cast<OutSmem*>(smem_raw);
  const int ntiles = a.chunk / kTile;
  const int ci = blockIdx.x, bh = blockIdx.y,
            it = ntiles - 1 - (int)blockIdx.z;
  const int b = bh / a.H, h = bh % a.H, grp = h / (a.H / a.G);
  const int i0 = it * kTile, P = a.P, N = a.N;
  const long long s0 = (long long)ci * a.chunk;
  const __nv_bfloat16* xc = a.x + b * a.x_sb + h * a.x_sh + s0 * a.x_ss;
  const __nv_bfloat16* Bc = a.B + b * a.b_sb + grp * a.b_sg + s0 * a.b_ss;
  const __nv_bfloat16* Cc = a.C + b * a.c_sb + grp * a.c_sg + s0 * a.c_ss;
  const bool has_state = ci > 0;

  auto load = [&](int jt, int buf) {
    load_tile<kRowN, kOutThreads>(sm.b[buf], Bc + jt * kTile * a.b_ss,
                                  a.b_ss, kTile, N);
    load_tile<kRowX, kOutThreads>(sm.x[buf], xc + jt * kTile * a.x_ss,
                                  a.x_ss, kTile, P);
    cp_async_commit();
  };
  // group 0: C_i, and cum and dt of the rows up to this tile's last (as
  // chunk_state summed them)
  load_tile<kRowN, kOutThreads>(sm.c, Cc + i0 * a.c_ss, a.c_ss, kTile, N);
  const long long crow = ((long long)bh * a.nc + ci) * a.chunk;
  for (int k = threadIdx.x; k < (i0 + kTile) / 2; k += kOutThreads)
    cp_async16(&sm.cum[2 * k], a.cum + crow + 2 * k);
  for (int k = threadIdx.x; k < (i0 + kTile) / 4; k += kOutThreads)
    cp_async16(&sm.dts[4 * k], a.dts + crow + 4 * k);
  cp_async_commit();
  // H_c [p][n] float32 into registers, split into bf16 pieces below; the
  // first x and B tiles follow the state term, whose pieces hold their
  // buffers (without a state they go now)
  constexpr int kHLoads = kMaxP * kMaxN / 4 / kOutThreads;
  const int per_row = N >> 2;
  float4 hv[kHLoads];
  if (has_state) {
    const float4* Hc = reinterpret_cast<const float4*>(
        a.ws + ((long long)bh * a.nc + ci) * P * N);
#pragma unroll
    for (int k = 0; k < kHLoads; ++k) {
      const int idx = threadIdx.x + k * kOutThreads;
      if (idx < P * per_row) hv[k] = Hc[idx];
    }
  } else {
    load(0, 0);
  }

  if (has_state) {
#pragma unroll
    for (int k = 0; k < kHLoads; ++k) {
      const int idx = threadIdx.x + k * kOutThreads;
      if (idx < P * per_row) {
        const int row = idx / per_row, col = (idx % per_row) << 2;
        uint32_t hi[2], mid[2], lo[2];
        split3(hv[k].x, hv[k].y, hi[0], mid[0], lo[0]);
        split3(hv[k].z, hv[k].w, hi[1], mid[1], lo[1]);
        *reinterpret_cast<uint2*>(&sm.h[row][col]) = make_uint2(hi[0], hi[1]);
        *reinterpret_cast<uint2*>(&sm.b[0][row][col]) =
            make_uint2(mid[0], mid[1]);
        *reinterpret_cast<uint2*>(&sm.b[1][row][col]) =
            make_uint2(lo[0], lo[1]);
      }
    }
    cp_async_wait<0>();
  } else {
    cp_async_wait<1>();
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, q = lane >> 3, r = lane & 7;
  const int m0 = warp * 16;           // this warp's rows within the tile
  const int gi0 = i0 + m0 + g, gi1 = gi0 + 8;
  const int ppairs = P / 16;          // 16-wide p column pairs

  // C_i as A fragments (rows i, k = n), kept for every product below
  uint32_t cf[kMaxN / 16][4];
#pragma unroll
  for (int ks = 0; ks < kMaxN / 16; ++ks)
    if (ks * 16 < N)
      ldsm_x4(cf[ks], &sm.c[m0 + (lane & 15)][ks * 16 + (lane >> 4) * 8]);

  float acc[kMaxP / 8][4];
#pragma unroll
  for (int i = 0; i < kMaxP / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  if (has_state) {
    // exp(cum_i) C_i (H_hi + H_mid + H_lo)^T; H is stored [p][n] = [n8][k]
    const __nv_bfloat16(*pieces[3])[kRowN] = {sm.h, sm.b[0], sm.b[1]};
#pragma unroll
    for (int ks = 0; ks < kMaxN / 16; ++ks) {
      if (ks * 16 >= N) break;
#pragma unroll
      for (int k3 = 0; k3 < 3; ++k3) {
        uint32_t hb[kMaxP / 16][4];
#pragma unroll
        for (int pp = 0; pp < kMaxP / 16; ++pp)
          if (pp < ppairs)
            ldsm_x4(hb[pp], &pieces[k3][pp * 16 + r + (q >> 1) * 8][ks * 16 + (q & 1) * 8]);
#pragma unroll
        for (int pp = 0; pp < kMaxP / 16; ++pp)
          if (pp < ppairs) {
            mma(acc[2 * pp], cf[ks], hb[pp][0], hb[pp][1]);
            mma(acc[2 * pp + 1], cf[ks], hb[pp][2], hb[pp][3]);
          }
      }
    }
    const float e0 = expf((float)sm.cum[gi0]), e1 = expf((float)sm.cum[gi1]);
#pragma unroll
    for (int i = 0; i < kMaxP / 8; ++i) {
      acc[i][0] *= e0;
      acc[i][1] *= e0;
      acc[i][2] *= e1;
      acc[i][3] *= e1;
    }
    __syncthreads();  // the pieces' buffers are free for the tiles
    load(0, 0);
  }

  const double cum0 = sm.cum[gi0], cum1 = sm.cum[gi1];
  for (int jt = 0; jt <= it; ++jt) {
    const int buf = jt & 1;
    if (jt < it) {
      load(jt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // C_i B_j^T: rows i, cols j; B_j is stored [j][n] = [n8][k]
    float sc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kMaxN / 16; ++ks) {
      if (ks * 16 >= N) break;
      uint32_t bb[4][4];
#pragma unroll
      for (int jp = 0; jp < 4; ++jp)
        ldsm_x4(bb[jp], &sm.b[buf][jp * 16 + r + (q >> 1) * 8][ks * 16 + (q & 1) * 8]);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        mma(sc[2 * jp], cf[ks], bb[jp][0], bb[jp][1]);
        mma(sc[2 * jp + 1], cf[ks], bb[jp][2], bb[jp][3]);
      }
    }

    // M = CB exp(cum_i - cum_j) dt_j for i >= j; only the diagonal tile
    // has pairs i < j, which are zeroed without an exp
    const bool diag = jt == it;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gj = jt * kTile + nt * 8 + 2 * t + e;
        const double cj = sm.cum[gj];
        const float dj = sm.dts[gj];
        sc[nt][e] = (!diag || gi0 >= gj)
                        ? sc[nt][e] * expf((float)(cum0 - cj)) * dj
                        : 0.f;
        sc[nt][2 + e] = (!diag || gi1 >= gj)
                            ? sc[nt][2 + e] * expf((float)(cum1 - cj)) * dj
                            : 0.f;
      }

    // y += (M_hi + M_mid + M_lo) x_j, M's A fragments straight from sc;
    // x_j is stored [j][p] = [k][n8]: .trans
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t m[3][4];
      split3(sc[2 * kk][0], sc[2 * kk][1], m[0][0], m[1][0], m[2][0]);
      split3(sc[2 * kk][2], sc[2 * kk][3], m[0][1], m[1][1], m[2][1]);
      split3(sc[2 * kk + 1][0], sc[2 * kk + 1][1], m[0][2], m[1][2],
             m[2][2]);
      split3(sc[2 * kk + 1][2], sc[2 * kk + 1][3], m[0][3], m[1][3],
             m[2][3]);
      uint32_t xb[kMaxP / 16][4];
#pragma unroll
      for (int pp = 0; pp < kMaxP / 16; ++pp)
        if (pp < ppairs)
          ldsm_x4_t(xb[pp], &sm.x[buf][kk * 16 + r + (q & 1) * 8][pp * 16 + (q >> 1) * 8]);
      mma3<kMaxP / 16>(acc, m, xb, ppairs);
    }
    __syncthreads();  // the buffer is free for the load two tiles on
  }

  const long long y_ss = (long long)a.H * P;
  __nv_bfloat16* yr = a.y + ((long long)b * a.S_len + s0 + gi0) * y_ss +
                      (long long)h * P;
#pragma unroll
  for (int pt = 0; pt < kMaxP / 8; ++pt) {
    const int p = pt * 8 + 2 * t;
    if (p < P) {
      *reinterpret_cast<__nv_bfloat162*>(yr + p) =
          __floats2bfloat162_rn(acc[pt][0], acc[pt][1]);
      *reinterpret_cast<__nv_bfloat162*>(yr + 8 * y_ss + p) =
          __floats2bfloat162_rn(acc[pt][2], acc[pt][3]);
    }
  }
}

// the shared-memory opt-in is per device; set it on a device's first call
int set_smem_once() {
  static unsigned set_on = 0;  // bit d: done for device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32 && (set_on & (1u << dev))) return 0;
  err = cudaFuncSetAttribute(ssd_chunk_state_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(StateSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_chunk_out_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(OutSmem));
  if (err != cudaSuccess) return (int)err;
  if (dev < 32) set_on |= 1u << dev;
  return 0;
}

}  // namespace

// x: [b, s, h, p]; B, C: [b, s, g, n] (bf16, unit last stride, every other
// stride and each base a multiple of 16 bytes); dt: [b, s, h] float32;
// A: [h] float32; y: [b, s, h, p] bf16 contiguous.  Workspace from the
// caller, nc = s / chunk: ws [b*h*nc*p*n] and seg [b*h*nc] float32, cum
// [b*h*nc*chunk] double, dts [b*h*nc*chunk] float32.  fin: null, or the
// final state [b, h, p, n] float32, written by the state pass.
// Needs p, n multiples of 16 with p <= 64, n <= 128, chunk a multiple of
// 64 up to 256, s % chunk == 0, h % g == 0 and b*h <= 65535; returns
// cudaErrorInvalidValue otherwise.  Launches ssd_chunk_state_kernel,
// ssd_state_pass_kernel (when nc > 1 or fin is given) and
// ssd_chunk_out_kernel, in that order, on `stream`: one launch of the route as its wrapper
// (kernels/ssd_scan.py) counts it.  Returns the first launch error.
extern "C" int repro_ssd_scan_sm90(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, void* ws, void* seg, void* cum, void* dts,
    void* fin, int batch, int S, int H, int G, int P, int N, int chunk, long long x_sb,
    long long x_ss, long long x_sh, long long dt_sb, long long dt_ss,
    long long dt_sh, long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg, void* stream) {
  if (batch == 0 || S == 0 || H == 0) return (int)cudaGetLastError();
  if (P <= 0 || P % 16 || P > kMaxP || N <= 0 || N % 16 || N > kMaxN ||
      chunk <= 0 || chunk % kTile || chunk > kMaxChunk || S % chunk ||
      G <= 0 || H % G || (long long)batch * H > 65535)
    return (int)cudaErrorInvalidValue;
  int err = set_smem_once();
  if (err) return err;
  const int nc = S / chunk;
  const Args a{static_cast<const __nv_bfloat16*>(x),
               static_cast<const float*>(dt),
               static_cast<const float*>(A),
               static_cast<const __nv_bfloat16*>(B),
               static_cast<const __nv_bfloat16*>(C),
               static_cast<__nv_bfloat16*>(y),
               static_cast<float*>(ws),
               static_cast<float*>(seg),
               static_cast<double*>(cum),
               static_cast<float*>(dts),
               S, H, G, P, N, chunk, nc,
               x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
               b_sb, b_ss, b_sg, c_sb, c_ss, c_sg};
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned bh = (unsigned)(batch * H);
  ssd_chunk_state_kernel<<<dim3((unsigned)nc, bh), kStateThreads,
                           sizeof(StateSmem), st>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  if (nc > 1 || fin) {
    const long long quads = (long long)bh * P * N / 4;
    ssd_state_pass_kernel<<<(unsigned)((quads + kPassThreads - 1) /
                                       kPassThreads),
                            kPassThreads, 0, st>>>(a.ws, a.seg, nc, P * N,
                                                   quads,
                                                   static_cast<float*>(fin));
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  ssd_chunk_out_kernel<<<dim3((unsigned)nc, bh, (unsigned)(chunk / kTile)),
                         kOutThreads, sizeof(OutSmem), st>>>(a);
  return (int)cudaGetLastError();
}
