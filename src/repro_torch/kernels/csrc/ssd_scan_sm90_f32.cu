// Mamba2 SSD chunk scan (forward, from a zero state) for Hopper (sm_90a) on
// the tensor cores: float32 x, B and C, chunk-parallel, to float32
// accuracy.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:ssd_scan_kernel (body
// _ssd_kernel), together with the group-to-head broadcast its wrapper
// repro/kernels/ops.py:ssd_scan does around it, for float32 at p <= 64,
// n <= 128 (multiples of 16) and chunk a multiple of 64: mamba2-2.7b's and
// jamba's p 64, n 128, chunk 256.  bf16 at those widths takes
// ssd_scan_sm90.cu; other widths take the CUDA-core ssd_scan.cu.  The
// three-kernel form is that of ssd_scan_sm90.cu.  Per (batch, head), with
// dA_j = dt_j A, cum the running sum of dA inside a chunk, w_j = dt_j
// exp(cum_last - cum_j) and L_ij = exp(cum_i - cum_j) for i >= j:
//   S_c     = sum_j x_j w_j B_j^T                       (chunk's state part)
//   H_0 = 0, H_{c+1} = exp(cum_last_c) H_c + S_c        (entering states)
//   y_i     = sum_{j<=i} ((C_i.B_j) L_ij dt_j) x_j + exp(cum_i) C_i.H_c^T
//
// Bound on this card: operations.  The scan counts c(c+1) n flops per
// (chunk, B/C group) over the causal pairs for C.B^T, and per (chunk,
// head) c(c+1) p for M.x plus 4 c p n for the entering-state term and the
// state update: 16.3 GFLOP at the main shape [1, 4096, 80, 64], n 128,
// c 256, g 1.  float32 accuracy from the tensor cores costs six bf16
// products per multiply-add (below), the same issue cost as three TF32
// products: 0.0987 ms at 989 TFLOP/s (0.2427 ms for the same flops at the
// CUDA cores' 67).  The compulsory bytes (x, B, C, dt read
// once, y written once, x, B and C as strided views of one [1, 4096, 5376]
// float32 activation) are ~173 MB, 0.052 ms at 3.35 TB/s.  What this design
// adds: the same float32 workspace as ssd_scan_sm90.cu (S, then H in place,
// 42 MB), and the six cross terms of every 16 x 8 x 16 product it issues
// (C B^T whole on the diagonal tile): 177 GFLOP (chunk_state 32.2,
// chunk_out 144.9).
//
// Precision: every product now has two float32 operands (x o w and B in
// chunk_state; C and H, C and B, M and x in chunk_out).  Each operand v is
// split into three bf16 pieces, v_hi = bf16(v), v_mid = bf16(v - v_hi),
// v_lo = bf16(v - v_hi - v_mid), which hold all 24 bits of v, and each
// product a.b is issued as the six cross terms hi.lo, lo.hi, mid.mid,
// hi.mid, mid.hi, then hi.hi; the three dropped (mid.lo, lo.mid, lo.lo) are
// <= 2^-26 of a term.  Dropping mid.mid too (~2^-18), or two pieces, puts
// elements outside the ssd_scan tier (rtol 1e-4, atol 1e-5) where y cancels
// from terms that sum to ~10-20 (tests/test_torch_ssd_sm90_f32.py emulates
// all three).  The tensor core adds into its float32 accumulator with
// truncation, so no accumulator chain is long: the six terms of one 16-deep
// step of a product start from zero and are added to the running float32
// sum by a rounded add, as flash_attention_tf32.cu does.  cum is
// accumulated in double (dt A formed in float32, as the reference forms
// it) and each difference is rounded to float32 before expf.
//
// Three kernels, launched in order on the caller's stream:
// 1. ssd_f32_chunk_state_kernel, one 256-thread block per (chunk,
//    batch*head), two an SM: cum in double (to `cum`, with dt gathered to
//    `dts`, for chunk_out), w, exp(cum_last) to `seg`, and S_c =
//    (x o w)^T B with the 64-row float32 tiles of x and B double-buffered
//    through cp.async.  Each of 8 warps owns 16 p x 64 n of S_c.
// 2. ssd_state_pass_kernel: the state pass of ssd_scan_sm90.cu, from the
//    header both share (ssd_scan_sm90_common.cuh, with the cp.async and
//    mma.sync wrappers, split3 and the decay sums): the workspace is
//    float32 in both routes.
// 3. ssd_f32_chunk_out_kernel, one 128-thread block per (chunk,
//    batch*head, 64-row tile i), two an SM, longest (last) tiles launched
//    first: each of 4 warps owns 16 rows i and keeps them of C_i in
//    registers as float32 A fragments, split into pieces at each use (kept
//    in the tile loop: hoisted out of it, the pieces would take 96
//    registers and spill).  C_i, cum, dt and H_c arrive in one cp.async
//    group (C_i and H_c in the B tiles' buffers); the entering-state term
//    C_i H_c^T comes first, scaled by exp(cum_i).  Then for each tile
//    j <= i (B_j and x_j double-buffered through cp.async) S = C_i B_j^T,
//    M = S o L o dt_j masked on the diagonal tile before exp, and
//    y += M x_j with M's pieces taken straight from the accumulators (the
//    m16n8 accumulator fragment has the layout of the next mma's A
//    fragment); on the diagonal tile a warp skips the steps of M x above
//    its rows.  y is stored in float32.  The kernel is built for each
//    p / 16, so its loops over p tiles have compile-time bounds: the
//    products of one 16-deep step over every p tile (or every n8 column
//    tile of S) form one block of independent mma.sync chains that the
//    scheduler interleaves.
//
// Fragments from float32 shared memory (ldmatrix has no 32-bit form): each
// lane reads its fragment's elements with 64- or 128-bit loads and splits
// them in registers.  The sums do not depend on which k slot holds which
// element, nor on which row or column of an mma tile holds which p or n,
// so the slots are assigned to make the loads wide:
// - contracting over n (C.H^T, C.B^T): k slots (2t, 2t+1, 2t+8, 2t+9) of
//   lane (g, t) hold n = 4t .. 4t+3 of the 16-deep step, one float4 per
//   row of C, H or B;
// - contracting over the chunk's rows j (x o w, B and x, whose rows are j):
//   a float2 of a row holds two neighbouring columns, which go to rows
//   (g, g + 8) of the A tile or to column g of two neighbouring n8 tiles,
//   so columns 4t .. 4t+3 of a 16-wide pair of tiles land in one lane and
//   are stored as one float4.
// Row pitches (floats) keep every such load free of bank conflicts: 4 mod
// 32 for the float2 reads down rows 2t (x, chunk_state's B), 16 mod 32 for
// float4 reads on rows g (chunk_out's C and B), 8 mod 32 for float4 reads
// on rows 2g (H).
//
// What this first float32 version leaves: each warp splits the B_j and x_j
// fragments it reads (four times per block in chunk_out), so the splits'
// FADD, F2FP and PRMT outnumber the HMMA in chunk_out's instruction mix;
// and chunk_out runs two blocks of 4 warps an SM (float32 tiles
// double-buffered take 112 KB).  A split pass into bf16 planes and a
// warpgroup pipeline are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <math.h>

#include "ssd_scan_sm90_common.cuh"

namespace {

constexpr int kRowX = kMaxP + 4;   // x tiles: float2 reads down rows 2t
constexpr int kRowBs = kMaxN + 4;  // chunk_state's B tiles: the same
constexpr int kRowBo = kMaxN + 16; // chunk_out's B and C: float4 on rows g
constexpr int kRowH = kMaxN + 8;   // H_c: float4 reads on rows 2g
constexpr int kOutThreads = 128;

struct Args {
  const float* x;           // [b, s, h, p], unit p stride
  const float* dt;          // [b, s, h]
  const float* A;           // [h]
  const float* B;           // [b, s, g, n], unit n stride
  const float* C;           // [b, s, g, n], unit n stride
  float* y;                 // [b, s, h, p] contiguous
  float* ws;                // [b*h, nc, p, n]: S_c, then H_c in place
  float* seg;               // [b*h, nc] exp(cum_last)
  double* cum;              // [b*h, nc, chunk] the decay's running sums
  float* dts;               // [b*h, nc, chunk] dt, gathered
  int S_len, H, G, P, N, chunk, nc;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg, c_sb, c_ss, c_sg;
};

struct StateSmem {   // 105.5 KB: two blocks an SM
  float x[2][kTile][kRowX];
  float b[2][kTile][kRowBs];
  double cum[kMaxChunk];
  float w[kMaxChunk];
  double warp_tot[kStateThreads / 32];
};

// 111.6 KB: two blocks an SM.  Before the first tile, b[1] stages C_i and
// b[0] holds H_c (pitch kRowH).
struct OutSmem {
  float b[2][kTile][kRowBo];
  float x[2][kTile][kRowX];
  double cum[kMaxChunk];
  float dts[kMaxChunk];
};
static_assert(sizeof(float[kMaxP][kRowH]) <= sizeof(float[kTile][kRowBo]),
              "H_c fits a B tile's buffer");
static_assert(2 * (sizeof(OutSmem) + 1024) <= 228 * 1024,
              "two chunk_out blocks an SM");

// A fragment (pieces x registers) from a lane's float4 of row g and of row
// g + 8: k slots (2t, 2t+1) take elements 0, 1, slots (2t+8, 2t+9) 2, 3
__device__ __forceinline__ void split_a(const float4& r0, const float4& r1,
                                        uint32_t (&a)[3][4]) {
  split3(r0.x, r0.y, a[0][0], a[1][0], a[2][0]);
  split3(r1.x, r1.y, a[0][1], a[1][1], a[2][1]);
  split3(r0.z, r0.w, a[0][2], a[1][2], a[2][2]);
  split3(r1.z, r1.w, a[0][3], a[1][3], a[2][3]);
}

// B fragment from a lane's float4 of column g's row, in split_a's k slots
__device__ __forceinline__ void split_b(const float4& v, uint32_t (&b)[3][2]) {
  split3(v.x, v.y, b[0][0], b[1][0], b[2][0]);
  split3(v.z, v.w, b[0][1], b[1][1], b[2][1]);
}

// the float32 product of one 16-deep step, into a zeroed tile: the six
// cross terms, smallest first (the accumulator truncates)
__device__ __forceinline__ void mma6(float (&d)[4], const uint32_t (&a)[3][4],
                                     const uint32_t (&b)[3][2]) {
  mma(d, a[0], b[2][0], b[2][1]);   // hi.lo
  mma(d, a[2], b[0][0], b[0][1]);   // lo.hi
  mma(d, a[1], b[1][0], b[1][1]);   // mid.mid
  mma(d, a[0], b[1][0], b[1][1]);   // hi.mid
  mma(d, a[1], b[0][0], b[0][1]);   // mid.hi
  mma(d, a[0], b[0][0], b[0][1]);   // hi.hi
}

// v as a value the compiler cannot move out of the loop it is used in: C_i's
// pieces, hoisted out of the tile loop, would take 96 registers
__device__ __forceinline__ float4 in_place(float4 v) {
  asm volatile("" : "+f"(v.x), "+f"(v.y), "+f"(v.z), "+f"(v.w));
  return v;
}

// this thread's block and thread indices, read anew (not kept in registers
// from the kernel's start to its end)
__device__ __forceinline__ unsigned ctaid_y() {
  unsigned v;
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(v));
  return v;
}

__device__ __forceinline__ unsigned ctaid_xz(unsigned& z) {
  unsigned x;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(x));
  asm volatile("mov.u32 %0, %%ctaid.z;" : "=r"(z));
  return x;
}

__device__ __forceinline__ unsigned tid_x() {
  unsigned v;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(v));
  return v;
}

template <int kRows>
__device__ __forceinline__ void zero(float (&d)[kRows][4]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[i][e] = 0.f;
}

// acc += part for the first `rows` tiles, a rounded float32 add each
template <int kRows>
__device__ __forceinline__ void add_to(float (&acc)[kRows][4],
                                       const float (&part)[kRows][4],
                                       int rows) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if (i < rows)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = __fadd_rn(acc[i][e], part[i][e]);
}

// `rows` rows of `cols` floats (a multiple of 4), row stride `ss` elements,
// into dst rows of pitch kRow, 16 bytes per cp.async
template <int kRow, int kThreads>
__device__ __forceinline__ void load_tile(float (*dst)[kRow], const float* src,
                                          long long ss, int rows, int cols) {
  const int per_row = cols >> 2;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += kThreads) {
    const int r = idx / per_row, k = (idx % per_row) << 2;
    cp_async16(&dst[r][k], src + r * ss + k);
  }
}

// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kStateThreads, 2)
    ssd_f32_chunk_state_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StateSmem& sm = *reinterpret_cast<StateSmem*>(smem_raw);
  const int ci = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H, grp = h / (a.H / a.G);
  const int c = a.chunk, ntiles = c / kTile;
  const long long s0 = (long long)ci * c;
  const float* xc = a.x + b * a.x_sb + h * a.x_sh + s0 * a.x_ss;
  const float* Bc = a.B + b * a.b_sb + grp * a.b_sg + s0 * a.b_ss;

  auto load = [&](int jt, int buf) {
    load_tile<kRowX, kStateThreads>(sm.x[buf], xc + jt * kTile * a.x_ss,
                                    a.x_ss, kTile, a.P);
    load_tile<kRowBs, kStateThreads>(sm.b[buf], Bc + jt * kTile * a.b_ss,
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
  const int g = lane >> 2, t = lane & 3;
  // rows (g, g + 8) of the A tile are p0 + 2g and p0 + 2g + 1; column g of
  // n8 tiles (2np, 2np + 1) is n0 + 16 np + 2g and that + 1
  const int p0 = (warp & 3) * 16, n0 = (warp >> 2) * 64;
  const bool active = p0 < a.P && n0 < a.N;
  const int pairs = min(4, (a.N - n0) / 16);
  float acc[8][4];
  zero(acc);

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
        // k slots 2t, 2t+1, 2t+8, 2t+9 are the step's rows j
        const int r[4] = {kk * 16 + 2 * t, kk * 16 + 2 * t + 1,
                          kk * 16 + 2 * t + 8, kk * 16 + 2 * t + 9};
        uint32_t aw[3][4];
        {
          float2 xv[4];
          float wv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            xv[e] = *reinterpret_cast<const float2*>(&sm.x[buf][r[e]][p0 + 2 * g]);
            wv[e] = sm.w[jt * kTile + r[e]];
          }
          split3(xv[0].x * wv[0], xv[1].x * wv[1], aw[0][0], aw[1][0], aw[2][0]);
          split3(xv[0].y * wv[0], xv[1].y * wv[1], aw[0][1], aw[1][1], aw[2][1]);
          split3(xv[2].x * wv[2], xv[3].x * wv[3], aw[0][2], aw[1][2], aw[2][2]);
          split3(xv[2].y * wv[2], xv[3].y * wv[3], aw[0][3], aw[1][3], aw[2][3]);
        }
        float part[8][4];
        zero(part);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np < pairs) {
            float2 bv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              bv[e] = *reinterpret_cast<const float2*>(&sm.b[buf][r[e]][n0 + np * 16 + 2 * g]);
            uint32_t b0[3][2], b1[3][2];
            split3(bv[0].x, bv[1].x, b0[0][0], b0[1][0], b0[2][0]);
            split3(bv[2].x, bv[3].x, b0[0][1], b0[1][1], b0[2][1]);
            split3(bv[0].y, bv[1].y, b1[0][0], b1[1][0], b1[2][0]);
            split3(bv[2].y, bv[3].y, b1[0][1], b1[1][1], b1[2][1]);
            mma6(part[2 * np], aw, b0);
            mma6(part[2 * np + 1], aw, b1);
          }
        }
        add_to(acc, part, 2 * pairs);
      }
    }
    __syncthreads();  // the buffer is free for the load two tiles on
  }

  if (!active) return;
  // lane holds n0 + 16 np + 4t + (0, 1, 2, 3) = (tile 2np: d0, tile 2np+1:
  // d0, tile 2np: d1, tile 2np+1: d1) of row p0 + 2g, and d2/d3 of the next
  float* Sb = a.ws + ((long long)bh * a.nc + ci) * a.P * a.N;
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    if (np < pairs) {
      const int n = n0 + np * 16 + 4 * t;
      const float(&u)[4] = acc[2 * np];
      const float(&v)[4] = acc[2 * np + 1];
      *reinterpret_cast<float4*>(Sb + (p0 + 2 * g) * a.N + n) =
          make_float4(u[0], v[0], u[1], v[1]);
      *reinterpret_cast<float4*>(Sb + (p0 + 2 * g + 1) * a.N + n) =
          make_float4(u[2], v[2], u[3], v[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// kPP = p / 16: the loops over p tiles have compile-time bounds, so the
// products of one step over all p tiles form one block of independent
// mma.sync chains
template <int kPP>
__global__ void __launch_bounds__(kOutThreads, 2)
    ssd_f32_chunk_out_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  OutSmem& sm = *reinterpret_cast<OutSmem*>(smem_raw);
  const int ntiles = a.chunk / kTile;
  const int ci = blockIdx.x, bh = blockIdx.y,
            it = ntiles - 1 - (int)blockIdx.z;
  const int b = bh / a.H, h = bh % a.H, grp = h / (a.H / a.G);
  const int i0 = it * kTile, P = a.P, N = a.N;
  const long long s0 = (long long)ci * a.chunk;
  const float* xc = a.x + b * a.x_sb + h * a.x_sh + s0 * a.x_ss;
  const float* Bc = a.B + b * a.b_sb + grp * a.b_sg + s0 * a.b_ss;
  const float* Cc = a.C + b * a.c_sb + grp * a.c_sg + s0 * a.c_ss;
  const bool has_state = ci > 0;
  float(*ct)[kRowBo] = sm.b[1];
  float(*ht)[kRowH] = reinterpret_cast<float(*)[kRowH]>(&sm.b[0][0][0]);

  auto load = [&](int jt, int buf) {
    load_tile<kRowBo, kOutThreads>(sm.b[buf], Bc + jt * kTile * a.b_ss,
                                   a.b_ss, kTile, N);
    load_tile<kRowX, kOutThreads>(sm.x[buf], xc + jt * kTile * a.x_ss,
                                  a.x_ss, kTile, P);
    cp_async_commit();
  };
  // group 0: C_i, cum and dt of the rows up to this tile's last (as
  // chunk_state summed them), and H_c; without a state the first x and B
  // tiles follow as group 1
  load_tile<kRowBo, kOutThreads>(ct, Cc + i0 * a.c_ss, a.c_ss, kTile, N);
  const long long crow = ((long long)bh * a.nc + ci) * a.chunk;
  for (int k = threadIdx.x; k < (i0 + kTile) / 2; k += kOutThreads)
    cp_async16(&sm.cum[2 * k], a.cum + crow + 2 * k);
  for (int k = threadIdx.x; k < (i0 + kTile) / 4; k += kOutThreads)
    cp_async16(&sm.dts[4 * k], a.dts + crow + 4 * k);
  if (has_state)
    load_tile<kRowH, kOutThreads>(
        ht, a.ws + ((long long)bh * a.nc + ci) * P * N, N, P, N);
  cp_async_commit();
  if (has_state) {
    cp_async_wait<0>();
  } else {
    load(0, 0);
    cp_async_wait<1>();
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = warp * 16;           // this warp's rows within the tile
  const int gi0 = i0 + m0 + g, gi1 = gi0 + 8;
  const int nks = N / 16;             // 16-deep steps over n

  // C_i's rows gi0, gi1 as float32: n = 16 ks + 4t .. 4t+3 of each
  float4 cv[kMaxN / 16][2];
#pragma unroll
  for (int ks = 0; ks < kMaxN / 16; ++ks)
    if (ks < nks) {
      cv[ks][0] = *reinterpret_cast<const float4*>(&ct[m0 + g][ks * 16 + 4 * t]);
      cv[ks][1] = *reinterpret_cast<const float4*>(&ct[m0 + g + 8][ks * 16 + 4 * t]);
    }

  // y: n8 tile 2pp column g is p = 16 pp + 2g, tile 2pp + 1 that + 1, so a
  // lane holds p = 16 pp + 4t .. 4t+3 of rows gi0 (d0, d1) and gi1 (d2, d3)
  float acc[2 * kPP][4];
  zero(acc);

  if (has_state) {
    // exp(cum_i) C_i H_c^T; H is stored [p][n]: column p's row
#pragma unroll
    for (int ks = 0; ks < kMaxN / 16; ++ks) {
      if (ks >= nks) break;
      uint32_t ca[3][4];
      split_a(cv[ks][0], cv[ks][1], ca);
      float part[2 * kPP][4];
      zero(part);
#pragma unroll
      for (int pp = 0; pp < kPP; ++pp) {
        const int row = pp * 16 + 2 * g;
        uint32_t h0[3][2], h1[3][2];
        split_b(*reinterpret_cast<const float4*>(&ht[row][ks * 16 + 4 * t]), h0);
        split_b(*reinterpret_cast<const float4*>(&ht[row + 1][ks * 16 + 4 * t]), h1);
        mma6(part[2 * pp], ca, h0);
        mma6(part[2 * pp + 1], ca, h1);
      }
      add_to(acc, part, 2 * kPP);
    }
    const float e0 = expf((float)sm.cum[gi0]), e1 = expf((float)sm.cum[gi1]);
#pragma unroll
    for (int i = 0; i < 2 * kPP; ++i) {
      acc[i][0] *= e0;
      acc[i][1] *= e0;
      acc[i][2] *= e1;
      acc[i][3] *= e1;
    }
    __syncthreads();  // C_i's and H_c's buffers are free for the tiles
    load(0, 0);
  } else {
    __syncthreads();  // C_i's buffer is free for tile 1
  }

  for (int jt = 0; jt <= it; ++jt) {
    const int buf = jt & 1;
    if (jt < it) {
      load(jt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // C_i B_j^T: rows i, columns j (standard n8 layout: tile q's column g
    // is row 8 q + g of B_j); eight chains a 16-deep step
    float sc[8][4];
    zero(sc);
#pragma unroll
    for (int ks = 0; ks < kMaxN / 16; ++ks) {
      if (ks >= nks) break;
      uint32_t ca[3][4];
      split_a(in_place(cv[ks][0]), in_place(cv[ks][1]), ca);
      float part[8][4];
      zero(part);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        uint32_t bb[3][2];
        split_b(*reinterpret_cast<const float4*>(&sm.b[buf][q * 8 + g][ks * 16 + 4 * t]), bb);
        mma6(part[q], ca, bb);
      }
      add_to(sc, part, 8);
    }

    // M = CB exp(cum_i - cum_j) dt_j for i >= j; only the diagonal tile
    // has pairs i < j, which are zeroed without an exp.  cum_i is read
    // here, not kept: the registers are spoken for
    const bool diag = jt == it;
    const double cum0 = sm.cum[gi0], cum1 = sm.cum[gi1];
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gj = jt * kTile + q * 8 + 2 * t + e;
        const double cj = sm.cum[gj];
        const float dj = sm.dts[gj];
        sc[q][e] = (!diag || gi0 >= gj)
                       ? sc[q][e] * expf((float)(cum0 - cj)) * dj
                       : 0.f;
        sc[q][2 + e] = (!diag || gi1 >= gj)
                           ? sc[q][2 + e] * expf((float)(cum1 - cj)) * dj
                           : 0.f;
      }

    // y += M x_j, 16 rows j a step: M's A fragment is the accumulators of
    // n8 tiles 2kk, 2kk+1 (k slots j = 16 kk + 2t, 2t+1, 2t+8, 2t+9); x_j's
    // float2 at those rows holds columns p = 16 pp + 2g, 2g + 1.  On the
    // diagonal tile a warp stops at the first step above its last row i
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      if (diag && kk * 16 > m0 + 15) break;
      uint32_t m[3][4];
      split3(sc[2 * kk][0], sc[2 * kk][1], m[0][0], m[1][0], m[2][0]);
      split3(sc[2 * kk][2], sc[2 * kk][3], m[0][1], m[1][1], m[2][1]);
      split3(sc[2 * kk + 1][0], sc[2 * kk + 1][1], m[0][2], m[1][2],
             m[2][2]);
      split3(sc[2 * kk + 1][2], sc[2 * kk + 1][3], m[0][3], m[1][3],
             m[2][3]);
      const int r = kk * 16 + 2 * t;
      float part[2 * kPP][4];
      zero(part);
#pragma unroll
      for (int pp = 0; pp < kPP; ++pp) {
        const int col = pp * 16 + 2 * g;
        const float2 v0 = *reinterpret_cast<const float2*>(&sm.x[buf][r][col]);
        const float2 v1 = *reinterpret_cast<const float2*>(&sm.x[buf][r + 1][col]);
        const float2 v2 = *reinterpret_cast<const float2*>(&sm.x[buf][r + 8][col]);
        const float2 v3 = *reinterpret_cast<const float2*>(&sm.x[buf][r + 9][col]);
        uint32_t x0[3][2], x1[3][2];
        split3(v0.x, v1.x, x0[0][0], x0[1][0], x0[2][0]);
        split3(v2.x, v3.x, x0[0][1], x0[1][1], x0[2][1]);
        split3(v0.y, v1.y, x1[0][0], x1[1][0], x1[2][0]);
        split3(v2.y, v3.y, x1[0][1], x1[1][1], x1[2][1]);
        mma6(part[2 * pp], m, x0);
        mma6(part[2 * pp + 1], m, x1);
      }
      add_to(acc, part, 2 * kPP);
    }
    __syncthreads();  // the buffer is free for the load two tiles on
  }

  // the output row, from indices read anew
  unsigned tile_z;
  const long long row0 = (long long)ctaid_xz(tile_z) * a.chunk +
                         (ntiles - 1 - (int)tile_z) * kTile +
                         (tid_x() >> 5) * 16 + ((tid_x() & 31) >> 2);
  const int bh_out = (int)ctaid_y();
  const long long y_ss = (long long)a.H * P;
  float* yr = a.y + ((long long)(bh_out / a.H) * a.S_len + row0) * y_ss +
              (long long)(bh_out % a.H) * P;
  const int t_out = tid_x() & 3;
#pragma unroll
  for (int pp = 0; pp < kPP; ++pp) {
    const int p = pp * 16 + 4 * t_out;
    const float(&u)[4] = acc[2 * pp];
    const float(&v)[4] = acc[2 * pp + 1];
    *reinterpret_cast<float4*>(yr + p) = make_float4(u[0], v[0], u[1], v[1]);
    *reinterpret_cast<float4*>(yr + 8 * y_ss + p) =
        make_float4(u[2], v[2], u[3], v[3]);
  }
}

// the shared-memory opt-in is per device and per kernel; set it on the
// device's first launch of `kernel` (bit d of `set_on`: done for device d)
template <typename Kernel>
int opt_in(Kernel* kernel, int bytes, unsigned& set_on) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32 && (set_on & (1u << dev))) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32) set_on |= 1u << dev;
  return 0;
}

int launch_state(const Args& a, dim3 grid, cudaStream_t st) {
  static unsigned set_on = 0;
  const int err = opt_in(ssd_f32_chunk_state_kernel, (int)sizeof(StateSmem),
                         set_on);
  if (err) return err;
  ssd_f32_chunk_state_kernel<<<grid, kStateThreads, sizeof(StateSmem), st>>>(
      a);
  return (int)cudaGetLastError();
}

template <int kPP>
int launch_out(const Args& a, dim3 grid, cudaStream_t st) {
  static unsigned set_on = 0;
  const int err = opt_in(ssd_f32_chunk_out_kernel<kPP>,
                         (int)sizeof(OutSmem), set_on);
  if (err) return err;
  ssd_f32_chunk_out_kernel<kPP><<<grid, kOutThreads, sizeof(OutSmem),
                                  st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [b, s, h, p]; B, C: [b, s, g, n] (float32, unit last stride, every
// other stride and each base a multiple of 16 bytes); dt: [b, s, h]
// float32; A: [h] float32; y: [b, s, h, p] float32 contiguous.  Workspace
// from the caller, nc = s / chunk: ws [b*h*nc*p*n] and seg [b*h*nc]
// float32, cum [b*h*nc*chunk] double, dts [b*h*nc*chunk] float32.
// Needs p, n multiples of 16 with p <= 64, n <= 128, chunk a multiple of
// 64 up to 256, s % chunk == 0, h % g == 0 and b*h <= 65535; returns
// cudaErrorInvalidValue otherwise.  Launches ssd_f32_chunk_state_kernel,
// ssd_state_pass_kernel (when nc > 1) and ssd_f32_chunk_out_kernel, in
// that order, on `stream`: one launch of the route as its wrapper
// (kernels/ssd_scan.py) counts it.  Returns the first launch error.
extern "C" int repro_ssd_scan_sm90_f32(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, void* ws, void* seg, void* cum, void* dts,
    int batch, int S, int H, int G, int P, int N, int chunk, long long x_sb,
    long long x_ss, long long x_sh, long long dt_sb, long long dt_ss,
    long long dt_sh, long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg, void* stream) {
  if (batch == 0 || S == 0 || H == 0) return (int)cudaGetLastError();
  if (P <= 0 || P % 16 || P > kMaxP || N <= 0 || N % 16 || N > kMaxN ||
      chunk <= 0 || chunk % kTile || chunk > kMaxChunk || S % chunk ||
      G <= 0 || H % G || (long long)batch * H > 65535)
    return (int)cudaErrorInvalidValue;
  const int nc = S / chunk;
  const Args a{static_cast<const float*>(x),
               static_cast<const float*>(dt),
               static_cast<const float*>(A),
               static_cast<const float*>(B),
               static_cast<const float*>(C),
               static_cast<float*>(y),
               static_cast<float*>(ws),
               static_cast<float*>(seg),
               static_cast<double*>(cum),
               static_cast<float*>(dts),
               S, H, G, P, N, chunk, nc,
               x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
               b_sb, b_ss, b_sg, c_sb, c_ss, c_sg};
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned bh = (unsigned)(batch * H);
  const dim3 state_grid((unsigned)nc, bh);
  int err = launch_state(a, state_grid, st);
  if (err) return err;
  if (nc > 1) {
    const long long quads = (long long)bh * P * N / 4;
    ssd_state_pass_kernel<<<(unsigned)((quads + kPassThreads - 1) /
                                       kPassThreads),
                            kPassThreads, 0, st>>>(a.ws, a.seg, nc, P * N,
                                                   quads);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  const dim3 out_grid((unsigned)nc, bh, (unsigned)(chunk / kTile));
  switch (P / 16) {
    case 1: return launch_out<1>(a, out_grid, st);
    case 2: return launch_out<2>(a, out_grid, st);
    case 3: return launch_out<3>(a, out_grid, st);
    default: return launch_out<4>(a, out_grid, st);
  }
}
