// Mamba2 SSD chunk scan (forward, from a zero state) on the CUDA cores of
// Hopper (sm_90a), chunk-parallel, for the widths the tensor-core routes
// refuse.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:ssd_scan_kernel (body
// _ssd_kernel), together with the group-to-head broadcast its wrapper
// repro/kernels/ops.py:ssd_scan does around it.  Serves every call that
// kernels/ssd_scan.py:_tensor_core_widths refuses (chunk not a multiple of
// 64, p or n not a multiple of 16, p > 64): the tiny ssm configurations'
// chunk 8, p 16, n 16, and any SSM width outside mamba2-2.7b's (64, 128,
// 256).  bf16 or float32 x, B and C; float32 dt and A; chunk <= 256,
// n <= 128, any p; float32 math, y in x's dtype.
//
// Per (batch, head), with dA_r = dt_r A, L_ij = exp(sum_{j<r<=i} dA_r)
// for i >= j in one chunk, the reference computes chunk by chunk
//   y_i   = sum_{j<=i} ((C_i.B_j) L_ij dt_j) x_j + exp(cum_i) C_i.state^T
//   state = exp(cum_last) state + sum_j x_j dt_j exp(cum_last - cum_j) B_j^T
// Rows go in groups: max(1, 64 / chunk) chunks (at most 64 rows), or one
// chunk above 64 rows.  The workspace holds one [p, n] float32 state per
// group, not per chunk: at chunk 8, p = n = 16, a state per chunk would be
// twice x's own bytes.  Kernels, in order on the caller's stream:
// 1. ssd_cc_chunk_state_kernel, a block per (group, batch and block of
//    heads of one B/C group, p tile): the group's decay sums G (double),
//    exp(G_last) to `seg`, and its state part S_g = sum_j x_j w_j B_j^T,
//    w_j = dt_j exp(G_last - G_j), to `ws` as [n][p]; 32-row tiles of x
//    and B double-buffered through cp.async, 4 x 8 products a thread (x_j
//    w_j formed once in shared memory) or 2 x 4 at narrow widths, where
//    several heads share each B tile.
// 2. ssd_state_pass_kernel (ssd_scan_sm90_common.cuh, included as it is):
//    H_{g+1} = seg_g H_g + S_g in float32, each multiply and add rounded,
//    sequential over groups, elementwise over the [p, n] state padded to
//    a multiple of 4 floats.
// 3. chunk <= 64: ssd_cc_chunk_out_small_kernel, a block per (group,
//    batch and block of heads of one B/C group, p tile).  x, B, C and the
//    decay factors of the group's rows go to shared memory; C_i.B_j o L o
//    dt_j for the pairs i >= j of each chunk (chunk x chunk, C.B once for
//    all heads of the block) is stored transposed, zero above the
//    diagonal.  Each (head, p) pair belongs to TN neighbouring threads
//    that hold 8 of its n state elements each in registers, starting from
//    the group's H; the block walks the group's chunks in order with that
//    state and no barrier: per 8 rows, each thread sums its share of the
//    entering-state term and of the intra-chunk term, shuffles add the
//    shares, then the state update.  Narrow heads share a block.
//    chunk > 64: ssd_cc_chunk_cb_kernel, a block per (batch, B/C group,
//    chunk, pair of 64-row tiles j <= i), writes C_i B_j^T to `cb` once
//    for all the heads of the group (80 at mamba2-2.7b's widths); then
//    ssd_cc_chunk_out_large_kernel, a block per (chunk of a (batch, head),
//    p tile of 64, 64-row tile i), longest tiles first, three blocks an
//    SM: exp(G_i) C_i H^T, then for each tile j <= i, M = C B^T o
//    exp(G_i - G_j) o dt_j (masked before exp) and M x_j, 4 x 4 a thread,
//    x_j double-buffered through cp.async in the bytes C_i and H used; on
//    the diagonal tile a warp stops M x at its own rows.  No configuration
//    of the repo sends a chunk above 64 rows here (mamba2-2.7b's widths go
//    to the tensor-core routes), so this path is one build, untuned for
//    narrow p.
// x, B and C are read through their strides (in the model they are views of
// one xBC activation) at group h / (H / G): no broadcast or contiguous
// copies.  Where every 4-element group of an operand is aligned, its tiles
// load as 16-byte cp.async (float32) or 8-byte loads (bf16); otherwise
// element by element.
//
// Bound on this card, as chip_smoke.py's ssd_bound counts it (x, B, C, dt
// read once, y written once; c(c+1) n flops a chunk and B/C group for
// C B^T over the causal pairs, and per head c(c+1) p for M x plus 4 c p n
// for the entering state and its update), at the CUDA cores' 67 TFLOP/s
// float32 peak and 3.35 TB/s, and what the design does at each yardstick
// (benchmarks/torch_ssd_cuda_cores.py on an H100 80GB HBM3 at 700 W, its
// --variants taking one piece of work out at a time):
// - narrow, x [1, 4096, 320, 16], n 16, chunk 8: bytes, 173.5 MB, 0.0518
//   ms (operations 1.53 GFLOP, 0.0229 ms).  The design reads x twice and
//   moves the 21 MB workspace three times (336 MB, ~0.10 ms); groups of 64
//   rows keep the workspace at a quarter of x, and the chunk x chunk
//   products keep the operations near the count above.  0.326 ms, 16% of
//   the bound: chunk_out_small takes 201 us, 77 without its walk of the
//   group's chunks, which is latency-bound at 3 blocks an SM, as is its
//   per-block load and decay prologue.
// - main, x [1, 4096, 80, 64], n 128, chunk 256 (mamba2-2.7b's widths,
//   which its configurations send to the tensor-core routes): operations,
//   16.26 GFLOP, 0.2427 ms (bytes 0.052 ms).  C B^T once per group and
//   chunk, not per head and p tile.  0.730 ms, 33%: of chunk_out_large's
//   434 us, 187 are neither product (loads of C_i, H, x_j and the C B^T
//   tiles, ~0.74 GB from L2, and M's exponentials); of chunk_state's 233,
//   125 are outside its products; the products themselves run at ~68% of
//   the float32 peak; the state pass and the C B^T pass add 42 us.
// - wide, x [1, 4096, 40, 128], n 128, chunk 256 (no configuration has
//   p 128): the same 16.26 GFLOP and 0.2427 ms; 0.736 ms, 33%, split as at
//   main (chunk_out_large 433 us, 177 of them neither product).
//
// Precision: the decay's running sums G are accumulated in double (dA
// formed in float32, as the reference forms it), each difference rounded
// to float32 before expf; the mask comes before exp, so only i >= j is
// exponentiated.  A chunk's cum_i is G_i - G_(chunk start - 1).
#include "common.cuh"
#include "ssd_scan_sm90_common.cuh"

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNsp = 8;             // state elements a chunk_out_small thread
constexpr int kBatch = 8;           // rows chunk_out_small sums at once
constexpr int kStateRows = 32;      // a chunk_state tile of rows
constexpr int kMtPitch = kTile + 4; // M^T rows of the large chunk_out
constexpr int kSmemCap = 232448;    // a block's most dynamic shared memory

struct Args {
  const void* x;      // [b, s, h, p], unit p stride
  const float* dt;    // [b, s, h]
  const float* A;     // [h]
  const void* B;      // [b, s, g, n], unit n stride
  const void* C;      // [b, s, g, n], unit n stride
  void* y;            // [b, s, h, p] contiguous
  float* ws;          // [b*h, groups, PN4]: S_g as [n][p], then H_g in place
  float* seg;         // [b*h, groups]: exp of each group's decay
  float* cb;          // chunk > 64: [b, g, chunks, tile pairs, 64, 64]
  int S, H, G, P, N, chunk;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg, c_sb, c_ss, c_sg;
};

// what the host decides for one kernel of a call
struct Plan {
  int R;      // rows a group (a whole number of chunks, <= 64 or one chunk)
  int NG;     // groups a sequence
  int PN4;    // floats a state in the workspace: p n rounded up to 4
  int HB;     // heads a block, all of one B/C group
  int HBLK;   // blocks of heads a B/C group
  int PT;     // p tile
  int XP;     // shared-memory pitch of x rows (PT rounded up to 4)
  int NPAD;   // n rounded up to the kernel's n tile (zeros past n)
  int NSTR;   // shared-memory pitch of B and C rows
  int TN;     // chunk_out_small: threads a (head, p) pair
  int vx, vb, vc, vh;  // 4-element groups of x, B, C, ws aligned
};

// W neighbouring floats of shared memory (16-, 8- or 4-byte aligned)
template <int W>
__device__ __forceinline__ void lds(float (&v)[W], const float* p) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const float4 t = *reinterpret_cast<const float4*>(p + 4 * q);
      v[4 * q] = t.x; v[4 * q + 1] = t.y; v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else if constexpr (W == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) v[e] = p[e];
  }
}

__device__ __forceinline__ void vec4(float* d, const float* s) {
  cp_async16(d, s);
}
__device__ __forceinline__ void vec4(float* d, const __nv_bfloat16* s) {
  const uint2 u = *reinterpret_cast<const uint2*>(s);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  *reinterpret_cast<float4*>(d) = make_float4(lo.x, lo.y, hi.x, hi.y);
}

// rows x cols (cols a multiple of 4) of a strided operand (row stride ss
// elements, unit column stride) into dst (row pitch `pitch` floats), zeros
// at rows >= rv or columns >= cv.  With vec, each 4-element group inside
// the operand is one vector load (cp.async for float32: the caller waits).
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const T* src,
                                          long long ss, int rows, int cols,
                                          int rv, int cv, bool vec) {
  const int c4 = cols >> 2;
  for (int idx = threadIdx.x; idx < rows * c4; idx += kThreads) {
    const int r = idx / c4, c = (idx - r * c4) << 2;
    float* d = dst + r * pitch + c;
    const T* s = src + r * ss + c;
    if (vec && r < rv && c + 4 <= cv) {
      vec4(d, s);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d[e] = (r < rv && c + e < cv) ? load_f32(s + e) : 0.f;
    }
  }
}

// G[r] = sum_{r' <= r} (double)(dt_r' A) and d[r] = dt_r for the `rows`
// (<= 256) rows of one head, by one warp: each lane sums a run of
// neighbouring rows, then the runs' totals are scanned across the warp.
__device__ __forceinline__ void warp_cumsum(double* G, float* d,
                                            const float* dt, long long dt_ss,
                                            float Ah, int rows) {
  const int lane = threadIdx.x & 31;
  const int per = (rows + 31) >> 5;
  const int r0 = lane * per;
  float v[8];
  double tot = 0.0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int r = r0 + k;
    v[k] = (k < per && r < rows) ? dt[r * dt_ss] : 0.f;
    tot += (double)(v[k] * Ah);
  }
  double incl = tot;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  double run = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) run = 0.0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int r = r0 + k;
    if (k < per && r < rows) {
      run += (double)(v[k] * Ah);
      G[r] = run;
      d[r] = v[k];
    }
  }
}

// the block's place: (group or chunk, batch, B/C group, block of heads,
// p tile) of the small-chunk kernels' grid
struct Place {
  int b, grp, h0, nh, p0, pw;
};

__device__ __forceinline__ Place place_of(const Args& a, const Plan& pl) {
  const int hpg = a.H / a.G;
  const int hb = blockIdx.y % pl.HBLK;
  const int grp = (blockIdx.y / pl.HBLK) % a.G;
  Place q;
  q.b = blockIdx.y / (pl.HBLK * a.G);
  q.grp = grp;
  q.h0 = grp * hpg + hb * pl.HB;
  q.nh = min(pl.HB, hpg - hb * pl.HB);
  q.p0 = blockIdx.z * pl.PT;
  q.pw = min(pl.PT, a.P - q.p0);
  return q;
}

// ---------------------------------------------------------------------------
// 1. S_g = sum_j x_j w_j B_j^T over a group's rows, and exp(G_last)
template <typename T, int TP, int TNN>
__global__ void __launch_bounds__(kThreads, TP == 2 ? 4 : 3)
    ssd_cc_chunk_state_kernel(Args a, Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int RW = (pl.R + kStateRows - 1) / kStateRows * kStateRows;
  const int stages = pl.R > kStateRows ? 2 : 1;
  const int xstage = pl.HB * kStateRows * pl.XP;
  const int bstage = kStateRows * pl.NSTR;
  float* xs = reinterpret_cast<float*>(smem);     // [st][HB][rows][XP]
  float* bs = xs + stages * xstage;               // [st][rows][NSTR]
  double* G = reinterpret_cast<double*>(bs + stages * bstage);  // [HB][RW]
  float* w = reinterpret_cast<float*>(G + pl.HB * RW);           // [HB][RW]
  float* d = w + pl.HB * RW;                                     // [HB][RW]

  const Place q = place_of(a, pl);
  const int gi = blockIdx.x;
  const int s0 = gi * pl.R;
  const int rows = min(pl.R, a.S - s0);
  const int ntiles = (rows + kStateRows - 1) / kStateRows;
  const T* xg = static_cast<const T*>(a.x) + q.b * a.x_sb +
                (long long)s0 * a.x_ss + q.h0 * a.x_sh + q.p0;
  const T* Bg = static_cast<const T*>(a.B) + q.b * a.b_sb +
                (long long)s0 * a.b_ss + q.grp * a.b_sg;

  auto issue = [&](int t) {
    float* xd = xs + (t & 1) * xstage;
    const int r0 = t * kStateRows, rv = min(kStateRows, rows - r0);
    for (int hh = 0; hh < pl.HB; ++hh)
      load_tile(xd + hh * kStateRows * pl.XP, pl.XP,
                xg + hh * a.x_sh + (long long)r0 * a.x_ss, a.x_ss, kStateRows,
                pl.XP, hh < q.nh ? rv : 0, q.pw, pl.vx);
    load_tile(bs + (t & 1) * bstage, pl.NSTR, Bg + (long long)r0 * a.b_ss,
              a.b_ss, kStateRows, pl.NPAD, rv, a.N, pl.vb);
    cp_async_commit();
  };
  issue(0);

  const int warp = threadIdx.x >> 5;
  for (int hh = warp; hh < q.nh; hh += kThreads / 32) {
    const int h = q.h0 + hh;
    warp_cumsum(G + hh * RW, d + hh * RW,
                a.dt + q.b * a.dt_sb + (long long)s0 * a.dt_ss + h * a.dt_sh,
                a.dt_ss, a.A[h], rows);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < pl.HB * RW; idx += kThreads) {
    const int hh = idx / RW, r = idx - hh * RW;
    float v = 0.f;
    if (hh < q.nh && r < rows)
      v = d[idx] * expf((float)(G[hh * RW + rows - 1] - G[idx]));
    w[idx] = v;
  }
  if (blockIdx.z == 0 && threadIdx.x < q.nh) {
    const int hh = threadIdx.x;
    a.seg[(long long)(q.b * a.H + q.h0 + hh) * pl.NG + gi] =
        expf((float)G[hh * RW + rows - 1]);
  }

  // thread -> (head, p unit, n unit), p fastest: p = TP pu + e,
  // n = 4 (nu + NU f) + i
  const int PU = pl.PT / TP, NU = pl.NPAD / TNN;
  const int pu = threadIdx.x % PU, nu = (threadIdx.x / PU) % NU;
  const int hh = threadIdx.x / (PU * NU);
  const bool active = hh < q.nh;
  float acc[TP][TNN];
#pragma unroll
  for (int e = 0; e < TP; ++e)
#pragma unroll
    for (int f = 0; f < TNN; ++f) acc[e][f] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      __syncthreads();
      issue(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // the 4 x 8 tile: x_j w_j in place, once for all the threads that read
    // it, which keeps w and the multiply out of the product loop (and its
    // registers under three blocks' share); the 2 x 4 tile multiplies there
    constexpr bool kScaled = TP == 4;
    if (kScaled) {
      for (int idx = threadIdx.x; idx < pl.HB * kStateRows * pl.XP;
           idx += kThreads) {
        const int hr = idx / pl.XP;    // head * kStateRows + row
        const int hd = hr / kStateRows;
        xs[(t & 1) * xstage + idx] *= w[hd * RW + t * kStateRows + hr -
                                         hd * kStateRows];
      }
      __syncthreads();
    }
    if (active) {
      const float* xt = xs + (t & 1) * xstage + hh * kStateRows * pl.XP +
                        TP * pu;
      const float* bt = bs + (t & 1) * bstage + 4 * nu;
      const float* wt = w + hh * RW + t * kStateRows;
#pragma unroll 4
      for (int j = 0; j < kStateRows; ++j) {
        float xv[TP];
        lds(xv, xt + j * pl.XP);
        if (!kScaled) {
          const float wj = wt[j];
#pragma unroll
          for (int e = 0; e < TP; ++e) xv[e] *= wj;
        }
#pragma unroll
        for (int f = 0; f < TNN / 4; ++f) {
          const float4 bv = *reinterpret_cast<const float4*>(
              bt + j * pl.NSTR + 4 * NU * f);
#pragma unroll
          for (int e = 0; e < TP; ++e) {
            acc[e][4 * f] += xv[e] * bv.x;
            acc[e][4 * f + 1] += xv[e] * bv.y;
            acc[e][4 * f + 2] += xv[e] * bv.z;
            acc[e][4 * f + 3] += xv[e] * bv.w;
          }
        }
      }
    }
  }
  if (active) {
    float* out = a.ws + ((long long)(q.b * a.H + q.h0 + hh) * pl.NG + gi) *
                            pl.PN4 + q.p0;
#pragma unroll
    for (int e = 0; e < TP; ++e) {
      const int p = TP * pu + e;
      if (p >= q.pw) continue;
#pragma unroll
      for (int f = 0; f < TNN; ++f) {
        const int nn = 4 * (nu + NU * (f >> 2)) + (f & 3);
        if (nn < a.N) out[nn * a.P + p] = acc[e][f];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3a. chunk <= 64: the group's chunks in order, the state in registers
template <typename T, int TN>
__global__ void __launch_bounds__(kThreads, 3)
    ssd_cc_chunk_out_small_kernel(Args a, Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = a.chunk;
  float* xs = reinterpret_cast<float*>(smem);           // [HB][64][XP]
  float* bs = xs + pl.HB * kTile * pl.XP;               // [64][NSTR]
  float* cs = bs + kTile * pl.NSTR;                     // [64][NSTR]
  double* G = reinterpret_cast<double*>(cs + kTile * pl.NSTR);  // [HB][64]
  float* dd = reinterpret_cast<float*>(G + pl.HB * kTile);       // [HB][64]
  float* ecum = dd + pl.HB * kTile;   // exp(cum_i), cum inside the chunk
  float* wv = ecum + pl.HB * kTile;   // dt_j exp(cum_last - cum_j)
  float* segc = wv + pl.HB * kTile;   // exp(cum_last) of each chunk
  // M^T [HB][R j][MP i]: row j holds M[i][j] of its chunk's rows i in
  // order, zero above the diagonal (i < j) and past the chunk
  const int MP = (c + kBatch - 1) / kBatch * kBatch;
  float* Ms = segc + pl.HB * kTile;

  const Place q = place_of(a, pl);
  const int gi = blockIdx.x;
  const int s0 = gi * pl.R;
  const int rows = min(pl.R, a.S - s0);
  const int kg = rows / c;
  const T* xg = static_cast<const T*>(a.x) + q.b * a.x_sb +
                (long long)s0 * a.x_ss + q.h0 * a.x_sh + q.p0;
  for (int hh = 0; hh < pl.HB; ++hh)
    load_tile(xs + hh * kTile * pl.XP, pl.XP, xg + hh * a.x_sh, a.x_ss,
              rows, pl.XP, hh < q.nh ? rows : 0, q.pw, pl.vx);
  load_tile(bs, pl.NSTR,
            static_cast<const T*>(a.B) + q.b * a.b_sb +
                (long long)s0 * a.b_ss + q.grp * a.b_sg,
            a.b_ss, rows, pl.NPAD, rows, a.N, pl.vb);
  load_tile(cs, pl.NSTR,
            static_cast<const T*>(a.C) + q.b * a.c_sb +
                (long long)s0 * a.c_ss + q.grp * a.c_sg,
            a.c_ss, rows, pl.NPAD, rows, a.N, pl.vc);
  cp_async_commit();

  const int warp = threadIdx.x >> 5;
  for (int hh = warp; hh < q.nh; hh += kThreads / 32) {
    const int h = q.h0 + hh;
    warp_cumsum(G + hh * kTile, dd + hh * kTile,
                a.dt + q.b * a.dt_sb + (long long)s0 * a.dt_ss + h * a.dt_sh,
                a.dt_ss, a.A[h], rows);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < q.nh * rows; idx += kThreads) {
    const int hh = idx / rows, r = idx - hh * rows;
    const double* g = G + hh * kTile;
    const int cs0 = r - r % c, ce = cs0 + c - 1;
    const double base = cs0 > 0 ? g[cs0 - 1] : 0.0;
    ecum[hh * kTile + r] = expf((float)(g[r] - base));
    wv[hh * kTile + r] = dd[hh * kTile + r] * expf((float)(g[ce] - g[r]));
    if (r == ce) segc[hh * kTile + r / c] = expf((float)(g[ce] - base));
  }
  cp_async_wait<0>();
  __syncthreads();

  // M[i][j] = (C_i.B_j) exp(G_i - G_j) dt_j for j <= i in one chunk,
  // masked before exp; C_i.B_j once for all heads of the block
  for (int idx = threadIdx.x; idx < rows * MP; idx += kThreads) {
    const int j = idx / MP, il = idx - j * MP, jl = j % c;
    const int r = j - jl + il;
    float cb = 0.f;
    if (il < c && jl <= il) {
      const float* cr = cs + r * pl.NSTR;
      const float* br = bs + j * pl.NSTR;
      for (int nn = 0; nn < pl.NPAD; nn += 4) {
        const float4 u = *reinterpret_cast<const float4*>(cr + nn);
        const float4 v = *reinterpret_cast<const float4*>(br + nn);
        cb += u.x * v.x;
        cb += u.y * v.y;
        cb += u.z * v.z;
        cb += u.w * v.w;
      }
    }
    for (int hh = 0; hh < pl.HB; ++hh) {
      const double* g = G + hh * kTile;
      Ms[(hh * pl.R + j) * MP + il] =
          (hh < q.nh && il < c && jl <= il)
              ? cb * expf((float)(g[r] - g[j])) * dd[hh * kTile + j]
              : 0.f;
    }
  }
  __syncthreads();

  // thread -> (head, p) pair, TN threads a pair; thread t of a pair holds
  // n = 4 (t + TN f) + i, f < 2
  const int t = threadIdx.x % TN, pair = threadIdx.x / TN;
  const int hh = min(pair / pl.PT, pl.HB - 1), pp = pair % pl.PT;
  const bool valid = pair / pl.PT < q.nh && pp < q.pw;
  float st[kNsp];
  {
    const float* hsrc = a.ws + ((long long)(q.b * a.H + q.h0 + hh) * pl.NG +
                                gi) * pl.PN4 + q.p0 + pp;
#pragma unroll
    for (int f = 0; f < kNsp; ++f) {
      const int nn = 4 * (t + TN * (f >> 2)) + (f & 3);
      st[f] = (gi > 0 && valid && nn < a.N) ? hsrc[nn * a.P] : 0.f;
    }
  }
  const float* xcol = xs + hh * kTile * pl.XP + pp;
  const float* crow = cs + 4 * t;
  const float* brow = bs + 4 * t;
  const int hr = hh * kTile;
  const long long y_ss = (long long)a.H * a.P;
  T* yb = static_cast<T*>(a.y) + ((long long)q.b * a.S + s0) * y_ss +
          (long long)(q.h0 + hh) * a.P + q.p0 + pp;
  for (int kk = 0; kk < kg; ++kk) {
    const int cs0 = kk * c;
    // rows in batches of kBatch: each thread's part of y_i (its n of the
    // entering-state term, its j = t, t + TN, ... of the intra-chunk
    // term), summed over the pair's TN threads by shuffles
    for (int b0 = 0; b0 < c; b0 += kBatch) {
      const int nb = min(kBatch, c - b0);
      float part[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        part[u] = 0.f;
        if (u < nb) {
          const int r = cs0 + b0 + u;
          const float* cr = crow + r * pl.NSTR;
          const float4 c0 = *reinterpret_cast<const float4*>(cr);
          const float4 c1 = *reinterpret_cast<const float4*>(cr + 4 * TN);
          part[u] = ecum[hr + r] *
                    ((c0.x * st[0] + c0.y * st[1] + c0.z * st[2] +
                      c0.w * st[3]) +
                     (c1.x * st[4] + c1.y * st[5] + c1.z * st[6] +
                      c1.w * st[7]));
        }
      }
      const float* mb = Ms + (hh * pl.R + cs0) * MP + b0;
      for (int jj = t; jj < b0 + nb; jj += TN) {
        const float xv = xcol[(cs0 + jj) * pl.XP];
        float mv[kBatch];
        lds(mv, mb + jj * MP);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) part[u] += mv[u] * xv;
      }
#pragma unroll
      for (int off = 1; off < TN; off <<= 1)
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          part[u] += __shfl_xor_sync(0xffffffffu, part[u], off);
      if (valid) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (u % TN == t && u < nb)
            store_from_f32(yb + (cs0 + b0 + u) * y_ss, part[u]);
      }
    }
    if (valid && kk + 1 < kg) {
      float U[kNsp];
#pragma unroll
      for (int f = 0; f < kNsp; ++f) U[f] = 0.f;
#pragma unroll 4
      for (int j = cs0; j < cs0 + c; ++j) {
        const float xw = xcol[j * pl.XP] * wv[hr + j];
        const float4 b0 = *reinterpret_cast<const float4*>(brow +
                                                           j * pl.NSTR);
        const float4 b1 = *reinterpret_cast<const float4*>(
            brow + j * pl.NSTR + 4 * TN);
        U[0] += xw * b0.x; U[1] += xw * b0.y;
        U[2] += xw * b0.z; U[3] += xw * b0.w;
        U[4] += xw * b1.x; U[5] += xw * b1.y;
        U[6] += xw * b1.z; U[7] += xw * b1.w;
      }
      const float sg = segc[hr + kk];
#pragma unroll
      for (int f = 0; f < kNsp; ++f)
        st[f] = __fadd_rn(__fmul_rn(sg, st[f]), U[f]);
    }
  }
}

// ---------------------------------------------------------------------------
// chunk > 64, first: C_i B_j^T for each pair of 64-row tiles j <= i of a
// chunk, once per (batch, B/C group, chunk) for all its heads, to `cb`
// ([pair][64 i][64 j], float32; rows past the chunk zero)
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
    ssd_cc_chunk_cb_kernel(Args a, Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* cs = reinterpret_cast<float*>(smem);     // [64][NSTR]
  float* bs = cs + kTile * pl.NSTR;               // [64][NSTR]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int pair = blockIdx.x;
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= pair) ++it;
  const int jt = pair - it * (it + 1) / 2;
  const int nc = a.S / a.chunk;
  const int ci = blockIdx.y % nc, grp = (blockIdx.y / nc) % a.G;
  const int b = blockIdx.y / (nc * a.G);
  const int c = a.chunk, s0 = ci * c;
  const int i0 = it * kTile, j0 = jt * kTile;
  load_tile(cs, pl.NSTR,
            static_cast<const T*>(a.C) + b * a.c_sb +
                (long long)(s0 + i0) * a.c_ss + grp * a.c_sg,
            a.c_ss, kTile, pl.NPAD, min(kTile, c - i0), a.N, pl.vc);
  load_tile(bs, pl.NSTR,
            static_cast<const T*>(a.B) + b * a.b_sb +
                (long long)(s0 + j0) * a.b_ss + grp * a.b_sg,
            a.b_ss, kTile, pl.NPAD, min(kTile, c - j0), a.N, pl.vb);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // rows i = 4 ty + r, columns j = tx + 16 u
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[r][u] = 0.f;
#pragma unroll 2
  for (int nn = 0; nn < pl.NPAD; nn += 4) {
    float4 cv[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      cv[r] = *reinterpret_cast<const float4*>(cs + (4 * ty + r) * pl.NSTR +
                                               nn);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      bv[u] = *reinterpret_cast<const float4*>(bs + (tx + 16 * u) * pl.NSTR +
                                               nn);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc[r][u] += cv[r].x * bv[u].x;
        acc[r][u] += cv[r].y * bv[u].y;
        acc[r][u] += cv[r].z * bv[u].z;
        acc[r][u] += cv[r].w * bv[u].w;
      }
  }
  const int pairs = gridDim.x;
  float* out = a.cb + ((long long)blockIdx.y * pairs + pair) * kTile * kTile;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      out[(4 * ty + r) * kTile + tx + 16 * u] = acc[r][u];
}

// 3b. chunk > 64: one 64-row tile i of a chunk, against the tiles j <= i,
// with C_i B_j^T from ssd_cc_chunk_cb_kernel
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
    ssd_cc_chunk_out_large_kernel(Args a, Plan pl) {
  // one build: p tiles of 64, 4 x 4 outputs a thread, whatever p is (no
  // configuration sends chunks above 64 rows, so nothing is tuned for them)
  constexpr int TQ = 4, PT = 16 * TQ;
  extern __shared__ __align__(16) unsigned char smem[];
  // the entering-state product first, then x_j (two buffers) and M^T
  // over the same bytes
  float* cs = reinterpret_cast<float*>(smem);     // [64][NSTR]
  float* Ht = cs + kTile * pl.NSTR;               // [NPAD][PT]
  float* xs = cs;                                 // [2][64][PT]
  float* Mt = xs + 2 * kTile * PT;                // [64 j][kMtPitch]
  const int big = max(kTile * pl.NSTR + pl.NPAD * PT,
                      2 * kTile * PT + kTile * kMtPitch);
  double* G = reinterpret_cast<double*>(cs + big);       // [256]
  float* dd = reinterpret_cast<float*>(G + kMaxChunk);   // [256]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5;
  const int bh = blockIdx.x / pl.NG, ci = blockIdx.x % pl.NG;
  const int b = bh / a.H, h = bh % a.H, grp = h / (a.H / a.G);
  const int it = gridDim.z - 1 - blockIdx.z;
  const int p0 = blockIdx.y * PT, pw = min(PT, a.P - p0);
  const int c = a.chunk, s0 = ci * c, i0 = it * kTile;
  const int need = min(c, i0 + kTile);
  const int ri = need - i0;
  const T* xg = static_cast<const T*>(a.x) + b * a.x_sb +
                (long long)s0 * a.x_ss + h * a.x_sh + p0;
  const int itiles = gridDim.z;
  const float* cbg = a.cb + ((long long)(b * a.G + grp) * pl.NG + ci) *
                                itiles * (itiles + 1) / 2 * kTile * kTile;

  load_tile(cs, pl.NSTR,
            static_cast<const T*>(a.C) + b * a.c_sb +
                (long long)(s0 + i0) * a.c_ss + grp * a.c_sg,
            a.c_ss, kTile, pl.NPAD, ri, a.N, pl.vc);
  load_tile(Ht, PT, a.ws + ((long long)bh * pl.NG + ci) * pl.PN4 + p0,
            (long long)a.P, pl.NPAD, PT, ci > 0 ? a.N : 0, pw, pl.vh);
  cp_async_commit();
  if (warp == 0)
    warp_cumsum(G, dd, a.dt + b * a.dt_sb + (long long)s0 * a.dt_ss +
                           h * a.dt_sh, a.dt_ss, a.A[h], need);
  cp_async_wait<0>();
  __syncthreads();

  // entering state: acc[r][e] = exp(G_i) sum_n C[i][n] H[n][p], rows
  // i = 4 ty + r, columns p = TQ tx + e
  float acc[4][TQ];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < TQ; ++e) acc[r][e] = 0.f;
  for (int nn = 0; nn < pl.NPAD; nn += 4) {
    float4 cv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      cv[r] = *reinterpret_cast<const float4*>(cs + (4 * ty + r) * pl.NSTR +
                                               nn);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float hv[TQ];
      lds(hv, Ht + (nn + k) * PT + TQ * tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float cr = k == 0 ? cv[r].x : k == 1 ? cv[r].y
                       : k == 2 ? cv[r].z : cv[r].w;
#pragma unroll
        for (int e = 0; e < TQ; ++e) acc[r][e] += cr * hv[e];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
    const float ec = i < need ? expf((float)G[i]) : 0.f;
#pragma unroll
    for (int e = 0; e < TQ; ++e) acc[r][e] *= ec;
  }
  __syncthreads();   // C_i and H are read; x_j and M^T go over them

  auto issue_x = [&](int jt) {
    load_tile(xs + (jt & 1) * kTile * PT, PT,
              xg + (long long)(jt * kTile) * a.x_ss, a.x_ss, kTile, PT,
              min(kTile, c - jt * kTile), pw, pl.vx);
    cp_async_commit();
  };
  // this thread's C B^T elements of a tile: rows 4 ty + r, columns
  // tx + 16 u
  auto load_cb = [&](int jt, float (&v)[4][4]) {
    const float* t = cbg + (it * (it + 1) / 2 + jt) * kTile * kTile;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[r][u] = t[(4 * ty + r) * kTile + tx + 16 * u];
  };
  issue_x(0);
  float cbn[4][4];
  load_cb(0, cbn);
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kTile;
    float cbv[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) cbv[r][u] = cbn[r][u];
    if (jt < it) load_cb(jt + 1, cbn);
    // M = C B^T o exp(G_i - G_j) o dt_j for j <= i, masked before exp;
    // stored as M^T [j][i]
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + tx + 16 * u;
      float m[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + 4 * ty + r;
        m[r] = (j <= i && i < need)
                   ? cbv[r][u] * expf((float)(G[i] - G[j])) * dd[j]
                   : 0.f;
      }
      *reinterpret_cast<float4*>(Mt + (tx + 16 * u) * kMtPitch + 4 * ty) =
          make_float4(m[0], m[1], m[2], m[3]);
    }
    cp_async_wait<0>();          // x_jt
    __syncthreads();
    if (jt < it) issue_x(jt + 1);
    // y += M x_j; on the diagonal tile a warp's rows 8 warp .. 8 warp + 7
    // take no j above them
    const float* xt = xs + (jt & 1) * kTile * PT + TQ * tx;
    const int jend = jt == it ? min(kTile, 8 * warp + 8) : kTile;
#pragma unroll 4
    for (int j = 0; j < jend; ++j) {
      const float4 mv = *reinterpret_cast<const float4*>(Mt + j * kMtPitch +
                                                         4 * ty);
      float xv[TQ];
      lds(xv, xt + j * PT);
#pragma unroll
      for (int e = 0; e < TQ; ++e) {
        acc[0][e] += mv.x * xv[e];
        acc[1][e] += mv.y * xv[e];
        acc[2][e] += mv.z * xv[e];
        acc[3][e] += mv.w * xv[e];
      }
    }
    __syncthreads();             // x_jt and M^T are read
  }

  const long long y_ss = (long long)a.H * a.P;
  T* yb = static_cast<T*>(a.y) + ((long long)b * a.S + s0 + i0) * y_ss +
          (long long)h * a.P + p0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = 4 * ty + r;
    if (i >= ri) continue;
#pragma unroll
    for (int e = 0; e < TQ; ++e) {
      const int p = TQ * tx + e;
      if (p < pw) store_from_f32(yb + i * y_ss + p, acc[r][e]);
    }
  }
}

// ---------------------------------------------------------------------------
// the shared-memory opt-in is per device and kernel: set once each
cudaError_t opt_in(const void* fn) {
  static const void* fns[32];
  static unsigned masks[32];
  static int count = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int slot = 0;
  while (slot < count && fns[slot] != fn) ++slot;
  if (slot == count && count < 32) {
    fns[count] = fn;
    masks[count++] = 0;
  }
  if (slot < count && dev < 32 && ((masks[slot] >> dev) & 1u))
    return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemCap);
  if (err == cudaSuccess && slot < count && dev < 32)
    masks[slot] |= 1u << dev;
  return err;
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// pitch of B and C rows: a whole number of float4, odd, so that neighbouring
// rows' float4 reads fall on different banks
int row_pitch(int npad) { return (npad / 4) % 2 ? npad : npad + 4; }

bool aligned(const void* p, int elem, long long s0, int n0, long long s1,
             int n1, long long s2, int n2) {
  auto ok = [](long long s, int n) { return n <= 1 || s % 4 == 0; };
  return (uintptr_t)p % (4 * elem) == 0 && ok(s0, n0) && ok(s1, n1) &&
         ok(s2, n2);
}

size_t state_smem(const Plan& pl) {
  const int RW = round_up(pl.R, kStateRows);
  const int stages = pl.R > kStateRows ? 2 : 1;
  return sizeof(float) * (size_t)stages *
             (pl.HB * kStateRows * pl.XP + kStateRows * pl.NSTR) +
         (size_t)pl.HB * RW * (sizeof(double) + 2 * sizeof(float));
}

size_t small_smem(const Plan& pl, int chunk) {
  return sizeof(float) * ((size_t)pl.HB * kTile * pl.XP +
                          2 * (size_t)kTile * pl.NSTR) +
         (size_t)pl.HB * kTile * (sizeof(double) + 4 * sizeof(float)) +
         sizeof(float) * (size_t)pl.HB * pl.R * round_up(chunk, kBatch);
}

size_t large_smem(const Plan& pl) {
  const size_t big = max(kTile * pl.NSTR + pl.NPAD * pl.PT,
                         2 * kTile * pl.PT + kTile * kMtPitch);
  return sizeof(float) * big + kMaxChunk * (sizeof(double) + sizeof(float));
}

constexpr size_t kSmemTarget = 113 * 1024;   // two blocks an SM

using Kernel = void (*)(Args, Plan);

// the kernel's shared-memory opt-in, its launch, and the launch's error
int start(Kernel kern, dim3 grid, size_t bytes, cudaStream_t st,
          const Args& a, const Plan& pl) {
  const cudaError_t err = opt_in((const void*)kern);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, bytes, st>>>(a, pl);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, int batch, cudaStream_t st) {
  const int c = a.chunk, hpg = a.H / a.G;
  const int k = c < kTile ? kTile / c : 1;
  const int elem = (int)sizeof(T);
  Plan base{};
  base.R = k * c;
  base.NG = (a.S / c + k - 1) / k;
  base.PN4 = round_up(a.P * a.N, 4);
  base.vx = aligned(a.x, elem, a.x_sb, batch, a.x_ss, a.S, a.x_sh, a.H);
  base.vb = aligned(a.B, elem, a.b_sb, batch, a.b_ss, a.S, a.b_sg, a.G);
  base.vc = aligned(a.C, elem, a.c_sb, batch, a.c_ss, a.S, a.c_sg, a.G);
  base.vh = a.P % 4 == 0;
  int err;

  // 1. chunk_state
  {
    Plan pl = base;
    const bool small = (a.P <= 32 && a.N <= 64) || a.N <= 32;
    const int TP = small ? 2 : 4, TNN = small ? 4 : 8;
    pl.PT = min(round_up(a.P, 4), kTile);
    pl.XP = pl.PT;
    pl.NPAD = round_up(a.N, TNN);
    pl.NSTR = row_pitch(pl.NPAD);
    const int units = (pl.PT / TP) * (pl.NPAD / TNN);
    pl.HB = max(1, min(hpg, kThreads / units));
    while (pl.HB > 1 && state_smem(pl) > kSmemTarget) --pl.HB;
    pl.HBLK = (hpg + pl.HB - 1) / pl.HB;
    const dim3 grid((unsigned)pl.NG, (unsigned)(batch * a.G * pl.HBLK),
                    (unsigned)((a.P + pl.PT - 1) / pl.PT));
    err = start(small ? ssd_cc_chunk_state_kernel<T, 2, 4>
                      : ssd_cc_chunk_state_kernel<T, 4, 8>,
                grid, state_smem(pl), st, a, pl);
    if (err != cudaSuccess) return err;
  }

  // 2. the state pass over groups
  {
    const long long quads = (long long)batch * a.H * base.PN4 / 4;
    ssd_state_pass_kernel<<<(unsigned)((quads + kPassThreads - 1) /
                                       kPassThreads),
                            kPassThreads, 0, st>>>(a.ws, a.seg, base.NG,
                                                   base.PN4, quads);
    if ((err = (int)cudaGetLastError()) != cudaSuccess) return err;
  }

  // 3. chunk_out
  if (c <= kTile) {
    Plan pl = base;
    pl.TN = max(2, pow2_at_least((a.N + kNsp - 1) / kNsp));
    pl.NPAD = kNsp * pl.TN;
    pl.NSTR = row_pitch(pl.NPAD);
    const int pairs = kThreads / pl.TN;
    pl.PT = min(min(a.P, kTile), pairs);
    if (pl.PT < a.P) pl.PT &= ~3;
    pl.XP = round_up(pl.PT, 4);
    pl.HB = max(1, min(hpg, pairs / pl.PT));
    while (pl.HB > 1 && small_smem(pl, c) > kSmemTarget) --pl.HB;
    pl.HBLK = (hpg + pl.HB - 1) / pl.HB;
    const dim3 grid((unsigned)pl.NG, (unsigned)(batch * a.G * pl.HBLK),
                    (unsigned)((a.P + pl.PT - 1) / pl.PT));
    const Kernel kern = pl.TN == 2   ? ssd_cc_chunk_out_small_kernel<T, 2>
                        : pl.TN == 4 ? ssd_cc_chunk_out_small_kernel<T, 4>
                        : pl.TN == 8 ? ssd_cc_chunk_out_small_kernel<T, 8>
                                     : ssd_cc_chunk_out_small_kernel<T, 16>;
    return start(kern, grid, small_smem(pl, c), st, a, pl);
  }
  Plan pl = base;
  pl.NPAD = round_up(a.N, 4);
  pl.NSTR = row_pitch(pl.NPAD);
  const int itiles = (c + kTile - 1) / kTile;
  const dim3 cgrid((unsigned)(itiles * (itiles + 1) / 2),
                   (unsigned)(batch * a.G * (a.S / c)));
  err = start(ssd_cc_chunk_cb_kernel<T>, cgrid,
              sizeof(float) * 2 * kTile * pl.NSTR, st, a, pl);
  if (err != cudaSuccess) return err;
  pl.PT = kTile;
  const dim3 grid((unsigned)(batch * a.H * pl.NG),
                  (unsigned)((a.P + pl.PT - 1) / pl.PT), (unsigned)itiles);
  return start(ssd_cc_chunk_out_large_kernel<T>, grid, large_smem(pl), st, a,
               pl);
}

}  // namespace

// x: [b, s, h, p] (unit p stride); dt: [b, s, h] float32; A: [h] float32;
// B, C: [b, s, g, n] (unit n stride); y: [b, s, h, p] contiguous, in x's
// dtype; ws: b*h*groups*round_up(p*n, 4) float32 and seg: b*h*groups
// float32, groups = ceil((s / chunk) / max(1, 64 / chunk)).  Needs
// s % chunk == 0, chunk <= 256, n <= 128, h % g == 0, which its launcher
// (kernels/ssd_scan.py) checks.
extern "C" int repro_ssd_scan(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, void* ws, void* seg, void* cb, int batch, int S,
    int H,
    int G, int P, int N, int chunk, long long x_sb, long long x_ss,
    long long x_sh, long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long b_sg, long long c_sb,
    long long c_ss, long long c_sg, int dtype, void* stream) {
  if (batch == 0 || S == 0 || H == 0 || P == 0) return (int)cudaGetLastError();
  const Args a{x, (const float*)dt, (const float*)A, B, C, y, (float*)ws,
               (float*)seg, (float*)cb, S, H, G, P, N, chunk,
               x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
               b_sb, b_ss, b_sg, c_sb, c_ss, c_sg};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kFloat32) return launch<float>(a, batch, st);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(a, batch, st);
  return (int)cudaErrorInvalidValue;
}
