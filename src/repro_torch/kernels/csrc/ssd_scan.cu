// Mamba2 SSD chunk scan (forward, from a zero state) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:ssd_scan_kernel (body
// _ssd_kernel), together with the group-to-head broadcast its wrapper
// repro/kernels/ops.py:ssd_scan does around it.  For each (batch, head) it
// walks the chunks in order and computes, with cum = cumsum(dt * A) inside
// the chunk:
//   y_intra = ((C B^T) o exp(cum_i - cum_j)[i >= j]) (x dt)
//   y_inter = (C state^T) exp(cum)
//   state   = exp(cum_last) state + (x dt exp(cum_last - cum))^T B
// in float32, with y cast to x's dtype.
//
// Bound on this card: operations.  The scan is causal, so only the c(c+1)/2
// pairs i >= j of a chunk count, as flash attention counts its causal
// pairs: each (chunk, head) costs c(c+1)(n + p) flops for C B^T and M x,
// plus 4 c p n for the entering-state term and the state update.  At the
// main path's [1, 4096, 80, 64] with n = 128, c = 256 that is 26.9 GFLOP,
// ~0.027 ms at the 989 TFLOP/s of bf16 tensor cores.  The compulsory bytes
// (x, B, C, dt read once, y written once) are ~87 MB with x, B and C as
// strided views of one [1, 4096, 5376] bf16 tensor, ~0.026 ms at 3.35 TB/s.
// This first version runs its products as float32 FMAs on the CUDA cores
// (67 TFLOP/s peak), skipping the masked upper triangle tile by tile, so it
// sits well above that bound; wgmma tiles are later work.
//
// Design: one 256-thread block per (batch*head, 64-wide p tile); the loop
// over chunks inside the block takes the place of the TPU grid's
// sequential chunk axis, and the [n, p] float32 state (32 KB) stays in
// shared memory across it.  A chunk is cut into 64-row tiles, as flash
// attention cuts a sequence: for each row tile i, C_i stays in shared
// memory while the tiles j <= i of B and x stream through; each thread
// owns a 4 x 4 block of every 64 x 64 product.  B and C are read through
// their strides at group h / (H / G), and x as the strided view it is: no
// broadcast or contiguous copies.  Shared arrays are stored transposed with
// a row stride of 65 floats, which keeps the stores and the reads of the
// inner loops to at most two-way bank conflicts.  Masking happens before exp: only
// i >= j is exponentiated (the upper triangle is positive and overflows).
//
// Precision: cum is accumulated in double.  With dt ~ 1 and |A| up to 16
// the float32 cumsum reaches ~-3e3 late in a 256-row chunk, and
// cum_i - cum_j of two such sums keeps only ~1e-4 relative precision,
// which puts exp(cum_i - cum_j) outside the ssd_scan tier against the
// sequential oracle.  Each dA = dt * A is still formed in float32, as the
// reference forms it; only the running sums and their differences are
// double, and each difference is rounded to float32 before expf.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;        // rows of a chunk tile; width of a p tile
constexpr int kMaxChunk = 256;   // one cumsum element per thread
constexpr int kMaxState = 128;   // n
constexpr int kStride = kTile + 1;
static_assert(kThreads == kMaxChunk, "the cumsum maps one row per thread");

struct SsdArgs {
  const void* x;      // [b, s, h, p], unit p stride
  const float* dt;    // [b, s, h]
  const float* A;     // [h]
  const void* B;      // [b, s, g, n], unit n stride
  const void* C;      // [b, s, g, n], unit n stride
  void* y;            // [b, s, h, p] contiguous
  int S, H, G, P, N, chunk;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg, c_sb, c_ss, c_sg;
};

constexpr size_t kSmemBytes =
    kMaxChunk * sizeof(double) + 3 * kMaxChunk * sizeof(float) +
    (3 * kMaxState + 2 * kTile) * kStride * sizeof(float);

// 64 rows of a [rows, n] operand (row stride ss) into dst[n][row], zeros
// past `rows`
template <typename T>
__device__ __forceinline__ void load_rows_t(float (*dst)[kStride],
                                            const T* src, long long ss,
                                            int rows, int N) {
  for (int idx = threadIdx.x; idx < kTile * N; idx += kThreads) {
    const int r = idx / N, k = idx % N;
    dst[k][r] = r < rows ? load_f32(src + (long long)r * ss + k) : 0.f;
  }
}

// 64 rows of x [rows, p] (row stride ss) into xs[row][p], zeros past `rows`
// and past the tile's width pw
template <typename T>
__device__ __forceinline__ void load_x(float (*xs)[kStride], const T* src,
                                       long long ss, int rows, int pw) {
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
    const int r = idx / kTile, p = idx % kTile;
    xs[r][p] = (r < rows && p < pw) ? load_f32(src + (long long)r * ss + p)
                                    : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_kernel(SsdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* cum = reinterpret_cast<double*>(smem);
  float* dts = reinterpret_cast<float*>(cum + kMaxChunk);
  float* ecum = dts + kMaxChunk;   // exp(cum_i)
  float* wdec = ecum + kMaxChunk;  // dt_j exp(cum_last - cum_j)
  auto Ct = reinterpret_cast<float(*)[kStride]>(wdec + kMaxChunk);  // [n][i]
  auto Bt = Ct + kMaxState;                                         // [n][j]
  auto stT = Bt + kMaxState;                                        // [n][p]
  auto xs = stT + kMaxState;                                        // [j][p]
  auto Mt = xs + kTile;                                             // [j][i]
  __shared__ double warp_tot[kThreads / 32];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int grp = h / (a.H / a.G);
  const int p0 = blockIdx.y * kTile, pw = min(kTile, a.P - p0);
  const int N = a.N, c = a.chunk, ntiles = (c + kTile - 1) / kTile;
  const float Ah = a.A[h];
  const T* xb = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh + p0;
  const float* dtb = a.dt + b * a.dt_sb + h * a.dt_sh;
  const T* Bb = static_cast<const T*>(a.B) + b * a.b_sb + grp * a.b_sg;
  const T* Cb = static_cast<const T*>(a.C) + b * a.c_sb + grp * a.c_sg;
  const long long y_ss = (long long)a.H * a.P;
  T* yb = static_cast<T*>(a.y) + (long long)b * a.S * y_ss +
          (long long)h * a.P + p0;

  for (int idx = tid; idx < kMaxState * kStride; idx += kThreads)
    (&stT[0][0])[idx] = 0.f;

  for (int s0 = 0; s0 < a.S; s0 += c) {
    // ---- dt and the within-chunk cumulative decay (double sums) ----
    __syncthreads();
    const float d = tid < c ? dtb[(long long)(s0 + tid) * a.dt_ss] : 0.f;
    dts[tid] = d;
    double v = (double)(d * Ah);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    for (int w = 0; w < warp; ++w) v += warp_tot[w];
    cum[tid] = v;
    __syncthreads();
    const double cum_last = cum[c - 1];
    ecum[tid] = tid < c ? expf((float)v) : 0.f;
    wdec[tid] = tid < c ? d * expf((float)(cum_last - v)) : 0.f;
    const float seg = expf((float)cum_last);
    const T* xc = xb + (long long)s0 * a.x_ss;
    const T* Bc = Bb + (long long)s0 * a.b_ss;
    const T* Cc = Cb + (long long)s0 * a.c_ss;

    for (int it = 0; it < ntiles; ++it) {
      const int i0 = it * kTile;
      __syncthreads();
      load_rows_t(Ct, Cc + (long long)i0 * a.c_ss, a.c_ss, c - i0, N);
      __syncthreads();

      // entering-state term: acc[i][p] = exp(cum_i) sum_n C[i,n] state[p,n]
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
#pragma unroll 4
      for (int k = 0; k < N; ++k) {
        float cv[4], sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Ct[k][ty + 16 * r];
#pragma unroll
        for (int q = 0; q < 4; ++q) sv[q] = stT[k][tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] += cv[r] * sv[q];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = ecum[i0 + ty + 16 * r];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] *= e;
      }

      // intra-chunk term over the tiles j <= i
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile;
        __syncthreads();
        load_rows_t(Bt, Bc + (long long)j0 * a.b_ss, a.b_ss, c - j0, N);
        load_x(xs, xc + (long long)j0 * a.x_ss, a.x_ss, c - j0, pw);
        __syncthreads();
        float cb[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) cb[r][q] = 0.f;
#pragma unroll 4
        for (int k = 0; k < N; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = Ct[k][ty + 16 * r];
#pragma unroll
          for (int q = 0; q < 4; ++q) bv[q] = Bt[k][tx + 16 * q];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) cb[r][q] += cv[r] * bv[q];
        }
        // M[i][j] = CB * exp(cum_i - cum_j) * dt_j for i >= j, else 0.
        // Rows and columns past the chunk hold zeros of B, C and dt.
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int gi = i0 + ty + 16 * r;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int gj = j0 + tx + 16 * q;
            float m = 0.f;
            if (gi >= gj)
              m = cb[r][q] * expf((float)(cum[gi] - cum[gj])) * dts[gj];
            Mt[tx + 16 * q][ty + 16 * r] = m;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int j = 0; j < kTile; ++j) {
          float mv[4], xv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) mv[r] = Mt[j][ty + 16 * r];
#pragma unroll
          for (int q = 0; q < 4; ++q) xv[q] = xs[j][tx + 16 * q];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] += mv[r] * xv[q];
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int gi = i0 + ty + 16 * r;
        if (gi >= c) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = tx + 16 * q;
          if (p < pw) store_from_f32(yb + (long long)(s0 + gi) * y_ss + p,
                                     acc[r][q]);
        }
      }
    }

    // ---- carried state: exp(cum_last) state + sum_j x_j wdec_j B_j ----
    // each thread owns n = tx + 16 a (a < 8) and p = ty + 16 e (e < 4)
    float ns[8][4];
#pragma unroll
    for (int a8 = 0; a8 < 8; ++a8)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ns[a8][e] = seg * stT[tx + 16 * a8][ty + 16 * e];
    for (int jt = 0; jt < ntiles; ++jt) {
      const int j0 = jt * kTile;
      __syncthreads();
      load_rows_t(Bt, Bc + (long long)j0 * a.b_ss, a.b_ss, c - j0, N);
      load_x(xs, xc + (long long)j0 * a.x_ss, a.x_ss, c - j0, pw);
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kTile; ++j) {
        const float w = wdec[j0 + j];
        float xv[4], bv[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) xv[e] = xs[j][ty + 16 * e] * w;
#pragma unroll
        for (int a8 = 0; a8 < 8; ++a8) bv[a8] = Bt[tx + 16 * a8][j];
#pragma unroll
        for (int a8 = 0; a8 < 8; ++a8)
#pragma unroll
          for (int e = 0; e < 4; ++e) ns[a8][e] += xv[e] * bv[a8];
      }
    }
    // every read of the old state (own entries above, and the y_inter
    // reads, which ended before the last barrier) is done
#pragma unroll
    for (int a8 = 0; a8 < 8; ++a8)
#pragma unroll
      for (int e = 0; e < 4; ++e) stT[tx + 16 * a8][ty + 16 * e] = ns[a8][e];
  }
}

template <typename T>
int launch(const SsdArgs& a, int batch, cudaStream_t st) {
  // the shared-memory opt-in is per device; set it on a device's first call
  static unsigned set_on = 0;  // bit d: done for device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32 || !(set_on & (1u << dev))) {
    err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) set_on |= 1u << dev;
  }
  const dim3 grid((unsigned)(batch * a.H), (unsigned)((a.P + kTile - 1) / kTile));
  ssd_scan_kernel<T><<<grid, kThreads, kSmemBytes, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [b, s, h, p] (unit p stride); dt: [b, s, h] float32; A: [h] float32;
// B, C: [b, s, g, n] (unit n stride); y: [b, s, h, p] contiguous, in x's
// dtype.  Needs s % chunk == 0, chunk <= 256, n <= 128, h % g == 0, which
// its launcher (kernels/ssd_scan.py) checks.
extern "C" int repro_ssd_scan(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, int batch, int S, int H, int G, int P, int N,
    int chunk, long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh, long long b_sb,
    long long b_ss, long long b_sg, long long c_sb, long long c_ss,
    long long c_sg, int dtype, void* stream) {
  if (batch == 0 || S == 0 || H == 0 || P == 0) return (int)cudaGetLastError();
  const SsdArgs a{x, (const float*)dt, (const float*)A, B, C, y,
                  S, H, G, P, N, chunk,
                  x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
                  b_sb, b_ss, b_sg, c_sb, c_ss, c_sg};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kFloat32) return launch<float>(a, batch, st);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(a, batch, st);
  return (int)cudaErrorInvalidValue;
}
