// Content-addressed dropout for Hopper (sm_90a): the mask of each sample is
// jax.random.bernoulli's, bit for bit, and the scale the jitted reference's.
//
// Replaces no Pallas kernel: the reference computes dropout in XLA
// (repro/models/layers.py:dropout), which fuses the threefry draws, the
// compare and the scale into one loop.  This is that loop.  For x [B, n]
// (n = the elements of one sample), sample b, flat index i < n:
//   key_b   = threefry2x32(key, (0, sample_ids[b]))         (fold_in)
//   bits    = y0 ^ y1 of threefry2x32(key_b, (i >> 32, i & 0xFFFFFFFF))
//   u       = bitcast_f32((bits >> 9) | 0x3F800000) - 1.0f
//   out[b,i] = u < p ? round(fl32(x[b,i]) * r) : 0
// with p = fl32(1 - rate) and r the float32 reciprocal the reference
// multiplies by (kernels/threefry.py:dropout_scalars).  The backward is the
// same function of the cotangent, so the mask is regenerated from the keys,
// never stored.  u = (bits >> 9) / 2**23 exactly, so u < p is the integer
// test bits < T * 512 with T = ceil(p * 2**23) clamped to [0, 2**23],
// computed on the host (repro_threefry_dropout); T = 2**23 keeps every
// element.
//
// Bound on this card: integer operations.  A threefry2x32 hash is 20 rounds
// of add, rotate, xor plus 12 key additions: 72 32-bit integer operations,
// 3 more make the uniform's bits; 75 an element against 4 bytes moved an
// element in bf16.  An SM issues one warp instruction a clock in each of
// its 4 schedulers (128 lanes), and integer work goes to two pipes of 64
// lanes each: the ALU pipe (LOP3, SHF, IADD3, ISETP, FSEL) and the
// multiply-add pipe (IMAD and its forms).  At 132 SMs, ~1.98 GHz that is
// ~0.038 ms for [1, 4096, 4096], ~1.9x the ~0.020 ms its bytes take at
// 3.35 TB/s.  The rotations and xors need the ALU pipe (a funnel shift
// SHF and a LOP3 a round), so the kernel's pace is set by how little else
// goes there.
//
// Design:
// - One block covers a tile of one sample: 256 threads x 4 vectors of 16
//   bytes (32 bf16 or 16 float32 elements a thread), a warp's vectors
//   contiguous (LDG.E.128 / STG.E.128).  Warp 0 folds the sample id into
//   the sample's key and its hoisted injection constants in shared memory
//   while every warp's loads are in flight; the block reads them after one
//   barrier: one fold a block, not one a thread.
// - A sample's first vector starts at its first 16-byte boundary; the
//   elements before it (the head, when x + b*n is not 16-byte aligned) and
//   after its last whole vector (the tail) are < 16 and go through a scalar
//   path in the sample's first tile.  The wrapper gives out the same
//   address phase as x, so one boundary serves both.
// - Where n <= 2**32 (kNarrow) every counter's high word is 0: the first
//   word's key addition and the first round's add fold into one add of a
//   per-vector constant, and indices are 32-bit.  Larger n takes the
//   64-bit counter.
// - The adds go to the multiply-add pipe: mad.lo.u32 by a multiplier of 1
//   that the compiler cannot see (a kernel parameter), so ptxas cannot
//   turn them back into IADD3.  A rotation is one funnel shift (SHF), its
//   xor one LOP3: 41 ALU-pipe instructions a hash.  Building rotations on
//   the multiply-add pipe as the lo/hi pair of x * 2**r (IMAD.WIDE.U32)
//   moves ALU work off, but the wide product issues at a lower rate and
//   every such build was slower on the card
//   (benchmarks/torch_threefry_pipes.py).
// - The keep test is one unsigned compare of the bits, the scale __fmul_rn
//   (no contraction) rounded to nearest even into bf16 (two a F2FP).
#include "common.cuh"

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kVectors = 4;               // 16-byte vectors a thread
constexpr unsigned kParity = 0x1BD11BDAu;

// the rotation of round r: (13, 15, 26, 6) in even groups of four rounds,
// (17, 29, 16, 24) in odd ones
__host__ __device__ constexpr int rot_amount(int r) {
  return (r & 4) ? ((r & 3) == 0 ? 17 : (r & 3) == 1 ? 29
                    : (r & 3) == 2 ? 16 : 24)
                 : ((r & 3) == 0 ? 13 : (r & 3) == 1 ? 15
                    : (r & 3) == 2 ? 26 : 6);
}

// the sample's key and the constants its hashes add: c0 = s0 + s1 (the
// counter's x0 after its key addition and round 0's add, less the index),
// c1 = s1, and the injections after rounds 3, 7, 11, 15 and 19: ka[g] on
// the first word, kb[g] (round number included) on the second
struct SampleKey {
  unsigned c0, c1, ka[5], kb[5];
};
constexpr int kSampleKeyWords = 12;

// a + b on the multiply-add pipe (one is 1)
__device__ __forceinline__ unsigned add_mad(unsigned a, unsigned b,
                                            unsigned one) {
  unsigned d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(one), "r"(b));
  return d;
}

// rounds r..19 of the hash, from x0 after round r's add; the 32 bits
template <int r>
__device__ __forceinline__ unsigned hash_rounds(unsigned x0, unsigned x1,
                                                const SampleKey& k,
                                                unsigned one) {
  x1 = __funnelshift_l(x1, x1, rot_amount(r)) ^ x0;
  if constexpr (r == 19) {
    return add_mad(x0, k.ka[4], one) ^ add_mad(x1, k.kb[4], one);
  } else if constexpr ((r + 1) % 4 == 0) {
    constexpr int g = (r + 1) / 4 - 1;
    x1 = add_mad(x1, k.kb[g], one);
    x0 = add_mad(add_mad(x0, k.ka[g], one), x1, one);
    return hash_rounds<r + 1>(x0, x1, k, one);
  } else {
    return hash_rounds<r + 1>(add_mad(x0, x1, one), x1, k, one);
  }
}

// threefry2x32 of (x0, x1) under (k0, k1), plain and rolled: the fold of a
// sample id (once a block) and the scalar head, tail and 64-bit counters
__device__ __forceinline__ void threefry2x32(unsigned k0, unsigned k1,
                                             unsigned& x0, unsigned& x1) {
  // ks[(g + 1) % 3], ks[(g + 2) % 3], ks[g % 3] of group g
  unsigned ka = k1, kb = k0 ^ k1 ^ kParity, kc = k0;
  x0 += k0;
  x1 += k1;
#pragma unroll 1
  for (unsigned g = 0; g < 5; ++g) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, (g & 1) ? rot_amount(4 + j)
                                           : rot_amount(j)) ^ x0;
    }
    x0 += ka;
    x1 += kb + g + 1;
    const unsigned t = ka;
    ka = kb;
    kb = kc;
    kc = t;
  }
}

// the 32 random bits of index i under the sample key, rolled
__device__ __forceinline__ unsigned scalar_bits(unsigned long long i,
                                                const SampleKey& k) {
  // the key's words back from the constants: s1 = c1, s0 = c0 - c1
  unsigned x0 = (unsigned)(i >> 32), x1 = (unsigned)i;
  threefry2x32(k.c0 - k.c1, k.c1, x0, x1);
  return x0 ^ x1;
}

// keep ? round(fl32(v) * r) : 0
__device__ __forceinline__ float scale_kept(float v, bool keep, float r) {
  return keep ? __fmul_rn(v, r) : 0.0f;
}

template <typename T>
constexpr int kVecElems = 16 / sizeof(T);

// one 16-byte vector of elements e = 0.. (float32: one a word; bf16: two a
// word, the lower index in the low half); bits_of(e) gives element e's bits
template <typename T, typename Bits>
__device__ __forceinline__ uint4 dropout_vector(uint4 in, Bits bits_of,
                                                unsigned thr, bool keep_all,
                                                float r) {
  unsigned w[4] = {in.x, in.y, in.z, in.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (std::is_same<T, float>::value) {
      const bool keep = (bits_of(j) < thr) | keep_all;
      w[j] = __float_as_uint(scale_kept(__uint_as_float(w[j]), keep, r));
    } else {
      const bool keep_lo = (bits_of(2 * j) < thr) | keep_all;
      const bool keep_hi = (bits_of(2 * j + 1) < thr) | keep_all;
      const __nv_bfloat162 packed = __floats2bfloat162_rn(
          scale_kept(__uint_as_float(w[j] << 16), keep_lo, r),
          scale_kept(__uint_as_float(w[j] & 0xFFFF0000u), keep_hi, r));
      w[j] = *reinterpret_cast<const unsigned*>(&packed);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, bool kNarrow>
__global__ void __launch_bounds__(kThreads)
threefry_dropout_kernel(const T* __restrict__ x, T* __restrict__ out,
                        const int* __restrict__ sample_ids, long long n,
                        unsigned tiles_per_sample, unsigned key0,
                        unsigned key1, unsigned thr, bool keep_all, float r,
                        unsigned one) {
  using Index = typename std::conditional<kNarrow, unsigned,
                                          unsigned long long>::type;
  constexpr int kW = kVecElems<T>;
  constexpr Index kPerTile = (Index)kThreads * kVectors;
  __shared__ unsigned skey[kSampleKeyWords];
  const unsigned b = blockIdx.x / tiles_per_sample;
  const Index tile = blockIdx.x - b * tiles_per_sample;
  const T* xb = x + (long long)b * n;
  T* ob = out + (long long)b * n;
  // elements before the sample's first 16-byte boundary
  const unsigned head = (unsigned)min(
      (long long)(((16u - ((unsigned)(uintptr_t)xb & 15u)) & 15u)
                  / sizeof(T)),
      n);
  const Index nvec = (Index)((n - head) / kW);
  const uint4* xv = reinterpret_cast<const uint4*>(xb + head);
  uint4* ov = reinterpret_cast<uint4*>(ob + head);
  int sid = 0;
  if (threadIdx.x < 32) sid = sample_ids[b];
  uint4 in[kVectors];
#pragma unroll
  for (int v = 0; v < kVectors; ++v) {
    const Index vec = tile * kPerTile + v * kThreads + threadIdx.x;
    if (vec < nvec) in[v] = xv[vec];
  }
  // fold_in(key, sample id), in warp 0 while the loads are in flight
  if (threadIdx.x < 32) {
    unsigned s0 = 0u, s1 = (unsigned)sid;
    threefry2x32(key0, key1, s0, s1);
    const unsigned ks[3] = {s0, s1, s0 ^ s1 ^ kParity};
    if (threadIdx.x == 0) {
      skey[0] = s0 + s1;
      skey[1] = s1;
#pragma unroll
      for (int g = 0; g < 5; ++g) {
        skey[2 + g] = ks[(g + 1) % 3];
        skey[7 + g] = ks[(g + 2) % 3] + (unsigned)(g + 1);
      }
    }
  }
  __syncthreads();
  SampleKey k;
  k.c0 = skey[0];
  k.c1 = skey[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
    k.ka[g] = skey[2 + g];
    k.kb[g] = skey[7 + g];
  }
#pragma unroll
  for (int v = 0; v < kVectors; ++v) {
    const Index vec = tile * kPerTile + v * kThreads + threadIdx.x;
    if (vec < nvec) {
      const Index i = head + vec * kW;      // the vector's first index
      uint4 res;
      if constexpr (kNarrow) {
        const unsigned a0 = i + k.c0, a1 = i + k.c1;
        res = dropout_vector<T>(
            in[v],
            [&](int e) {
              return hash_rounds<0>(e ? add_mad(a0, e, one) : a0,
                                    e ? add_mad(a1, e, one) : a1, k, one);
            },
            thr, keep_all, r);
      } else {
        res = dropout_vector<T>(
            in[v], [&](int e) { return scalar_bits(i + e, k); }, thr,
            keep_all, r);
      }
      ov[vec] = res;
    }
  }
  // the head and the tail, < 2 * kW elements, one a thread of tile 0
  const unsigned long long tail = head + (unsigned long long)nvec * kW;
  const unsigned rest = head + (unsigned)(n - tail);
  if (tile == 0 && threadIdx.x < rest) {
    const unsigned long long i =
        threadIdx.x < head ? threadIdx.x : tail + (threadIdx.x - head);
    const unsigned bits = scalar_bits(i, k);
    store_from_f32(ob + i,
                   scale_kept(load_f32(xb + i), (bits < thr) | keep_all, r));
  }
}

template <typename T, bool kNarrow>
void launch(const void* x, void* out, const void* sample_ids, long long n,
            unsigned tiles, dim3 grid, unsigned key0, unsigned key1,
            unsigned thr, bool keep_all, float r, cudaStream_t s) {
  threefry_dropout_kernel<T, kNarrow><<<grid, kThreads, 0, s>>>(
      (const T*)x, (T*)out, (const int*)sample_ids, n, tiles, key0, key1,
      thr, keep_all, r, 1u);
}

}  // namespace

extern "C" int repro_threefry_dropout(const void* x, void* out,
                                      const void* sample_ids, long long B,
                                      long long n, unsigned key0,
                                      unsigned key1, float p, float r,
                                      int dtype, void* stream) {
  if (B == 0 || n == 0) return (int)cudaGetLastError();
  if (dtype != kFloat32 && dtype != kBFloat16)
    return (int)cudaErrorInvalidValue;
  const long long elt = dtype == kFloat32 ? 4 : 2;
  // one 16-byte boundary serves x and out only at the same address phase
  if ((((uintptr_t)x ^ (uintptr_t)out) & 15u) != 0 || (uintptr_t)x % elt)
    return (int)cudaErrorMisalignedAddress;
  // tiles of a sample: its whole vectors (at most n / vector elements) over
  // the vectors of a tile, and one at least for the scalar head and tail
  const long long vecs_per_tile = (long long)kThreads * kVectors;
  const long long tiles = std::max(
      1LL, (n / (16 / elt) + vecs_per_tile - 1) / vecs_per_tile);
  const long long blocks = B * tiles;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  // u < p  <=>  (bits >> 9) < T = ceil(p * 2**23), T in [0, 2**23]
  const double t = std::ceil((double)p * 8388608.0);
  const unsigned long long T =
      t >= 8388608.0 ? 8388608ull : (t > 0.0 ? (unsigned long long)t : 0ull);
  const bool keep_all = T == 8388608ull;
  const unsigned thr = keep_all ? 0u : (unsigned)(T << 9);
  const dim3 grid((unsigned)blocks);
  cudaStream_t s = (cudaStream_t)stream;
  const bool narrow = n <= (1LL << 32);
  if (dtype == kFloat32) {
    if (narrow)
      launch<float, true>(x, out, sample_ids, n, (unsigned)tiles, grid, key0,
                          key1, thr, keep_all, r, s);
    else
      launch<float, false>(x, out, sample_ids, n, (unsigned)tiles, grid,
                           key0, key1, thr, keep_all, r, s);
  } else {
    if (narrow)
      launch<__nv_bfloat16, true>(x, out, sample_ids, n, (unsigned)tiles,
                                  grid, key0, key1, thr, keep_all, r, s);
    else
      launch<__nv_bfloat16, false>(x, out, sample_ids, n, (unsigned)tiles,
                                   grid, key0, key1, thr, keep_all, r, s);
  }
  return (int)cudaGetLastError();
}
