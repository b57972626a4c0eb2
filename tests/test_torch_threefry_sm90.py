"""A CPU model of the Hopper dropout kernel ``csrc/threefry_dropout.cu``.

The kernel runs only on the card; what it computes differently from the
plain threefry is modelled here in numpy ``uint32`` and held against
``threefry.threefry2x32`` and ``jax.random.bits``:

* the unrolled hash of the 32-bit-counter kernel: the counter's high word
  0 folded into the first add (x0 = i + (s0 + s1), x1 = i + s1), the key
  injections hoisted into ``ka`` / ``kb`` (round numbers included) and
  fused into the next round's add, each rotation a funnel shift; and the
  variants of ``benchmarks/torch_threefry_pipes.py`` whose rounds rotate
  as the lo/hi pair of ``x * 2**r`` xored into x0;
* the rolled hash of the sample fold and the scalar head and tail (the key
  schedule rotated a group at a time, the key words recovered from the
  hoisted constants);
* the keep test as one integer compare, ``bits < ceil(p * 2**23) * 512``;
* the thread -> element map: 4 vectors of 16 bytes a thread, a warp's
  vectors contiguous, each sample's vectors from its first 16-byte
  boundary, the head and tail one element a thread of the sample's first
  tile; every index of every sample exactly once, at any base address.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro_torch.kernels import threefry as tf  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

U32 = np.uint32
ROT = [r for group in (tf.ROTATIONS * 3)[:5] for r in group]   # round r
THREADS, VECTORS = 256, 4


def sample_key(key, sid: int) -> dict:
    """Warp 0's fold of a sample id into the hoisted constants."""
    s0, s1 = tf.fold_in(key, sid)
    ks = (s0, s1, s0 ^ s1 ^ U32(tf.KS_PARITY))
    with np.errstate(over="ignore"):
        return {"c0": U32(s0 + s1), "c1": U32(s1),
                "ka": [ks[(g + 1) % 3] for g in range(5)],
                "kb": [U32(ks[(g + 2) % 3] + U32(g + 1)) for g in range(5)]}


def rotate_xor(x, x0, r: int, wide: bool):
    if wide:      # IMAD.WIDE.U32 x * 2**r: lo, hi, then lo ^ hi ^ x0
        w = x.astype(np.uint64) * np.uint64(1 << ROT[r])
        return (w & np.uint64(tf.MASK)).astype(U32) ^ \
            (w >> np.uint64(32)).astype(U32) ^ x0
    return ((x << U32(ROT[r])) | (x >> U32(32 - ROT[r]))) ^ x0


def hash_rounds(x0, x1, k: dict, wide_rounds: int):
    """The unrolled hash from x0 after round 0's add and x1 after its key
    addition, as ``hash_rounds<0>``."""
    with np.errstate(over="ignore"):
        for r in range(20):
            x1 = rotate_xor(x1, x0, r, bool(wide_rounds >> r & 1))
            if r == 19:
                return (x0 + k["ka"][4]) ^ (x1 + k["kb"][4])
            if (r + 1) % 4 == 0:
                g = (r + 1) // 4 - 1
                x1 = x1 + k["kb"][g]
                x0 = (x0 + k["ka"][g]) + x1
            else:
                x0 = x0 + x1


def narrow_bits(k: dict, i, wide_rounds: int):
    """The 32-bit-counter kernel's bits of indices i < 2**32: the vector's
    first index gives a0 = i + c0, a1 = i + c1, element e adds e."""
    i = np.asarray(i, U32)
    with np.errstate(over="ignore"):
        return hash_rounds(i + k["c0"], i + k["c1"], k, wide_rounds)


def rolled_threefry(k0, k1, x0, x1):
    """The rolled ``threefry2x32`` of the fold and the scalar path: the key
    schedule (ka, kb, kc) rotated one step a group."""
    k0, k1 = U32(k0), U32(k1)
    ka, kb, kc = k1, k0 ^ k1 ^ U32(tf.KS_PARITY), k0
    x0, x1 = np.asarray(x0, U32), np.asarray(x1, U32)
    with np.errstate(over="ignore"):
        x0, x1 = x0 + k0, x1 + k1
        for g in range(5):
            for j in range(4):
                x0 = x0 + x1
                x1 = rotate_xor(x1, x0, 4 * (g & 1) + j, False)
            x0 = x0 + ka
            x1 = x1 + kb + U32(g + 1)
            ka, kb, kc = kb, kc, ka
    return x0, x1


def scalar_bits(k: dict, i):
    """``scalar_bits``: the key words back from the constants."""
    i = np.asarray(i, np.uint64)
    with np.errstate(over="ignore"):
        y0, y1 = rolled_threefry(k["c0"] - k["c1"], k["c1"],
                                 (i >> np.uint64(32)).astype(U32),
                                 (i & np.uint64(tf.MASK)).astype(U32))
    return y0 ^ y1


def plain_bits(key, sid, i):
    s = tf.fold_in(key, sid)
    i = np.asarray(i, np.uint64)
    y0, y1 = tf.threefry2x32(s, (i >> np.uint64(32)).astype(U32),
                             (i & np.uint64(tf.MASK)).astype(U32))
    return y0 ^ y1


# rounds (bit r) rotating as a wide product: none in the kernel, the
# benchmark's variants
KERNEL_WIDE_ROUNDS = 0x00000
WIDE_CHOICES = [KERNEL_WIDE_ROUNDS, 0x11111, 0x55555, 0xFFFFF]


@pytest.mark.parametrize("wide_rounds", WIDE_CHOICES)
def test_unrolled_hash_equals_threefry_on_random_words(wide_rounds):
    rs = np.random.default_rng(wide_rounds)
    key = rs.integers(0, 2 ** 32, size=2, dtype=np.uint64).astype(U32)
    sid = int(rs.integers(0, 2 ** 31))
    i = rs.integers(0, 2 ** 32, size=100_000, dtype=np.uint64).astype(U32)
    k = sample_key(key, sid)
    want = plain_bits(key, sid, i)
    np.testing.assert_array_equal(narrow_bits(k, i, wide_rounds), want)
    np.testing.assert_array_equal(scalar_bits(k, i), want)


@pytest.mark.parametrize("key,count,want", chip_smoke.THREEFRY_KNOWN_ANSWERS)
def test_kernel_hash_forms_known_answers(key, count, want):
    """Both hash forms on whole counters: the unrolled one started from
    (hi + s0) + (lo + s1) and lo + s1, the rolled one as it stands."""
    y0, y1 = rolled_threefry(*key, [count[0]], [count[1]])
    assert (int(y0[0]), int(y1[0])) == want
    ks = (U32(key[0]), U32(key[1]), U32(key[0] ^ key[1] ^ tf.KS_PARITY))
    k = {"ka": [ks[(g + 1) % 3] for g in range(5)],
         "kb": [U32((int(ks[(g + 2) % 3]) + g + 1) & tf.MASK)
                for g in range(5)]}
    x1 = U32((count[1] + key[1]) & tf.MASK)
    x0 = U32((count[0] + key[0] + int(x1)) & tf.MASK)
    for wide_rounds in WIDE_CHOICES:
        bits = hash_rounds(np.array([x0]), np.array([x1]), k, wide_rounds)
        assert int(bits[0]) == want[0] ^ want[1]


@pytest.mark.parametrize("shape", [(4, 33), (7, 9, 3), (1000,)])
def test_kernel_bits_equal_jax_random_bits(shape):
    key = tf.fold_in(tf.key_from_seed(11), 2)
    n = int(np.prod(shape))
    for sid in (0, 77, 2 ** 31 - 1):
        jk = jax.random.fold_in(jax.random.wrap_key_data(
            np.asarray(key, U32)), np.int32(sid))
        want = np.asarray(jax.random.bits(jk, shape)).reshape(-1)
        k = sample_key(key, sid)
        np.testing.assert_array_equal(
            narrow_bits(k, np.arange(n), KERNEL_WIDE_ROUNDS), want)
        np.testing.assert_array_equal(scalar_bits(k, np.arange(n)), want)


def keep_threshold(p: float) -> int:
    """T of the C entry: ceil(p * 2**23) clamped to [0, 2**23]."""
    t = np.ceil(np.float64(np.float32(p)) * 2.0 ** 23)
    return int(min(max(t, 0.0), 2.0 ** 23)) if t == t else 0


@pytest.mark.parametrize("p", [*(tf.dropout_scalars(rate, torch.float32)[0]
                                 for rate in (0.1, 0.5, 0.9)),
                               0.0, 1.0, 1 - 2 ** -24, 2 ** -30])
def test_integer_keep_test_equals_the_float_compare(p):
    """u = bitcast((bits >> 9) | 1.0f) - 1 < p exactly when bits < T * 512
    (T = 2**23: every element kept), over every 23-bit mantissa."""
    m = np.arange(2 ** 23, dtype=U32)
    u = ((m | U32(0x3F800000)).view(np.float32) - np.float32(1.0))
    want = u < np.float32(p)
    T = keep_threshold(p)
    got = m < U32(T) if T < 2 ** 23 else np.ones_like(want)
    np.testing.assert_array_equal(got, want)
    bits = (m.astype(np.uint64) << np.uint64(9)) | np.uint64(511)
    assert ((bits < np.uint64(T << 9)) == want).all()


def element_map(n: int, B: int, phase: int, elt: int) -> list:
    """Per sample, every index the kernel's threads write, from the grid
    the C entry launches: x's base ``phase`` elements past a 16-byte
    boundary; vectors of W = 16 / elt elements from the sample's first
    boundary, vector ``tile * 1024 + v * 256 + t`` for v < 4; the head and
    tail one element a thread (t < head + tail) of tile 0."""
    W = 16 // elt
    per_tile = THREADS * VECTORS
    tiles = max(1, -(-(n // W) // per_tile))
    tile, v, t = np.meshgrid(np.arange(tiles), np.arange(VECTORS),
                             np.arange(THREADS), indexing="ij")
    vec = (tile * per_tile + v * THREADS + t).reshape(-1)
    out = []
    for b in range(B):
        start = phase + b * n                 # the sample's base, elements
        head = min((W - start % W) % W, n)
        nvec = (n - head) // W
        tail = head + nvec * W
        rest = head + (n - tail)
        assert rest < 2 * W <= THREADS
        mine = vec[vec < nvec]
        assert ((start + head + mine * W) % W == 0).all()   # 16-byte aligned
        idx = (head + mine[:, None] * W + np.arange(W)).reshape(-1)
        scalar = [s if s < head else tail + s - head for s in range(rest)]
        out.append(np.concatenate([idx, np.asarray(scalar, idx.dtype)]))
    return out


SIZES = sorted({*range(1, 65),
                *(int(np.prod(s[1:])) for s, _, _ in
                  chip_smoke.DROPOUT_CASES)})


@pytest.mark.parametrize("elt", [2, 4])
def test_element_map_covers_every_index_once(elt):
    for n in SIZES:
        for phase in range(0, 8) if n <= 64 else (0, 3):
            for b, idx in enumerate(element_map(n, 3 if n <= 64 else 1,
                                                phase % (16 // elt), elt)):
                counts = np.bincount(idx, minlength=n)
                assert len(counts) == n and (counts == 1).all(), \
                    (n, phase, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_same_phase_empty_lines_up_with_x(dtype):
    """The wrapper's output buffer sits at x's address modulo 16 bytes."""
    buf = torch.zeros(1000, dtype=dtype)
    for offset in range(8):
        x = buf[offset:offset + 3 * 97].view(3, 97)
        out = tf.same_phase_empty(x)
        assert out.shape == x.shape and out.dtype == dtype
        assert out.is_contiguous()
        assert out.data_ptr() % 16 == x.data_ptr() % 16
        assert out.untyped_storage().data_ptr() != \
            x.untyped_storage().data_ptr()
