"""Content-addressed threefry2x32: the host key chain, and the launcher of
the dropout kernel ``csrc/threefry_dropout.cu``.

The reference draws every random bit with ``jax.random`` under its default
threefry2x32 implementation, partitionable counter layout
(``jax_threefry_partitionable``), 32-bit mode:

* ``key(seed)`` is the pair ``(0, seed mod 2**32)``;
* ``fold_in(key, d)`` is ``threefry2x32(key, (0, d mod 2**32))``, whose two
  output words are the new key;
* the 32 random bits of the element at flat index ``i`` of a draw are
  ``y0 ^ y1`` of ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``;
* ``bernoulli(key, p, shape)`` keeps an element when
  ``bitcast_f32((bits >> 9) | 0x3F800000) - 1 < fl32(p)``.

Keys are derived on the host, in numpy ``uint32`` (a few hashes a sample,
no device sync); only the last fold, of each sample id, and the draws run
on the card.  The plain torch version of the draws is ``ref.random_bits``
/ ``ref.bernoulli_keep`` / ``ref.dropout_reference``.

The dropout scale is not ``x / (1 - rate)`` as torch computes it: inside
``jit`` XLA turns the reference's division by the constant into a product
with its float32 reciprocal, and in bf16 the divisor is first rounded to
bf16 (a weakly typed Python scalar).  :func:`dropout_scalars` gives both
constants.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import _build

MASK = 0xFFFFFFFF
#: rotation amounts of the two alternating groups of four rounds
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: the key schedule's parity constant (Threefish's C240)
KS_PARITY = 0x1BD11BDA


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds of the counter words ``(x0, x1)``
    (broadcast numpy ``uint32`` arrays) under ``key`` = ``(k0, k1)``."""
    k0, k1 = (np.uint32(int(k) & MASK) for k in key)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(KS_PARITY))
    x0 = np.asarray(x0, np.uint32)
    x1 = np.asarray(x1, np.uint32)
    with np.errstate(over="ignore"):
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for i in range(5):
            for r in ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key_from_seed(seed: int) -> np.ndarray:
    """``jax.random.key_data(jax.random.key(seed))`` in 32-bit mode: the
    seed is taken mod 2**32, beside a zero high word."""
    return np.array([0, int(seed) & MASK], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in`` on key data: a new ``uint32[2]`` key."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & MASK], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def dropout_scalars(rate: float, dtype: torch.dtype) -> Tuple[float, float]:
    """``(p, r)`` of dropout at ``rate`` on ``dtype`` activations, as the
    jitted reference computes them: ``p = fl32(1 - rate)``, the keep
    probability the uniform draw is compared with in float32, and
    ``r = fl32(1 / c)`` with ``c`` = ``1 - rate`` rounded to ``dtype``, the
    float32 factor a kept element is multiplied by before it is rounded
    back to ``dtype``."""
    keep = 1.0 - rate
    c = torch.tensor(keep, dtype=torch.float32).to(dtype).float().numpy()
    return float(np.float32(keep)), float(np.float32(1.0) / c)


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _require_card(x: torch.Tensor, sample_ids: torch.Tensor) -> None:
    if not (x.is_cuda and sample_ids.is_cuda
            and x.device == sample_ids.device):
        raise ValueError("threefry_dropout_cuda: x and sample_ids must be "
                         "CUDA tensors on one device")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def same_phase_empty(x: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor like contiguous ``x`` whose address is
    ``x``'s modulo 16 bytes, so that the kernel's 16-byte vectors line up
    in both (a view into a slightly longer buffer where ``x`` is off a
    16-byte boundary)."""
    phase = x.data_ptr() % 16
    if phase == 0:
        return torch.empty_like(x)
    elt = x.element_size()
    buf = torch.empty(x.numel() + 16 // elt, dtype=x.dtype, device=x.device)
    shift = (phase - buf.data_ptr() % 16) % 16 // elt
    return buf[shift:shift + x.numel()].view(x.shape)


def threefry_dropout_cuda(x: torch.Tensor, key, sample_ids: torch.Tensor,
                          p: float, r: float) -> torch.Tensor:
    """``keep ? round(fl32(x) * r) : 0`` with ``keep`` the reference's
    bernoulli mask of each sample: x [B, ...] on the card (float32 or
    bf16), ``key`` the op's folded key ``(k0, k1)``, ``sample_ids`` [B]
    int32 on the same card (folded into the key by the kernel).  One
    launch."""
    _require_card(x, sample_ids)
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"threefry_dropout_cuda: unsupported dtype "
                         f"{x.dtype}")
    B = x.shape[0]
    if sample_ids.dtype != torch.int32 or sample_ids.shape != (B,):
        raise ValueError(f"threefry_dropout_cuda: sample_ids must be int32 "
                         f"[{B}]; got {sample_ids.dtype} "
                         f"{tuple(sample_ids.shape)}")
    x2 = x.contiguous()
    sids = sample_ids.contiguous()
    out = same_phase_empty(x2)
    n = x2.numel() // B if B else 0
    _build.launch("threefry_dropout", "repro_threefry_dropout",
                  x2.data_ptr(), out.data_ptr(), sids.data_ptr(), B, n,
                  int(key[0]) & MASK, int(key[1]) & MASK, float(p), float(r),
                  DTYPE_CODES[x.dtype], _stream(x))
    return out
