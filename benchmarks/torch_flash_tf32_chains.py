#!/usr/bin/env python3
"""Accumulator chains of the 3xTF32 flash-attention kernel, on one card.

    python3 benchmarks/torch_flash_tf32_chains.py

Builds ``src/repro_torch/kernels/csrc/flash_attention_tf32.cu`` as it is
("short chains": the products of two 8-dim steps of q.k^T, and of one
32-key tile of P.V, summed from zero, then added to the running sums) and a
variant in which every product goes straight into the running sums ("long
chains": one mma.sync chain per score over all head dims, and per output
element over all keys).  Runs both on the same float32 inputs at
[1, 4096, 32, 128], causal, with q x 1 and q x 4, and prints for each, and
for the float32 plain version, the error against the plain version
evaluated in float64 (max abs error, the worst error as a share of its
element's ``flash_attention`` tolerance, elements outside it), then the
time of each build (CUDA events, medians of 5 interleaved rounds of 10
calls).  The card's name and power limit come first.  Needs a card and
nvcc; builds into ``build/flash_tf32_chains/`` (git-ignored).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build, ops, ref  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/csrc/flash_attention_tf32.cu"
OUT = ROOT / "build" / "flash_tf32_chains"
# the short chains' sums, and what the long-chain variant puts instead
LONG_CHAINS = (
    ("mma3(part, a_hi[j], a_lo[j], kf.x, kf.y);",
     "mma3(s[nt], a_hi[j], a_lo[j], kf.x, kf.y);"),
    ("mma3(part[j], p_hi[kt], p_lo[kt], vr[0], vr[L::kPitchV]);",
     "mma3(acc[n0 + j], p_hi[kt], p_lo[kt], vr[0], vr[L::kPitchV]);"),
)
TIER = ops.TOLERANCE_TIERS["flash_attention"]


def build(name: str, text: str):
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"{name}.cu", OUT / f"{name}.so"
    src.write_text(text)
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, *_build.CFLAGS,
                    "-shared", "-o", str(lib), str(src)], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(lib)).repro_flash_attention_tf32
    fn.argtypes = _build.SIGNATURES["repro_flash_attention_tf32"]
    fn.restype = ctypes.c_int
    return fn


def run(fn, q, k, v) -> torch.Tensor:
    B, S, H, hd = q.shape
    o = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H,
             k.shape[2], hd, *q.stride()[:3], *k.stride()[:3],
             *v.stride()[:3], 1, float(hd ** -0.5),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"repro_flash_attention_tf32: CUDA error {err}")
    return o


def report(got: torch.Tensor, want: torch.Tensor) -> str:
    err = (got.double() - want.double()).abs()
    share = err / (TIER["atol"] + TIER["rtol"] * want.double().abs())
    return (f"max_abs_err {float(err.max()):.3e}, worst {float(share.max()):.3f}"
            f" of the tier, {int((share > 1).sum())} outside")


def time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_flash_tf32_chains: no CUDA device visible")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    text = SOURCE.read_text()
    long_text = text
    for old, new in LONG_CHAINS:
        if old not in long_text:
            sys.exit(f"torch_flash_tf32_chains: {old!r} not in the source")
        long_text = long_text.replace(old, new)
    fns = {"short chains": build("short", text),
           "long chains": build("long", long_text)}
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, S, H, hd = 1, 4096, 32, 128
    for qscale in (1.0, 4.0):
        q = qscale * torch.randn(B, S, H, hd, generator=gen, device="cuda")
        k, v = (torch.randn(B, S, H, hd, generator=gen, device="cuda")
                for _ in "kv")
        want = ref.gqa_attention_reference(q.double(), k.double(), v.double(),
                                           causal=True)
        plain = ref.gqa_attention_reference(q, k, v, causal=True)
        print(f"[{B}, {S}, {H}, {hd}] causal q x {qscale:g}, against float64:"
              f" plain version (float32) {report(plain, want)}", flush=True)
        for name, fn in fns.items():
            print(f"  {name}: {report(run(fn, q, k, v), want)}", flush=True)
        del want, plain
        if qscale == 1.0:
            times = {name: [] for name in fns}
            for _ in range(5):
                for name, fn in fns.items():
                    times[name].append(time_ms(lambda: run(fn, q, k, v), 10))
            print("  ms (medians of 5 interleaved rounds of 10): " + ", ".join(
                f"{name} {float(np.median(t)):.4f}"
                for name, t in times.items()), flush=True)


if __name__ == "__main__":
    main()
