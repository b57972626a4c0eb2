#!/usr/bin/env python3
"""Variants of the dropout kernel's design, side by side on one card.

    python3 benchmarks/torch_threefry_pipes.py

Builds ``src/repro_torch/kernels/csrc/threefry_dropout.cu`` as it is and
in the variants of ``VARIANTS``, each a text substitution into the
source: rotations of some rounds built on the multiply-add pipe as the
lo/hi pair of an IMAD.WIDE.U32 (``x * (one << r)``, the multiplier hidden
from ptxas) and xored into x0 by one LOP3, in place of the funnel shift
(SHF, ALU pipe); 2 or 8 vectors of 16 bytes a thread in place of 4; a
launch bound of 8 blocks an SM; plain adds, placed by ptxas, in place of
``mad.lo.u32`` by a hidden 1; the key injection of the first word and the
next round's add as one three-input add; 128 or 512 threads a block.  Checks every build bit for bit against the
plain version at [1, 4096, 4096], rate 0.1, in bf16 and float32, prints
each build's static ALU-pipe and multiply-add-pipe instructions an element
(32-bit-counter kernels, the sample fold and scalar path included) and its
time (CUDA events, medians of 7 interleaved rounds of 20 calls), then the
SM clock and power ``nvidia-smi`` samples while the committed build runs
back to back for ~2 s, and the committed build's time at 8 samples of
that size.  The card's name and power limit come first.
Needs a card and nvcc; builds into ``build/threefry_pipes/`` (git-ignored).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ref, threefry  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/csrc/threefry_dropout.cu"
OUT = ROOT / "build" / "threefry_pipes"
ROTATION = "  x1 = __funnelshift_l(x1, x1, rot_amount(r)) ^ x0;\n"
WIDE_ROTATION = """  if constexpr ((MASKu >> r) & 1u) {
    unsigned long long w;
    asm("mul.wide.u32 %0, %1, %2;"
        : "=l"(w) : "r"(x1), "r"(one << rot_amount(r)));
    x1 = (unsigned)w ^ (unsigned)(w >> 32) ^ x0;
  } else {
""" + "  " + ROTATION + "  }\n"
VECTORS = "constexpr int kVectors = 4;"
THREADS = "constexpr int kThreads = 256;"
BOUNDS = "__global__ void __launch_bounds__(kThreads)"
MAD = '  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(one), "r"(b));'
INJECTION = "    x0 = add_mad(add_mad(x0, k.ka[g], one), x1, one);"


def wide(mask: int) -> tuple:
    return ((ROTATION, WIDE_ROTATION.replace("MASK", f"{mask:#07x}")),)


# name -> (substitutions, 16-byte vectors a thread)
VARIANTS = {
    "as committed": ((), 4),
    "IMAD.WIDE rounds 0x11111": (wide(0x11111), 4),
    "IMAD.WIDE rounds 0x55555": (wide(0x55555), 4),
    "IMAD.WIDE rounds 0xfffff": (wide(0xFFFFF), 4),
    "2 vectors a thread": (((VECTORS, VECTORS.replace("4", "2")),), 2),
    "8 vectors a thread": (((VECTORS, VECTORS.replace("4", "8")),), 8),
    "8 blocks an SM": (((BOUNDS, BOUNDS.replace("(kThreads)",
                                                "(kThreads, 8)")),), 4),
    "adds as ptxas places them": (((MAD, "  d = a + b;"),), 4),
    "IADD3 injections": (((INJECTION, "    x0 = x0 + k.ka[g] + x1;"),), 4),
    "128 threads a block": (((THREADS, THREADS.replace("256", "128")),), 4),
    "512 threads a block": (((THREADS, THREADS.replace("256", "512")),), 4),
}
SHAPE, SAMPLE_IDS, RATE = (1, 4096, 4096), (12345,), 0.1


def build_all() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    libs, procs = {}, []
    for i, (name, (subs, _)) in enumerate(VARIANTS.items()):
        src = text
        for old, new in subs:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} not found once")
            src = src.replace(old, new)
        path = OUT / f"variant{i}.cu"
        path.write_text(src)
        libs[name] = OUT / f"variant{i}.so"
        procs.append(subprocess.Popen(
            [_build._nvcc(), *_build.ARCH_FLAGS, *_build.CFLAGS,
             f"-I{SOURCE.parent}", "-shared", "-o", str(libs[name]),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for name, proc in zip(libs, procs):
        out = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        regs = sorted({line.split("Used")[1].split(",")[0].strip()
                       for line in out.splitlines() if "Used" in line})
        print(f"{name}: ptxas {regs}", flush=True)
    return libs


def caller(lib: Path, x, key, sids, p, r):
    fn = ctypes.CDLL(str(lib)).repro_threefry_dropout
    fn.argtypes = _build.SIGNATURES["repro_threefry_dropout"]
    fn.restype = ctypes.c_int

    def call():
        out = torch.empty_like(x)
        err = fn(x.data_ptr(), out.data_ptr(), sids.data_ptr(), x.shape[0],
                 x[0].numel(),
                 int(key[0]), int(key[1]), p, r,
                 threefry.DTYPE_CODES[x.dtype],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return out
    return call


def clock_under_load(call, seconds: float = 2.0) -> str:
    """Median SM clock (MHz) and power (W) sampled every 50 ms while
    ``call`` runs back to back."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "50"],
                           stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(2000):
            call()
        torch.cuda.synchronize()
    smi.terminate()
    rows = [line.split(",") for line in smi.communicate()[0].splitlines()
            if line.count(",") == 1]
    rows = np.array([[float(a), float(b)] for a, b in rows[2:]])
    return (f"SM clock {np.median(rows[:, 0]):.0f} MHz (min "
            f"{rows[:, 0].min():.0f}), power {np.median(rows[:, 1]):.1f} W "
            f"over {len(rows)} samples")


def main() -> None:
    cs.phase_device()
    libs = build_all()
    for name, lib in libs.items():
        counts, mix = cs.parse_sass(cs.sass_of(lib))
        for f in sorted(mix):
            if "threefry_dropout_kernel" in f and "Lb1E" in f:
                bf16 = "nv_bfloat16" in f
                per = VARIANTS[name][1] * (8 if bf16 else 4)
                alu, mad = cs.pipe_counts(mix[f])
                print(f"{name} {'bf16' if bf16 else 'float32'}: static ALU "
                      f"pipe {alu / per:.2f}, multiply-add pipe "
                      f"{mad / per:.2f} an element ({per} a thread); "
                      f"LDL/STL {counts[f]['LDL/STL']}", flush=True)
    key = threefry.fold_in(threefry.key_from_seed(0), 1)
    sids = torch.tensor(SAMPLE_IDS, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(SHAPE, generator=gen, device="cuda").to(dtype)
        p, r = threefry.dropout_scalars(RATE, dtype)
        want = ref.dropout_reference(x, key, sids, p, r)
        fns = {name: caller(lib, x, key, sids, p, r)
               for name, lib in libs.items()}
        for name, call in fns.items():
            cs.check(torch.equal(call(), want),
                     f"{name} {dtype}: != the plain version")
        med = cs.interleaved_medians(fns, 7, 20)
        print(f"{dtype} {list(SHAPE)} rate {RATE}, bitwise the plain "
              f"version in every build; ms: "
              + ", ".join(f"{k} {v:.5f}" for k, v in med.items()),
              flush=True)
        print(f"{dtype} as committed, back to back: "
              f"{clock_under_load(fns['as committed'])}", flush=True)
        # the launch's fixed cost: 8 samples of the same size
        x8 = torch.randn((8, *SHAPE[1:]), generator=gen,
                         device="cuda").to(dtype)
        sids8 = torch.arange(8, dtype=torch.int32, device="cuda")
        t8 = cs.interleaved_medians(
            {"x8": caller(libs["as committed"], x8, key, sids8, p, r)},
            7, 20)["x8"]
        print(f"{dtype} as committed at {[8, *SHAPE[1:]]}: {t8:.5f} ms, "
              f"{t8 / 8:.5f} ms a sample against "
              f"{med['as committed']:.5f} at {list(SHAPE)}", flush=True)


if __name__ == "__main__":
    main()
