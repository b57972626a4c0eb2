#!/usr/bin/env python3
"""The CUDA-core SSD scan (``csrc/ssd_scan.cu``) at its three yardsticks,
beside the single-kernel design it replaced, on one card.

    python3 benchmarks/torch_ssd_cuda_cores.py [--widths] [--variants]
        [--before DIR]

Yardsticks (``chip_smoke.SSD_CC_YARDSTICKS``), float32, each with
silu-activated x, B and C as views of one ``xBC`` activation, g 1, b 1,
s 4096, dt = softplus of a normal draw and A = -linspace(1, 16, h):

- main:   x [1, 4096, 80, 64],  B, C [1, 4096, 1, 128], chunk 256;
- narrow: x [1, 4096, 320, 16], B, C [1, 4096, 1, 16],  chunk 8;
- wide:   x [1, 4096, 40, 128], B, C [1, 4096, 1, 128], chunk 256.

At each, this tree's kernel (``ssd_scan_cuda_cores``) is held to the
``ssd_scan`` tier against the float32 sequential oracle and timed (CUDA
events, medians of interleaved rounds) beside its bound
(``chip_smoke.ssd_bound`` at the CUDA cores' float32 peak) and the composed
``ref.ssd_chunked``; its kernels' device time a call comes from
``torch.profiler``.

``--widths`` first holds the kernel to the oracle at every width of
``chip_smoke.SSD_CC_WIDTHS`` (``chip_smoke.py`` phase 3 does the same).

``--variants`` builds variants of this tree's ``ssd_scan.cu`` by text
substitution (``VARIANTS``), each with one piece of work taken out, and
times each beside the kernel as it is at the yardsticks the piece runs
at, with its kernels' device time a call: where the kernels' time goes.
Their outputs are wrong by design and are not checked.  The anchors are
exact lines of ``ssd_scan.cu``: an edit to those lines makes
``build_variants`` raise with the anchor it missed, and the anchor is then
updated with the edit.

``--before DIR`` names a checkout of a tree whose ``ssd_scan.cu`` is the
single-kernel design the chunk-parallel one replaced (commit 2f0fc7b, for
example unpacked with ``git archive`` into a git-ignored directory).  It is
built alone with nvcc into ``build/ssd_cuda_cores_before/`` and called
through that design's C entry (``BEFORE_SIGNATURE``: one kernel, no
workspace), checked against the same oracle and timed in the same rounds,
in the order before, tree, tree, before.  The card's name and power limit
come first; a JSON line with every number comes last.  Needs a card and
nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    cuda_core_workspace, ssd_scan_cuda_cores)

BEFORE_OUT = ROOT / "build" / "ssd_cuda_cores_before"
# the C entry of the single-kernel design: x, dt, A, B, C, y; batch, S, H,
# G, P, N, chunk; the strides of x, dt, B, C; the dtype code; the stream
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
BEFORE_SIGNATURE = [_P] * 6 + [_I] * 7 + [_LL] * 12 + [_I, _P]


# name -> (yardsticks, [(text, replacement), ...]) on csrc/ssd_scan.cu
VARIANTS = {
    "chunk_out_small without the walk": (("narrow",), [(
        "  // thread -> (head, p) pair, TN threads a pair;",
        "  if (pl.TN > 0) return;\n  // thread -> (head, p) pair, TN "
        "threads a pair;")]),
    "chunk_out_small without M": (("narrow",), [(
        "for (int idx = threadIdx.x; idx < rows * MP; idx += kThreads) {",
        "for (int idx = threadIdx.x; idx < 0 * MP; idx += kThreads) {")]),
    "chunk_out_small without the intra-chunk sum": (("narrow",), [(
        "for (int jj = t; jj < b0 + nb; jj += TN) {",
        "for (int jj = t; jj < 0; jj += TN) {")]),
    "chunk_out_small without the state update": (("narrow",), [(
        "    if (valid && kk + 1 < kg) {",
        "    if (valid && kk + 1 < 0 * kg) {")]),
    "chunk_state without its products": (("narrow", "main", "wide"), [(
        "    if (active) {\n      const float* xt",
        "    if (active && pl.R < 0) {\n      const float* xt")]),
    "chunk_out_large without M x": (("main", "wide"), [(
        "const int jend = jt == it ? min(kTile, 8 * warp + 8) : kTile;",
        "const int jend = 0;")]),
    "chunk_out_large without the entering-state product": (
        ("main", "wide"), [(
            "  for (int nn = 0; nn < pl.NPAD; nn += 4) {\n    float4 cv[4];\n",
            "  for (int nn = 0; nn < 0; nn += 4) {\n    float4 cv[4];\n")]),
    "chunk_out_large without either product": (("main", "wide"), [(
        "const int jend = jt == it ? min(kTile, 8 * warp + 8) : kTile;",
        "const int jend = 0;"), (
        "  for (int nn = 0; nn < pl.NPAD; nn += 4) {\n    float4 cv[4];\n",
        "  for (int nn = 0; nn < 0; nn += 4) {\n    float4 cv[4];\n")]),
}
VARIANT_OUT = ROOT / "build" / "ssd_cuda_cores_variants"


def build_variants() -> dict:
    """Each variant's C entry, the sources built by parallel nvcc calls."""
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    procs = {}
    for i, (name, (_, subs)) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} not found")
            text = text.replace(old, new)
        out = VARIANT_OUT / str(i)
        out.mkdir(parents=True, exist_ok=True)
        (out / "ssd_scan.cu").write_text(text)
        procs[name] = (out / "lib.so", subprocess.Popen(
            [_build._nvcc(), *_build.ARCH_FLAGS, *_build.CFLAGS,
             f"-I{_build.CSRC}", "-shared", "-o", str(out / "lib.so"),
             str(out / "ssd_scan.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    fns = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
        fn = ctypes.CDLL(str(lib)).repro_ssd_scan
        fn.argtypes = _build.SIGNATURES["repro_ssd_scan"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def call_variant(fn, x, dt, A, B, C, chunk):
    """A variant's C entry called as ``ssd_scan_cuda_cores`` calls the
    tree's (contiguous x, B and C views as given)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    ws, seg, cb = (torch.empty(k, dtype=torch.float32, device=x.device)
                   for k in cuda_core_workspace(b, s, h, g, p, n, chunk))
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
             C.data_ptr(), y.data_ptr(), ws.data_ptr(), seg.data_ptr(),
             cb.data_ptr(), b, s, h, g, p, n, chunk, *x.stride()[:3],
             *dt.stride(), *B.stride()[:3], *C.stride()[:3], 0,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"variant repro_ssd_scan: CUDA error {err}")
    return y


def build_before(tree: Path):
    """``ssd_scan.cu`` of ``tree`` as a shared library; its C entry."""
    src = tree / "src/repro_torch/kernels/csrc/ssd_scan.cu"
    BEFORE_OUT.mkdir(parents=True, exist_ok=True)
    lib = BEFORE_OUT / "libssd_scan_before.so"
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, *_build.CFLAGS,
                    "-shared", "-o", str(lib), str(src)], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(lib)).repro_ssd_scan
    fn.argtypes = BEFORE_SIGNATURE
    fn.restype = ctypes.c_int
    return fn


def call_before(fn, x, dt, A, B, C, chunk):
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
             C.data_ptr(), y.data_ptr(), b, s, h, g, p, n, chunk,
             *x.stride()[:3], *dt.stride(), *B.stride()[:3],
             *C.stride()[:3], 0, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"before-design repro_ssd_scan: CUDA error {err}")
    return y


def inputs(gen, h, p, n, chunk, s=4096, g=1):
    xBC = F.silu(torch.randn(1, s, h * p + 2 * g * n, generator=gen,
                             device="cuda"))
    x = xBC[..., :h * p].reshape(1, s, h, p)
    B = xBC[..., h * p:h * p + g * n].reshape(1, s, g, n)
    C = xBC[..., h * p + g * n:].reshape(1, s, g, n)
    dt = F.softplus(torch.randn(1, s, h, generator=gen, device="cuda"))
    A = -torch.linspace(1.0, 16.0, h, device="cuda")
    return x, dt, A, B, C


def turns(fns: dict, rounds: int, iters: int) -> dict:
    """Medians of ``cs.time_ms`` over ``rounds``, the functions taken in
    turn, the order reversed every other round (a, b, b, a, ...)."""
    times = {k: [] for k in fns}
    order = list(fns)
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            times[k].append(cs.time_ms(fns[k], iters))
    return {k: float(np.median(v)) for k, v in times.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", type=Path, default=None)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--widths", action="store_true")
    args = ap.parse_args()
    card = cs.phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    for line in _build.last_build_log.splitlines():
        if "ssd_" in line or "Used" in line or "spill" in line:
            cs.log("  " + line.strip())
    before = build_before(args.before) if args.before else None
    variants = build_variants() if args.variants else {}
    tier = ops.TOLERANCE_TIERS["ssd_scan"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.widths:
        cs.ssd_cc_widths(gen)
    out = {}
    for name, (h, p, n, chunk) in cs.SSD_CC_YARDSTICKS.items():
        b, s, g = 1, 4096, 1
        x, dt, A, B, C = inputs(gen, h, p, n, chunk)
        Bh, Ch = (t.repeat_interleave(h, dim=2) for t in (B, C))
        want = ref.ssd_reference(x, dt, A, Bh, Ch)[0]
        fns = {"tree": lambda: ssd_scan_cuda_cores(x, dt, A, B, C, chunk)}
        if before is not None:
            fns = {"before": lambda: call_before(before, x, dt, A, B, C,
                                                 chunk), **fns}
        rec = {"shape": f"x [{b}, {s}, {h}, {p}], B, C [{b}, {s}, {g}, {n}], "
                        f"chunk {chunk}, float32"}
        for who, fn in fns.items():
            ok, err = cs.within(fn(), want, tier)
            cs.log(f"{name} {who}: max_abs_err {err:.3e} (max |y| "
                   f"{float(want.abs().max()):.2f}) tier ssd_scan ok={ok}")
            cs.check(ok, f"{name} {who} outside ssd_scan")
            rec[f"{who}_max_abs_err"] = err
        med = turns(fns, 4, 5)
        nbytes, flops = cs.ssd_bound(b, s, h, g, p, n, chunk, 4)
        bnd, by = cs.bound(nbytes, flops, torch.float32)
        composed = cs.time_ms(lambda: ref.ssd_chunked(x, dt, A, B, C, chunk),
                              5)
        phases = {k: v for k, v in cs.device_us_by_kernel(
            fns["tree"], 10).items() if k.startswith("ssd_")}
        for vname, fn in variants.items():
            if name not in VARIANTS[vname][0]:
                continue
            run = (lambda fn=fn: call_variant(fn, x, dt, A, B, C, chunk))
            vmed = turns({"tree": fns["tree"], vname: run}, 4, 5)
            vph = {k: v for k, v in cs.device_us_by_kernel(run, 10).items()
                   if k.startswith("ssd_")}
            cs.log(f"{name} variant {vname}: {vmed[vname]:.4f} ms (tree "
                   f"{vmed['tree']:.4f}); by kernel, us a call: "
                   + ", ".join(f"{k} {v:.2f}" for k, v in vph.items()))
            rec.setdefault("variants", {})[vname] = dict(
                ms=vmed[vname], tree_ms=vmed["tree"], phases_us=vph)
        rec.update({f"{k}_ms": v for k, v in med.items()})
        rec.update(bound_ms=bnd, bound_by=by, composed_ms=composed,
                   tree_phases_us=phases,
                   tree_share_of_bound=bnd / med["tree"])
        if before is not None:
            rec["speedup"] = med["before"] / med["tree"]
        cs.log(f"{name}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                        med.items())
               + f"; bound {bnd:.4f} ms ({by}, {nbytes / 1e6:.1f} MB, "
                 f"{flops / 1e9:.2f} GFLOP); composed ref.ssd_chunked "
                 f"{composed:.4f} ms; tree by kernel, us a call: "
               + ", ".join(f"{k} {v:.2f}" for k, v in phases.items()))
        out[name] = rec
        del x, dt, A, B, C, Bh, Ch, want
        torch.cuda.empty_cache()
    cs.log(card)
    print(json.dumps({"card": card, "yardsticks": out}), flush=True)


if __name__ == "__main__":
    main()
