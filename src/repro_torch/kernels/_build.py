"""Build the CUDA kernels in ``csrc/`` and bind them with ``ctypes``.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` in parallel, then links
one shared library with a plain C interface, at first use.  The library goes
to ``build/repro_torch_kernels/<hash of sources and flags>/`` at the root of
the checkout (listed in ``.gitignore``), so a changed source builds anew and
an unchanged one is reused.  No PyTorch headers are compiled: every pointer
and the stream cross as ``c_void_p``, sizes as ``c_int``/``c_longlong``, and
each C entry returns its ``cudaGetLastError()``, on which :func:`launch`
raises.  A machine with a card but no ``nvcc``, or a failed build, raises:
there is no fallback.

:data:`LAUNCHES` counts kernel launches by name; :func:`launch` is the only
place that adds to it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas -v: registers, shared memory and spills of each kernel, kept in
# ``last_build_log``
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_U = ctypes.c_uint
#: C entry points and their argument types (see csrc/*.cu)
SIGNATURES = {
    "repro_rmsnorm": [_P, _P, _P, _LL, _I, _F, _I, _P],
    "repro_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL,
                              _I, _F, _I, _P],
    "repro_flash_attention_sm90": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   *[_LL] * 9, _I, _F, _P],
    "repro_flash_attention_tf32": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   *[_LL] * 9, _I, _F, _P],
    "repro_flash_attention_bf16_mma": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                       *[_LL] * 9, _I, _F, _P],
    "repro_fused_adam": [_P, _P, _P, _P, _LL, _F, _F, _F, _F, _F, _F, _F, _F,
                         _F, _P],
    "repro_ssd_scan": [*[_P] * 9, *[_I] * 7, *[_LL] * 12, _I, _P],
    "repro_ssd_scan_sm90": [*[_P] * 10, *[_I] * 7, *[_LL] * 12, _P],
    "repro_ssd_scan_sm90_f32": [*[_P] * 10, *[_I] * 7, *[_LL] * 12, _P],
    "repro_threefry_dropout": [_P, _P, _P, _LL, _LL, _U, _U, _F, _F, _I, _P],
}
#: kernel launches by kernel name, added to only by :func:`launch`
LAUNCHES: Dict[str, int] = {"rmsnorm": 0, "flash_attention": 0,
                            "fused_adam": 0, "ssd_scan": 0,
                            "flash_attention_sm90": 0, "ssd_scan_sm90": 0,
                            "flash_attention_tf32": 0,
                            "ssd_scan_sm90_f32": 0,
                            "flash_attention_bf16_mma": 0,
                            "threefry_dropout": 0}

_lib: Optional[ctypes.CDLL] = None
last_build_seconds: float = 0.0
last_build_log: str = ""


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built from source at first use and need the CUDA "
                       "toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def build() -> Path:
    """Compile (if needed) and return the path of the kernels' library."""
    global last_build_seconds, last_build_log
    cus, headers = _sources()
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
    for p in cus + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / "librepro_torch_kernels.so"
    if lib.exists():
        return lib
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [out_dir / (p.stem + ".o") for p in cus]
    procs = [subprocess.Popen([nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(src),
                               "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for src, obj in zip(cus, objs)]
    logs, errors = [], []
    for src, proc in zip(cus, procs):
        out = proc.communicate()[0].decode(errors="replace")
        logs.append(f"{src.name}:\n{out}")
        if proc.returncode != 0:
            errors.append(logs[-1])
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = out_dir / f"{lib.name}.{os.getpid()}.tmp"
    res = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                          *map(str, objs)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    last_build_log = "\n".join(logs)
    last_build_seconds = time.perf_counter() - t0
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernels' library (built at first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(kernel: str, entry: str, *args) -> None:
    """Call C entry ``entry`` of the library, count one launch of
    ``kernel``, and raise if CUDA reports an error for the launch."""
    err = getattr(library(), entry)(*args)
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")
    LAUNCHES[kernel] += 1
