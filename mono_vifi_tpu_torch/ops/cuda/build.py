"""Build and load the kernel library from `mono_vifi_tpu_torch/csrc`.

At first use each `.cu` source is compiled by its own `nvcc` process, all
started together, for `sm_90a`; the objects are linked into one shared
library with a plain C interface, which is loaded with ctypes. The library
is cached under `mono_vifi_tpu_torch/_build/<hash of sources and flags>/`,
so an unchanged checkout builds once. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_ROOT = PKG / "_build"
FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libmono_vifi_kernels.so"

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "mv_bilinear_sample": [_P, _I, _I, _P, _P, _P] + [_I] * 8 + [_P],
    "mv_bilinear_sample_bwd": [_P, _I, _I, _P, _P, _P, _P, _P] + [_I] * 7 + [_P],
    "mv_ssim_l1_fwd": [_P, _P, _P] + [_I] * 5 + [_P],
    "mv_ssim_l1_bwd": [_P, _P, _P, _P] + [_I] * 5 + [_P],
    "mv_bilinear_splat": [_P, _I] + [_P] * 8 + [_I, _P] + [_I] * 8 + [_P],
    "mv_bilinear_sample_table": [_P, _I] + [_P] * 4 + [_I] * 8 + [_P],
}

# seconds the last build in this process took (0.0 when the cache held it)
last_build_seconds = 0.0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    cands = [
        home and os.path.join(home, "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the kernels need the CUDA toolkit")


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link the library; return its
    path. Raises RuntimeError with the compiler's output on failure."""
    global last_build_seconds
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    out_dir = BUILD_ROOT / _digest(sources)
    lib = out_dir / LIB_NAME
    if lib.exists():
        last_build_seconds = 0.0
        return lib
    t0 = time.perf_counter()
    nvcc = _nvcc()
    work = BUILD_ROOT / f"tmp-{os.getpid()}-{time.monotonic_ns()}"
    work.mkdir(parents=True)
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    log, objs, failed = [], [], []
    for src, obj, p in procs:
        text, _ = p.communicate()
        log.append(f"== {src.name} (rc {p.returncode})\n{text}")
        objs.append(str(obj))
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(work / LIB_NAME), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    (work / "build.log").write_text("\n".join(log))
    out_dir.mkdir(parents=True, exist_ok=True)
    os.replace(work / "build.log", out_dir / "build.log")
    os.replace(work / LIB_NAME, lib)
    shutil.rmtree(work, ignore_errors=True)
    last_build_seconds = time.perf_counter() - t0
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load the library once and declare its signatures."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
