"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together) and linked into one
``libkernels.so`` with a plain C interface, loaded with ``ctypes``.  The
library lands in ``build/kernels/<hash>/`` at the repository root, keyed
by a hash of the sources and flags, so an unchanged tree builds once and
an edited one rebuilds.  Nothing is built at import time: the first call
of ``library()`` builds, which happens at the first kernel launch.

Each C entry point returns ``cudaGetLastError()`` after its launch;
``check()`` raises on anything but ``cudaSuccess``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# C entry points of csrc/*.cu and their argument types.
SIGNATURES = {
    "pmt_cache_update": [_P, _P, _P, _I, _I, _LL, _P],
    "pmt_decode_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _F, _I, _F, _I, _I, _P],
    "pmt_prefill_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _I, _F, _I, _I, _F, _I, _I, _P],
    "pmt_fma32": [_P, _P, _LL, _I, _P],
    "pmt_stream_triad": [_P, _P, _P, _LL, _F, _I, _P],
    "pmt_gemm": [_P, _P, _P, _I, _I, _I, _I, _P],
    "pmt_jacobi2d": [_P, _P, _I, _I, _P],
    "pmt_gridder": [_P, _P, _P, _P, _I, _I, _I, _P],
    "pmt_degridder": [_P, _P, _P, _P, _I, _I, _I, _P],
}
ERROR_STRING = "pmt_error_string"

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # set by the call that built


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card, from csrc/")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for src, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                errors.append(f"{src.name}:\n{log.decode(errors='replace')}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        lib_tmp = Path(tmp) / "libkernels.so"
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
             str(lib_tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(lib_tmp, out)        # atomic: readers see all or none


def library_path() -> Path:
    """Where this tree's sources build to (built or not)."""
    return BUILD_ROOT / _digest() / "libkernels.so"


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this tree's sources have
    not been built yet."""
    global _lib, build_seconds
    if _lib is None:
        out = library_path()
        if not out.exists():
            t0 = time.perf_counter()
            _build(out)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(out))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        getattr(lib, ERROR_STRING).argtypes = [ctypes.c_int]
        getattr(lib, ERROR_STRING).restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        what = getattr(library(), ERROR_STRING)(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch ({what})")


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(dtype) -> int:
    """The C side's element-type code: 0 = float32, 1 = bfloat16."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, "
                        f"not {dtype}")
    return _DTYPE_CODES[dtype]
