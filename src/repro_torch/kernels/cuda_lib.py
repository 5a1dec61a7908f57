"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface under ``build/`` at the root of the checkout, named by a hash
of the source and the headers it may include (``csrc/*.cuh``) so an
edited kernel is rebuilt, and loaded with ``ctypes``.
Nothing is built when this module is imported: the first kernel launch
(or an explicit :func:`build`) compiles.  There is no fallback: a build
that fails raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# C signatures of the exported functions, per source (see the .cu files).
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "panel_gemm": {
        "repro_panel_gemm": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _I, _F, _F, _P),
        "repro_panel_gemm_splitk": (_P, _I, _P, _P, _I, _I, _I, _I, _P),
    },
    "quant_gemm": {
        "repro_quant_panel_gemm": (_P, _I, _P, _P, _I, _P, _P, _P, _I, _I,
                                   _I, _I, _I, _I, _I, _I, _F, _F, _P),
        "repro_quant_panel_gemm_splitk": (_P, _I, _P, _P, _I, _P, _I, _I,
                                          _I, _I, _P),
    },
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (no nvcc on PATH and no CUDA_HOME); "
                       "the CUDA kernels are built from source at first use")


def library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=tuple(SIGNATURES)) -> dict:
    """Compile every named source that has no up-to-date library yet, one
    ``nvcc`` process per source, all started together.  Returns
    ``{name: seconds}`` (0.0 for a library that was already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo, secs = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            secs[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        todo[name] = (out, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (out, tmp, t0, proc) in todo.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str = "panel_gemm") -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed, with ``argtypes``/``restype`` declared for every function."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build((name,))
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib
