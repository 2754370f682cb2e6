"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` of the package is compiled with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface,
``build/torch_kernels/libarrl_kernels.so`` under the repository root, and
loaded with ``ctypes``. Nothing happens at import: the first wrapper that
launches a kernel calls ``library()``. The sources compile in parallel, one
``nvcc`` each, then link. A stamp of the sources' and flags' hash decides
whether an existing library is reused.

No ``--use_fast_math`` and ``-fmad=false``: both kernels need IEEE fp32
with every multiply and add rounded on its own (see the notes in the
sources).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libarrl_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-Xcompiler", "-fPIC",
              "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (pointers and the stream as c_void_p).
SIGNATURES = {
    "arrl_stage1_pair": [_P, _I, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P],
    "arrl_resample": [_P, _I, _P, _P, _P, _P, _P],
}

_lib = None
build_log = ""  # nvcc's output of the last build in this process


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _digest(sources):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(os.path.basename(p).encode() + b"\0")
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    path = shutil.which("nvcc")
    if path is None and CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if path is None or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _run_all(cmds):
    """Start every command at once, wait for all; raise on any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = []
    failed = []
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0:
            failed.append(f"{' '.join(c)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "".join(logs)


def build() -> str:
    """Compile the library unless an up-to-date one exists; returns its
    path."""
    global build_log
    sources = [s for s in _sources() if s.endswith(".cu")]
    digest = _digest(_sources())
    stamp = LIB_PATH + ".sha256"
    if os.path.exists(LIB_PATH) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in sources]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", s, "-o", o]
                        for s, o in zip(sources, objs)])
        lib_tmp = os.path.join(tmp, "lib.so")
        log += _run_all([[nvcc, "-shared", *NVCC_FLAGS[:2], *objs,
                          "-o", lib_tmp]])
        os.replace(lib_tmp, LIB_PATH)
    with open(stamp, "w") as f:
        f.write(digest + "\n")
    build_log = log
    return LIB_PATH


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.arrl_error_string.argtypes = [ctypes.c_int]
        lib.arrl_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, name: str):
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        msg = library().arrl_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
