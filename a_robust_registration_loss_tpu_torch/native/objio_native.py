"""ctypes bindings for the C++ OBJ IO fast path (``objio.cpp``).

``available()`` loads ``build/torch_native/libobjio.so`` under the
repository root, building it with ``g++ -O2 -shared -fPIC`` on first use
when a compiler is there; a stamp of the source's hash decides whether an
existing library is reused. Nothing is built next to the source. Callers
fall back to the pure-Python parser of ``data/objio.py`` when this returns
False: the same semantics, another speed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "objio.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "torch_native")
LIB_PATH = os.path.join(BUILD_DIR, "libobjio.so")
_lib = None
_tried = False


def _digest() -> str:
    with open(SOURCE, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _build() -> bool:
    """Compile into a temporary file and rename it into place, so a
    concurrent loader never sees half a library."""
    stamp = os.path.join(BUILD_DIR, "libobjio.stamp")
    digest = _digest()
    if os.path.exists(LIB_PATH) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read() == digest:
                return True
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", tmp, SOURCE],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        os.unlink(tmp)
        return False
    os.replace(tmp, LIB_PATH)
    with open(stamp, "w") as f:
        f.write(digest)
    return True


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _build():
        return None
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError:
        return None
    lib.objio_read.restype = ctypes.c_int
    lib.objio_read.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.objio_write.restype = ctypes.c_int
    lib.objio_write.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.c_long,
    ]
    lib.objio_free.restype = None
    lib.objio_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def read_obj(path: str):
    lib = _load()
    vp = ctypes.POINTER(ctypes.c_float)()
    fp = ctypes.POINTER(ctypes.c_int)()
    nv = ctypes.c_long()
    nf = ctypes.c_long()
    rc = lib.objio_read(os.fsencode(path), ctypes.byref(vp), ctypes.byref(nv),
                        ctypes.byref(fp), ctypes.byref(nf))
    if rc != 0:
        raise IOError(f"objio_read({path!r}) failed with code {rc}")
    try:
        v = (np.ctypeslib.as_array(vp, shape=(nv.value, 3)).copy() if nv.value
             else np.zeros((0, 3), np.float32))
        f = (np.ctypeslib.as_array(fp, shape=(nf.value, 3)).copy() if nf.value
             else np.zeros((0, 3), np.int32))
    finally:
        lib.objio_free(vp)
        lib.objio_free(fp)
    return v.astype(np.float32, copy=False), f.astype(np.int32, copy=False)


def write_obj(path: str, vertices, faces=None):
    lib = _load()
    v = np.ascontiguousarray(vertices, dtype=np.float32).reshape(-1, 3)
    if faces is None:
        f = np.zeros((0, 3), np.int32)
    else:
        f = np.ascontiguousarray(faces, dtype=np.int32).reshape(-1, 3)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    rc = lib.objio_write(
        os.fsencode(path),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), v.shape[0],
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), f.shape[0],
    )
    if rc != 0:
        raise IOError(f"objio_write({path!r}) failed with code {rc}")
