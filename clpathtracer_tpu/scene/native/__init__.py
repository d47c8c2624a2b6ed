"""Native (C++) Wavefront OBJ parser, loaded via ctypes.

The reference parses OBJ in C (vendored tinyobj, src/model.c:10-11); this
is this framework's native equivalent for the same hot path —
geometry-record scanning — compiled on first use with g++ (no pip, no
pybind11) into a library named by a hash of the source, with the
numbers handed back as SoA numpy arrays. Material
resolution (mtllib file IO, Kd/Ke lookup) stays in Python: it touches the
filesystem and runs once per material, not per line.

Falls back cleanly: callers catch NativeObjError (or set CLPT_NO_NATIVE)
and use scene/objparser.py's pure-Python parser instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "obj_native.cpp")
_lock = threading.Lock()
_lib = None


class NativeObjError(RuntimeError):
    pass


def _so_path() -> str:
    """The library built from the source as it is now: its file name
    carries a hash of the .cpp, so a library built from any other version
    of the source is never loaded."""
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    return os.path.join(_DIR, f"_obj_native.{digest}.so")


def _compile(so: str) -> None:
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", _SRC, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:  # no compiler on this machine
        raise NativeObjError(f"native obj parser compile failed: {e}") from e
    if proc.returncode != 0:
        raise NativeObjError(
            f"native obj parser compile failed:\n{proc.stderr[-2000:]}")
    os.replace(tmp, so)  # atomic: concurrent builders never see a partial file


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if os.environ.get("CLPT_NO_NATIVE"):
            raise NativeObjError("disabled via CLPT_NO_NATIVE")
        so = _so_path()
        if not os.path.exists(so):
            _compile(so)
        lib = ctypes.CDLL(so)
        lib.obj_parse.restype = ctypes.c_void_p
        lib.obj_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.obj_error.restype = ctypes.c_char_p
        lib.obj_error.argtypes = [ctypes.c_void_p]
        lib.obj_counts.restype = None
        lib.obj_counts.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int64)]
        lib.obj_export.restype = None
        lib.obj_export.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_char_p]
        lib.obj_free.restype = None
        lib.obj_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    try:
        _load()
        return True
    except NativeObjError:
        return False


def parse_obj_native(text: str):
    """Parse OBJ text with the native scanner.

    Returns (geometry dict like objparser.parse_obj minus albedo/emission,
    tri_mat [F] i32 material ids, mat_names list, mtllib names list).
    Raises NativeObjError on malformed input (message matches the Python
    parser's error kinds).
    """
    lib = _load()
    data = text.encode("utf-8", errors="replace")
    h = lib.obj_parse(data, len(data))
    try:
        err = lib.obj_error(h)
        if err:
            raise NativeObjError(err.decode())
        counts = (ctypes.c_int64 * 6)()
        lib.obj_counts(h, counts)
        nv, nn, nt, nf, mat_len, lib_len = (int(c) for c in counts)
        v = np.empty((nv, 3), np.float32)
        vn = np.empty((nn, 3), np.float32)
        vt = np.empty((nt, 2), np.float32)
        faces = np.empty((nf, 3, 3), np.int32)
        tri_mat = np.empty((nf,), np.int32)
        matbuf = ctypes.create_string_buffer(max(mat_len, 1))
        libbuf = ctypes.create_string_buffer(max(lib_len, 1))
        lib.obj_export(
            h,
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            vn.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            vt.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            tri_mat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            matbuf, libbuf)
        mats = (matbuf.raw[:mat_len].decode("utf-8", errors="replace")
                .split("\n")[:-1] if mat_len else [])
        libs = (libbuf.raw[:lib_len].decode("utf-8", errors="replace")
                .split("\n")[:-1] if lib_len else [])
    finally:
        lib.obj_free(h)

    # same out-of-range validation as the Python parser
    if faces.size and (np.any(faces[..., 0] < 0)
                       or np.any(faces[..., 0] >= nv)):
        raise NativeObjError("face references out-of-range vertex index")
    if faces.size and np.any(faces[..., 1] >= nn):
        raise NativeObjError("face references out-of-range normal index")
    geo = {"verts": v, "normals": vn, "texcoords": vt, "faces": faces}
    return geo, tri_mat, mats, libs
