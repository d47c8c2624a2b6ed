"""Native (C++) acceleration-structure builder, loaded via ctypes.

Compiled on first use with g++ (no pip / pybind11 dependency); the .so is
cached next to the source under a name keyed by a hash of it. Falls back
cleanly — callers use `available()` / catch NativeBuildError and take the
numpy builder instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "sah_native.cpp")
_lock = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    pass


def _so_path() -> str:
    """The library built from the source as it is now: its file name
    carries a hash of the .cpp, so a library built from any other version
    of the source is never loaded."""
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    return os.path.join(_DIR, f"_sah_native.{digest}.so")


def _compile(so: str) -> None:
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", _SRC, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:  # no compiler on this machine
        raise NativeBuildError(f"native builder compile failed: {e}") from e
    if proc.returncode != 0:
        raise NativeBuildError(
            f"native builder compile failed:\n{proc.stderr[-2000:]}")
    os.replace(tmp, so)  # atomic: concurrent builders never see a partial file


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if os.environ.get("CLPT_NO_NATIVE"):
            raise NativeBuildError("disabled via CLPT_NO_NATIVE")
        so = _so_path()
        if not os.path.exists(so):
            _compile(so)
        lib = ctypes.CDLL(so)
        lib.kd_build.restype = ctypes.c_void_p
        lib.kd_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32]
        lib.kd_num_nodes.restype = ctypes.c_int64
        lib.kd_num_nodes.argtypes = [ctypes.c_void_p]
        lib.kd_num_tri_indices.restype = ctypes.c_int64
        lib.kd_num_tri_indices.argtypes = [ctypes.c_void_p]
        lib.kd_export.restype = None
        lib.kd_export.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32)]
        lib.kd_free.restype = None
        lib.kd_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    try:
        _load()
        return True
    except NativeBuildError:
        return False


def build_kd_native(tri_verts: np.ndarray, max_depth: int, leaf_size: int,
                    tri_block: int = 4):
    """Build via the C++ builder.

    tri_verts: [F, 3, 3] float. Returns (node_table [M, 24] f32,
    tri_indices [T] i32). Only tri_block=4 (quad-row) layouts are packed.
    """
    assert tri_block == 4, "native builder emits quad-row (tri_block=4) trees"
    lib = _load()
    tv = np.ascontiguousarray(tri_verts, np.float32)
    n = tv.shape[0]
    handle = lib.kd_build(
        tv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(n), ctypes.c_int32(max_depth),
        ctypes.c_int32(leaf_size), ctypes.c_int32(tri_block))
    try:
        m = lib.kd_num_nodes(handle)
        t = lib.kd_num_tri_indices(handle)
        # node/tri ids ride in the f32 node table; beyond 2^24 they would
        # silently round and corrupt traversal (same guard as the numpy
        # packer, accel/sah.py::pack_node_table)
        assert m < (1 << 24), f"{m} nodes overflows f32-exact int range"
        assert n < (1 << 24), f"{n} tris overflows f32-exact int range"
        assert t < (1 << 24), f"{t} tri indices overflow f32-exact range"
        table = np.empty((m, 24), np.float32)
        tri_indices = np.empty((t,), np.int32)
        lib.kd_export(
            handle, table.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            tri_indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    finally:
        lib.kd_free(handle)
    return table, tri_indices
