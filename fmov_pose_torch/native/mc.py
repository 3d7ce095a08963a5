"""Python binding for the native isosurface extractor (see marching.cpp; a
copy of ``fmov_pose_tpu/native/mc.py``)."""

from __future__ import annotations

import ctypes

import numpy as np

from fmov_pose_torch import native


def _lib():
    lib = native.load("fmovmc", ["marching.cpp"])
    if not getattr(lib, "_configured", False):
        lib.mt_run.restype = ctypes.c_void_p
        lib.mt_run.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.mt_get.restype = None
        lib.mt_get.argtypes = [ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_float),
                               ctypes.POINTER(ctypes.c_int32)]
        lib.mt_free.restype = None
        lib.mt_free.argtypes = [ctypes.c_void_p]
        lib._configured = True
    return lib


def marching_cubes(grid: np.ndarray, iso: float = 0.0):
    """Extract the iso-surface of a [nx, ny, nz] scalar grid.

    Returns (vertices [V, 3] float32 in voxel coordinates, triangles [T, 3]
    int32) — same convention as `mcubes.marching_cubes` used by the
    reference (`renderer.py:43`).
    """
    lib = _lib()
    grid = np.ascontiguousarray(grid, dtype=np.float32)
    nx, ny, nz = grid.shape
    nv = ctypes.c_int64()
    nt = ctypes.c_int64()
    handle = lib.mt_run(
        grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nx, ny, nz, ctypes.c_float(iso),
        ctypes.byref(nv), ctypes.byref(nt))
    try:
        verts = np.empty((nv.value, 3), dtype=np.float32)
        tris = np.empty((nt.value, 3), dtype=np.int32)
        if nv.value:
            lib.mt_get(handle,
                       verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                       tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    finally:
        lib.mt_free(handle)
    return verts, tris
