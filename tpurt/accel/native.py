"""ctypes bridge to the native C++ builders (tpurt/native/builders.cpp).

The shared library is built from the committed source by `make` on first
use in each process (make compares timestamps, so a library older than
builders.cpp is rebuilt, and a missing one is built) and kept next to the
source; every entry point falls back to the numpy builders when the
toolchain or the build is unavailable, so the python-only install never
breaks (outputs are bit-identical, tested).  `backend()` names the builder
that runs.  At 1M triangles the native grid builder is ~100× the python one
(the python rasterization loop is per-triangle per-cell).
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    here = os.path.join(os.path.dirname(__file__), "..", "native")
    so = os.path.join(here, "native_builders.so")
    try:
        subprocess.run(
            ["make", "-s", "native_builders.so"],
            cwd=here, check=True, capture_output=True, timeout=120,
        )
    except Exception:
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    i64 = ctypes.c_int64
    lib.tpurt_build_clusters.restype = ctypes.c_void_p
    lib.tpurt_build_clusters.argtypes = [
        ctypes.c_void_p, i64, ctypes.c_void_p, i64, ctypes.c_int,
        ctypes.POINTER(i64),
    ]
    lib.tpurt_build_grid.restype = ctypes.c_void_p
    lib.tpurt_build_grid.argtypes = [
        ctypes.c_void_p, i64, ctypes.c_void_p, i64, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(i64),
    ]
    lib.tpurt_get_clusters.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
    lib.tpurt_free_clusters.argtypes = [ctypes.c_void_p]
    lib.tpurt_load_obj.restype = ctypes.c_void_p
    lib.tpurt_load_obj.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(i64), ctypes.POINTER(i64),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(i64),
    ]
    lib.tpurt_get_obj.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 5
    lib.tpurt_obj_group_name.restype = ctypes.c_char_p
    lib.tpurt_obj_group_name.argtypes = [ctypes.c_void_p, i64]
    lib.tpurt_free_obj.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def backend() -> str:
    """Which cluster builder runs: "native" (C++) or "numpy"."""
    return "native" if available() else "numpy"


def _run(builder, verts, tris, leaf, *extra):
    from tpurt.accel.clusters import ClusterSet

    lib = _load()
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    n = ctypes.c_int64(0)
    handle = builder(
        verts.ctypes.data_as(ctypes.c_void_p), verts.shape[0],
        tris.ctypes.data_as(ctypes.c_void_p), tris.shape[0],
        *extra, leaf, ctypes.byref(n),
    )
    C = n.value
    tri_ids = np.empty((C, leaf), np.int32)
    lo = np.empty((C, 3), np.float32)
    hi = np.empty((C, 3), np.float32)
    if C:
        lib.tpurt_get_clusters(
            handle,
            tri_ids.ctypes.data_as(ctypes.c_void_p),
            lo.ctypes.data_as(ctypes.c_void_p),
            hi.ctypes.data_as(ctypes.c_void_p),
        )
    lib.tpurt_free_clusters(handle)
    return ClusterSet(tri_ids=tri_ids, aabb_lo=lo, aabb_hi=hi)


def build_clusters_native(vertices, triangles, leaf: int = 128):
    lib = _load()
    if lib is None:
        from tpurt.accel.clusters import build_clusters

        return build_clusters(vertices, triangles, leaf)
    return _run(lib.tpurt_build_clusters, vertices, triangles, leaf)


def load_obj_native(path: str):
    """Native .obj parse (SURVEY §2 R11) → the load_obj dict, or None when
    the library is unavailable (caller falls back to the numpy parser —
    which is also the semantic spec: outputs are bit-identical, tested)."""
    lib = _load()
    if lib is None:
        return None
    nv = ctypes.c_int64(0)
    nt = ctypes.c_int64(0)
    has_n = ctypes.c_int(0)
    ng = ctypes.c_int64(0)
    handle = lib.tpurt_load_obj(
        os.fsencode(path), ctypes.byref(nv), ctypes.byref(nt),
        ctypes.byref(has_n), ctypes.byref(ng))
    if not handle:
        return None
    try:
        V, T = nv.value, nt.value
        verts = np.empty((V, 3), np.float32)
        tris = np.empty((T, 3), np.int32)
        uvs = np.empty((V, 2), np.float32)
        nrms = np.empty((V, 3), np.float32) if has_n.value else None
        tri_group = np.empty((T,), np.int32)
        lib.tpurt_get_obj(
            handle,
            verts.ctypes.data_as(ctypes.c_void_p),
            tris.ctypes.data_as(ctypes.c_void_p),
            uvs.ctypes.data_as(ctypes.c_void_p),
            (nrms.ctypes.data_as(ctypes.c_void_p) if nrms is not None
             else None),
            tri_group.ctypes.data_as(ctypes.c_void_p),
        )
        groups = [
            lib.tpurt_obj_group_name(handle, i).decode()
            for i in range(ng.value)
        ]
    finally:
        lib.tpurt_free_obj(handle)
    return {
        "vertices": verts,
        "triangles": tris,
        "uvs": uvs,
        "normals": nrms,
        "tri_group": tri_group,
        "groups": groups,
    }


def build_grid_native(vertices, triangles, target_tris_per_cell: int = 64,
                      leaf: int = 128):
    lib = _load()
    if lib is None:
        from tpurt.accel.grid import build_grid

        return build_grid(vertices, triangles, target_tris_per_cell).clusters
    return _run(
        lib.tpurt_build_grid, vertices, triangles, leaf, target_tris_per_cell
    )
