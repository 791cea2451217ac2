"""Mesh voxelization: ctypes bindings to the native C++ voxelizer, with a
pure-NumPy fallback.

The reference consumes pre-voxelized .npy grids (pascal3D.py:132-154,
modelnet shards) but ships no voxelizer — this supplies the missing
preprocessing stage. The native path (native/voxelizer.cpp) does
multi-threaded conservative surface rasterization + z-parity solid fill;
the fallback implements the same algorithm vectorized in NumPy (slower,
always available). Also loads OFF files (the ModelNet/Pascal CAD format).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

from anytime3d_tpu.data.native import native_lib

_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False


def _find_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    candidates = [
        os.environ.get("ANYTIME3D_VOXELIZER_LIB", ""),  # sanitizer builds etc.
        native_lib("libvoxelizer.so") or "",
    ]
    candidates = [c for c in candidates if c]
    for path in candidates:
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
                lib.voxelize_mesh.argtypes = [
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                    ctypes.c_int32, ctypes.c_int32,
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
                ]
                lib.nms_host.argtypes = [
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                    ctypes.c_float, ctypes.POINTER(ctypes.c_uint8),
                ]
                _LIB = lib
                break
            except OSError:
                continue
    return _LIB


def native_available() -> bool:
    return _find_lib() is not None


def normalize_mesh(verts: np.ndarray, dim: int, pad: float = 0.05) -> np.ndarray:
    """Scale/center vertices into the [0, dim] voxelization cube, preserving
    aspect, with ``pad`` fractional margin."""
    v = np.asarray(verts, np.float32)
    mins, maxs = v.min(axis=0), v.max(axis=0)
    extent = float((maxs - mins).max())
    if extent <= 0:
        extent = 1.0
    scale = dim * (1.0 - 2 * pad) / extent
    center = (mins + maxs) / 2.0
    return (v - center) * scale + dim / 2.0


def voxelize(
    verts: np.ndarray,
    tris: np.ndarray,
    dim: int = 64,
    solid: bool = True,
    normalize: bool = True,
    threads: int = 0,
) -> np.ndarray:
    """Triangle mesh -> (dim, dim, dim) float32 occupancy grid."""
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    if normalize:
        verts = np.ascontiguousarray(normalize_mesh(verts, dim), np.float32)
    lib = _find_lib()
    if lib is not None:
        out = np.zeros(dim * dim * dim, np.uint8)
        lib.voxelize_mesh(
            verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(verts),
            tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(tris),
            dim,
            1 if solid else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            threads,
        )
        return out.reshape(dim, dim, dim).astype(np.float32)
    return _voxelize_numpy(verts, tris, dim, solid)


def _voxelize_numpy(verts: np.ndarray, tris: np.ndarray, dim: int, solid: bool) -> np.ndarray:
    """Fallback: z-column crossing parity (solid) / rasterized samples
    (surface). Same convention as the native path."""
    grid = np.zeros((dim, dim, dim), np.float32)
    tv = verts[tris]  # (T, 3, 3)
    # jitter keeps rays off shared triangle edges (parity correctness)
    xs = np.arange(dim) + 0.5 + 1.2345e-4
    ys = np.arange(dim) + 0.5 + 3.1713e-4
    for x_i, cx in enumerate(xs):
        # prune triangles not spanning this x slab
        span = (tv[:, :, 0].min(axis=1) <= cx + 0.5) & (tv[:, :, 0].max(axis=1) >= cx - 0.5)
        sub = tv[span]
        if len(sub) == 0:
            continue
        for y_i, cy in enumerate(ys):
            v0, v1, v2 = sub[:, 0], sub[:, 1], sub[:, 2]
            d1 = (v1[:, 0] - v0[:, 0]) * (cy - v0[:, 1]) - (v1[:, 1] - v0[:, 1]) * (cx - v0[:, 0])
            d2 = (v2[:, 0] - v1[:, 0]) * (cy - v1[:, 1]) - (v2[:, 1] - v1[:, 1]) * (cx - v1[:, 0])
            d3 = (v0[:, 0] - v2[:, 0]) * (cy - v2[:, 1]) - (v0[:, 1] - v2[:, 1]) * (cx - v2[:, 0])
            inside = ~(((d1 < 0) | (d2 < 0) | (d3 < 0)) & ((d1 > 0) | (d2 > 0) | (d3 > 0)))
            area = d1 + d2 + d3
            ok = inside & (np.abs(area) > 1e-12)
            if not ok.any():
                continue
            w0 = d2[ok] / area[ok]
            w1 = d3[ok] / area[ok]
            w2 = d1[ok] / area[ok]
            z_hits = np.sort(w0 * v0[ok, 2] + w1 * v1[ok, 2] + w2 * v2[ok, 2])
            if solid:
                for i in range(0, len(z_hits) - 1, 2):
                    za = max(0, int(np.ceil(z_hits[i] - 0.5)))
                    zb = min(dim - 1, int(np.floor(z_hits[i + 1] - 0.5)))
                    grid[x_i, y_i, za : zb + 1] = 1.0
            else:
                zi = np.clip((z_hits - 0.5).round().astype(int), 0, dim - 1)
                grid[x_i, y_i, zi] = 1.0
    return grid


def nms_native(boxes: np.ndarray, iou_thresh: float = 0.5) -> np.ndarray:
    """Host NMS via the native lib (falls back to ops.nms_indices)."""
    boxes = np.ascontiguousarray(boxes, np.float32)
    lib = _find_lib()
    if lib is None:
        from anytime3d_tpu.ops.nms import nms_indices

        keep = np.zeros(len(boxes), np.uint8)
        keep[nms_indices(boxes, iou_thresh)] = 1
        return keep.astype(bool)
    keep = np.zeros(len(boxes), np.uint8)
    lib.nms_host(
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(boxes),
        iou_thresh,
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return keep.astype(bool)


def load_off(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load an OFF mesh (the ModelNet CAD format): returns (verts, tris)."""
    with open(path) as fh:
        header = fh.readline().strip()
        if header.startswith("OFF") and len(header) > 3:
            counts = header[3:].split()
        else:
            counts = fh.readline().split()
        n_v, n_f = int(counts[0]), int(counts[1])
        verts = np.array(
            [[float(x) for x in fh.readline().split()[:3]] for _ in range(n_v)], np.float32
        )
        tris = []
        for _ in range(n_f):
            parts = [int(x) for x in fh.readline().split()]
            k = parts[0]
            poly = parts[1 : 1 + k]
            for i in range(1, k - 1):  # fan triangulation
                tris.append([poly[0], poly[i], poly[i + 1]])
    return verts, np.array(tris, np.int32)
