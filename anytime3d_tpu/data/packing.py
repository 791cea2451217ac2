"""Bit-packed voxel transfer: 1 bit/voxel host->device, unpack on device.

A (32, 64³) float32 occupancy batch is 33.5 MB per step of host->device
traffic; bit-packed it is 1.05 MB (32×). The reference ships full float
grids every step (modelnet_dataset.py:83). Packing is np.packbits (C speed)
on the host; unpacking is a shift-and-mask inside the jitted step, fused by
XLA into the consumer.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from anytime3d_tpu.data.native import native_lib

_PACK_LIB: Optional[ctypes.CDLL] = None
_PACK_LIB_TRIED = False


def _find_pack_lib() -> Optional[ctypes.CDLL]:
    """native/libpack.so, built at first use. ANYTIME3D_PACK_LIB: a path
    overrides the default candidate (sanitizer builds); ''/'0'/'off'/'none'
    force the NumPy path (same conventions as ANYTIME3D_AUGMENT_LIB)."""
    global _PACK_LIB, _PACK_LIB_TRIED
    if _PACK_LIB_TRIED:
        return _PACK_LIB
    _PACK_LIB_TRIED = True
    env = os.environ.get("ANYTIME3D_PACK_LIB")
    if env is not None and env.strip().lower() in ("", "0", "off", "none"):
        return None
    candidates = [env or native_lib("libpack.so") or ""]
    for path in (c for c in candidates if c):
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
                lib.pack_blocked_batch.argtypes = [
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                    ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                    ctypes.c_int32, ctypes.c_int32,
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
                ]
                lib.pack_blocked_batch.restype = ctypes.c_int32
                _PACK_LIB = lib
                break
            except OSError:  # pragma: no cover
                continue
    return _PACK_LIB


def pack_voxels(vox: np.ndarray) -> np.ndarray:
    """(B, ...) occupancy (any float/bool >0.5 = occupied) -> (B, ceil(N/8))
    uint8, MSB-first within each byte."""
    b = vox.shape[0]
    flat = (np.asarray(vox).reshape(b, -1) > 0.5)
    return np.packbits(flat, axis=-1)


def pack_voxels_device(vox: jnp.ndarray, threshold: float = 0.5) -> jnp.ndarray:
    """Device-side (jit-safe) inverse of :func:`unpack_voxels`: threshold a
    (B, ...) occupancy/probability grid and pack to (B, N/8) uint8, MSB-first
    — bit-identical to host ``np.packbits``. Serving programs use this to
    return occupancies at 1 bit/voxel (32x less device->host traffic).
    N must be divisible by 8 (every voxel grid is)."""
    b = vox.shape[0]
    bits = (vox.reshape(b, -1) > threshold)
    n = bits.shape[1]
    if n % 8:
        raise ValueError(f"flat size {n} not divisible by 8")
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)  # MSB-first
    bytes_ = bits.reshape(b, n // 8, 8).astype(jnp.uint8) << shifts
    # disjoint bit positions: the sum IS the bitwise-or, overflow-free
    return jnp.sum(bytes_, axis=-1, dtype=jnp.uint8)


def unpack_voxels(
    packed: jnp.ndarray, shape: Sequence[int], dtype=jnp.float32
) -> jnp.ndarray:
    """(B, ceil(N/8)) uint8 -> (B, *shape) in {0, 1}. Device-side, jit-safe."""
    b = packed.shape[0]
    n = math.prod(shape)
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)  # MSB-first
    bits = (packed[:, :, None] >> shifts) & jnp.uint8(1)
    return bits.reshape(b, -1)[:, :n].reshape(b, *shape).astype(dtype)


def blocked_shape(shape: Sequence[int], block: int = 4) -> Tuple[int, ...]:
    """The s2d(block) coarse layout of a (D, H, W, C) grid."""
    d, h, w, c = shape
    if d % block or h % block or w % block:
        raise ValueError(f"grid {shape} not divisible by block {block}")
    return (d // block, h // block, w // block, block**3 * c)


def pack_voxels_blocked(vox: np.ndarray, block: int = 4) -> np.ndarray:
    """Pack occupancy bits in the s2d(block) coarse-layout order so the
    device-side unpack lands DIRECTLY in the blocked layout the blocked-head
    encoder consumes (channel order (bd, bh, bw, c)) — no device relayout,
    and the fine grid with its 1-wide channel dim never exists on device.

    Host cost: a fused single-pass loop in native/pack.cpp when libpack.so
    is built (threshold + blocked reorder + bit-pack — the NumPy
    formulation's 8-d float transpose is slow on the host); NumPy transpose
    + np.packbits otherwise. Both give bit-identical output
    (tests/test_packing_native.py)."""
    v = np.asarray(vox)
    if v.ndim == 4:  # (B, D, H, W) -> add channel dim
        v = v[..., None]
    B, D, H, W, C = v.shape
    b = block
    if D % b or H % b or W % b:
        raise ValueError(f"grid {(D, H, W)} not divisible by block {b}")

    lib = _find_pack_lib()
    if lib is not None:
        vf = np.ascontiguousarray(v, dtype=np.float32)
        out = np.empty((B, (D * H * W * C + 7) // 8), np.uint8)
        rc = lib.pack_blocked_batch(
            vf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int64(B), D, H, W, C, b,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            min(8, os.cpu_count() or 1),
        )
        if rc == 0:
            return out
        # invalid-arg fall-through: NumPy oracle path below

    v = v.reshape(B, D // b, b, H // b, b, W // b, b, C)
    v = v.transpose(0, 1, 3, 5, 2, 4, 6, 7)
    return pack_voxels(v.reshape(B, -1))


def unpack_voxels_blocked(
    packed: jnp.ndarray, shape: Sequence[int], block: int = 4, dtype=jnp.float32
) -> jnp.ndarray:
    """Inverse of ``pack_voxels_blocked``: (B, N/8) uint8 -> the s2d(block)
    coarse layout (B, D/b, H/b, W/b, b^3*C) of a (D, H, W, C) grid."""
    return unpack_voxels(packed, blocked_shape(shape, block), dtype=dtype)
