"""Sparse feature front-end: Harris corners, patch descriptors, NCC matching.

The reference has no feature pipeline — its mapping inputs (2D/3D bboxes,
orientations) come straight from the detector head (src/module/
nolbo_test.py:81-188) and are lifted to metric 3D by src/visualizer/
visualizer.py:237-308. The pose-graph / bundle-adjustment layer built here
(geometry/posegraph.py, geometry/ba.py) additionally needs raw
frame-to-frame correspondences to anchor keyframe poses, so this module
supplies them on the device:

- everything is fixed-shape (max_keypoints slots + validity masks) so the
  whole front-end compiles once under jit;
- detection is convolutions + elementwise math, descriptor matching
  is one dense ``desc_a @ desc_b.T`` correlation (a matmul) — no host loops, in
  contrast to the reference's python-loop NMS style (function.py:117-150).

All functions take/return plain arrays and are vmap-able over a batch of
frames.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = [
    "harris_response",
    "detect_keypoints",
    "extract_descriptors",
    "match_descriptors",
    "Keypoints",
    "Matches",
]


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set for one frame."""

    rowcol: jnp.ndarray  # (K, 2) int32 (row, col); 0 where invalid
    score: jnp.ndarray  # (K,) float response; -inf where invalid
    valid: jnp.ndarray  # (K,) bool


class Matches(NamedTuple):
    """Fixed-capacity correspondence set between two frames."""

    index_a: jnp.ndarray  # (K,) int32 index into keypoints of frame A
    index_b: jnp.ndarray  # (K,) int32 index into keypoints of frame B
    score: jnp.ndarray  # (K,) NCC correlation in [-1, 1]
    valid: jnp.ndarray  # (K,) bool


def _to_gray(image: jnp.ndarray) -> jnp.ndarray:
    if image.ndim == 3:
        image = jnp.mean(image, axis=-1)
    return image.astype(jnp.float32)


def _conv2(img: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """SAME 2D convolution of a single-channel image (H, W)."""
    return jax.lax.conv_general_dilated(
        img[None, :, :, None],
        kernel[:, :, None, None],
        window_strides=(1, 1),
        padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )[0, :, :, 0]


def harris_response(image: jnp.ndarray, k: float = 0.04, window: int = 5) -> jnp.ndarray:
    """Harris corner response map.

    Sobel gradients -> structure tensor box-filtered over ``window`` ->
    ``det(M) - k * trace(M)^2``. Pure conv + elementwise (VPU-friendly).
    """
    img = _to_gray(image)
    sobel = jnp.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]])
    ix = _conv2(img, sobel)
    iy = _conv2(img, sobel.T)
    box = jnp.ones((window, window)) / float(window * window)
    sxx = _conv2(ix * ix, box)
    syy = _conv2(iy * iy, box)
    sxy = _conv2(ix * iy, box)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def detect_keypoints(
    image: jnp.ndarray,
    max_keypoints: int = 256,
    nms_radius: int = 4,
    threshold: float = 1e-6,
    border: int = 8,
) -> Keypoints:
    """Top-``max_keypoints`` Harris corners after radius NMS.

    NMS = keep pixels equal to the local max over a (2r+1)^2 window
    (reduce_window max + equality test), then a single fixed-K top-k —
    no data-dependent shapes.
    """
    resp = harris_response(image)
    h, w = resp.shape
    win = 2 * nms_radius + 1
    local_max = jax.lax.reduce_window(
        resp, -jnp.inf, jax.lax.max, (win, win), (1, 1), "SAME"
    )
    rows = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    inside = (
        (rows >= border)
        & (rows < h - border)
        & (cols >= border)
        & (cols < w - border)
    )
    keep = (resp >= local_max) & (resp > threshold) & inside
    masked = jnp.where(keep, resp, -jnp.inf)
    score, flat_idx = jax.lax.top_k(masked.reshape(-1), max_keypoints)
    valid = jnp.isfinite(score)
    rc = jnp.stack([flat_idx // w, flat_idx % w], axis=-1).astype(jnp.int32)
    rc = jnp.where(valid[:, None], rc, 0)
    return Keypoints(rowcol=rc, score=score, valid=valid)


def extract_descriptors(
    image: jnp.ndarray, keypoints: Keypoints, patch: int = 8
) -> jnp.ndarray:
    """Normalized intensity-patch descriptors, (K, patch*patch).

    Each descriptor is the ``patch`` x ``patch`` window centred on the
    keypoint, zero-meaned and L2-normalized, so that a plain dot product
    between descriptors is the normalized cross-correlation (NCC) of the
    patches. Gathering is one vmapped ``dynamic_slice``.
    """
    img = _to_gray(image)
    h, w = img.shape
    half = patch // 2

    def _one(rc):
        r = jnp.clip(rc[0] - half, 0, h - patch)
        c = jnp.clip(rc[1] - half, 0, w - patch)
        return jax.lax.dynamic_slice(img, (r, c), (patch, patch)).reshape(-1)

    d = jax.vmap(_one)(keypoints.rowcol)
    d = d - jnp.mean(d, axis=-1, keepdims=True)
    norm = jnp.linalg.norm(d, axis=-1, keepdims=True)
    d = d / jnp.maximum(norm, 1e-6)
    return jnp.where(keypoints.valid[:, None], d, 0.0)


def match_descriptors(
    desc_a: jnp.ndarray,
    desc_b: jnp.ndarray,
    valid_a: jnp.ndarray,
    valid_b: jnp.ndarray,
    min_score: float = 0.7,
    ratio: float = 0.95,
) -> Matches:
    """Mutual-nearest-neighbour NCC matching with Lowe ratio test.

    One dense correlation ``desc_a @ desc_b.T`` (one matmul does all the work),
    then row/col argmax agreement. Output is fixed-shape (K_a slots).
    """
    corr = desc_a @ desc_b.T  # (Ka, Kb) NCC since descriptors are normalized
    neg = -jnp.inf
    corr = jnp.where(valid_a[:, None] & valid_b[None, :], corr, neg)

    best_b = jnp.argmax(corr, axis=1)  # (Ka,)
    best_score = jnp.max(corr, axis=1)
    # second best for the ratio test (mask out the best column per row)
    ka = desc_a.shape[0]
    row_idx = jnp.arange(ka)
    corr_wo_best = corr.at[row_idx, best_b].set(neg)
    second = jnp.max(corr_wo_best, axis=1)

    best_a_of_b = jnp.argmax(corr, axis=0)  # (Kb,)
    mutual = best_a_of_b[best_b] == row_idx

    # ratio in correlation space: distance^2 = 2 - 2*ncc for unit vectors
    d1 = jnp.sqrt(jnp.maximum(2.0 - 2.0 * best_score, 0.0))
    d2 = jnp.sqrt(jnp.maximum(2.0 - 2.0 * second, 0.0))
    passes_ratio = d1 <= ratio * jnp.maximum(d2, 1e-6)

    valid = mutual & (best_score >= min_score) & passes_ratio & valid_a
    return Matches(
        index_a=row_idx.astype(jnp.int32),
        index_b=best_b.astype(jnp.int32),
        score=jnp.where(valid, best_score, 0.0),
        valid=valid,
    )
