"""Two-view relative pose: normalized 8-point essential matrix, cheirality
disambiguation, and midpoint triangulation.

No reference counterpart — src/visualizer/visualizer.py recovers object
pose from *detector outputs* (bbox + orientation) only; frame-to-frame
camera motion is assumed known. This module closes that gap so the
pose-graph layer (geometry/posegraph.py) can be driven end-to-end from raw
images: features (geometry/features.py) -> essential matrix -> relative
pose -> pose-graph edge.

Design: every solve is a fixed-shape batched linear-algebra problem —
one (N, 9) normal-equation SVD for E, four candidate (R, t) decompositions
scored by a vmapped cheirality count, triangulation as a batched 3x3
solve. Degenerate/invalid correspondences are handled by weights, not by
shrinking arrays, so the whole estimator jits once and vmaps over frame
pairs.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

__all__ = ["TwoViewResult", "estimate_essential", "decompose_essential",
           "triangulate", "two_view_pose"]


class TwoViewResult(NamedTuple):
    rotation: jnp.ndarray  # (3, 3) camera-2-from-camera-1
    translation: jnp.ndarray  # (3,) unit norm (scale is unobservable)
    essential: jnp.ndarray  # (3, 3)
    points: jnp.ndarray  # (N, 3) triangulated points in camera-1 frame
    inlier_weight: jnp.ndarray  # (N,) weights actually used


def _normalize_points(x: jnp.ndarray, w: jnp.ndarray):
    """Hartley normalization: zero centroid, mean distance sqrt(2)."""
    wsum = jnp.maximum(jnp.sum(w), 1e-6)
    mean = jnp.sum(x * w[:, None], axis=0) / wsum
    centered = x - mean
    scale = jnp.sqrt(2.0) / jnp.maximum(
        jnp.sum(jnp.linalg.norm(centered, axis=-1) * w) / wsum, 1e-9
    )
    t = jnp.array(
        [
            [scale, 0.0, -scale * mean[0]],
            [0.0, scale, -scale * mean[1]],
            [0.0, 0.0, 1.0],
        ]
    )
    return centered * scale, t


def estimate_essential(
    pts1: jnp.ndarray, pts2: jnp.ndarray, weights: jnp.ndarray
) -> jnp.ndarray:
    """Weighted normalized 8-point algorithm.

    ``pts1``/``pts2`` are (N, 2) *calibrated* image coordinates
    (pixel coords premultiplied by K^-1). ``weights`` in [0, 1] select
    correspondences; N is static.
    """
    x1n, t1 = _normalize_points(pts1, weights)
    x2n, t2 = _normalize_points(pts2, weights)
    u1, v1 = x1n[:, 0], x1n[:, 1]
    u2, v2 = x2n[:, 0], x2n[:, 1]
    ones = jnp.ones_like(u1)
    a = jnp.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, ones], axis=-1)
    a = a * weights[:, None]
    # smallest right singular vector of A via eigh of A^T A (9x9, cheap)
    ata = a.T @ a
    _, vecs = jnp.linalg.eigh(ata)
    f = vecs[:, 0].reshape(3, 3)
    f = t2.T @ f @ t1
    # project onto the essential manifold: singular values -> (s, s, 0)
    u, s, vt = jnp.linalg.svd(f)
    s_avg = (s[0] + s[1]) / 2.0
    e = u @ jnp.diag(jnp.array([s_avg, s_avg, 0.0])) @ vt
    return e


def decompose_essential(e: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Four (R, t) candidates from E (stacked: rotations (4,3,3), ts (4,3))."""
    u, _, vt = jnp.linalg.svd(e)
    # enforce proper rotations
    u = u * jnp.sign(jnp.linalg.det(u))
    vt = vt * jnp.sign(jnp.linalg.det(vt))
    w = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    r1 = u @ w @ vt
    r2 = u @ w.T @ vt
    t = u[:, 2]
    rs = jnp.stack([r1, r1, r2, r2])
    ts = jnp.stack([t, -t, t, -t])
    return rs, ts


def triangulate(
    pts1: jnp.ndarray, pts2: jnp.ndarray, r: jnp.ndarray, t: jnp.ndarray
) -> jnp.ndarray:
    """Midpoint triangulation in camera-1 frame; (N, 3).

    Rays: d1 = (x1, y1, 1) in cam1; d2 = R^T (x2, y2, 1) from origin -R^T t.
    Solves the 2x2 closest-point system per correspondence (vmapped).
    """
    d1 = jnp.concatenate([pts1, jnp.ones_like(pts1[:, :1])], axis=-1)
    d2 = (jnp.concatenate([pts2, jnp.ones_like(pts2[:, :1])], axis=-1)) @ r  # R^T d2
    o2 = -r.T @ t

    def _mid(a_dir, b_dir):
        # min over (s, u): |s*a_dir - (o2 + u*b_dir)|^2
        aa = jnp.dot(a_dir, a_dir)
        bb = jnp.dot(b_dir, b_dir)
        ab = jnp.dot(a_dir, b_dir)
        ao = jnp.dot(a_dir, o2)
        bo = jnp.dot(b_dir, o2)
        det = aa * bb - ab * ab
        det = jnp.where(jnp.abs(det) < 1e-9, 1e-9, det)
        s = (bb * ao - ab * bo) / det
        u_ = (ab * ao - aa * bo) / det
        p1 = s * a_dir
        p2 = o2 + u_ * b_dir
        return (p1 + p2) / 2.0

    return jax.vmap(_mid)(d1, d2)


def two_view_pose(
    pts1: jnp.ndarray, pts2: jnp.ndarray, weights: jnp.ndarray
) -> TwoViewResult:
    """Full two-view solve: E -> 4 candidates -> cheirality vote -> points.

    The candidate with the most points in front of *both* cameras wins
    (weighted vote; ``lax``-free — a 4-way argmax over static candidates).
    """
    e = estimate_essential(pts1, pts2, weights)
    rs, ts = decompose_essential(e)

    def _score_and_points(r, t):
        pts = triangulate(pts1, pts2, r, t)
        z1 = pts[:, 2]
        z2 = (pts @ r.T + t)[:, 2]
        score = jnp.sum(((z1 > 0) & (z2 > 0)).astype(jnp.float32) * weights)
        return score, pts

    scores, all_pts = jax.vmap(_score_and_points)(rs, ts)
    best = jnp.argmax(scores)
    r = rs[best]
    t = ts[best]
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-9)
    return TwoViewResult(
        rotation=r,
        translation=t,
        essential=e,
        points=all_pts[best],
        inlier_weight=weights,
    )
