"""K-means over (sin, cos) Euler-angle vectors with cosine-style distance.

Reference semantics: kmeans_cosine at src/module/function.py:156-200 — used to
build orientation anchor bins for the multi-object head (frozen results at
src/dataset_loader/pascal3D.py:21-54). Re-designed as a fully vectorized
``lax.fori_loop`` fit: distance to all centres in one broadcast, centre
update via one-hot matmul, no python loops over clusters.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def sincos_distance(x: jnp.ndarray, centres: jnp.ndarray) -> jnp.ndarray:
    """Distance of points to centres: sum_a (1 - (sin·sin_c + cos·cos_c))^2.

    ``x``: (N, 2A) as [sin_0..sin_{A-1}, cos_0..cos_{A-1}]; ``centres``: (K, 2A).
    Returns (N, K). For A Euler angles the summand per angle is
    (1 - cos(theta - theta_c))^2 — zero iff the angles coincide.
    """
    a = x.shape[-1] // 2
    sx, cx = x[:, :a], x[:, a:]
    sc, cc = centres[:, :a], centres[:, a:]
    # (N, K, A) agreement term via broadcasting
    agree = sx[:, None, :] * sc[None, :, :] + cx[:, None, :] * cc[None, :, :]
    return jnp.sum(jnp.square(1.0 - agree), axis=-1)


def _fit(x: jnp.ndarray, centres: jnp.ndarray, iters: int):
    k = centres.shape[0]

    def body(_, centres):
        d = sincos_distance(x, centres)
        assign = jnp.argmin(d, axis=-1)  # (N,)
        onehot = jax.nn.one_hot(assign, k, dtype=x.dtype)  # (N, K)
        counts = jnp.sum(onehot, axis=0)  # (K,)
        sums = onehot.T @ x  # (K, D) — one matmul instead of per-cluster masking
        new = sums / jnp.maximum(counts, 1.0)[:, None]
        # keep old centre when a cluster is empty (reference behavior)
        return jnp.where(counts[:, None] > 0, new, centres)

    centres = jax.lax.fori_loop(0, iters, body, centres)
    d = sincos_distance(x, centres)
    assign = jnp.argmin(d, axis=-1)
    dist = jnp.take_along_axis(d, assign[:, None], axis=-1)[:, 0]
    return centres, assign, dist


_fit_jit = jax.jit(_fit, static_argnums=(2,))


def kmeans_sincos(
    x,
    k: int,
    max_iter: int = 100,
    nsample: int = 0,
    seed: int = 0,
):
    """Two-pass sample-then-full k-means fit (reference: function.py:193-200).

    Pass 1 fits 10 iterations on a subsample to seed centres; pass 2 fits
    ``max_iter`` on the full data. Returns (centres, assignments, distances)
    as NumPy arrays.
    """
    x = np.asarray(x, dtype=np.float32)
    n = x.shape[0]
    if nsample == 0:
        nsample = int(max(2 * np.sqrt(n), 10 * k))
    nsample = min(nsample, n)
    rng = np.random.default_rng(seed)
    sample = x[rng.choice(n, size=nsample, replace=False)]
    init = x[rng.choice(n, size=k, replace=False)]
    seeded, _, _ = _fit_jit(jnp.asarray(sample), jnp.asarray(init), 10)
    centres, assign, dist = _fit_jit(jnp.asarray(x), seeded, max_iter)
    return np.asarray(centres), np.asarray(assign), np.asarray(dist)
