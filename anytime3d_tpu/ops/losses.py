"""Loss functions for the multi-modal VAE family.

Reference semantics (matched numerically, re-derived in JAX):
- ``gaussian_kl``       <- kl_loss, src/module/function.py:84-98
- ``focal_binary_loss`` <- binary_loss, src/module/function.py:73-82
- ``prior_repulsion``   <- regulizer_loss, src/module/function.py:40-71

All functions are pure, batched over the leading axis, and reduce per-sample
(sum over feature dims) so callers choose the batch reduction. fp32 math: the
voxel BCE sums ~262k terms per sample, which underflows/overflows bf16.
"""

from __future__ import annotations

import jax.numpy as jnp


def gaussian_kl(
    mean: jnp.ndarray,
    log_var: jnp.ndarray,
    mean_target: jnp.ndarray,
    log_var_target: jnp.ndarray,
) -> jnp.ndarray:
    """KL( N(mean, exp(log_var)) || N(mean_target, exp(log_var_target)) ).

    Closed form, summed over the last axis:
      0.5*(lv_t - lv) + (exp(lv) + (m - m_t)^2) / (2 exp(lv_t)) - 0.5
    """
    kl = (
        0.5 * (log_var_target - log_var)
        + (jnp.exp(log_var) + jnp.square(mean - mean_target)) / (2.0 * jnp.exp(log_var_target))
        - 0.5
    )
    return jnp.sum(kl, axis=-1)


def standard_gaussian_kl(mean: jnp.ndarray, log_var: jnp.ndarray) -> jnp.ndarray:
    """KL( N(mean, exp(log_var)) || N(0, I) ) — the plain-VAE prior term."""
    return gaussian_kl(mean, log_var, jnp.zeros_like(mean), jnp.zeros_like(log_var))


def focal_binary_loss(
    pred: jnp.ndarray,
    target: jnp.ndarray,
    gamma: float = 0.6,
    b_range: bool = False,
    epsilon: float = 1e-7,
) -> jnp.ndarray:
    """Gamma-weighted binary cross-entropy over flattened voxels, per sample.

    - ``gamma`` weights occupied voxels (0.6 everywhere in the reference).
    - ``b_range`` optionally shifts targets from {0,1} to {-1,2}
      (the AE3D input remap trick, src/module/AE3D.py:69-70).
    ``pred`` holds probabilities in (0,1); they are clipped to
    [epsilon, 1-epsilon] before the log. The math runs in float32 regardless
    of input dtype: in bf16 the upper clip bound 1-1e-7 rounds to 1.0, so a
    saturated prediction yields log(0) = -inf and 0·(-inf) = NaN on occupied
    voxels (seen as loss_shape=NaN in converged bf16 eval sweeps).
    """
    b = 1.0 if b_range else 0.0
    n = pred.shape[0]
    pred = jnp.clip(
        pred.reshape(n, -1).astype(jnp.float32), epsilon, 1.0 - epsilon
    )
    target = target.reshape(n, -1).astype(jnp.float32)
    y = -b + (2.0 * b + 1.0) * target
    loss = -(gamma * y * jnp.log(pred) + (1.0 - gamma) * (1.0 - y) * jnp.log(1.0 - pred))
    return jnp.sum(loss, axis=-1)


def prior_repulsion(
    z_mean: jnp.ndarray,
    z_log_var: jnp.ndarray,
    dist_in_z_space: float,
    class_onehot: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Pairwise repulsion of prior Gaussians in latent space, per sample.

    For each ordered pair (i, j) in the batch the variance-normalized L1
    distance d_ij = sum_k |mu_i - mu_j|_k / exp(0.5 * lv_i)_k is hinged at
    ``dist_in_z_space``: pairs closer than the margin pay (d_ij - margin)^2.
    ``class_onehot`` optionally gates the penalty to same-class pairs only
    (the instance-prior case, src/module/function.py:57-67). Note i==j pairs
    contribute 0 by construction (d_ii = 0 -> penalty margin^2? No: d_ii = 0
    gives (0 - margin)^2 — the reference includes this constant diagonal term
    too; kept for parity so loss curves are comparable).
    """
    diff = jnp.abs(z_mean[:, None, :] - z_mean[None, :, :]) / jnp.exp(0.5 * z_log_var[:, None, :])
    d = jnp.sum(diff, axis=-1)  # (B, B)
    hinge = d - dist_in_z_space
    penalty = jnp.where(hinge > 0.0, 0.0, jnp.square(hinge))
    if class_onehot is not None:
        same = jnp.sum(jnp.abs(class_onehot[:, None, :] - class_onehot[None, :, :]), axis=-1)
        gate = jnp.where(same > 0.0, 0.0, 1.0)
        penalty = penalty * gate
    return jnp.sum(penalty, axis=-1)


def softmax_cross_entropy(logits: jnp.ndarray, onehot: jnp.ndarray) -> jnp.ndarray:
    """Per-sample softmax CE (classifier pretraining, src/module/classifier.py:37-41)."""
    m = jnp.max(logits, axis=-1, keepdims=True)
    shifted = logits - m
    log_p = shifted - jnp.log(jnp.sum(jnp.exp(shifted), axis=-1, keepdims=True))
    return -jnp.sum(onehot * log_p, axis=-1)
