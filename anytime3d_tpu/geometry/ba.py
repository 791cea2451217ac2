"""Bundle adjustment with Schur-complement reduction — the mapping/pose layer.

No reference counterpart: the reference lifts single frames geometrically
(visualizer.py:237-308) but never optimizes over time. This implements the
BASELINE.json north-star subsystem: Levenberg-Marquardt bundle adjustment
over camera poses and landmarks where the landmark block is marginalized by
the Schur complement, and the landmark dimension — the big one — shards over
the mesh 'data' axis: each shard reduces its landmarks' contributions to the
(6P × 6P) reduced camera system and one psum combines them (landmark
marginalization is embarrassingly parallel per landmark).

Design notes:
- poses are (rvec, tvec) ∈ se(3)-ish (Rodrigues rotation vector); landmarks
  are 3-vectors; observations are pixel coords under a pinhole intrinsic.
- Jacobians come from jax.jacfwd per observation, vmapped — exact, and the
  2x9 blocks stay tiny so the matrix work is the (L, P6, P6) batched outer
  products, not autodiff overhead.
- fixed observation structure: a dense (P, L) visibility mask. Absent
  observations contribute zero (masked), keeping shapes static for jit.
- gauge freedom: pose 0 is held fixed (its 6 rows/cols are pinned).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp


# ----------------------------------------------------------------- rotations

def _skew(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.array(
        [[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]]
    )


def rodrigues(rvec: jnp.ndarray) -> jnp.ndarray:
    """Rotation vector (3,) -> rotation matrix (3, 3).

    Small-angle AND autodiff safe: ||rvec|| has a 0/0 gradient at zero, so
    theta is computed from a clamped squared norm and the near-identity
    branch uses the first-order exponential I + skew(rvec) (exact gradient
    at 0). Both branches stay finite so jacfwd through jnp.where is clean."""
    sq = jnp.sum(jnp.square(rvec))
    theta = jnp.sqrt(jnp.maximum(sq, 1e-24))
    k = rvec / theta
    kx = _skew(k)
    r_full = jnp.eye(3) + jnp.sin(theta) * kx + (1.0 - jnp.cos(theta)) * (kx @ kx)
    r_small = jnp.eye(3) + _skew(rvec)
    return jnp.where(sq < 1e-12, r_small, r_full)


def project(pose: jnp.ndarray, point: jnp.ndarray, intrinsics: jnp.ndarray) -> jnp.ndarray:
    """pose (6,) = [rvec, tvec]; point (3,); intrinsics (fx, fy, cx, cy) -> (2,)."""
    r = rodrigues(pose[:3])
    pc = r @ point + pose[3:]
    fx, fy, cx, cy = intrinsics
    z = jnp.maximum(pc[2], 1e-6)
    return jnp.array([fx * pc[0] / z + cx, fy * pc[1] / z + cy])


# ----------------------------------------------------------------- BA core

@dataclasses.dataclass
class BAProblem:
    poses: jnp.ndarray  # (P, 6)
    points: jnp.ndarray  # (L, 3)
    observations: jnp.ndarray  # (P, L, 2) pixels
    mask: jnp.ndarray  # (P, L) 1.0 where observed
    intrinsics: jnp.ndarray  # (4,)


jax.tree_util.register_dataclass(
    BAProblem,
    data_fields=["poses", "points", "observations", "mask", "intrinsics"],
    meta_fields=[],
)


def _residual_and_jacobians(poses, points, observations, mask, intrinsics):
    """Per-observation residuals + Jacobians, vmapped over (P, L).

    Returns r (P, L, 2), Jp (P, L, 2, 6), Jl (P, L, 2, 3), all pre-masked."""

    def one(pose, point, obs):
        def res_fn(pose_, point_):
            return project(pose_, point_, intrinsics) - obs

        r = res_fn(pose, point)
        jp = jax.jacfwd(res_fn, argnums=0)(pose, point)
        jl = jax.jacfwd(res_fn, argnums=1)(pose, point)
        return r, jp, jl

    over_l = jax.vmap(one, in_axes=(None, 0, 0))
    over_pl = jax.vmap(over_l, in_axes=(0, None, 0))
    r, jp, jl = over_pl(poses, points, observations)
    m = mask[..., None]
    return r * m, jp * m[..., None], jl * m[..., None]


def _schur_reduce(r, jp, jl, damping):
    """Build the reduced camera system from per-observation blocks.

    Returns (S (6P, 6P), rhs (6P,), Hll (L, 3, 3), bl (L, 3), W (L, 6P, 3))
    — everything needed for back-substitution. This is the shard-local
    reduction: across landmark shards S and rhs simply ADD (psum)."""
    p, l = r.shape[0], r.shape[1]

    # pose-block Hessian (block diagonal in poses)
    hpp = jnp.einsum("plki,plkj->pij", jp, jp)  # (P, 6, 6)
    bp = -jnp.einsum("plki,plk->pi", jp, r)  # (P, 6)

    # landmark blocks
    hll = jnp.einsum("plki,plkj->lij", jl, jl) + damping * jnp.eye(3)  # (L, 3, 3)
    bl = -jnp.einsum("plki,plk->li", jl, r)  # (L, 3)
    w = jnp.einsum("plki,plkj->lpij", jp, jl)  # (L, P, 6, 3) cross blocks

    hll_inv = jnp.linalg.inv(hll)  # (L, 3, 3)
    w_flat = w.reshape(l, p * 6, 3)
    # S_j = W_j Hll_j^-1 W_j^T summed over landmarks
    whi = jnp.einsum("lab,lbc->lac", w_flat, hll_inv)  # (L, 6P, 3)
    s_corr = jnp.einsum("lab,lcb->ac", whi, w_flat)  # (6P, 6P)
    rhs_corr = jnp.einsum("lab,lb->a", whi, bl)  # (6P,)

    s = jax.scipy.linalg.block_diag(*[hpp[i] for i in range(p)]) - s_corr
    s = s + damping * jnp.eye(p * 6)
    rhs = bp.reshape(-1) - rhs_corr
    return s, rhs, hll_inv, bl, w_flat


def _apply_gauge(s, rhs, fixed_pose: int = 0):
    """Pin the first pose (gauge freedom): identity rows/cols, zero rhs."""
    n = s.shape[0]
    idx = jnp.arange(n)
    free = (idx < fixed_pose * 6) | (idx >= (fixed_pose + 1) * 6)
    s = jnp.where(free[:, None] & free[None, :], s, 0.0)
    s = s + jnp.diag(jnp.where(free, 0.0, 1.0))
    rhs = jnp.where(free, rhs, 0.0)
    return s, rhs


def ba_step(
    problem: BAProblem, damping: float = 1e-3, fix_first_pose: bool = True
) -> Tuple[BAProblem, jnp.ndarray]:
    """One LM step: Schur solve for pose updates, back-substitute landmarks.

    Returns (updated problem, mean squared residual BEFORE the step)."""
    r, jp, jl = _residual_and_jacobians(
        problem.poses, problem.points, problem.observations, problem.mask,
        problem.intrinsics,
    )
    p = problem.poses.shape[0]
    s, rhs, hll_inv, bl, w_flat = _schur_reduce(r, jp, jl, damping)
    if fix_first_pose:
        s, rhs = _apply_gauge(s, rhs)
    dp = jnp.linalg.solve(s, rhs)  # (6P,)
    # back-substitution: dl_j = Hll_j^-1 (bl_j - W_j^T dp)
    wt_dp = jnp.einsum("lab,a->lb", w_flat, dp)  # (L, 3)
    dl = jnp.einsum("lij,lj->li", hll_inv, bl - wt_dp)

    new = BAProblem(
        poses=problem.poses + dp.reshape(p, 6),
        points=problem.points + dl,
        observations=problem.observations,
        mask=problem.mask,
        intrinsics=problem.intrinsics,
    )
    n_obs = jnp.maximum(jnp.sum(problem.mask), 1.0)
    mse = jnp.sum(jnp.square(r)) / n_obs
    return new, mse


def solve(
    problem: BAProblem, iters: int = 10, damping: float = 1e-3
) -> Tuple[BAProblem, jnp.ndarray]:
    """Run ``iters`` LM steps under lax.scan; returns (problem, mse_history)."""

    def body(prob, _):
        new, mse = ba_step(prob, damping)
        return new, mse

    final, history = jax.lax.scan(body, problem, None, length=iters)
    return final, history


# ----------------------------------------------------------- distributed BA

def ba_step_sharded(problem: BAProblem, mesh, damping: float = 1e-3):
    """Landmark-sharded LM step via shard_map: each device reduces its
    landmark shard's (S, rhs) contribution; one psum over 'data' forms the
    global reduced camera system; every device solves it (replicated, tiny)
    and back-substitutes its own landmarks locally.

    Landmark count must divide mesh.shape['data']."""
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    p_num = problem.poses.shape[0]

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P("data"), P(None, "data"), P(None, "data"), P()),
        out_specs=(P(), P("data"), P()),
        check_vma=False,
    )
    def step(poses, points, observations, mask, intrinsics):
        r, jp, jl = _residual_and_jacobians(poses, points, observations, mask, intrinsics)
        s, rhs, hll_inv, bl, w_flat = _schur_reduce(r, jp, jl, damping)
        # combine shard-local reduced systems across devices
        hpp_global = jax.lax.psum(s, "data")
        rhs_global = jax.lax.psum(rhs, "data")
        # NOTE: block_diag(hpp) + damping was added per shard; renormalize
        n_shards = jax.lax.psum(jnp.ones(()), "data")
        # the per-shard S each contains the full block-diag Hpp? No — Hpp is
        # built from the shard's own observations, so the psum IS the global
        # Hpp; only the damping diag was added n_shards times:
        hpp_global = hpp_global - (n_shards - 1.0) * damping * jnp.eye(p_num * 6)
        s_g, rhs_g = _apply_gauge(hpp_global, rhs_global)
        dp = jnp.linalg.solve(s_g, rhs_g)
        wt_dp = jnp.einsum("lab,a->lb", w_flat, dp)
        dl = jnp.einsum("lij,lj->li", hll_inv, bl - wt_dp)
        n_obs = jax.lax.psum(jnp.sum(mask), "data")
        mse = jax.lax.psum(jnp.sum(jnp.square(r)), "data") / jnp.maximum(n_obs, 1.0)
        return poses + dp.reshape(p_num, 6), points + dl, mse

    new_poses, new_points, mse = step(
        problem.poses, problem.points, problem.observations, problem.mask,
        problem.intrinsics,
    )
    return (
        BAProblem(new_poses, new_points, problem.observations, problem.mask, problem.intrinsics),
        mse,
    )
