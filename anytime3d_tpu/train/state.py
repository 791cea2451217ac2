"""Train state: params + Adam optimizer state + step counter.

Unlike the reference (per-submodel Keras save_weights; optimizer moments and
step counter lost on resume, SURVEY.md §5 checkpointing), the full state is
one pytree, checkpointed atomically by ``anytime3d_tpu.train.checkpoint``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
import optax


@dataclasses.dataclass(frozen=True)
class TrainState:
    """A pytree: ``step``, ``params`` and ``opt_state`` are its leaves;
    ``apply_fn`` and ``tx`` are static."""

    step: jax.Array
    params: Any
    opt_state: Any
    apply_fn: Callable
    tx: optax.GradientTransformation

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)

    def apply_gradients(self, grads):
        updates, new_opt_state = self.tx.update(grads, self.opt_state, self.params)
        new_params = optax.apply_updates(self.params, updates)
        return self.replace(step=self.step + 1, params=new_params, opt_state=new_opt_state)


jax.tree_util.register_dataclass(
    TrainState,
    data_fields=["step", "params", "opt_state"],
    meta_fields=["apply_fn", "tx"],
)


def flat_adam(
    learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
) -> optax.GradientTransformation:
    """Adam over ONE contiguous flat buffer — numerically exact Adam (same
    math; only fp reassociation at the concatenate boundaries differs).

    Default off: the ravel/unravel concatenate and slice copies (108 MB each
    way on the flagship) can materialise instead of fusing into the
    per-leaf gradient producers. Its speed against per-leaf ``optax.adam``
    is not measured on the H100."""
    from jax.flatten_util import ravel_pytree

    def init(params):
        flat, _ = ravel_pytree(params)
        return {
            "m": jnp.zeros_like(flat),
            "v": jnp.zeros_like(flat),
            "count": jnp.zeros((), jnp.int32),
        }

    def update(grads, state, params=None):
        del params
        g, unravel = ravel_pytree(grads)
        count = state["count"] + 1
        m = b1 * state["m"] + (1.0 - b1) * g
        v = b2 * state["v"] + (1.0 - b2) * jnp.square(g)
        c = count.astype(m.dtype)
        m_hat = m / (1.0 - b1**c)
        v_hat = v / (1.0 - b2**c)
        upd = -learning_rate * m_hat / (jnp.sqrt(v_hat) + eps)
        return unravel(upd), {"m": m, "v": v, "count": count}

    return optax.GradientTransformation(init, update)


def create_train_state(
    model,
    sample_input,
    key: jax.Array,
    learning_rate: float = 1e-4,
    extra_init_kwargs: dict | None = None,
    flat_opt: bool = False,
) -> TrainState:
    """Initialize params with a sample input and build an Adam optimizer
    (reference default lr 1e-4, e.g. train_pascal.py:70). Uses the model's
    ``initialize`` method when present so every submodule gets params.
    ``flat_opt`` selects the flat-buffer Adam (exact same update, see
    :func:`flat_adam`); default per-leaf ``optax.adam``."""
    method = getattr(model, "initialize", None)
    params = model.init(
        {"params": key, "dropout": key},
        sample_input,
        method=method,
        **(extra_init_kwargs or {}),
    )["params"]
    tx = flat_adam(learning_rate) if flat_opt else optax.adam(learning_rate)
    return TrainState(
        step=jnp.zeros((), jnp.int32),
        params=params,
        opt_state=tx.init(params),
        apply_fn=model.apply,
        tx=tx,
    )


def grads_finite_flag(grads) -> jnp.ndarray:
    """1.0 iff every gradient leaf is finite (exact per-leaf isfinite test).

    Emitted by every train step as ``metrics['grads_finite']`` so the trainer
    can refuse to checkpoint a state whose UPDATE was poisoned even when the
    forward loss was still finite (bf16 backward-only overflow).

    Per-leaf ``jnp.all(isfinite)`` ANDed across leaves — exact semantics.
    (The earlier sum-of-squares formulation could overflow f32 on a large
    but finite gradient and falsely zero a legitimate update; ADVICE r3.)"""
    flags = [
        jnp.all(jnp.isfinite(g)) for g in jax.tree_util.tree_leaves(grads)
    ]
    ok = flags[0]
    for f in flags[1:]:
        ok = jnp.logical_and(ok, f)
    return ok.astype(jnp.float32)


def l2_penalty(params, weight: float = 5e-4) -> jax.Array:
    """Kernel L2 regularization, matching keras l2(l=5e-4) on conv/dense
    kernels (weight * sum w²). Norm scales/biases are exempt."""

    def leaf_l2(path, leaf):
        name = path[-1].key if hasattr(path[-1], "key") else str(path[-1])
        if name == "kernel":
            return jnp.sum(jnp.square(leaf))
        return jnp.zeros((), leaf.dtype)

    leaves = jax.tree_util.tree_map_with_path(leaf_l2, params)
    return weight * jax.tree_util.tree_reduce(jnp.add, leaves, jnp.zeros(()))
