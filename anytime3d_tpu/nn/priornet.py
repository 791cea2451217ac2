"""Prior networks: one-hot label -> Gaussian latent prior (mean, log_var).

Reference semantics: priornet at src/net_core/priornet.py:26-59 — twin MLP
towers over (2*onehot - 1) with Dense+Norm+Dropout(0.2)+act per layer and a
linear final layer; ``const_log_var`` pins log-variance to a constant (0.0 in
every real config, e.g. train_pascal.py:205,212).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax.numpy as jnp

from anytime3d_tpu.nn import module as nn
from anytime3d_tpu.nn.blocks import activation, group_norm


@dataclasses.dataclass(frozen=True)
class PriorNetConfig:
    input_dim: int = 40
    unit_nums: Tuple[int, ...] = (64, 32, 16)  # last entry is the latent dim
    act: str = "elu"
    const_log_var: Optional[float] = 0.0
    dropout_rate: float = 0.2


class _Tower(nn.Module):
    unit_nums: Tuple[int, ...]
    act: str
    dropout_rate: float
    dtype: Any

    @nn.compact
    def __call__(self, x, deterministic: bool):
        for units in self.unit_nums[:-1]:
            x = nn.Dense(units, dtype=self.dtype)(x)
            # LayerNorm (GroupNorm degenerates on (B, C) dense outputs)
            x = nn.LayerNorm(dtype=self.dtype)(x)
            x = nn.Dropout(self.dropout_rate, deterministic=deterministic)(x)
            x = activation(self.act)(x)
        return nn.Dense(self.unit_nums[-1], dtype=self.dtype)(x)


class PriorNet(nn.Module):
    """One-hot (or concatenated one-hot) label -> (mean, log_var)."""

    config: PriorNetConfig
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, onehot, deterministic: bool = True):
        cfg = self.config
        x = 2.0 * onehot - 1.0
        mean = _Tower(cfg.unit_nums, cfg.act, cfg.dropout_rate, self.dtype, name="mean_tower")(
            x, deterministic
        )
        if cfg.const_log_var is None:
            log_var = _Tower(
                cfg.unit_nums, cfg.act, cfg.dropout_rate, self.dtype, name="log_var_tower"
            )(x, deterministic)
        else:
            log_var = jnp.full_like(mean, cfg.const_log_var)
        return mean, log_var
