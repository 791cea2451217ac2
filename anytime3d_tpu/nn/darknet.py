"""Darknet image backbones and the 2D encoder head.

Reference semantics: src/net_core/darknet.py — Darknet19 (:96-133),
Darknet53 (:46-56), Darknet53Tiny (:58-81), head2D (:149-168). Differences
by design: GroupNorm, SAME-padded stride-2 convs (the reference's
asymmetric ZeroPad2D+valid trick exists only to mimic the original C darknet;
SAME gives identical receptive fields and XLA-friendlier layouts).
"""

from __future__ import annotations

from typing import Any, Sequence

import jax.numpy as jnp

from anytime3d_tpu.nn import module as nn
from anytime3d_tpu.nn.blocks import ConvBlock2D, activation, maxpool2d


class Darknet19(nn.Module):
    """YOLOv2 19-conv backbone: 448x448x3 -> 14x14x1024 (stride 32)."""

    act: str = "elu"
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x):
        conv = lambda f, k, h: ConvBlock2D(f, k, act=self.act, dtype=self.dtype)(h)
        x = conv(32, 3, x)
        x = maxpool2d(x)
        x = conv(64, 3, x)
        x = maxpool2d(x)
        x = conv(128, 3, x)
        x = conv(64, 1, x)
        x = conv(128, 3, x)
        x = maxpool2d(x)
        x = conv(256, 3, x)
        x = conv(128, 1, x)
        x = conv(256, 3, x)
        x = maxpool2d(x)
        for f, k in [(512, 3), (256, 1), (512, 3), (256, 1), (512, 3)]:
            x = conv(f, k, x)
        x = maxpool2d(x)
        for f, k in [(1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3)]:
            x = conv(f, k, x)
        return x


class _ResBlock(nn.Module):
    """1x1 bottleneck + 3x3 conv with skip (Darknet53Residual analogue)."""

    features: int
    act: str = "elu"
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x):
        h = ConvBlock2D(self.features // 2, 1, act=self.act, dtype=self.dtype)(x)
        h = ConvBlock2D(self.features, 3, act=self.act, dtype=self.dtype)(h)
        return x + h


class Darknet53(nn.Module):
    """53-conv residual backbone; returns (x_36, x_61, x) multi-scale maps."""

    act: str = "elu"
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x):
        def stage(h, features, blocks):
            h = ConvBlock2D(features, 3, strides=2, act=self.act, dtype=self.dtype)(h)
            for _ in range(blocks):
                h = _ResBlock(features, act=self.act, dtype=self.dtype)(h)
            return h

        x = ConvBlock2D(32, 3, act=self.act, dtype=self.dtype)(x)
        x = stage(x, 64, 1)
        x = stage(x, 128, 2)
        x = x_36 = stage(x, 256, 8)
        x = x_61 = stage(x, 512, 8)
        x = stage(x, 1024, 4)
        return x_36, x_61, x


class Darknet53Tiny(nn.Module):
    """7-conv tiny backbone; returns (x_8, x)."""

    act: str = "elu"
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x):
        conv = lambda f, h: ConvBlock2D(f, 3, act=self.act, dtype=self.dtype)(h)
        x = conv(16, x)
        x = maxpool2d(x)
        x = conv(32, x)
        x = maxpool2d(x)
        x = conv(64, x)
        x = maxpool2d(x)
        x = conv(128, x)
        x = maxpool2d(x)
        x = x_8 = conv(256, x)
        x = maxpool2d(x)
        x = conv(512, x)
        x = maxpool2d(x, stride=1)
        x = conv(1024, x)
        return x_8, x


class Head2D(nn.Module):
    """Conv stack + 1x1 projection (+ optional global pool) — head2D analogue.

    With ``last_pooling='max'`` this is the single-object encoder head whose
    flat output concatenates (mean, log_var) latent blocks; with
    ``last_pooling=None`` it is the fully-convolutional multi-object head.
    """

    output_dim: int
    filter_nums: Sequence[int] = (1024, 1024, 1024, 1024)
    filter_sizes: Sequence[int] = (3, 3, 3, 1)
    last_pooling: str | None = "max"
    act: str = "elu"
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x):
        for f, k in zip(self.filter_nums, self.filter_sizes):
            x = ConvBlock2D(f, k, act=self.act, dtype=self.dtype)(x)
        x = nn.Conv(self.output_dim, (1, 1), use_bias=False, dtype=self.dtype)(x)
        if self.last_pooling == "max":
            x = jnp.max(x, axis=(1, 2))
        elif self.last_pooling == "average":
            x = jnp.mean(x, axis=(1, 2))
        return x


BACKBONES = {
    "darknet19": Darknet19,
    "darknet53": Darknet53,
    "darknet53tiny": Darknet53Tiny,
}
