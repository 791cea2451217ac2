"""Shared building blocks: conv/deconv/dense + GroupNorm + activation.

Reference counterparts: Darknet53Conv/Darknet19Conv (src/net_core/darknet.py:
11-31, 83-94), conv3DEnc/conv3DDec/linearTransform (src/net_core/
autoencoder3D.py:26-70). Differences by design:

- GroupNorm replaces BatchNorm: no cross-replica batch statistics, identical
  behavior train vs eval, plays well with pjit/shard_map (SURVEY.md §7.2).
- No kernel L2 inside modules; weight decay is applied functionally by the
  train step (``anytime3d_tpu.train.step.l2_penalty``) to keep modules pure.
- Compute dtype is a parameter (bfloat16 for training); params stay float32.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp

from anytime3d_tpu.nn import module as nn

Dtype = Any


def depth_to_space3d(x: jnp.ndarray, b: int) -> jnp.ndarray:
    """(B, D, H, W, C*b^3) -> (B, D*b, H*b, W*b, C): scatter each position's
    channel blocks into a bxbxb spatial neighbourhood (inverse of
    ``space_to_depth3d``; channel order (bd, bh, bw, c))."""
    B, D, H, W, Cb = x.shape
    C = Cb // b**3
    x = x.reshape(B, D, H, W, b, b, b, C)
    x = x.transpose(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, D * b, H * b, W * b, C)


def space_to_depth3d(x: jnp.ndarray, b: int) -> jnp.ndarray:
    """(B, D, H, W, C) -> (B, D/b, H/b, W/b, C*b^3): fold each bxbxb spatial
    block into channels. Pure reshape/transpose — XLA lowers it to a relayout,
    no FLOPs."""
    B, D, H, W, C = x.shape
    x = x.reshape(B, D // b, b, H // b, b, W // b, b, C)
    x = x.transpose(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(B, D // b, H // b, W // b, b * b * b * C)

ACTIVATIONS: dict[str, Callable] = {
    "elu": jax.nn.elu,
    "relu": jax.nn.relu,
    "lrelu": lambda x: jax.nn.leaky_relu(x, negative_slope=0.1),
    "sigmoid": jax.nn.sigmoid,
    "tanh": jax.nn.tanh,
    "none": lambda x: x,
}


def activation(name: str | None) -> Callable:
    if name is None:
        return ACTIVATIONS["none"]
    return ACTIVATIONS[str(name).lower()]


def _num_groups(channels: int, max_groups: int = 32) -> int:
    """Largest divisor of ``channels`` that is <= max_groups."""
    g = min(max_groups, channels)
    while channels % g != 0:
        g -= 1
    return g


def group_norm(channels: int, dtype: Dtype = jnp.float32) -> nn.GroupNorm:
    return nn.GroupNorm(num_groups=_num_groups(channels), dtype=dtype, epsilon=1e-5)


class ConvBlock2D(nn.Module):
    """Conv2D (no bias) + GroupNorm + activation."""

    features: int
    kernel_size: int = 3
    strides: int = 1
    act: str = "elu"
    use_norm: bool = True
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        x = nn.Conv(
            self.features,
            (self.kernel_size, self.kernel_size),
            strides=(self.strides, self.strides),
            padding="SAME",
            use_bias=not self.use_norm,
            dtype=self.dtype,
        )(x)
        if self.use_norm:
            x = group_norm(self.features, self.dtype)(x)
            x = activation(self.act)(x)
        return x


class ConvBlock3D(nn.Module):
    """Conv3D (no bias) + GroupNorm + activation (conv3DEnc analogue)."""

    features: int
    kernel_size: int = 4
    strides: int = 2
    act: str = "elu"
    use_norm: bool = True
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        x = nn.Conv(
            self.features,
            (self.kernel_size,) * 3,
            strides=(self.strides,) * 3,
            padding="SAME",
            use_bias=not self.use_norm,
            dtype=self.dtype,
        )(x)
        if self.use_norm:
            x = group_norm(self.features, self.dtype)(x)
            x = activation(self.act)(x)
        return x


class PhaseGroupNorm(nn.Module):
    """GroupNorm over a phase-folded tensor with the CLASSIC fine-grid
    statistics (KERNELS.md §5 dynamics diagnosis; VERDICT r4 weak #1).

    The blocked decoder tail keeps stage outputs at the coarse grid with
    channels ordered (phase, c) — phase slowest, the ``depth_to_space3d``
    convention. Plain contiguous-channel GroupNorm there forms groups of
    (single phase, channel slice): per-phase statistics, which the classic
    path never computes. This module normalizes group g over
    (spatial × ALL phases × channel slice) — exactly the element set the
    classic ``group_norm(features)`` pools at the fine grid after d2s —
    with per-channel scale/bias shared across phases, matching the classic
    parameter count (one affine pair per fine channel). Statistics in f32.
    """

    features: int  # fine-grid channel count C (kernel emits phases*C)
    phases: int = 8  # folded block volume (2^3 for one stride-2 stage)
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        B, D, H, W, C = x.shape
        f = self.features
        assert C == self.phases * f, (C, self.phases, f)
        g = _num_groups(f)
        xr = x.astype(jnp.float32).reshape(B, D, H, W, self.phases, g, f // g)
        mean = xr.mean(axis=(1, 2, 3, 4, 6), keepdims=True)
        var = xr.var(axis=(1, 2, 3, 4, 6), keepdims=True)
        xn = (xr - mean) * jax.lax.rsqrt(var + 1e-5)
        scale = self.param("scale", nn.initializers.ones, (f,), jnp.float32)
        bias = self.param("bias", nn.initializers.zeros, (f,), jnp.float32)
        xn = xn.reshape(B, D, H, W, self.phases, f) * scale + bias
        return xn.reshape(B, D, H, W, C).astype(self.dtype)


# The stride-2 SAME ConvTranspose init quirk the blocked tail must match:
# lecun-normal draws per-tap std 1/sqrt(k^3*Cin), but stride-2 decimation
# means each FINE output only sums (k/2)^3*Cin taps, so the classic stage's
# outputs start at std 1/sqrt(8) of unit. A k=2 dense conv at the coarse
# grid sums its whole 8*Cin fan-in into every output (std 1) — scale its
# init variance by 1/8 to reproduce the classic starting point.
TRANSPOSE_MATCH_INIT = nn.initializers.variance_scaling(
    1.0 / 8.0, "fan_in", "truncated_normal"
)


class DeconvBlock3D(nn.Module):
    """ConvTranspose3D (no bias) + GroupNorm + activation (conv3DDec analogue)."""

    features: int
    kernel_size: int = 4
    strides: int = 2
    act: str = "elu"
    use_norm: bool = True
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        x = nn.ConvTranspose(
            self.features,
            (self.kernel_size,) * 3,
            strides=(self.strides,) * 3,
            padding="SAME",
            use_bias=not self.use_norm,
            dtype=self.dtype,
        )(x)
        if self.use_norm:
            x = group_norm(self.features, self.dtype)(x)
            x = activation(self.act)(x)
        return x


def conv_transpose_equiv_kernel(kernel: jnp.ndarray) -> jnp.ndarray:
    """Embed a (4,4,4,Cin,Cout) stride-2 SAME ConvTranspose kernel into the
    (3,3,3,Cin,8*Cout) zero-structured phase-conv kernel of its exact
    decomposition.

    Derivation (1D, validated numerically against nn.ConvTranspose): with
    SAME padding, y[2i+p] = K[p]*x[i-1+p] + K[p+2]*x[i+p] — output phase p
    is a 2-tap conv with taps K[2t+p] whose window is offset by p. A k=3
    SAME conv covers both alignments in ONE dense conv (phase p occupies
    tap positions {p, p+1}; the remaining taps are structural zeros), so
    every shape stays power-of-two: no odd-size intermediates, and the
    interleave back to the fine grid is a standard depth_to_space. The
    entries are a scatter (permutation) of the ConvTranspose kernel — no
    new parameters, no re-scaling; the 27/8 structural-zero FLOP overhead
    only matters at large Cin*Cout (use on the 1-channel final stage,
    where it is negligible)."""
    kd, kh, kw, cin, cout = kernel.shape
    assert kd == kh == kw == 4, "equiv decomposition is k=4 s=2 specific"
    k3 = jnp.zeros((3, 3, 3, cin, 8 * cout), kernel.dtype)
    for pd in (0, 1):
        for ph in (0, 1):
            for pw in (0, 1):
                i = (pd * 2 + ph) * 2 + pw
                # phase (pd,ph,pw) is a 2-tap-per-axis conv with taps
                # K[2t+p] occupying k=3 positions t+p — overlapping writes
                # land in disjoint channel blocks.
                k3 = k3.at[
                    pd : pd + 2, ph : ph + 2, pw : pw + 2, :, i * cout : (i + 1) * cout
                ].set(kernel[pd::2, ph::2, pw::2])
    return k3


class ConvTransposeEquiv3D(nn.Module):
    """Exact phase-decomposed lowering of ``nn.ConvTranspose(features,
    (4,4,4), strides=(2,2,2), padding='SAME', use_bias=False)``.

    Computes a zero-structured k=3 SAME conv over the coarse grid emitting
    8*features phase channels, then one depth_to_space(2) back to the fine
    grid. The parameter tensor has the SAME shape (4,4,4,Cin,Cout) and
    initializer as the classic ConvTranspose kernel and the function is
    identical, so the loss surface and elementwise-Adam dynamics match the
    classic layout exactly: this is a lowering choice, not a
    reparameterization. The phase form keeps the contraction 8*Cout wide
    at the coarse grid and is stride-1 in both directions, where
    conv_transpose has an output width of Cout and an input-dilated
    backward (docs/KERNELS.md §5). Which lowering is faster on the GPU is
    not measured."""

    features: int
    use_bias: bool = False
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x, phase_output: bool = False):
        """``phase_output=True`` skips the final depth_to_space and returns
        the (B, D, H, W, 8*Cout) phase tensor (channel order (pd, ph, pw, c)
        — d2s(2) of it is the normal output). Lets a blocked-loss consumer
        avoid materializing the fine grid; bias is not supported there."""
        cin = x.shape[-1]
        kernel = self.param(
            "kernel",
            nn.initializers.lecun_normal(),
            (4, 4, 4, cin, self.features),
            jnp.float32,
        )
        kp = conv_transpose_equiv_kernel(kernel)
        x, kp = nn.promote_dtype(x, kp, dtype=self.dtype)
        u = jax.lax.conv_general_dilated(
            x,
            kp,
            window_strides=(1, 1, 1),
            padding="SAME",
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        )  # (B, D, H, W, 8*Cout), phase order (pd, ph, pw, c)
        co = self.features
        if phase_output:
            assert not self.use_bias, "phase_output does not support bias"
            return u
        y = depth_to_space3d(u, 2)
        if self.use_bias:
            bias = self.param("bias", nn.initializers.zeros, (co,), jnp.float32)
            y = y + bias.astype(y.dtype)
        return y


class DeconvEquivBlock3D(nn.Module):
    """DeconvBlock3D with the exact phase-decomposed lowering (k=4 s=2 only).
    Norm/activation run AFTER the interleave at the fine grid — identical
    normalization statistics to the classic block."""

    features: int
    act: str = "elu"
    use_norm: bool = True
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        x = ConvTransposeEquiv3D(
            self.features, use_bias=not self.use_norm, dtype=self.dtype
        )(x)
        if self.use_norm:
            x = group_norm(self.features, self.dtype)(x)
            x = activation(self.act)(x)
        return x


class DenseBlock(nn.Module):
    """Flatten + Dense + LayerNorm + activation (linearTransform analogue).

    LayerNorm, not GroupNorm: on a (B, C) tensor GroupNorm's per-group
    normalization degenerates (singleton groups normalize to zero), while
    LayerNorm normalizes over the full feature axis.
    """

    features: int
    act: str = "elu"
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        x = x.reshape((x.shape[0], -1))
        x = nn.Dense(self.features, dtype=self.dtype)(x)
        x = nn.LayerNorm(dtype=self.dtype)(x)
        return activation(self.act)(x)


def maxpool2d(x, window: int = 2, stride: int = 2):
    return nn.max_pool(x, (window, window), strides=(stride, stride), padding="SAME")
