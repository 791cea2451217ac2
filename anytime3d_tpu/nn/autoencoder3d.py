"""3D convolutional voxel encoder/decoder (3D-GAN style).

Reference semantics: encoder3D/decoder3D at src/net_core/autoencoder3D.py:
72-139 — the single shared voxel decoder used by every model in the
reference. Config mirrors the reference structure dicts; norm is GroupNorm.
The decoder's linear stage reshapes to (D/prod(strides))^3 x max(filters[0]/64, 8)
channels exactly as the reference computes it (autoencoder3D.py:115-120).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from anytime3d_tpu.nn import module as nn
from anytime3d_tpu.nn.blocks import (
    TRANSPOSE_MATCH_INIT,
    ConvBlock3D,
    ConvTransposeEquiv3D,
    DeconvBlock3D,
    DeconvEquivBlock3D,
    DenseBlock,
    PhaseGroupNorm,
    activation,
    depth_to_space3d,
    group_norm,
    space_to_depth3d,
)


@dataclasses.dataclass(frozen=True)
class Encoder3DConfig:
    """Mirrors the reference encoder structure dict (autoencoder3D.py:5-14)."""

    output_dim: int = 400
    filter_nums: Tuple[int, ...] = (64, 128, 256, 512)
    filter_sizes: Tuple[int, ...] = (4, 4, 4, 4, 4)
    strides: Tuple[int, ...] = (2, 2, 2, 2, 1)
    final_pool: str = "average"  # 'average' | 'max' | 'none'
    act: str = "elu"
    final_act: str = "none"  # 'sigmoid' | 'none'
    # Layout option: fold a 2x2x2 spatial block of the (typically 1-channel)
    # input into channels before the stem conv. A k=4 s=2 stem becomes k=2
    # s=1 over 8 channels — same linear map family and FLOPs, with an 8-wide
    # contraction instead of a 1-wide one. Requires stem stride divisible by
    # the block.
    stem_space_to_depth: int = 1
    # Blocked head (mirror of the decoder's blocked tail): fold the input
    # 4x4x4 into channels and run the first TWO stride-2 stages as k=2 dense
    # convs at the 4x-coarse grid (stage 1 keeps its features as 8*C phase
    # channels). Avoids the layout-hostile fine-grid convs entirely.
    # Requires strides[:2] == (2, 2); overrides stem_space_to_depth.
    head_blocked: bool = False
    # Blocked middle: express every remaining stride-2 stage as
    # s2d(2) + k=2 s=1 dense conv — the same 4-taps-per-axis linear family
    # with stride-1 tiling, AND a clean backward: stride-1 convs have no
    # zero-stuffed (input-dilated) gradient lowering.
    mid_blocked: bool = False

    @property
    def all_filters(self) -> Tuple[int, ...]:
        return tuple(self.filter_nums) + (self.output_dim,)


@dataclasses.dataclass(frozen=True)
class Decoder3DConfig:
    """Mirrors the reference decoder structure dict (autoencoder3D.py:15-24)."""

    input_dim: int = 200
    output_shape: Tuple[int, int, int, int] = (64, 64, 64, 1)
    filter_nums: Tuple[int, ...] = (512, 256, 128, 64, 1)
    filter_sizes: Tuple[int, ...] = (4, 4, 4, 4, 4)
    strides: Tuple[int, ...] = (1, 2, 2, 2, 2)
    act: str = "elu"
    final_act: str = "sigmoid"
    # Lowering of the final (usually 1-channel) layer: a stride-2 transposed
    # conv to 1 output channel has an output width of 1 AND a zero-stuffed
    # input-dilated lowering. The pixel-shuffle form (k=2 dense conv
    # emitting s^3*C channels at the coarse grid + depth-to-space) is the
    # same 2-taps-per-axis linear family. 'transpose' keeps the classic
    # lowering. 'transpose_equiv' is the EXACT phase-decomposed lowering of
    # 'transpose' (blocks.py::ConvTransposeEquiv3D): identical parameter
    # tensor, init, function, and elementwise-Adam dynamics. Which is
    # fastest on the H100 is not measured.
    final_mode: str = "pixel_shuffle"  # 'pixel_shuffle' | 'transpose' | 'transpose_equiv'
    # Blocked tail: run the last TWO stride-2 stages at the coarse grid with
    # phase channels (k=2 dense convs, 8*C then s_tot^3*C_out channels) and a
    # single depth-to-space at the very end. Removes the two largest
    # interleave relayouts of the decoder; requires strides[-2:] == (2, 2)
    # and final_mode='pixel_shuffle'.
    tail_blocked: bool = False
    # Blocked middle: every remaining stride-2 transposed conv becomes a
    # k=2 s=1 dense conv emitting 8*C phase channels + depth-to-space(2)
    # (GroupNorm/act applied AFTER the d2s at the fine grid — the exact
    # normalization statistics of the classic path). Same linear family
    # (pixel-shuffle form), stride-1 tiling, no input-dilated lowering in
    # either direction.
    mid_blocked: bool = False
    # Blocked-tail training-dynamics fixes (KERNELS.md §5 diagnosis — the
    # tail reparameterization, not the layout, costs category accuracy):
    # tail_init_match_transpose scales the two tail convs' init variance by
    # 1/8 so outputs start at the classic stride-2 transpose's std (which
    # only sums 8 of its 64 lecun-scaled taps per fine voxel);
    # tail_phase_norm replaces the tail GroupNorm's per-phase statistics
    # with the classic fine-grid statistics (blocks.py::PhaseGroupNorm).
    tail_init_match_transpose: bool = False
    tail_phase_norm: bool = False
    # Exact-equivalent middle: every k=4 s=2 transposed-conv stage runs via
    # ConvTransposeEquiv3D — the classic parameterization (same kernel
    # tensor/init/dynamics) with the phase-conv lowering. Unlike mid_blocked
    # this is NOT a reparameterization: training is classic-identical.
    mid_equiv: bool = False


def encoder_head_blocked_active(cfg: "Encoder3DConfig") -> bool:
    """True when Encoder3D will take the blocked-head path (s2d(4) stem)."""
    return (
        cfg.head_blocked
        and len(cfg.all_filters) > 2
        and cfg.strides[0] == 2
        and cfg.strides[1] == 2
    )


def decoder_tail_blocked_active(cfg: "Decoder3DConfig") -> bool:
    """True when Decoder3D will take the blocked-tail path (d2s(4) final)."""
    return (
        cfg.tail_blocked
        and cfg.final_mode == "pixel_shuffle"
        and len(cfg.filter_nums) >= 2
        and cfg.strides[-1] == 2
        and cfg.strides[-2] == 2
    )


def decoder_final_equiv_active(cfg: "Decoder3DConfig") -> bool:
    """True when Decoder3D's final stage is the exact phase-decomposed
    ConvTranspose lowering (blocks.py::ConvTransposeEquiv3D)."""
    return (
        cfg.final_mode == "transpose_equiv"
        and cfg.strides[-1] == 2
        and cfg.filter_sizes[-1] == 4
    )


def phase2_to_block4(u: jnp.ndarray, c: int) -> jnp.ndarray:
    """(B, D, H, W, 8*C) phase-2 tensor (channel order (pd, ph, pw, c)) ->
    the s2d(4)-of-the-fine-grid blocked layout (B, D/2, H/2, W/2, 64*C)
    with channel order (bd, bh, bw, c). Pure relayout: fine index
    o = 2j + p with j = 2i + q gives o = 4i + (2q + p), so the block-4
    index is b = 2q + p per axis."""
    x = space_to_depth3d(u, 2)  # channels: (qd,qh,qw),(pd,ph,pw),c
    B, D, H, W, _ = x.shape
    x = x.reshape(B, D, H, W, 2, 2, 2, 2, 2, 2, c)  # (qd,qh,qw,pd,ph,pw,c)
    x = x.transpose(0, 1, 2, 3, 4, 7, 5, 8, 6, 9, 10)  # (qd,pd,qh,ph,qw,pw,c)
    return x.reshape(B, D, H, W, 64 * c)


def _decoder_stage_names(cfg: "Decoder3DConfig") -> list:
    """Flax submodule names of the decoder's conv stages, in order, for a
    given layout config — mirrors Decoder3D.__call__'s branch structure
    (nn/module.py numbers instances per class)."""
    names, counts = [], {}

    def fresh(cls_name):
        i = counts.get(cls_name, 0)
        counts[cls_name] = i + 1
        return f"{cls_name}_{i}"

    blocked = decoder_tail_blocked_active(cfg)
    n_mid = len(cfg.filter_nums) - (2 if blocked else 1)
    for f, k, s in zip(cfg.filter_nums[:n_mid], cfg.filter_sizes[:n_mid], cfg.strides[:n_mid]):
        if cfg.mid_blocked and s == 2 and k == 4:
            names.append(fresh("Conv"))  # + GroupNorm handled by caller
        elif cfg.mid_equiv and s == 2 and k == 4:
            names.append(fresh("DeconvEquivBlock3D"))
        else:
            names.append(fresh("DeconvBlock3D"))
    if blocked:
        names.append(fresh("Conv"))
        names.append(fresh("Conv"))
        return names
    k, s = cfg.filter_sizes[-1], cfg.strides[-1]
    if cfg.final_mode == "transpose_equiv" and s == 2 and k == 4:
        names.append(fresh("ConvTransposeEquiv3D"))
    elif cfg.final_mode == "pixel_shuffle" and s > 1:
        names.append(fresh("Conv"))
    else:
        names.append(fresh("ConvTranspose"))
    return names


def remap_decoder_params(params: dict, src_cfg: "Decoder3DConfig", dst_cfg: "Decoder3DConfig") -> dict:
    """Rename a Decoder3D param subtree from the ``src_cfg`` layout to the
    ``dst_cfg`` layout, for layout pairs that share parameter TENSORS —
    i.e. classic 'transpose' <-> exact phase-equiv ('transpose_equiv' /
    ``mid_equiv``), whose kernels are identical by construction
    (blocks.py::ConvTransposeEquiv3D). Raises if a stage pair is not
    tensor-compatible (e.g. blocked/pixel-shuffle reparameterizations).

    Use case: load a classic-layout checkpoint into `configs.*_acc` (or
    back) — `train.checkpoint.graft_submodule` composability across the
    layout frontier."""
    compatible = {
        ("DeconvBlock3D", "DeconvEquivBlock3D"),
        ("DeconvEquivBlock3D", "DeconvBlock3D"),
        ("ConvTranspose", "ConvTransposeEquiv3D"),
        ("ConvTransposeEquiv3D", "ConvTranspose"),
    }
    src_names = _decoder_stage_names(src_cfg)
    dst_names = _decoder_stage_names(dst_cfg)
    if len(src_names) != len(dst_names):
        raise ValueError(f"layout stage mismatch: {src_names} vs {dst_names}")
    out = dict(params)
    for s_name, d_name in zip(src_names, dst_names):
        if s_name == d_name:
            continue
        s_cls, d_cls = s_name.rsplit("_", 1)[0], d_name.rsplit("_", 1)[0]
        if (s_cls, d_cls) not in compatible:
            raise ValueError(
                f"stages {s_name} -> {d_name} are not tensor-compatible "
                "(different parameterizations, not just lowerings)"
            )
        sub = out.pop(s_name)
        inner = {
            ("DeconvBlock3D", "DeconvEquivBlock3D"): ("ConvTranspose_0", "ConvTransposeEquiv3D_0"),
            ("DeconvEquivBlock3D", "DeconvBlock3D"): ("ConvTransposeEquiv3D_0", "ConvTranspose_0"),
        }.get((s_cls, d_cls))
        if inner is not None:
            s_inner, d_inner = inner
            conv = sub[s_inner]
            # loud failure over silent drop: ConvTransposeEquiv3D carries
            # ONLY a kernel, so a no-norm DeconvBlock3D's ConvTranspose bias
            # has no destination slot (ADVICE r4)
            extra = sorted(set(conv) - {"kernel"})
            if extra:
                raise ValueError(
                    f"stage {s_name}: leaves {extra} beyond 'kernel' have no "
                    f"counterpart in {d_inner} (use_norm=False bias?) — "
                    "remap would silently drop them"
                )
            sub = {
                d_inner: dict(conv),
                **{k: v for k, v in sub.items() if k != s_inner},
            }
        out[d_name] = sub
    return out


class Encoder3D(nn.Module):
    """Voxel grid (B, D, H, W, C) -> latent vector (B, output_dim)."""

    config: Encoder3DConfig
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, blocked_input: bool = False):
        """``blocked_input=True`` means ``x`` is already in the s2d(4) coarse
        layout (B, D/4, H/4, W/4, 64*C) — the relayout is skipped. Only valid
        on the blocked-head path; lets the train step keep the whole voxel
        round-trip at the coarse layout (the fine 64^3x1 grid is never
        materialized)."""
        cfg = self.config
        filters = cfg.all_filters
        sizes, strides = list(cfg.filter_sizes), list(cfg.strides)
        blocked = encoder_head_blocked_active(cfg)
        if blocked_input and not blocked:
            raise ValueError("blocked_input requires the blocked-head layout")
        if blocked:
            if not blocked_input:
                x = space_to_depth3d(x, 4)
            x = ConvBlock3D(filters[0] * 8, 2, 1, act=cfg.act, dtype=self.dtype)(x)
            x = ConvBlock3D(filters[1], 2, 1, act=cfg.act, dtype=self.dtype)(x)
            filters = filters[2:]
            sizes, strides = sizes[2:], strides[2:]
        else:
            b = cfg.stem_space_to_depth
            if b > 1:
                if strides[0] % b != 0:
                    raise ValueError("stem_space_to_depth must divide the stem stride")
                x = space_to_depth3d(x, b)
                sizes[0] = max(1, -(-sizes[0] // b))  # ceil-div receptive field
                strides[0] //= b
        for f, k, s in zip(filters[:-1], sizes[:-1], strides[:-1]):
            if cfg.mid_blocked and s == 2 and k == 4 and min(x.shape[1:4]) >= 2:
                # stride-2 k=4 SAME conv == k=2 s=1 conv over the s2d(2)
                # phase-folded grid (same 4-tap family; stride-1 tiling and
                # no dilated backward). The equivalence is k=4-specific —
                # any other kernel size falls through to the classic conv.
                x = space_to_depth3d(x, 2)
                x = ConvBlock3D(f, 2, 1, act=cfg.act, dtype=self.dtype)(x)
            else:
                x = ConvBlock3D(f, k, s, act=cfg.act, dtype=self.dtype)(x)
        # final conv: no norm, no activation (autoencoder3D.py:86-88)
        x = nn.Conv(
            filters[-1],
            (cfg.filter_sizes[-1],) * 3,
            strides=(cfg.strides[-1],) * 3,
            padding="SAME",
            use_bias=False,
            dtype=self.dtype,
        )(x)
        if cfg.final_pool == "average":
            x = jnp.mean(x, axis=(1, 2, 3))
        elif cfg.final_pool == "max":
            x = jnp.max(x, axis=(1, 2, 3))
        return activation(cfg.final_act)(x)


class Decoder3D(nn.Module):
    """Latent vector (B, input_dim) -> occupancy grid (B, D, H, W, C)."""

    config: Decoder3DConfig
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, z, blocked_output: bool = False):
        """``blocked_output=True`` returns the occupancy grid in the d2s(4)
        coarse layout (B, D/4, H/4, W/4, 64*C) with the final activation
        already applied — elementwise-identical to d2s(4) of the normal
        output. Only valid on the blocked-tail path; the consumer (loss,
        packing) must use the same layout."""
        cfg = self.config
        spatial = np.asarray(cfg.output_shape[:-1]) // int(np.prod(cfg.strides))
        ch = max(cfg.filter_nums[0] // 64, 8)
        x = DenseBlock(int(np.prod(spatial)) * ch, act=cfg.act, dtype=self.dtype)(z)
        x = x.reshape((z.shape[0], *spatial, ch))
        blocked = decoder_tail_blocked_active(cfg)
        if blocked_output and not (blocked or decoder_final_equiv_active(cfg)):
            raise ValueError(
                "blocked_output requires the blocked-tail or transpose_equiv layout"
            )
        n_mid = len(cfg.filter_nums) - (2 if blocked else 1)
        for f, k, s in zip(cfg.filter_nums[:n_mid], cfg.filter_sizes[:n_mid], cfg.strides[:n_mid]):
            if cfg.mid_blocked and s == 2 and k == 4:
                # stride-2 k=4 transpose == k=2 s=1 conv emitting 8*C phase
                # channels + d2s(2) (the pixel-shuffle form of final_mode,
                # applied mid-stack). Norm/act AFTER the d2s: identical
                # normalization statistics to the classic path.
                x = nn.Conv(
                    f * 8, (2, 2, 2), padding="SAME", use_bias=False,
                    dtype=self.dtype,
                )(x)
                x = depth_to_space3d(x, 2)
                x = group_norm(f, self.dtype)(x)
                x = activation(cfg.act)(x)
            elif cfg.mid_equiv and s == 2 and k == 4:
                x = DeconvEquivBlock3D(f, act=cfg.act, dtype=self.dtype)(x)
            else:
                x = DeconvBlock3D(f, k, s, act=cfg.act, dtype=self.dtype)(x)
        if blocked:
            f4 = cfg.filter_nums[-2]
            tail_init = (
                TRANSPOSE_MATCH_INIT
                if cfg.tail_init_match_transpose
                else nn.initializers.lecun_normal()
            )
            x = nn.Conv(
                f4 * 8, (2, 2, 2), padding="SAME", use_bias=False,
                kernel_init=tail_init, dtype=self.dtype,
            )(x)
            if cfg.tail_phase_norm:
                x = PhaseGroupNorm(f4, phases=8, dtype=self.dtype)(x)
            else:
                x = group_norm(f4 * 8, self.dtype)(x)
            x = activation(cfg.act)(x)
            x = nn.Conv(
                cfg.filter_nums[-1] * 64,
                (2, 2, 2),
                padding="SAME",
                use_bias=False,
                kernel_init=tail_init,
                dtype=self.dtype,
            )(x)
            if blocked_output:
                return activation(cfg.final_act)(x)
            x = depth_to_space3d(x, 4)
            return activation(cfg.final_act)(x)
        f, k, s = cfg.filter_nums[-1], cfg.filter_sizes[-1], cfg.strides[-1]
        if cfg.final_mode == "transpose_equiv" and s == 2 and k == 4:
            if blocked_output:
                # emit the standard block-4 coarse layout without ever
                # materializing the fine grid: phase-2 conv output ->
                # relayout (loss/metrics are permutation-invariant sums,
                # so this changes nothing but the layout)
                u = ConvTransposeEquiv3D(f, dtype=self.dtype)(x, phase_output=True)
                return activation(cfg.final_act)(phase2_to_block4(u, f))
            x = ConvTransposeEquiv3D(f, dtype=self.dtype)(x)
        elif cfg.final_mode == "pixel_shuffle" and s > 1:
            x = nn.Conv(
                f * s**3,
                (max(1, -(-k // s)),) * 3,
                strides=(1,) * 3,
                padding="SAME",
                use_bias=False,
                dtype=self.dtype,
            )(x)
            x = depth_to_space3d(x, s)
        else:
            x = nn.ConvTranspose(
                f,
                (k,) * 3,
                strides=(s,) * 3,
                padding="SAME",
                use_bias=False,
                dtype=self.dtype,
            )(x)
        return activation(cfg.final_act)(x)
