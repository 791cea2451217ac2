"""MultiModalVAE — the single configurable model covering every reference
variant (SURVEY.md §2.3): the seven nolbo.py classes and AE3D.

Reference call sites: src/module/nolbo.py:49-1787, src/module/AE3D.py:28-128.
One config axis per reference variant:

- ``encoder='image'|'voxel'``      Darknet backbone+Head2D  vs  Encoder3D
- ``variational=True|False``       VAE posterior            vs  deterministic AE
- ``z_category_dim>0``             dual latent split (category ⊕ instance)
- ``prior_category/prior_inst``    label-conditioned Gaussian priors (NOLBO)
  vs None (plain N(0,I) VAE or AE)
- ``latent_dropout``               the `_dr` variants' random-rate dropout

The module is pure: all RNG comes in through method arguments; losses and
train steps live in ``anytime3d_tpu.train.step``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp

from anytime3d_tpu.nn import module as nn
from anytime3d_tpu.nn.autoencoder3d import Decoder3D, Decoder3DConfig, Encoder3D, Encoder3DConfig
from anytime3d_tpu.nn.darknet import BACKBONES, Head2D
from anytime3d_tpu.nn.heads import Head2DConfig
from anytime3d_tpu.nn.priornet import PriorNet, PriorNetConfig


@dataclasses.dataclass(frozen=True)
class MMVAEConfig:
    # latent layout
    z_category_dim: int = 0  # 0 => no category/instance split
    z_inst_dim: int = 16
    # label spaces (0 => modality absent)
    category_dim: int = 0
    inst_dim: int = 0
    # encoder modality
    encoder: str = "voxel"  # 'image' | 'voxel'
    backbone: str = "darknet19"
    head: Optional[Head2DConfig] = None
    encoder3d: Optional[Encoder3DConfig] = None
    decoder: Decoder3DConfig = dataclasses.field(default_factory=Decoder3DConfig)
    # priors: None => standard-normal prior (VAE) / no prior (AE)
    prior_category: Optional[PriorNetConfig] = None
    prior_inst: Optional[PriorNetConfig] = None
    # behavior flags
    variational: bool = True
    latent_dropout: bool = False  # `_dr` variants (nolbo.py:586-588,1237-1239)
    # decoder-input prior mixing is a TRAINING behavior and lives in
    # train.step.LossConfig (mix_coin_prob / mix_element_prob)
    log_var_clip: float = 10.0  # encoder log-var clip (nolbo.py:104,108)

    @property
    def z_dim(self) -> int:
        return self.z_category_dim + self.z_inst_dim

    @property
    def enc_output_dim(self) -> int:
        mult = 2 if self.variational else 1
        return mult * self.z_dim


@dataclasses.dataclass
class EncoderOutput:
    """Posterior blocks. For AE variants log_var fields are None."""

    mean_category: Optional[jnp.ndarray]
    log_var_category: Optional[jnp.ndarray]
    mean_inst: jnp.ndarray
    log_var_inst: Optional[jnp.ndarray]

    @property
    def mean(self) -> jnp.ndarray:
        if self.mean_category is None:
            return self.mean_inst
        return jnp.concatenate([self.mean_category, self.mean_inst], axis=-1)

    @property
    def log_var(self) -> Optional[jnp.ndarray]:
        if self.log_var_inst is None:
            return None
        if self.log_var_category is None:
            return self.log_var_inst
        return jnp.concatenate([self.log_var_category, self.log_var_inst], axis=-1)


jax.tree_util.register_dataclass(
    EncoderOutput,
    data_fields=["mean_category", "log_var_category", "mean_inst", "log_var_inst"],
    meta_fields=[],
)


def decoder_blocked_block(cfg: MMVAEConfig) -> Optional[int]:
    """Block size (4) when the DECODER alone can emit the coarse d2s layout,
    regardless of encoder modality. TWO layouts qualify: the blocked tail
    (``tail_blocked``) and the exact phase-equiv final stage
    (``final_mode='transpose_equiv'``, whose phase output relayouts to the
    same block-4 coarse layout via ``phase2_to_block4``) — so the acc
    configs' train/bench IO path is packed-blocked too. Image->shape
    training uses this to run the voxel loss in the blocked layout: the decoder's
    final d2s relayout AND the fine-grid 1-channel elementwise loss are both
    skipped — the loss/P-R are sums of
    elementwise terms, so the layout permutation changes no metric."""
    from anytime3d_tpu.nn.autoencoder3d import (
        decoder_final_equiv_active,
        decoder_tail_blocked_active,
    )

    if not (
        decoder_tail_blocked_active(cfg.decoder)
        or decoder_final_equiv_active(cfg.decoder)
    ):
        return None
    if any(s % 4 for s in cfg.decoder.output_shape[:-1]):
        return None
    return 4


def blocked_io_block(cfg: MMVAEConfig) -> Optional[int]:
    """Block size (4) when the voxel round-trip of ``cfg`` can stay in the
    coarse s2d/d2s layout end-to-end, else None (see
    MultiModalVAE.blocked_io_block)."""
    from anytime3d_tpu.nn.autoencoder3d import encoder_head_blocked_active

    if cfg.encoder != "voxel" or cfg.encoder3d is None:
        return None
    if not encoder_head_blocked_active(cfg.encoder3d):
        return None
    return decoder_blocked_block(cfg)


class MultiModalVAE(nn.Module):
    """Multi-modal VAE with a shared Gaussian latent across image / voxel /
    label modalities. Submodule names (``backbone``, ``head``, ``encoder3d``,
    ``decoder``, ``prior_category``, ``prior_inst``) define the checkpoint
    subtrees, preserving the reference's cross-experiment composability
    (train_pascal.py:222-225)."""

    config: MMVAEConfig
    dtype: Any = jnp.float32

    def setup(self):
        cfg = self.config
        if cfg.encoder == "image":
            head_cfg = cfg.head or Head2DConfig(output_dim=cfg.enc_output_dim)
            self.backbone = BACKBONES[cfg.backbone](act=head_cfg.act, dtype=self.dtype)
            self.head = Head2D(
                output_dim=head_cfg.output_dim,
                filter_nums=head_cfg.filter_nums,
                filter_sizes=head_cfg.filter_sizes,
                last_pooling=head_cfg.last_pooling,
                act=head_cfg.act,
                dtype=self.dtype,
            )
        else:
            enc_cfg = cfg.encoder3d or Encoder3DConfig(output_dim=cfg.enc_output_dim)
            self.encoder3d = Encoder3D(enc_cfg, dtype=self.dtype)
        self.decoder = Decoder3D(cfg.decoder, dtype=self.dtype)
        if cfg.prior_category is not None:
            self.prior_category = PriorNet(cfg.prior_category, dtype=self.dtype)
        if cfg.prior_inst is not None:
            self.prior_inst = PriorNet(cfg.prior_inst, dtype=self.dtype)

    # ------------------------------------------------------------------ encode
    @property
    def blocked_io_block(self) -> Optional[int]:
        """Block size (4) when the voxel round-trip can stay in the coarse
        s2d/d2s layout end-to-end (blocked-head encoder + blocked-tail
        decoder on the same grid), else None. Used by the train step to skip
        every fine-grid relayout — see train/step.py."""
        return blocked_io_block(self.config)

    @property
    def decoder_block(self) -> Optional[int]:
        """Block size (4) when the decoder alone can emit the coarse d2s
        layout — lets image->shape steps run the voxel loss blocked even
        though the encoder consumes images (see decoder_blocked_block)."""
        return decoder_blocked_block(self.config)

    def encode(self, x, blocked_input: bool = False) -> EncoderOutput:
        """Image or voxel input -> posterior blocks.

        Channel layout of the flat encoder output matches the reference
        (nolbo.py:101-108): [mean_cat | log_var_cat | mean_inst | log_var_inst]
        for variational dual-latent; [mean | log_var] single-latent;
        plain z for AE variants.
        """
        cfg = self.config
        if cfg.encoder == "image":
            feats = self.backbone(x)
            if isinstance(feats, tuple):
                feats = feats[-1]  # multi-output backbones use the last map
            out = self.head(feats)
        else:
            out = self.encoder3d(x, blocked_input=blocked_input)

        clip = cfg.log_var_clip
        if not cfg.variational:
            if cfg.z_category_dim > 0:
                return EncoderOutput(out[..., : cfg.z_category_dim], None,
                                     out[..., cfg.z_category_dim :], None)
            return EncoderOutput(None, None, out, None)

        if cfg.z_category_dim > 0:
            zc, zi = cfg.z_category_dim, cfg.z_inst_dim
            mean_c = out[..., :zc]
            lv_c = jnp.clip(out[..., zc : 2 * zc], -clip, clip)
            mean_i = out[..., 2 * zc : 2 * zc + zi]
            lv_i = jnp.clip(out[..., 2 * zc + zi :], -clip, clip)
            return EncoderOutput(mean_c, lv_c, mean_i, lv_i)
        zi = cfg.z_inst_dim
        mean_i = out[..., :zi]
        lv_i = jnp.clip(out[..., zi:], -clip, clip)
        return EncoderOutput(None, None, mean_i, lv_i)

    # ------------------------------------------------------------------ decode
    def decode(self, z, blocked_output: bool = False):
        return self.decoder(z, blocked_output=blocked_output)

    # ------------------------------------------------------------------ priors
    def priors_category(self, category_onehot, deterministic: bool = True):
        return self.prior_category(category_onehot, deterministic=deterministic)

    def priors_inst(self, inst_onehot, deterministic: bool = True):
        """Instance prior input is concat(category_onehot, inst_onehot) in the
        dual-latent model (nolbo.py:96-97); callers build the concatenation."""
        return self.prior_inst(inst_onehot, deterministic=deterministic)

    # ------------------------------------------------------------------ init
    def initialize(self, x):
        """Trace every submodule once so ``model.init`` creates all params
        (``__call__`` alone would skip the prior networks)."""
        cfg = self.config
        out = self.__call__(x)
        if cfg.prior_category is not None:
            self.prior_category(jnp.zeros((1, cfg.prior_category.input_dim)))
        if cfg.prior_inst is not None:
            self.prior_inst(jnp.zeros((1, cfg.prior_inst.input_dim)))
        return out

    # ------------------------------------------------------------------ forward
    def __call__(self, x, key: Optional[jax.Array] = None):
        """Posterior-mean autoencode (jit-compile check / inference path)."""
        enc = self.encode(x)
        z = enc.mean
        if key is not None and enc.log_var is not None:
            eps = jax.random.normal(key, z.shape, dtype=z.dtype)
            z = z + jnp.exp(0.5 * enc.log_var) * eps
        return self.decode(z)
