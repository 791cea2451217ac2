"""Named model configs — one per reference experiment (SURVEY.md §2.3 table).

Each factory returns an ``MMVAEConfig`` matching the config dict of the
corresponding reference train script (file:line cited per factory). The
reference encodes these as seven copy-pasted classes × per-script dicts; here
it is one model and a table.
"""

from __future__ import annotations

from anytime3d_tpu.models.mmvae import MMVAEConfig
from anytime3d_tpu.nn.autoencoder3d import Decoder3DConfig, Encoder3DConfig
from anytime3d_tpu.nn.heads import Head2DConfig
from anytime3d_tpu.nn.priornet import PriorNetConfig


def _decoder64(input_dim: int) -> Decoder3DConfig:
    """The shared 64³ voxel decoder used by every reference model
    (autoencoder3D.py:15-24; filters [512,256,128,64,1], strides [1,2,2,2,2])."""
    return Decoder3DConfig(
        input_dim=input_dim,
        output_shape=(64, 64, 64, 1),
        filter_nums=(512, 256, 128, 64, 1),
        filter_sizes=(4, 4, 4, 4, 4),
        strides=(1, 2, 2, 2, 2),
        act="elu",
        final_act="sigmoid",
        # blocked tail: last two stride-2 stages run at 16^3 with phase
        # channels, one depth-to-space at the end (nn/autoencoder3d.py).
        # Quality parity in a 1000-step A/B (F1 0.973 vs 0.977 classic on
        # the synthetic protocol); its speed on the H100 is not measured.
        tail_blocked=True,
    )


def _encoder3d(output_dim: int) -> Encoder3DConfig:
    """The shared 64³ voxel encoder (train_modelnet_category*.py:113-120)."""
    return Encoder3DConfig(
        output_dim=output_dim,
        filter_nums=(64, 128, 256, 512),
        filter_sizes=(4, 4, 4, 4, 4),
        strides=(2, 2, 2, 2, 1),
        final_pool="average",
        act="elu",
        final_act="none",
        # blocked head: first two stride-2 stages run at the 4x-coarse grid
        # (input space-to-depth'd 4x4x4 into channels) — no conv runs on the
        # 1-channel fine grid. See nn/autoencoder3d.py::Encoder3D.
        stem_space_to_depth=2,
        head_blocked=True,
    )


# --------------------------------------------------------------------------
# ModelNet voxel->voxel family (40 categories, z=64)
# --------------------------------------------------------------------------

def modelnet_nolbo(
    z_dim: int = 64, category_dim: int = 40, latent_dropout: bool = False
) -> MMVAEConfig:
    """NOLBO with class prior — nolboSingleObject_modelnet_category_only
    (nolbo.py:1594-1787; config train_modelnet_category.py:107-139).
    ``latent_dropout=True`` is the train_modelnet_category_dr.py variant
    (dropout flag on fit, nolbo.py:1619,1646-1648).

    Layout note (r4 A/B, RESULTS.md): this default layout (blocked
    head+tail, chosen for throughput on the previous accelerator; not
    measured on the H100) costs ~5 pts of nearest-prior category
    accuracy vs the classic decoder at matched budget — the cost is
    entirely the blocked/pixel-shuffle decoder TAIL (the blocked encoder
    head is free, measured acc 0.758 vs classic 0.744). Reconstruction
    P/R is at parity in every layout. For classification-critical
    workloads use ``modelnet_nolbo_acc``."""
    return MMVAEConfig(
        z_category_dim=z_dim,
        z_inst_dim=0,
        category_dim=category_dim,
        encoder="voxel",
        encoder3d=_encoder3d(2 * z_dim),
        decoder=_decoder64(z_dim),
        prior_category=PriorNetConfig(
            input_dim=category_dim, unit_nums=(32, z_dim), const_log_var=0.0
        ),
        variational=True,
        latent_dropout=latent_dropout,
    )


def modelnet_vae(z_dim: int = 64, latent_dropout: bool = False) -> MMVAEConfig:
    """Standard-normal-prior VAE — nolboSingleObject_modelnet_category_VAE
    (nolbo.py:1387-1592; config train_modelnet_category_VAE.py:109-131)."""
    return MMVAEConfig(
        z_category_dim=z_dim,
        z_inst_dim=0,
        encoder="voxel",
        encoder3d=_encoder3d(2 * z_dim),
        decoder=_decoder64(z_dim),
        variational=True,
        latent_dropout=latent_dropout,
    )


def modelnet_ae(z_dim: int = 64, latent_dropout: bool = False) -> MMVAEConfig:
    """Deterministic voxel AE — nolboSingleObject_modelnet_category_AE
    (nolbo.py:1206-1384; config train_modelnet_category_AE.py:109-131)."""
    return MMVAEConfig(
        z_category_dim=z_dim,
        z_inst_dim=0,
        encoder="voxel",
        encoder3d=_encoder3d(z_dim),
        decoder=_decoder64(z_dim),
        variational=False,
        latent_dropout=latent_dropout,
    )


def ae3d(z_dim: int = 16) -> MMVAEConfig:
    """The distributed voxel AE — AE3D (AE3D.py:28-128; config
    train_modelnet_AE.py:18-38). Same shape as modelnet_ae with z=16; its
    b_range input remap lives in the loss config, not the model."""
    return modelnet_ae(z_dim=z_dim)


# --------------------------------------------------------------------------
# Pascal3D+ image->voxel family (12 classes, 10 instances, Darknet19)
# --------------------------------------------------------------------------

def _pascal_head(output_dim: int) -> Head2DConfig:
    """Pascal heads are a bare 1x1 projection + global max pool
    (train_pascal.py:182-189: empty filter lists)."""
    return Head2DConfig(
        output_dim=output_dim, filter_nums=(), filter_sizes=(), last_pooling="max"
    )


def pascal_nolbo(
    z_dim: int = 16, category_dim: int = 12, inst_dim: int = 10, backbone: str = "darknet19"
) -> MMVAEConfig:
    """Dual-latent NOLBO (z = z_category ⊕ z_inst) — nolboSingleObject
    (nolbo.py:49-324; config train_pascal.py:173-214)."""
    zc = z_dim // 2
    return MMVAEConfig(
        z_category_dim=zc,
        z_inst_dim=z_dim - zc,
        category_dim=category_dim,
        inst_dim=inst_dim,
        encoder="image",
        backbone=backbone,
        head=_pascal_head(2 * z_dim),
        decoder=_decoder64(z_dim),
        prior_category=PriorNetConfig(
            input_dim=category_dim, unit_nums=(32, zc), const_log_var=0.0
        ),
        prior_inst=PriorNetConfig(
            input_dim=category_dim + inst_dim, unit_nums=(32, z_dim - zc), const_log_var=0.0
        ),
        variational=True,
    )


def pascal_category(z_dim: int = 16, category_dim: int = 12, backbone: str = "darknet19") -> MMVAEConfig:
    """Single category latent with class prior — nolboSingleObject_category_only
    (nolbo.py:984-1203; config train_pascal_category.py:173-206)."""
    return MMVAEConfig(
        z_category_dim=z_dim,
        z_inst_dim=0,
        category_dim=category_dim,
        encoder="image",
        backbone=backbone,
        head=_pascal_head(2 * z_dim),
        decoder=_decoder64(z_dim),
        prior_category=PriorNetConfig(
            input_dim=category_dim, unit_nums=(32, z_dim), const_log_var=0.0
        ),
        variational=True,
    )


def pascal_vae(z_dim: int = 16, backbone: str = "darknet19", latent_dropout: bool = False) -> MMVAEConfig:
    """Image VAE baseline — nolboSingleObject_VAE (nolbo.py:750-982; config
    train_pascal_VAE.py:173-199)."""
    return MMVAEConfig(
        z_category_dim=z_dim,
        z_inst_dim=0,
        encoder="image",
        backbone=backbone,
        head=_pascal_head(2 * z_dim),
        decoder=_decoder64(z_dim),
        variational=True,
        latent_dropout=latent_dropout,
    )


def pascal_ae(z_dim: int = 16, backbone: str = "darknet19", latent_dropout: bool = False) -> MMVAEConfig:
    """Image AE baseline — nolboSingleObject_AE (nolbo.py:541-748; config
    train_pascal_AE.py:173-199)."""
    return MMVAEConfig(
        z_category_dim=z_dim,
        z_inst_dim=0,
        encoder="image",
        backbone=backbone,
        head=_pascal_head(z_dim),
        decoder=_decoder64(z_dim),
        variational=False,
        latent_dropout=latent_dropout,
    )


# --------------------------------------------------------------------------
# KITTI image->voxel (single class, instance prior only)
# --------------------------------------------------------------------------

def kitti_inst_only(z_dim: int = 16, inst_dim: int = 10, backbone: str = "darknet19") -> MMVAEConfig:
    """Instance-prior-only NOLBO — nolboSingleObject_instOnly
    (nolbo.py:326-539; config train_kitti.py:131-164)."""
    return MMVAEConfig(
        z_category_dim=0,
        z_inst_dim=z_dim,
        inst_dim=inst_dim,
        encoder="image",
        backbone=backbone,
        head=_pascal_head(2 * z_dim),
        decoder=_decoder64(z_dim),
        prior_inst=PriorNetConfig(input_dim=inst_dim, unit_nums=(32, z_dim), const_log_var=0.0),
        variational=True,
    )


def modelnet_nolbo_acc(z_dim: int = 64, category_dim: int = 40) -> MMVAEConfig:
    """Accuracy-first flagship layout: blocked encoder HEAD (free,
    measured) + CLASSIC-parameterized decoder under the exact
    phase-decomposed lowering (blocks.py::ConvTransposeEquiv3D). The r4
    matched-budget A/B (RESULTS.md, docs/results/modelnet_nolbo_{encblocked,
    psfinal,decblocked}.json) isolated the blocked layout's ~5-pt category-
    accuracy cost to the decoder tail; this config keeps the encoder-side
    throughput win and the best measured accuracy (0.758 vs classic
    0.744 / blocked 0.686). ``mid_equiv`` + ``final_mode='transpose_equiv'``
    compute the SAME function with the SAME parameter tensors, init, and
    elementwise-Adam dynamics as the classic transposed-conv decoder
    (parity-tested in tests/test_nn.py::TestTransposeEquiv), so the
    enc_blocked accuracy evidence transfers exactly — only the lowering
    (and therefore the step time) changes. Its step time on the H100 is
    not measured.

    CHECKPOINT MIGRATION (r4): this name previously meant the classic
    lowering (``final_mode='transpose'``), whose param tree names the final
    stage ``decoder/ConvTranspose_0`` and whose data path is dense/linear-
    packed (``blocked_io_block`` None, now 4). Checkpoints saved under the
    old definition restore after renaming the decoder subtree with
    ``nn.autoencoder3d.remap_decoder_params(params['decoder'],
    src_cfg=<classic decoder>, dst_cfg=cfg.decoder)`` — the kernels are
    tensor-identical, only the stage names differ (ADVICE r4)."""
    import dataclasses

    cfg = modelnet_nolbo(z_dim=z_dim, category_dim=category_dim)
    return dataclasses.replace(
        cfg,
        decoder=dataclasses.replace(
            cfg.decoder,
            final_mode="transpose_equiv",
            tail_blocked=False,
        ),
    )


def pascal_nolbo_acc(**kw) -> MMVAEConfig:
    """Accuracy-first layout for the image->shape flagship: the shared 64³
    decoder in its CLASSIC parameterization under the exact phase-equiv
    lowering (see ``modelnet_nolbo_acc``). Evidence: the voxel-family
    matched-budget A/B (RESULTS.md) isolated the blocked tail's category-
    accuracy cost to the decoder REPARAMETERIZATION, and the decoder here
    is the same `_decoder64`; an image-family A/B has not been run —
    prefer the blocked default for throughput unless classification
    accuracy is critical. Its step time on the H100 is not measured."""
    import dataclasses

    cfg = pascal_nolbo(**kw)
    return dataclasses.replace(
        cfg,
        decoder=dataclasses.replace(
            cfg.decoder, final_mode="transpose_equiv", tail_blocked=False
        ),
    )


REGISTRY = {
    "modelnet_nolbo": modelnet_nolbo,
    "modelnet_nolbo_acc": modelnet_nolbo_acc,
    "modelnet_nolbo_dr": lambda: modelnet_nolbo(latent_dropout=True),
    "modelnet_vae": modelnet_vae,
    "modelnet_vae_dr": lambda: modelnet_vae(latent_dropout=True),
    "modelnet_ae": modelnet_ae,
    "modelnet_ae_dr": lambda: modelnet_ae(latent_dropout=True),
    "ae3d": ae3d,
    "pascal_nolbo": pascal_nolbo,
    "pascal_nolbo_acc": pascal_nolbo_acc,
    "pascal_category": pascal_category,
    "pascal_vae": pascal_vae,
    "pascal_vae_dr": lambda: pascal_vae(latent_dropout=True),
    "pascal_ae": pascal_ae,
    "pascal_ae_dr": lambda: pascal_ae(latent_dropout=True),
    "kitti_inst_only": kitti_inst_only,
}


# --------------------------------------------------------------------------
# per-variant loss hyperparameters — the other half of each experiment
# --------------------------------------------------------------------------

def _loss_table():
    """Faithful per-name LossConfig, one entry per reference fit().

    Derivation (every value read off the reference's total_loss expression):

    - ``pascal_nolbo`` (nolbo.py:119-147): scalar 50% coin then elementwise
      p=0.5 prior mix; repulsion margins 3.0*z_cat / 3.0*z_inst (class-gated
      inst); keras .losses summed -> l2 5e-4.
    - ``kitti_inst_only`` (nolbo.py:383-404): coin swaps the WHOLE prior
      vector (element prob 1.0); margin 10.0*z_inst; .losses summed.
    - ``pascal_category`` (nolbo.py:1042-1063): coin + elementwise p=0.3
      (missing_pr); margin 3.0*z; total = kl + shape + 0.01*reg — NO .losses
      term -> l2 0.
    - ``modelnet_nolbo`` (nolbo.py:1639-1666): coin + p=0.3; margin 2.0*z
      (:1661 — NOT 3.0); total = kl + shape + 0.01*reg, no l2.
    - ``pascal_vae``/``pascal_ae`` (+_dr) (nolbo.py:578-630, 795-854):
      shape (+KL vs N(0,I)) + .losses -> l2 5e-4; no priors, no mixing.
    - ``modelnet_vae``/``modelnet_ae`` (+_dr) (nolbo.py:1231-1258,
      1422-1445): shape (+KL); fit() never adds .losses -> l2 0.
    - ``ae3d`` (AE3D.py:46-48, 69-70): gamma-BCE only with b_range=False;
      encoder INPUT remapped 2x-1; no .losses -> l2 0, input_remap.
    """
    from anytime3d_tpu.train.step import LossConfig

    prior_img = LossConfig(  # pascal_nolbo
        reg_weight=1.0,
        reg_margin_scale_category=3.0,
        reg_margin_scale_inst=3.0,
        l2_weight=5e-4,
        mix_coin_prob=0.5,
        mix_element_prob=0.5,
    )
    kitti = LossConfig(
        reg_weight=1.0,
        reg_margin_scale_inst=10.0,
        l2_weight=5e-4,
        mix_coin_prob=0.5,
        mix_element_prob=1.0,  # whole-vector prior swap (nolbo.py:383-386)
    )
    pascal_cat = LossConfig(
        reg_weight=0.01,
        reg_margin_scale_category=3.0,
        l2_weight=0.0,
        mix_coin_prob=0.5,
        mix_element_prob=0.3,
    )
    modelnet_cat = LossConfig(
        reg_weight=0.01,
        reg_margin_scale_category=2.0,  # nolbo.py:1661
        l2_weight=0.0,
        mix_coin_prob=0.5,
        mix_element_prob=0.3,
    )
    img_plain = LossConfig(l2_weight=5e-4)  # pascal AE/VAE (+_dr)
    vox_plain = LossConfig(l2_weight=0.0)  # modelnet AE/VAE (+_dr)
    ae3d_loss = LossConfig(l2_weight=0.0, input_remap=True)

    return {
        "modelnet_nolbo": modelnet_cat,
        "modelnet_nolbo_acc": modelnet_cat,
        "modelnet_nolbo_dr": modelnet_cat,
        "modelnet_vae": vox_plain,
        "modelnet_vae_dr": vox_plain,
        "modelnet_ae": vox_plain,
        "modelnet_ae_dr": vox_plain,
        "ae3d": ae3d_loss,
        "pascal_nolbo": prior_img,
        "pascal_nolbo_acc": prior_img,
        "pascal_category": pascal_cat,
        "pascal_vae": img_plain,
        "pascal_vae_dr": img_plain,
        "pascal_ae": img_plain,
        "pascal_ae_dr": img_plain,
        "kitti_inst_only": kitti,
    }


def loss_config(name: str):
    """The faithful LossConfig for a REGISTRY name."""
    return _loss_table()[name]


def variant(name: str, **overrides):
    """REGISTRY entry point for training: everything needed to train ``name``
    faithfully — ``(MMVAEConfig, LossConfig)``.

    ``overrides`` forward to the config factory (e.g.
    ``category_dim=len(loader.class_index)`` when a dataset defines fewer
    classes than the reference default — the reference sizes its one-hots
    from the dataset too, pascal3D.py:21-54). Factories that take no
    kwargs raise loudly on unsupported overrides."""
    cfg = REGISTRY[name](**overrides) if overrides else REGISTRY[name]()
    return cfg, loss_config(name)
