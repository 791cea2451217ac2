"""Network cores on the in-repo module layer (``nn.module``). Reference
semantics: src/net_core/ (darknet.py, autoencoder3D.py, priornet.py) —
re-designed: GroupNorm instead of BatchNorm (no cross-replica batch
statistics under sharded jit; SURVEY.md §7.2), channels-last layouts,
bfloat16-friendly compute dtype plumbing.
"""

from anytime3d_tpu.nn.blocks import (
    ConvBlock2D,
    ConvBlock3D,
    ConvTransposeEquiv3D,
    DeconvBlock3D,
    DeconvEquivBlock3D,
    DenseBlock,
    group_norm,
)
from anytime3d_tpu.nn.darknet import Darknet19, Darknet53, Darknet53Tiny, Head2D
from anytime3d_tpu.nn.autoencoder3d import (
    Encoder3D,
    Decoder3D,
    Encoder3DConfig,
    Decoder3DConfig,
    remap_decoder_params,
)
from anytime3d_tpu.nn.priornet import PriorNet, PriorNetConfig
from anytime3d_tpu.nn.heads import Head2DConfig

__all__ = [
    "ConvBlock2D",
    "ConvBlock3D",
    "ConvTransposeEquiv3D",
    "DeconvBlock3D",
    "DeconvEquivBlock3D",
    "remap_decoder_params",
    "DenseBlock",
    "group_norm",
    "Darknet19",
    "Darknet53",
    "Darknet53Tiny",
    "Head2D",
    "Head2DConfig",
    "Encoder3D",
    "Decoder3D",
    "Encoder3DConfig",
    "Decoder3DConfig",
    "PriorNet",
    "PriorNetConfig",
]
