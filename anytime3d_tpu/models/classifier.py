"""Image classifier for backbone pretraining.

Reference semantics: src/module/classifier.py:7-131 — Darknet backbone +
Head2D with average pooling -> class logits; softmax CE; top-1/top-5 metrics.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax.numpy as jnp

from anytime3d_tpu.nn import module as nn
from anytime3d_tpu.nn.darknet import BACKBONES, Head2D


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    num_classes: int = 1000
    backbone: str = "darknet19"
    head_filter_nums: Tuple[int, ...] = ()
    head_filter_sizes: Tuple[int, ...] = ()
    act: str = "elu"


class Classifier(nn.Module):
    config: ClassifierConfig
    dtype: Any = jnp.float32

    def setup(self):
        cfg = self.config
        self.backbone = BACKBONES[cfg.backbone](act=cfg.act, dtype=self.dtype)
        self.head = Head2D(
            output_dim=cfg.num_classes,
            filter_nums=cfg.head_filter_nums,
            filter_sizes=cfg.head_filter_sizes,
            last_pooling="average",
            act=cfg.act,
            dtype=self.dtype,
        )

    def __call__(self, images):
        feats = self.backbone(images)
        if isinstance(feats, tuple):
            feats = feats[-1]  # multi-output backbones use last map (classifier.py:78-81)
        return self.head(feats)
