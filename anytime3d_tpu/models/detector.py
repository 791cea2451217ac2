"""Multi-object detector-reconstructor (YOLO-style grid head + voxel decoder).

Reference semantics: src/module/nolbo_test.py:41-256. Per-cell, per-predictor
channel layout (nolbo_test.py:214-255):

  [objness 1 | bbox2D 4 (h,w,x,y) | bbox3D 3 (w,h,l) | z_mean z | z_log_var z
   | ori_sin 3 | ori_cos 3 | rad_log_var 3]

with activations sigmoid / (exp, sigmoid) / relu / identity / tanh / tanh /
identity. Re-designed: the reference's host python triple loop over
(grid_row, grid_col, predictor) (nolbo_test.py:108-134) becomes one vectorized
decode + fixed-size top-K selection + mask-based NMS, all inside jit; shape
reconstruction batches all detections × samples through the decoder at once
instead of a per-object loop (nolbo_test.py:169-178).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from anytime3d_tpu.nn import module as nn
from anytime3d_tpu.models.mmvae import MMVAEConfig  # noqa: F401  (doc cross-ref)
from anytime3d_tpu.nn.autoencoder3d import Decoder3D, Decoder3DConfig
from anytime3d_tpu.nn.darknet import BACKBONES, Head2D
from anytime3d_tpu.nn.heads import Head2DConfig
from anytime3d_tpu.ops.nms import nms
from anytime3d_tpu.ops.sampling import reparameterize


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    predictor_num: int = 5
    bbox2d_dim: int = 4
    bbox3d_dim: int = 3
    orientation_dim: int = 3
    z_inst_dim: int = 16
    predict_log_var: bool = True  # nolbo_test.py:17 uses 2*z; nolbo.py:18 uses z
    backbone: str = "darknet19"
    head_filter_nums: Tuple[int, ...] = (1024, 1024, 1024, 1024)
    head_filter_sizes: Tuple[int, ...] = (3, 3, 3, 1)
    act: str = "elu"
    decoder: Decoder3DConfig = dataclasses.field(
        default_factory=lambda: Decoder3DConfig(input_dim=16)
    )
    max_detections: int = 16  # fixed-size selection budget (jit-static)
    shape_samples: int = 32  # latent samples averaged per shape (nolbo_test.py:171)

    @property
    def channels_per_predictor(self) -> int:
        z = self.z_inst_dim * (2 if self.predict_log_var else 1)
        return 1 + self.bbox2d_dim + self.bbox3d_dim + z + 3 * self.orientation_dim

    @property
    def head_output_dim(self) -> int:
        return self.predictor_num * self.channels_per_predictor


class DetectorReconstructor(nn.Module):
    """Fully-convolutional detection head over a Darknet backbone, plus the
    shared voxel decoder for per-object shape reconstruction."""

    config: DetectorConfig
    dtype: Any = jnp.float32

    def setup(self):
        cfg = self.config
        self.backbone = BACKBONES[cfg.backbone](act=cfg.act, dtype=self.dtype)
        self.head = Head2D(
            output_dim=cfg.head_output_dim,
            filter_nums=cfg.head_filter_nums,
            filter_sizes=cfg.head_filter_sizes,
            last_pooling=None,
            act=cfg.act,
            dtype=self.dtype,
        )
        self.decoder = Decoder3D(cfg.decoder, dtype=self.dtype)

    def encode_grid(self, images) -> Dict[str, jnp.ndarray]:
        """Images (B, H, W, 3) -> activated per-predictor field dict, each
        shaped (B, gh, gw, P, ·). Field activations follow nolbo_test.py:247-255."""
        cfg = self.config
        feats = self.backbone(images)
        if isinstance(feats, tuple):
            feats = feats[-1]
        raw = self.head(feats)  # (B, gh, gw, P*C)
        b, gh, gw, _ = raw.shape
        raw = raw.reshape(b, gh, gw, cfg.predictor_num, cfg.channels_per_predictor)

        idx = 0

        def take(n):
            nonlocal idx
            out = raw[..., idx : idx + n]
            idx += n
            return out

        objness = jax.nn.sigmoid(take(1))
        bbox2d = take(cfg.bbox2d_dim)
        bbox2d = jnp.concatenate(
            [jnp.exp(bbox2d[..., :2]), jax.nn.sigmoid(bbox2d[..., 2:])], axis=-1
        )  # (h, w) exp-decoded; (x, y) cell-relative sigmoid
        bbox3d = jax.nn.relu(take(cfg.bbox3d_dim))
        z_mean = take(cfg.z_inst_dim)
        z_log_var = (
            take(cfg.z_inst_dim)
            if cfg.predict_log_var
            else jnp.zeros_like(z_mean)
        )
        ori_sin = jax.nn.tanh(take(cfg.orientation_dim))
        ori_cos = jax.nn.tanh(take(cfg.orientation_dim))
        rad_log_var = take(cfg.orientation_dim)
        return {
            "objness": objness,
            "bbox2d": bbox2d,
            "bbox3d": bbox3d,
            "z_mean": z_mean,
            "z_log_var": z_log_var,
            "ori_sin": ori_sin,
            "ori_cos": ori_cos,
            "rad_log_var": rad_log_var,
        }

    def detect(
        self,
        images,
        obj_thresh: float = 0.5,
        iou_thresh: float = 0.5,
        top_1_per_cell: bool = True,
    ) -> Dict[str, jnp.ndarray]:
        """Single-image detection (B=1): returns fixed-size padded detections.

        Output dict fields are (K, ·) with a boolean ``valid`` mask, K =
        config.max_detections. Boxes are [x_min, y_min, x_max, y_max, score]
        in normalized image coordinates (the reference's colMin/rowMin order,
        nolbo_test.py:114-126).
        """
        cfg = self.config
        fields = self.encode_grid(images)
        objness = fields["objness"][0, ..., 0]  # (gh, gw, P)
        gh, gw, p = objness.shape

        if top_1_per_cell:
            # per-cell winner takes all (nolbo_test.py:110-134 break)
            best = jnp.argmax(objness, axis=-1)  # (gh, gw)
            cell_mask = jax.nn.one_hot(best, p, dtype=bool)
            objness = jnp.where(cell_mask, objness, 0.0)

        # decode boxes for every (cell, predictor)
        rows = jax.lax.broadcasted_iota(jnp.float32, (gh, gw, p), 0)
        cols = jax.lax.broadcasted_iota(jnp.float32, (gh, gw, p), 1)
        bbox2d = fields["bbox2d"][0]  # (gh, gw, P, 4) = (h, w, x, y)
        bh, bw = bbox2d[..., 0], bbox2d[..., 1]
        bx, by = bbox2d[..., 2], bbox2d[..., 3]
        cy = (rows + by) / gh
        cx = (cols + bx) / gw
        x_min, x_max = cx - bw / 2.0, cx + bw / 2.0
        y_min, y_max = cy - bh / 2.0, cy + bh / 2.0

        flat = lambda a: a.reshape(-1, *a.shape[3:])
        scores = objness.reshape(-1)
        k = min(cfg.max_detections, scores.shape[0])
        top_scores, top_idx = jax.lax.top_k(scores, k)
        valid = top_scores > obj_thresh

        boxes = jnp.stack(
            [x_min.reshape(-1), y_min.reshape(-1), x_max.reshape(-1), y_max.reshape(-1), scores],
            axis=-1,
        )[top_idx]
        keep = nms(boxes, iou_thresh, valid=valid)
        valid = valid & keep

        out = {"bbox2d": boxes, "valid": valid}
        for name in ("bbox3d", "z_mean", "z_log_var", "ori_sin", "ori_cos", "rad_log_var"):
            out[name] = flat(fields[name][0])[top_idx]
        return out

    def reconstruct(self, key: jax.Array, z_mean, z_log_var, sample: bool = True):
        """Decode (K, z) latents into (K, D, H, W) occupancy grids, averaging
        ``shape_samples`` posterior samples per object in ONE batched decode."""
        cfg = self.config
        if not sample:
            vox = self.decoder(z_mean)
            return vox[..., 0]
        k, z = z_mean.shape
        s = cfg.shape_samples
        mean_rep = jnp.repeat(z_mean, s, axis=0)
        lv_rep = jnp.repeat(z_log_var, s, axis=0)
        latents = reparameterize(key, mean_rep, lv_rep)
        vox = self.decoder(latents)  # (K*S, D, H, W, 1)
        vox = vox.reshape(k, s, *vox.shape[1:-1])
        return jnp.mean(vox, axis=1)

    def initialize(self, images):
        """Trace every submodule (head grid + decoder) so init covers all params."""
        fields = self.encode_grid(images)
        self.decoder(jnp.zeros((1, self.config.decoder.input_dim)))
        return fields

    def __call__(self, images):
        """Jit-compile check path: grid fields for a batch of images."""
        return self.encode_grid(images)
