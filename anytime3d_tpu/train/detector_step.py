"""Multi-object detector training: YOLO-grid loss + per-object shape ELBO.

The reference ships multi-object INFERENCE only (nolbo_test.py) — its
training path was never released (the multi-object config at nolbo.py:8-47
has no consuming class). This implements it, completing the KITTI in-the-wild
path: grid targets come from data.pascal3d.build_grid_targets /
Pascal3DMultiObjectLoader; the loss follows the YOLO-v2 recipe the head
layout implies (objness BCE, responsible-cell bbox regression, orientation
sin/cos regression with predicted von-Mises-style log-var weighting, latent
KL against the instance prior) — each term cites the activation that shapes
it (nolbo_test.py:247-255).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import jax
import jax.numpy as jnp

from anytime3d_tpu.models.detector import DetectorReconstructor
from anytime3d_tpu.ops import focal_binary_loss, gaussian_kl, voxel_tp_fp_fn
from anytime3d_tpu.ops.sampling import reparameterize
from anytime3d_tpu.train.state import TrainState, l2_penalty
from anytime3d_tpu.train.step import apply_gradients_if_finite


@dataclasses.dataclass(frozen=True)
class DetectorLossConfig:
    lambda_obj: float = 1.0
    lambda_noobj: float = 0.5
    lambda_bbox: float = 5.0
    lambda_ori: float = 1.0
    lambda_bbox3d: float = 1.0
    lambda_shape: float = 1.0
    lambda_kl: float = 0.1
    gamma: float = 0.6
    l2_weight: float = 5e-4
    shape_decode_per_image: int = 4  # decode budget: objects per image per step


def detector_losses(
    model: DetectorReconstructor,
    cfg: DetectorLossConfig,
    params,
    batch: Dict[str, jnp.ndarray],
    key: jax.Array,
):
    """Batch fields: ``images`` (B, H, W, 3); grid targets ``objness``
    (B, gh, gw, P, 1), ``bbox`` (h, w, x, y), ``sin``/``cos`` (…, 3);
    ``voxels`` (B, S, D, D, D, 1) per-image shape slots and ``voxel_slot``
    (B, gh, gw, P) int32 indices into them (-1 = empty).

    Compact transfer forms (dispatch outrunning a thin host->device link
    retains every in-flight batch host-side): ``images`` may be
    uint8 (normalized in-graph) and ``voxels`` may arrive bit-packed as
    ``voxels_packed`` (B, S, prod(grid)/8) uint8 (32x smaller; grid shape
    comes from the model's decoder config)."""
    if "voxels_packed" in batch:
        from anytime3d_tpu.data.packing import unpack_voxels

        grid = model.config.decoder.output_shape
        pk = batch["voxels_packed"]
        vox = unpack_voxels(
            pk.reshape(-1, pk.shape[-1]), grid
        ).reshape(pk.shape[0], pk.shape[1], *grid)
        batch = {k: v for k, v in batch.items() if k != "voxels_packed"}
        batch["voxels"] = vox
    if batch["images"].dtype == jnp.uint8:
        batch = dict(batch, images=batch["images"].astype(jnp.float32) / 255.0)
    fields = model.apply({"params": params}, batch["images"])
    obj_t = batch["objness"]
    mask = obj_t[..., 0]  # (B, gh, gw, P)
    n_obj = jnp.maximum(jnp.sum(mask), 1.0)
    metrics: Dict[str, jnp.ndarray] = {}

    # ---- objectness: BCE, weighted between object/empty cells
    p_obj = jnp.clip(fields["objness"][..., 0].astype(jnp.float32), 1e-6, 1 - 1e-6)
    bce = -(mask * jnp.log(p_obj) + (1.0 - mask) * jnp.log(1.0 - p_obj))
    w = cfg.lambda_obj * mask + cfg.lambda_noobj * (1.0 - mask)
    loss_obj = jnp.sum(w * bce) / mask.size
    metrics["loss_obj"] = loss_obj

    # ---- bbox: (h, w) in log space (head exp-decodes), (x, y) direct
    pred_hw = jnp.log(jnp.clip(fields["bbox2d"][..., :2].astype(jnp.float32), 1e-6, None))
    tgt_hw = jnp.log(jnp.clip(batch["bbox"][..., :2], 1e-6, None))
    pred_xy = fields["bbox2d"][..., 2:].astype(jnp.float32)
    tgt_xy = batch["bbox"][..., 2:]
    se = jnp.sum(jnp.square(pred_hw - tgt_hw) + jnp.square(pred_xy - tgt_xy), axis=-1)
    loss_bbox = cfg.lambda_bbox * jnp.sum(mask * se) / n_obj
    metrics["loss_bbox"] = loss_bbox

    # ---- orientation: heteroscedastic regression on (sin, cos) with the
    # predicted rad_log_var as per-angle uncertainty (Gaussian NLL form)
    lv = jnp.clip(fields["rad_log_var"].astype(jnp.float32), -6.0, 6.0)
    err = (
        jnp.square(fields["ori_sin"].astype(jnp.float32) - batch["sin"])
        + jnp.square(fields["ori_cos"].astype(jnp.float32) - batch["cos"])
    )
    nll = jnp.sum(0.5 * jnp.exp(-lv) * err + 0.5 * lv, axis=-1)
    loss_ori = cfg.lambda_ori * jnp.sum(mask * nll) / n_obj
    metrics["loss_ori"] = loss_ori

    # ---- 3D box size regression when provided — LOG space: size error is
    # relative (a 4 m car mis-sized 10% should cost what a 1 m box mis-sized
    # 10% costs), and the O(1) log-errors keep the shared-trunk gradients
    # balanced. The linear-space form was ~50x the detection terms at init
    # (targets ~4 m, relu head starts near 0) — the same shared-backbone
    # gradient-imbalance family diagnosed for the shape loss in r3 (commit
    # 9d04978), and the measured 0.08 mAP cost of the with-3D operating
    # point (docs/results/detector_4k_with3d.json, r3 verdict weak #5).
    if "bbox3d" in batch:
        pred3 = jnp.log(jnp.clip(fields["bbox3d"].astype(jnp.float32), 1e-3, None))
        tgt3 = jnp.log(jnp.clip(batch["bbox3d"], 1e-3, None))
        se3 = jnp.sum(jnp.square(pred3 - tgt3), axis=-1)
        loss_b3 = cfg.lambda_bbox3d * jnp.sum(mask * se3) / n_obj
        metrics["loss_bbox3d"] = loss_b3
    else:
        loss_b3 = 0.0

    # ---- latent KL vs instance prior means when provided (inst-conditioned
    # Gaussian with unit variance, matching const_log_var=0 priors)
    if "z_prior_mean" in batch:
        kl = gaussian_kl(
            fields["z_mean"].astype(jnp.float32),
            jnp.clip(fields["z_log_var"].astype(jnp.float32), -10.0, 10.0),
            batch["z_prior_mean"],
            jnp.zeros_like(batch["z_prior_mean"]),
        )
        loss_kl = cfg.lambda_kl * jnp.sum(mask * kl) / n_obj
        metrics["loss_kl"] = loss_kl
    else:
        loss_kl = 0.0

    # ---- shape decode for a fixed per-image budget of responsible cells.
    # Fixed-size: take the top-K target-objness cells per image (K static),
    # decode their sampled latents, compare to the indexed target voxels.
    loss_shape = 0.0
    if "voxels" in batch and cfg.shape_decode_per_image > 0:
        b = mask.shape[0]
        k = cfg.shape_decode_per_image
        flat_mask = mask.reshape(b, -1)
        _, top_idx = jax.lax.top_k(flat_mask, k)  # (B, K) cell indices
        zdim = fields["z_mean"].shape[-1]
        zm = jnp.take_along_axis(
            fields["z_mean"].reshape(b, -1, zdim), top_idx[..., None], axis=1
        )
        zlv = jnp.take_along_axis(
            fields["z_log_var"].reshape(b, -1, zdim), top_idx[..., None], axis=1
        )
        slot = jnp.take_along_axis(batch["voxel_slot"].reshape(b, -1), top_idx, axis=1)
        valid = jnp.take_along_axis(flat_mask, top_idx, axis=1) > 0  # (B, K)
        z = reparameterize(key, zm, jnp.clip(zlv, -10.0, 10.0)).reshape(b * k, zdim)
        pred_vox = model.apply(
            {"params": params}, z, method=lambda m, z: m.decoder(z)
        ).astype(jnp.float32)
        tgt_vox = jnp.take_along_axis(
            batch["voxels"],
            jnp.maximum(slot, 0)[..., None, None, None, None],
            axis=1,
        ).reshape(b * k, *batch["voxels"].shape[2:])
        per = focal_binary_loss(pred_vox, tgt_vox, gamma=cfg.gamma)
        vmask = valid.reshape(-1).astype(jnp.float32)
        # PER-VOXEL mean, not the reference's per-sample voxel SUM: the sum
        # form is ~4400 against O(1) detection terms, and through the SHARED
        # backbone that 1000x gradient imbalance collapsed every detection
        # head to an input-independent marginal (diagnosed r3: identical
        # boxes on every image, train-set mAP 0.05). The decoder itself is
        # scale-invariant under Adam; only the shared-trunk mixing ratio
        # changes.
        vox_count = float(math.prod(batch["voxels"].shape[2:]))
        loss_shape = (
            cfg.lambda_shape
            * jnp.sum(per * vmask)
            / (jnp.maximum(jnp.sum(vmask), 1.0) * vox_count)
        )
        metrics["loss_shape"] = loss_shape
        tp, fp, fn = voxel_tp_fp_fn(tgt_vox, pred_vox)
        sel = vmask > 0
        metrics["precision"] = jnp.sum(jnp.where(sel, tp / (tp + fp + 1e-10), 0.0)) / jnp.maximum(
            jnp.sum(vmask), 1.0
        )
        metrics["recall"] = jnp.sum(jnp.where(sel, tp / (tp + fn + 1e-10), 0.0)) / jnp.maximum(
            jnp.sum(vmask), 1.0
        )

    l2 = l2_penalty(params, cfg.l2_weight)
    total = loss_obj + loss_bbox + loss_ori + loss_b3 + loss_kl + loss_shape + l2
    metrics["loss_total"] = total
    return total, metrics


def make_detector_train_step(
    model: DetectorReconstructor, cfg: DetectorLossConfig = DetectorLossConfig(), donate=True
):
    def step(state: TrainState, batch, key):
        def loss_fn(params):
            return detector_losses(model, cfg, params, batch, key)

        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        return apply_gradients_if_finite(state, grads, metrics)

    return jax.jit(step, donate_argnums=(0,) if donate else ())
