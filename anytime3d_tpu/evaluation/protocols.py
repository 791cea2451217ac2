"""Metric protocols reproducing the reference evaluation scripts.

- ``missing_rate_sweep``: anytime degradation at rates {0.3, 0.5, 0.7, 0.9},
  uncorrected vs prior-corrected (test_modelnet_3D.py:117, test_pascal_3D.py:144)
- ``pr_curve``: precision/recall over decode thresholds
  (modelnetAE3.ipynb cells 2-3, computed on-device instead of offline dumps)
- ``category_vectors``: per-class mean latents used as AE/VAE eval priors
  (test_modelnet_getLatents.py:93-115)
- ``evaluate_epoch``: single-pass eval at a fixed missing rate
  (test_modelnet_AE.py:104-156)
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from anytime3d_tpu.anytime import anytime_eval_jit
from anytime3d_tpu.models.mmvae import MultiModalVAE
from anytime3d_tpu.ops import voxel_tp_fp_fn


def missing_rate_sweep(
    model: MultiModalVAE,
    params,
    batch_fn: Callable[[int], Dict],
    rates: Sequence[float] = (0.3, 0.5, 0.7, 0.9),
    num_batches: int = 8,
    prior_means=None,
    seed: int = 0,
    correction: str = "resample",
) -> Dict[float, Dict[str, float]]:
    """Anytime degradation table: metrics per missing rate, averaged over
    ``num_batches`` batches. ``correction='mean'`` is the instOnly variant's
    snap-to-prior-mean fill (nolbo.py:460-474)."""
    out: Dict[float, Dict[str, float]] = {}
    for rate in rates:
        sums: Dict[str, float] = {}
        for b in range(num_batches):
            key = jax.random.PRNGKey(seed * 10_000 + int(rate * 100) * 100 + b)
            metrics = anytime_eval_jit(
                model, params, batch_fn(b), key,
                missing_prob=rate, prior_means=prior_means,
                correction=correction,
            )
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v)
        out[rate] = {k: v / num_batches for k, v in sums.items()}
    return out


def pr_curve(
    target: jnp.ndarray,
    pred: jnp.ndarray,
    thresholds: Optional[Sequence[float]] = None,
    acceptance_div: int = 0,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Precision/recall/IoU across decode thresholds, one device pass per
    threshold (the reference dumps voxels to txt and sweeps offline in a
    notebook).

    ``acceptance_div > 0`` appends the notebook's acceptance-probability
    tail (modelnetAE3.ipynb cell 2): for each ``accept_prob = 0.1**i``,
    ``i in [0, acceptance_div)``, only voxels predicted at saturating
    probability (pred >= 1.0) are kept, each accepted independently with
    ``accept_prob`` — extending the curve into the extreme high-precision /
    vanishing-recall corner. Those rows are returned in the same
    precision/recall/iou arrays; ``accept_prob`` is NaN for the plain
    threshold rows and holds the acceptance probability for tail rows
    (their ``threshold`` entry is 1.0, the saturation cut)."""
    if thresholds is None:
        thresholds = np.linspace(0.05, 0.95, 19)

    # ONE compiled program per sweep (threshold is traced): no eager
    # per-threshold dispatch
    @jax.jit
    def _prf(tgt, prd, thr):
        tp, fp, fn = voxel_tp_fp_fn(tgt, prd, threshold=thr)
        return (
            jnp.mean(tp / (tp + fp + 1e-10)),
            jnp.mean(tp / (tp + fn + 1e-10)),
            jnp.mean(tp / (tp + fp + fn + 1e-10)),
        )

    ps, rs, ious = [], [], []
    for t in thresholds:
        p_, r_, i_ = _prf(target, pred, jnp.float32(t))
        ps.append(float(p_))
        rs.append(float(r_))
        ious.append(float(i_))
    thr_col = list(np.asarray(thresholds, np.float32))
    accept_col = [np.nan] * len(thr_col)

    # pred >= 1.0, then a Bernoulli(accept_prob) keep mask — the notebook's
    # np.random.choice([0,1], p=[1-p, p]) on device; ONE compile, prob traced
    @jax.jit
    def _accept_prf(tgt, prd, k, prob):
        keep = jax.random.bernoulli(k, prob, jnp.shape(prd))
        prd_t = jnp.where(keep, prd, 0.0)
        tp, fp, fn = voxel_tp_fp_fn(tgt, prd_t, threshold=1.0)
        return (
            jnp.mean(tp / (tp + fp + 1e-10)),
            jnp.mean(tp / (tp + fn + 1e-10)),
            jnp.mean(tp / (tp + fp + fn + 1e-10)),
        )

    for i in range(acceptance_div):
        accept_prob = 0.1 ** i
        key = jax.random.PRNGKey(seed * 1000 + i)
        p_, r_, i_ = _accept_prf(target, pred, key, jnp.float32(accept_prob))
        ps.append(float(p_))
        rs.append(float(r_))
        ious.append(float(i_))
        thr_col.append(1.0)
        accept_col.append(accept_prob)
    return {
        "threshold": np.asarray(thr_col, np.float32),
        "accept_prob": np.asarray(accept_col, np.float32),
        "precision": np.asarray(ps, np.float32),
        "recall": np.asarray(rs, np.float32),
        "iou": np.asarray(ious, np.float32),
    }


def category_vectors(
    model: MultiModalVAE,
    params,
    batch_fn: Callable[[int], Dict],
    num_classes: int,
    num_batches: int = 16,
) -> np.ndarray:
    """Per-class mean posterior-mean latents — the AE/VAE external priors
    (test_modelnet_getLatents.py:93-115). Returns (num_classes, z_dim)."""
    sums = None
    counts = np.zeros(num_classes)
    encode = jax.jit(
        lambda p, x: model.apply({"params": p}, x, method=MultiModalVAE.encode)
    )
    for b in range(num_batches):
        batch = batch_fn(b)
        enc = encode(params, batch["input"])
        z = np.asarray(enc.mean)
        labels = np.argmax(np.asarray(batch["category_onehot"]), axis=-1)
        if sums is None:
            sums = np.zeros((num_classes, z.shape[-1]), np.float64)
        np.add.at(sums, labels, z)
        np.add.at(counts, labels, 1)
    counts = np.maximum(counts, 1)
    return (sums / counts[:, None]).astype(np.float32)


def evaluate_epoch(
    model: MultiModalVAE,
    params,
    batch_fn: Callable[[int], Dict],
    num_batches: int,
    missing_prob: float = 0.0,
    prior_means=None,
    seed: int = 0,
    correction: str = "resample",
) -> Dict[str, float]:
    """Single-pass eval: mean loss/P/R (+ corrected variants when masking)."""
    sums: Dict[str, float] = {}
    for b in range(num_batches):
        key = jax.random.PRNGKey(seed + b)
        metrics = anytime_eval_jit(
            model, params, batch_fn(b), key,
            missing_prob=missing_prob, prior_means=prior_means,
            correction=correction,
        )
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0.0) + float(v)
    return {k: v / num_batches for k, v in sums.items()}
