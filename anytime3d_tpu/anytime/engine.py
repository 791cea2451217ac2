"""The anytime observation protocol, prior correction, and Gaussian fusion.

Reference semantics (src/module/nolbo.py:161-259, the paper's core loop):

1. encode an observation into a Gaussian latent posterior;
2. simulate partial observation by masking each latent dim w.p. missing_prob,
   filling masked dims with the mean of the class-prior means;
3. classify by nearest prior mean; decode -> "uncorrected" reconstruction;
4. CORRECT: re-classify with a masked-dimension-aware distance, then replace
   masked dims with draws from the nearest class prior, decode again.

Everything is jit-able: masks are dense, classification is an argmin over a
(B, K) distance matrix, correction is a gather + where. The reference runs
this eagerly with host RNG (np.random.choice, nolbo.py:202).

``GaussianBelief`` generalizes step 4 into a recursive *information-filter*
update over a stream of partial observations — the mapping-backend primitive
(BASELINE.json north star): precision adds, precision-weighted means add,
and the anytime property (monotone improvement with more observations) is
the filter's consistency.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax
import jax.numpy as jnp

from anytime3d_tpu.models.mmvae import MultiModalVAE
from anytime3d_tpu.ops import focal_binary_loss, voxel_tp_fp_fn
from anytime3d_tpu.ops.sampling import reparameterize


# --------------------------------------------------------------------------
# classification + correction primitives
# --------------------------------------------------------------------------

def classify_by_prior(
    z: jnp.ndarray, prior_means: jnp.ndarray, mask: Optional[jnp.ndarray] = None
) -> jnp.ndarray:
    """argmin_k sum_d [mask_d *] (z_d - mu_kd)^2  ->  (B,) class indices.

    ``mask`` restricts the distance to observed dims (nolbo.py:239)."""
    d2 = jnp.square(z[:, None, :] - prior_means[None, :, :])  # (B, K, D)
    if mask is not None:
        d2 = d2 * mask[:, None, :]
    return jnp.argmin(jnp.sum(d2, axis=-1), axis=-1)


def correct_latent(
    key: jax.Array,
    z: jnp.ndarray,
    mask: jnp.ndarray,
    prior_means: jnp.ndarray,
    prior_log_vars: Optional[jnp.ndarray] = None,
    mode: str = "resample",
    gate_margin: float = 0.2,
) -> jnp.ndarray:
    """Replace missing dims with the nearest class prior (nolbo.py:239-243).

    mode='resample': draw masked dims from N(mu_k*, exp(lv)) with lv=0 as the
    reference does; mode='mean': snap to mu_k* outright (the instOnly variant,
    nolbo.py:460-474).

    A ``_gated`` suffix ('resample_gated'/'mean_gated') corrects ONLY samples
    whose nearest-prior decision is confident: relative margin between the
    two nearest priors over OBSERVED dims > ``gate_margin``; everyone else
    keeps the uncorrected z. This is NEW vs the reference (which corrects
    unconditionally): measured on the image family, unconditional correction
    injects wrong-class prior samples exactly when classification fails —
    corrected shape loss tracks classification error, degrading below the
    uncorrected decode at high missing rates
    (docs/results/pascal_nolbo_structural_16k.json sweep, r4)."""
    gated = mode.endswith("_gated")
    base = mode[: -len("_gated")] if gated else mode
    d2 = jnp.square(z[:, None, :] - prior_means[None, :, :])  # (B, K, D)
    d2 = d2 * mask[:, None, :]
    dist = jnp.sum(d2, axis=-1)  # (B, K)
    nearest = jnp.argmin(dist, axis=-1)  # (B,)
    mu = prior_means[nearest]  # (B, D)
    if base == "resample":
        lv = (
            prior_log_vars[nearest]
            if prior_log_vars is not None
            else jnp.zeros_like(mu)
        )
        fill = reparameterize(key, mu, lv)
    else:
        fill = mu
    corrected = jnp.where(mask > 0, z, fill)
    if not gated:
        return corrected
    top2 = -jax.lax.top_k(-dist, 2)[0]  # (B, 2) two smallest distances
    margin = (top2[:, 1] - top2[:, 0]) / (top2[:, 1] + 1e-9)
    confident = margin > gate_margin
    return jnp.where(confident[:, None], corrected, z)


# --------------------------------------------------------------------------
# full anytime evaluation protocol
# --------------------------------------------------------------------------

def anytime_eval_jit(
    model: MultiModalVAE,
    params,
    batch: Dict[str, jnp.ndarray],
    key: jax.Array,
    missing_prob: float = 0.0,
    prior_means: Optional[jnp.ndarray] = None,
    correction: str = "resample",
    gamma: float = 0.6,
    return_pred: bool = False,
) -> Dict[str, jnp.ndarray]:
    """``anytime_eval`` under jit (model + protocol knobs static).

    The protocol is ~10² ops; eager per-op dispatch pays a launch per op,
    so every evaluation loop should go through this.
    A positive ``missing_prob`` is passed TRACED, so every rate of a
    missing-rate sweep shares one compiled program; rate 0.0 (no masking,
    fewer outputs) compiles separately."""
    if missing_prob and float(missing_prob) > 0.0:
        return _ANYTIME_EVAL_JIT_MASKED(
            model, params, batch, key, jnp.float32(missing_prob), prior_means,
            correction, gamma, return_pred,
        )
    return _ANYTIME_EVAL_JIT_CLEAN(
        model, params, batch, key, 0.0, prior_means, correction, gamma,
        return_pred,
    )


def anytime_eval(
    model: MultiModalVAE,
    params,
    batch: Dict[str, jnp.ndarray],
    key: jax.Array,
    missing_prob: float = 0.0,
    prior_means: Optional[jnp.ndarray] = None,
    correction: str = "resample",
    gamma: float = 0.6,
    return_pred: bool = False,
) -> Dict[str, jnp.ndarray]:
    """Run the reference getEval protocol (nolbo.py:161-259) on a batch.

    ``prior_means``: (K, z_cat_dim) class anchors. If None and the model has a
    category priornet, they are computed from it over all K one-hots; for
    AE/VAE variants pass external ``category_vectors`` mean latents
    (nolbo.py:632-698). Returns uncorrected and (when missing_prob>0)
    corrected metrics. ``return_pred=True`` additionally returns the decoded
    grids under ``pred``/``pred_corrected`` — the arrays the reference dumps
    to .npy for the offline PR-curve notebook (test_modelnet_3D.py:124-143).
    """
    cfg = model.config
    # a traced (jnp scalar) missing_prob means "masking on, rate data-driven"
    masked = (
        True
        if not isinstance(missing_prob, (int, float))
        else missing_prob > 0.0
    )
    # independent epsilon per latent block: the reference draws the category
    # and instance samples separately (nolbo.py:184-197)
    k_sample_cat, k_sample_inst, k_mask, k_corr = jax.random.split(key, 4)

    enc = model.apply({"params": params}, batch["input"], method=MultiModalVAE.encode)

    # ---- category block (the anytime-masked latent)
    if enc.mean_category is not None:
        mean_cat, lv_cat = enc.mean_category, enc.log_var_category
        if cfg.z_inst_dim > 0:
            mean_inst, lv_inst = enc.mean_inst, enc.log_var_inst
        else:
            mean_inst = lv_inst = None
    else:
        # single-latent models carry the latent in the inst slot
        mean_cat, lv_cat = enc.mean_inst, enc.log_var_inst
        mean_inst = lv_inst = None

    if prior_means is None:
        if cfg.prior_category is not None:
            eye = jnp.eye(cfg.prior_category.input_dim, dtype=mean_cat.dtype)
            prior_means, _ = model.apply(
                {"params": params}, eye, method=MultiModalVAE.priors_category
            )
        else:
            raise ValueError("prior_means required for models without a category priornet")

    z_cat = (
        reparameterize(k_sample_cat, mean_cat, lv_cat) if lv_cat is not None else mean_cat
    )

    # ---- anytime mask: missing dims <- mean of prior means (nolbo.py:200-208)
    if masked:
        keep = jax.random.bernoulli(k_mask, 1.0 - missing_prob, z_cat.shape)
        mask = keep.astype(z_cat.dtype)
        fill = jnp.mean(prior_means, axis=0)
        z_cat = jnp.where(keep, z_cat, fill)
    else:
        mask = jnp.ones_like(z_cat)

    metrics: Dict[str, jnp.ndarray] = {}

    # ---- classification by nearest prior mean (nolbo.py:214-227)
    if "category_onehot" in batch:
        pred_cat = classify_by_prior(z_cat, prior_means)
        gt = jnp.argmax(batch["category_onehot"], axis=-1)
        metrics["acc_category"] = jnp.mean((pred_cat == gt).astype(jnp.float32))

    # ---- instance block (dual-latent models): sample + classify
    z_parts = [z_cat]
    if mean_inst is not None:
        z_inst = (
            reparameterize(k_sample_inst, mean_inst, lv_inst) if lv_inst is not None else mean_inst
        )
        z_parts.append(z_inst)
        if cfg.prior_inst is not None and "inst_onehot" in batch and "category_onehot" in batch:
            b = z_inst.shape[0]
            inst_num = cfg.inst_dim
            eye_inst = jnp.eye(inst_num, dtype=z_inst.dtype)
            # per-sample: condition on the sample's category, sweep instances
            # (nolbo.py:166-171)
            cat_rep = jnp.repeat(batch["category_onehot"], inst_num, axis=0)
            inst_rep = jnp.tile(eye_inst, (b, 1))
            inst_means, _ = model.apply(
                {"params": params},
                jnp.concatenate([cat_rep, inst_rep], axis=-1),
                method=MultiModalVAE.priors_inst,
            )
            inst_means = inst_means.reshape(b, inst_num, -1)
            d2 = jnp.sum(jnp.square(z_inst[:, None, :] - inst_means), axis=-1)
            pred_inst = jnp.argmin(d2, axis=-1)
            gt_inst = jnp.argmax(batch["inst_onehot"], axis=-1)
            metrics["acc_inst"] = jnp.mean((pred_inst == gt_inst).astype(jnp.float32))

    # ---- uncorrected decode + metrics (nolbo.py:229-235)
    z = jnp.concatenate(z_parts, axis=-1) if len(z_parts) > 1 else z_parts[0]
    pred = model.apply({"params": params}, z, method=MultiModalVAE.decode)
    target = batch["target"]
    metrics["loss_shape"] = jnp.mean(focal_binary_loss(pred, target, gamma=gamma))
    tp, fp, fn = voxel_tp_fp_fn(target, pred)
    metrics["precision"] = jnp.mean(tp / (tp + fp + 1e-10))
    metrics["recall"] = jnp.mean(tp / (tp + fn + 1e-10))
    if return_pred:
        metrics["pred"] = pred

    if not masked:
        return metrics

    # ---- correction pass (nolbo.py:239-259)
    z_cat_corr = correct_latent(k_corr, z_cat, mask, prior_means, mode=correction)
    if "category_onehot" in batch:
        pred_cat_c = classify_by_prior(z_cat_corr, prior_means)
        gt = jnp.argmax(batch["category_onehot"], axis=-1)
        metrics["acc_category_corrected"] = jnp.mean((pred_cat_c == gt).astype(jnp.float32))
    z_corr = (
        jnp.concatenate([z_cat_corr] + z_parts[1:], axis=-1)
        if len(z_parts) > 1
        else z_cat_corr
    )
    pred_c = model.apply({"params": params}, z_corr, method=MultiModalVAE.decode)
    metrics["loss_shape_corrected"] = jnp.mean(focal_binary_loss(pred_c, target, gamma=gamma))
    tp, fp, fn = voxel_tp_fp_fn(target, pred_c)
    metrics["precision_corrected"] = jnp.mean(tp / (tp + fp + 1e-10))
    metrics["recall_corrected"] = jnp.mean(tp / (tp + fn + 1e-10))
    if return_pred:
        metrics["pred_corrected"] = pred_c
    return metrics


# --------------------------------------------------------------------------
# recursive Gaussian latent fusion (the mapping backend primitive)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class GaussianBelief:
    """Diagonal-Gaussian belief over a latent, in information form.

    precision = 1/var summed over observations; info = mean * precision.
    ``from_moments``/``mean``/``log_var`` convert to/from moment form.
    """

    info: jnp.ndarray  # (D,) or (B, D): precision-weighted mean
    precision: jnp.ndarray  # same shape

    @classmethod
    def from_moments(cls, mean: jnp.ndarray, log_var: jnp.ndarray) -> "GaussianBelief":
        prec = jnp.exp(-log_var)
        return cls(info=mean * prec, precision=prec)

    @classmethod
    def uninformative(cls, shape, eps: float = 1e-6) -> "GaussianBelief":
        return cls(info=jnp.zeros(shape), precision=jnp.full(shape, eps))

    @property
    def mean(self) -> jnp.ndarray:
        return self.info / self.precision

    @property
    def log_var(self) -> jnp.ndarray:
        return -jnp.log(self.precision)


jax.tree_util.register_dataclass(
    GaussianBelief, data_fields=["info", "precision"], meta_fields=[]
)


@dataclasses.dataclass
class OccupancyBelief:
    """Associative log-odds fusion of decoded occupancy grids (product of
    experts over views).

    The latent-space ``GaussianBelief`` is the right fusion when the
    encoder's per-dim log-var measures OBSERVATION certainty. Under the
    NOLBO training objective the posterior variance is pulled toward the
    CLASS-prior variance (nolbo.py:84-98 KL), so across views it is nearly
    constant and precision-weighted latent fusion degenerates to mean
    averaging — measured: +0.009 IoU over a single view at N=8
    (docs/results/streaming_fusion.json). Occupancy-space fusion sidesteps
    the calibration question: each view's decoded grid votes per voxel in
    log-odds, the running SUM is associative and order-free (streamable,
    mesh-shardable with one psum — the same information-filter pattern as
    ``fuse_sequence_sharded``), and thresholding the mean log-odds at 0.5
    is exactly per-voxel majority logic over views.
    """

    log_odds: jnp.ndarray  # running sum of per-observation logit(p)
    count: jnp.ndarray  # scalar observation count (broadcastable)

    @classmethod
    def empty(cls, shape, dtype=jnp.float32) -> "OccupancyBelief":
        return cls(
            log_odds=jnp.zeros(shape, dtype), count=jnp.zeros((), dtype)
        )

    @property
    def probs(self) -> jnp.ndarray:
        """Calibrated fused occupancy: sigmoid of the MEAN log-odds
        (geometric-mean expert; same 0.5-threshold decision as the sum)."""
        return jax.nn.sigmoid(self.log_odds / jnp.maximum(self.count, 1.0))


jax.tree_util.register_dataclass(
    OccupancyBelief, data_fields=["log_odds", "count"], meta_fields=[]
)


def fuse_occupancy(
    belief: OccupancyBelief,
    probs: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
    epsilon: float = 1e-6,
) -> OccupancyBelief:
    """Add one decoded occupancy grid (probabilities in (0,1)) to the belief.

    ``mask`` (same shape, 1 = this observation actually SEES the voxel):
    visibility-masked fusion — the volumetric-fusion standard (TSDF-style).
    A partially-occluded view decodes a systematically-absent guess for
    voxels it cannot see; without the mask those bogus votes accumulate and
    fusion DEGRADES with N (measured:
    docs/results/streaming_fusion_occluded.json pofe 0.137 -> 0.096 over
    N=1..8). With it only observed voxels vote, ``count`` becomes per-voxel,
    and unobserved voxels stay at the 0.5 prior (-> absent at threshold)."""
    p = jnp.clip(probs.astype(jnp.float32), epsilon, 1.0 - epsilon)
    vote = jnp.log(p) - jnp.log1p(-p)
    if mask is not None:
        m = mask.astype(jnp.float32)
        return OccupancyBelief(
            log_odds=belief.log_odds + m * vote, count=belief.count + m
        )
    return OccupancyBelief(log_odds=belief.log_odds + vote, count=belief.count + 1.0)


def fuse_observation(
    belief: GaussianBelief,
    mean: jnp.ndarray,
    log_var: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
) -> GaussianBelief:
    """Information-filter update: add an observation's precision where observed.

    With mask=None all dims are observed. Masked (unobserved) dims contribute
    nothing, so the belief there stays at its prior — exactly the anytime
    degradation/improvement semantics, now exact instead of the reference's
    single-shot fill-in."""
    prec_obs = jnp.exp(-log_var)
    if mask is not None:
        prec_obs = prec_obs * mask
    return GaussianBelief(
        info=belief.info + mean * prec_obs,
        precision=belief.precision + prec_obs,
    )


def fuse_sequence(
    means: jnp.ndarray,
    log_vars: jnp.ndarray,
    masks: Optional[jnp.ndarray] = None,
    prior: Optional[GaussianBelief] = None,
) -> GaussianBelief:
    """Fuse a (T, ...) sequence of observations with ``lax.scan``.

    Returns the final belief; per-step beliefs are recoverable by scanning
    externally. Associativity of precision addition makes this shardable:
    partial sums over a 'data' mesh axis combine with a single psum."""
    if prior is None:
        prior = GaussianBelief.uninformative(means.shape[1:])

    def step(belief, obs):
        mean, lv, mask = obs
        return fuse_observation(belief, mean, lv, mask), None

    if masks is None:
        masks = jnp.ones_like(means)
    belief, _ = jax.lax.scan(step, prior, (means, log_vars, masks))
    return belief


def fuse_sequence_sharded(
    mesh,
    means: jnp.ndarray,
    log_vars: jnp.ndarray,
    masks: Optional[jnp.ndarray] = None,
    prior: Optional[GaussianBelief] = None,
    axis: str = "data",
) -> GaussianBelief:
    """``fuse_sequence`` with the observation stream sharded over a mesh axis.

    The information-filter update is a per-dim SUM of (mask·precision,
    mask·precision·mean) over observations, so it is associative and
    order-free: each device scans only its T/n local shard of the stream and
    ONE psum over ``axis`` combines the partial information states. This is
    the mesh-scaled form of the reference's per-observation update loop
    (/root/reference/src/module/nolbo.py:199-208), which is strictly
    sequential on host RNG; here T observations fuse in T/n scan steps plus
    one collective. Exactly equal to the sequential result (the adds commute;
    fp32 reduction order differs only at the psum).

    Args:
      mesh: a ``jax.sharding.Mesh`` containing ``axis``.
      means/log_vars/masks: (T, ...) stacked observations; T must divide by
        the axis size.
      prior: optional starting belief (added once, on every device's result).
    """
    n = mesh.shape[axis]
    T = means.shape[0]
    if T % n != 0:
        raise ValueError(f"stream length {T} % mesh axis '{axis}'={n} != 0")
    if masks is None:
        masks = jnp.ones_like(means)
    if prior is None:
        prior = GaussianBelief.uninformative(means.shape[1:])

    from jax.sharding import PartitionSpec as P

    def local_fuse(means_l, lvs_l, masks_l):
        # zero-information start: the prior joins once, outside the psum.
        # (derived from the operand so the scan carry is device-varying)
        zero = GaussianBelief(info=means_l[0] * 0.0, precision=means_l[0] * 0.0)
        b = fuse_sequence(means_l, lvs_l, masks_l, prior=zero)
        return jax.lax.psum(b.info, axis), jax.lax.psum(b.precision, axis)

    spec = P(axis)
    info, prec = jax.shard_map(
        local_fuse,
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=(P(), P()),
    )(means, log_vars, masks)
    return GaussianBelief(
        info=prior.info + info, precision=prior.precision + prec
    )


# masked: missing_prob traced (arg 4 dynamic) — one compile per sweep;
# clean: missing_prob static 0.0 (different output set)
_ANYTIME_EVAL_JIT_MASKED = jax.jit(
    anytime_eval, static_argnums=(0, 6, 7, 8)
)
_ANYTIME_EVAL_JIT_CLEAN = jax.jit(
    anytime_eval, static_argnums=(0, 4, 6, 7, 8)
)
