"""Loss assembly and jitted train/eval steps for the MultiModalVAE family.

Reference semantics: the fit() methods of the seven nolbo.py classes
(nolbo.py:90-159, 365-430, 578-630, 795-854, 1026-1075, 1231-1258,
1422-1460, 1619-1676) and AE3D.fit (AE3D.py:67-90) — all collapsed into one
config-driven loss. Every loss term cites its source. RNG is threaded via a
single key split per step (the reference interleaves host np.random into
training math, nolbo.py:119-124 — here everything is device-side).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from anytime3d_tpu.models.mmvae import MultiModalVAE
from anytime3d_tpu.ops import (
    focal_binary_loss,
    gaussian_kl,
    prior_repulsion,
    voxel_tp_fp_fn,
)
from anytime3d_tpu.ops.losses import standard_gaussian_kl
from anytime3d_tpu.ops.sampling import reparameterize
from anytime3d_tpu.train.state import TrainState, grads_finite_flag, l2_penalty


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Per-variant training-loss hyperparameters.

    Every reference fit() difference lives here; the faithful per-name values
    are in ``models.configs.loss_config`` (the registry returns
    (MMVAEConfig, LossConfig) pairs). Defaults match ``nolboSingleObject``
    (nolbo.py:90-159)."""

    gamma: float = 0.6  # occupied-voxel BCE weight (0.60 everywhere, nolbo.py:133)
    # target range remap in the BCE (function.py:73-79). NO reference variant
    # sets it (every fit() passes b_range=False); kept for API parity.
    b_range: bool = False
    # AE3D's encoder-INPUT remap [0,1] -> [-1,1] (AE3D.py:69-70: 2x - 1);
    # the loss target stays [0,1]
    input_remap: bool = False
    kl_weight: float = 1.0
    reg_weight: float = 1.0  # 0.01 for *_category_only (nolbo.py:1063,1664)
    # prior-repulsion margin = scale * z_dim, per latent block
    # (nolbo.py:136-140: 3.0/3.0; instOnly 10.0 :393; modelnet_category 2.0 :1661)
    reg_margin_scale_category: float = 3.0
    reg_margin_scale_inst: float = 3.0
    # kernel L2: 5e-4 where the reference fit() sums keras .losses
    # (nolbo.py:142-145, 397-400, 592-599, 810-812); the *_category_only,
    # modelnet voxel and AE3D variants never add them (nolbo.py:1062, 1656;
    # AE3D.py:46-48) -> 0.0 there
    l2_weight: float = 5e-4
    # decoder-input prior mixing (nolbo.py:119-124): one scalar coin per step
    # (np.random.rand() > 0.5) selects the mixed branch with probability
    # ``mix_coin_prob``; inside it each latent element takes the prior sample
    # with probability ``mix_element_prob``. instOnly swaps the WHOLE vector
    # (nolbo.py:383-386) == element prob 1.0; *_category_only uses
    # missing_pr=0.3 (nolbo.py:1042-1048, 1639-1644).
    mix_coin_prob: float = 0.0
    mix_element_prob: float = 0.5


def _encode_and_sample(
    model, cfg, params, batch, key, deterministic, blocked=False, blocked_out=None
):
    """Shared forward: priors -> posterior -> z draw -> decoder input.

    ``blocked=True``: batch["input"] is in the s2d(4) coarse layout and the
    decoder emits the matching d2s(4)-pending layout — the fine 64^3x1 grid
    is never materialized in the step.
    ``blocked_out`` (default: follow ``blocked``) controls the decoder side
    alone: image->shape steps keep a dense image input but still decode into
    the blocked layout when the loss target is blocked (materialize_batch).
    """
    if blocked_out is None:
        blocked_out = blocked
    mcfg = model.config
    # independent keys for the posterior draws and the prior-mix draws — the
    # reference samples each with its own epsilon (nolbo.py:110-116); sharing
    # keys would correlate the posterior and prior noise
    (
        k_cat, k_inst, k_prior_cat, k_prior_inst, k_mix, k_drop, k_dropout_rng,
    ) = jax.random.split(key, 7)
    rngs = {"dropout": k_dropout_rng}
    x = batch["input"]
    if cfg.input_remap:
        # AE3D's encoder-input range shift [0,1] -> [-1,1] (AE3D.py:69-70);
        # elementwise, so valid in dense and blocked layouts alike
        x = 2.0 * x - 1.0

    out: Dict[str, Any] = {}
    enc = model.apply(
        {"params": params},
        x,
        blocked_input=blocked,
        method=MultiModalVAE.encode,
        rngs=rngs,
    )
    out["enc"] = enc

    # ---- label-conditioned priors (NOLBO variants)
    prior_cat = prior_inst = None
    if mcfg.prior_category is not None:
        prior_cat = model.apply(
            {"params": params},
            batch["category_onehot"],
            deterministic,
            method=MultiModalVAE.priors_category,
            rngs=rngs,
        )
        out["prior_cat"] = prior_cat
    if mcfg.prior_inst is not None:
        inst_in = batch["inst_onehot"]
        if mcfg.category_dim > 0:
            # dual-latent: instance prior conditions on (category, instance)
            # one-hots concatenated (nolbo.py:96-97)
            inst_in = jnp.concatenate([batch["category_onehot"], inst_in], axis=-1)
        prior_inst = model.apply(
            {"params": params},
            inst_in,
            deterministic,
            method=MultiModalVAE.priors_inst,
            rngs=rngs,
        )
        out["prior_inst"] = prior_inst

    # ---- latent draw
    if mcfg.variational:
        if enc.mean_category is not None and mcfg.z_inst_dim > 0:
            z_cat = reparameterize(k_cat, enc.mean_category, enc.log_var_category)
            z_inst = reparameterize(k_inst, enc.mean_inst, enc.log_var_inst)
            z = jnp.concatenate([z_cat, z_inst], axis=-1)
        else:
            z = reparameterize(k_inst, enc.mean, enc.log_var)
    else:
        z = enc.mean

    # ---- decoder-input prior mixing (nolbo.py:119-124): one scalar coin per
    # step selects the mixed branch; inside it each element takes the prior
    # sample with probability mix_element_prob (1.0 = whole-vector swap, the
    # instOnly variant nolbo.py:383-386). Runs BEFORE latent dropout — the
    # reference applies dropout to the already-mixed z_input (nolbo.py:1644-1649).
    if (
        not deterministic
        and cfg.mix_coin_prob > 0.0
        and (prior_cat is not None or prior_inst is not None)
    ):
        parts = []
        if prior_cat is not None:
            parts.append(reparameterize(k_prior_cat, prior_cat[0], prior_cat[1]))
        if prior_inst is not None:
            parts.append(reparameterize(k_prior_inst, prior_inst[0], prior_inst[1]))
        z_prior = jnp.concatenate(parts, axis=-1)
        k_coin, k_elem = jax.random.split(k_mix)
        use_mix = jax.random.bernoulli(k_coin, cfg.mix_coin_prob, ())
        take_prior = jax.random.bernoulli(k_elem, cfg.mix_element_prob, z.shape)
        z = jnp.where(use_mix & take_prior, z_prior, z)

    # ---- `_dr` variants: latent dropout at a random rate per step
    # (nolbo.py:586-588, 1237-1239: tf.nn.dropout with rate ~ U(0,1))
    if mcfg.latent_dropout and not deterministic:
        k_rate, k_mask = jax.random.split(k_drop)
        rate = jax.random.uniform(k_rate, (), minval=0.0, maxval=0.95)
        keep = jax.random.bernoulli(k_mask, 1.0 - rate, z.shape)
        z = jnp.where(keep, z / (1.0 - rate), 0.0)

    out["z"] = z
    out["pred"] = model.apply(
        {"params": params},
        z,
        blocked_output=blocked_out,
        method=MultiModalVAE.decode,
        rngs=rngs,
    )
    return out


def materialize_batch(model, batch):
    """Unpack/relayout a voxel batch inside jit; returns
    ``(batch, blocked_in, blocked_out)``.

    The static grid shape comes from the model's decoder config; ``target``
    defaults to the same grid (voxel->voxel variants ship ONE packed copy for
    both roles). When the model supports blocked IO (blocked-head encoder +
    blocked-tail decoder), input/target are produced in the s2d(4) coarse
    layout: ``input_packed_blocked`` batches (bits pre-ordered on the host,
    data/packing.py::pack_voxels_blocked) unpack straight into it with zero
    relayout; dense or linearly-packed batches pay one s2d relayout.

    ``blocked_out`` is decoder-side only: any model with a blocked-tail
    decoder (including IMAGE->shape, whose encoder consumes dense images)
    gets its voxel target in the blocked layout so the decoder skips the
    final d2s relayout and the loss never touches the fine 64^3x1 grid. ``target_packed_blocked`` (pack_voxels_blocked on host)
    unpacks straight into it; linearly-packed / dense targets pay one s2d.
    The shape/focal losses and TP/FP/FN are sums of elementwise terms, so
    the layout permutation leaves every metric unchanged."""
    from anytime3d_tpu.data.packing import unpack_voxels, unpack_voxels_blocked
    from anytime3d_tpu.nn.autoencoder3d import space_to_depth3d

    if "input" in batch and batch["input"].dtype == jnp.uint8:
        # image batches may ship as uint8 (4x less host->device traffic);
        # normalize to [0,1] inside jit where XLA fuses the
        # divide into the stem conv (the reference divides on host, /255 at
        # pascal3D.py:268)
        batch = dict(batch, input=batch["input"].astype(jnp.float32) / 255.0)
    block = getattr(model, "blocked_io_block", None)
    dec_block = getattr(model, "decoder_block", None)
    grid = model.config.decoder.output_shape

    # ---- explicit voxel target (image->shape loaders: input is the image,
    # the 64^3 voxel target still rides the 32x-smaller bit transfer)
    tgt = batch.get("target")
    tgt_blocked = False
    if "target_packed_blocked" in batch:
        if dec_block is None:
            raise ValueError(
                "target_packed_blocked requires a blocked-tail decoder"
            )
        tgt = unpack_voxels_blocked(batch["target_packed_blocked"], grid, dec_block)
        tgt_blocked = True
    elif "target_packed" in batch:
        tgt = unpack_voxels(batch["target_packed"], grid)
    out = {
        k: v
        for k, v in batch.items()
        if k not in ("target", "target_packed", "target_packed_blocked")
    }

    # ---- voxel input paths
    blocked_in = False
    if "input_packed_blocked" in out:
        if block is None:
            raise ValueError(
                "input_packed_blocked requires a blocked-IO model "
                "(blocked-head encoder + blocked-tail decoder)"
            )
        vox = unpack_voxels_blocked(out.pop("input_packed_blocked"), grid, block)
        out["input"] = vox
        blocked_in = True
        if tgt is None:
            tgt, tgt_blocked = vox, True
    elif "input_packed" in out:
        vox = unpack_voxels(out.pop("input_packed"), grid)
        if block is not None:
            vox = space_to_depth3d(vox, block)
        out["input"] = vox
        blocked_in = block is not None
        if tgt is None:
            tgt, tgt_blocked = vox, blocked_in
    elif block is not None:
        shared = tgt is None or tgt is batch.get("input")
        out["input"] = space_to_depth3d(out["input"], block)
        blocked_in = True
        if shared:
            tgt, tgt_blocked = out["input"], True

    # ---- decoder-side layout: blocked whenever the tail supports it and a
    # voxel target exists (covers image->shape, where blocked_in stays False)
    blocked_out = dec_block is not None and tgt is not None
    if tgt is not None:
        if blocked_out and not tgt_blocked:
            tgt = space_to_depth3d(tgt, dec_block)
        out["target"] = tgt
    return out, blocked_in, blocked_out


def compute_losses(
    model: MultiModalVAE,
    cfg: LossConfig,
    params,
    batch: Dict[str, jnp.ndarray],
    key: jax.Array,
    deterministic: bool = False,
):
    """Returns (total_loss, metrics_dict). Batch keys: ``input``, ``target``
    (+ ``category_onehot`` / ``inst_onehot`` for prior variants). Voxel
    batches may instead carry ``input_packed`` (bit-packed uint8,
    data/packing.py) — 32x less host->device traffic; unpacked here inside
    jit where XLA fuses the shift-and-mask into the consumer."""
    mcfg = model.config
    batch, blocked_in, blocked_out = materialize_batch(model, batch)
    fwd = _encode_and_sample(
        model, cfg, params, batch, key, deterministic,
        blocked=blocked_in, blocked_out=blocked_out,
    )
    enc, pred = fwd["enc"], fwd["pred"]
    # losses always in fp32: the voxel BCE sums ~262k log terms per sample,
    # which loses mass in bfloat16 even when the model computes in bf16
    pred = pred.astype(jnp.float32)
    target = batch["target"].astype(jnp.float32)

    metrics: Dict[str, jnp.ndarray] = {}
    total = jnp.zeros(())

    # ---- shape reconstruction loss (nolbo.py:133-134)
    loss_shape = jnp.mean(
        focal_binary_loss(pred, target, gamma=cfg.gamma, b_range=cfg.b_range)
    )
    metrics["loss_shape"] = loss_shape
    total = total + loss_shape

    # ---- KL terms
    if mcfg.variational:
        if mcfg.prior_category is not None or mcfg.prior_inst is not None:
            kl = jnp.zeros(())
            if mcfg.prior_category is not None:
                mc, lvc = fwd["prior_cat"]
                kl = kl + jnp.mean(
                    gaussian_kl(enc.mean_category if enc.mean_category is not None else enc.mean_inst,
                                enc.log_var_category if enc.log_var_category is not None else enc.log_var_inst,
                                mc, lvc)
                )
            if mcfg.prior_inst is not None:
                mi, lvi = fwd["prior_inst"]
                kl = kl + jnp.mean(gaussian_kl(enc.mean_inst, enc.log_var_inst, mi, lvi))
            metrics["loss_kl"] = kl
            total = total + cfg.kl_weight * kl
        else:
            kl = jnp.mean(standard_gaussian_kl(enc.mean, enc.log_var))
            metrics["loss_kl"] = kl
            total = total + cfg.kl_weight * kl

    # ---- prior repulsion regularizer (nolbo.py:136-140)
    if mcfg.prior_category is not None or mcfg.prior_inst is not None:
        reg = jnp.zeros(())
        if mcfg.prior_category is not None:
            mc, lvc = fwd["prior_cat"]
            zdim = mc.shape[-1]
            reg = reg + jnp.mean(
                prior_repulsion(mc, lvc, cfg.reg_margin_scale_category * zdim)
            )
        if mcfg.prior_inst is not None:
            mi, lvi = fwd["prior_inst"]
            zdim = mi.shape[-1]
            gate = batch.get("category_onehot") if mcfg.category_dim > 0 else None
            reg = reg + jnp.mean(
                prior_repulsion(mi, lvi, cfg.reg_margin_scale_inst * zdim, class_onehot=gate)
            )
        metrics["loss_reg"] = reg
        total = total + cfg.reg_weight * reg

    # ---- kernel L2 (keras l2(5e-4) analogue). Skipped entirely at weight 0:
    # XLA cannot DCE `0.0 * sum(w^2)` (inf/NaN semantics), so the zero-weight
    # variants (modelnet family, ae3d) would otherwise pay a full ~200-leaf
    # parameter reduction every step — measured 1.9 ms on the 31M-param
    # image model (r4 profile on the previous accelerator; not measured on
    # the H100).
    if cfg.l2_weight:
        total = total + l2_penalty(params, cfg.l2_weight)

    # ---- voxel precision / recall (nolbo.py:155-158)
    tp, fp, fn = voxel_tp_fp_fn(target, pred)
    metrics["precision"] = jnp.mean(tp / (tp + fp + 1e-10))
    metrics["recall"] = jnp.mean(tp / (tp + fn + 1e-10))
    metrics["loss_total"] = total
    return total, metrics


def apply_gradients_if_finite(state: TrainState, grads, metrics: Dict):
    """Overflow-safe update: zero the WHOLE gradient when any leaf is
    non-finite, then apply normally.

    A finite loss does NOT imply finite grads — e.g. a constant (all-black)
    image drives every GroupNorm group to zero variance, and the backward's
    1/sqrt(var+eps) factor compounds per layer into overflow while the
    forward stays finite. Zeroing keeps params and Adam moments finite (the
    poisoned step decays momentum only — from a fresh state it is an exact
    no-op); ``metrics['grads_finite']`` records it and the Trainer gates
    checkpoint saves on it. This formulation costs nothing measurable: the
    per-leaf ``where`` fuses into the optimizer's own gradient reads,
    unlike a post-update select over params AND both Adam moments (three
    extra state-sized reads, ~3% of the flagship step — measured and
    rejected)."""
    flag = grads_finite_flag(grads)
    metrics["grads_finite"] = flag
    keep = flag > 0
    safe = jax.tree_util.tree_map(
        lambda g: jnp.where(keep, g, jnp.zeros_like(g)), grads
    )
    return state.apply_gradients(safe), metrics


def make_train_step(model: MultiModalVAE, cfg: LossConfig = LossConfig(), donate: bool = True):
    """Build a jitted ``step(state, batch, key) -> (state, metrics)``.

    Gradient sync across a data-sharded mesh is implicit: with params
    replicated and the batch sharded over the 'data' axis, XLA inserts the
    psum during ``jit`` compilation (no hand-written collectives needed).
    """

    def step(state: TrainState, batch, key):
        def loss_fn(params):
            return compute_losses(model, cfg, params, batch, key, deterministic=False)

        (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        return apply_gradients_if_finite(state, grads, metrics)

    return jax.jit(step, donate_argnums=(0,) if donate else ())


def make_train_step_dp(
    model: MultiModalVAE,
    cfg: LossConfig = LossConfig(),
    mesh=None,
    grad_psum_dtype=jnp.bfloat16,
    donate: bool = True,
):
    """``make_train_step`` with an EXPLICIT data-parallel gradient psum in
    reduced precision (KERNELS.md §3: bf16 grad reduction halves the
    per-step all-reduce bytes — a 2x comms margin vs the
    reference's f32 cross-replica SUM, src/module/AE3D.py:95-100).

    The step body runs under ``jax.shard_map``, fully manual over the mesh
    with the batch split on 'data' and params replicated in-body: each data
    shard computes grads of its LOCAL mean loss, casts them to
    ``grad_psum_dtype``, psums over 'data' (the collective moves the
    reduced-precision bytes), divides by the shard count and upcasts to
    f32 for Adam. Metrics are pmean'd in f32. The per-shard RNG key is
    fold_in(key, axis_index) so posterior/prior draws stay independent
    across shards (the implicit-jit path gets this from sharding the
    global random bits).

    Scope: this is the pure-DP production step — on a DP-only mesh
    (model=1) it is strictly the implicit path plus the halved-bytes
    reduction. On a DP×TP mesh it still runs correctly (the in-body
    replication all-gathers TP-sharded params at entry) but forfeits TP
    compute partitioning inside the step; a partial-manual shard_map
    (``axis_names={'data'}``, 'model' auto) would keep it, but check-fails
    XLA's CPU SPMD partitioner in jax 0.9.0 ("Invalid binary instruction
    opcode copy", hlo_instruction.cc:1585); not attempted on GPUs yet.

    ``grad_psum_dtype=None``/``jnp.float32`` gives the same explicit-DP
    step with a full-precision reduction — the control arm of the parity
    test (tests/test_train.py::test_bf16_grad_psum_parity)."""
    from jax.sharding import PartitionSpec as P

    assert mesh is not None, "make_train_step_dp requires a mesh"
    n_data = mesh.shape["data"]
    rdtype = grad_psum_dtype or jnp.float32

    def local_grads(params, batch, key):
        key = jax.random.fold_in(key, jax.lax.axis_index("data"))

        def loss_fn(p):
            return compute_losses(model, cfg, p, batch, key, deterministic=False)

        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        grads = jax.tree_util.tree_map(
            lambda g: (
                jax.lax.psum(g.astype(rdtype), "data") / n_data
            ).astype(jnp.float32),
            grads,
        )
        metrics = jax.tree_util.tree_map(
            lambda m: jax.lax.pmean(m, "data"), metrics
        )
        return grads, metrics

    sharded_grads = jax.shard_map(
        local_grads,
        mesh=mesh,
        in_specs=(P(), P("data"), P()),
        out_specs=(P(), P()),
        axis_names=set(mesh.axis_names),
    )

    def step(state: TrainState, batch, key):
        grads, metrics = sharded_grads(state.params, batch, key)
        return apply_gradients_if_finite(state, grads, metrics)

    return jax.jit(step, donate_argnums=(0,) if donate else ())


def make_eval_step(model: MultiModalVAE, cfg: LossConfig = LossConfig()):
    """Jitted eval: loss + P/R at posterior sample, no gradient."""

    def step(params, batch, key):
        _, metrics = compute_losses(model, cfg, params, batch, key, deterministic=True)
        return metrics

    return jax.jit(step)
