"""Ahead-of-time model export for serving (StableHLO via ``jax.export``).

The reference ships inference only as eager test scripts that rebuild the
graph from Python each run (``/root/reference/test_modelnet_3D.py:60-114``,
``/root/reference/src/module/nolbo_test.py:81-188``); there is no deployable
artifact. A production framework wants the opposite: serialize the jitted
inference program ONCE (with weights baked in or passed alongside) and run it
from any process — including ones without the model-building Python — via
:func:`load_infer`. The program is ``jax.export``'s StableHLO, lowered for
the platforms named at export (``cuda`` for the GPU, ``cpu`` in tests; by
default the exporting process's own), and runs only on those.

The artifact is this module's own container (:func:`serialize_exported`):
a JSON header with the calling signature, then the StableHLO bytecode.
``jax.export``'s own ``serialize`` needs the ``flatbuffers`` package, which
the GPU deployment does not have.

Design notes:
- Static shapes end-to-end: the exported program is specialized to one
  ``(batch, D, D, D, 1)`` (voxel front-end) or ``(batch, H, W, 3)`` (image
  front-end) input signature. Serving-side batching pads to this shape
  (``serving.batcher``) rather than recompiling per request count.
- The inference function is the anytime protocol's serving subset: encode ->
  posterior mean -> nearest-prior classification -> decode, i.e. the
  deterministic path of ``anytime.engine.anytime_eval`` (nolbo.py:214-259)
  without the masking simulation (real deployments have real missing dims,
  applied by the caller via ``mask``).
- ``prior_means`` are baked into the exported closure as constants — they are
  (K, z_dim) and tiny, and baking them keeps the serving signature to a
  single array input.
"""

from __future__ import annotations

import base64
import json
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax import export as jax_export

from anytime3d_tpu.anytime.engine import classify_by_prior
from anytime3d_tpu.models.mmvae import MultiModalVAE


_MAGIC = b"anytime3d-stablehlo-1\n"


def serialize_exported(exported: jax_export.Exported) -> bytes:
    """``exported`` as bytes: magic, header length, JSON header, StableHLO.

    Covers what this package exports: one device, static shapes, no
    effects, no shardings; anything else is refused."""
    n_in, n_out = len(exported.in_avals), len(exported.out_avals)
    if (
        exported.nr_devices != 1
        or exported.ordered_effects
        or exported.unordered_effects
        or exported.disabled_safety_checks
        or exported.in_shardings_hlo != (None,) * n_in
        or exported.out_shardings_hlo != (None,) * n_out
    ):
        raise ValueError("only single-device programs without effects or shardings serialize")

    def avals(seq):
        return [[[int(d) for d in a.shape], a.dtype.name] for a in seq]

    header = json.dumps({
        "fun_name": exported.fun_name,
        "in_tree": base64.b64encode(exported.in_tree.serialize_using_proto()).decode(),
        "out_tree": base64.b64encode(exported.out_tree.serialize_using_proto()).decode(),
        "in_avals": avals(exported.in_avals),
        "out_avals": avals(exported.out_avals),
        "platforms": list(exported.platforms),
        "calling_convention_version": exported.calling_convention_version,
        "module_kept_var_idx": list(exported.module_kept_var_idx),
        "uses_global_constants": exported.uses_global_constants,
    }).encode()
    return _MAGIC + len(header).to_bytes(8, "little") + header + exported.mlir_module_serialized


def deserialize_exported(data: bytes) -> jax_export.Exported:
    """Inverse of :func:`serialize_exported`."""
    data = bytes(data)
    if not data.startswith(_MAGIC):
        raise ValueError("not a serialized anytime3d serving program")
    start = len(_MAGIC) + 8
    end = start + int.from_bytes(data[len(_MAGIC):start], "little")
    h = json.loads(data[start:end])

    def tree(b64):
        return jax.tree_util.PyTreeDef.deserialize_using_proto(
            jax.tree_util.default_registry, base64.b64decode(b64)
        )

    def avals(seq):
        return tuple(jax.core.ShapedArray(tuple(shape), jnp.dtype(dt)) for shape, dt in seq)

    n_in, n_out = len(h["in_avals"]), len(h["out_avals"])
    return jax_export.Exported(
        fun_name=h["fun_name"],
        in_tree=tree(h["in_tree"]),
        in_avals=avals(h["in_avals"]),
        out_tree=tree(h["out_tree"]),
        out_avals=avals(h["out_avals"]),
        nr_devices=1,
        in_shardings_hlo=(None,) * n_in,
        out_shardings_hlo=(None,) * n_out,
        _has_named_shardings=True,
        _in_named_shardings=(None,) * n_in,
        _out_named_shardings=(None,) * n_out,
        platforms=tuple(h["platforms"]),
        ordered_effects=(),
        unordered_effects=(),
        disabled_safety_checks=(),
        mlir_module_serialized=data[end:],
        calling_convention_version=h["calling_convention_version"],
        module_kept_var_idx=tuple(h["module_kept_var_idx"]),
        uses_global_constants=h["uses_global_constants"],
        _get_vjp=None,
    )


def _platforms(platforms: Optional[Sequence[str]]) -> tuple:
    return tuple(platforms) if platforms else (jax_export.default_export_platform(),)


def make_infer_fn(
    model: MultiModalVAE,
    prior_means: Optional[jnp.ndarray] = None,
    correction: bool = True,
):
    """Build the pure serving function ``fn(params, x, mask) -> outputs``.

    ``mask`` is a (B, z_cat_dim) 0/1 array of OBSERVED latent dims — all-ones
    for full observations; a real partial observation marks its missing dims
    0 and the function fills them with the prior-corrected values
    (nolbo.py:239-243) before decoding — class-prior means when the model
    has priors, the N(0, I) prior mean (zeros) otherwise. Outputs:

    - ``z_mean``: full posterior mean (B, z_dim) — the latent the mapping
      backend fuses (``anytime.engine.fuse_observation``);
    - ``z_log_var``: posterior log-variance (or zeros for AE variants);
    - ``category``: (B,) nearest-prior class indices (present when priors
      are available);
    - ``pred``: decoded occupancy logits' sigmoid, (B, D, D, D, 1).
    """
    cfg = model.config

    def fn(params, x, mask):
        enc = model.apply({"params": params}, x, method=MultiModalVAE.encode)
        if enc.mean_category is not None:
            mean_cat, lv_cat = enc.mean_category, enc.log_var_category
            mean_inst, lv_inst = enc.mean_inst, enc.log_var_inst
        else:
            mean_cat, lv_cat = enc.mean_inst, enc.log_var_inst
            mean_inst = lv_inst = None

        pm = prior_means
        if pm is None and cfg.prior_category is not None:
            eye = jnp.eye(cfg.prior_category.input_dim, dtype=mean_cat.dtype)
            pm, _ = model.apply(
                {"params": params}, eye, method=MultiModalVAE.priors_category
            )

        z_cat = mean_cat
        out = {}
        if pm is not None:
            pm_c = jnp.asarray(pm, mean_cat.dtype)
            if correction:
                # masked-distance classify + prior fill of missing dims
                # (deterministic serving: prior MEAN, not a draw)
                cls = classify_by_prior(z_cat, pm_c, mask=mask)
                z_cat = jnp.where(mask > 0, z_cat, pm_c[cls])
            else:
                cls = classify_by_prior(z_cat, pm_c)
            out["category"] = cls
        elif correction:
            # no class priors (VAE/AE variants): the latent prior is N(0, I)
            # (or undefined for AE), so the fill for missing dims is the
            # prior mean 0 — never the raw unobserved encoder values.
            z_cat = jnp.where(mask > 0, z_cat, jnp.zeros_like(z_cat))

        z_parts = [z_cat]
        lv_parts = [lv_cat if lv_cat is not None else jnp.zeros_like(z_cat)]
        if mean_inst is not None:
            z_parts.append(mean_inst)
            lv_parts.append(
                lv_inst if lv_inst is not None else jnp.zeros_like(mean_inst)
            )
        z = jnp.concatenate(z_parts, axis=-1)
        out["z_mean"] = z
        out["z_log_var"] = jnp.concatenate(lv_parts, axis=-1)
        logits = model.apply({"params": params}, z, method=MultiModalVAE.decode)
        out["pred"] = jax.nn.sigmoid(logits.astype(jnp.float32))
        return out

    return fn


def export_infer(
    model: MultiModalVAE,
    params,
    input_shape,
    prior_means: Optional[jnp.ndarray] = None,
    correction: bool = True,
    input_dtype=jnp.float32,
    packed_input: bool = False,
    packed_output: bool = False,
    output_threshold: float = 0.5,
    platforms: Optional[Sequence[str]] = None,
) -> bytes:
    """Serialize the jitted serving program (weights baked in) to bytes.

    ``input_shape`` includes the batch dim, e.g. ``(8, 64, 64, 64, 1)``.
    The result round-trips through :func:`load_infer` in any process on one
    of ``platforms`` (``jax.export`` names: ``cuda``, ``cpu``; default: the
    current backend) — no model class, config, or checkpoint needed on the
    serving side.

    Packed IO (voxel serving over thin links, where float grids dominate
    request latency): ``packed_input`` takes ``x`` as (B, N/8) uint8
    occupancy bits (``np.packbits`` order, data/packing.py) and unpacks
    in-graph; ``packed_output`` replaces the float ``pred`` with
    ``pred_packed`` uint8 bits at ``output_threshold`` — 32x less transfer
    each way.
    """
    import math

    from anytime3d_tpu.data.packing import pack_voxels_device, unpack_voxels

    infer = make_infer_fn(model, prior_means=prior_means, correction=correction)
    z_cat_dim = model.config.z_category_dim or model.config.z_inst_dim
    batch = input_shape[0]
    item_shape = tuple(input_shape[1:])

    def closed(x, mask):
        if packed_input:
            x = unpack_voxels(x, item_shape, dtype=jnp.float32)
        out = infer(params, x, mask)
        if packed_output:
            out["pred_packed"] = pack_voxels_device(
                out.pop("pred"), output_threshold
            )
        return out

    if packed_input:
        if model.config.encoder != "voxel":
            raise ValueError("packed_input requires a voxel encoder")
        x_spec = jax.ShapeDtypeStruct(
            (batch, math.prod(item_shape) // 8), jnp.uint8
        )
    else:
        x_spec = jax.ShapeDtypeStruct(tuple(input_shape), input_dtype)
    exported = jax_export.export(jax.jit(closed), platforms=_platforms(platforms))(
        x_spec,
        jax.ShapeDtypeStruct((batch, z_cat_dim), jnp.float32),
    )
    return serialize_exported(exported)


def export_detector(
    model,
    params,
    image_shape,
    obj_thresh: float = 0.5,
    iou_thresh: float = 0.5,
    reconstruct: bool = True,
    input_dtype=jnp.float32,
    platforms: Optional[Sequence[str]] = None,
) -> bytes:
    """Serialize the detector serving program: one frame in, fixed-size
    padded detections (+ decoded shapes) out.

    The program is ``DetectorReconstructor.detect`` (vectorized grid decode,
    per-cell winner, top-K + fixed-shape NMS — the jit-able re-design of
    nolbo_test.py:81-188's host loop) followed, when ``reconstruct`` is on,
    by the deterministic posterior-mean decode of all K slots in one batched
    decoder call. ``image_shape`` includes the leading batch dim and must be
    (1, H, W, 3) — detection is per-frame; serve frames through
    ``serving.batcher`` ahead of this program if needed. Thresholds are
    baked in as constants (static under jit).

    Outputs: ``bbox2d`` (K, 5) [x0, y0, x1, y1, score] normalized, ``valid``
    (K,) bool, per-slot ``ori_sin``/``ori_cos``/``rad_log_var``/``bbox3d``/
    ``z_mean``/``z_log_var`` — and ``vox`` (K, D, H, W) occupancies when
    reconstructing. Deserialize with :func:`load_infer` (signature
    ``fn(images) -> dict``) on one of ``platforms`` (default: the current
    backend)."""
    from anytime3d_tpu.models.detector import DetectorReconstructor

    if tuple(image_shape)[0] != 1:
        raise ValueError(f"detector serving is per-frame; got batch {image_shape[0]}")

    def closed(images):
        out = model.apply(
            {"params": params},
            images,
            obj_thresh,
            iou_thresh,
            method=DetectorReconstructor.detect,
        )
        if reconstruct:
            out = dict(out)
            out["vox"] = model.apply(
                {"params": params},
                None,  # key unused on the deterministic path
                out["z_mean"],
                out["z_log_var"],
                False,  # sample=False: posterior-mean decode
                method=DetectorReconstructor.reconstruct,
            )
        return out

    exported = jax_export.export(jax.jit(closed), platforms=_platforms(platforms))(
        jax.ShapeDtypeStruct(tuple(image_shape), input_dtype)
    )
    return serialize_exported(exported)


def load_infer(data: bytes):
    """Deserialize an exported serving program into ``fn(x, mask) -> outputs``.

    Compiles on first call; the loading process's backend must be one of
    the platforms the program was exported for (``exported.platforms``).
    """
    exported = deserialize_exported(data)
    return jax.jit(exported.call)
