"""Multi-view anytime-fusion quality benchmark — the paper's titular claim.

The reference only SIMULATES accumulating observations by masking latent
dims of a single encode (/root/reference/src/module/nolbo.py:199-259).
This benchmark measures the real thing on the recursive Gaussian fusion
engine (anytime/engine.py::fuse_observation): for held-out objects, encode
N = 1..V *distinct rendered views* (different azimuths of the same object),
fuse the per-view posteriors precision-weighted in information form, decode
the fused mean, and sweep N. The anytime property to demonstrate:

  - IoU / P / R / category acc MONOTONE (non-decreasing) in N;
  - fused-N beats the best single view;
  - fused-N beats the reference's masked single-shot protocol at matched
    information (missing_prob = 1 - 1/N on one view).

Also reports a uniform-average ablation (fuse means with equal weight,
ignoring the encoder's per-dim log-var) to show the information filter's
precision weighting — not mere averaging — carries the gain, plus the
per-instance confusion matrix of the fused classifier (VERDICT r4 #6).

Usage (params from a benchmarks/quality_image.py --save-params run):
  python benchmarks/streaming_fusion.py --config pascal_nolbo \
      --structural-inst --params runs/structural_64k_params \
      --out docs/results/streaming_fusion.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="pascal_nolbo")
    p.add_argument("--params", required=True,
                   help="params dir from quality_image --save-params")
    p.add_argument("--structural-inst", action="store_true")
    p.add_argument("--inst-spread", type=float, default=0.4)
    p.add_argument("--objects", type=int, default=512,
                   help="held-out objects (seed=1 loader, disjoint from the "
                        "seed=0 training draw)")
    p.add_argument("--views", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--latent-mask", type=float, default=0.0,
                   help="PARTIAL observations in the reference's own model "
                        "(nolbo.py:199-208): each view reveals this "
                        "fraction of its posterior dims; fusion is the "
                        "masked information filter, unobserved dims take "
                        "the reference fill. In-distribution (unlike image "
                        "occlusion, which is OOD for an encoder trained on "
                        "full silhouettes — committed negative).")
    p.add_argument("--occlude", action="store_true",
                   help="PARTIAL observations: each view is occluded by a "
                        "random half-plane through the image center, so a "
                        "single frame genuinely under-determines the shape "
                        "(the anytime deployment story — observations "
                        "accumulate). Without it, full silhouettes are "
                        "near-redundant across views and every fusion "
                        "saturates at the single-view ceiling (measured).")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from anytime3d_tpu.utils.profiling import enable_compilation_cache

    enable_compilation_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from anytime3d_tpu.anytime import anytime_eval_jit
    from anytime3d_tpu.data.modelnet import SyntheticImageObjectLoader
    from anytime3d_tpu.data.packing import pack_voxels, unpack_voxels
    from anytime3d_tpu.models import configs
    from anytime3d_tpu.models.mmvae import MultiModalVAE
    from anytime3d_tpu.ops import focal_binary_loss, voxel_tp_fp_fn
    from anytime3d_tpu.train.checkpoint import restore_params

    model_cfg, _loss_cfg = configs.variant(args.config)
    model = MultiModalVAE(model_cfg, dtype=jnp.bfloat16)
    n_cls = model_cfg.category_dim or 12
    n_inst = model_cfg.inst_dim or 10
    dim = model_cfg.decoder.output_shape[0]
    V, B, es = args.views, args.batch_size, args.image_size

    # ---- params: init a template tree, restore into it
    template = model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, es, es, 3), jnp.bfloat16),
        method=model.initialize,  # trace priornets too (state.py:83)
    )["params"]
    params = restore_params(args.params, jax.device_get(template))
    params = jax.device_put(params)

    # ---- held-out objects + V distinct views each --------------------------
    ld = SyntheticImageObjectLoader(
        num_samples=args.objects, dim=dim, num_classes=n_cls, num_inst=n_inst,
        seed=1, inst_spread=args.inst_spread,
        structural_inst=args.structural_inst,
    )
    rng = np.random.default_rng(7)
    t_host = time.time()
    imgs = np.zeros((args.objects, V, es, es), np.uint8)
    vox_packed, vis_packed = [], []
    if args.occlude and es != dim:
        raise SystemExit("--occlude requires image_size == voxel dim (the "
                         "visibility back-projection assumes 1:1 pixels)")

    def visibility_mask(sx, sz, keep):
        """Voxels observed by a view: back-project the KEPT pixels through
        the same nearest-neighbour rotation the renderer uses (_render:
        rot[a,b,y] = vox[sx[a,b], y, sz[a,b]]; img[b,a] = max_y) — a pixel
        (b,a) observes the whole y-column at rotated (x,z) = (sx,sz)[a,b]."""
        mask2d = np.zeros((dim, dim), bool)  # (x, z) canonical
        kept = keep.T  # keep is (row=b, col=a) -> index by (a, b)
        mask2d[sx[kept], sz[kept]] = True
        return np.broadcast_to(mask2d[:, None, :], (dim, dim, dim))

    d_idx = np.arange(dim) - dim / 2 + 0.5
    gx, gz = np.meshgrid(d_idx, d_idx, indexing="ij")
    yy, xx = np.mgrid[0:es, 0:es]
    for i in range(args.objects):
        vox = ld._make(i)
        # V azimuths: uniformly spread with a random per-object offset, so
        # every N-prefix covers a growing arc (the streaming-camera story)
        az0 = rng.uniform(-np.pi, np.pi)
        for v in range(V):
            az = az0 + 2 * np.pi * v / V
            mono = ld._render(vox, az, (es, es))[..., 0]
            if args.occlude:
                th = rng.uniform(0.0, 2.0 * np.pi)
                cx = es / 2 + rng.uniform(-es / 8, es / 8)
                cy = es / 2 + rng.uniform(-es / 8, es / 8)
                keep = (
                    (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
                ) < 0.0
                mono = mono * keep
                c, s = np.cos(az), np.sin(az)
                sx = np.clip(np.round(c * gx - s * gz + dim / 2 - 0.5),
                             0, dim - 1).astype(int)
                sz = np.clip(np.round(s * gx + c * gz + dim / 2 - 0.5),
                             0, dim - 1).astype(int)
                vis = visibility_mask(sx, sz, keep)
                vis_packed.append(
                    pack_voxels(vis.astype(np.float32)[None, ..., None])[0]
                )
            imgs[i, v] = (mono * 255).astype(np.uint8)
        vox_packed.append(pack_voxels(vox[None, ..., None])[0])
    vox_packed = np.stack(vox_packed)
    vis_packed = (
        np.stack(vis_packed).reshape(args.objects, V, -1)
        if args.occlude else None
    )
    cls_idx = ld._labels[: args.objects]
    inst_idx = ld._insts[: args.objects]
    cls_oh = np.eye(n_cls, dtype=np.float32)[cls_idx]
    inst_oh = np.eye(n_inst, dtype=np.float32)[inst_idx]
    print(f"rendered {args.objects} objects x {V} views in "
          f"{time.time()-t_host:.1f}s", flush=True)

    # ---- prior anchors (category priornet over one-hots)
    eye = jnp.eye(model_cfg.prior_category.input_dim, dtype=jnp.float32)
    prior_means, _ = jax.jit(
        lambda pr: model.apply({"params": pr}, eye,
                               method=MultiModalVAE.priors_category)
    )(params)

    # ---- one jitted program: encode V views, fuse prefixes, decode, score
    def eval_batch(pr, images_u8, target_pk, cat_oh, inst_oh_b, vis_pk=None,
                   lat_mask=None):
        """images_u8 (B,V,es,es) -> metric sums for every N in 1..V.

        ``lat_mask`` (B,V,Dc+Di): per-view OBSERVED latent dims — the
        reference's partial-observation model (nolbo.py:199-208) applied to
        N real views. Fusion becomes the masked information filter
        (engine.fuse_observation with mask); unobserved-by-all dims take
        the reference's fill (mean of prior means / mean of the GT
        category's instance-prior means)."""
        target = unpack_voxels(target_pk, (dim, dim, dim, 1))
        x = images_u8.astype(jnp.bfloat16) / 255.0
        x = jnp.repeat(x[..., None], 3, axis=-1)  # mono -> RGB
        enc = model.apply(
            {"params": pr}, x.reshape(B * V, es, es, 3),
            method=MultiModalVAE.encode,
        )
        # GT-category-conditioned instance prior table (hoisted: score() and
        # the instance-block fill both need it)
        eye_i = jnp.eye(n_inst, dtype=jnp.float32)
        cat_rep = jnp.repeat(cat_oh, n_inst, axis=0)
        inst_prior_means, _ = model.apply(
            {"params": pr},
            jnp.concatenate([cat_rep, jnp.tile(eye_i, (B, 1))], -1),
            method=MultiModalVAE.priors_inst,
        )
        inst_prior_means = inst_prior_means.reshape(B, n_inst, -1)

        def blocks(mean, lv, mask=None, fill=None):
            mean = mean.astype(jnp.float32).reshape(B, V, -1)
            lv = lv.astype(jnp.float32).reshape(B, V, -1)
            prec = jnp.exp(-lv)
            w = prec if mask is None else mask * prec
            # information-filter prefix fusion: cumulative sums over views
            info_c = jnp.cumsum(mean * w, axis=1)
            prec_c = jnp.cumsum(w, axis=1)
            fused = info_c / jnp.maximum(prec_c, 1e-12)  # (B,V,D) after N
            nview = jnp.arange(1, V + 1, dtype=jnp.float32)[None, :, None]
            if mask is None:
                single = mean
                avg = jnp.cumsum(mean, axis=1) / nview
            else:
                fused = jnp.where(prec_c > 0, fused, fill)
                single = jnp.where(mask > 0, mean, fill)
                cnt = jnp.cumsum(mask, axis=1)
                avg = jnp.where(
                    cnt > 0,
                    jnp.cumsum(mask * mean, axis=1) / jnp.maximum(cnt, 1e-12),
                    fill,
                )
            return single, fused, avg

        if lat_mask is not None:
            zc = model_cfg.z_category_dim
            mk_cat, mk_inst = lat_mask[..., :zc], lat_mask[..., zc:]
            fill_cat = jnp.mean(prior_means, axis=0)[None, None]
            fill_inst = jnp.mean(inst_prior_means, axis=1)[:, None]
        else:
            mk_cat = mk_inst = None
            fill_cat = fill_inst = None
        m_cat, f_cat, a_cat = blocks(
            enc.mean_category, enc.log_var_category, mk_cat, fill_cat
        )
        m_inst, f_inst, a_inst = blocks(
            enc.mean_inst, enc.log_var_inst, mk_inst, fill_inst
        )

        def score(z_cat, z_inst):
            """(B,V,D) latents (index 1 = N or view) -> per-N metric sums."""
            z = jnp.concatenate([z_cat, z_inst], axis=-1).reshape(B * V, -1)
            pred = model.apply({"params": pr}, z, method=MultiModalVAE.decode)
            pred = pred.reshape(B, V, *pred.shape[1:])
            tgt = jnp.broadcast_to(target[:, None], pred.shape)
            tp, fp, fn = voxel_tp_fp_fn(
                tgt.reshape(B * V, -1), pred.reshape(B * V, -1)
            )
            tp = tp.reshape(B, V); fp = fp.reshape(B, V); fn = fn.reshape(B, V)
            loss = focal_binary_loss(
                pred.reshape(B * V, -1), tgt.reshape(B * V, -1)
            ).reshape(B, V)
            d2 = jnp.sum(
                jnp.square(z_cat[:, :, None, :] - prior_means[None, None]), -1
            )
            pred_cat = jnp.argmin(d2, axis=-1)  # (B, V)
            acc_cat = (pred_cat == jnp.argmax(cat_oh, -1)[:, None]).astype(
                jnp.float32
            )
            # instance id conditioned on the GT category (engine semantics,
            # nolbo.py:166-171)
            d2i = jnp.sum(
                jnp.square(z_inst[:, :, None, :] - inst_prior_means[:, None]),
                -1,
            )
            acc_inst = (
                jnp.argmin(d2i, -1) == jnp.argmax(inst_oh_b, -1)[:, None]
            ).astype(jnp.float32)
            iou = tp / (tp + fp + fn + 1e-9)
            return {
                "iou": iou, "loss_shape": loss, "acc_category": acc_cat,
                "acc_inst": acc_inst,
                "precision": tp / (tp + fp + 1e-9),
                "recall": tp / (tp + fn + 1e-9),
            }

        fused = score(f_cat, f_inst)          # index 1 = N (prefix fusion)
        single = score(m_cat, m_inst)         # index 1 = individual view
        avg = score(a_cat, a_inst)            # uniform-average ablation

        # occupancy-space product-of-experts fusion: per-view decoded grids
        # vote in log-odds; prefix-mean over views (engine.OccupancyBelief
        # semantics — associative, streamable). The latent mean/log-var do
        # not carry view certainty under the NOLBO KL, so THIS is where the
        # multi-view information actually combines.
        # (in latent-mask mode m_cat/m_inst are the masked+filled per-view
        # latents — the reference's single-shot protocol per view)
        z_v = jnp.concatenate([m_cat, m_inst], axis=-1).reshape(B * V, -1)
        pred_v = model.apply({"params": pr}, z_v, method=MultiModalVAE.decode)
        pred_v = pred_v.reshape(B, V, -1).astype(jnp.float32)
        pv = jnp.clip(pred_v, 1e-6, 1.0 - 1e-6)
        lo = jnp.cumsum(jnp.log(pv) - jnp.log1p(-pv), axis=1)
        pofe = jax.nn.sigmoid(lo / jnp.arange(1, V + 1)[None, :, None])
        tgt_flat = jnp.broadcast_to(
            target.reshape(B, 1, -1), pofe.shape
        ).reshape(B * V, -1)
        tp, fp, fn = voxel_tp_fp_fn(tgt_flat, pofe.reshape(B * V, -1))
        tp = tp.reshape(B, V); fp = fp.reshape(B, V); fn = fn.reshape(B, V)
        pofe_metrics = {
            "iou": tp / (tp + fp + fn + 1e-9),
            "precision": tp / (tp + fp + 1e-9),
            "recall": tp / (tp + fn + 1e-9),
            "loss_shape": focal_binary_loss(
                pofe.reshape(B * V, -1), tgt_flat
            ).reshape(B, V),
        }

        out = {}
        for k in fused:
            out[f"fused_{k}"] = jnp.sum(fused[k], axis=0)       # (V,) per N
            out[f"avg_{k}"] = jnp.sum(avg[k], axis=0)
            out[f"view_{k}"] = jnp.sum(single[k], axis=0)        # per view
        for k, v in pofe_metrics.items():
            out[f"pofe_{k}"] = jnp.sum(v, axis=0)

        if lat_mask is not None:
            # fraction of latent dims observed by SOME view among the first N
            out["lat_coverage"] = jnp.sum(
                jnp.mean(jax.lax.cummax(lat_mask, axis=1), axis=-1), axis=0
            )

        if vis_pk is not None:
            # visibility-masked occupancy fusion (engine.fuse_occupancy with
            # mask): only voxels a view SEES vote; unobserved stay at the
            # 0.5 prior (-> absent at threshold). The TSDF-style fusion.
            vis = unpack_voxels(
                vis_pk.reshape(B * V, -1), (dim, dim, dim, 1)
            ).reshape(B, V, -1)
            vote = jnp.log(pv) - jnp.log1p(-pv)
            lo_m = jnp.cumsum(vis * vote, axis=1)
            cnt = jnp.cumsum(vis, axis=1)
            visp = jax.nn.sigmoid(lo_m / jnp.maximum(cnt, 1.0))
            # never-observed voxels: exactly 0.5 -> push below threshold
            visp = jnp.where(cnt > 0, visp, 0.0)
            tp2, fp2, fn2 = voxel_tp_fp_fn(
                tgt_flat, visp.reshape(B * V, -1)
            )
            tp2 = tp2.reshape(B, V); fp2 = fp2.reshape(B, V); fn2 = fn2.reshape(B, V)
            out["vispofe_iou"] = jnp.sum(tp2 / (tp2 + fp2 + fn2 + 1e-9), axis=0)
            out["vispofe_precision"] = jnp.sum(tp2 / (tp2 + fp2 + 1e-9), axis=0)
            out["vispofe_recall"] = jnp.sum(tp2 / (tp2 + fn2 + 1e-9), axis=0)
            out["coverage"] = jnp.sum(
                jnp.mean((cnt > 0).astype(jnp.float32), axis=-1), axis=0
            )
        # best single view per object (oracle view selection)
        out["best_single_iou"] = jnp.sum(jnp.max(single["iou"], axis=1))
        out["first_single_iou"] = jnp.sum(single["iou"][:, 0])
        # fused-classifier prediction at N=V for the confusion matrix
        z_catV = f_cat[:, V - 1]
        d2 = jnp.sum(jnp.square(z_catV[:, None] - prior_means[None]), -1)
        out["pred_cat_fusedV"] = jnp.argmin(d2, -1)
        return out

    eval_jit = jax.jit(eval_batch)

    lat_masks = None
    if args.latent_mask > 0.0:
        z_total = model_cfg.z_category_dim + model_cfg.z_inst_dim
        lat_masks = (
            np.random.default_rng(11).random((args.objects, V, z_total))
            < args.latent_mask
        ).astype(np.float32)

    sums, preds_cat = None, []
    n_batches = args.objects // B
    t0 = time.time()
    for bi in range(n_batches):
        sl = slice(bi * B, (bi + 1) * B)
        out = eval_jit(
            params, jnp.asarray(imgs[sl]), jnp.asarray(vox_packed[sl]),
            jnp.asarray(cls_oh[sl]), jnp.asarray(inst_oh[sl]),
            jnp.asarray(vis_packed[sl]) if vis_packed is not None else None,
            jnp.asarray(lat_masks[sl]) if lat_masks is not None else None,
        )
        out = {k: np.asarray(v, np.float64) for k, v in out.items()}
        preds_cat.append(out.pop("pred_cat_fusedV").astype(int))
        sums = out if sums is None else {
            k: sums[k] + out[k] for k in sums
        }
    n = n_batches * B
    fuse_s = time.time() - t0
    print(f"fusion sweep ({n} objects, V={V}) in {fuse_s:.1f}s", flush=True)

    curves = {k: (v / n).round(5).tolist() for k, v in sums.items()}

    # ---- reference masked single-shot protocol at matched information ------
    # one view, missing_prob = 1 - 1/N: the per-dim Bernoulli keep-rate that
    # leaves the same expected fraction of "observed" latent information as
    # fusing N full views leaves per view (nolbo.py:199-208 semantics).
    masked_rows = {}
    for N in range(2, V + 1):
        rate = 1.0 - 1.0 / N
        ms, cnt = {}, 0
        for bi in range(n_batches):
            sl = slice(bi * B, (bi + 1) * B)
            x = imgs[sl, 0].astype(np.float32) / 255.0
            b = {
                "input": jnp.asarray(np.repeat(x[..., None], 3, -1)),
                "target": unpack_voxels(
                    jnp.asarray(vox_packed[sl]), (dim, dim, dim, 1)
                ),
                "category_onehot": jnp.asarray(cls_oh[sl]),
                "inst_onehot": jnp.asarray(inst_oh[sl]),
            }
            m = anytime_eval_jit(
                model, params, b, jax.random.PRNGKey(1000 * N + bi),
                missing_prob=rate, prior_means=prior_means,
                correction="resample_gated",
            )
            for k, v in m.items():
                ms[k] = ms.get(k, 0.0) + float(v)
            cnt += 1
        masked_rows[str(N)] = {k: round(v / cnt, 5) for k, v in ms.items()}

    # ---- per-instance confusion of the fused-V classifier
    pred_cat = np.concatenate(preds_cat)
    conf = np.zeros((n_cls, n_cls), int)
    for t, q in zip(cls_idx[:n], pred_cat):
        conf[t, q] += 1

    result = {
        "config": args.config,
        "params": args.params,
        "structural_inst": args.structural_inst,
        "objects": n,
        "views": V,
        "occlude": args.occlude,
        "latent_mask": args.latent_mask,
        "image_size": es,
        "dim": dim,
        "fusion_seconds": round(fuse_s, 1),
        "curves_vs_N": curves,
        "best_single_iou": round(float(sums["best_single_iou"] / n), 5),
        "first_single_iou": round(float(sums["first_single_iou"] / n), 5),
        "masked_protocol_matched_info": masked_rows,
        "confusion_category_fusedV": conf.tolist(),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print("wrote", args.out)

    vis_col = "vispofe_iou" in curves
    hdr = f"\n{'N':>2} "
    hdr += f"{'vis IoU':>8} {'cover':>6} " if vis_col else ""
    hdr += (f"{'pofe IoU':>9} {'fused IoU':>9} {'avg IoU':>8} "
            f"{'acc_cat':>8} {'acc_inst':>8} {'pofe R':>7}")
    print(hdr)
    for i in range(V):
        row = f"{i+1:>2} "
        if vis_col:
            row += (f"{curves['vispofe_iou'][i]:>8.4f} "
                    f"{curves['coverage'][i]:>6.3f} ")
        row += (f"{curves['pofe_iou'][i]:>9.4f} "
                f"{curves['fused_iou'][i]:>9.4f} "
                f"{curves['avg_iou'][i]:>8.4f} "
                f"{curves['fused_acc_category'][i]:>8.4f} "
                f"{curves['fused_acc_inst'][i]:>8.4f} "
                f"{curves['pofe_recall'][i]:>7.4f}")
        print(row)
    print(f"best single view IoU (oracle): {result['best_single_iou']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
