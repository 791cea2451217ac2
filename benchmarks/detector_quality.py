"""Detector-reconstructor quality runner (VERDICT r1 item #6).

Trains DetectorReconstructor on the synthetic multi-object scene curriculum
(no real Pascal/KITTI grids ship in this image), then:
- runs the detection protocol: P/R at IoU 0.5, mAP@0.5 (VOC all-points AP),
  matched orientation MAE (evaluation/detection.py);
- runs ONE full ``scene_reconstruction`` frame end-to-end (detect -> decode
  shapes -> lift to metric poses -> project 3D boxes) and renders the
  overlay artifact the reference's visualizer draws by hand
  (/root/reference/src/visualizer/visualizer.py:208-308,
  /root/reference/src/module/nolbo_test.py:81-188).

Usage:
  python benchmarks/detector_quality.py --steps 4000 \
      --out docs/results/detector.json --artifact docs/results/detector_scene.png
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
    p.add_argument("--steps", type=int, default=4000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--image-size", type=int, nargs=2, default=(128, 96),
                   metavar=("COLS", "ROWS"))
    p.add_argument("--grid-size", type=int, nargs=2, default=(4, 3),
                   metavar=("COLS", "ROWS"))
    p.add_argument("--voxel-dim", type=int, default=32)
    p.add_argument("--max-slots", type=int, default=8)
    p.add_argument("--max-objects", type=int, default=3,
                   help="objects per scene upper bound (reference trains the "
                        "20x15-grid Pascal loader on multi-object scenes, "
                        "pascal3D.py:289-292; raise for reference-scale runs)")
    p.add_argument("--max-detections", type=int, default=16,
                   help="fixed-size selection budget K of the jitted detect "
                        "path (DetectorConfig.max_detections) — at 13x13 "
                        "grids the default 16 can bind")
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--eval-batches", type=int, default=8)
    p.add_argument("--train-samples", type=int, default=1024,
                   help="distinct objects in the procedural curriculum; the "
                   "1024 default memorizes — raise to train for held-out "
                   "detection (docs/results/README.md)")
    p.add_argument("--image-noise", type=float, default=0.0,
                   help="train-time Gaussian pixel noise sigma (anti-overfit)")
    p.add_argument("--photometric", action="store_true",
                   help="train-time photometric jitter (brightness/contrast/"
                        "blur/invert/hue-sat, data/augment.py::photometric_augment"
                        " — the reference imgAug pipeline analogue)")
    p.add_argument("--no-bbox3d", action="store_true",
                   help="drop the metric (w,h,l) supervision — the detection-"
                        "only operating point (A/B control for the with-3D "
                        "shared-trunk cost, r3 verdict weak #5)")
    p.add_argument("--save-path", default=None, help="checkpoint dir")
    p.add_argument("--out", required=True)
    p.add_argument("--artifact", default=None, help="scene overlay PNG path")
    p.add_argument("--jsonl", default=None)
    args = p.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from anytime3d_tpu.utils.profiling import enable_compilation_cache

    enable_compilation_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from anytime3d_tpu.data import SyntheticMultiObjectLoader
    from anytime3d_tpu.data.collate import collate_multiobject
    from anytime3d_tpu.evaluation.detection import evaluate_detector
    from anytime3d_tpu.models.detector import DetectorConfig, DetectorReconstructor
    from anytime3d_tpu.nn.autoencoder3d import Decoder3DConfig
    from anytime3d_tpu.train import create_train_state
    from anytime3d_tpu.train.detector_step import (
        DetectorLossConfig,
        make_detector_train_step,
    )
    from anytime3d_tpu.train.trainer import Trainer, TrainerConfig

    image_size = tuple(args.image_size)
    grid_size = tuple(args.grid_size)
    d = args.voxel_dim
    train_ld = SyntheticMultiObjectLoader(
        num_samples=args.train_samples, dim=d, image_size=image_size,
        grid_size=grid_size, max_objects=args.max_objects, seed=0
    )
    eval_ld = SyntheticMultiObjectLoader(
        num_samples=256, dim=d, image_size=image_size, grid_size=grid_size,
        max_objects=args.max_objects, seed=1
    )

    n_strides = 3 if d >= 32 else 2
    decoder = Decoder3DConfig(
        input_dim=16,
        output_shape=(d, d, d, 1),
        filter_nums=(128, 64, 32)[:n_strides] + (1,),
        filter_sizes=(4,) * (n_strides + 1),
        strides=(1,) + (2,) * n_strides,
    )
    dtype = jnp.bfloat16 if args.bf16 else jnp.float32
    model = DetectorReconstructor(
        DetectorConfig(decoder=decoder, max_detections=args.max_detections),
        dtype=dtype,
    )

    def make_batch_fn(loader, noise=0.0, seed=0, photometric=False, packed=True):
        noise_rng = np.random.default_rng(seed)

        def batch_fn(_it):
            images, targets, voxel_lists = loader.getNextBatch(args.batch_size)
            if photometric:
                from anytime3d_tpu.data.augment import photometric_augment

                images = np.stack(
                    [
                        photometric_augment(noise_rng, im * 255.0) / 255.0
                        for im in images
                    ]
                ).astype(np.float32)
            if noise > 0.0:
                images = np.clip(
                    images + noise_rng.normal(0.0, noise, images.shape), 0.0, 1.0
                ).astype(np.float32)
            b = collate_multiobject(
                images, targets, voxel_lists, max_slots=args.max_slots
            )
            if args.no_bbox3d:
                b.pop("bbox3d", None)
            if packed:
                # compact TRAIN transfer: uint8 images + bit-packed voxels
                # (raw float batches are 10 MB/step; a dispatch that outruns
                # a thin host->device link backs batches up on the host).
                # Eval batches stay float (the detection protocol feeds
                # images directly).
                from anytime3d_tpu.data.packing import pack_voxels

                vox = b.pop("voxels")
                B, S = vox.shape[:2]
                b["voxels_packed"] = pack_voxels(
                    vox.reshape(B * S, -1)
                ).reshape(B, S, -1)
                b["images"] = (np.clip(b["images"], 0.0, 1.0) * 255).astype(np.uint8)
            return {k: jnp.asarray(v) for k, v in b.items()}

        return batch_fn

    state = create_train_state(
        model,
        jnp.zeros((args.batch_size, image_size[1], image_size[0], 3), dtype),
        jax.random.PRNGKey(0),
        learning_rate=args.learning_rate,
    )
    step = make_detector_train_step(model, DetectorLossConfig(), donate=True)
    trainer = Trainer(
        model,
        state,
        make_batch_fn(train_ld, noise=args.image_noise, photometric=args.photometric),
        config=TrainerConfig(
            total_steps=args.steps, log_every=200, jsonl_path=args.jsonl,
            save_path=args.save_path, save_every=max(args.steps // 2, 1),
        ),
        step_fn=step,
    )
    t0 = time.time()
    final_state = trainer.run(epoch_fn=lambda: train_ld.epoch)
    train_s = time.time() - t0
    final_train = {k: round(v, 5) for k, v in trainer.logger.means().items()}
    print(f"\ntrained {args.steps} steps in {train_s:.1f}s; final:", final_train)

    # fixed eval batches so detection metrics are reproducible
    eval_batches = [
        make_batch_fn(eval_ld, packed=False)(i) for i in range(args.eval_batches)
    ]
    det = evaluate_detector(
        model, final_state.params, lambda i: eval_batches[i],
        num_batches=args.eval_batches, obj_thresh=0.5,
        collect_diagnostics=True,
    )
    # per-FN breakdown (VERDICT r4: small objects? crowding? shading?) —
    # quantiles of area / max-GT-overlap / brightness, missed vs detected
    def _qs(recs, key):
        v = np.asarray([r[key] for r in recs], np.float64)
        if not v.size:
            return None
        return {
            "n": int(v.size),
            "q25": round(float(np.quantile(v, 0.25)), 4),
            "median": round(float(np.quantile(v, 0.5)), 4),
            "q75": round(float(np.quantile(v, 0.75)), 4),
            "mean": round(float(v.mean()), 4),
        }

    fn_recs = det.pop("fn_records")
    tp_recs = det.pop("tp_records")
    fn_breakdown = {
        "fn": {k: _qs(fn_recs, k) for k in ("area", "max_gt_overlap", "brightness")},
        "tp": {k: _qs(tp_recs, k) for k in ("area", "max_gt_overlap", "brightness")},
    }
    print("FN breakdown:", json.dumps(fn_breakdown))
    # AP benefits from the full score range: rerun matching at a low threshold
    det_lowt = evaluate_detector(
        model, final_state.params, lambda i: eval_batches[i],
        num_batches=args.eval_batches, obj_thresh=0.1,
    )
    det["map50_full_curve"] = det_lowt["map50"]
    print("detection eval:", {k: round(float(v), 4) for k, v in det.items()})

    # train-set detection: separates can't-generalize from can't-detect-at-
    # all (a structural decode/protocol failure shows up here too)
    train_eval_batches = [
        make_batch_fn(train_ld, packed=False)(i) for i in range(args.eval_batches)
    ]
    det_train = evaluate_detector(
        model, final_state.params, lambda i: train_eval_batches[i],
        num_batches=args.eval_batches, obj_thresh=0.1,
    )
    print("TRAIN-set detection:", {k: round(float(v), 4) for k, v in det_train.items()})

    artifact = None
    if args.artifact:
        from anytime3d_tpu.evaluation.viz import draw_scene
        from anytime3d_tpu.models.pipeline import scene_reconstruction

        frame = np.asarray(eval_batches[0]["images"][0:1], np.float32)
        scene = scene_reconstruction(
            model, final_state.params, jnp.asarray(frame), jax.random.PRNGKey(0),
            image_size_px=image_size, obj_thresh=0.3,
        )
        img = draw_scene(frame[0], {k: np.asarray(v) for k, v in scene.items()})
        os.makedirs(os.path.dirname(args.artifact) or ".", exist_ok=True)
        import cv2

        cv2.imwrite(args.artifact, img[..., ::-1])  # RGB -> BGR on disk
        artifact = args.artifact
        n_det = int(np.asarray(scene["valid_det"]).sum())
        n_valid = int(np.asarray(scene["valid"]).sum())
        print(f"scene artifact: {artifact} ({n_det} detections drawn, "
              f"{n_valid} lifted to metric 3D)")

    result = {
        "steps": args.steps,
        "batch_size": args.batch_size,
        "image_size": list(image_size),
        "grid_size": list(grid_size),
        "voxel_dim": d,
        "dtype": "bfloat16" if args.bf16 else "float32",
        "learning_rate": args.learning_rate,
        "train_samples": args.train_samples,
        "image_noise": args.image_noise,
        "photometric": args.photometric,
        "max_objects": args.max_objects,
        "max_detections": args.max_detections,
        "train_seconds": round(train_s, 1),
        "train_ms_per_step": round(train_s / max(args.steps, 1) * 1e3, 2),
        "images_per_second": round(args.batch_size * args.steps / max(train_s, 1e-9), 1),
        "fn_breakdown": fn_breakdown,
        "final_train": final_train,
        "detection": {k: round(float(v), 5) for k, v in det.items()},
        "detection_trainset": {k: round(float(v), 5) for k, v in det_train.items()},
        "artifact": artifact,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
