"""Quality-parity runner: train a ModelNet-family variant to convergence and
run the full reference evaluation protocol, emitting an auditable JSON.

Reproduces (on the class-informative synthetic ModelNet40 stand-in — no real
shards ship in this image):
- the anytime degradation sweep at missing rates {0.3, 0.5, 0.7, 0.9},
  uncorrected vs prior-corrected (/root/reference/src/module/nolbo.py:199-259,
  /root/reference/test_modelnet_3D.py:117-143);
- the PR curve with the notebook's acceptance-probability tail
  (/root/reference/modelnetAE3.ipynb cell 2);
- category accuracy by nearest prior mean (nolbo.py:214-227), with external
  ``category_vectors`` for the AE/VAE variants (test_modelnet_getLatents.py).

Usage (one run per variant; results assembled into RESULTS.md):
  python benchmarks/quality_parity.py --config modelnet_nolbo --steps 20000 \
      --out docs/results/modelnet_nolbo.json
  python benchmarks/quality_parity.py --config modelnet_nolbo --classic \
      --out docs/results/modelnet_nolbo_classic.json   # layout A/B
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def classic_layout(model_cfg):
    """Rewrite a config to the reference's classic layout (stride-2 transposed
    convs end-to-end): final_mode='transpose', no blocked head/tail, no
    space-to-depth stem — the blocked-vs-classic quality A/B axis."""
    enc = dataclasses.replace(
        model_cfg.encoder3d, stem_space_to_depth=1, head_blocked=False
    )
    dec = dataclasses.replace(
        model_cfg.decoder, final_mode="transpose", tail_blocked=False
    )
    return dataclasses.replace(model_cfg, encoder3d=enc, decoder=dec)


def apply_layout(model_cfg, layout: str):
    """Layout A/B axis incl. the half-and-half diagnostics (r4, VERDICT weak
    #3: which half of the blocked layout costs category accuracy?):

    - ``blocked``: the flagship default (blocked head AND tail);
    - ``classic``: the reference layout end-to-end;
    - ``enc_blocked``: blocked encoder head, CLASSIC decoder;
    - ``dec_blocked``: classic encoder, blocked decoder tail.
    """
    if layout == "blocked":
        return model_cfg
    if layout == "classic":
        return classic_layout(model_cfg)
    if layout == "enc_blocked":
        dec = dataclasses.replace(
            model_cfg.decoder, final_mode="transpose", tail_blocked=False
        )
        return dataclasses.replace(model_cfg, decoder=dec)
    if layout == "dec_blocked":
        enc = dataclasses.replace(
            model_cfg.encoder3d, stem_space_to_depth=1, head_blocked=False
        )
        return dataclasses.replace(model_cfg, encoder3d=enc)
    if layout in ("blocked_initfix", "blocked_phasenorm", "blocked_dynfix"):
        # r5 in-place fixes for the blocked tail's training dynamics
        # (KERNELS.md §5: ~sqrt(8) init fan-in shift + per-phase GroupNorm
        # statistics). Same 14.3 ms layout, classic-matched dynamics knobs.
        dec = dataclasses.replace(
            model_cfg.decoder,
            tail_init_match_transpose=layout in ("blocked_initfix", "blocked_dynfix"),
            tail_phase_norm=layout in ("blocked_phasenorm", "blocked_dynfix"),
        )
        return dataclasses.replace(model_cfg, decoder=dec)
    if layout == "ps_final":
        # blocked head + pixel-shuffle FINAL only (no blocked penultimate
        # stage): the r4 A/B isolated the accuracy cost to the blocked tail;
        # this point locates it within the tail (last stage vs penultimate)
        dec = dataclasses.replace(model_cfg.decoder, tail_blocked=False)
        return dataclasses.replace(model_cfg, decoder=dec)
    raise SystemExit(f"unknown layout {layout!r}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True,
                   help="modelnet_nolbo | modelnet_vae | modelnet_ae | ae3d")
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--train-samples", type=int, default=4096)
    p.add_argument("--eval-samples", type=int, default=1024)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--classic", action="store_true",
                   help="classic reference layout instead of the blocked default layout")
    p.add_argument("--layout", default=None,
                   choices=["blocked", "classic", "enc_blocked", "dec_blocked",
                            "ps_final", "blocked_initfix", "blocked_phasenorm",
                            "blocked_dynfix"],
                   help="layout A/B axis incl. half-and-half diagnostics "
                        "(overrides --classic)")
    p.add_argument("--structural-inst", action="store_true",
                   help="procedural part-based CAD instance curriculum "
                        "(data/instances.py) instead of the analytic families")
    p.add_argument("--fp32", action="store_true", help="disable bf16 compute")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend")
    p.add_argument("--out", required=True)
    p.add_argument("--jsonl", default=None, help="training metrics JSONL path")
    p.add_argument("--eval-batches", type=int, default=16)
    args = p.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from anytime3d_tpu.utils.profiling import enable_compilation_cache

    enable_compilation_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from anytime3d_tpu.data.modelnet import SyntheticVoxelLoader
    from anytime3d_tpu.evaluation import (
        category_vectors,
        evaluate_epoch,
        missing_rate_sweep,
        pr_curve,
    )
    from anytime3d_tpu.anytime import anytime_eval_jit
    from anytime3d_tpu.models import configs
    from anytime3d_tpu.models.mmvae import MultiModalVAE
    from anytime3d_tpu.train import create_train_state
    from anytime3d_tpu.train.trainer import Trainer, TrainerConfig

    model_cfg, loss_cfg = configs.variant(args.config)
    layout = args.layout or ("classic" if args.classic else "blocked")
    model_cfg = apply_layout(model_cfg, layout)
    dtype = jnp.float32 if args.fp32 else jnp.bfloat16
    model = MultiModalVAE(model_cfg, dtype=dtype)
    n_cls = model_cfg.category_dim or 40

    train_ld = SyntheticVoxelLoader(
        num_samples=args.train_samples, dim=args.dim, num_classes=n_cls, seed=0,
        structural_inst=args.structural_inst,
    )
    eval_ld = SyntheticVoxelLoader(
        num_samples=args.eval_samples, dim=args.dim, num_classes=n_cls, seed=1,
        structural_inst=args.structural_inst,
    )

    def to_batch(b):
        out = {
            "input": jnp.asarray(b["input_images"]),
            "target": jnp.asarray(b["input_images"]),
        }
        out["category_onehot"] = jnp.asarray(b["class_list"])
        return out

    # train batches ride the production bit-packed transfer (cli/train.py
    # --packed): 32x less host->device traffic than raw 64^3 float batches
    from anytime3d_tpu.data.packing import pack_voxels, pack_voxels_blocked
    from anytime3d_tpu.models.mmvae import blocked_io_block

    block = blocked_io_block(model_cfg)

    def to_train_batch(b):
        if block is not None:
            out = {
                "input_packed_blocked": jnp.asarray(
                    pack_voxels_blocked(b["input_images"], block)
                )
            }
        else:
            out = {"input_packed": jnp.asarray(pack_voxels(b["input_images"]))}
        out["category_onehot"] = jnp.asarray(b["class_list"])
        return out

    def train_batch_fn(_it):
        return to_train_batch(train_ld.getNextBatch(args.batch_size))

    # fixed eval batches, reused identically across rates/models
    eval_ld_batches = [
        to_batch(eval_ld.getNextBatch(args.batch_size)) for _ in range(args.eval_batches)
    ]

    def eval_batch_fn(i):
        return eval_ld_batches[i % len(eval_ld_batches)]

    state = create_train_state(
        model,
        jnp.zeros((args.batch_size, args.dim, args.dim, args.dim, 1), dtype),
        jax.random.PRNGKey(0),
        learning_rate=args.learning_rate,
    )
    trainer = Trainer(
        model,
        state,
        train_batch_fn,
        loss_config=loss_cfg,
        config=TrainerConfig(
            total_steps=args.steps,
            log_every=200,
            eval_every=0,
            jsonl_path=args.jsonl,
        ),
    )
    t0 = time.time()
    final_state = trainer.run(epoch_fn=lambda: train_ld.epoch)
    train_s = time.time() - t0
    params = final_state.params
    final_train = {k: round(v, 5) for k, v in trainer.logger.means().items()}
    print(f"\ntrained {args.steps} steps in {train_s:.1f}s; final:", final_train)

    # ---- prior anchors: priornet for nolbo, category_vectors for AE/VAE
    # (test_modelnet_getLatents.py:93-115 -> nolbo.py:632-698 eval)
    prior_means = None
    if model_cfg.prior_category is None:
        def cv_batch_fn(i):
            return to_batch(train_ld.getNextBatch(args.batch_size))

        prior_means = jnp.asarray(
            category_vectors(model, params, cv_batch_fn, n_cls, num_batches=32)
        )

    # ---- full-observation eval + anytime degradation sweep
    eval_full = evaluate_epoch(
        model, params, eval_batch_fn, num_batches=args.eval_batches,
        missing_prob=0.0, prior_means=prior_means,
    )
    sweep = missing_rate_sweep(
        model, params, eval_batch_fn, rates=(0.3, 0.5, 0.7, 0.9),
        num_batches=args.eval_batches, prior_means=prior_means,
    )

    # ---- PR curve with acceptance tail at missing 0.3 (the notebook's
    # protocol: div=20 thresholds (i+1)/20 + 0.1**i acceptance rows)
    preds, preds_c, targets = [], [], []
    for i in range(min(8, args.eval_batches)):
        b = eval_batch_fn(i)
        m = anytime_eval_jit(
            model, params, b, jax.random.PRNGKey(7000 + i),
            missing_prob=0.3, prior_means=prior_means, return_pred=True,
        )
        preds.append(np.asarray(m["pred"], np.float32))
        preds_c.append(np.asarray(m["pred_corrected"], np.float32))
        targets.append(np.asarray(b["target"], np.float32))
    target = jnp.asarray(np.concatenate(targets))
    thresholds = [(i + 1) / 20 for i in range(19)]
    curve = pr_curve(target, jnp.asarray(np.concatenate(preds)),
                     thresholds=thresholds, acceptance_div=10)
    curve_c = pr_curve(target, jnp.asarray(np.concatenate(preds_c)),
                       thresholds=thresholds, acceptance_div=10)

    result = {
        "config": args.config,
        "layout": layout,
        "structural_inst": args.structural_inst,
        "steps": args.steps,
        "batch_size": args.batch_size,
        "dim": args.dim,
        "dtype": "float32" if args.fp32 else "bfloat16",
        "train_seconds": round(train_s, 1),
        "train_samples": args.train_samples,
        "eval_samples": args.eval_samples,
        "final_train": final_train,
        "eval_full": {k: round(float(v), 5) for k, v in eval_full.items()},
        "sweep": {
            str(r): {k: round(float(v), 5) for k, v in m.items()}
            for r, m in sweep.items()
        },
        "pr_curve_missing03": {k: v.tolist() for k, v in curve.items()},
        "pr_curve_missing03_corrected": {k: v.tolist() for k, v in curve_c.items()},
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print("wrote", args.out)
    for r in ("0.3", "0.5", "0.7", "0.9"):
        m = result["sweep"][r]
        line = f"rate {r}: P {m['precision']:.3f} R {m['recall']:.3f}"
        if "precision_corrected" in m:
            line += f" | corrected P {m['precision_corrected']:.3f} R {m['recall_corrected']:.3f}"
        if "acc_category" in m:
            line += f" | acc {m['acc_category']:.3f}"
            if "acc_category_corrected" in m:
                line += f" -> {m['acc_category_corrected']:.3f}"
        print(line)


if __name__ == "__main__":
    main()
