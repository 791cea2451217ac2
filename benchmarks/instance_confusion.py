"""Instance-identity confusion diagnosis for the structural curriculum.

VERDICT r4 #6: if the structural acc_inst scaling curve plateaus, diagnose
WHICH instance pairs confuse. Loads params saved by
``quality_image.py --save-params``, encodes held-out single views, and
classifies the instance latent against the (GT-category-conditioned)
instance-prior means exactly like the eval protocol
(/root/reference/src/module/nolbo.py:166-181 semantics, anytime/engine.py).
Emits the pooled 10x10 instance confusion matrix (rows = true instance,
cols = predicted, summed over categories) plus the most-confused pairs.

Usage:
  python benchmarks/instance_confusion.py --params runs/structural_64k_params \
      --out docs/results/instance_confusion_64k.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="pascal_nolbo")
    p.add_argument("--params", required=True)
    p.add_argument("--objects", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--inst-spread", type=float, default=0.4)
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

    from anytime3d_tpu.data.modelnet import SyntheticImageObjectLoader
    from anytime3d_tpu.models import configs
    from anytime3d_tpu.models.mmvae import MultiModalVAE
    from anytime3d_tpu.train.checkpoint import restore_params

    model_cfg, _ = configs.variant(args.config)
    model = MultiModalVAE(model_cfg, dtype=jnp.bfloat16)
    n_cls = model_cfg.category_dim or 12
    n_inst = model_cfg.inst_dim or 10
    es, B = args.image_size, args.batch_size

    template = model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, es, es, 3), jnp.bfloat16),
        method=model.initialize,
    )["params"]
    params = jax.device_put(restore_params(args.params, jax.device_get(template)))

    ld = SyntheticImageObjectLoader(
        num_samples=args.objects, dim=model_cfg.decoder.output_shape[0],
        num_classes=n_cls, num_inst=n_inst, seed=1,
        inst_spread=args.inst_spread, structural_inst=True,
    )

    def classify_batch(pr, images, cat_oh):
        x = images.astype(jnp.bfloat16) / 255.0
        enc = model.apply({"params": pr}, x, method=MultiModalVAE.encode)
        z_inst = enc.mean_inst.astype(jnp.float32)
        eye_i = jnp.eye(n_inst, dtype=jnp.float32)
        cat_rep = jnp.repeat(cat_oh, n_inst, axis=0)
        inst_means, _ = model.apply(
            {"params": pr},
            jnp.concatenate([cat_rep, jnp.tile(eye_i, (B, 1))], -1),
            method=MultiModalVAE.priors_inst,
        )
        inst_means = inst_means.reshape(B, n_inst, -1)
        d2 = jnp.sum(jnp.square(z_inst[:, None] - inst_means), -1)
        return jnp.argmin(d2, -1)

    cls_oh_all = np.eye(n_cls, dtype=np.float32)[ld._labels[: args.objects]]
    jit_cls = jax.jit(classify_batch)
    conf = np.zeros((n_inst, n_inst), int)
    per_class_acc = np.zeros(n_cls)
    per_class_n = np.zeros(n_cls)
    nb = args.objects // B
    for bi in range(nb):
        sl = slice(bi * B, (bi + 1) * B)
        imgs = np.stack([
            (ld._render(ld._make(i), float(ld._azimuths[i]), (es, es))[..., 0]
             * 255).astype(np.uint8)
            for i in range(sl.start, sl.stop)
        ])
        imgs = np.repeat(imgs[..., None], 3, axis=-1)
        pred = np.asarray(jit_cls(params, jnp.asarray(imgs),
                                  jnp.asarray(cls_oh_all[sl])))
        true = ld._insts[sl]
        cls = ld._labels[sl]
        for t, q, c in zip(true, pred, cls):
            conf[t, q] += 1
            per_class_n[c] += 1
            per_class_acc[c] += float(t == q)

    acc = float(np.trace(conf) / max(conf.sum(), 1))
    # most-confused ordered pairs (true -> predicted), off-diagonal
    off = [
        {"true_inst": int(t), "pred_inst": int(q), "count": int(conf[t, q]),
         "frac_of_true": round(float(conf[t, q] / max(conf[t].sum(), 1)), 4)}
        for t in range(n_inst) for q in range(n_inst)
        if t != q and conf[t, q] > 0
    ]
    off.sort(key=lambda r: -r["count"])
    result = {
        "config": args.config,
        "params": args.params,
        "objects": nb * B,
        "acc_inst": round(acc, 5),
        "per_class_acc": [
            round(float(a / max(n, 1)), 4)
            for a, n in zip(per_class_acc, per_class_n)
        ],
        "confusion_inst": conf.tolist(),
        "top_confusions": off[:15],
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print("wrote", args.out, "acc_inst", acc)
    for r in off[:8]:
        print(f"  inst {r['true_inst']} -> {r['pred_inst']}: {r['count']} "
              f"({r['frac_of_true']:.0%} of true-{r['true_inst']})")


if __name__ == "__main__":
    sys.exit(main())
