"""Export CLI — serialize a trained model's serving program to StableHLO.

The reference has no deployment story: inference means re-running a test
script that rebuilds the graph from Python and restores per-submodel Keras
weights (/root/reference/test_modelnet_3D.py:60-114). This writes ONE
artifact a server loads with ``serving.load_infer`` — no model code, config,
or checkpoint needed on the serving side. The artifact is lowered for the
GPU (``cuda``), whatever machine exports it.

  python -m anytime3d_tpu.cli.export --config modelnet_nolbo \
      --ckpt ckpt/ --batch-size 8 --out model.stablehlo
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True)
    parser.add_argument("--ckpt", default=None,
                        help="checkpoint dir (omit: export init params, "
                             "useful only for smoke tests)")
    parser.add_argument("--batch-size", type=int, default=8,
                        help="the ONE compiled serving batch shape; "
                             "serving.MicroBatcher pads requests to it")
    parser.add_argument("--image-size", type=int, default=64)
    parser.add_argument("--no-correction", action="store_true",
                        help="skip the masked-latent prior fill")
    parser.add_argument("--prior-means", default=None,
                        help=".npy of (K, z_cat_dim) external category_vectors "
                             "for AE/VAE variants (test_modelnet_getLatents.py)")
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from anytime3d_tpu.models import configs
    from anytime3d_tpu.models.mmvae import MultiModalVAE
    from anytime3d_tpu.serving import export_infer
    from anytime3d_tpu.train import create_train_state
    from anytime3d_tpu.train.checkpoint import restore_state

    model_cfg = configs.REGISTRY[args.config]()
    model = MultiModalVAE(model_cfg)

    if model_cfg.encoder == "image":
        shape = (args.batch_size, args.image_size, args.image_size, 3)
    else:
        d = model_cfg.decoder.output_shape[0]
        shape = (args.batch_size, d, d, d, 1)

    state = create_train_state(
        model, jnp.zeros(shape, jnp.float32), jax.random.PRNGKey(0)
    )
    if args.ckpt:
        state = restore_state(args.ckpt, state)

    prior_means = (
        jnp.asarray(np.load(args.prior_means)) if args.prior_means else None
    )
    data = export_infer(
        model,
        state.params,
        input_shape=shape,
        prior_means=prior_means,
        correction=not args.no_correction,
        platforms=("cuda",),
    )
    with open(args.out, "wb") as f:
        f.write(data)
    print(f"wrote {args.out}: {len(data)} bytes, input {shape}")


if __name__ == "__main__":
    main()
