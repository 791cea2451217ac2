"""Serving CLI: stand up the HTTP inference endpoint.

Two modes:
- ``--artifact model.bin``: serve a pre-exported StableHLO program
  (serving/export.py; produce one with ``cli/export.py`` or
  ``export_infer`` directly);
- ``--config modelnet_nolbo --checkpoint DIR``: build the model, restore
  the checkpoint, export the packed-IO serving program in-process, serve.

The endpoint protocol is documented in serving/server.py.
"""

from __future__ import annotations

import argparse
import math


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--artifact", default=None, help="serialized serving program")
    p.add_argument("--config", default=None, help="REGISTRY name (export in-process)")
    p.add_argument("--checkpoint", default=None, help="checkpoint dir (train/checkpoint.py)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--mask-dim", type=int, default=None)
    p.add_argument("--item-bytes", type=int, default=None,
                   help="packed item length (defaults to dim^3/8)")
    p.add_argument("--port", type=int, default=8731)
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (default loopback; the endpoint is "
                        "unauthenticated — use 0.0.0.0 only deliberately)")
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--bf16", action="store_true")
    args = p.parse_args(argv)

    import numpy as np

    from anytime3d_tpu.serving.server import InferenceServer
    from anytime3d_tpu.utils.profiling import enable_compilation_cache

    enable_compilation_cache()

    if args.artifact:
        with open(args.artifact, "rb") as fh:
            data = fh.read()
        if args.mask_dim is None:
            raise SystemExit("--mask-dim is required with --artifact")
        item_bytes = args.item_bytes or args.dim**3 // 8
        mask_dim = args.mask_dim
    else:
        if not args.config:
            raise SystemExit("need --artifact or --config")
        import jax
        import jax.numpy as jnp

        from anytime3d_tpu.models import configs
        from anytime3d_tpu.models.mmvae import MultiModalVAE
        from anytime3d_tpu.serving.export import export_infer
        from anytime3d_tpu.train import create_train_state
        from anytime3d_tpu.train.checkpoint import restore_state

        model_cfg, _ = configs.variant(args.config)
        if model_cfg.encoder != "voxel":
            raise SystemExit("packed-IO serving needs a voxel-encoder config")
        dtype = jnp.bfloat16 if args.bf16 else jnp.float32
        model = MultiModalVAE(model_cfg, dtype=dtype)
        d = args.dim
        state = create_train_state(
            model, jnp.zeros((args.batch_size, d, d, d, 1), dtype),
            jax.random.PRNGKey(0),
        )
        if args.checkpoint:
            state = restore_state(args.checkpoint, state)
        data = export_infer(
            model, state.params, (args.batch_size, d, d, d, 1),
            packed_input=True, packed_output=True,
        )
        item_bytes = d**3 // 8
        mask_dim = model_cfg.z_category_dim or model_cfg.z_inst_dim

    server = InferenceServer(
        data, (item_bytes,), mask_dim, batch_size=args.batch_size,
        max_wait_s=args.max_wait_ms / 1e3, input_dtype=np.uint8,
    )
    print(f"serving on :{args.port} (item {item_bytes} B packed, "
          f"mask {mask_dim}, batch {args.batch_size})")
    try:
        server.serve(args.port, host=args.host)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


if __name__ == "__main__":
    main()
