"""Multi-device scaling benchmark: frames/s at 1 device vs an N-device mesh.

The north-star target (BASELINE.md) is >=80% frames/s scaling efficiency
from 1 host to a multi-host slice. This harness measures it wherever it
runs: on a GPU host it uses all local devices; on CPU it runs the
same code on a virtual mesh (validates sharding semantics, not speed):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python benchmarks/scaling.py --force-cpu --tiny

Prints one JSON line per mesh size: {devices, ms_per_step, frames_per_s,
efficiency_vs_1}. Batch scales with the mesh (weak scaling, per-device
batch fixed) — the production regime for data parallelism.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--per-device-batch", type=int, default=32)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--tiny", action="store_true",
                        help="16^3 grids / small model (CPU-mesh validation)")
    parser.add_argument("--force-cpu", action="store_true")
    parser.add_argument("--model-axis", type=int, default=1,
                        help="devices on the tensor-parallel 'model' axis")
    args = parser.parse_args(argv)

    if args.force_cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    from anytime3d_tpu.models import configs
    from anytime3d_tpu.models.mmvae import MMVAEConfig, MultiModalVAE
    from anytime3d_tpu.nn.autoencoder3d import Decoder3DConfig, Encoder3DConfig
    from anytime3d_tpu.nn.priornet import PriorNetConfig
    from jax.sharding import NamedSharding, PartitionSpec as P

    from anytime3d_tpu.parallel import make_mesh, param_sharding_rules, shard_batch
    from anytime3d_tpu.train import LossConfig, create_train_state, make_train_step
    from anytime3d_tpu.utils.profiling import enable_compilation_cache

    enable_compilation_cache()

    if args.tiny:
        z = 8
        cfg = MMVAEConfig(
            z_category_dim=z, z_inst_dim=0, category_dim=4, encoder="voxel",
            encoder3d=Encoder3DConfig(
                output_dim=2 * z, filter_nums=(8, 16), filter_sizes=(3, 3, 3),
                strides=(2, 2, 1),
            ),
            decoder=Decoder3DConfig(
                input_dim=z, output_shape=(16, 16, 16, 1), filter_nums=(16, 8, 1),
                filter_sizes=(3, 3, 3), strides=(1, 2, 2),
            ),
            prior_category=PriorNetConfig(input_dim=4, unit_nums=(16, z), const_log_var=0.0),
        )
        dim, n_cls = 16, 4
    else:
        cfg = configs.modelnet_nolbo()
        dim, n_cls = 64, 40

    n_dev = len(jax.devices())
    sizes = sorted({1, n_dev} | {d for d in (2, 4, 8) if d <= n_dev})
    rng = np.random.default_rng(0)
    results = {}
    for nd in sizes:
        if nd % args.model_axis:
            continue
        b = args.per_device_batch * (nd // args.model_axis)
        vox = (rng.uniform(size=(b, dim, dim, dim, 1)) > 0.7).astype(np.float32)
        labels = np.eye(n_cls, dtype=np.float32)[rng.integers(0, n_cls, b)]
        batch = {
            "input": jnp.asarray(vox),
            "target": jnp.asarray(vox),
            "category_onehot": jnp.asarray(labels),
        }
        model = MultiModalVAE(cfg, dtype=jnp.bfloat16)
        state = create_train_state(model, batch["input"], jax.random.PRNGKey(0))
        step = make_train_step(model, LossConfig(), donate=True)
        if nd > 1:
            mesh = make_mesh(
                data=nd // args.model_axis, model=args.model_axis,
                devices=jax.devices()[:nd],
            )
            batch = shard_batch(batch, mesh)
            if args.model_axis > 1:
                # TP: channel-heavy kernels sharded on 'model'
                param_sh = param_sharding_rules(state.params, mesh)
                state = state.replace(
                    params=jax.tree_util.tree_map(
                        jax.device_put, state.params, param_sh
                    ),
                    opt_state=jax.device_put(state.opt_state, NamedSharding(mesh, P())),
                    step=jax.device_put(state.step, NamedSharding(mesh, P())),
                )

        for i in range(3):
            state, m = step(state, batch, jax.random.PRNGKey(i))
        jax.block_until_ready(m)
        t0 = time.perf_counter()
        for i in range(args.iters):
            state, m = step(state, batch, jax.random.PRNGKey(100 + i))
        float(m["loss_total"])
        dt = (time.perf_counter() - t0) / args.iters
        fps = b / dt
        results[nd] = fps
        eff = fps / (results[1] * nd) if 1 in results and nd > 1 else 1.0
        print(json.dumps({
            "devices": nd, "global_batch": b,
            "ms_per_step": round(dt * 1e3, 2),
            "frames_per_s": round(fps, 1),
            "efficiency_vs_1": round(eff, 3),
        }))


if __name__ == "__main__":
    main()
