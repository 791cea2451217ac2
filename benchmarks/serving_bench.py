"""Serving-stack benchmark: MicroBatcher latency/throughput on real hardware.

Measures the full serving path — exported StableHLO program (weights baked
in), fixed-shape micro-batching, device round trip, per-item result
distribution — at 1/8/32 concurrent closed-loop clients, for both transfer
formats:

- ``packed``: uint8 bit IO (1 bit/voxel each way, serving/export.py
  packed_input/packed_output) — the production transfer format;
- ``float``: raw float32 grids (the naive format; 1 MB/item each way).

Writes ONE JSON with p50/p99 per-request latency (ms) and steady-state
shapes/s per concurrency level.

Usage (on a GPU):
  python benchmarks/serving_bench.py --out runs/serving_bench.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench_level(mb, make_item, mask, clients: int, per_client: int):
    lat = []
    errs = []

    def client(ci):
        item = make_item(ci)
        for _ in range(per_client):
            t0 = time.perf_counter()
            try:
                mb.submit(item, mask).result(timeout=300)
            except Exception as e:  # pragma: no cover
                errs.append(repr(e))
                return
            lat.append(time.perf_counter() - t0)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errs:
        raise RuntimeError(f"{len(errs)} client errors, first: {errs[0]}")
    lat_ms = np.asarray(lat) * 1e3
    return {
        "clients": clients,
        "requests": len(lat),
        "p50_ms": round(float(np.percentile(lat_ms, 50)), 2),
        "p99_ms": round(float(np.percentile(lat_ms, 99)), 2),
        "mean_ms": round(float(lat_ms.mean()), 2),
        "shapes_per_s": round(len(lat) / wall, 2),
        "batches_run": mb.batches_run,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--per-client", type=int, default=16)
    p.add_argument("--levels", default="1,8,32")
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--skip-float", action="store_true",
                   help="packed variant only (the float path is slow on thin links)")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from anytime3d_tpu.utils.profiling import enable_compilation_cache

    enable_compilation_cache()

    import jax
    import jax.numpy as jnp

    from anytime3d_tpu.data.packing import pack_voxels
    from anytime3d_tpu.models import configs
    from anytime3d_tpu.models.mmvae import MultiModalVAE
    from anytime3d_tpu.serving import MicroBatcher, export_infer, load_infer
    from anytime3d_tpu.train import create_train_state

    model_cfg, _ = configs.variant("modelnet_nolbo")
    model = MultiModalVAE(model_cfg, dtype=jnp.bfloat16)
    d = args.dim
    state = create_train_state(
        model, jnp.zeros((args.batch_size, d, d, d, 1), jnp.bfloat16),
        jax.random.PRNGKey(0),
    )
    z = model_cfg.z_category_dim
    shape = (args.batch_size, d, d, d, 1)
    rng = np.random.default_rng(0)
    vox = (rng.uniform(size=(64, d, d, d, 1)) > 0.7).astype(np.float32)
    mask = np.ones((z,), np.float32)
    levels = [int(x) for x in args.levels.split(",")]

    result = {
        "model": "modelnet_nolbo (bf16)",
        "batch_size": args.batch_size,
        "dim": d,
        "max_wait_ms": args.max_wait_ms,
        "per_client": args.per_client,
        "backend": jax.default_backend(),
        "variants": {},
    }

    def run_variant(name, data, item_of, input_shape, input_dtype):
        fn = load_infer(data)
        mb = MicroBatcher(
            fn, batch_size=args.batch_size, input_shape=input_shape,
            mask_dim=z, max_wait_s=args.max_wait_ms / 1e3,
            input_dtype=input_dtype,
        )
        # warm-up: compile + one full batch
        futs = [mb.submit(item_of(i), mask) for i in range(args.batch_size)]
        t0 = time.perf_counter()
        for f in futs:
            f.result(timeout=1200)
        warm = time.perf_counter() - t0
        out = {
            "artifact_bytes": len(data),
            "first_batch_s": round(warm, 2),
            "levels": [
                bench_level(mb, item_of, mask, c, args.per_client)
                for c in levels
            ],
        }
        mb.close()
        result["variants"][name] = out
        print(name, json.dumps(out["levels"]))

    packed_bytes = export_infer(
        model, state.params, shape, packed_input=True, packed_output=True
    )
    packed_items = pack_voxels(vox)
    run_variant(
        "packed", packed_bytes, lambda i: packed_items[i % 64],
        (d * d * d // 8,), np.uint8,
    )
    if not args.skip_float:
        float_bytes = export_infer(model, state.params, shape)
        run_variant(
            "float", float_bytes, lambda i: vox[i % 64], (d, d, d, 1), np.float32
        )

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
