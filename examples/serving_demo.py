"""Serving demo: export -> deploy -> concurrent requests through the batcher.

Exports a (randomly initialized) small NOLBO model to StableHLO bytes, then
serves it from the deserialized program only — the server half of this file
touches no model code. Swap `tiny_cfg()` for `configs.variant(...)[0]` and
`create_train_state` for `restore_state` to serve a trained checkpoint
(or export offline with `python -m anytime3d_tpu.cli.export`).

Run anywhere: `python examples/serving_demo.py` (CPU ok; the artifact is
lowered for the backend that exports it — pass ``platforms=("cuda",)`` to
export for the GPU).
"""

import os
import sys
import threading
import time

import numpy as np

# runnable from a checkout without installation
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from anytime3d_tpu.models.mmvae import MMVAEConfig, MultiModalVAE
from anytime3d_tpu.nn.autoencoder3d import Decoder3DConfig, Encoder3DConfig
from anytime3d_tpu.nn.priornet import PriorNetConfig
from anytime3d_tpu.serving import MicroBatcher, export_infer, load_infer
from anytime3d_tpu.train import create_train_state

DIM, Z, K, BATCH = 32, 16, 10, 8


def tiny_cfg():
    return MMVAEConfig(
        z_category_dim=Z, z_inst_dim=0, category_dim=K, encoder="voxel",
        encoder3d=Encoder3DConfig(output_dim=2 * Z, filter_nums=(16, 32, 64),
                                  filter_sizes=(3, 3, 3), strides=(2, 2, 2)),
        decoder=Decoder3DConfig(input_dim=Z, output_shape=(DIM, DIM, DIM, 1),
                                filter_nums=(64, 32, 16, 1),
                                filter_sizes=(4, 4, 4, 4), strides=(1, 2, 2, 2)),
        prior_category=PriorNetConfig(input_dim=K, unit_nums=(32, Z),
                                      const_log_var=0.0),
    )


def main():
    # ---- exporter side --------------------------------------------------
    model = MultiModalVAE(tiny_cfg())
    state = create_train_state(
        model, jnp.zeros((BATCH, DIM, DIM, DIM, 1)), jax.random.PRNGKey(0)
    )
    data = export_infer(model, state.params, input_shape=(BATCH, DIM, DIM, DIM, 1))
    print(f"exported serving program: {len(data)/1e6:.2f} MB")

    # ---- server side (bytes only from here on) --------------------------
    fn = load_infer(data)
    rng = np.random.default_rng(0)
    n_req = 3 * BATCH + 5
    lat = [None] * n_req

    with MicroBatcher(fn, batch_size=BATCH, input_shape=(DIM, DIM, DIM, 1),
                      mask_dim=Z, max_wait_s=0.002) as mb:
        def client(i):
            x = (rng.uniform(size=(DIM, DIM, DIM, 1)) > 0.5).astype(np.float32)
            # simulate a partial observation: 30% of latent dims missing
            mask = (np.random.default_rng(i).uniform(size=Z) > 0.3).astype(np.float32)
            t0 = time.perf_counter()
            r = mb.submit(x, mask=mask).result(timeout=300)
            lat[i] = time.perf_counter() - t0
            assert r["pred"].shape == (DIM, DIM, DIM, 1)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(n_req)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        print(f"{n_req} concurrent requests in {wall*1e3:.0f} ms "
              f"({mb.batches_run} device batches of {BATCH}); "
              f"p50 latency {sorted(lat)[n_req//2]*1e3:.0f} ms "
              f"(first batch includes compile)")


if __name__ == "__main__":
    main()
