"""Benchmark harness — prints ONE JSON line with the headline metric.

Metric: end-to-end training throughput (voxels/s) of the flagship ModelNet
NOLBO config (64³ voxel encoder + priornet + 64³ voxel decoder, batch 32),
the dominant-FLOPs path of the reference (SURVEY.md §3.1: 5×Conv3D enc +
5×Conv3DTranspose dec on 64³ grids). ``--family image|detector`` times the
other two train steps; ``--all`` prints all three lines, flagship last.

Runs only on a GPU. Every line names the device it was measured on.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np


def _device_info() -> dict:
    """The device the numbers were measured on; refuses to run without a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py: needs an NVIDIA GPU; JAX found {dev.platform!r} devices")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "nvidia_smi": smi}


def _time_steps(step_fn, state, batch, iters: int) -> float:
    """Seconds for ``iters`` steps after 3 warm-up steps; the window ends
    when the last step's outputs are ready on the device."""
    import jax

    for i in range(3):
        state, metrics = step_fn(state, batch, jax.random.PRNGKey(i))
    jax.block_until_ready((state, metrics))
    t0 = time.perf_counter()
    for i in range(iters):
        state, metrics = step_fn(state, batch, jax.random.PRNGKey(3 + i))
    jax.block_until_ready((state, metrics))
    return time.perf_counter() - t0


def _iters(default: int) -> int:
    return int(os.environ.get("ANYTIME3D_BENCH_ITERS", default))


def bench_image():
    """Image->shape family: Darknet19 backbone + head -> dual latent -> 64³
    decoder, the reference's train_pascal.py hot loop (SURVEY §3.2)."""
    import jax
    import jax.numpy as jnp

    from anytime3d_tpu.utils.profiling import enable_compilation_cache

    enable_compilation_cache()

    from anytime3d_tpu.models import configs
    from anytime3d_tpu.models.mmvae import MultiModalVAE
    from anytime3d_tpu.train import create_train_state, make_train_step
    from anytime3d_tpu.data.packing import pack_voxels_blocked

    batch_size = 32
    model_cfg, loss_cfg = configs.variant("pascal_nolbo")
    model = MultiModalVAE(model_cfg, dtype=jnp.bfloat16)

    rng = np.random.default_rng(0)
    images = rng.uniform(size=(batch_size, 96, 128, 3)).astype(np.float32)
    vox = (rng.uniform(size=(batch_size, 64, 64, 64, 1)) > 0.7).astype(np.float32)
    n_cat, n_inst = model_cfg.category_dim, model_cfg.inst_dim
    batch = {
        "input": jnp.asarray(images),
        # blocked bit order (production path, cli/train.py): the loss runs
        # in the coarse d2s layout — no fine-grid relayout or 1-ch loss
        "target_packed_blocked": jnp.asarray(pack_voxels_blocked(vox)),
        "category_onehot": jnp.asarray(
            np.eye(n_cat, dtype=np.float32)[rng.integers(0, n_cat, batch_size)]
        ),
        "inst_onehot": jnp.asarray(
            np.eye(n_inst, dtype=np.float32)[rng.integers(0, n_inst, batch_size)]
        ),
    }
    state = create_train_state(model, jnp.asarray(images), jax.random.PRNGKey(0))
    step = make_train_step(model, loss_cfg, donate=True)
    iters = _iters(20)
    dt = _time_steps(step, state, batch, iters)
    print(json.dumps({
        "metric": "pascal_nolbo_train_voxels_per_s",
        "value": batch_size * 64**3 * iters / dt,
        "unit": "voxels/s",
        "device": _device_info(),
    }))


def bench_detector():
    """Detector family: Darknet19 -> YOLO-style grid head train step
    (the reference ships this path inference-only, nolbo_test.py)."""
    import jax
    import jax.numpy as jnp

    from anytime3d_tpu.utils.profiling import enable_compilation_cache

    enable_compilation_cache()

    from anytime3d_tpu.models.detector import DetectorConfig, DetectorReconstructor
    from anytime3d_tpu.nn.autoencoder3d import Decoder3DConfig
    from anytime3d_tpu.train import create_train_state
    from anytime3d_tpu.train.detector_step import (
        DetectorLossConfig,
        make_detector_train_step,
    )

    batch_size = 16
    gh, gw, p = 3, 4, 5
    d = 32
    decoder = Decoder3DConfig(
        input_dim=16, output_shape=(d, d, d, 1), filter_nums=(128, 64, 32, 1),
        filter_sizes=(4, 4, 4, 4), strides=(1, 2, 2, 2),
    )
    model = DetectorReconstructor(DetectorConfig(decoder=decoder), dtype=jnp.bfloat16)

    rng = np.random.default_rng(0)
    max_slots = 8
    batch = {
        "images": jnp.asarray(rng.uniform(size=(batch_size, 96, 128, 3)).astype(np.float32)),
        "objness": jnp.asarray((rng.uniform(size=(batch_size, gh, gw, p, 1)) > 0.9).astype(np.float32)),
        "bbox": jnp.asarray(rng.uniform(size=(batch_size, gh, gw, p, 4)).astype(np.float32)),
        "sin": jnp.asarray(rng.uniform(-1, 1, size=(batch_size, gh, gw, p, 3)).astype(np.float32)),
        "cos": jnp.asarray(rng.uniform(-1, 1, size=(batch_size, gh, gw, p, 3)).astype(np.float32)),
        "voxel_slot": jnp.asarray(rng.integers(-1, max_slots, size=(batch_size, gh, gw, p)).astype(np.int32)),
        "voxels": jnp.asarray((rng.uniform(size=(batch_size, max_slots, d, d, d, 1)) > 0.7).astype(np.float32)),
    }
    state = create_train_state(model, batch["images"], jax.random.PRNGKey(0))
    step = make_detector_train_step(model, DetectorLossConfig(), donate=True)
    iters = _iters(20)
    dt = _time_steps(step, state, batch, iters)
    print(json.dumps({
        "metric": "detector_train_images_per_s",
        "value": batch_size * iters / dt,
        "unit": "images/s",
        "device": _device_info(),
    }))


def main():
    import jax
    import jax.numpy as jnp

    from anytime3d_tpu.utils.profiling import enable_compilation_cache

    enable_compilation_cache()

    from anytime3d_tpu.models import configs
    from anytime3d_tpu.models.mmvae import MultiModalVAE
    from anytime3d_tpu.train import create_train_state, make_train_step

    batch_size = 32
    model_cfg, loss_cfg = configs.variant("modelnet_nolbo")
    model = MultiModalVAE(model_cfg, dtype=jnp.bfloat16)

    rng = np.random.default_rng(0)
    vox = (rng.uniform(size=(batch_size, 64, 64, 64, 1)) > 0.7).astype(np.float32)
    labels = np.eye(40, dtype=np.float32)[rng.integers(0, 40, batch_size)]
    # production transfer path (cli/train.py): bit-packed in the blocked
    # coarse-layout order — 32x less host->device traffic, zero device
    # relayout (train/step.py::materialize_batch)
    from anytime3d_tpu.data.packing import pack_voxels_blocked

    batch = {
        "input_packed_blocked": jnp.asarray(pack_voxels_blocked(vox)),
        "category_onehot": jnp.asarray(labels),
    }

    state = create_train_state(model, jnp.asarray(vox), jax.random.PRNGKey(0))
    # the faithful per-variant loss (registry): 0.01*reg margin 2z, prior
    # mixing coin 0.5 / element 0.3 — what cli/train.py trains with
    step = make_train_step(model, loss_cfg, donate=True)

    iters = _iters(50)
    dt = _time_steps(step, state, batch, iters)
    print(json.dumps({
        "metric": "modelnet_nolbo_train_voxels_per_s",
        "value": batch_size * 64**3 * iters / dt,
        "unit": "voxels/s",
        "device": _device_info(),
    }))


if __name__ == "__main__":
    import sys

    _device_info()  # refuse before any work when there is no GPU
    # driver contract: bare `python bench.py` prints exactly ONE JSON line
    # (the flagship). `--family image|detector` benches the secondary
    # families; `--all` prints all three lines, flagship last.
    if "--all" in sys.argv:
        bench_image()
        bench_detector()
        main()
    elif "--family" in sys.argv:
        fam = sys.argv[sys.argv.index("--family") + 1]
        {"image": bench_image, "detector": bench_detector, "modelnet": main}[fam]()
    else:
        main()
