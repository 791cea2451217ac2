"""Bring-up check of the NOLBO train and serve path on NVIDIA GPUs.

    python chip_smoke.py              # one GPU
    python chip_smoke.py --chips 4    # the four-GPU path only

One process drives everything (a JAX process reserves most of a card's
memory, so a second one could not run); the HTTP clients are threads. Any
failing phase raises, so the script exits non-zero and prints no result.

One GPU, in order:

1. device check: refuses to run unless JAX's first device is a GPU;
2. native build: the host libraries of ``native/`` (set-up time);
3. train: ``cli.train`` on ``modelnet_nolbo`` at full width (64³ grids,
   batch 32, bf16, bit-packed input) for a few steps with a checkpoint,
   then a second run resumed from it; the step's ``memory_analysis`` and
   the device's peak bytes; then a few ``pascal_nolbo`` steps
   (``cli.train``) and detector steps (``cli.train_detector``);
4. correctness: the trained flagship's encode->decode forward on a batch of
   4 in (a) bf16 and (b) float32 at highest matmul precision on the GPU,
   and (c) float32 on the CPU backend, the plain reference;
5. serve: the packed-IO serving program exported on the GPU behind
   ``serving.server.InferenceServer`` on localhost; every response must
   equal the in-process program's output for the same input.

``--chips 4``: ``__graft_entry__.dryrun_multichip(4)`` (a DP x TP step and a
bf16-gradient-psum DP step, each checked against the replicated one-device
answer) and a few ``cli.train --mesh`` steps at batch 128 (32 per card).

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

# the float32 reference runs on the CPU backend of this same process
if os.environ.get("JAX_PLATFORMS") and "cpu" not in os.environ["JAX_PLATFORMS"]:
    os.environ["JAX_PLATFORMS"] += ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import anytime3d_tpu  # noqa: E402,F401  (fails outside a checkout of the repo)

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "runs", "chip_smoke")

# correctness bounds (phase 4)
F32_REL_LOGIT_ERR = 1e-3  # GPU f32 vs CPU f32: summation order only
BF16_OCC_AGREE = 0.99  # bf16 keeps ~3 digits over ~1e5-term conv sums
BF16_LOSS_REL = 0.02


def log(msg: str) -> None:
    print(msg, flush=True)


def check_device(chips: int) -> None:
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU; JAX found {devices[0].platform!r} devices"
        )
    if len(devices) < chips:
        raise SystemExit(f"chip_smoke: needs {chips} GPUs; JAX found {len(devices)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)  # name, power limit: one line per GPU
    log(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")
    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    n_cached = len(os.listdir(cache)) if cache and os.path.isdir(cache) else 0
    log(f"compile cache: {cache or '<checkout>/.jax_cache'} ({n_cached} entries at start)")


def build_native() -> None:
    from anytime3d_tpu.data.native import native_lib

    t0 = time.perf_counter()
    for lib in ("libvoxelizer.so", "libaugment.so", "libpack.so"):
        if native_lib(lib) is None:
            raise RuntimeError(f"native/{lib} did not build")
    log(f"[native] built in {time.perf_counter() - t0:.1f}s")


def _flagship(dtype):
    from anytime3d_tpu.models import configs
    from anytime3d_tpu.models.mmvae import MultiModalVAE

    cfg, loss_cfg = configs.variant("modelnet_nolbo")
    return cfg, loss_cfg, MultiModalVAE(cfg, dtype=dtype)


def _voxel_batch(n: int, seed: int):
    from anytime3d_tpu.data import SyntheticVoxelLoader

    loader = SyntheticVoxelLoader(num_samples=n, dim=64, seed=seed)
    return loader.getNextBatch(n)


def train_flagship(batch_size: int = 32, steps: int = 4, resume_steps: int = 2):
    """cli.train at full width, a checkpoint, a resumed run; returns the
    restored state of the final checkpoint."""
    from anytime3d_tpu.cli.train import main as train_main
    from anytime3d_tpu.data.packing import pack_voxels_blocked
    from anytime3d_tpu.train import create_train_state, make_train_step
    from anytime3d_tpu.train.checkpoint import restore_state

    cfg, loss_cfg, model = _flagship(jnp.bfloat16)
    ckpt = os.path.join(WORK, "modelnet_nolbo")
    common = [
        "--config", "modelnet_nolbo", "--data", "synthetic", "--bf16", "--packed",
        "--batch-size", str(batch_size), "--eval-every", "0", "--save-path", ckpt,
    ]

    # the step's compile and memory, on the shapes cli.train feeds it
    b = _voxel_batch(batch_size, seed=3)
    batch = {
        "input_packed_blocked": jnp.asarray(pack_voxels_blocked(b["input_images"])),
        "category_onehot": jnp.asarray(b["class_list"]),
    }
    state = create_train_state(
        model, jnp.zeros((batch_size, 64, 64, 64, 1), jnp.bfloat16), jax.random.PRNGKey(0)
    )
    t0 = time.perf_counter()
    compiled = make_train_step(model, loss_cfg).lower(state, batch, jax.random.PRNGKey(1)).compile()
    log(f"[train] flagship step compiled in {time.perf_counter() - t0:.1f}s")
    log(f"[train] memory_analysis: {compiled.memory_analysis()}")
    del compiled, state

    t0 = time.perf_counter()
    first = train_main(common + ["--steps", str(steps)])
    log(f"[train] modelnet_nolbo: {steps} steps in {time.perf_counter() - t0:.1f}s, "
        f"step={int(first.step)}")
    t0 = time.perf_counter()
    resumed = train_main(common + ["--steps", str(steps + resume_steps), "--load-path", ckpt])
    log(f"[train] resumed from step {steps}: {resume_steps} steps in "
        f"{time.perf_counter() - t0:.1f}s, step={int(resumed.step)}")
    if int(resumed.step) != steps + resume_steps:
        raise RuntimeError(f"resume ended at step {int(resumed.step)}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[train] peak_bytes_in_use={stats.get('peak_bytes_in_use')} "
        f"bytes_limit={stats.get('bytes_limit')}")
    restored = restore_state(ckpt, resumed)
    for a, b_ in zip(jax.tree_util.tree_leaves(restored.params),
                     jax.tree_util.tree_leaves(resumed.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))
    log("[train] checkpoint restores the final params exactly")
    return restored


def train_other_families(image_batch: int = 32, image_size: int = 128,
                         detector_batch: int = 16, steps: int = 3) -> None:
    from anytime3d_tpu.cli.train import main as train_main
    from anytime3d_tpu.cli.train_detector import main as detector_main

    t0 = time.perf_counter()
    state = train_main([
        "--config", "pascal_nolbo", "--data", "synthetic", "--bf16",
        "--batch-size", str(image_batch), "--image-size", str(image_size),
        "--steps", str(steps), "--eval-every", "0",
    ])
    log(f"[train] pascal_nolbo: {steps} steps in {time.perf_counter() - t0:.1f}s, "
        f"step={int(state.step)}")
    t0 = time.perf_counter()
    detector_main([
        "--data", "synthetic", "--bf16", "--batch-size", str(detector_batch),
        "--steps", str(steps),
    ])
    log(f"[train] detector: {steps} steps + eval in {time.perf_counter() - t0:.1f}s")


def _forward_logits(cfg, dtype, params, x, device):
    """encode -> posterior mean -> decode, stopping before the final sigmoid."""
    import dataclasses

    from anytime3d_tpu.models.mmvae import MultiModalVAE

    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, final_act="none"))
    model = MultiModalVAE(cfg, dtype=dtype)
    params, x = jax.device_put((params, x), device)
    fn = jax.jit(lambda p, v: model.apply({"params": p}, v).astype(jnp.float32))
    return np.asarray(fn(params, x))


def _loss_shape(logits, target):
    from anytime3d_tpu.ops import focal_binary_loss

    return float(jnp.mean(focal_binary_loss(jax.nn.sigmoid(logits), target)))


def check_correctness(params, n: int = 4) -> None:
    cfg, _, _ = _flagship(jnp.float32)
    x = jnp.asarray(_voxel_batch(n, seed=11)["input_images"])
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    params = jax.device_get(params)
    t0 = time.perf_counter()
    a = _forward_logits(cfg, jnp.bfloat16, params, x, gpu)
    with jax.default_matmul_precision("highest"):
        b = _forward_logits(cfg, jnp.float32, params, x, gpu)
    d = _forward_logits(cfg, jnp.float32, params, x, gpu)  # default precision
    c = _forward_logits(cfg, jnp.float32, params, x, cpu)
    log(f"[correct] 4 forwards in {time.perf_counter() - t0:.1f}s, "
        f"logit range {c.min():.3f}..{c.max():.3f}")

    span = float(c.max() - c.min())
    err_bc = float(np.abs(b - c).max()) / span
    agree = float(np.mean((a >= 0) == (b >= 0)))
    x_np = np.asarray(x)
    loss_a, loss_b = _loss_shape(a, x_np), _loss_shape(b, x_np)
    loss_rel = abs(loss_a - loss_b) / abs(loss_b)
    err_db = float(np.abs(d - b).max()) / span
    log(f"[correct] (b) f32 GPU vs (c) f32 CPU: max|dlogit|/range = {err_bc:.3e} "
        f"(bound {F32_REL_LOGIT_ERR:.0e})")
    log(f"[correct] (a) bf16 GPU vs (b): occupancy agreement {agree:.5f} "
        f"(bound >= {BF16_OCC_AGREE}), loss_shape {loss_a:.6f} vs {loss_b:.6f}, "
        f"rel {loss_rel:.3e} (bound {BF16_LOSS_REL})")

    # TF32: a default-precision f32 matmul against the highest-precision one
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    m1 = jax.random.normal(k1, (2048, 2048), jnp.float32)
    m2 = jax.random.normal(k2, (2048, 2048), jnp.float32)
    mm = jax.jit(jnp.matmul)
    default = np.asarray(mm(m1, m2))
    with jax.default_matmul_precision("highest"):
        highest = np.asarray(jax.jit(jnp.matmul)(m1, m2))
    mm_err = float(np.abs(default - highest).max() / np.abs(highest).max())
    log(f"[correct] f32 matmul default vs highest precision: rel err {mm_err:.2e} -> "
        f"default f32 matmuls {'run as TF32' if mm_err > 1e-5 else 'keep float32'}; "
        f"model forward default vs highest: max|dlogit|/range = {err_db:.3e}")

    if not err_bc <= F32_REL_LOGIT_ERR:
        raise RuntimeError(f"f32 GPU forward differs from the CPU reference: {err_bc}")
    if not agree >= BF16_OCC_AGREE:
        raise RuntimeError(f"bf16 occupancy agrees on only {agree:.4f} of voxels")
    if not loss_rel <= BF16_LOSS_REL:
        raise RuntimeError(f"bf16 loss_shape off by {loss_rel:.3e}")


def check_serving(params, batch_size: int = 8, n_requests: int = 12, n_clients: int = 4) -> None:
    from anytime3d_tpu.data.packing import pack_voxels
    from anytime3d_tpu.serving import export_infer, load_infer
    from anytime3d_tpu.serving.server import InferenceServer

    cfg, _, model = _flagship(jnp.float32)
    t0 = time.perf_counter()
    artifact = export_infer(
        model, params, (batch_size, 64, 64, 64, 1), packed_input=True, packed_output=True
    )
    mask_dim = cfg.z_category_dim
    server = InferenceServer(artifact, (64**3 // 8,), mask_dim, batch_size=batch_size)
    log(f"[serve] exported ({len(artifact)} bytes) and loaded in {time.perf_counter() - t0:.1f}s")
    vox = _voxel_batch(n_requests, seed=21)["input_images"]
    packed = np.asarray(pack_voxels(vox))
    rng = np.random.default_rng(0)
    masks = (rng.uniform(size=(n_requests, mask_dim)) > 0.3).astype(np.float32)
    masks[0] = 1.0
    responses = [None] * n_requests
    try:
        port = server.serve(0, background=True)

        def client(idx):
            for i in idx:
                body = json.dumps({
                    "voxels_packed_b64": base64.b64encode(packed[i].tobytes()).decode(),
                    "mask": masks[i].tolist(),
                }).encode()
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/infer", data=body,
                    headers={"Content-Type": "application/json"},
                )
                with urllib.request.urlopen(req, timeout=600) as r:
                    responses[i] = json.loads(r.read())

        t0 = time.perf_counter()
        threads = [
            threading.Thread(target=client, args=(range(c, n_requests, n_clients),))
            for c in range(n_clients)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        if any(t.is_alive() for t in threads) or any(r is None for r in responses):
            raise RuntimeError("serving clients did not finish")
        log(f"[serve] {n_requests} requests from {n_clients} clients in "
            f"{time.perf_counter() - t0:.1f}s, {server.batcher.batches_run} batches")
    finally:
        server.close()

    fn = load_infer(artifact)
    for start in range(0, n_requests, batch_size):
        rows = list(range(start, min(start + batch_size, n_requests)))
        x = np.zeros((batch_size, packed.shape[1]), np.uint8)
        m = np.ones((batch_size, mask_dim), np.float32)
        x[: len(rows)], m[: len(rows)] = packed[rows], masks[rows]
        ref = jax.device_get(fn(jnp.asarray(x), jnp.asarray(m)))
        for j, i in enumerate(rows):
            got = responses[i]
            want_bits = np.asarray(ref["pred_packed"][j]).tobytes()
            if base64.b64decode(got["pred_packed_b64"]) != want_bits:
                raise RuntimeError(f"request {i}: served occupancy differs")
            for key in ("z_mean", "z_log_var", "category"):
                np.testing.assert_array_equal(
                    np.asarray(got[key]), np.asarray(ref[key][j]), err_msg=f"request {i} {key}"
                )
    log(f"[serve] all {n_requests} responses equal the in-process program's output")


def four_chip_path(batch_size: int = 128, steps: int = 3) -> None:
    from __graft_entry__ import dryrun_multichip
    from anytime3d_tpu.cli.train import main as train_main
    from anytime3d_tpu.parallel import make_mesh

    mesh = make_mesh(data=2, model=2)
    log(f"[4 chips] mesh {dict(mesh.shape)} device ids {mesh.device_ids.tolist()}")
    t0 = time.perf_counter()
    dryrun_multichip(4)
    log(f"[4 chips] dryrun_multichip(4) passed in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    state = train_main([
        "--config", "modelnet_nolbo", "--data", "synthetic", "--bf16", "--packed",
        "--mesh", "--batch-size", str(batch_size), "--steps", str(steps), "--eval-every", "0",
    ])
    held = {d.id for leaf in jax.tree_util.tree_leaves(state) for d in leaf.sharding.device_set}
    log(f"[4 chips] cli.train --mesh: {steps} steps at batch {batch_size} in "
        f"{time.perf_counter() - t0:.1f}s; state held on devices {sorted(held)}")
    if len(held) != len(jax.devices()):
        raise RuntimeError(f"train state sits on devices {sorted(held)} only")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = parser.parse_args(argv)

    check_device(args.chips)
    from anytime3d_tpu.utils.profiling import enable_compilation_cache

    enable_compilation_cache()
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    build_native()
    if args.chips == 4:
        four_chip_path()
    else:
        state = train_flagship()
        train_other_families()
        check_correctness(state.params)
        check_serving(state.params)
    dev = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())},
    }), flush=True)


if __name__ == "__main__":
    main()
