"""Child program for the 2-process jax.distributed test (test_multihost.py).

Each process joins the cluster via ``multihost.initialize`` (standard env
vars), contributes 2 local CPU devices, builds a 4-device global 'data' mesh,
assembles its local slice of the global batch with ``host_local_batch_slice``
+ ``make_global_batch``, and runs ONE DP-sharded train step on a tiny voxel
model. It prints ``MULTIHOST_OK loss=<val>`` — the parent asserts both
processes print the same loss (the psum'd global step is identical on every
host). Mirrors the reference's only distributed reduction, the
MirroredStrategy mean in /root/reference/src/module/AE3D.py:92-104, but over
jax.distributed processes instead of in-process replicas.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# CPU devices whatever the machine has; Gloo is the multi-process CPU
# collectives implementation.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.config.update("jax_num_cpu_devices", 2)

import jax.numpy as jnp
import numpy as np

from anytime3d_tpu.models.mmvae import MMVAEConfig, MultiModalVAE
from anytime3d_tpu.nn.autoencoder3d import Decoder3DConfig, Encoder3DConfig
from anytime3d_tpu.parallel import make_mesh, shard_batch
from anytime3d_tpu.parallel import multihost
from anytime3d_tpu.train import LossConfig, create_train_state, make_train_step


def main():
    pid, n_proc = multihost.initialize()
    assert n_proc == int(os.environ["NUM_PROCESSES"]), (pid, n_proc)
    n_global = jax.device_count()
    n_local = len(jax.local_devices())
    assert n_global == n_proc * n_local, (n_global, n_proc, n_local)

    z = 8
    cfg = MMVAEConfig(
        z_category_dim=z,
        z_inst_dim=0,
        category_dim=4,
        encoder="voxel",
        encoder3d=Encoder3DConfig(
            output_dim=2 * z, filter_nums=(8, 16), filter_sizes=(3, 3, 3),
            strides=(2, 2, 1),
        ),
        decoder=Decoder3DConfig(
            input_dim=z, output_shape=(16, 16, 16, 1), filter_nums=(16, 8, 1),
            filter_sizes=(3, 3, 3), strides=(1, 2, 2),
        ),
        variational=True,
    )
    model = MultiModalVAE(cfg)
    mesh = make_mesh(data=n_global)

    global_batch = 2 * n_global
    # Every host derives the SAME global batch deterministically, then keeps
    # only its slice — the per-host loader contract (ModelNetLoader sharding).
    rng = np.random.default_rng(0)
    vox = (rng.uniform(size=(global_batch, 16, 16, 16, 1)) > 0.7).astype(np.float32)
    labels = np.eye(4, dtype=np.float32)[rng.integers(0, 4, global_batch)]
    start, size = multihost.host_local_batch_slice(global_batch)
    local = {
        "input": vox[start : start + size],
        "target": vox[start : start + size],
        "category_onehot": labels[start : start + size],
    }
    batch = multihost.make_global_batch(local, mesh)

    state = create_train_state(
        model, jnp.zeros((global_batch, 16, 16, 16, 1)), jax.random.PRNGKey(0)
    )
    from jax.sharding import NamedSharding, PartitionSpec as P

    rep = NamedSharding(mesh, P())
    state = state.replace(
        params=jax.device_put(state.params, rep),
        opt_state=jax.device_put(state.opt_state, rep),
        step=jax.device_put(state.step, rep),
    )
    batch = shard_batch(batch, mesh)

    step = make_train_step(model, LossConfig())
    new_state, metrics = step(state, batch, jax.random.PRNGKey(1))
    loss = float(metrics["loss_total"])
    assert np.isfinite(loss), metrics
    # one more step to prove the updated sharded state is reusable
    # (the step donates its input state; keep only the freshest)
    new_state, metrics2 = step(new_state, batch, jax.random.PRNGKey(2))
    loss2 = float(metrics2["loss_total"])
    assert np.isfinite(loss2), metrics2

    # collective multi-host checkpoint: process 0 writes, every process
    # meets at the barrier; restore into a zeroed state and verify the round
    # trip (train/checkpoint.py multihost contract)
    ckpt_dir = os.environ.get("MULTIHOST_CKPT_DIR")
    if ckpt_dir:
        from anytime3d_tpu.train.checkpoint import (
            restore_state,
            save_state,
            wait_for_saves,
        )

        save_state(os.path.join(ckpt_dir, "state"), new_state, wait=False)
        wait_for_saves()
        zeroed = new_state.replace(
            params=jax.tree_util.tree_map(jnp.zeros_like, new_state.params),
            step=jnp.zeros_like(new_state.step),
        )
        back = restore_state(os.path.join(ckpt_dir, "state"), zeroed)
        assert int(back.step) == int(new_state.step), (back.step, new_state.step)
        a = jax.tree_util.tree_leaves(back.params)[0]
        b = jax.tree_util.tree_leaves(new_state.params)[0]
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))
        print(f"MULTIHOST_CKPT_OK pid={pid}", flush=True)

    print(f"MULTIHOST_OK pid={pid} loss={loss:.6f} loss2={loss2:.6f}", flush=True)


if __name__ == "__main__":
    main()
