"""Device mesh and sharding utilities (replacement for the reference's
tf.distribute.MirroredStrategy, src/module/AE3D.py:36-42).

Design: one global Mesh('data', 'model'). Data parallelism shards the batch
over 'data'; tensor parallelism shards the channel-heavy kernels (decoder
dense + deconv stacks, head 1x1 projections) over 'model'. With jit +
NamedSharding, XLA chooses and schedules the collectives (psum for grad sync,
all-gather where a TP kernel's activations rejoin). The mesh follows the
algorithm alone: the GPUs of one host are joined all to all (NVLink), so no
device order is preferred.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import jax
import numpy as np
from jax.experimental import mesh_utils
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    data: Optional[int] = None,
    model: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build Mesh(('data', 'model')). Defaults: all devices on 'data'."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data is None:
        data = n // model
    assert data * model == n, f"mesh {data}x{model} != {n} devices"
    arr = mesh_utils.create_device_mesh((data, model), devices=np.asarray(devices))
    return Mesh(arr, ("data", "model"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis (batch) sharding over 'data'."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(batch, mesh: Mesh):
    """Device-put a host batch pytree with the batch axis sharded on 'data'."""
    sh = batch_sharding(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), batch)


# --------------------------------------------------------------------- TP rules

# (path regex, spec) — first match wins. Only the channel-heavy kernels are
# sharded; everything else replicates. Dense kernels are (in, out); conv
# kernels are (k, k, [k,] in, out) — shard the output-channel dim.
#
# Coverage (measured via jax.eval_shape): the FLAGSHIP blocked layout
# (configs.modelnet_nolbo: blocked-head encoder `encoder3d/ConvBlock3D_*` +
# final `encoder3d/Conv_0`, blocked-tail decoder `decoder/Conv_{0,1}`) and
# the classic layout both shard ≥99.9% of their conv/dense parameter mass;
# the image family's Darknet backbone (`backbone/ConvBlock2D_*`) is covered
# too. GroupNorm scales/biases and priornet MLPs (<0.1%) replicate.
DEFAULT_RULES: tuple[tuple[str, P], ...] = (
    (r"decoder/DenseBlock_0/Dense_0/kernel", P(None, "model")),
    # classic mid-stage ConvTranspose kernels AND their exact
    # phase-decomposed lowering (blocks.py::ConvTransposeEquiv3D — same
    # (4,4,4,Cin,Cout) kernel shape). Scoped to Deconv*Block3D stages: the
    # FINAL stage's bare decoder/ConvTranspose(Equiv3D)_0 kernel stays
    # replicated by design — its Cout is the voxel channel count (1), so
    # output-channel sharding is either impossible or a sliver; keeping it
    # out of the rule makes that explicit instead of relying on the
    # divisibility check (ADVICE r4).
    (
        r"decoder/Deconv\w*Block3D_\d+/ConvTranspose\w*/kernel",
        P(None, None, None, None, "model"),
    ),
    # blocked-tail decoder stages (k=2 phase-channel dense convs,
    # nn/autoencoder3d.py::Decoder3D blocked path) — 5-D conv kernels
    (r"decoder/Conv_\d+/kernel", P(None, None, None, None, "model")),
    # voxel encoder: blocked-head + classic ConvBlock3D stages and the final
    # no-norm projection conv (5-D kernels, out-channel sharded)
    (r"encoder3d/.*Conv.*/kernel", P(None, None, None, None, "model")),
    # image backbones (Darknet 2-D convs)
    (r"backbone/.*Conv.*/kernel", P(None, None, None, "model")),
    (r"head/.*Conv.*/kernel", P(None, None, None, "model")),
)


def tp_coverage(params, mesh: Mesh, rules=DEFAULT_RULES) -> float:
    """Fraction of parameter COUNT the TP rules shard over 'model' (the rest
    replicates). Diagnostic for rule/layout drift — the flagship layout must
    stay ≥0.9 (tests/test_train.py::test_tp_rules_cover_flagship)."""
    shardings = param_sharding_rules(params, mesh, rules)
    tot = shd = 0
    for leaf, sh in zip(
        jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(shardings)
    ):
        n = int(np.prod(leaf.shape)) if leaf.shape else 1
        tot += n
        if any(s is not None for s in sh.spec):
            shd += n
    return shd / max(tot, 1)


def param_sharding_rules(params, mesh: Mesh, rules=DEFAULT_RULES):
    """Pytree of NamedShardings for ``params``: TP rules where they match and
    the leaf rank fits, replicated otherwise."""

    def spec_for(path, leaf):
        path_str = "/".join(
            p.key if hasattr(p, "key") else str(p) for p in path
        )
        for pattern, spec in rules:
            if re.search(pattern, path_str) and len(spec) == leaf.ndim:
                # only shard when the dim divides evenly
                axis = [a for a in spec if a is not None]
                if axis:
                    dim = spec.index(axis[0])
                    if leaf.shape[dim] % mesh.shape["model"] == 0:
                        return NamedSharding(mesh, spec)
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map_with_path(spec_for, params)


def shard_params(params, mesh: Mesh, rules=DEFAULT_RULES):
    shardings = param_sharding_rules(params, mesh, rules)
    return jax.tree_util.tree_map(jax.device_put, params, shardings)
