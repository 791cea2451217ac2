"""Layout-frontier demo: pick a decoder lowering per workload, and move a
checkpoint across lowerings without retraining.

The shared 64³ decoder (reference: src/net_core/autoencoder3D.py:104-139)
ships in three lowerings (RESULTS.md A/B at matched 8000 steps; the step
time of each on the H100 is not measured):

- blocked (default, `configs.modelnet_nolbo`): category acc 0.686 — the
  tail is REPARAMETERIZED (pixel-shuffle phase convs), so its training
  dynamics differ from the reference's.
- exact phase-equiv (`configs.modelnet_nolbo_acc`): acc 0.740 — the
  CLASSIC parameterization (same kernel tensors, init, Adam trajectory as
  stride-2 transposed convs; tests/test_nn.py::TestTransposeEquiv) under a
  phase-conv lowering (KERNELS.md §5).
- classic XLA transpose lowering: same dynamics as equiv — kept for
  parity verification.

Because classic and equiv share parameter TENSORS, a checkpoint trained
under one loads into the other via a pure path rename — shown below with
a tiny model on CPU.

Run anywhere: `python examples/layout_frontier.py`.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import dataclasses

import jax

jax.config.update("jax_platforms", os.environ.get("DEMO_PLATFORM", "cpu"))

import jax.numpy as jnp
import numpy as np

from anytime3d_tpu.nn import Decoder3D, Decoder3DConfig, remap_decoder_params

classic_cfg = Decoder3DConfig(
    input_dim=8,
    output_shape=(32, 32, 32, 1),
    filter_nums=(32, 16, 8, 1),
    filter_sizes=(4, 4, 4, 4),
    strides=(1, 2, 2, 2),
    final_mode="transpose",
    tail_blocked=False,
)
equiv_cfg = dataclasses.replace(
    classic_cfg, final_mode="transpose_equiv", mid_equiv=True
)

z = jnp.asarray(np.random.default_rng(0).normal(size=(2, 8)).astype(np.float32))

# "train" under the classic layout (here: just init)
classic = Decoder3D(classic_cfg)
params_classic = classic.init(jax.random.PRNGKey(0), z)["params"]
y_classic = classic.apply({"params": params_classic}, z)

# move the checkpoint to the equiv lowering: rename only, tensors shared
params_equiv = remap_decoder_params(params_classic, classic_cfg, equiv_cfg)
equiv = Decoder3D(equiv_cfg)
y_equiv = equiv.apply({"params": params_equiv}, z)

err = float(jnp.max(jnp.abs(y_classic - y_equiv)))
print(f"classic vs equiv lowering, same checkpoint: max|diff| = {err:.2e}")
assert err < 1e-5

# and back — bitwise, it is the same tensor tree
roundtrip = remap_decoder_params(params_equiv, equiv_cfg, classic_cfg)
same = all(
    np.array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(
        jax.tree_util.tree_leaves(roundtrip),
        jax.tree_util.tree_leaves(params_classic),
    )
)
print(f"roundtrip bitwise-identical: {same}")
assert same
print("ok")
