"""Checkpoint tests: full-state roundtrip (incl. optimizer moments) and
cross-experiment submodule grafting (SURVEY.md §5)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from anytime3d_tpu.models.mmvae import MultiModalVAE
from anytime3d_tpu.train import LossConfig, create_train_state, make_train_step
from anytime3d_tpu.train.checkpoint import (
    graft_submodule,
    restore_params,
    restore_state,
    save_params,
    save_state,
    wait_for_saves,
)

from tests.test_train import synth_batch, tiny_voxel_cfg


def _make_state(steps=2, with_prior=False, seed=0):
    model = MultiModalVAE(tiny_voxel_cfg(variational=True, with_prior=with_prior))
    batch = synth_batch(n=4, seed=seed)
    state = create_train_state(model, batch["input"], jax.random.PRNGKey(seed))
    step = make_train_step(model, LossConfig(), donate=False)
    for i in range(steps):
        state, _ = step(state, batch, jax.random.PRNGKey(i))
    return model, state, batch


class TestRoundtrip:
    def test_full_state_roundtrip(self, tmp_path):
        model, state, batch = _make_state(steps=3)
        path = str(tmp_path / "ckpt")
        save_state(path, state)

        fresh = create_train_state(model, batch["input"], jax.random.PRNGKey(99))
        restored = restore_state(path, fresh)

        assert int(restored.step) == int(state.step) == 3
        for a, b in zip(
            jax.tree_util.tree_leaves(state.params), jax.tree_util.tree_leaves(restored.params)
        ):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        # optimizer moments survive (unlike the reference, SURVEY.md §5)
        for a, b in zip(
            jax.tree_util.tree_leaves(state.opt_state),
            jax.tree_util.tree_leaves(restored.opt_state),
        ):
            assert np.array_equal(np.asarray(a), np.asarray(b))

    def test_resume_training_continues(self, tmp_path):
        model, state, batch = _make_state(steps=2)
        path = str(tmp_path / "ckpt")
        save_state(path, state)
        fresh = create_train_state(model, batch["input"], jax.random.PRNGKey(7))
        restored = restore_state(path, fresh)
        step = make_train_step(model, LossConfig(), donate=False)
        new_state, metrics = step(restored, batch, jax.random.PRNGKey(5))
        assert int(new_state.step) == 3
        assert np.isfinite(float(metrics["loss_total"]))


class TestGrafting:
    def test_graft_decoder_between_experiments(self, tmp_path):
        # donor: plain VAE; recipient: NOLBO-with-prior (different model!)
        _, donor_state, _ = _make_state(steps=2, with_prior=False, seed=0)
        donor_path = str(tmp_path / "donor")
        save_state(donor_path, donor_state)

        model, state, _ = _make_state(steps=0, with_prior=True, seed=1)
        before = np.asarray(
            jax.tree_util.tree_leaves(state.params["decoder"])[0]
        ).copy()
        grafted = graft_submodule(state, donor_path, "decoder")
        after_leaves = jax.tree_util.tree_leaves(grafted.params["decoder"])
        donor_leaves = jax.tree_util.tree_leaves(donor_state.params["decoder"])
        for a, b in zip(after_leaves, donor_leaves):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        assert not np.array_equal(before, np.asarray(after_leaves[0]))
        # other submodules untouched
        assert "prior_category" in grafted.params

    def test_graft_missing_submodule_raises(self, tmp_path):
        _, donor_state, _ = _make_state(steps=1, with_prior=False)
        donor_path = str(tmp_path / "donor")
        save_state(donor_path, donor_state)
        model, state, _ = _make_state(steps=0, with_prior=True)
        try:
            graft_submodule(state, donor_path, "prior_category")
            assert False, "should raise"
        except KeyError as e:
            assert "prior_category" in str(e)


class TestFormat:
    def test_overwrite_replaces_whole_checkpoint(self, tmp_path):
        """A second save to the same path replaces the first and leaves no
        temporary or old directories beside it."""
        _, first, _ = _make_state(steps=1)
        model, second, batch = _make_state(steps=3)
        path = str(tmp_path / "ckpt")
        save_state(path, first)
        save_state(path, second)
        assert sorted(os.listdir(tmp_path)) == ["ckpt"]
        restored = restore_state(
            path, create_train_state(model, batch["input"], jax.random.PRNGKey(9))
        )
        assert int(restored.step) == 3
        for a, b in zip(
            jax.tree_util.tree_leaves(second.params), jax.tree_util.tree_leaves(restored.params)
        ):
            assert np.array_equal(np.asarray(a), np.asarray(b))

    def test_async_save_snapshots_before_returning(self, tmp_path):
        """wait=False returns after the host snapshot: changing the state
        afterwards does not change what lands on disk; the fence commits it."""
        model, state, batch = _make_state(steps=2)
        path = str(tmp_path / "ckpt")
        save_state(path, state, wait=False)
        expected = np.asarray(jax.tree_util.tree_leaves(state.params)[0]).copy()
        step = make_train_step(model, LossConfig(), donate=True)
        state, _ = step(state, batch, jax.random.PRNGKey(3))  # donates the saved buffers
        wait_for_saves()
        assert os.path.exists(os.path.join(path, "arrays.npz"))
        restored = restore_state(path, state)
        assert int(restored.step) == 2
        np.testing.assert_array_equal(
            np.asarray(jax.tree_util.tree_leaves(restored.params)[0]), expected
        )

    def test_params_roundtrip_and_shape_check(self, tmp_path):
        _, state, _ = _make_state(steps=1)
        path = str(tmp_path / "params")
        save_params(path, state.params)
        back = restore_params(path, jax.device_get(state.params))
        jax.tree_util.tree_map(np.testing.assert_array_equal, back, jax.device_get(state.params))
        wrong = jax.tree_util.tree_map(lambda a: np.zeros((1,) + a.shape), state.params)
        with pytest.raises(ValueError, match="shape mismatch"):
            restore_params(path, wrong)
