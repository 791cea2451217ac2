"""Shape/dtype golden tests for net cores (SURVEY.md §4b)."""

import jax
import jax.numpy as jnp
import numpy as np

from anytime3d_tpu.nn import (
    Darknet19,
    Darknet53,
    Darknet53Tiny,
    Decoder3D,
    Decoder3DConfig,
    Encoder3D,
    Encoder3DConfig,
    Head2D,
    PriorNet,
    PriorNetConfig,
)

KEY = jax.random.PRNGKey(0)


def test_darknet19_stride32():
    model = Darknet19()
    x = jnp.zeros((1, 64, 64, 3))
    params = model.init(KEY, x)["params"]
    y = model.apply({"params": params}, x)
    assert y.shape == (1, 2, 2, 1024)


def test_darknet53_multiscale():
    model = Darknet53()
    x = jnp.zeros((1, 64, 64, 3))
    params = model.init(KEY, x)["params"]
    x36, x61, y = model.apply({"params": params}, x)
    assert x36.shape == (1, 8, 8, 256)
    assert x61.shape == (1, 4, 4, 512)
    assert y.shape == (1, 2, 2, 1024)


def test_darknet53tiny():
    model = Darknet53Tiny()
    x = jnp.zeros((1, 64, 64, 3))
    params = model.init(KEY, x)["params"]
    x8, y = model.apply({"params": params}, x)
    assert x8.shape == (1, 4, 4, 256)
    assert y.shape == (1, 2, 2, 1024)


def test_head2d_pooling_modes():
    for pooling, expect in [("max", (2, 24)), ("average", (2, 24)), (None, (2, 4, 4, 24))]:
        model = Head2D(output_dim=24, filter_nums=(32,), filter_sizes=(3,), last_pooling=pooling)
        x = jnp.ones((2, 4, 4, 16))
        params = model.init(KEY, x)["params"]
        y = model.apply({"params": params}, x)
        assert y.shape == expect, pooling


def test_encoder3d_shapes():
    cfg = Encoder3DConfig(
        output_dim=16, filter_nums=(8, 16), filter_sizes=(3, 3, 3), strides=(2, 2, 1),
        final_pool="average",
    )
    model = Encoder3D(cfg)
    x = jnp.ones((2, 16, 16, 16, 1))
    params = model.init(KEY, x)["params"]
    y = model.apply({"params": params}, x)
    assert y.shape == (2, 16)


def test_encoder3d_space_to_depth_stem():
    base = dict(
        output_dim=16, filter_nums=(8, 16), filter_sizes=(4, 3, 3), strides=(2, 2, 1),
        final_pool="average",
    )
    x = jnp.ones((2, 16, 16, 16, 1))
    for s2d in (1, 2):
        cfg = Encoder3DConfig(**base, stem_space_to_depth=s2d)
        model = Encoder3D(cfg)
        params = model.init(KEY, x)["params"]
        y = model.apply({"params": params}, x)
        assert y.shape == (2, 16), s2d
    # the s2d stem kernel contracts over 8 input channels with a 2^3 window
    stem = params["ConvBlock3D_0"]["Conv_0"]["kernel"]
    assert stem.shape[:4] == (2, 2, 2, 8)


def test_encoder3d_blocked_head():
    cfg = Encoder3DConfig(
        output_dim=16, filter_nums=(8, 16), filter_sizes=(4, 4, 3), strides=(2, 2, 1),
        final_pool="average", head_blocked=True,
    )
    model = Encoder3D(cfg)
    x = jnp.ones((2, 16, 16, 16, 1))
    params = model.init(KEY, x)["params"]
    y = model.apply({"params": params}, x)
    assert y.shape == (2, 16)
    g = jax.grad(lambda p: jnp.sum(model.apply({"params": p}, x) ** 2))(params)
    assert all(jnp.all(jnp.isfinite(l)) for l in jax.tree_util.tree_leaves(g))


def test_decoder3d_blocked_tail_and_pixel_shuffle():
    import numpy as np

    base = dict(
        input_dim=8, output_shape=(16, 16, 16, 1), filter_nums=(16, 8, 1),
        filter_sizes=(3, 4, 4), strides=(1, 2, 2),
    )
    z = jax.random.normal(KEY, (2, 8))
    for mode, blocked in (("transpose", False), ("pixel_shuffle", False), ("pixel_shuffle", True)):
        cfg = Decoder3DConfig(**base, final_mode=mode, tail_blocked=blocked)
        model = Decoder3D(cfg)
        params = model.init(KEY, z)["params"]
        y = model.apply({"params": params}, z)
        assert y.shape == (2, 16, 16, 16, 1), (mode, blocked)
        yn = np.asarray(y)
        assert yn.min() >= 0.0 and yn.max() <= 1.0  # sigmoid output
        assert yn.std() > 0


def test_decoder3d_shapes_and_range():
    cfg = Decoder3DConfig(
        input_dim=8, output_shape=(16, 16, 16, 1), filter_nums=(16, 8, 1),
        filter_sizes=(3, 3, 3), strides=(1, 2, 2),
    )
    model = Decoder3D(cfg)
    z = jax.random.normal(KEY, (2, 8))
    params = model.init(KEY, z)["params"]
    y = model.apply({"params": params}, z)
    assert y.shape == (2, 16, 16, 16, 1)
    y = np.asarray(y)
    assert (y >= 0).all() and (y <= 1).all()  # sigmoid occupancy


def test_decoder3d_reference_channel_rule():
    """Reference: conv input channels = max(filters[0]/64, 8) (autoencoder3D.py:115-120)."""
    cfg = Decoder3DConfig(
        input_dim=4, output_shape=(16, 16, 16, 1), filter_nums=(512, 1),
        filter_sizes=(3, 3), strides=(2, 2),
    )
    model = Decoder3D(cfg)
    z = jnp.ones((1, 4))
    params = model.init(KEY, z)["params"]
    # dense output = (16/4)^3 * max(512/64, 8) = 64 * 8
    dense_kernel = params["DenseBlock_0"]["Dense_0"]["kernel"]
    assert dense_kernel.shape == (4, 64 * 8)


def test_priornet_const_log_var():
    cfg = PriorNetConfig(input_dim=5, unit_nums=(16, 4), const_log_var=0.0)
    model = PriorNet(cfg)
    onehot = jnp.eye(5)
    params = model.init(KEY, onehot)["params"]
    mean, log_var = model.apply({"params": params}, onehot)
    assert mean.shape == (5, 4)
    assert np.allclose(np.asarray(log_var), 0.0)
    assert "log_var_tower" not in params


def test_priornet_learned_log_var_and_dropout():
    cfg = PriorNetConfig(input_dim=5, unit_nums=(16, 4), const_log_var=None)
    model = PriorNet(cfg)
    onehot = jnp.eye(5)
    params = model.init({"params": KEY, "dropout": KEY}, onehot)["params"]
    assert "log_var_tower" in params
    m1, lv1 = model.apply({"params": params}, onehot, deterministic=True)
    # stochastic under dropout
    m2a, _ = model.apply(
        {"params": params}, onehot, False, rngs={"dropout": jax.random.PRNGKey(1)}
    )
    m2b, _ = model.apply(
        {"params": params}, onehot, False, rngs={"dropout": jax.random.PRNGKey(2)}
    )
    assert not np.allclose(np.asarray(m2a), np.asarray(m2b))
    assert lv1.shape == (5, 4)


class TestMidBlocked:
    """mid_blocked: every stride-2 stage as s2d(2)/d2s(2) + k=2 s=1 conv —
    same linear family and PARAMETER COUNT as the classic stride-2 stages
    (4^3*Cin*Cout == 2^3*(8*Cin)*Cout, and transpose 4^3*Cin*Cout ==
    2^3*Cin*(8*Cout)), stride-1 tiling, no dilated lowering in either
    direction."""

    def _enc_cfg(self, **kw):
        from anytime3d_tpu.nn.autoencoder3d import Encoder3DConfig

        return Encoder3DConfig(
            output_dim=16, filter_nums=(8, 16, 32), filter_sizes=(4, 4, 4, 4),
            strides=(2, 2, 2, 1), **kw,
        )

    def _dec_cfg(self, **kw):
        from anytime3d_tpu.nn.autoencoder3d import Decoder3DConfig

        return Decoder3DConfig(
            input_dim=8, output_shape=(32, 32, 32, 1),
            filter_nums=(32, 16, 8, 1), filter_sizes=(4, 4, 4, 4),
            strides=(1, 2, 2, 2), **kw,
        )

    def test_encoder_shapes_and_param_parity(self):
        import jax
        import numpy as np
        from anytime3d_tpu.nn.autoencoder3d import Encoder3D

        x = jnp.asarray(
            np.random.default_rng(0).uniform(size=(2, 32, 32, 32, 1)).astype(np.float32)
        )
        outs, counts = [], []
        for mid in (False, True):
            enc = Encoder3D(self._enc_cfg(mid_blocked=mid))
            params = enc.init(jax.random.PRNGKey(0), x)["params"]
            out = enc.apply({"params": params}, x)
            assert out.shape == (2, 16)
            assert np.isfinite(np.asarray(out)).all()
            counts.append(sum(p.size for p in jax.tree_util.tree_leaves(params)))
            outs.append(out)
        assert counts[0] == counts[1], counts

    def test_decoder_shapes_and_param_parity(self):
        import jax
        import numpy as np
        from anytime3d_tpu.nn.autoencoder3d import Decoder3D

        z = jnp.asarray(
            np.random.default_rng(0).uniform(size=(2, 8)).astype(np.float32)
        )
        counts = []
        for mid in (False, True):
            dec = Decoder3D(self._dec_cfg(mid_blocked=mid))
            params = dec.init(jax.random.PRNGKey(0), z)["params"]
            out = dec.apply({"params": params}, z)
            assert out.shape == (2, 32, 32, 32, 1)
            assert np.isfinite(np.asarray(out)).all()
            counts.append(sum(p.size for p in jax.tree_util.tree_leaves(params)))
        assert counts[0] == counts[1], counts

    def test_composes_with_blocked_head_tail(self):
        import jax
        import numpy as np
        from anytime3d_tpu.nn.autoencoder3d import Decoder3D, Encoder3D

        enc_cfg = self._enc_cfg(mid_blocked=True, head_blocked=True)
        dec_cfg = self._dec_cfg(mid_blocked=True, tail_blocked=True)
        x = jnp.asarray(
            np.random.default_rng(0).uniform(size=(2, 32, 32, 32, 1)).astype(np.float32)
        )
        enc = Encoder3D(enc_cfg)
        p = enc.init(jax.random.PRNGKey(0), x)["params"]
        assert enc.apply({"params": p}, x).shape == (2, 16)
        dec = Decoder3D(dec_cfg)
        z = jnp.zeros((2, 8))
        pd = dec.init(jax.random.PRNGKey(0), z)["params"]
        assert dec.apply({"params": pd}, z).shape == (2, 32, 32, 32, 1)

    def test_gradients_flow(self):
        import jax
        import numpy as np
        from anytime3d_tpu.nn.autoencoder3d import Decoder3D

        dec = Decoder3D(self._dec_cfg(mid_blocked=True))
        z = jnp.asarray(np.random.default_rng(0).normal(size=(2, 8)).astype(np.float32))
        params = dec.init(jax.random.PRNGKey(0), z)["params"]
        g = jax.grad(lambda p: jnp.sum(dec.apply({"params": p}, z)))(params)
        norms = [float(jnp.abs(x).sum()) for x in jax.tree_util.tree_leaves(g)]
        assert all(np.isfinite(norms)) and max(norms) > 0


class TestTransposeEquiv:
    """ConvTransposeEquiv3D: EXACT phase-decomposed lowering of the k=4 s=2
    SAME ConvTranspose (blocks.py). Same (4,4,4,Cin,Cout) parameter tensor,
    same init, same function => same loss surface and elementwise-Adam
    dynamics as the classic layout; only the lowering differs."""

    def test_module_exact_parity(self):
        from anytime3d_tpu.nn import module as nn
        from anytime3d_tpu.nn.blocks import ConvTransposeEquiv3D

        rng = np.random.default_rng(1)
        for D, cin, cout in [(4, 3, 5), (6, 1, 4), (8, 2, 1)]:
            x = jnp.asarray(rng.normal(size=(2, D, D, D, cin)).astype(np.float32))

            class Ref(nn.Module):
                @nn.compact
                def __call__(self, x):
                    return nn.ConvTranspose(
                        cout, (4, 4, 4), strides=(2, 2, 2),
                        padding="SAME", use_bias=False,
                    )(x)

            ref = Ref()
            p_ref = ref.init(jax.random.PRNGKey(0), x)
            K = p_ref["params"]["ConvTranspose_0"]["kernel"]
            y_ref = ref.apply(p_ref, x)
            eq = ConvTransposeEquiv3D(cout)
            y_eq = eq.apply({"params": {"kernel": K}}, x)
            assert y_eq.shape == y_ref.shape
            np.testing.assert_allclose(
                np.asarray(y_eq), np.asarray(y_ref), atol=1e-5
            )
            # gradient parity wrt the (shared) kernel tensor
            g_ref = jax.grad(
                lambda k: jnp.sum(
                    jnp.sin(ref.apply({"params": {"ConvTranspose_0": {"kernel": k}}}, x))
                )
            )(K)
            g_eq = jax.grad(
                lambda k: jnp.sum(jnp.sin(eq.apply({"params": {"kernel": k}}, x)))
            )(K)
            np.testing.assert_allclose(
                np.asarray(g_eq), np.asarray(g_ref), atol=1e-4
            )

    def _cfgs(self):
        classic = Decoder3DConfig(
            input_dim=8, output_shape=(32, 32, 32, 1),
            filter_nums=(32, 16, 8, 1), filter_sizes=(4, 4, 4, 4),
            strides=(1, 2, 2, 2), final_mode="transpose", tail_blocked=False,
        )
        import dataclasses

        equiv = dataclasses.replace(
            classic, final_mode="transpose_equiv", mid_equiv=True
        )
        return classic, equiv

    @staticmethod
    def _remap(params):
        """Rename classic param paths to the equiv decoder's structure (the
        tensors themselves are shared between the two lowerings)."""
        out, j = {}, 0
        for name in sorted(params):
            sub = params[name]
            if name.startswith("DeconvBlock3D_") and "ConvTranspose_0" in sub and name != "DeconvBlock3D_0":
                out[f"DeconvEquivBlock3D_{j}"] = {
                    "ConvTransposeEquiv3D_0": {"kernel": sub["ConvTranspose_0"]["kernel"]},
                    **{k: v for k, v in sub.items() if k != "ConvTranspose_0"},
                }
                j += 1
            elif name == "ConvTranspose_0":
                out["ConvTransposeEquiv3D_0"] = {"kernel": sub["kernel"]}
            else:
                out[name] = sub
        return out

    def test_decoder_exact_parity(self):
        classic_cfg, equiv_cfg = self._cfgs()
        z = jnp.asarray(np.random.default_rng(0).normal(size=(2, 8)).astype(np.float32))
        dec_c = Decoder3D(classic_cfg)
        p_c = dec_c.init(jax.random.PRNGKey(0), z)["params"]
        dec_e = Decoder3D(equiv_cfg)
        p_e_init = dec_e.init(jax.random.PRNGKey(0), z)["params"]
        p_e = self._remap(p_c)
        # structures must match exactly (same shapes, renamed paths)
        assert jax.tree_util.tree_structure(p_e) == jax.tree_util.tree_structure(p_e_init)
        y_c = dec_c.apply({"params": p_c}, z)
        y_e = dec_e.apply({"params": p_e}, z)
        np.testing.assert_allclose(np.asarray(y_e), np.asarray(y_c), atol=1e-5)

    def test_adam_dynamics_identical(self):
        """5 Adam steps on both lowerings from the same init: parameter
        trajectories and losses agree to float precision (Adam is
        elementwise, the function is identical)."""
        import optax

        classic_cfg, equiv_cfg = self._cfgs()
        z = jnp.asarray(np.random.default_rng(2).normal(size=(2, 8)).astype(np.float32))
        tgt = jnp.asarray(
            (np.random.default_rng(3).uniform(size=(2, 32, 32, 32, 1)) > 0.7).astype(np.float32)
        )
        dec_c = Decoder3D(classic_cfg)
        p_c = dec_c.init(jax.random.PRNGKey(0), z)["params"]
        dec_e = Decoder3D(equiv_cfg)
        p_e = self._remap(p_c)

        def run(dec, params):
            tx = optax.adam(1e-3)
            opt = tx.init(params)
            losses = []
            for _ in range(5):
                loss, g = jax.value_and_grad(
                    lambda p: jnp.mean((dec.apply({"params": p}, z) - tgt) ** 2)
                )(params)
                upd, opt = tx.update(g, opt, params)
                params = optax.apply_updates(params, upd)
                losses.append(float(loss))
            return losses, params

        losses_c, pc5 = run(dec_c, p_c)
        losses_e, pe5 = run(dec_e, p_e)
        np.testing.assert_allclose(losses_e, losses_c, rtol=1e-4)
        for a, b in zip(
            jax.tree_util.tree_leaves(self._remap(pc5)), jax.tree_util.tree_leaves(pe5)
        ):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=5e-5)

    def test_equiv_blocked_output_layout(self):
        """blocked_output of the transpose_equiv final == s2d(4) of the full
        fine-grid output, elementwise (the standard blocked convention) —
        the fine 64^3 grid is never materialized on the blocked path."""
        from anytime3d_tpu.nn.autoencoder3d import space_to_depth3d

        _, equiv_cfg = self._cfgs()
        z = jnp.asarray(np.random.default_rng(4).normal(size=(2, 8)).astype(np.float32))
        dec = Decoder3D(equiv_cfg)
        p = dec.init(jax.random.PRNGKey(0), z)["params"]
        fine = dec.apply({"params": p}, z)
        blocked = dec.apply({"params": p}, z, blocked_output=True)
        ref = space_to_depth3d(fine, 4)
        assert blocked.shape == ref.shape
        np.testing.assert_allclose(np.asarray(blocked), np.asarray(ref), atol=1e-6)

    def test_remap_decoder_params_roundtrip(self):
        """remap_decoder_params: classic checkpoint loads into the equiv
        layout (and back) with identical outputs — checkpoint composability
        across the layout frontier."""
        from anytime3d_tpu.nn.autoencoder3d import remap_decoder_params

        classic_cfg, equiv_cfg = self._cfgs()
        z = jnp.asarray(np.random.default_rng(7).normal(size=(2, 8)).astype(np.float32))
        dec_c = Decoder3D(classic_cfg)
        p_c = dec_c.init(jax.random.PRNGKey(0), z)["params"]
        dec_e = Decoder3D(equiv_cfg)
        p_e = remap_decoder_params(p_c, classic_cfg, equiv_cfg)
        # structure matches a fresh equiv init
        p_e_init = dec_e.init(jax.random.PRNGKey(1), z)["params"]
        assert jax.tree_util.tree_structure(p_e) == jax.tree_util.tree_structure(p_e_init)
        y_c = dec_c.apply({"params": p_c}, z)
        y_e = dec_e.apply({"params": p_e}, z)
        np.testing.assert_allclose(np.asarray(y_e), np.asarray(y_c), atol=1e-5)
        # and back
        p_rt = remap_decoder_params(p_e, equiv_cfg, classic_cfg)
        for a, b in zip(jax.tree_util.tree_leaves(p_rt), jax.tree_util.tree_leaves(p_c)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        # incompatible reparameterizations refuse loudly
        import dataclasses, pytest
        blocked_cfg = dataclasses.replace(
            classic_cfg, final_mode="pixel_shuffle", tail_blocked=True
        )
        with pytest.raises(ValueError):
            remap_decoder_params(p_c, classic_cfg, blocked_cfg)


class TestBlockedTailDynamicsFixes:
    """r5 in-place fixes for the blocked tail's training dynamics
    (KERNELS.md §5: init fan-in shift + per-phase GroupNorm statistics)."""

    def test_phase_group_norm_matches_classic_fine_grid(self):
        """PhaseGroupNorm on the coarse phase tensor == classic GroupNorm
        after depth_to_space (same statistics pool, same affine params)."""
        from anytime3d_tpu.nn.blocks import (
            PhaseGroupNorm, depth_to_space3d, group_norm, space_to_depth3d,
        )

        C, phases = 8, 8
        x = jax.random.normal(jax.random.PRNGKey(3), (2, 4, 4, 4, phases * C))
        pgn = PhaseGroupNorm(C, phases=phases)
        p = pgn.init(KEY, x)["params"]
        # non-trivial affine so scale/bias placement is checked too
        p = {"scale": p["scale"] * 0 + jnp.arange(1, C + 1, dtype=jnp.float32),
             "bias": jnp.linspace(-1, 1, C)}
        got = pgn.apply({"params": p}, x)

        fine = depth_to_space3d(x, 2)  # (2, 8, 8, 8, C)
        gn = group_norm(C)
        gp = gn.init(KEY, fine)["params"]
        gp = {"scale": p["scale"], "bias": p["bias"]}
        want = space_to_depth3d(gn.apply({"params": gp}, fine), 2)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)

    def test_tail_init_match_transpose_scales_std(self):
        cfg = dict(
            input_dim=8, output_shape=(16, 16, 16, 1), filter_nums=(16, 8, 1),
            filter_sizes=(3, 4, 4), strides=(1, 2, 2),
            final_mode="pixel_shuffle", tail_blocked=True,
        )
        z = jax.random.normal(KEY, (2, 8))
        stds = {}
        for fix in (False, True):
            m = Decoder3D(Decoder3DConfig(**cfg, tail_init_match_transpose=fix))
            params = m.init(jax.random.PRNGKey(11), z)["params"]
            ks = [v["kernel"] for k, v in params.items() if k.startswith("Conv_")]
            assert len(ks) == 2
            stds[fix] = [float(jnp.std(k)) for k in ks]
        for a, b in zip(stds[True], stds[False]):
            assert abs(a / b - 1 / np.sqrt(8)) < 0.08, stds

    def test_blocked_dynfix_decoder_runs_and_blocked_output_parity(self):
        from anytime3d_tpu.nn.blocks import space_to_depth3d

        cfg = Decoder3DConfig(
            input_dim=8, output_shape=(16, 16, 16, 1), filter_nums=(16, 8, 1),
            filter_sizes=(3, 4, 4), strides=(1, 2, 2),
            final_mode="pixel_shuffle", tail_blocked=True,
            tail_init_match_transpose=True, tail_phase_norm=True,
        )
        m = Decoder3D(cfg)
        z = jax.random.normal(KEY, (2, 8))
        params = m.init(KEY, z)["params"]
        fine = m.apply({"params": params}, z)
        coarse = m.apply({"params": params}, z, blocked_output=True)
        np.testing.assert_allclose(
            np.asarray(space_to_depth3d(fine, 4)), np.asarray(coarse),
            rtol=1e-5, atol=1e-5,
        )
        g = jax.grad(lambda p: jnp.sum(m.apply({"params": p}, z) ** 2))(params)
        assert all(
            bool(jnp.all(jnp.isfinite(l)))
            for l in jax.tree_util.tree_leaves(g)
        )


def test_decoder_stage_names_match_param_tree_all_layouts():
    """_decoder_stage_names hand-mirrors Decoder3D.__call__'s branch
    structure; this pins the two against each other for EVERY layout combo
    so a future branch added to one but not the other fails loudly instead
    of silently corrupting remap_decoder_params' name zip (ADVICE r4)."""
    import itertools

    from anytime3d_tpu.nn.autoencoder3d import _decoder_stage_names

    z = jax.random.normal(KEY, (1, 8))
    combos = itertools.product(
        ("pixel_shuffle", "transpose", "transpose_equiv"),
        (False, True),  # tail_blocked
        (False, True),  # mid_blocked
        (False, True),  # mid_equiv
    )
    for final_mode, tail, midb, mide in combos:
        cfg = Decoder3DConfig(
            input_dim=8, output_shape=(16, 16, 16, 1),
            filter_nums=(16, 8, 1), filter_sizes=(4, 4, 4),
            strides=(1, 2, 2), final_mode=final_mode, tail_blocked=tail,
            mid_blocked=midb, mid_equiv=mide,
        )
        params = Decoder3D(cfg).init(KEY, z)["params"]
        stage_keys = {
            k for k in params
            if not (k.startswith("DenseBlock") or "GroupNorm" in k)
        }
        names = _decoder_stage_names(cfg)
        assert stage_keys == set(names), (
            final_mode, tail, midb, mide, sorted(stage_keys), names
        )
