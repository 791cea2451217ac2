"""The in-repo module layer (anytime3d_tpu/nn/module.py) against flax.linen.

Runs only where flax imports. Layer by layer: the same parameter tree, the
same initial values for the same key, and the same outputs for the same
params. Model by model: the package's own model definitions, loaded once on
this layer and once on flax.linen, give identical parameter paths and
shapes, so checkpoints, TP sharding rules and ``remap_decoder_params`` keep
their meaning.
"""

from __future__ import annotations

import contextlib
import importlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from anytime3d_tpu.nn import module as nn

KEY = jax.random.PRNGKey(3)


def _linen():
    return pytest.importorskip("flax.linen")


LAYERS = {
    "conv3d_bf16": (lambda m: m.Conv(16, (3, 3, 3), strides=2, dtype=jnp.bfloat16), (2, 6, 6, 6, 8)),
    "conv3d_nobias": (lambda m: m.Conv(4, (2, 2, 2), use_bias=False), (2, 4, 4, 4, 8)),
    "conv2d": (lambda m: m.Conv(8, (3, 3), strides=(2, 2)), (2, 9, 7, 3)),
    "conv_transpose3d": (
        lambda m: m.ConvTranspose(4, (4, 4, 4), strides=(2, 2, 2), use_bias=False),
        (2, 4, 4, 4, 8),
    ),
    "conv_transpose3d_bias_bf16": (
        lambda m: m.ConvTranspose(3, (4, 4, 4), strides=(2, 2, 2), dtype=jnp.bfloat16),
        (1, 3, 3, 3, 2),
    ),
    "dense": (lambda m: m.Dense(5), (3, 7)),
    "dense_bf16": (lambda m: m.Dense(5, dtype=jnp.bfloat16), (3, 7)),
    "group_norm_3d_bf16": (
        lambda m: m.GroupNorm(num_groups=4, epsilon=1e-5, dtype=jnp.bfloat16),
        (2, 4, 4, 4, 8),
    ),
    "group_norm_2d": (lambda m: m.GroupNorm(num_groups=2, epsilon=1e-5), (2, 5, 5, 6)),
    "layer_norm": (lambda m: m.LayerNorm(), (4, 9)),
    "layer_norm_bf16": (lambda m: m.LayerNorm(dtype=jnp.bfloat16), (4, 9)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_flax(name):
    linen = _linen()
    make, shape = LAYERS[name]
    x = jax.random.normal(jax.random.PRNGKey(1), shape)
    ours, ref = make(nn), make(linen)
    p_ours, p_ref = ours.init(KEY, x), ref.init(KEY, x)
    assert jax.tree_util.tree_structure(p_ours) == jax.tree_util.tree_structure(p_ref)
    jax.tree_util.tree_map(np.testing.assert_array_equal, p_ours, p_ref)
    y_ours, y_ref = ours.apply(p_ref, x), ref.apply(p_ref, x)
    assert y_ours.dtype == y_ref.dtype
    np.testing.assert_array_equal(np.asarray(y_ours, np.float32), np.asarray(y_ref, np.float32))


def test_dropout_matches_flax():
    linen = _linen()
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 32))
    rngs = {"dropout": jax.random.PRNGKey(7)}
    for deterministic in (False, True):
        y_ours = nn.Dropout(0.2, deterministic=deterministic).apply({}, x, rngs=rngs)
        y_ref = linen.Dropout(0.2, deterministic=deterministic).apply({}, x, rngs=rngs)
        np.testing.assert_array_equal(np.asarray(y_ours), np.asarray(y_ref))


def test_max_pool_matches_flax():
    linen = _linen()
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 7, 6, 3)).astype(jnp.bfloat16)
    for strides in ((2, 2), (1, 1)):
        np.testing.assert_array_equal(
            np.asarray(nn.max_pool(x, (2, 2), strides, "SAME"), np.float32),
            np.asarray(linen.max_pool(x, (2, 2), strides=strides, padding="SAME"), np.float32),
        )


_PREFIXES = ("anytime3d_tpu.nn", "anytime3d_tpu.models")


@contextlib.contextmanager
def _models_on(layer):
    """Import the package's model modules afresh with ``layer`` standing in
    for ``anytime3d_tpu.nn.module``; restore every module afterwards."""
    pkg = importlib.import_module("anytime3d_tpu")
    saved_attrs = {a: getattr(pkg, a) for a in ("nn", "models")}
    saved = {k: v for k, v in sys.modules.items() if k.startswith(_PREFIXES)}
    for k in saved:
        del sys.modules[k]
    sys.modules["anytime3d_tpu.nn.module"] = layer
    try:
        models = types.SimpleNamespace(
            mmvae=importlib.import_module("anytime3d_tpu.models.mmvae"),
            detector=importlib.import_module("anytime3d_tpu.models.detector"),
            classifier=importlib.import_module("anytime3d_tpu.models.classifier"),
        )
        assert models.mmvae.nn is layer
        yield models
    finally:
        for k in [k for k in sys.modules if k.startswith(_PREFIXES)]:
            del sys.modules[k]
        sys.modules.update(saved)
        for a, v in saved_attrs.items():
            setattr(pkg, a, v)


def _flax_layer(linen):
    layer = types.ModuleType("anytime3d_tpu.nn.module")
    layer.__dict__.update(vars(linen))
    layer.promote_dtype = linen.dtypes.promote_dtype
    return layer


def _model_and_input(models, name):
    from anytime3d_tpu.models import configs

    if name == "detector":
        return models.detector.DetectorReconstructor(models.detector.DetectorConfig()), (1, 96, 128, 3)
    if name == "classifier":
        cfg = models.classifier.ClassifierConfig(num_classes=10)
        return models.classifier.Classifier(cfg), (1, 64, 64, 3)
    cfg = configs.REGISTRY[name]()
    shape = (1, 64, 64, 3) if cfg.encoder == "image" else (1, *cfg.decoder.output_shape)
    return models.mmvae.MultiModalVAE(cfg), shape


def _param_shapes(models, name):
    model, shape = _model_and_input(models, name)
    method = getattr(model, "initialize", None)
    tree = jax.eval_shape(
        lambda: model.init({"params": KEY, "dropout": KEY}, jnp.zeros(shape), method=method)
    )
    return {
        jax.tree_util.keystr(path, simple=True, separator="/"): leaf.shape
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree)
    }


def _model_names():
    from anytime3d_tpu.models import configs

    return sorted(configs.REGISTRY) + ["detector", "classifier"]


@pytest.fixture(scope="module")
def flax_param_shapes():
    linen = _linen()
    with _models_on(_flax_layer(linen)) as models:
        return {name: _param_shapes(models, name) for name in _model_names()}


@pytest.mark.parametrize("name", _model_names())
def test_model_param_paths_match_flax(name, flax_param_shapes):
    import anytime3d_tpu.models as models

    models = types.SimpleNamespace(
        mmvae=models.mmvae, detector=models.detector, classifier=models.classifier
    )
    assert _param_shapes(models, name) == flax_param_shapes[name]


def test_small_model_init_and_forward_match_flax():
    """Same key, same initial values; same params, same output — through
    setup-defined children, auto-named children and explicit names."""
    linen = _linen()
    from anytime3d_tpu.models.mmvae import MultiModalVAE
    from tests.test_train import tiny_voxel_cfg

    cfg = tiny_voxel_cfg(variational=True, with_prior=True)
    x = jax.random.uniform(jax.random.PRNGKey(2), (2, *cfg.decoder.output_shape))
    rngs = {"params": KEY, "dropout": KEY}
    ours = MultiModalVAE(cfg)
    p_ours = ours.init(rngs, x, method=ours.initialize)
    with _models_on(_flax_layer(linen)) as models:
        ref = models.mmvae.MultiModalVAE(cfg)
        p_ref = ref.init(rngs, x, method=ref.initialize)
        y_ref = ref.apply(p_ref, x)
        onehot = jnp.eye(cfg.prior_category.input_dim)[:2]
        prior_ref = ref.apply(
            p_ref, onehot, False, method=ref.priors_category,
            rngs={"dropout": jax.random.PRNGKey(5)},
        )
    jax.tree_util.tree_map(np.testing.assert_array_equal, p_ours, p_ref)
    np.testing.assert_array_equal(np.asarray(ours.apply(p_ref, x)), np.asarray(y_ref))
    prior_ours = ours.apply(
        p_ref, onehot, False, method=MultiModalVAE.priors_category,
        rngs={"dropout": jax.random.PRNGKey(5)},
    )
    jax.tree_util.tree_map(np.testing.assert_array_equal, prior_ours, prior_ref)
