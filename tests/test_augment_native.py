"""Native batch augmentation engine (native/augment.cpp) tests.

Oracle: ``_augment_one_numpy`` — the exact same fused inverse-map bilinear
gather in vectorized NumPy. Cross-checks: identity-transform output against
cv2.resize (the reference's resampling, datasetUtils.py:91-152), bbox remap
consistency, flip semantics, multi-threaded == single-threaded.
"""

import numpy as np
import pytest

from anytime3d_tpu.data.augment import (
    _augment_one_numpy,
    augment_batch,
    augment_native_available,
    remap_bbox,
)

@pytest.fixture
def native_augment():
    if not augment_native_available():
        pytest.skip("libaugment.so cannot be built here (make -C native)")


needs_native = pytest.mark.usefixtures("native_augment")


def _images(rng, n=6, hetero=True):
    out = []
    for i in range(n):
        r = int(rng.integers(20, 70)) if hetero else 48
        c = int(rng.integers(20, 70)) if hetero else 48
        out.append(rng.uniform(0, 255, (r, c, 3)).astype(np.float32))
    return out


@needs_native
def test_native_matches_numpy_oracle():
    rng = np.random.default_rng(0)
    imgs = _images(rng)
    st_rng = np.random.default_rng(7)
    out, params, flips = augment_batch(
        np.random.default_rng(7), imgs, (40, 32), augmentation=True, flip_prob=0.5
    )
    # re-draw the same (scale, tx, ty, flip) stream the wrapper drew
    st = st_rng.uniform([0.8, -0.2, -0.2], [1.2, 0.2, 0.2], (len(imgs), 3)).astype(
        np.float32
    )
    fl = st_rng.random(len(imgs)) < 0.5
    np.testing.assert_array_equal(flips, fl)
    for i, img in enumerate(imgs):
        ref, ref_params = _augment_one_numpy(
            img, 32, 40, *(float(v) for v in st[i]), flip=bool(fl[i])
        )
        # native computes sample coordinates in fp32, the oracle in fp64 —
        # a ~1e-5 relative coordinate delta moves bilinear weights slightly
        np.testing.assert_allclose(out[i], ref, atol=1e-2)
        np.testing.assert_allclose(params[i], ref_params, rtol=1e-6, atol=1e-7)


@needs_native
def test_identity_matches_cv2_resize():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (30, 40, 3)).astype(np.float32)  # already 4:3
    out, params, _ = augment_batch(rng, [img], (40, 30), augmentation=False)
    # aspect matches output -> no padding; identity affine -> pure resize
    ref = cv2.resize(img, (40, 30), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(out[0], ref, atol=1e-2)
    assert params[0][0] == 1.0 and params[0][3] == 0.0 and params[0][4] == 0.0


@needs_native
def test_bbox_remap_tracks_content():
    """A bright rectangle's remapped bbox must cover its warped pixels."""
    rng = np.random.default_rng(2)
    img = np.zeros((50, 80, 3), np.float32)
    img[15:35, 20:60] = 255.0
    bbox = np.array([20 / 80, 15 / 50, 60 / 80, 35 / 50], np.float32)
    out, params, _ = augment_batch(rng, [img], (64, 64), augmentation=True)
    b = remap_bbox(bbox, params[0])
    ys, xs = np.where(out[0, :, :, 0] > 127)
    if len(xs) == 0:
        pytest.skip("content translated fully out of frame (rare draw)")
    x0, x1 = xs.min() / 64, xs.max() / 64
    y0, y1 = ys.min() / 64, ys.max() / 64
    tol = 2.5 / 64  # bilinear feathering + pixel quantization
    assert b[0] <= x0 + tol and b[2] >= x1 - tol
    assert b[1] <= y0 + tol and b[3] >= y1 - tol


@needs_native
def test_flip_is_mirror():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (32, 32, 3)).astype(np.float32)
    out_f, _, _ = augment_batch(
        np.random.default_rng(0), [img], (32, 32), augmentation=False, flip_prob=1.0
    )
    out_n, _, _ = augment_batch(
        np.random.default_rng(0), [img[:, ::-1].copy()], (32, 32), augmentation=False
    )
    np.testing.assert_allclose(out_f[0], out_n[0], atol=2e-3)


@needs_native
def test_threads_deterministic():
    rng = np.random.default_rng(4)
    imgs = _images(rng, n=16)
    a, pa, _ = augment_batch(np.random.default_rng(5), imgs, (48, 48), n_threads=1)
    b, pb, _ = augment_batch(np.random.default_rng(5), imgs, (48, 48), n_threads=8)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(pa), np.asarray(pb))


@needs_native
def test_channel_promotion_rgba_and_single_channel():
    """ADVICE r1 (high): a uniform 4-channel (RGBA) batch used to overflow the
    3-channel output buffer, and (H,W,1) batches produced mis-strided output.
    The wrapper now promotes every image to exactly 3 channels."""
    rng = np.random.default_rng(6)
    rgb = rng.uniform(0, 255, (4, 30, 40, 3)).astype(np.float32)
    rgba = np.concatenate([rgb, np.full((4, 30, 40, 1), 128.0, np.float32)], -1)
    single = rgb[..., :1].copy()

    out_rgb, p_rgb, _ = augment_batch(np.random.default_rng(9), list(rgb), (40, 30))
    out_rgba, p_rgba, _ = augment_batch(np.random.default_rng(9), list(rgba), (40, 30))
    # alpha is dropped: RGBA result identical to the RGB result
    np.testing.assert_array_equal(out_rgba, out_rgb)
    np.testing.assert_array_equal(np.asarray(p_rgba), np.asarray(p_rgb))

    out_1, _, _ = augment_batch(np.random.default_rng(9), list(single), (40, 30))
    ref_1, _, _ = augment_batch(
        np.random.default_rng(9), [np.repeat(s, 3, axis=2) for s in single], (40, 30)
    )
    np.testing.assert_array_equal(out_1, ref_1)

    with pytest.raises(ValueError):
        augment_batch(rng, [rng.uniform(0, 255, (8, 8, 5)).astype(np.float32)], (8, 8))


@needs_native
def test_half_integer_pad_size_matches_oracle():
    """ADVICE r1 (medium): at half-integer padded sizes (26 rows -> 40x32
    output: 26*1.25 = 32.5) lround (half-away-from-zero) and Python round()
    (banker's) used to pick different padded widths — both backends now use
    floor(x+0.5)."""
    rng = np.random.default_rng(8)
    img = rng.uniform(0, 255, (26, 20, 3)).astype(np.float32)
    out, params, _ = augment_batch(
        np.random.default_rng(11), [img], (40, 32), augmentation=False
    )
    ref, ref_params = _augment_one_numpy(img, 32, 40, 1.0, 0.0, 0.0)
    np.testing.assert_allclose(params[0], ref_params, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(out[0], ref, atol=1e-2)
    # the shared rule is half-up: padded width floor(26*1.25+0.5) = 33
    assert abs(ref_params[5] - 20.0 / 33.0) < 1e-6


def test_env_var_disables_native(monkeypatch):
    """ADVICE r1 (low): ANYTIME3D_AUGMENT_LIB set to ''/'0'/'off' forces the
    classic path even when libaugment.so is built."""
    import anytime3d_tpu.data.augment as aug

    for value in ("", "0", "off", "none"):
        monkeypatch.setattr(aug, "_AUG_LIB", None)
        monkeypatch.setattr(aug, "_AUG_LIB_TRIED", False)
        monkeypatch.setenv("ANYTIME3D_AUGMENT_LIB", value)
        assert aug._find_augment_lib() is None
    monkeypatch.setattr(aug, "_AUG_LIB", None)
    monkeypatch.setattr(aug, "_AUG_LIB_TRIED", False)
    monkeypatch.delenv("ANYTIME3D_AUGMENT_LIB", raising=False)
    aug._find_augment_lib()  # unset -> default discovery (may or may not load)


def test_numpy_fallback_pads_and_grayscale():
    """Fallback path (and oracle) semantics: grayscale promotion + aspect pad."""
    img = np.arange(20 * 10, dtype=np.float32).reshape(20, 10)  # tall, 2D
    out, params = _augment_one_numpy(img, 16, 16, 1.0, 0.0, 0.0)
    assert out.shape == (16, 16, 3)
    # tall image pads columns: pad_l_frac > 0, w_frac < 1, full-height content
    assert params[3] > 0 and params[5] < 1.0 and params[6] == 1.0
    # padded border is zero
    assert float(np.abs(out[:, 0]).max()) == 0.0
