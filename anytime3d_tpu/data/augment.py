"""Pure-NumPy/cv2 image augmentation with explicit RNG.

Reference semantics: src/dataset_loader/datasetUtils.py —
``imageRandomAugmentation`` (:91-152: pad-to-aspect, random scale 0.8-1.2,
translate ±20% affine warp, resize, returns transform params for label
remap) and the ``imgAug`` photometric pipeline (:64-89, imgaug-based) rebuilt
here with cv2 primitives (imgaug is not available and pulls a host-side
dependency chain; everything below is vectorized NumPy).
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from anytime3d_tpu.data.native import native_lib

try:
    import cv2
except Exception:  # pragma: no cover - cv2 is present in the target image
    cv2 = None


def photometric_augment(rng: np.random.Generator, image: np.ndarray) -> np.ndarray:
    """Random photometric jitter: brightness, contrast, blur, invert, additive
    noise — the imgAug pipeline analogue (datasetUtils.py:64-89). Input uint8
    or float [0,255]; returns same dtype range float32."""
    img = image.astype(np.float32)
    if rng.random() < 0.5:  # brightness
        img = img + rng.uniform(-25, 25)
    if rng.random() < 0.5:  # contrast
        img = (img - 127.5) * rng.uniform(0.7, 1.3) + 127.5
    if rng.random() < 0.2 and cv2 is not None:  # blur
        k = int(rng.integers(1, 3)) * 2 + 1
        img = cv2.GaussianBlur(img, (k, k), 0)
    if rng.random() < 0.1:  # invert (datasetUtils.py:77 Invert(0.1))
        img = 255.0 - img
    if rng.random() < 0.3:  # gaussian noise
        img = img + rng.normal(0, 8, img.shape)
    if (
        rng.random() < 0.5
        and cv2 is not None
        and img.ndim == 3
        and img.shape[2] == 3
    ):
        # hue/saturation jitter (datasetUtils.py:76 AddToHueAndSaturation
        # (-20, 20)): one shared shift added to the H (wrapping, OpenCV
        # uint8 hue range [0,180)) and S channels
        shift = float(rng.uniform(-20, 20))
        hsv = cv2.cvtColor(
            np.clip(img, 0, 255).astype(np.uint8), cv2.COLOR_RGB2HSV
        ).astype(np.float32)
        hsv[..., 0] = np.mod(hsv[..., 0] + shift * 180.0 / 255.0, 180.0)
        hsv[..., 1] = np.clip(hsv[..., 1] + shift, 0.0, 255.0)
        img = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.float32)


def noisy(
    rng: np.random.Generator, noise_type: str, image: np.ndarray
) -> np.ndarray:
    """Parametric noise models matching the reference's ``noisy``
    (datasetUtils.py:15-52): 'gauss' | 's&p' | 'poisson' | 'speckle'.
    Operates on float images in [0, 255]."""
    img = image.astype(np.float32)
    if noise_type == "gauss":
        return img + rng.normal(0.0, 10.0, img.shape)
    if noise_type == "s&p":
        amount, s_vs_p = 0.004, 0.5
        out = img.copy()
        n_salt = int(np.ceil(amount * img.size * s_vs_p))
        n_pepper = int(np.ceil(amount * img.size * (1.0 - s_vs_p)))
        coords = tuple(rng.integers(0, d, n_salt) for d in img.shape)
        out[coords] = 255.0
        coords = tuple(rng.integers(0, d, n_pepper) for d in img.shape)
        out[coords] = 0.0
        return out
    if noise_type == "poisson":
        vals = 2 ** np.ceil(np.log2(len(np.unique(img.astype(np.uint8)))))
        return rng.poisson(np.clip(img, 0, None) / 255.0 * vals) / vals * 255.0
    if noise_type == "speckle":
        return img + img * rng.normal(0.0, 0.1, img.shape)
    raise ValueError(f"unknown noise type {noise_type!r}")


def _to_rgb3(image: np.ndarray) -> np.ndarray:
    """Promote/validate an image to exactly 3 channels, contiguous float32.

    Every consumer of the native engine sizes its output buffer for 3
    channels, and ``augment_batch`` (native/augment.cpp) writes ``ch_out``
    floats per pixel — so the wrapper guarantees ch==3 up front: grayscale
    (H,W) and (H,W,1) are repeated, RGBA drops alpha, anything else raises
    (rather than overflowing or mis-striding the output buffer)."""
    im = np.asarray(image, np.float32)
    if im.ndim == 2:
        im = np.stack([im] * 3, axis=-1)
    elif im.ndim == 3 and im.shape[2] == 1:
        im = np.repeat(im, 3, axis=2)
    elif im.ndim == 3 and im.shape[2] == 4:
        im = im[:, :, :3]
    if im.ndim != 3 or im.shape[2] != 3:
        raise ValueError(
            f"augment expects (H,W), (H,W,1), (H,W,3) or (H,W,4) images; got {image.shape}"
        )
    return np.ascontiguousarray(im)


def image_random_augmentation(
    rng: np.random.Generator,
    image: np.ndarray,
    image_size: Tuple[int, int],  # (cols, rows) output
    augmentation: bool = True,
    add_noise: bool = False,
    scale_range: Tuple[float, float] = (0.8, 1.2),
    translate_frac: float = 0.2,
    pad_to_aspect: bool = True,
):
    """Geometric + optional photometric augmentation.

    Returns ``(image_out, params)`` where ``params`` = (scale, tx_frac,
    ty_frac, pad_left_frac, pad_top_frac, content_w_frac, content_h_frac)
    describing the full pixel transform so box/point labels can be remapped
    with ``remap_bbox`` (the reference returns equivalent params,
    datasetUtils.py:137-152).
    """
    out_c, out_r = image_size
    img = _to_rgb3(image)
    in_r, in_c = img.shape[:2]

    # the affine params are drawn FIRST so both backends consume the RNG
    # stream identically (padding is deterministic)
    if augmentation:
        scale = float(rng.uniform(*scale_range))
        tx = float(rng.uniform(-translate_frac, translate_frac))
        ty = float(rng.uniform(-translate_frac, translate_frac))
    else:
        scale, tx, ty = 1.0, 0.0, 0.0

    lib = _find_augment_lib()
    if lib is not None:
        # native fused path (native/augment.cpp): pad-to-aspect + warp +
        # resize as ONE bilinear gather — no padded/warped intermediates,
        # one resampling instead of cv2's two. Same params contract.
        out, params = _augment_one_native(
            lib, img, out_r, out_c, scale, tx, ty, pad_to_aspect=pad_to_aspect
        )
        if add_noise:
            out = photometric_augment(rng, out)
        return out.astype(np.float32), params

    # pad to output aspect ratio, content centered. Half-up rounding
    # (floor(x+0.5)) is the ONE padded-size rule shared with
    # native/augment.cpp — Python's round() is banker's and diverges at
    # half-integer sizes.
    pad_l = pad_t = 0
    if pad_to_aspect:
        target_ar = out_c / out_r
        ar = in_c / in_r
        if ar < target_ar:  # too narrow: pad cols
            new_c = int(np.floor(in_r * target_ar + 0.5))
            pad_l = (new_c - in_c) // 2
            img = np.pad(img, ((0, 0), (pad_l, new_c - in_c - pad_l), (0, 0)))
        elif ar > target_ar:  # too wide: pad rows
            new_r = int(np.floor(in_c / target_ar + 0.5))
            pad_t = (new_r - in_r) // 2
            img = np.pad(img, ((pad_t, new_r - in_r - pad_t), (0, 0), (0, 0)))
    padded_r, padded_c = img.shape[:2]

    if cv2 is not None:
        m = np.array(
            [
                [scale, 0.0, (1 - scale) * padded_c / 2.0 + tx * padded_c],
                [0.0, scale, (1 - scale) * padded_r / 2.0 + ty * padded_r],
            ],
            np.float32,
        )
        img = cv2.warpAffine(img, m, (padded_c, padded_r))
        img = cv2.resize(img, (out_c, out_r))
    else:  # numpy fallback: nearest resize only
        ys = (np.arange(out_r) * padded_r / out_r).astype(int)
        xs = (np.arange(out_c) * padded_c / out_c).astype(int)
        img = img[ys][:, xs]

    if add_noise:
        img = photometric_augment(rng, img)

    params = (
        scale,
        tx,
        ty,
        pad_l / padded_c,
        pad_t / padded_r,
        in_c / padded_c,
        in_r / padded_r,
    )
    return img.astype(np.float32), params


def remap_bbox(bbox_frac: np.ndarray, params) -> np.ndarray:
    """Remap [x0, y0, x1, y1] fractions of the ORIGINAL image through the
    transform described by ``image_random_augmentation`` params, into
    fractions of the output image."""
    scale, tx, ty, pad_l, pad_t, w_frac, h_frac = params
    b = np.asarray(bbox_frac, np.float32).copy()
    # original -> padded fractions
    b[..., [0, 2]] = pad_l + b[..., [0, 2]] * w_frac
    b[..., [1, 3]] = pad_t + b[..., [1, 3]] * h_frac
    # affine about padded center + translation
    b[..., [0, 2]] = (b[..., [0, 2]] - 0.5) * scale + 0.5 + tx
    b[..., [1, 3]] = (b[..., [1, 3]] - 0.5) * scale + 0.5 + ty
    return b


def _augment_one_numpy(
    image: np.ndarray,
    out_r: int,
    out_c: int,
    scale: float,
    tx: float,
    ty: float,
    flip: bool = False,
    pad_to_aspect: bool = True,
):
    """Vectorized NumPy twin of native/augment.cpp::run_job — the exact same
    fused inverse-map bilinear gather (pad-to-aspect + affine about padded
    center + resize, single resampling, zero border). Used as the fallback
    when the native library is not built and as the oracle in its tests."""
    im = _to_rgb3(image)
    rows, cols, ch = im.shape
    pad_l = pad_t = 0
    padded_r, padded_c = rows, cols
    if pad_to_aspect:
        target_ar = out_c / out_r
        ar = cols / rows
        # half-up rounding shared with native/augment.cpp (see
        # image_random_augmentation)
        if ar < target_ar:
            new_c = int(np.floor(rows * target_ar + 0.5))
            pad_l = (new_c - cols) // 2
            padded_c = new_c
        elif ar > target_ar:
            new_r = int(np.floor(cols / target_ar + 0.5))
            pad_t = (new_r - rows) // 2
            padded_r = new_r
    off_x = (1.0 - scale) * padded_c * 0.5 + tx * padded_c
    off_y = (1.0 - scale) * padded_r * 0.5 + ty * padded_r
    xp = (np.arange(out_c, dtype=np.float64) + 0.5) * (padded_c / out_c) - 0.5
    yp = (np.arange(out_r, dtype=np.float64) + 0.5) * (padded_r / out_r) - 0.5
    x_orig = (xp - off_x) / scale - pad_l
    y_orig = (yp - off_y) / scale - pad_t
    if flip:
        x_orig = (cols - 1) - x_orig
    xg, yg = np.meshgrid(x_orig, y_orig)  # (out_r, out_c)
    x0 = np.floor(xg).astype(np.int64)
    y0 = np.floor(yg).astype(np.int64)
    wx = (xg - x0).astype(np.float32)[..., None]
    wy = (yg - y0).astype(np.float32)[..., None]

    def gather(yi, xi):
        ok = (yi >= 0) & (yi < rows) & (xi >= 0) & (xi < cols)
        v = im[np.clip(yi, 0, rows - 1), np.clip(xi, 0, cols - 1)]
        return np.where(ok[..., None], v, 0.0)

    out = (
        gather(y0, x0) * (1 - wx) * (1 - wy)
        + gather(y0, x0 + 1) * wx * (1 - wy)
        + gather(y0 + 1, x0) * (1 - wx) * wy
        + gather(y0 + 1, x0 + 1) * wx * wy
    ).astype(np.float32)
    params = (
        scale, tx, ty,
        pad_l / padded_c, pad_t / padded_r,
        cols / padded_c, rows / padded_r,
    )
    return out, params


def _augment_one_native(
    lib: ctypes.CDLL,
    image: np.ndarray,
    out_r: int,
    out_c: int,
    scale: float,
    tx: float,
    ty: float,
    flip: bool = False,
    pad_to_aspect: bool = True,
):
    """Single-image call into native/augment.cpp (n=1, caller's thread —
    loaders already fan out over a thread pool, and ctypes releases the GIL
    for the call's duration so workers overlap)."""
    im = _to_rgb3(image)
    shapes = np.array([im.shape[0], im.shape[1], im.shape[2]], np.int32)
    ptrs = (ctypes.POINTER(ctypes.c_float) * 1)(
        im.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    )
    st = np.array([scale, tx, ty], np.float32)
    fl = np.array([1 if flip else 0], np.uint8)
    out = np.empty((out_r, out_c, 3), np.float32)
    params_out = np.empty(7, np.float32)
    rc = lib.augment_batch(
        ptrs,
        shapes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        1, out_r, out_c,
        st.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        fl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        1 if pad_to_aspect else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        params_out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        3,  # ch_out: the channel count `out` was sized for
        1,
    )
    if rc != 0:  # pragma: no cover
        raise RuntimeError(f"augment_batch native call failed (code {rc})")
    return out, tuple(float(v) for v in params_out)


_AUG_LIB: Optional[ctypes.CDLL] = None
_AUG_LIB_TRIED = False


def _find_augment_lib() -> Optional[ctypes.CDLL]:
    global _AUG_LIB, _AUG_LIB_TRIED
    if _AUG_LIB_TRIED:
        return _AUG_LIB
    _AUG_LIB_TRIED = True
    env = os.environ.get("ANYTIME3D_AUGMENT_LIB")
    if env is not None and env.strip().lower() in ("", "0", "off", "none"):
        # explicit disable: force the classic cv2/NumPy path even when
        # libaugment.so is built, so augmentation numerics can be pinned to
        # one backend across machines (same convention as the sanitizer
        # override below — set the var to a path to use that build instead).
        return None
    candidates = [env or native_lib("libaugment.so") or ""]  # env: sanitizer builds
    for path in (c for c in candidates if c):
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
                lib.augment_batch.argtypes = [
                    ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.c_int32,
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.c_int32,  # ch_out
                    ctypes.c_int32,  # n_threads
                ]
                lib.augment_batch.restype = ctypes.c_int32
                _AUG_LIB = lib
                break
            except OSError:  # pragma: no cover
                continue
    return _AUG_LIB


def augment_native_available() -> bool:
    return _find_augment_lib() is not None


def augment_batch(
    rng: np.random.Generator,
    images: Sequence[np.ndarray],
    image_size: Tuple[int, int],  # (cols, rows) output
    augmentation: bool = True,
    scale_range: Tuple[float, float] = (0.8, 1.2),
    translate_frac: float = 0.2,
    pad_to_aspect: bool = True,
    flip_prob: float = 0.0,
    n_threads: int = 0,
):
    """Batch geometric augmentation via the native engine (native/augment.cpp):
    the whole pad-to-aspect + affine + resize chain of
    ``image_random_augmentation`` fused into one inverse-map bilinear gather
    per image, fanned over a thread pool. RNG draws stay in NumPy (one
    (scale, tx, ty, flip) tuple per image), so behavior is reproducible from
    the generator state alone.

    Returns ``(batch, params, flipped)``: batch (n, rows, cols, 3) float32,
    ``params`` the per-image 7-tuples understood by ``remap_bbox``, and
    ``flipped`` the per-image horizontal-flip flags (callers negate azimuth,
    pascal3D.py:227-248). Falls back to the per-image Python path when the
    native library is not built.
    """
    n = len(images)
    out_c, out_r = image_size
    if augmentation:
        st = rng.uniform(
            [scale_range[0], -translate_frac, -translate_frac],
            [scale_range[1], translate_frac, translate_frac],
            (n, 3),
        ).astype(np.float32)
    else:
        st = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (n, 1))
    flips = (
        (rng.random(n) < flip_prob).astype(np.uint8)
        if flip_prob > 0
        else np.zeros(n, np.uint8)
    )

    lib = _find_augment_lib()
    if lib is None:
        out = np.empty((n, out_r, out_c, 3), np.float32)
        params = []
        for i, img in enumerate(images):
            o, p = _augment_one_numpy(
                img, out_r, out_c, *(float(v) for v in st[i]),
                flip=bool(flips[i]), pad_to_aspect=pad_to_aspect,
            )
            out[i] = o
            params.append(p)
        return out, params, flips.astype(bool)

    held: List[np.ndarray] = []  # keep converted arrays alive for the call
    shapes = np.zeros((n, 3), np.int32)
    ptrs = (ctypes.POINTER(ctypes.c_float) * n)()
    for i, img in enumerate(images):
        im = _to_rgb3(img)  # out is sized (n, r, c, 3); every input must be 3ch
        shapes[i] = (im.shape[0], im.shape[1], im.shape[2])
        ptrs[i] = im.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        held.append(im)

    out = np.empty((n, out_r, out_c, 3), np.float32)
    params_out = np.empty((n, 7), np.float32)
    rc = lib.augment_batch(
        ptrs,
        shapes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, out_r, out_c,
        st.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        flips.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        1 if pad_to_aspect else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        params_out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        3,  # ch_out: the channel count `out` was sized for
        n_threads,
    )
    if rc != 0:  # pragma: no cover
        raise RuntimeError(f"augment_batch native call failed (code {rc})")
    return out, [tuple(float(v) for v in p) for p in params_out], flips.astype(bool)


def random_flip_horizontal(
    rng: np.random.Generator, image: np.ndarray, prob: float = 0.5
) -> tuple[np.ndarray, bool]:
    """Horizontal flip; callers negate azimuth when flipped
    (pascal3D.py:227-248)."""
    if rng.random() < prob:
        return image[:, ::-1].copy(), True
    return image, False
