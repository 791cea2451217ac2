"""Native blocked packer (native/pack.cpp) vs the NumPy oracle.

The contract: `pack_voxels_blocked` produces IDENTICAL bytes whether the
native single-pass packer or the NumPy transpose+packbits path runs — the
bit order is np.packbits MSB-first over the (B, D/b, H/b, W/b, b, b, b, C)
transpose flatten. Skips where libpack.so cannot be built (`make -C native`)."""

import numpy as np
import pytest

from anytime3d_tpu.data import packing


@pytest.fixture
def native_pack():
    if packing._find_pack_lib() is None:
        pytest.skip("libpack.so cannot be built here (make -C native)")


needs_lib = pytest.mark.usefixtures("native_pack")


def _numpy_oracle(v, b):
    if v.ndim == 4:
        v = v[..., None]
    B, D, H, W, C = v.shape
    x = v.reshape(B, D // b, b, H // b, b, W // b, b, C).transpose(0, 1, 3, 5, 2, 4, 6, 7)
    return np.packbits(x.reshape(B, -1) > 0.5, axis=-1)


@needs_lib
class TestNativeMatchesOracle:
    @pytest.mark.parametrize("shape,block", [
        ((3, 16, 16, 16, 1), 4),
        ((2, 64, 64, 64, 1), 4),
        ((2, 8, 8, 8, 2), 2),     # multi-channel
        ((1, 12, 8, 16, 3), 2),   # anisotropic + C=3: 8*3=24 bits per row seg
        ((5, 16, 16, 16), 4),     # no channel dim (added by the wrapper)
    ])
    def test_equal_bytes(self, shape, block):
        rng = np.random.default_rng(hash(shape) % 2**31)
        v = (rng.uniform(size=shape) > 0.6).astype(np.float32)
        got = packing.pack_voxels_blocked(v, block=block)
        want = _numpy_oracle(v, block)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)

    def test_non_byte_aligned_tail(self):
        """D*H*W*C % 8 != 0: final byte zero-padded like np.packbits."""
        v = (np.random.default_rng(0).uniform(size=(2, 2, 2, 2, 3)) > 0.4).astype(np.float32)
        got = packing.pack_voxels_blocked(v, block=2)
        np.testing.assert_array_equal(got, _numpy_oracle(v, 2))

    def test_roundtrip_through_device_unpack(self):
        import jax.numpy as jnp

        v = (np.random.default_rng(3).uniform(size=(2, 16, 16, 16, 1)) > 0.7).astype(np.float32)
        packed = packing.pack_voxels_blocked(v, block=4)
        coarse = np.asarray(
            packing.unpack_voxels_blocked(jnp.asarray(packed), (16, 16, 16, 1), block=4)
        )
        # invert the s2d layout on host and compare to the source grid
        b = 4
        x = coarse.reshape(2, 4, 4, 4, b, b, b, 1).transpose(0, 1, 4, 2, 5, 3, 6, 7)
        np.testing.assert_array_equal(x.reshape(v.shape), v)

    def test_env_disable_forces_numpy(self, monkeypatch):
        monkeypatch.setattr(packing, "_PACK_LIB", None)
        monkeypatch.setattr(packing, "_PACK_LIB_TRIED", False)
        monkeypatch.setenv("ANYTIME3D_PACK_LIB", "off")
        assert packing._find_pack_lib() is None
        v = (np.random.default_rng(1).uniform(size=(1, 8, 8, 8, 1)) > 0.5).astype(np.float32)
        np.testing.assert_array_equal(
            packing.pack_voxels_blocked(v, block=2), _numpy_oracle(v, 2)
        )
        monkeypatch.setattr(packing, "_PACK_LIB", None)
        monkeypatch.setattr(packing, "_PACK_LIB_TRIED", False)


def test_indivisible_grid_raises():
    v = np.zeros((1, 6, 8, 8, 1), np.float32)
    with pytest.raises(ValueError):
        packing.pack_voxels_blocked(v, block=4)
