"""What the GPU entry points promise, checked without a GPU: they refuse the
CPU backend, the main path imports without flax or orbax, and the compile
cache follows one rule."""

import os
import subprocess
import sys
import textwrap

import jax
import pytest

import bench
import chip_smoke
from anytime3d_tpu.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert "needs an NVIDIA GPU" in str(exc.value)
    assert '"ok"' not in capsys.readouterr().out


def test_bench_refuses_cpu():
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        bench._device_info()


_BLOCKER = """
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("flax", "orbax", "flatbuffers"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, Block())
"""


def _run_blocked(code: str) -> str:
    """Run ``code`` in a fresh CPU process where flax, orbax and flatbuffers
    (none of them on the GPU deployment) cannot be imported."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKER + textwrap.dedent(code)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_main_path_imports_without_flax_or_orbax():
    out = _run_blocked(
        """
        import anytime3d_tpu.cli.train, anytime3d_tpu.cli.train_detector
        import anytime3d_tpu.cli.serve, anytime3d_tpu.serving
        import anytime3d_tpu.train.checkpoint, anytime3d_tpu.train.trainer
        import anytime3d_tpu.models, anytime3d_tpu.data
        assert not any(m.split(".")[0] in ("flax", "orbax") for m in sys.modules)
        print("imported")
        """
    )
    assert "imported" in out


def test_serving_artifact_roundtrip_without_flatbuffers():
    out = _run_blocked(
        """
        import jax, jax.numpy as jnp, numpy as np
        from anytime3d_tpu.models.mmvae import MultiModalVAE
        from anytime3d_tpu.serving import export_infer, load_infer
        from anytime3d_tpu.train import create_train_state
        from tests.test_train import synth_batch, tiny_voxel_cfg

        model = MultiModalVAE(tiny_voxel_cfg(with_prior=True))
        x = synth_batch(n=2)["input"]
        params = create_train_state(model, x, jax.random.PRNGKey(0)).params
        data = export_infer(model, params, (2, 16, 16, 16, 1))
        out = load_infer(data)(x, jnp.ones((2, 8), jnp.float32))
        assert out["pred"].shape == (2, 16, 16, 16, 1)
        assert "flatbuffers" not in sys.modules
        print("served")
        """
    )
    assert "served" in out


@pytest.fixture
def cache_dir_restored():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_wins(monkeypatch, cache_dir_restored, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "from_env"))
    before = jax.config.jax_compilation_cache_dir
    profiling.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "from_env").exists()


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch, cache_dir_restored, tmp_path):
    assert profiling.DEFAULT_CACHE_DIR == os.path.join(ROOT, ".jax_cache")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(profiling, "DEFAULT_CACHE_DIR", str(tmp_path / "cache"))
    profiling.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "cache")
    assert (tmp_path / "cache").is_dir()
