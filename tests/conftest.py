"""Test configuration: run everything on a virtual 8-device CPU mesh.

The platform is forced through ``jax.config`` as well as the environment,
so that an accelerator on the machine is never picked up; the 8 virtual CPU
devices exercise the mesh and sharding paths (SURVEY.md §4d). Tests compile
without a persistent cache: an empty ``JAX_COMPILATION_CACHE_DIR`` turns it
off, and ``utils.profiling.enable_compilation_cache`` then sets none.

The ``chip`` marker is registered for tests that need the GPU; none does
yet. The card is checked end to end by ``python chip_smoke.py``.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

assert jax.default_backend() == "cpu", jax.default_backend()
assert jax.device_count() >= 8, jax.devices()


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA GPU; skips on the CPU")

