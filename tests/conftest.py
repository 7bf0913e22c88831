"""Test configuration: force the CPU backend with 8 virtual devices so the
multi-device sharding paths are exercised without accelerator hardware,
and enable x64 for reference-precision (complex128) numerics."""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
# no persistent compile cache for the CPU test runs: caching CPU AOT
# executables buys nothing here and their feature-string mismatch makes
# every later load log loud (harmless) cpu_aot_loader errors
os.environ.setdefault("WAE_COMPILE_CACHE", "0")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
# force the CPU backend (with the 8 virtual devices from XLA_FLAGS) even
# where JAX would pick up a GPU
jax.config.update("jax_platforms", "cpu")
assert jax.default_backend() == "cpu"
assert len(jax.devices()) == 8, jax.devices()
