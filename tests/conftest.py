import os
import sys

# Smoke tests and benches see the single real CPU device; only the dry-run
# entry point forces 512 host devices (per assignment).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    # tests that shell out to a fresh python (multi-device dry runs):
    # historically environment-sensitive (backend probing, device-count
    # env vars) — deselect with `-m "not subprocess"` on minimal hosts
    config.addinivalue_line(
        "markers",
        "subprocess: spawns a fresh python with its own jax backend "
        "(deselect with -m 'not subprocess')")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the port's kernels); skips without one")
