import os
import sys

# Make `import repro` work without installation.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# Tests and benches must see exactly ONE device; only launch/dryrun.py sets
# the 512-device XLA flag (and does so before any jax import).
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA CUDA card; skips where there is none")
