import os
import sys

# tests must see exactly ONE device (the dry-run sets its own XLA_FLAGS);
# keep any user flags but never inherit a forced device count.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")
