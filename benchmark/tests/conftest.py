"""The benchmark's tests: the repository's root on the path, and the
``card`` marker for tests that need a CUDA card (they skip without one,
deciding inside the test)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
