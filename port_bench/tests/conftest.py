"""The benchmark's own tests: `python -m pytest port_bench/tests -q` from
the checkout's root. Tests marked `card` need a CUDA card and skip without
one (decided inside each test); run them on the card with
`python -m pytest port_bench/tests -q -m card`."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
