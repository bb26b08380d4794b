"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the repo's root.  Tests marked ``cuda`` need a card and skip without
one (decided when the test runs)."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (os.path.dirname(BENCH), BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU; skips where there is none")
