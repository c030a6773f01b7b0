"""pytest settings of the benchmark's own tests (npp_bench/tests/): the
`cuda` marker for tests that need a card (each skips inside itself
without one). Run them from the repository root:
`python -m pytest npp_bench/tests -q`."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: needs a CUDA card; skips inside the test without '
        'one (on the card: `python -m pytest -m cuda npp_bench/tests`)')
