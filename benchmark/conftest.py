"""pytest settings of the benchmark's own tests (``python -m pytest
benchmark/tests``).  ``card``: a test that needs an NVIDIA card; it skips
here, deciding in a fixture, never at import."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device")
