"""pytest settings of the benchmark's own tests (``hoardbench/tests``):

    python3 -m pytest -q hoardbench/tests

The ``card`` marker names a test that needs a CUDA card; the ``card``
fixture skips it where there is none, deciding when the test runs."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100")
    return torch.device("cuda")
