"""Settings for the benchmark's own tests (``python -m pytest benchmark/tests``).

They are not part of the repo's ``tests/`` suite.  A test that needs the
card carries the ``cuda`` marker and decides inside a fixture whether a
card is here.
"""

import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here: this test runs on the card")
    return torch.cuda.get_device_name(0)


@pytest.fixture
def repo_root():
    return ROOT


@pytest.fixture(autouse=True)
def _tmpdir_env(tmp_path, monkeypatch):
    """Each test's temporary files under pytest's own directory."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    os.makedirs(tmp_path, exist_ok=True)
