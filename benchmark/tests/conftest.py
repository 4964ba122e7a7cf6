"""CPU tests of the benchmark (``python -m pytest benchmark/tests``); the
``gpu`` cases run only where torch sees a card."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips without one)")


@pytest.fixture(autouse=True)
def _one_thread(tmp_path, monkeypatch):
    """One torch thread per test; the card's route through the batched
    engines; every file the program writes under tmp_path."""
    import torch
    monkeypatch.setenv("DMFT_ED_RAGGED", "1")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
