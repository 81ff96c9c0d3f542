"""The harness's own tests: ``python -m pytest benchmark/tests`` from the
checkout's root.  They run on the CPU at small sizes; the one marked
``cuda`` runs on a card and skips without one."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device and nvcc; skips without a card")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here: the harness runs its cells on a "
                    "card")
    return torch.device("cuda", 0)
