import pytest


@pytest.fixture
def cuda_card():
    """Skip unless an NVIDIA card is present (decided here, never at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the benchmark measures the port on it")
