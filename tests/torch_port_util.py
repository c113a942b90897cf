"""Shared helpers of the tests of the PyTorch port (tests/test_torch_*.py)."""

import pytest
import torch

# The suite runs several test processes on one host; torch's default of one
# intra-op thread per core would oversubscribe it and disturb the suite's
# timing-based tests. The port's tests use small shapes.
torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.fixture
def cuda_device():
    """The first card; the test skips where there is none. Decided when the
    test runs, never at import, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")
