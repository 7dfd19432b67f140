"""The port's test files share one autouse fixture: import `one_torch_thread`
into a test module and its tests run with one intra-op torch thread.

The tiny models gain nothing from intra-op threads, and beside the test
runner's other workers their spinning slows every process."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the importing module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
