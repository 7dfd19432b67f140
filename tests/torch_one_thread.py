"""The port's test files share one autouse fixture: import `one_torch_thread`
into a test module and its tests run with one intra-op torch thread.

The tiny models gain nothing from intra-op threads, and beside the test
runner's other workers their spinning slows every process.

A file with a test whose bound was measured in torch's default summation
order (its own thread count) keeps that test on the default and the rest on
one thread: `name = one_torch_thread_except("test_...")` at module level."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the importing module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def one_torch_thread_except(test_name: str):
    """An autouse fixture that runs each test of the module with one
    intra-op thread, except the test function `test_name`."""

    @pytest.fixture(autouse=True)
    def fixture(request):
        if request.node.originalname == test_name:
            yield
            return
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(n)

    return fixture
