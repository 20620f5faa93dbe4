"""One intra-op thread for the port's CPU tests.

The suite runs several pytest workers at once (``-n 6``).  Each worker's
torch would start a thread a core, and their idle threads spin against
each other's; the tests' shapes are tiny, so one thread a worker loses
nothing.  A test module takes the fixture by importing it (``from
torch_threads import one_thread``): autouse and module-scoped, it runs
before the module's other fixtures and tests."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
