"""A module fixture for the port's CPU test files: their reduced models'
ops are tiny, and torch's default of one intra-op thread per core makes
the test workers' threads spin against each other (a serve of 0.07 s
alone took ~10 s under six workers). Import it into a test module
(``from _torch_threads import one_torch_thread``) to run that module on
one intra-op thread, restored after."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
