"""One intra-op torch thread while a test module of the port runs (each
imports ``one_torch_thread``): their many small eager ops under parallel
test workers, each holding a full thread pool, oversubscribe the cores
(measured ~10x slower under six workers)."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
