"""Thread limits for the port's CPU parity tests.

The suite runs in several worker processes on a few cores. numpy's
OpenBLAS and PyTorch each start a thread per core in every worker, and the
analytic towers' QR decompositions then spin against each other (one
fixture took minutes inside the full suite against ten seconds alone).
One BLAS thread costs these tests nothing when they run alone. Import the
fixture into a test module to apply it there."""
import pytest
import torch
from threadpoolctl import threadpool_limits


@pytest.fixture(autouse=True, scope='module')
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)
