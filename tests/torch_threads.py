"""One intra-op torch thread for a test module of the port.

The plain PyTorch versions of the kernels run thousands of small ops.
Under ``pytest -n 6`` on an 8-core machine each worker's default of one
thread per core leaves the threads of every parallel region waiting on
each other, which slowed those ops 10-100x; one thread per worker does
not.  Import the fixture into a test module to apply it there.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
