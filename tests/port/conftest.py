"""The port's tests run torch on one CPU thread.

The suite runs in several worker processes at once (pytest-xdist), and
each torch op at these small batch sizes is short. With torch's default of
one OpenMP thread per core in every worker, the workers' thread pools
oversubscribe the cores and each op waits for its pool's slowest thread:
`tests/port` under 6 workers on an 8-core host took about 4.5 times the
worker time it takes on one thread per process (CHANGES.md). The
thread count is restored after each test, so nothing else in the process
sees it.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
