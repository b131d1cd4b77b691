"""One CPU thread for PyTorch in the port's test modules.

The port's CPU tests run tiny models whose ops are far too small to gain
from PyTorch's intra-op thread pool, and the test run puts several
workers on one machine: a pool per worker, each as wide as the machine,
oversubscribes the cores and every small op pays for it in wakeups.
Importing ``one_torch_thread`` into a test module (pytest collects
fixtures from module globals) runs that module's tests on one PyTorch
thread and restores the previous count after them.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
