"""The port's CPU tests on one intra-op thread.

The suite runs in parallel workers (``pytest -n 6`` on 8 cores), and each
worker's torch would otherwise start a thread pool as wide as the machine:
six of them, beside XLA's own pools, oversubscribe the cores, and torch's
idle threads spin while they wait for work, which slows every file in
every worker (the port's files took 5,851 s of worker time so, 2,029 on
one thread).  A port test file imports :func:`one_torch_thread`; as an
autouse module fixture it runs the module on one thread and restores the
count after it.

oneDNN's fp32 convs sum in an order that follows the thread count.  A
test whose claim rests on the bits of the default count (an fp32 conv
equal to XLA's, not within a bound) asks for :func:`all_torch_threads`.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module on one thread; yields the count it found."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield threads
    torch.set_num_threads(threads)


@pytest.fixture
def all_torch_threads(one_torch_thread):
    """One test on the thread count the module found."""
    torch.set_num_threads(one_torch_thread)
    yield
    torch.set_num_threads(1)
