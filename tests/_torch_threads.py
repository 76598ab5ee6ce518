"""One torch thread for a test module's in-process work.

The port's tests run small tensors, and a pytest run with several
workers (``-n``) puts them side by side, each with its own intra-op
pool: there a pool of as many threads as cores costs more CPU than it
saves (``tests/test_torch_moe.py`` alone on an 8-core host: 161 s of CPU
with one thread against 187 with eight, in about the same wall time). A
module imports
:func:`one_torch_thread` to use it; the rank processes the tests start
get ``OMP_NUM_THREADS=1`` instead.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
