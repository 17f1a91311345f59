"""An autouse fixture for the port's CPU tests: one torch thread.

The tests run the kernels' plain torch versions, which are loops of small
gathers and selects over ``[S]`` vectors.  On several threads, competing
with the other test workers for the cores, these run many times slower than
on one.  A test file imports ``one_torch_thread`` to use it.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
