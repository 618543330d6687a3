"""A module-scoped autouse fixture that runs torch at one thread.

A test module takes it with ``from tests.torch_threads import
one_torch_thread  # noqa: F401``.  Under pytest-xdist every worker shares the
host's cores; at torch's default thread count each worker's intra-op pool
spins against the others, and a module of many small ops ran tens of times
slower than alone (5 s alone, 474 s in a six-worker run).
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
