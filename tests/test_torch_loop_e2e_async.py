"""The revisit sweep of tests/test_torch_loop_e2e.py in the default mode:
mapping worker, loop worker and the global BA on its own thread (~60 s on
one CPU thread; a file of its own so that the test workers split the two
runs)."""

import pytest
import torch

from test_torch_loop_e2e import revisit_run


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_revisit_closes_a_loop_and_relocalizes_async():
    revisit_run("async")
