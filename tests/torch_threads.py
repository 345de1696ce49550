"""One intra-op thread for a port test module (``tests/test_torch_*.py``).

A module that does heavy torch work on the CPU takes the fixture with one
line beside its import::

    from .torch_threads import one_thread  # noqa: F401

    pytestmark = pytest.mark.usefixtures("one_thread")

Two reasons:

* The suite runs several pytest-xdist workers (ROADMAP.md's tier-1
  command runs 6), and torch gives each process an intra-op pool of every
  core, so a machine of few cores is oversubscribed many times over. One
  thread a worker runs most tests faster, E-RAFT's full-width ones about
  ten times so.
* Some CPU kernels sum in an order that depends on the threads' timing,
  so two eager runs of one step differ in the last bits. The tests that
  hold a graphed step or window to an eager one bit for bit need one
  thread.

The fixture is module-scoped, and it restores the thread count the module
found when the module's last test ends.
"""

import pytest
import torch


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
