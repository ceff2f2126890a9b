"""One torch thread for a port test module's in-process work.

The port's CPU tests run tiny models, where each torch op is a few
microseconds of work.  With torch's default of one intra-op thread per
core in each of pytest-xdist's workers, the workers' thread pools spin
against each other: six concurrent runs of one reduced train test took
126 s each at the default and 3.9 s each with one thread (the JAX side's
times were the same either way).  Each ``tests/test_torch_*.py`` module
imports :func:`one_torch_thread`, which sets one thread for the module's
tests and restores the count after them.  The ranks of the mesh tests
are single-threaded already (``OMP_NUM_THREADS=1``).
"""
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
