"""Fixtures shared by the port's test files (``tests/test_torch_*.py``).

A file takes one by importing it by name, e.g. ``from _torch_common import
one_thread  # noqa: F401``; pytest then applies the autouse fixture to
every test of that file."""
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The reduced models run thousands of small ops: one torch thread
    keeps them cheap when the suite runs in several processes (set for the
    whole module, its module-scoped fixtures included)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
