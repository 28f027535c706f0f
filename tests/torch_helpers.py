"""What the port's tests (tests/test_torch_*.py) share.

Each of them imports ``one_torch_thread`` into its namespace, where the
autouse fixture applies to every test of the module.
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread: the test workers share the CPUs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Lazy:
    """A value known only as a sum of ``k`` resting values: what the
    int64 bound of a plain field (ops/field.py, ops/field16.py) needs of
    each product operand."""

    def __init__(self, k):
        self.k = k

    def __add__(self, other):
        return Lazy(self.k + other.k)

    __sub__ = __add__

    def __neg__(self):
        return self
