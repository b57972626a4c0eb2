"""A module-scoped autouse fixture that runs a test file's torch on one
thread.  Import it into a test module to apply it there:

    from _torch_threads import torch_one_thread  # noqa: F401

The port's CPU twins work on small tensors, and OpenMP threads spinning
beside the other test workers made such files many times slower than their
single-process time.  Not a test module: nothing here is collected.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
