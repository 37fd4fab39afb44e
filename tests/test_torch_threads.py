"""One CPU thread for torch and numpy's BLAS in each test process of
the port's files.

The suite runs in several processes at once (pytest-xdist, six workers
on the machine's cores), and in each process torch and numpy's BLAS
take a thread per core by default; the port's CPU twins and the numpy
around them then run on many times as many threads as cores, whose
idle threads spin on one another's cores.  Each port test file takes
``one_torch_thread`` (``from test_torch_threads import
one_torch_thread``): its tests run torch and the BLAS libraries loaded
in the process (``threadpoolctl``, where it is installed) on one thread,
and the counts in force before come back after the file.  One thread
changes only the order in which a product's f32 sums are split across
threads, which every comparison of the port against anerf_tpu is held to
within its bars.  A test that holds two f32 evaluations closer than
that order allows (``test_torch_net_shapes.py``'s padded packs, at 1e-6
of the scale) takes ``torch_threads_as_before`` too: torch's count in
force before the file, for that test alone.
"""
import contextlib

import pytest
import torch

try:
    from threadpoolctl import threadpool_limits
except ImportError:   # then torch's threads alone
    threadpool_limits = None


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One thread for the file's tests; yields torch's count before."""
    before = torch.get_num_threads()
    limits = (threadpool_limits(limits=1, user_api='blas')
              if threadpool_limits else contextlib.nullcontext())
    with limits:
        torch.set_num_threads(1)
        yield before
        torch.set_num_threads(before)


@pytest.fixture
def torch_threads_as_before(one_torch_thread):
    torch.set_num_threads(one_torch_thread)
    yield
    torch.set_num_threads(1)


def test_this_file_runs_on_one_thread():
    assert torch.get_num_threads() == 1


def test_the_count_comes_back():
    """The fixture's teardown restores the count it found."""
    gen = one_torch_thread.__wrapped__()
    before = torch.get_num_threads()
    torch.set_num_threads(3)
    assert next(gen) == 3
    assert torch.get_num_threads() == 1
    with pytest.raises(StopIteration):
        next(gen)
    assert torch.get_num_threads() == 3
    torch.set_num_threads(before)


def test_a_test_can_take_the_count_before(one_torch_thread,
                                          torch_threads_as_before):
    assert torch.get_num_threads() == one_torch_thread
