"""PyTorch's intra-op threads under pytest-xdist.

Every xdist worker imports every test module while it collects, so this
module's import caps each worker's intra-op threads to its share of the
cores (``cpu_count // PYTEST_XDIST_WORKER_COUNT``, at least 1) before any
test runs.  Without the cap every worker starts one OpenMP thread a core,
and their spinning starves the other workers: six concurrent runs of
``tests/test_torch_fold.py::test_folded_plain_bitwise_vs_eager_oracle`` on 8
cores took 486 s each, against 16 s each with one thread a worker and 23 s
for one run alone.  The tests compare elementwise lookups bitwise and
reductions within stated tolerances, so the cap changes no test's contract.
Outside xdist nothing is changed.
"""

import os

import torch


def worker_threads():
    """This process's share of the cores under xdist, or None outside it."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not os.environ.get("PYTEST_XDIST_WORKER") or not workers:
        return None
    return max(1, (os.cpu_count() or 1) // int(workers))


if worker_threads() is not None:
    torch.set_num_threads(worker_threads())


def test_intra_op_threads_are_the_workers_share():
    n = worker_threads()
    if n is None:
        assert torch.get_num_threads() >= 1
    else:
        assert torch.get_num_threads() == n
