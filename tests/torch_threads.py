"""The CPU-thread budget of the port's tests.

Importing this module sets torch's intra-op pool to ``BUDGET`` threads: the
cores this process may run on, shared evenly between pytest-xdist's workers
(all of them without xdist), or the operator's ``OMP_NUM_THREADS`` where it
is set. Each worker keeping torch's default pool of one thread per core
oversubscribes the cores, and the step-by-step sample loops' tiny ops then
spin against one another. Every xdist worker imports every test module when
it collects, so the budget holds for the whole worker process.

A port test file imports this module beside ``torch``, and starts its
subprocesses with ``subprocess_env``; it sets no thread count of its own.
"""
import os

import torch


def _cores():
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:          # no affinity mask on this platform
        return os.cpu_count()


def _budget():
    given = os.environ.get("OMP_NUM_THREADS")
    if given:
        return int(given)
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, _cores() // workers)


BUDGET = _budget()
torch.set_num_threads(BUDGET)


def subprocess_env(procs=1, **over):
    """``os.environ`` with ``over`` for one of ``procs`` subprocesses that
    run side by side, each given an even share of the budget."""
    share = str(max(1, BUDGET // procs))
    return dict(os.environ, OMP_NUM_THREADS=share, MKL_NUM_THREADS=share,
                **over)
