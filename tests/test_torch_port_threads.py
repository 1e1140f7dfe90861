"""The port's tests' CPU-thread budget (``tests/torch_threads.py``): the test
process runs it, its xdist workers together fill the cores they may run on
and no more, and a subprocess started with ``subprocess_env`` runs its
share."""
import os
import subprocess
import sys

import pytest
import torch
import torch_threads

GIVEN = os.environ.get("OMP_NUM_THREADS")


def test_test_process_runs_the_budget():
    n = torch_threads.BUDGET
    assert torch.get_num_threads() == n
    if GIVEN:
        assert n == int(GIVEN)
        return
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    cores = len(os.sched_getaffinity(0))
    if workers >= cores:
        assert n == 1
    else:
        assert n * workers <= cores < (n + 1) * workers


@pytest.mark.parametrize("procs", [1, 2])
def test_subprocess_runs_its_share(procs):
    out = subprocess.run(
        [sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
        env=torch_threads.subprocess_env(procs), capture_output=True,
        text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) == max(1, torch_threads.BUDGET // procs)
