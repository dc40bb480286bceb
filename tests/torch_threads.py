"""One torch thread for the port's CPU tests.

The suite runs under ``pytest -n 6``: six worker processes, each with
torch's default pool of one intra-op thread per core, put six times as many
threads as there are cores on the tests' many small operations (reduced
widths, plain versions of the kernels), and a case then runs tens of times
slower than on one thread.  Every ``tests/test_torch_*.py`` calls
:func:`one_thread` when it is imported, and starts its child processes with
:data:`ONE_THREAD_ENV` in their environment.
"""

import torch

#: a child process's environment entries for the same one thread (torch
#: reads ``OMP_NUM_THREADS`` when it starts)
ONE_THREAD_ENV = {"OMP_NUM_THREADS": "1"}


def one_thread() -> None:
    """Run this process's torch operations on one intra-op thread."""
    torch.set_num_threads(1)
