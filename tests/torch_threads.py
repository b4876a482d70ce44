"""Torch's intra-op threads in the port's test processes.

The suite runs in six xdist workers on one host (`-n 6 --dist loadfile`),
and torch starts an intra-op pool of a thread a core in each of them: the
workers' pools oversubscribe the cores several times over. With two
threads a worker the twelve heaviest port test files ran in 351–396 s
against 577–594 s with torch's default (six workers on 8 cores). Every
port test file calls :func:`limit_torch_threads` when it is imported, and
every worker imports every file as it collects them, so the limit holds
for the whole run and for one file run alone."""
import torch

#: intra-op threads of a test process
TORCH_TEST_THREADS = 2


def limit_torch_threads() -> None:
    torch.set_num_threads(TORCH_TEST_THREADS)
