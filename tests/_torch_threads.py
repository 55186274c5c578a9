"""One intra-op thread for torch in each test module of the port that
imports `torch_one_thread` (an autouse, module-scoped fixture). The
suite runs its files in several worker processes on the host's cores
(-n 6), and torch's default pool of one thread a core in each of them
oversubscribes the host: a tiny model gains nothing from more threads,
while the workers' spinning pools stall each other (a 25 s lockstep read
305 s in the suite). The ranks that parallel/launch.py spawns run so too
(CPU_THREADS)."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
