"""Torch's intra-op thread count for the port's tests under pytest-xdist.

Each xdist worker is a process of its own, and torch starts as many
intra-op threads as the host has cores in every one of them: six workers
on eight cores ran 48 threads, and a BiLSTM training test that takes 6 s
alone took ten minutes.  :func:`cap_threads` gives each worker its share
of the cores, ``os.cpu_count() // PYTEST_XDIST_WORKER_COUNT``, and at
least 2: at one thread the smoke rwkv6's ill-conditioned gradient
(``tests/test_torch_training.py``, whose rwkv6 gradient moves by 1.1e-4
of a leaf under a 1e-7 perturbation) sums in an order that lands 2.0e-4
of its embedding leaf from JAX's, past that test's 1e-4, where 2, 4 and
8 threads stay within it.  Outside an xdist worker it changes nothing.
The port's test modules call it once, when they are imported.
"""

import os

import torch


def cap_threads() -> None:
    """Cap torch's intra-op threads at this xdist worker's share of the
    cores, at least 2; a no-op outside pytest-xdist."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return
    torch.set_num_threads(max(2, (os.cpu_count() or 1) // int(workers)))
