"""Shared set-up of the port's parity tests (``tests/test_torch_*.py``)."""

import subprocess
import time


def load_jax_partitioner():
    """Load the JAX package's C++ partitioner in this process before a
    parity test partitions a graph.  Parallel test workers may build the
    library at the same moment; a worker that sees it half-written
    would fall back to the numpy partitioner and give other parts, so
    wait out a concurrent first build instead."""
    from gist_tpu.partition import native
    for _ in range(40):
        try:
            native._load()
            return
        except (OSError, subprocess.CalledProcessError):
            time.sleep(0.5)
    native._load()
