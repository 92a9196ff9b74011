"""Shared set-up of the port's parity tests (``tests/test_torch_*.py``)."""

import subprocess
import time

import torch

# A multithreaded torch.exp was seen to return up to 7e-5 wrong values
# on its first call in a process (PyTorch 2.13 CPU build, AVX-512 host;
# later calls on the same input were exact).  The first call of the
# port's plain GAT walks then missed the JAX composite at rtol 1e-4 in
# about one process in five.  Make that first call here, at collection
# time, in every process that imports the port's parity tests.
torch.exp(torch.full((128, 1024), -5.0))


def run_interpret(fn):
    """Run ``fn`` with the Pallas kernels in interpret mode and wait for
    all its work, callbacks included, before any torch computation: one
    started while the interpreter still ran was seen to read corrupted
    values.  ``fn`` runs as one jitted call, so this thread dispatches
    nothing while the interpreter's callbacks dispatch their own ops
    (two dispatchers at once can deadlock).  Returns numpy arrays."""
    import jax
    import numpy as np
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        out = jax.block_until_ready(jax.jit(fn)())
    jax.effects_barrier()
    return jax.tree.map(np.asarray, out)


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
