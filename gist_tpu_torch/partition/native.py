"""ctypes binding for the C++ partitioner (libgistpart.so in this
directory, built from partition.cpp by ``make`` on first use).

Callers fall back to the numpy implementation when the library cannot
be built or loaded (see gist_tpu_torch/partition/__init__.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_HERE, "libgistpart.so")
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        # build under a private name, then rename: concurrent first uses
        # (parallel test workers) never load a half-written library
        tmp = f"libgistpart.{os.getpid()}.tmp.so"
        subprocess.run(["make", "-C", _HERE, "-s", f"LIB={tmp}"],
                       check=True, capture_output=True)
        os.replace(os.path.join(_HERE, tmp), _LIB_PATH)
    lib = ctypes.CDLL(_LIB_PATH)
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.greedy_partition.argtypes = [
        i64p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, i64p]
    lib.greedy_partition.restype = None
    lib.refined_partition.argtypes = [
        i64p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, i64p]
    lib.refined_partition.restype = None
    _lib = lib
    return lib


def _assignment_to_parts(assignment: np.ndarray, psize: int):
    order = np.argsort(assignment, kind="stable")
    sorted_assign = assignment[order]
    starts = np.searchsorted(sorted_assign, np.arange(psize))
    ends = np.searchsorted(sorted_assign, np.arange(psize), side="right")
    return [order[a:b].copy() for a, b in zip(starts, ends)]


def _run(fn_name, senders, receivers, n_nodes, psize, seed):
    from gist_tpu_torch.partition.greedy import build_csr
    lib = _load()
    indptr, nbrs = build_csr(senders, receivers, n_nodes)
    assignment = np.empty(n_nodes, dtype=np.int64)
    getattr(lib, fn_name)(np.ascontiguousarray(indptr),
                          np.ascontiguousarray(nbrs),
                          n_nodes, psize, seed, assignment)
    return _assignment_to_parts(assignment, psize)


def native_refined_partition(senders, receivers, n_nodes, psize, seed=0):
    """Multilevel k-way partition (HEM coarsening + boundary refinement);
    see partition.cpp:refined_partition."""
    return _run("refined_partition", senders, receivers, n_nodes, psize,
                seed)


def native_partition(senders, receivers, n_nodes, psize, seed=0):
    """Single-level BFS graph growing (partition.cpp:greedy_partition)."""
    return _run("greedy_partition", senders, receivers, n_nodes, psize,
                seed)
