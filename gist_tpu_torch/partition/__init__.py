"""Graph clustering for Cluster-GCN mini-batching and the dedup
layout's locality order.

* :mod:`gist_tpu_torch.partition.native` — the multilevel C++
  partitioner (ctypes-loaded, built by ``make`` on first use);
* :mod:`gist_tpu_torch.partition.greedy` — the numpy BFS graph-growing
  partitioner and boundary refinement, used when the library cannot be
  built.

Partition lists may be cached to ``<cache_dir>/<name>_<psize>_<method>.npy``
with an atomic rename, so concurrent processes never read a partial file.
"""

import os
import tempfile

import numpy as np

from gist_tpu_torch.partition.greedy import greedy_partition


def get_partition_list(senders, receivers, n_nodes, psize,
                       cache_dir=None, name=None, seed=0, method="refined"):
    """Split nodes into ``psize`` clusters; returns a list of int64 arrays.

    ``method="refined"`` (default) is the multilevel C++ partitioner
    (HEM coarsening + k-way boundary refinement, partition.cpp);
    ``"bfs"`` is single-level BFS graph growing.
    """
    if cache_dir and name:
        path = os.path.join(cache_dir, f"{name}_{psize}_{method}.npy")
        if os.path.exists(path):
            return list(np.load(path, allow_pickle=True))
    parts = _partition(senders, receivers, n_nodes, psize, seed, method)
    if cache_dir and name:
        os.makedirs(cache_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".npy")
        os.close(fd)
        np.save(tmp, np.asarray(parts, dtype=object), allow_pickle=True)
        os.replace(tmp, path)
    return parts


def _partition(senders, receivers, n_nodes, psize, seed, method="refined"):
    try:
        from gist_tpu_torch.partition.native import (native_partition,
                                                     native_refined_partition)
        if method == "refined":
            return native_refined_partition(senders, receivers, n_nodes,
                                            psize, seed)
        return native_partition(senders, receivers, n_nodes, psize, seed)
    except (ImportError, OSError):
        parts = greedy_partition(senders, receivers, n_nodes, psize, seed)
        if method == "refined":
            from gist_tpu_torch.partition.greedy import refine_partition
            parts = refine_partition(senders, receivers, n_nodes, parts)
        return parts
