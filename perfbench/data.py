"""A cell's data: the graph and its cluster partition, made once at seed 0
and cached under the benchmark's cache directory.

The graph comes from the benchmark's own generator
(:mod:`perfbench.reference.graphgen`), one ``.npy`` file an array, written
under a temporary name and renamed.  The partition is the program's own
(``gist_tpu_torch.partition.get_partition_list`` over the train-induced
subgraph, the call ``ClusterSampler`` makes), drawn at seed 0 into the
file that ``ClusterSampler`` then loads whatever the run's seed: so the
run's seed draws the cluster order, never a new partition.
"""

from __future__ import annotations

import os

import numpy as np

from perfbench.reference import graphgen

_ARRAYS = ("senders", "receivers", "features", "labels", "train_mask",
           "val_mask", "test_mask")


def graph_arrays(name: str, cache_dir: str) -> dict:
    """The arrays of synthetic graph ``name`` (seed 0), generated and
    cached at the first call in ``cache_dir``."""
    d = os.path.join(cache_dir, f"graph-{name}")
    paths = {k: os.path.join(d, f"{k}.npy") for k in _ARRAYS}
    if all(os.path.exists(p) for p in paths.values()):
        out = {k: np.load(p) for k, p in paths.items()}
        out["n_classes"] = graphgen.SYNTH_SPECS[name][3]
        return out
    arrays = graphgen.generate(name, seed=0)
    os.makedirs(d, exist_ok=True)
    for k, p in paths.items():
        tmp = f"{p}.tmp.npy"
        np.save(tmp, arrays[k])
        os.replace(tmp, p)
    return arrays


def dataset(name: str, arrays: dict):
    """The program's ``Dataset`` over ``arrays``."""
    from gist_tpu_torch.data.container import Dataset
    return Dataset(name=name, senders=arrays["senders"],
                   receivers=arrays["receivers"],
                   features=arrays["features"], labels=arrays["labels"],
                   train_mask=arrays["train_mask"],
                   val_mask=arrays["val_mask"],
                   test_mask=arrays["test_mask"],
                   n_classes=arrays["n_classes"])


def partition_path(name: str, psize: int, cache_dir: str) -> str:
    """The file ``get_partition_list`` caches ``name``'s partition in."""
    return os.path.join(cache_dir, f"{name}_{psize}_refined.npy")


def ensure_partition(name: str, arrays: dict, psize: int,
                     cache_dir: str) -> str:
    """Partition the train-induced subgraph into ``psize`` clusters at
    seed 0 by the program's partitioner, unless the file exists; returns
    its path."""
    path = partition_path(name, psize, cache_dir)
    if not os.path.exists(path):
        from gist_tpu_torch.graph import subgraph
        from gist_tpu_torch.partition import get_partition_list
        train_nid = np.nonzero(arrays["train_mask"])[0]
        s, r, _ = subgraph(arrays["senders"], arrays["receivers"],
                           train_nid, len(arrays["train_mask"]))
        get_partition_list(s, r, len(train_nid), psize,
                           cache_dir=cache_dir, name=name, seed=0)
    return path


def load_partition(path: str) -> list:
    """The cluster list in ``path`` (int64 arrays of train-local ids)."""
    return list(np.load(path, allow_pickle=True))
