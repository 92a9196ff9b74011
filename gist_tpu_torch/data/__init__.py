"""Datasets: container and the deterministic synthetic generators.

Only the ``synth-*`` names are served here; the on-disk loaders of the
JAX package (planetoid, reddit, amazon2m, ppi) wait for a later slice.
"""

from gist_tpu_torch.data.container import Dataset
from gist_tpu_torch.data.synthetic import SYNTH_SPECS, synthetic_dataset


def load_dataset(name: str, *, self_loop: bool = False,
                 seed: int = 0) -> Dataset:
    """``synth-*`` names only (``gist_tpu.data.loaders.load_dataset``'s
    first branch); ``self_loop`` replaces the graph's self loops with
    one per node, as the GCN baseline loads its graph."""
    if name not in SYNTH_SPECS:
        raise KeyError(f"unknown dataset {name!r}: the port loads only "
                       f"synthetic datasets {sorted(SYNTH_SPECS)}")
    ds = synthetic_dataset(name, seed=seed)
    if self_loop:
        from gist_tpu_torch.graph import add_self_loops
        ds.senders, ds.receivers = add_self_loops(ds.senders, ds.receivers,
                                                  ds.n_nodes)
    return ds
