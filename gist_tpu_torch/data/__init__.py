"""Datasets: container and the deterministic synthetic generators.

Only the ``synth-*`` names are served here; the on-disk loaders of the
JAX package (planetoid, reddit, amazon2m, ppi) wait for a later slice.
"""

from gist_tpu_torch.data.container import Dataset
from gist_tpu_torch.data.synthetic import SYNTH_SPECS, synthetic_dataset


def load_dataset(name: str, *, seed: int = 0) -> Dataset:
    """``synth-*`` names only (``gist_tpu.data.loaders.load_dataset``'s
    first branch)."""
    if name not in SYNTH_SPECS:
        raise KeyError(f"unknown dataset {name!r}: the port loads only "
                       f"synthetic datasets {sorted(SYNTH_SPECS)}")
    return synthetic_dataset(name, seed=seed)
