"""Datasets: container, on-disk loaders and the deterministic synthetic
generators (``gist_tpu/data``).  ``load_dataset`` serves the
``synth-*`` names and, from files under ``root``, planetoid, reddit,
ppi and amazon2m (:mod:`gist_tpu_torch.data.loaders`).
"""

from gist_tpu_torch.data.container import Dataset
from gist_tpu_torch.data.loaders import load_dataset
from gist_tpu_torch.data.synthetic import SYNTH_SPECS, synthetic_dataset
