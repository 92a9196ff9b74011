"""Experiment orchestration (``gist_tpu/sweeps``): a sweep is a plain
in-process grid over the port's trainers returning result dicts, with
JSON-lines persistence and resume by key.
"""

from gist_tpu_torch.sweeps.runner import SweepRunner, grid
