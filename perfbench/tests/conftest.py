"""A tiny benchmark beside the real one, for rehearsals on the CPU: the
real ``BENCHMARK.json``'s metrics and traffic mixes, with two cells of
the real drivers on ``synth-tiny``.

Run with ``python -m pytest perfbench/tests -q`` from the repository's
root.  Nothing here needs a card: the harness is driven past its look
for one, on the CPU."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_CONFIGS = {
    "tiny-sage": {"driver": "uw_sequential", "dataset": "synth-tiny",
                  "n_hidden": 16, "n_layers": 2, "dropout": 0.2,
                  "lr": 0.01, "weight_decay": 0.0005, "psize": 8,
                  "batch_size": 2, "iter_per_site": 3, "dtype": "float32"},
    "tiny-gat": {"driver": "ist_cluster", "dataset": "synth-tiny",
                 "n_hidden": 8, "n_layers": 2, "n_heads": 2, "lr": 0.01,
                 "weight_decay": 0.0005, "psize": 8, "batch_size": 2,
                 "iter_per_site": 3, "dtype": "float32"},
}
TINY_CELLS = {"tiny-sage-k1": ("tiny-sage", "ist-k1"),
              "tiny-gat-k2": ("tiny-gat", "ist-k2")}
# the limits of the real cells' kinds of numbers, at this size
TINY_LIMITS = {"partition_faults": 0, "batch_faults": 0,
               "boundary_faults": 0, "dispatch_faults": 0,
               "loss_gap": 1e-4, "grad_gap": 1e-3, "update_gap": 1e-3,
               "merge_faults": 0, "stale_leaves": 0}


def write_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(obj, fh, indent=1)


def make_root(path: str) -> str:
    """A benchmark root at ``path``: the real metrics and traffic, the
    tiny configurations and cells."""
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as fh:
        bench = json.load(fh)
    shutil.copytree(os.path.join(ROOT, "perfbench", "traffic"),
                    os.path.join(path, "perfbench", "traffic"))
    bench["configs"] = []
    for name, cfg in TINY_CONFIGS.items():
        f = f"perfbench/configs/{name}.json"
        write_json(os.path.join(path, f), {"name": name, **cfg})
        bench["configs"].append({"name": name, "source": "synthetic",
                                 "file": f, "reduced": [], "why": "tests"})
    bench["workloads"] = []
    for cell, (config, traffic) in TINY_CELLS.items():
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "tests"})
        write_json(os.path.join(path, "perfbench", "limits", f"{cell}.json"),
                   TINY_LIMITS)
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            m.pop("workloads", None)
    write_json(os.path.join(path, "BENCHMARK.json"), bench)
    return path


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> str:
    return make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture(scope="session")
def tiny_cache(tmp_path_factory) -> str:
    return str(tmp_path_factory.mktemp("cache"))


@pytest.fixture
def cpu():
    return torch.device("cpu")
