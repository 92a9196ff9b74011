"""Checkpoints of the IST trainers (``gist_tpu/train/checkpoint.py``).

A checkpoint is one ``round_<k>`` directory holding one file,
``state.pt``: a ``torch.save`` of a dict of CPU tensors, Python ints,
floats and strings (the full-width params, the round counter and the
states of the trainer's ``torch.Generator`` objects), so that a resumed
run samples the same partitions and dropout masks it would have sampled
uninterrupted.  It loads with ``torch.load(..., weights_only=True)``,
which refuses numpy arrays and arbitrary objects: numpy leaves are
saved as tensors, and the trainers turn them back into numpy.

Every write is atomic: the file goes to a temporary name and is moved
into place with ``os.replace``; a new round directory is filled under a
temporary name (``round_<k>.tmp<pid>``, which :func:`latest_round_dir`
skips) and then renamed.  A run cut mid-save leaves the previous round
whole.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import numpy as np
import torch

STATE_FILE = "state.pt"


def _to_saveable(tree):
    if isinstance(tree, dict):
        return {k: _to_saveable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_saveable(v) for v in tree]
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree))
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, np.generic):
        return tree.item()
    return tree


def save_checkpoint(path: str, state: dict) -> None:
    """Write ``state`` (a tree of dicts and lists over tensors, numpy
    arrays, ints, floats and strings) as the checkpoint directory
    ``path``, replacing one that is there."""
    path = os.path.abspath(path)
    data = _to_saveable(state)
    if os.path.isdir(path):
        target = os.path.join(path, STATE_FILE)
        torch.save(data, target + ".tmp")
        os.replace(target + ".tmp", target)
        return
    tmp_dir = f"{path}.tmp{os.getpid()}"
    shutil.rmtree(tmp_dir, ignore_errors=True)
    os.makedirs(tmp_dir)
    torch.save(data, os.path.join(tmp_dir, STATE_FILE))
    os.replace(tmp_dir, path)


def load_checkpoint(path: str) -> dict:
    """Read the checkpoint directory ``path`` (or its ``state.pt``);
    array leaves come back as CPU tensors."""
    if os.path.isdir(path):
        path = os.path.join(path, STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=True)


def latest_round_dir(root: str) -> Optional[str]:
    """Find the newest ``round_<k>`` checkpoint directory under root."""
    if not os.path.isdir(root):
        return None
    rounds = []
    for name in os.listdir(root):
        if name.startswith("round_"):
            try:
                rounds.append((int(name.split("_")[1]), name))
            except ValueError:
                pass
    if not rounds:
        return None
    return os.path.join(root, max(rounds)[1])


def generator_state(gen: torch.Generator) -> dict:
    """A generator's state with the type of device it draws on: the
    state of a CUDA generator restores only into a CUDA generator."""
    return {"device": gen.device.type, "state": gen.get_state()}


def restore_generator(gen: torch.Generator, saved: dict) -> None:
    """Set ``gen`` to a state from :func:`generator_state`; raises when
    it was saved from a generator on another type of device (there is
    no silent fall back to a fresh seed)."""
    if saved["device"] != gen.device.type:
        raise ValueError(
            f"the checkpoint holds the state of a {saved['device']!r} "
            f"generator, which cannot continue on a {gen.device.type!r} "
            f"generator: resume on the device type the run was saved from")
    gen.set_state(saved["state"])


def params_to_host(params: dict) -> dict:
    """A checkpoint's parameter tree as writable float32 numpy arrays."""
    return {"layers": [
        {k: np.array(v.numpy(), dtype=np.float32, copy=True)
         for k, v in layer.items()} for layer in params["layers"]]}
