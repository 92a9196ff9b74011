"""Shared CLI plumbing (``gist_tpu/cli/common.py``).

The flags are the JAX package's, with one change: ``--cpu-mesh`` (a
virtual JAX device mesh) has no torch meaning, and ``--device`` (default
``cuda``) takes its place.  ``--spmm-backend pallas`` selects the port's
kernel route, the ``dedup`` backend of :mod:`gist_tpu_torch.ops.spmm`.
"""

from __future__ import annotations

import argparse

import torch

# the JAX package's backend names -> the port's
_BACKENDS = {"auto": "auto", "segment": "segment", "pallas": "dedup"}


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dataset", type=str, default="synth-cora")
    p.add_argument("--data-root", type=str, default="./data",
                   help="directory of the on-disk datasets (planetoid, "
                        "reddit, ppi, amazon2m)")
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--n-epochs", type=int, default=200)
    p.add_argument("--n-hidden", type=int, default=16)
    p.add_argument("--n-layers", type=int, default=1)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--rnd-seed", type=int, default=3)
    p.add_argument("--use-layernorm", type=str, default="True",
                   choices=["True", "False"])
    p.add_argument("--result-json", type=str, default=None,
                   help="write the result dict to this path as JSON")
    p.add_argument("--spmm-backend", type=str, default="auto",
                   choices=sorted(_BACKENDS),
                   help="aggregation kernel; auto = the CUDA kernels for "
                        "a graph on the card that carries a layout, else "
                        "the segment path; pallas = the kernels always")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on; 'cpu' runs every kernel's "
                        "plain PyTorch version")


def apply_backend(args) -> torch.device:
    """Set the aggregation backend and return the run's device; raises
    when the device is ``cuda`` and there is no card."""
    from gist_tpu_torch.ops.spmm import set_default_backend
    from gist_tpu_torch.utils import resolve_device
    device = resolve_device(args.device)
    set_default_backend(_BACKENDS[args.spmm_backend])
    return device


def str2bool(v: str) -> bool:
    # booleans come as 'True'/'False' strings; accept those plus the
    # argparse-native spellings
    return str(v).lower() in ("true", "1", "yes")
