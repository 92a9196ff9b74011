"""What the benchmarks share: the card's rates and the least time of a
piece of work, the kernels' launch counts, the device stamp of a
record, and the result files."""

from __future__ import annotations

import json
import os
import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12                    # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def bound(nbytes, flops, dtype):
    """(ms, what binds) of the least time for ``nbytes`` of traffic and
    ``flops`` operations at the peak rate of ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k1_bound(layout, x, n_out_rows):
    """K1's least time on these inputs, as (ms, what binds, bytes,
    operations): every input byte read once and output byte written
    once (real jobs only), against the useful multiply-adds of W's
    nonzero counts."""
    jobs = int(layout.job_offsets[-1])
    f, item = x.shape[1], x.element_size()
    nbytes = (jobs * layout.tile_rows * layout.cu        # W counts, int8
              + jobs * layout.cu * 4                     # u_senders
              + layout.job_offsets.numel() * 4
              + x.numel() * item + n_out_rows * f * item)
    nnz = int(torch.count_nonzero(layout.w_blocks[:jobs]))
    flops = 2 * nnz * f
    return bound(nbytes, flops, x.dtype) + (nbytes, flops)


def launch_counts() -> dict:
    """Every kernel's launch counter, by kernel: K1-K9."""
    from gist_tpu_torch.ops import (dedup_spmm, gat_dedup, gat_tiled,
                                    split_spmm, tiled_spmm)
    return {"K1": dedup_spmm.launches, "K2": split_spmm.launches,
            "K3": tiled_spmm.launches, "K4": gat_dedup.launches_fwd,
            "K5": gat_dedup.launches_b1, "K6": gat_dedup.launches_b2,
            "K7": gat_tiled.launches_fwd, "K8": gat_tiled.launches_b1,
            "K9": gat_tiled.launches_b2}


def reset_launch_counts() -> None:
    """Every kernel's launch counter to 0."""
    from gist_tpu_torch.ops import (dedup_spmm, gat_dedup, gat_tiled,
                                    split_spmm, tiled_spmm)
    dedup_spmm.launches = split_spmm.launches = tiled_spmm.launches = 0
    gat_dedup.reset_launches()
    gat_tiled.reset_launches()


def launches_since(before: dict) -> dict:
    """The launches since ``before`` (a :func:`launch_counts`), of the
    kernels that launched."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def hardware(device) -> dict:
    """``hardware`` (the card's name, or ``cpu``) and ``power_limit_w``
    (the card's power limit from ``nvidia-smi``, None on the CPU).  The
    card is named to ``nvidia-smi`` by its UUID: its index there is the
    physical one, which ``CUDA_VISIBLE_DEVICES`` may renumber."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"hardware": "cpu", "power_limit_w": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    uuid = str(torch.cuda.get_device_properties(index).uuid)
    out = subprocess.run(
        ["nvidia-smi", "-i", uuid if uuid.startswith("GPU-") else
         f"GPU-{uuid}", "--query-gpu=power.limit",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return {"hardware": torch.cuda.get_device_name(index),
            "power_limit_w": float(out.stdout.strip())}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest absolute difference over the largest magnitude of
    ``want``."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()
                 / want.abs().max().clamp(min=1e-30))


def results_path(name: str) -> str:
    """A script's default output file: ``results/torch_<name>.json``,
    beside (never over) the JAX package's records."""
    return os.path.join("results", f"torch_{name}.json")


def write_json(path: str, obj) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)
