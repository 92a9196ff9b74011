"""What the benchmarks share: the card's rates and the least time of a
piece of work, the kernels' launch counts, the device stamp of a
record, and the result files."""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from gist_tpu_torch.bench.procs import run_child

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
    """Every kernel's launch counter, by kernel: K1-K9 and S1."""
    from gist_tpu_torch.ops import (dedup_spmm, gat_dedup, gat_tiled,
                                    segment_csr, split_spmm, tiled_spmm)
    return {"K1": dedup_spmm.launches, "K2": split_spmm.launches,
            "K3": tiled_spmm.launches, "K4": gat_dedup.launches_fwd,
            "K5": gat_dedup.launches_b1, "K6": gat_dedup.launches_b2,
            "K7": gat_tiled.launches_fwd, "K8": gat_tiled.launches_b1,
            "K9": gat_tiled.launches_b2, "S1": segment_csr.launches}


def reset_launch_counts() -> None:
    """Every kernel's launch counter to 0."""
    from gist_tpu_torch.ops import (dedup_spmm, gat_dedup, gat_tiled,
                                    segment_csr, split_spmm, tiled_spmm)
    dedup_spmm.launches = split_spmm.launches = tiled_spmm.launches = 0
    segment_csr.launches = 0
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
    out = run_child(
        ["nvidia-smi", "-i", uuid if uuid.startswith("GPU-") else
         f"GPU-{uuid}", "--query-gpu=power.limit",
         "--format=csv,noheader,nounits"], 60, capture_output=True,
        text=True, check=True)
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


def graph_digest(senders, receivers, n_nodes: int) -> str:
    """12 hex digits of the SHA-1 of a graph (node count, senders and
    receivers): the part of a layout cache's name that tells graphs
    apart."""
    h = hashlib.sha1(np.int64(n_nodes).tobytes())
    for a in (senders, receivers):
        h.update(np.ascontiguousarray(a, dtype=np.int64).tobytes())
    return h.hexdigest()[:12]


_LAYOUT_ARRAYS = ("pos", "perm", "dir_blk", "rem_blk", "is_dir")


def save_chunked(path: str, dc) -> None:
    """A chunked (or split) layout to ``path`` (``.npz``), written under
    a temporary name and renamed."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, u=dc.u_senders.numpy(), w=dc.w_blocks.numpy(),
             o=dc.job_offsets.numpy(), tn=dc.tile_rows, cu=dc.cu,
             mj=dc.max_jobs, nt=dc.num_tiles,
             **{k: getattr(dc, k).numpy() for k in _LAYOUT_ARRAYS
                if getattr(dc, k) is not None})
    os.replace(tmp, path)


def load_chunked(path: str):
    """The layout :func:`save_chunked` wrote to ``path``."""
    from gist_tpu_torch.graph import ChunkedDedupTiles
    z = np.load(path)
    return ChunkedDedupTiles(
        u_senders=torch.from_numpy(z["u"]), w_blocks=torch.from_numpy(z["w"]),
        job_offsets=torch.from_numpy(z["o"]), tile_rows=int(z["tn"]),
        cu=int(z["cu"]), max_jobs=int(z["mj"]), num_tiles=int(z["nt"]),
        **{k: torch.from_numpy(z[k]) if k in z else None
           for k in _LAYOUT_ARRAYS})


def cached_chunked(path, build):
    """The layout cached at ``path``, else ``build()``'s, saved there
    (``path`` None: built, never cached).  Raises where the build gives
    no layout."""
    if path and os.path.exists(path):
        return load_chunked(path)
    dc = build()
    if dc is None:
        raise RuntimeError(f"the layout for {path or 'this run'} did not "
                           f"build")
    if path:
        save_chunked(path, dc)
    return dc


def chunked_bound(t, x: torch.Tensor, n_out_rows: int):
    """(ms, what binds, bytes, operations) of the least time for K1 or K2
    once per chunk of ``t``: the offsets, each chunk's W and slot arrays
    of its real jobs (K1: CU sender ids a job; K2: three ints a job and
    CU remote ids a remote job), every feature row read once and every
    output row written once, against the useful multiply-adds of W's
    nonzero counts."""
    f, item = x.shape[1], x.element_size()
    nbytes = t.job_offsets.numel() * 4 + x.numel() * item \
        + n_out_rows * f * item
    nnz = 0
    for c, jobs in enumerate(t.job_offsets[:, -1].tolist()):
        nbytes += jobs * t.tile_rows * t.cu
        if t.is_dir is None:
            nbytes += jobs * t.cu * 4
        else:
            rem_jobs = jobs - int(t.is_dir[c, :jobs].sum())
            nbytes += jobs * 12 + rem_jobs * t.cu * 4
        nnz += int(torch.count_nonzero(t.w_blocks[c, :jobs]))
    flops = 2 * nnz * f
    return bound(nbytes, flops, x.dtype) + (nbytes, flops)


def chunked_plain(t, x: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """The chunked runner's plain version (``ops/dedup_spmm.py:
    run_dedup_chunked``): the same permutation, each chunk's plain walk
    (K1's, or K2's on a split layout), the same row map."""
    from gist_tpu_torch.ops.dedup_spmm import dedup_spmm_reference
    from gist_tpu_torch.ops.split_spmm import split_spmm_reference
    xp = x.index_select(0, t.perm) if t.perm is not None else x
    if t.is_dir is None:
        parts = [dedup_spmm_reference(t.job_offsets[c], t.w_blocks[c],
                                      t.u_senders[c], xp)
                 for c in range(t.n_chunks)]
    else:
        parts = [split_spmm_reference(t.job_offsets[c], t.dir_blk[c],
                                      t.rem_blk[c], t.is_dir[c],
                                      t.w_blocks[c], t.u_senders[c], xp)
                 for c in range(t.n_chunks)]
    out = torch.cat(parts)
    return out.index_select(0, t.pos) if t.pos is not None else out[:n_nodes]


def script_main(run) -> int:
    """A script's top: ``run()``'s record printed as one JSON line and
    0; any failure one line with ``"error"`` (the traceback on stderr)
    and 1.  Nothing falls back."""
    import traceback
    try:
        rec = run()
    except Exception as e:  # noqa: BLE001 - the one failure line
        traceback.print_exc()
        print(json.dumps({"error": f"{type(e).__name__}: {e}"[:300]}),
              flush=True)
        return 1
    print(json.dumps(rec), flush=True)
    return 0
