"""K3: the v1 gather-layout SpMM as a hand-written CUDA kernel, with its
plain PyTorch version.

Counterpart of the v1 branch of ``gist_tpu/ops/pallas_spmm.py``
(``_reduce_kernel``, ``_spmm_tiled``, ``_run_tiled``): ``out[r]`` sums
``x[senders[e]]`` over the slots e of r's tile whose receiver is r.  The
kernel source is ``gist_tpu_torch/csrc/tiled_spmm.cu`` (its row walk in
``csrc/tiled_rows.cuh``); it is compiled by ``nvcc`` for ``sm_90a`` into
``gist_tpu_torch/_build/`` at first use and loaded with ctypes, as K1 is.

:func:`tiled_spmm` launches the kernel for a CUDA tensor and runs
:func:`tiled_spmm_reference` (the TPU kernel's walk over tiles and
chunk-slot blocks, in plain PyTorch) for a CPU tensor; it never falls
back from one to the other.  ``launches`` counts the kernel launches.
The gradient (forward on ``tiled``, backward on ``tiled_t``) is
:func:`gist_tpu_torch.ops.dedup_spmm.spmm_dedup`'s.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch

from gist_tpu_torch.graph import TiledCSR
from gist_tpu_torch.ops import dedup_spmm

SOURCE = os.path.join(os.path.dirname(dedup_spmm.SOURCE), "tiled_spmm.cu")

launches = 0
_lib = None

# the kernel's instances (csrc/tiled_spmm.cu): lanes per group, and at
# most MAX_ACC fp32 accumulators a lane (per_lane * vec)
GROUPS = (16, 8)
MAX_ACC = 8


class Plan(NamedTuple):
    """A K3 launch plan: the lanes of a warp in groups of ``group``, each
    lane holding ``per_lane`` vectors of ``vec`` elements of a row, so a
    group covers ``span`` columns of one block column.  ``rows``: each
    group owns a destination row (32 / group rows a warp); otherwise one
    warp owns a row and its groups take successive slots of it."""
    rows: bool
    group: int
    per_lane: int
    vec: int

    @property
    def span(self) -> int:
        return self.group * self.per_lane * self.vec

    def grid(self, n_rows: int, f: int) -> tuple:
        """(blocks over the rows, block columns) of a launch; a block
        holds 8 warps (``tiled_rows::WARPS``)."""
        rows_per_block = 8 * (32 // self.group if self.rows else 1)
        return (-(-n_rows // rows_per_block), -(-f // self.span))


def vec_width(f: int, item: int, *ptrs: int) -> int:
    """The widest vector in {4, 2, 1} elements that divides ``f`` and to
    which every address in ``ptrs`` is aligned (elements of ``item``
    bytes)."""
    for v in (4, 2):
        if f % v == 0 and all(p % (v * item) == 0 for p in ptrs):
            return v
    return 1


def launch_plan(f: int, vec: int) -> Plan:
    """The plan K3 launches at F = ``f`` with ``vec``-element loads:
    groups of 16 lanes (8 where a row has at most 8 vectors), each lane
    holding the fewest vectors that cover the row, at most ``MAX_ACC``
    accumulators; one warp per row with its groups on successive slots
    where that covers the row in one block column, else each group on
    its own row.  Chosen by measurement on an H100 (``chip_smoke.py``
    phase ``k3_plans``, which compares both modes with groups of 8 and
    16 lanes; PERF.md): at F=41 and 47 the 16-lane edges plan was the
    fastest, at F=256 the rows plans (two or four block columns)."""
    nv = -(-f // vec)
    group = 16 if nv > 8 else 8
    per_lane = min(-(-nv // group), MAX_ACC // vec)
    return Plan(nv > group * per_lane, group, per_lane, vec)


def _load():
    global _lib
    if _lib is None:
        sig = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
               + [ctypes.c_void_p])
        _lib = dedup_spmm.load_library(SOURCE, {"tiled_spmm_f32": sig,
                                                "tiled_spmm_bf16": sig})
    return _lib


def tile_chunks(t: TiledCSR):
    """(tile, its chunks' slot slices) in the TPU kernel's grid order:
    ``max_chunks`` steps per tile, the steps past the tile's own chunks
    skipped (``gist_tpu/ops/pallas_spmm.py:450-456``)."""
    offs = t.tile_offsets.tolist()
    for i in range(t.num_tiles):
        nchunks = (offs[i + 1] - offs[i]) // t.chunk
        yield i, [slice(offs[i] + c * t.chunk, offs[i] + (c + 1) * t.chunk)
                  for c in range(t.max_chunks) if c < nchunks]


def local_rows(t: TiledCSR, i: int, sl: slice) -> torch.Tensor:
    """Receivers of a chunk of tile i as tile rows; the sentinel of
    padding slots (at or above the next tile) maps to the sink row TN."""
    return (t.receivers[sl].long() - i * t.tile_rows).clamp(max=t.tile_rows)


def tiled_spmm_reference(t: TiledCSR, x: torch.Tensor) -> torch.Tensor:
    """Plain version: per tile, the chunks of its segment added into the
    tile's rows (a sink row takes the padding slots), fp32, cast to x's
    dtype.  Returns the (num_tiles * TN, F) output."""
    tn = t.tile_rows
    xf = x.float()
    out = torch.zeros((t.num_tiles * tn, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    for i, chunks in tile_chunks(t):
        acc = torch.zeros((tn + 1, x.shape[1]), device=x.device)
        for sl in chunks:
            acc.index_add_(0, local_rows(t, i, sl),
                           xf.index_select(0, t.senders[sl]))
        out[i * tn:(i + 1) * tn] = acc[:tn]
    return out.to(x.dtype)


def check_layout(name: str, t: TiledCSR, dev: torch.device,
                 fields=("tile_offsets", "senders", "receivers")) -> None:
    """Raise unless the layout's ``fields`` are int32, contiguous and on
    ``dev``, the current CUDA device: the one check of a TiledCSR that
    every v1 kernel wrapper makes before a launch."""
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors are on {dev}, the current device "
                         f"is cuda:{torch.cuda.current_device()}")
    for f in fields:
        a = getattr(t, f)
        if a is None:
            raise ValueError(f"{name}: the layout carries no {f}")
        if a.dtype != torch.int32:
            raise TypeError(f"{name}: layout {f} must be int32, not "
                            f"{a.dtype}")
        if a.device != dev or not a.is_contiguous():
            raise ValueError(f"{name}: layout {f} must be contiguous and on "
                             f"{dev}")


def tiled_spmm(t: TiledCSR, x: torch.Tensor) -> torch.Tensor:
    """(num_tiles * TN, F) aggregation in x's dtype.

    CUDA tensors launch the kernel with :func:`launch_plan`'s plan (or
    raise); CPU tensors take the plain version; no other device is
    accepted."""
    if x.device.type == "cpu":
        return tiled_spmm_reference(t, x)
    return run_plan(t, x, None)


def run_plan(t: TiledCSR, x: torch.Tensor, plan) -> torch.Tensor:
    """One kernel launch on CUDA tensors with ``plan`` (None:
    :func:`launch_plan`'s); a plan is a :class:`Plan` whose ``vec`` x and
    F allow.  The path calls it through :func:`tiled_spmm`; a measurement
    may pass another plan to compare it."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"tiled_spmm runs on cuda or cpu, not {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tiled_spmm takes float32 or bfloat16, not {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"tiled_spmm expects a contiguous (N, F) input, got "
                         f"{tuple(x.shape)}")
    check_layout("tiled_spmm", t, x.device)
    n_rows, f = t.num_tiles * t.tile_rows, x.shape[1]
    out = torch.empty((n_rows, f), dtype=x.dtype, device=x.device)
    item = x.element_size()
    vec = vec_width(f, item, x.data_ptr(), out.data_ptr())
    if plan is None:
        plan = launch_plan(f, vec)
    elif vec % plan.vec:
        raise ValueError(f"tiled_spmm: plan {plan} needs {plan.vec}-element "
                         f"alignment; F and x allow {vec}")
    fn = _load().tiled_spmm_f32 if x.dtype == torch.float32 else \
        _load().tiled_spmm_bf16
    err = fn(t.tile_offsets.data_ptr(), t.senders.data_ptr(),
             t.receivers.data_ptr(), x.data_ptr(), out.data_ptr(), n_rows,
             t.tile_rows, f, int(plan.rows), plan.group, plan.per_lane,
             plan.vec, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"tiled_spmm launch failed with plan {plan}: "
                           f"CUDA error {err}")
    launches += 1
    return out


def run_tiled(t: TiledCSR, x: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """``gist_tpu/ops/pallas_spmm.py:_run_tiled``: aggregate x over the
    layout and return the node rows (N, F)."""
    if t.max_chunks == 0:
        return torch.zeros((n_nodes, x.shape[1]), dtype=x.dtype,
                           device=x.device)
    return tiled_spmm(t, x.contiguous())[:n_nodes]
