"""K1: the dedup SpMM as a hand-written CUDA kernel, with its plain
PyTorch version and its gradient.

Counterpart of the dedup branches of ``gist_tpu/ops/pallas_spmm.py``
(``_dedup_kernel``, ``_spmm_dedup_call``, ``_run_dedup``,
``_run_dedup_chunked`` and the ``spmm_pallas_csr`` custom VJP, whose
split-layout branch runs K2 from :mod:`gist_tpu_torch.ops.split_spmm`
and whose v1 branch runs K3 from :mod:`gist_tpu_torch.ops.tiled_spmm`).
The kernel source is ``gist_tpu_torch/csrc/dedup_spmm.cu`` (its walk
over the count blocks in ``csrc/count_block.cuh``, shared with K2); it
is compiled by ``nvcc`` for ``sm_90a`` into ``gist_tpu_torch/_build/``
at first use and loaded with ctypes through a plain C interface.  Each
kernel library is named by the content of the files it is compiled from
(:func:`library_path`), so an edited source is never served by an old
build.

:func:`dedup_spmm` launches the kernel for a CUDA tensor and runs
:func:`dedup_spmm_reference` (the same tile and job walk in plain
PyTorch) for a CPU tensor; it never falls back from one to the other.
``launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from typing import Optional

import torch

from gist_tpu_torch.graph import ChunkedDedupTiles, DedupTiles, Graph, TiledCSR

TILE_ROWS = 128
CU = 1024
# K1's and K2's launch shape (count_block::FT, count_block::WARPS): one
# warp per destination row, ROWS_PER_BLOCK rows a block, and
# ceil(F / FEATURE_TILE) column slices of each
FEATURE_TILE = 256
ROWS_PER_BLOCK = 8

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "dedup_spmm.cu")
BUILD_DIR = os.path.join(_PKG, "_build")

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(source: str) -> list:
    """``source`` and every header it includes by a quoted path from its
    directory, recursively, each once."""
    seen, todo = [], [os.path.abspath(source)]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        with open(path, encoding="utf-8") as fh:
            todo += [os.path.join(os.path.dirname(path), name)
                     for name in _INCLUDE.findall(fh.read())]
    return seen


def library_path(source: str) -> str:
    """The library built from ``source``: ``lib<stem>-<key>.so`` in
    ``BUILD_DIR``, where the key is the SHA-1 of the source and of every
    header it includes, so that an edit to either names a new library."""
    digest = hashlib.sha1()
    for path in _sources(source):
        with open(path, "rb") as fh:
            digest.update(os.path.basename(path).encode() + b"\0"
                          + fh.read() + b"\0")
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:12]}.so")


def launch_grid(num_tiles: int, f: int, tile_rows: int = TILE_ROWS) -> tuple:
    """(feature slices, blocks per tile, tiles) of a K1 or K2 launch, its
    blocks in that order from fastest to slowest."""
    return (-(-f // FEATURE_TILE), tile_rows // ROWS_PER_BLOCK, num_tiles)


launches = 0
_lib = None


def build_command(output: str, source: str = SOURCE) -> list:
    """The ``nvcc`` command that compiles ``source`` into ``output``."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", output, source]


def build(source: str = SOURCE) -> str:
    """Compile ``source`` into :func:`library_path` (atomic rename);
    returns the compiler's report (``-Xptxas -v``: registers, shared
    memory)."""
    library = library_path(source)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{library}.{os.getpid()}.tmp"
    res = subprocess.run(build_command(tmp, source), capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, library)
    return res.stderr


def load_library(source: str, signatures: dict) -> ctypes.CDLL:
    """The kernel library of ``source``, compiled first where none exists
    for the sources' present content; ``signatures`` gives each C
    function's argument types (every one returns a CUDA error code)."""
    path = library_path(source)
    if not os.path.exists(path):
        build(source)
    lib = ctypes.CDLL(path)
    for name, args in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _load():
    global _lib
    if _lib is None:
        sig = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]
        _lib = load_library(SOURCE, {"dedup_spmm_f32": sig,
                                     "dedup_spmm_bf16": sig})
    return _lib


def dedup_spmm_reference(job_offsets: torch.Tensor, w_blocks: torch.Tensor,
                         u_senders: torch.Tensor, x: torch.Tensor
                         ) -> torch.Tensor:
    """Plain version: walks the same tiles and jobs as the kernel,
    ``out[tile i] = sum_j W_j @ x[u_j]`` in fp32, cast to x's dtype.
    Returns the (num_tiles * TN, F) kernel-order output."""
    num_tiles = job_offsets.shape[0] - 1
    tn, cu = w_blocks.shape[1], w_blocks.shape[2]
    offs = job_offsets.tolist()
    xf = x.float()
    out = torch.zeros((num_tiles * tn, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    for i in range(num_tiles):
        for j in range(offs[i], offs[i + 1]):
            rows = xf.index_select(0, u_senders[j * cu:(j + 1) * cu])
            out[i * tn:(i + 1) * tn] += w_blocks[j].float() @ rows
    return out.to(x.dtype)


def _check(job_offsets, w_blocks, u_senders, x):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dedup_spmm takes float32 or bfloat16, not {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"dedup_spmm expects (N, F) input, got "
                         f"{tuple(x.shape)}")
    if tuple(w_blocks.shape[1:]) != (TILE_ROWS, CU):
        raise ValueError(f"dedup_spmm needs TN={TILE_ROWS}, CU={CU} blocks, "
                         f"got {tuple(w_blocks.shape[1:])}")
    if (job_offsets.dtype, w_blocks.dtype, u_senders.dtype) != (
            torch.int32, torch.int8, torch.int32):
        raise TypeError("layout must be int32 offsets, int8 W, int32 senders")
    if u_senders.shape[0] != w_blocks.shape[0] * CU:
        raise ValueError("u_senders must hold CU slots per job")
    for t in (job_offsets, w_blocks, u_senders, x):
        if t.device != x.device:
            raise ValueError("layout and features must be on one device")
        if not t.is_contiguous():
            raise ValueError("dedup_spmm takes contiguous tensors")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"x is on {x.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if w_blocks.data_ptr() % 16:
        raise ValueError("w_blocks must be 16-byte aligned")


def dedup_spmm(job_offsets: torch.Tensor, w_blocks: torch.Tensor,
               u_senders: torch.Tensor, x: torch.Tensor,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(num_tiles * 128, F) kernel-order aggregation in x's dtype,
    written into ``out`` when given.

    CUDA tensors launch the kernel (or raise); CPU tensors take the
    plain version; no other device is accepted."""
    global launches
    if x.device.type == "cpu":
        res = dedup_spmm_reference(job_offsets, w_blocks, u_senders, x)
        return res if out is None else out.copy_(res)
    if x.device.type != "cuda":
        raise ValueError(f"dedup_spmm runs on cuda or cpu, not {x.device}")
    _check(job_offsets, w_blocks, u_senders, x)
    num_tiles = job_offsets.shape[0] - 1
    shape = (num_tiles * TILE_ROWS, x.shape[1])
    if out is None:
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
    elif (out.shape != shape or out.dtype != x.dtype
          or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {shape} tensor in "
                         f"{x.dtype} on {x.device}")
    lib = _load()
    fn = lib.dedup_spmm_f32 if x.dtype == torch.float32 else \
        lib.dedup_spmm_bf16
    err = fn(job_offsets.data_ptr(), w_blocks.data_ptr(),
             u_senders.data_ptr(), x.data_ptr(), out.data_ptr(),
             num_tiles, x.shape[1],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"dedup_spmm launch failed: CUDA error {err}")
    launches += 1
    return out


def run_dedup(t: DedupTiles, x: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """``gist_tpu/ops/pallas_spmm.py:_run_dedup``: aggregate x over the
    layout and return node-order rows (N, F)."""
    if t.max_jobs == 0:
        return torch.zeros((n_nodes, x.shape[1]), dtype=x.dtype,
                           device=x.device)
    out = dedup_spmm(t.job_offsets, t.w_blocks, t.u_senders, x.contiguous())
    if t.pos is not None:
        return out.index_select(0, t.pos)
    return out[:n_nodes]


def run_dedup_chunked(t: ChunkedDedupTiles, x: torch.Tensor,
                      n_nodes: int) -> torch.Tensor:
    """``gist_tpu/ops/pallas_spmm.py:_run_dedup_chunked`` and
    ``_run_dedup_split_chunked``: permute x once (the chunks index
    ``x[perm]``), run K1 once per chunk, or K2 once per chunk on a split
    layout (``t.is_dir`` set), into its slice of one output, and take the
    rows to node order.  A chunk's padding tiles have no jobs, so the
    kernel writes zeros there; K2 reads zero for direct rows past the
    last, so x's rows are not padded."""
    if t.max_jobs == 0:
        return torch.zeros((n_nodes, x.shape[1]), dtype=x.dtype,
                           device=x.device)
    if t.perm is not None:
        x = x.index_select(0, t.perm)
    x = x.contiguous()
    rows = t.tiles_per_chunk * t.tile_rows
    out = torch.empty((t.n_chunks * rows, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    # here, not at the top: split_spmm imports this module
    from gist_tpu_torch.ops.split_spmm import split_spmm
    for c in range(t.n_chunks):
        out_c = out[c * rows:(c + 1) * rows]
        if t.is_dir is None:
            dedup_spmm(t.job_offsets[c], t.w_blocks[c], t.u_senders[c], x,
                       out=out_c)
        else:
            split_spmm(t.job_offsets[c], t.dir_blk[c], t.rem_blk[c],
                       t.is_dir[c], t.w_blocks[c], t.u_senders[c], x,
                       out=out_c)
    if t.pos is not None:
        return out.index_select(0, t.pos)
    return out[:n_nodes]


def run_layout(t, x: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Aggregate over a flat, chunked, split or v1 layout, dispatching as
    ``_spmm_forward``/``_spmm_bwd`` do: K1, K1 per chunk, K2, or K3."""
    if isinstance(t, DedupTiles):
        return run_dedup(t, x, n_nodes)
    if isinstance(t, TiledCSR):
        # here, not at the top: tiled_spmm imports this module
        from gist_tpu_torch.ops.tiled_spmm import run_tiled
        return run_tiled(t, x, n_nodes)
    return run_dedup_chunked(t, x, n_nodes)


class _DedupSpMM(torch.autograd.Function):
    """Gradient of the kernel aggregation: dx = A^T g, a kernel on the
    transpose layout; the layouts take no gradient."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, n_nodes: int):
        ctx.bwd, ctx.n_nodes = bwd, n_nodes
        return run_layout(fwd, x, n_nodes)

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd is None:
            raise NotImplementedError(
                "graph carries no transpose layout (dedup_t, dedup_c_t or "
                "tiled_t): its aggregation takes no gradient")
        return run_layout(ctx.bwd, g.contiguous(), ctx.n_nodes), None, None, \
            None


def _first(*layouts):
    return next((t for t in layouts if t is not None), None)


def spmm_dedup(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """``out[i] = sum_{(s, i)} x[s]`` through K1 (flat or per chunk), K2
    (split layout) or K3 (v1 layout), differentiable in x.  Forward and
    backward pick their layouts independently in the JAX package's order
    (``gist_tpu/ops/pallas_spmm.py:582-609``): flat, then chunked, then
    v1."""
    fwd = _first(graph.dedup, graph.dedup_c, graph.tiled)
    bwd = _first(graph.dedup_t, graph.dedup_c_t, graph.tiled_t)
    if fwd is None:
        raise ValueError("graph carries no kernel layout (build it with "
                         "tiles=True)")
    return _DedupSpMM.apply(x, fwd, bwd, graph.n_nodes)
