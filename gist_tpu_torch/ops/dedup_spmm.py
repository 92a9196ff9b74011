"""K1: the dedup SpMM as a hand-written CUDA kernel, with its plain
PyTorch version and its gradient.

Counterpart of the dedup branches of ``gist_tpu/ops/pallas_spmm.py``
(``_dedup_kernel``, ``_spmm_dedup_call``, ``_run_dedup`` and the
``spmm_pallas_csr`` custom VJP).  The kernel source is
``gist_tpu_torch/csrc/dedup_spmm.cu``; it is compiled by ``nvcc`` for
``sm_90a`` into ``gist_tpu_torch/_build/`` at first use and loaded with
ctypes through a plain C interface.

:func:`dedup_spmm` launches the kernel for a CUDA tensor and runs
:func:`dedup_spmm_reference` (the same tile and job walk in plain
PyTorch) for a CPU tensor; it never falls back from one to the other.
``launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import torch

from gist_tpu_torch.graph import DedupTiles, Graph

TILE_ROWS = 128
CU = 1024

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "dedup_spmm.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libdedup_spmm.so")

launches = 0
_lib = None


def build_command(output: str = LIBRARY) -> list:
    """The ``nvcc`` command that compiles the kernel into ``output``."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", output, SOURCE]


def build() -> str:
    """Compile the kernel (atomic rename into ``LIBRARY``); returns the
    compiler's report (``-Xptxas -v``: registers, shared memory)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    res = subprocess.run(build_command(tmp), capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, LIBRARY)
    return res.stderr


def _load():
    global _lib
    if _lib is None:
        if not os.path.exists(LIBRARY):
            build()
        lib = ctypes.CDLL(LIBRARY)
        for name in ("dedup_spmm_f32", "dedup_spmm_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
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
               u_senders: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(num_tiles * 128, F) kernel-order aggregation in x's dtype.

    CUDA tensors launch the kernel (or raise); CPU tensors take the
    plain version; no other device is accepted."""
    global launches
    if x.device.type == "cpu":
        return dedup_spmm_reference(job_offsets, w_blocks, u_senders, x)
    if x.device.type != "cuda":
        raise ValueError(f"dedup_spmm runs on cuda or cpu, not {x.device}")
    _check(job_offsets, w_blocks, u_senders, x)
    num_tiles = job_offsets.shape[0] - 1
    out = torch.empty((num_tiles * TILE_ROWS, x.shape[1]), dtype=x.dtype,
                      device=x.device)
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


class _DedupSpMM(torch.autograd.Function):
    """Gradient of the dedup aggregation: dx = A^T g, the same kernel on
    the transpose layout; the layouts take no gradient."""

    @staticmethod
    def forward(ctx, x, fwd: DedupTiles, bwd: DedupTiles, n_nodes: int):
        ctx.bwd, ctx.n_nodes = bwd, n_nodes
        return run_dedup(fwd, x, n_nodes)

    @staticmethod
    def backward(ctx, g):
        return run_dedup(ctx.bwd, g, ctx.n_nodes), None, None, None


def spmm_dedup(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """``out[i] = sum_{(s, i)} x[s]`` through K1, differentiable in x."""
    if graph.dedup is None or graph.dedup_t is None:
        raise ValueError("graph carries no dedup layout (build it with "
                         "tiles=True)")
    return _DedupSpMM.apply(x, graph.dedup, graph.dedup_t, graph.n_nodes)
