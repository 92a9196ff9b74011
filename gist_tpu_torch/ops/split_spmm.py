"""K2: the split dedup SpMM (direct and remote jobs) as a hand-written
CUDA kernel, with its plain PyTorch version.

Counterpart of the split branch of ``gist_tpu/ops/pallas_spmm.py``
(``_split_kernel``, ``_spmm_split_call``); the chunked runner,
``_run_dedup_split_chunked``, is
:func:`gist_tpu_torch.ops.dedup_spmm.run_dedup_chunked`.
The kernel source is ``gist_tpu_torch/csrc/split_spmm.cu`` (its walk
over the count blocks in ``csrc/count_block.cuh``, shared with K1); it is
compiled by ``nvcc`` for ``sm_90a`` into ``gist_tpu_torch/_build/`` at
first use and loaded with ctypes through a plain C interface, as K1 is.

:func:`split_spmm` aggregates one chunk: it launches the kernel for CUDA
tensors (or raises) and runs :func:`split_spmm_reference` (the same walk
over tiles and jobs) for CPU tensors.  ``launches`` counts the kernel
launches.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from gist_tpu_torch.ops import dedup_spmm

TILE_ROWS = (64, 128)
CUS = (512, 1024)

SOURCE = os.path.join(os.path.dirname(dedup_spmm.SOURCE), "split_spmm.cu")

launches = 0
_lib = None


def _load():
    global _lib
    if _lib is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        sig = [p] * 8 + [i, ctypes.c_int64, i, i, i, p]
        _lib = dedup_spmm.load_library(SOURCE, {"split_spmm_f32": sig,
                                                "split_spmm_bf16": sig})
    return _lib


def split_spmm_reference(job_offsets, dir_blk, rem_blk, is_dir, w_blocks,
                         u_rem, x):
    """Plain version: walks the same tiles and jobs as the kernel.  A
    direct job reads rows ``dir_blk * CU`` onward of x (zero past its
    last row), a remote job the rows ``u_rem[rem_blk * CU : +CU]``;
    fp32 accumulation, cast to x's dtype.  Returns the
    (num_tiles * TN, F) kernel-order output."""
    num_tiles = job_offsets.shape[0] - 1
    tn, cu = w_blocks.shape[1], w_blocks.shape[2]
    n = x.shape[0]
    offs = job_offsets.tolist()
    direct, dblk, rblk = is_dir.tolist(), dir_blk.tolist(), rem_blk.tolist()
    xf = x.float()
    out = torch.zeros((num_tiles * tn, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    for i in range(num_tiles):
        acc = out[i * tn:(i + 1) * tn]
        for j in range(offs[i], offs[i + 1]):
            w = w_blocks[j].float()
            if direct[j] == 1:
                lo = dblk[j] * cu
                valid = max(0, min(cu, n - lo))
                acc += w[:, :valid] @ xf[lo:lo + valid]
            else:
                lo = rblk[j] * cu
                acc += w @ xf.index_select(0, u_rem[lo:lo + cu])
    return out.to(x.dtype)


def _check(job_offsets, dir_blk, rem_blk, is_dir, w_blocks, u_rem, x, out):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"split_spmm takes float32 or bfloat16, not "
                        f"{x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"split_spmm expects (N, F) input, got "
                         f"{tuple(x.shape)}")
    if w_blocks.dim() != 3:
        raise ValueError("w_blocks must be (jobs, TN, CU)")
    jobs, tn, cu = w_blocks.shape
    if tn not in TILE_ROWS or cu not in CUS:
        raise ValueError(f"split_spmm takes TN in {TILE_ROWS} and CU in "
                         f"{CUS}, got TN={tn}, CU={cu}")
    if w_blocks.dtype != torch.int8 or any(
            t.dtype != torch.int32
            for t in (job_offsets, dir_blk, rem_blk, is_dir, u_rem)):
        raise TypeError("layout must be int8 W and int32 offsets, blocks "
                        "and remote ids")
    if any(t.shape != (jobs,) for t in (dir_blk, rem_blk, is_dir)):
        raise ValueError("dir_blk, rem_blk and is_dir need one entry per "
                         "job")
    if u_rem.dim() != 1 or u_rem.shape[0] % cu or u_rem.shape[0] == 0:
        raise ValueError("u_rem must hold CU slots per remote job")
    num_tiles = job_offsets.shape[0] - 1
    if out.shape != (num_tiles * tn, x.shape[1]) or out.dtype != x.dtype:
        raise ValueError(f"out must be ({num_tiles * tn}, {x.shape[1]}) "
                         f"in {x.dtype}")
    for t in (job_offsets, dir_blk, rem_blk, is_dir, w_blocks, u_rem, x, out):
        if t.device != x.device:
            raise ValueError("layout and features must be on one device")
        if not t.is_contiguous():
            raise ValueError("split_spmm takes contiguous tensors")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"x is on {x.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if w_blocks.data_ptr() % 16:
        raise ValueError("w_blocks must be 16-byte aligned")


def split_spmm(job_offsets, dir_blk, rem_blk, is_dir, w_blocks, u_rem, x,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One chunk of the split layout: the (num_tiles * TN, F) kernel-order
    aggregation in x's dtype, written into ``out`` when given.  x holds
    the permuted features, rows unpadded.

    CUDA tensors launch the kernel (or raise); CPU tensors take the
    plain version; no other device is accepted."""
    global launches
    if x.device.type == "cpu":
        res = split_spmm_reference(job_offsets, dir_blk, rem_blk, is_dir,
                                   w_blocks, u_rem, x)
        return res if out is None else out.copy_(res)
    if x.device.type != "cuda":
        raise ValueError(f"split_spmm runs on cuda or cpu, not {x.device}")
    num_tiles = job_offsets.shape[0] - 1
    if out is None:
        out = torch.empty((num_tiles * w_blocks.shape[1], x.shape[1]),
                          dtype=x.dtype, device=x.device)
    _check(job_offsets, dir_blk, rem_blk, is_dir, w_blocks, u_rem, x, out)
    lib = _load()
    fn = lib.split_spmm_f32 if x.dtype == torch.float32 else \
        lib.split_spmm_bf16
    err = fn(job_offsets.data_ptr(), dir_blk.data_ptr(), rem_blk.data_ptr(),
             is_dir.data_ptr(), w_blocks.data_ptr(), u_rem.data_ptr(),
             x.data_ptr(), out.data_ptr(), num_tiles, x.shape[0], x.shape[1],
             w_blocks.shape[1], w_blocks.shape[2],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"split_spmm launch failed: CUDA error {err}")
    launches += 1
    return out
