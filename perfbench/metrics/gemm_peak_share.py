"""``gemm_peak_share``: the dense layers' matrix-product FLOPs of the
window's steps at their padded row counts
(``perfbench/reference/flops.py:gemm_flops``) over the device time of
the kernels whose names hold ``gemm`` (cuBLAS's and CUTLASS's), as a
share of the fp32 peak, in %.  Silent where no such kernel ran."""

from perfbench.reference.flops import PEAK_FLOPS, gemm_flops


def read(rec):
    gemms = rec.kernels(lambda n: "gemm" in n.lower())
    if not gemms:
        return None
    t = sum(b - a for _, a, b in gemms) / 1e9
    work = sum(gemm_flops(rec.model, rec.dims, n_pad)
               for _, _, n_pad in rec.batches())
    return 100.0 * work / t / PEAK_FLOPS["float32"]
