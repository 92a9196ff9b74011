"""``s1_roofline``: the least time of the segment sums the window's steps
need (``perfbench/reference/flops.py:segment_sums``: offsets, indices,
weights, rows summed and output each once, at 3.35 TB/s, or the sums'
FLOPs at the fp32 peak, whichever is longer) over the device time of the
S1 kernel (``segment_csr_kernel``), in %.  Silent where S1 did not
run."""

from perfbench.reference.flops import least_seconds, segment_sums


def read(rec):
    s1 = rec.kernels(lambda n: "segment_csr_kernel" in n)
    if not s1:
        return None
    t = sum(b - a for _, a, b in s1) / 1e9
    least = sum(least_seconds(nb, fl)
                for n, e, _ in rec.batches()
                for nb, fl in segment_sums(rec.model, rec.dims, n, e))
    return 100.0 * least / t
