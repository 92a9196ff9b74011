"""Readings for the limits of a cell's check, on the card at the cell's
own size: the program as the configuration states it (``fp32``), the
lower-precision control (``bf16``: the program with its own bfloat16
compute path switched on) and the planted faults (``half``: half of each
batch's nodes left out of the loss, the mean taken over the rest;
``frozen``: an optimizer step that leaves its state unchanged;
``stale``: every merge after the first round's skipped, the full-width
parameters left as that merge wrote them).  Each seed runs the cell's
set-up and warm-up rounds, ``--rounds`` more in place of the window,
the compared round and the check; nothing is timed.  The benchmark's
runs never run this.

    python3 perfbench/calibrate.py --workload <cell> --mode fp32 \
        --seeds 11,12,13 --rounds 11 [--mode bf16 --seeds 21,22,23 \
        --rounds 11 ...]

One JSON line a run on standard output, and the largest and smallest
reading of each number a mode at the end.
"""

import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def half_batch():
    """The burst's loss over every other real node only."""
    from gist_tpu_torch.ist import ultrawide
    orig = ultrawide.masked_cross_entropy

    def loss(logits, labels, mask):
        m = mask.clone()
        m[1::2] = False
        return orig(logits, labels, m)

    ultrawide.masked_cross_entropy = loss
    try:
        yield
    finally:
        ultrawide.masked_cross_entropy = orig


@contextlib.contextmanager
def frozen_step():
    """Adam steps that change nothing."""
    import torch
    orig = torch.optim.Adam.step
    torch.optim.Adam.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.Adam.step = orig


@contextlib.contextmanager
def stale_merge():
    """Merges after the first that hand back the parameters unchanged
    (both rounds' merges: the host's and the card's)."""
    from gist_tpu_torch.ist import slicing, ultrawide
    host, dev = ultrawide.merge_host, slicing.merge
    calls = [0]

    def first_only(merge):
        def skip_later(params, *a, **kw):
            calls[0] += 1
            return merge(params, *a, **kw) if calls[0] == 1 else params
        return skip_later

    ultrawide.merge_host, slicing.merge = first_only(host), first_only(dev)
    try:
        yield
    finally:
        ultrawide.merge_host, slicing.merge = host, dev


MODES = {"fp32": (None, None), "bf16": ("bfloat16", None),
         "half": (None, half_batch), "frozen": (None, frozen_step),
         "stale": (None, stale_merge)}


def readings(root: str, workload: str, seed: int, mode: str, rounds: int,
             device, cache_dir: str, arrays=None) -> tuple:
    """(the check's numbers, its per-leaf gaps, the graph's arrays) of
    one seed in ``mode``, the compared round ``rounds`` after the
    warm-up."""
    from perfbench import harness
    dtype, patch = MODES[mode]
    # the drivers bind the program's functions when they load: the
    # fault is planted before
    with patch() if patch else contextlib.nullcontext():
        cell = harness.Cell(root, workload, seed, device, cache_dir, dtype,
                            arrays)
        cell.start()
        for _ in range(rounds):
            cell.next_round()
        cell.compared_round()
    cell.close()
    nums = {k: c["value"] for k, c in cell.check().items()}
    return nums, cell.detail, cell.arrays


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", action="append", choices=sorted(MODES),
                   required=True)
    p.add_argument("--seeds", action="append", required=True,
                   help="comma-separated seeds, one list a --mode")
    p.add_argument("--rounds", action="append", type=int, required=True,
                   help="rounds between the warm-up and the compared "
                   "round, one a --mode")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from perfbench import harness
    device = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    cache = os.path.join(ROOT, "perfbench", ".cache")
    arrays, seen = None, {}
    for mode, seeds, rounds in zip(args.mode, args.seeds, args.rounds):
        for seed in (int(s) for s in seeds.split(",")):
            t0 = time.perf_counter()
            nums, detail, arrays = readings(ROOT, args.workload, seed, mode,
                                            rounds, device, cache, arrays)
            print(json.dumps({"mode": mode, "seed": seed, "rounds": rounds,
                              "numbers": nums,
                              "leaves": detail,
                              "s": time.perf_counter() - t0}), flush=True)
            seen.setdefault(mode, []).append(nums)
    for mode, runs in seen.items():
        print(json.dumps({"mode": mode, "runs": len(runs), "max": {
            k: max(r[k] for r in runs) for k in runs[0]}, "min": {
            k: min(r[k] for r in runs) for k in runs[0]}}))
    harness.log("calibration done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
