"""Time the port's v1 kernels (K3, K7, K8, K9) of two checkouts on one
card, in turns.

    python3 chip_ab.py OTHER

OTHER is the root of another checkout (or a directory holding its
``gist_tpu_torch`` package).  The script runs one worker process per
checkout in the order OTHER, THIS, THIS, OTHER, twice over, so that
drift of the card's clocks falls on both alike.  Each worker builds its
checkout's kernels, makes the same seeded inputs on the full
synth-reddit-small v1 graph (the v1 main path's shapes: K3 at F=256 and
41 forward and transpose, K7-K9 at D=512 and 41 fp32), times each kernel
through its checkout's public wrapper with ``chip_smoke.py``'s timer
(device time per call over back-to-back calls) and prints the SHA-1 of
each output.  K8 and K9 take seeded stand-ins for m, l and ds, so every
run sees the same inputs.  Then one JSON line per case gives
both checkouts' times and whether their outputs are bitwise equal, and
the last line the card and the times' medians.  Needs a CUDA card;
imports no JAX.
"""

import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _timer():
    """``chip_smoke.py``'s kernel timer, from beside this script."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timer", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._kernel_ms


def _sha1(tensors):
    return [hashlib.sha1(t.detach().contiguous().cpu().numpy().tobytes())
            .hexdigest()[:16] for t in tensors]


def worker(root):
    """Time this root's kernels; one JSON line per case on stdout."""
    sys.path.insert(0, root)
    import torch

    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.graph import graph_from_edges
    from gist_tpu_torch.ops import gat_tiled as GT
    from gist_tpu_torch.ops import tiled_spmm as K3

    kernel_ms = _timer()
    dev = torch.device("cuda")
    ds = load_dataset("synth-reddit-small")
    g = graph_from_edges(ds.senders, ds.receivers, ds.n_nodes, tiles=True,
                         tile_mode="gather").to(dev)
    tf, tt = g.tiled, g.tiled_t
    n = g.n_nodes
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def case(kernel, name, fn):
        out = fn()
        torch.cuda.synchronize()
        print(json.dumps({"kernel": kernel, "case": name,
                          "ms": kernel_ms(torch, fn),
                          "sha1": _sha1(out if isinstance(out, tuple)
                                        else (out,))}), flush=True)

    for f in (256, 41):
        x = randn(n, f)
        for direction, t in (("fwd", tf), ("bwd", tt)):
            case("K3", f"{direction} F={f}", lambda: K3.tiled_spmm(t, x))
    src, dst = randn(n), randn(n)
    rows = tf.num_tiles * tf.tile_rows
    # seeded stand-ins for the forward's m, l and K8's ds, the same for
    # every checkout (the plain walks sum with atomics on the card)
    m, l = randn(rows), torch.rand(rows, generator=gen).to(dev) + 0.5
    ds_ = randn(tf.senders.shape[0])
    for d in (512, 41):
        z, gg = randn(n, d), randn(n, d)
        case("K7", f"D={d}", lambda: GT.gat_tiled_fwd(tf, z, src, dst, 0.01))
        case("K8", f"D={d}", lambda: GT.gat_tiled_bwd_b1(
            tf, z, src, dst, m, l, gg, 0.01))
        case("K9", f"D={d}", lambda: GT.gat_tiled_bwd_b2(
            tt, ds_, gg, src, dst, m, l, 0.01))


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_ab: no CUDA device available")
    args = sys.argv[1:]
    if len(args) >= 2 and args[0] == "--worker":
        return worker(args[1])
    if len(args) != 1 or not os.path.isdir(
            os.path.join(args[0], "gist_tpu_torch")):
        sys.exit("usage: python3 chip_ab.py OTHER; OTHER holds "
                 "gist_tpu_torch/")
    roots = {"other": os.path.abspath(args[0]), "this": HERE}
    runs = {"other": [], "this": []}
    for label in ["other", "this", "this", "other"] * 2:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", roots[label]], capture_output=True,
                             text=True, cwd=roots[label])
        if res.returncode:
            sys.exit(f"chip_ab: the {label} worker failed:\n{res.stderr}")
        runs[label].append({(r["kernel"], r["case"]): r for r in map(
            json.loads, [ln for ln in res.stdout.splitlines()
                         if ln.startswith('{"kernel"')])})
    summary = {}
    for key in runs["this"][0]:
        rows = {label: [run[key] for run in runs[label]] for label in runs}
        ms = {label: [r["ms"] for r in rows[label]] for label in rows}
        sha = {label: {tuple(r["sha1"]) for r in rows[label]}
               for label in rows}
        row = {"kernel": key[0], "case": key[1],
               "ms_other": ms["other"], "ms_this": ms["this"],
               "this_over_other": statistics.median(ms["this"])
               / statistics.median(ms["other"]),
               "repeatable": all(len(s) == 1 for s in sha.values()),
               "bitwise_equal": sha["this"] == sha["other"]}
        print(json.dumps(row), flush=True)
        summary[f"{key[0]} {key[1]}"] = {
            label: statistics.median(v) for label, v in ms.items()}
    name = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": name, "other": roots["other"],
                      "median_ms": summary}), flush=True)


if __name__ == "__main__":
    main()
