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
through its checkout's public wrapper with the port's timer
(device time per call over back-to-back calls) and prints the SHA-1 of
each output; the first worker of each checkout also saves its outputs
to a temporary directory.  K8 and K9 take seeded stand-ins for m, l and
ds, so every run sees the same inputs.  Then one JSON line per case
gives both checkouts' times, whether their outputs are bitwise equal
and, where they are not (a kernel that sums in another order), this
checkout's largest error against the other's relative to its max; the
last line gives the card and the times' medians.  Needs a CUDA card;
imports no JAX.
"""

import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))


def _timer():
    """The port's kernel timer (``gist_tpu_torch/bench/timing.py``) from
    this script's checkout, whichever checkout is being timed."""
    spec = importlib.util.spec_from_file_location(
        "bench_timing",
        os.path.join(HERE, "gist_tpu_torch", "bench", "timing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.kernel_ms


def _sha1(tensors):
    return [hashlib.sha1(t.detach().contiguous().cpu().numpy().tobytes())
            .hexdigest()[:16] for t in tensors]


def worker(root, save=None):
    """Time this root's kernels; one JSON line per case on stdout, and
    each case's outputs saved under the directory ``save`` if given."""
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
        out = out if isinstance(out, tuple) else (out,)
        torch.cuda.synchronize()
        if save:
            torch.save([t.cpu() for t in out],
                       os.path.join(save, f"{kernel} {name}.pt"))
        print(json.dumps({"kernel": kernel, "case": name,
                          "ms": kernel_ms(fn),
                          "sha1": _sha1(out)}), flush=True)

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


def _run_workers(roots, tmp):
    """The workers in the order other, this, this, other, twice over;
    the first of each label saves its outputs under ``tmp/<label>``.
    Returns each label's runs, each a dict (kernel, case) -> row."""
    runs = {"other": [], "this": []}
    for label in ["other", "this", "this", "other"] * 2:
        cmd = [sys.executable, os.path.abspath(__file__), "--worker",
               roots[label]]
        if not runs[label]:
            os.makedirs(os.path.join(tmp, label))
            cmd.append(os.path.join(tmp, label))
        res = subprocess.run(cmd, capture_output=True, text=True,
                             cwd=roots[label])
        if res.returncode:
            sys.exit(f"chip_ab: the {label} worker failed:\n{res.stderr}")
        runs[label].append({(r["kernel"], r["case"]): r for r in map(
            json.loads, [ln for ln in res.stdout.splitlines()
                         if ln.startswith('{"kernel"')])})
    return runs


def _rel_err(tmp, name):
    """The largest error of this checkout's outputs of a case against
    the other's, each relative to the other's max."""
    import torch
    this, other = (torch.load(os.path.join(tmp, label, name))
                   for label in ("this", "other"))
    return max(float((a.float() - b.float()).abs().max()
                     / b.float().abs().max().clamp(min=1e-30))
               for a, b in zip(this, other))


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_ab: no CUDA device available")
    args = sys.argv[1:]
    if len(args) >= 2 and args[0] == "--worker":
        return worker(*args[1:])
    if len(args) != 1 or not os.path.isdir(
            os.path.join(args[0], "gist_tpu_torch")):
        sys.exit("usage: python3 chip_ab.py OTHER; OTHER holds "
                 "gist_tpu_torch/")
    roots = {"other": os.path.abspath(args[0]), "this": HERE}
    with tempfile.TemporaryDirectory() as tmp:
        runs = _run_workers(roots, tmp)
        summary = {}
        for key in runs["this"][0]:
            rows = {label: [run[key] for run in runs[label]]
                    for label in runs}
            ms = {label: [r["ms"] for r in rows[label]] for label in rows}
            sha = {label: {tuple(r["sha1"]) for r in rows[label]}
                   for label in rows}
            equal = sha["this"] == sha["other"]
            row = {"kernel": key[0], "case": key[1],
                   "ms_other": ms["other"], "ms_this": ms["this"],
                   "this_over_other": statistics.median(ms["this"])
                   / statistics.median(ms["other"]),
                   "repeatable": all(len(s) == 1 for s in sha.values()),
                   "bitwise_equal": equal,
                   "rel_err_vs_other": 0.0 if equal else _rel_err(
                       tmp, f"{key[0]} {key[1]}.pt")}
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
