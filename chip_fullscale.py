"""The port's full-scale benchmark scripts at full length on one CUDA card.

    python3 chip_fullscale.py [--only NAME ...] [--out DIR] [--timeout S]
        [-- EXTRA ARGS]

Runs, from the root of a checkout, each named run below (all of them
without ``--only``) as ``python -m gist_tpu_torch.bench.<script>`` in a
child process of its own (``gist_tpu_torch/bench/procs.py:run_child``,
which waits for it and ends its whole process group), one after another.
A run's output goes to ``DIR/<name>.log`` and its record to
``DIR/<name>.json`` (``record_r2``'s runs: one record a trained run, as
named below); arguments after ``--`` are appended to every run's
(e.g. ``-- --n-epochs 5`` to cut Cluster-GCN's 60 epochs).  It prints
the host's ``nproc``, the card's name and power limit, one JSON line a
run (its record, or its exit code and the end of its log) and, last, a
summary line; it exits non-zero if a run failed.  Layouts are built, not
cached (``--cache-dir ''``): the machine is fresh at every call.

Runs (the JAX scripts' full-scale configurations):

* ``amazon_spmm_v2``, ``amazon_spmm_v3t128``: K1 (v2 chunked layout) or
  K2 (v3 split layout, threshold 128) once per chunk over full
  synth-amazon2m, against the segment path over the whole output;
* ``gat_chunked``: K4 once per chunk on synth-reddit-full (~115M edges),
  with the zero-score check against K1 per chunk;
* ``uw_k1_probe_h1024``, ``uw_k1_probe_h2048``: the K=1 full-width step
  rate on full synth-amazon2m, 3 rounds of 50 steps;
* ``ist_sharded_2d``: S=2 x G=4 (8 ranks on the card), 12 rounds of 8
  steps, beside the 1-D control;
* ``amazon_uw_fullscale_h512_k8``: ultra-wide SAGE h512, K=8, 16 epochs
  (4 rounds), an eval a round, resumable by key under DIR;
* ``cluster_fullscale``: Cluster-GCN SAGE h512 on full synth-amazon2m,
  60 epochs, an eval every 5;
* ``record_r2_singles``: ``record_r2 singles`` (cora GCN, reddit-small
  full-graph SAGE fp32 and bf16, the reddit Cluster-GCN baseline), each
  record ``DIR/torch_r2_<run>.json``;
* ``record_r2_uw_h2048_k1``, ``record_r2_uw_k8``: ``record_r2``'s
  ultra-wide grid on synth-amazon2m-small, the K=1 control and the K=8
  family (h512, h1024, h2048, in turn: a run cut by ``--timeout`` keeps
  the records its finished points wrote);
* ``amazon_split_analysis_tn64``, ``amazon_tn_analysis``: the Amazon2M
  cost models on full synth-amazon2m, their rates measured on the card;
  both take the locality order from one v2 layout, built by the first
  and cached under ``data/torch_layout_cache`` for the second.

``chip_smoke.py`` never starts this script.  Needs a card; it imports no
JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time

from gist_tpu_torch.bench.procs import run_child

HERE = os.path.dirname(os.path.abspath(__file__))

RUNS = {
    "amazon_spmm_v2": ("amazon_spmm", ["--threshold", "0"]),
    "amazon_spmm_v3t128": ("amazon_spmm", ["--threshold", "128"]),
    "gat_chunked": ("gat_chunked", []),
    "uw_k1_probe_h1024": ("uw_k1_probe", ["--hidden", "1024"]),
    "uw_k1_probe_h2048": ("uw_k1_probe", ["--hidden", "2048"]),
    "ist_sharded_2d": ("ist_sharded_2d", []),
    "amazon_uw_fullscale_h512_k8": ("amazon_uw_fullscale",
                                    ["--hidden", "512", "--k", "8",
                                     "--epochs", "16"]),
    "cluster_fullscale": ("cluster_fullscale", []),
    "record_r2_singles": ("record_r2", ["singles"]),
    "record_r2_uw_h2048_k1": ("record_r2", ["ultrawide:2048,1"]),
    "record_r2_uw_k8": ("record_r2", ["ultrawide", "--only", "uw_h512_k8",
                                      "uw_h1024_k8", "uw_h2048_k8"]),
    "amazon_split_analysis_tn64": ("amazon_split_analysis", ["--tn", "64"]),
    "amazon_tn_analysis": ("amazon_tn_analysis", []),
}
# the scripts that build a layout or a partition cache take --cache-dir
NO_CACHE = {"amazon_spmm", "gat_chunked", "uw_k1_probe",
            "amazon_uw_fullscale", "cluster_fullscale"}
# the cost models share one layout of full synth-amazon2m between them
LAYOUT_CACHE = {"amazon_split_analysis", "amazon_tn_analysis"}
# record_r2 writes DIR/torch_r2_<run>.json for each run it trains
R2_RECORDS = {
    "record_r2_singles": ("cora_gcn", "reddit_full_float32",
                          "reddit_full_bfloat16", "reddit_cluster_baseline"),
    "record_r2_uw_h2048_k1": ("uw_h2048_k1",),
    "record_r2_uw_k8": ("uw_h512_k8", "uw_h1024_k8", "uw_h2048_k8"),
}


def _text(cmd):
    return run_child(cmd, 60, capture_output=True, text=True).stdout.strip()


def _command(name, out, extra):
    script, args = RUNS[name]
    cmd = [sys.executable, "-m", f"gist_tpu_torch.bench.{script}", *args,
           "--out", out if name in R2_RECORDS
           else os.path.join(out, f"{name}.json")]
    if script in NO_CACHE:
        cmd += ["--cache-dir", ""]
    if script in LAYOUT_CACHE:
        cmd += ["--cache-dir", os.path.join(HERE, "data",
                                            "torch_layout_cache")]
    if script == "amazon_uw_fullscale":
        cmd += ["--ckpt", os.path.join(out, f"{name}_ckpt")]
    return cmd + list(extra)


def _r2_records(out, runs) -> dict:
    """Each written record of ``runs`` in ``out``, its curves left out
    (they stay in the file)."""
    recs = {}
    for run in runs:
        path = os.path.join(out, f"torch_r2_{run}.json")
        if os.path.exists(path):
            with open(path, encoding="utf-8") as fh:
                rec = json.load(fh)
            recs[run] = {k: v for k, v in rec.items()
                         if not isinstance(v, list) or len(v) <= 8}
    return recs


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    extra = []
    if "--" in argv:
        extra = argv[argv.index("--") + 1:]
        argv = argv[:argv.index("--")]
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--only", nargs="+", choices=sorted(RUNS), default=None)
    p.add_argument("--out", default="data/fullscale")
    p.add_argument("--timeout", type=float, default=3300,
                   help="seconds a run may take")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_fullscale: no CUDA device available")
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    print(json.dumps({
        "nproc": int(_text(["nproc"]) or 0),
        "card": _text(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"])}), flush=True)
    summary = {}
    for name in args.only or list(RUNS):
        cmd = _command(name, out, extra)
        log = os.path.join(out, f"{name}.log")
        t0 = time.time()
        with open(log, "w", encoding="utf-8") as fh:
            try:
                code = run_child(cmd, args.timeout, cwd=HERE, stdout=fh,
                                 stderr=fh).returncode
            except subprocess.TimeoutExpired:
                code = "timeout"
        seconds = time.time() - t0
        rec = {}
        if code != 0:
            with open(log, encoding="utf-8") as fh:
                rec = {"returncode": code,
                       "log_tail": fh.read()[-3000:]}
        if name in R2_RECORDS:
            rec["records"] = _r2_records(out, R2_RECORDS[name])
        elif code == 0:
            with open(os.path.join(out, f"{name}.json"),
                      encoding="utf-8") as fh:
                rec = json.load(fh)
        print(json.dumps({"run": name, "seconds": seconds, **rec}),
              flush=True)
        summary[name] = {"ok": code == 0, "seconds": seconds}
    print(json.dumps({"summary": summary}), flush=True)
    return 0 if all(v["ok"] for v in summary.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
