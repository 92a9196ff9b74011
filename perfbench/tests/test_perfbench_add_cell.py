"""A cell is added by adding files and an entry: a new traffic mix, its
limits and a ``workloads`` entry run with no file of the benchmark
edited."""

import hashlib
import json
import os
import time

from conftest import TINY_LIMITS, write_json
from perfbench import harness


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha1(
                    fh.read()).hexdigest()
    return out


def test_new_cell_by_files(tmp_path, cpu):
    from conftest import make_root
    root = make_root(str(tmp_path / "bench"))
    cache = str(tmp_path / "cache")
    before = _digests(root)
    write_json(os.path.join(root, "perfbench", "traffic", "ist-k4.json"),
               {"num_subnet": 4, "warmup_rounds": 1, "check_batches": 2})
    write_json(os.path.join(root, "perfbench", "limits",
                            "tiny-sage-k4.json"), TINY_LIMITS)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, encoding="utf-8") as fh:
        bench = json.load(fh)
    bench["workloads"].append({"name": "tiny-sage-k4", "config": "tiny-sage",
                               "traffic": "ist-k4", "chips": 1,
                               "why": "tests"})
    write_json(path, bench)
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before
            and k != "BENCHMARK.json"} == {
        k: v for k, v in before.items() if k != "BENCHMARK.json"}
    res = harness.run_cell(root, "tiny-sage-k4", 12, 0.2, False,
                           time.perf_counter(), cpu, cache)
    assert res["correct"] is True
    # four half-... quarter-width sub-models trained on every batch
    assert res["attempted"] % 4 == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"train_nodes_per_s", "mfu", "setup_s"}
