"""Both drivers' cells rehearsed at synth-tiny on the CPU: the run's
object has the contract's keys in order, the window's metrics are the
cell's, and the check passes; ``run.py`` refuses to report without a
card or without the program."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT, TINY_CELLS
from perfbench import harness

SEED = 2 ** 31 + 77


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal_last_line(tiny_root, tiny_cache, cpu, cell, trace):
    res = harness.run_cell(tiny_root, cell, SEED, 0.2, trace,
                           time.perf_counter(), cpu, tiny_cache)
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} \
        <= set(res["device"])
    spec = harness.load_spec(tiny_root, cell)
    want = spec.metrics("per_layer" if trace else "end_to_end")
    units = {m["name"]: m["unit"] for m in want}
    got = res["metrics"]
    assert set(got) <= set(units)
    for name, m in got.items():
        assert m["unit"] == units[name] and m["value"] > 0
    if trace:
        # host spans read on the CPU; device readers find nothing there
        assert {"batch_build_ms", "ist_sync_ms"} <= set(got)
        assert "device_idle_share" not in got
    else:
        assert set(got) == set(units)
    for name, c in res["checks"].items():
        assert c["value"] <= c["limit"], name
    json.loads(json.dumps(res))


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "uw-h2048-k1",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    res = _run(ROOT)
    assert res.returncode != 0 and res.stdout == ""


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    res = _run(tmp_path)
    assert res.returncode != 0 and res.stdout == ""
