"""No module whose top-level name is JAX's or the JAX package's reaches
the process that reports: checked on the loaded modules, by whole
top-level names (the port's own name begins with the JAX package's),
and on the harness's sources."""

import ast
import os
import subprocess
import sys

import pytest

from conftest import ROOT
from perfbench import harness

PB = os.path.join(ROOT, "perfbench")


@pytest.mark.parametrize("name,found", [
    ("gist_tpu", True), ("gist_tpu.ops.spmm", True), ("jax", True),
    ("jaxlib.xla_client", True), ("flax.linen", True),
    ("gist_tpu_torch", False), ("gist_tpu_torch.ops", False),
    ("jaxtyping", False), ("flaxen", False)])
def test_forbidden_modules_by_whole_top_level_name(monkeypatch, name,
                                                   found):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, name, object())
    assert (harness.forbidden_modules() != before) is found


def test_a_tiny_run_loads_none(tiny_root, tmp_path):
    code = (
        "import sys, time, torch; sys.path.insert(0, %r)\n"
        "from perfbench import harness\n"
        "harness.run_cell(%r, 'tiny-gat-k2', 5, 0.1, False, "
        "time.perf_counter(), torch.device('cpu'), %r)\n"
        "harness.run_cell(%r, 'tiny-sage-k1', 5, 0.1, True, "
        "time.perf_counter(), torch.device('cpu'), %r)\n"
        "print(harness.forbidden_modules())\n"
        % (ROOT, tiny_root, str(tmp_path), tiny_root, str(tmp_path)))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources(top):
    for d, _, files in os.walk(top):
        if ".cache" not in d:
            yield from (os.path.join(d, f) for f in files
                        if f.endswith(".py"))


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources(PB):
        for mod in _imports(path):
            assert mod.split(".")[0] not in harness.FORBIDDEN, (path, mod)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources(os.path.join(PB, "reference")):
        for mod in _imports(path):
            assert mod.split(".")[0] not in harness.FORBIDDEN + (
                "gist_tpu_torch",), (path, mod)
