"""The port and its chip scripts import neither JAX nor the JAX
package, its benchmark scripts or its driver entry: the machine with the
card has no JAX.  Nor do they hold the JAX package's TPU figures as
numbers: a link rate, an aggregation time or a gather rate is the
caller's input or is measured on the card."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gist_tpu",
             "benchmarks", "__graft_entry__")
# the JAX package's TPU figures: its v5e ICI link rate, its recorded
# fp32 and bf16 aggregation times, its XLA gather rate, its pipeline
# rate and its permute time
TPU_FIGURES = (4.5e10, 9.9e-3, 7.2e-3, 85e6, 195e9, 0.042)
SOURCES = sorted((ROOT / "gist_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_ab.py", ROOT / "chip_flagship.py",
    ROOT / "chip_fullscale.py",
    ROOT / "bench_torch.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_imports(path):
    bad = [m for m in _imported_roots(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_package():
    assert len(SOURCES) > 15
    assert (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_tpu_figures(path):
    """No numeric literal of the JAX package's TPU figures, and no
    mention of its 11 GiB budget."""
    text = path.read_text()
    tree = ast.parse(text, filename=str(path))
    bad = [(node.lineno, node.value) for node in ast.walk(tree)
           if isinstance(node, ast.Constant)
           and type(node.value) in (int, float)
           and any(node.value == v for v in TPU_FIGURES)]
    assert not bad, f"{path.relative_to(ROOT)} holds {bad}"
    assert "11 GiB" not in text and "HBM_BUDGET_GIB" not in text
