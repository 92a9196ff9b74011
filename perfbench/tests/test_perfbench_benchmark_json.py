"""``BENCHMARK.json`` and the files it names keep to the benchmark's
contract: its keys, names, units and lengths, the files of every
configuration, cell and metric, and a run length whose full check fits
its time."""

import json
import os
import re

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as fh:
        return json.load(fh)


def _line(s):
    assert 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s, s


def test_keys_and_paths():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert len(b["command"]) <= 32
    for w in b["command"]:
        _line(w)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_configs_and_cells():
    b = _bench()
    names = [c["name"] for c in b["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        _line(c["source"]), _line(c["why"])
        assert c["file"].startswith("perfbench/")
        with open(os.path.join(ROOT, c["file"]), encoding="utf-8") as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        assert sorted(c["reduced"]) == sorted(cfg.get("reduced", {}))
        for k in c["reduced"]:
            assert NAME.match(k)
            assert not re.search(r"(hidden|dim|rank|head|width)", k), k
        assert os.path.exists(os.path.join(
            ROOT, "perfbench", "drivers", f"{cfg['driver']}.py"))
    cells = b["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        _line(w["why"])
        for sub in (("traffic", w["traffic"]), ("limits", w["name"])):
            assert os.path.exists(os.path.join(ROOT, "perfbench", sub[0],
                                               f"{sub[1]}.json")), sub


def test_metrics():
    b = _bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert 1 <= len(b["per_layer"]) <= 128
    seen = set()
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            assert NAME.match(m["name"]) and m["name"] not in seen
            seen.add(m["name"])
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                              "higher")
            assert os.path.exists(os.path.join(
                ROOT, "perfbench", "metrics", f"{m['name']}.py"))
            assert set(m.get("workloads", [])) <= cells
            if kind == "end_to_end":
                assert set(m) - {"workloads"} == {
                    "name", "unit", "better", "bound", "source"}
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert set(m) - {"workloads"} == {
                    "name", "unit", "better", "source", "layer", "moves"}
                assert m["source"] in ("device_trace", "program_span",
                                       "program_counter", "host_clock")
                assert m["moves"] in e2e and m["moves"] != "setup_s"
                _line(m["layer"])
            if m["name"].endswith("_roofline") or "mfu" in m["name"]:
                assert m["unit"] == "%"
    for cell in cells:
        assert any(cell in m.get("workloads", [cell])
                   for m in b["end_to_end"] if m["name"] != "setup_s")
        assert any(cell in m.get("workloads", [cell])
                   for m in b["per_layer"])


def test_a_full_check_fits_its_time():
    rs = _bench()["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200
