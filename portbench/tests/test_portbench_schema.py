"""``BENCHMARK.json`` against the benchmark's contract, and every cell's
files found by name."""

from __future__ import annotations

import json
import re

import pytest

from portbench import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def spec():
    return json.loads((bench.ROOT / "BENCHMARK.json").read_text())


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_size(spec):
    assert set(spec) == TOP
    assert (bench.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (bench.ROOT / p).is_dir() and not p.endswith("_torch")
    cmd = spec["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)


def test_run_seconds_fit_a_full_check(spec):
    s = spec["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    cells = 24
    assert (2 + 14 * cells) * (s + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys(spec):
    names = [c["name"] for c in spec["configs"]]
    cells = [w["name"] for w in spec["workloads"]]
    metrics = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_bounds(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25


def test_configs_and_their_files(spec):
    assert 1 <= len(spec["configs"]) <= 24
    used = {w["config"] for w in spec["workloads"]}
    files = [c["file"] for c in spec["configs"]]
    assert len(files) == len(set(files))
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and line(c["source"]) and line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in spec["paths"])
        conf = json.loads((bench.ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"]
        assert len(c["reduced"]) <= 16
        assert sorted(c["reduced"]) == sorted(conf["reduced"])
        assert all(NAME.match(k) and k in conf for k in c["reduced"])
        for k in c["reduced"]:
            assert not (k.endswith("_dim") or k.endswith("_rank")
                        or "size" in k and k != "vocab_size")


def test_cells_find_their_files(spec):
    cells = spec["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        cell = bench.load_cell(w["name"])
        assert (bench.PKG / "drivers" / f"{cell['mix']['kind']}.py").exists()
        for m in cell["per_layer"]:
            assert (bench.PKG / "metrics" / f"{m['name']}.py").exists()


def test_every_cell_reports_enough(spec):
    for w in spec["workloads"]:
        e2e = [m["name"] for m in bench.reported(spec["end_to_end"],
                                                 w["name"])]
        per = bench.reported(spec["per_layer"], w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2 and per


def test_moves_names_a_metric_each_cell_reports(spec):
    for m in spec["per_layer"]:
        cells = m.get("workloads", [w["name"] for w in spec["workloads"]])
        for cell in cells:
            e2e = [e["name"] for e in bench.reported(spec["end_to_end"], cell)]
            assert m["moves"] in e2e, (m["name"], cell)
