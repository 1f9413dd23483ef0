"""``BENCHMARK.json`` against the rules every later check holds it to,
and against the benchmark's own files."""

import json
import re

import pytest

from portbench import harness

SPEC_PATH = harness.ROOT / "BENCHMARK.json"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH_CHARS = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    if not SPEC_PATH.exists():
        pytest.skip("no BENCHMARK.json beside the benchmark")
    return json.loads(SPEC_PATH.read_text())


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(spec):
    assert list(spec) == ["command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"]
    assert SPEC_PATH.stat().st_size <= 64 * 1024
    assert 1 <= len(spec["command"]) <= 32 and all(_line(w) for w in spec["command"])
    assert 1 <= len(spec["paths"]) <= 16
    for path in spec["paths"]:
        assert PATH_CHARS.match(path) and not path.startswith("/") and ".." not in path
    for word in spec["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in spec["paths"]), word
    seconds = spec["run_seconds"]
    assert isinstance(seconds, int) and 1 <= seconds <= 51
    # a full check of 24 cells fits its 43200 seconds
    assert (2 + 14 * 24) * (seconds + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units(spec):
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
    names += [w[k] for w in spec["workloads"] for k in ("config", "traffic")]
    names += [k for c in spec["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for group in ("end_to_end", "per_layer", "configs", "workloads"):
        assert len({x["name"] for x in spec[group]}) == len(spec[group])
    for metric in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
        assert metric["source"] in SOURCES


def test_configs(spec):
    assert 1 <= len(spec["configs"]) <= 24
    used = {w["config"] for w in spec["workloads"]}
    files = set()
    for config in spec["configs"]:
        assert set(config) == {"name", "source", "file", "reduced", "why"}
        assert config["name"] in used and _line(config["source"]) and _line(config["why"])
        assert config["file"].startswith("portbench/") and config["file"] not in files
        files.add(config["file"])
        assert (harness.ROOT / config["file"]).exists()
        assert config["file"] == f"portbench/configs/{config['name']}.json"
        assert len(config["reduced"]) <= 16


def test_cells_agree_with_their_files(spec):
    assert 1 <= len(spec["workloads"]) <= 24
    pairs = {(w["config"], w["traffic"]) for w in spec["workloads"]}
    assert len(pairs) == len(spec["workloads"])
    four = [w for w in spec["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(spec["workloads"]) // 4)
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        cell, config, traffic, driver = harness.load_cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        assert hasattr(driver, "run")


def test_metrics(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    cells = {w["name"] for w in spec["workloads"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells

    def reports(metric, cell):
        return cell in e2e[metric].get("workloads", cells)

    readers = harness.readers()
    assert 1 <= len(spec["per_layer"]) <= 128
    layers = {}
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e and m["moves"] != "setup_s"
        assert m["name"] in readers and readers[m["name"]].UNIT == m["unit"]
        for cell in m.get("workloads", cells):
            assert cell in cells and reports(m["moves"], cell), (m["name"], cell)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    assert set(readers) == {m["name"] for m in spec["per_layer"]}
    for cell in cells:
        assert any(reports(n, cell) for n in e2e if n != "setup_s"), cell
        assert any(cell in m.get("workloads", cells) for m in spec["per_layer"]), cell


def test_file_names_under_paths(spec):
    for path in spec["paths"]:
        for f in (harness.ROOT / path).rglob("*"):
            if "__pycache__" in f.parts or "_cache" in f.parts:
                continue
            assert PATH_CHARS.match(str(f.relative_to(harness.ROOT))), f
