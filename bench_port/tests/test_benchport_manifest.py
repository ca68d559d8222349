"""The manifest keeps its required shapes and names, and every file it
names is there."""

import json
import os
import re

import pytest

from conftest import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(REPO, p))
    assert 1 <= len(manifest["command"]) <= 32
    for word in manifest["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in manifest["paths"])
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    # a full check of 24 cells fits in 43,200 seconds at this length
    cells = 24
    assert ((2 + 14 * cells) * (manifest["run_seconds"] + 60)
            + cells * 2 * 90 + 1200) <= 43200


def _one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_names_units_and_entry_keys(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _one_line(c["source"])
        assert _one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("bench_port/")
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _one_line(w["why"])
        names.append(w["name"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    assert len(names) == len(set(names))
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in SOURCES_E2E
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _one_line(m["layer"])
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_every_named_file_exists(manifest):
    for c in manifest["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert "assumed" in cfg
    for w in manifest["workloads"]:
        path = os.path.join(BENCH, "traffic", w["traffic"] + ".json")
        with open(path) as f:
            kind = json.load(f)["kind"]
        assert os.path.exists(os.path.join(BENCH, "kinds", kind + ".py"))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        # the reader of the whole name, or of the quantity before its '.'
        assert any(os.path.exists(os.path.join(BENCH, "metrics", n + ".py"))
                   for n in (m["name"], m["name"].split(".")[0]))


def test_every_reader_serves_a_metric(manifest):
    names = {m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]}
    quantities = names | {n.split(".")[0] for n in names}
    for f in os.listdir(os.path.join(BENCH, "metrics")):
        if f.endswith(".py"):
            assert f[:-3] in quantities, f


def _reports(manifest, group, metric, cell):
    return any(m["name"] == metric
               and ("workloads" not in m or cell in m["workloads"])
               for m in manifest[group])


def test_each_cell_reports_what_it_must(manifest):
    cells = [w["name"] for w in manifest["workloads"]]
    configs = {w["config"] for w in manifest["workloads"]}
    assert configs == {c["name"] for c in manifest["configs"]}
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in manifest["end_to_end"])
    for cell in cells:
        e2e = [m for m in manifest["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]]
        assert len(e2e) >= 2
        assert any("workloads" not in m or cell in m["workloads"]
                   for m in manifest["per_layer"])


def test_per_layer_metric_cells_report_what_it_moves(manifest):
    e2e = {m["name"] for m in manifest["end_to_end"]}
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", sorted(cells)):
            assert cell in cells
            assert _reports(manifest, "end_to_end", m["moves"], cell), (
                f"{m['name']} moves {m['moves']}, which {cell} does not "
                "report")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_layers_are_named_alike(manifest):
    by_layer = {}
    for m in manifest["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())
