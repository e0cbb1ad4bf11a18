"""BENCHMARK.json keeps to the benchmark's contract, every name in it
finds its file, and a run's last line has the contract's keys."""

import json
import re
import pytest

from portbench.tests.helpers import REPO, run_cell, tiny_root

MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_run_length():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["portbench"]
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_configs():
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = set()
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and c["name"] in used
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        body = json.loads((REPO / c["file"]).read_text())
        assert body["reduced"] == c["reduced"] == []
        assert (REPO / body["weights"]).is_file()


def test_workloads():
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert one_line(w["why"]) and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (REPO / "portbench/traffic" / f"{w['traffic']}.json").is_file()
        assert (REPO / "portbench/checks" / f"{w['name']}.json").is_file()
    assert sum(w["chips"] == 4 for w in MANIFEST["workloads"]) <= 1


def test_metrics():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e[
        "setup_s"]
    names = set()
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(CELLS)
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert one_line(m["layer"]) and m["moves"] in e2e
        assert (REPO / "portbench/metrics" / f"{m['name']}.py").is_file()
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in MANIFEST["end_to_end"]
           if cell in m.get("workloads", CELLS)]
    layer = [m["name"] for m in MANIFEST["per_layer"]
             if cell in m["workloads"]]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    assert any("mfu" in n for n in layer)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("schema"))


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_schema(tiny, trace):
    rc, res, err = run_cell(tiny, "denoising_syn.serve_image_fp32",
                            trace=trace)
    assert rc == 0 and res is not None
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(res)[-1] == "check"
    assert isinstance(res["correct"], bool) and res["attempted"] > 0
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == {"restore_mp_per_s", "request_ms_p95",
                                       "setup_s"}
    for name, row in res["check"].items():
        assert set(row) == {"value", "limit"}
        assert f"check {name} " in err.strip().splitlines()[
            -len(res["check"]):][list(res["check"]).index(name)]
