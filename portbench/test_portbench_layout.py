"""BENCHMARK.json against the benchmark's contract, and a cell's files found
by name: a cell added with nothing but a traffic file and an entry runs."""

import json
import re

import pytest

from portbench import harness
from portbench.conftest import PACKAGE, ROOT, write_root

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = len(SPEC["workloads"])
    # a full check of 24 cells fits the driver's 43,200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24


def test_names_units_and_lengths():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in SPEC["configs"] + SPEC["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]


def test_configs_files_and_reduced():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank", "_size")), key
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_metrics_and_cells():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and (PACKAGE / "metrics" / f"{m['name']}.py").exists()
        layers.setdefault(m["layer"], []).append(m["name"])
        for w in m["workloads"]:
            cell = harness.load_cell(ROOT, w)
            assert m["moves"] in [x["name"] for x in cell.end_to_end]
    for w in SPEC["workloads"]:
        assert w["chips"] == 1
        cell = harness.load_cell(ROOT, w["name"])
        reported = [x["name"] for x in cell.end_to_end]
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        assert (PACKAGE / "drivers" / f"{cell.traffic['kind']}.py").exists()


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_found_by_name(name):
    cell = harness.load_cell(ROOT, name)
    w = {x["name"]: x for x in SPEC["workloads"]}[name]
    assert cell.config["name"] == w["config"]
    assert cell.traffic == json.loads((PACKAGE / "traffic" / f"{w['traffic']}.json").read_text())
    assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())


def test_a_cell_added_as_data_alone_runs(tmp_path, capsys):
    """qwen3-8b.prefill-long: its traffic file and an entry, no code."""
    entry = {"name": "qwen3-8b.prefill-long", "config": "qwen3-8b", "traffic": "prefill-long",
             "chips": 1, "why": "one long prompt at a time"}
    root, spec = write_root(tmp_path, [entry])
    cell = harness.load_cell(root, entry["name"])
    assert cell.traffic["kind"] == "batched_prefill"
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
    next(m for m in spec["end_to_end"]
         if m["name"] == "prompt_tokens_per_s")["workloads"].append(entry["name"])
    rc = harness.main(["--workload", entry["name"], "--seed", "7", "--seconds", "0.2"],
                      root=root, spec=spec, device="cpu")
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["correct"] and out["attempted"] > 0
    assert set(out["metrics"]) == {"prompt_tokens_per_s", "setup_s"}


@pytest.mark.parametrize("path", sorted((PACKAGE / "limits").glob("*.json")), ids=lambda p: p.stem)
def test_each_limit_lies_between_its_readings(path):
    """A limit sits above the largest reading of sound runs on the card and
    below the least reading of the control or fault that it has to catch,
    with more room above the first; an exact comparison has the limit 0."""
    f = json.loads(path.read_text())
    assert set(f["readings"]) == set(f["limits"])
    for k, limit in f["limits"].items():
        lower, upper = f["readings"][k]["lower"], f["readings"][k]["upper"]
        assert lower <= limit < upper, k
        if limit:
            assert upper >= 3 * lower and limit / lower > upper / limit > 1, k
        else:
            assert lower == 0, k
