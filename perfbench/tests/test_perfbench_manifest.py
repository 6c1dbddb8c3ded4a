"""``BENCHMARK.json`` against the contract's rules on names and units, and
every piece it names present under ``perfbench/``."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
HERE = ROOT / "perfbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELL_NAMES = [c["name"] for c in BENCH["workloads"]]


def reported(metric: dict) -> list[str]:
    return metric.get("workloads", CELL_NAMES)


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("name", [m["name"] for m in METRICS] + CELL_NAMES
                         + [c["name"] for c in BENCH["configs"]]
                         + [c["traffic"] for c in BENCH["workloads"]]
                         + [k for c in BENCH["configs"] for k in c["reduced"]])
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    allowed = {"name", "unit", "better", "source", "workloads"}
    if metric in BENCH["end_to_end"]:
        allowed |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert set(metric) <= allowed
    assert set(reported(metric)) <= set(CELL_NAMES)
    if metric["unit"] == "%" and ("roofline" in metric["name"] or "mfu" in metric["name"]):
        assert metric["better"] == "higher"


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_cells_report_what_they_move(metric):
    moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
    assert set(reported(metric)) <= set(reported(moved))
    assert (HERE / "metrics" / f"{metric['name']}.py").is_file()


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_every_configuration_has_a_cell_and_a_file(config):
    assert any(c["config"] == config["name"] for c in BENCH["workloads"])
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and data["reduced"] == config["reduced"]
    assert (HERE / "families" / f"{data['family']}.py").is_file()
    assert (HERE / "reference" / f"{data['family']}.py").is_file()


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_every_cell_is_complete(cell):
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (HERE / "loops" / f"{traffic['loop']}.py").is_file()
    assert (HERE / "limits" / f"{cell['name']}.json").is_file()
    names = {m["name"] for m in METRICS if cell["name"] in reported(m)}
    assert "setup_s" in names
    assert any(m["name"] != "setup_s" and cell["name"] in reported(m) for m in BENCH["end_to_end"])
    assert any(cell["name"] in reported(m) for m in BENCH["per_layer"])


def test_layers_are_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers
