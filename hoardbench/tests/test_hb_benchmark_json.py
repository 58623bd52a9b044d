"""BENCHMARK.json against the contract's shapes, and every file it names."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ALL_METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["hoardbench"]
    assert BENCH["command"] == ["python3", "hoardbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_plain(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


@pytest.mark.parametrize("metric", ALL_METRICS, ids=lambda m: m["name"])
def test_metric_shape(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    metrics = ROOT / "hoardbench" / "metrics"
    assert (metrics / f"{metric['name']}.py").is_file() or \
        (metrics / f"{metric['name'].rsplit('.', 1)[0]}.py").is_file()
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert metric["layer"] and "\n" not in metric["layer"] and len(metric["layer"]) <= 200
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves",
                               "workloads"}
    for w in metric.get("workloads", []):
        assert w in {c["name"] for c in BENCH["workloads"]}


def test_setup_is_an_end_to_end_metric():
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_cell_of_a_layer_metric_reports_what_it_moves(metric):
    moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
    assert set(metric["workloads"]) <= set(moved.get("workloads", metric["workloads"]))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    assert NAME.match(cell["traffic"]) and cell["chips"] in (1, 4)
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    assert (ROOT / "hoardbench" / "traffic" / f"{cell['traffic']}.json").is_file()
    limits = json.loads((ROOT / "hoardbench" / "limits" / f"{cell['name']}.json").read_text())
    assert limits["data_mismatches"] == 0
    assert {"loss_gap", "grad_gap", "change_gap"} <= set(limits)
    assert any(limits[k] is not None for k in ("loss_gap", "grad_gap", "grad_diff")
               if k in limits)
    reported = {m["name"] for m in ALL_METRICS if cell["name"] in m.get("workloads",
                                                                        [cell["name"]])}
    assert "setup_s" in reported and len(reported & {m["name"] for m in BENCH["per_layer"]})


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert config["file"].startswith("hoardbench/configs/")
    body = json.loads((ROOT / config["file"]).read_text())
    assert body["name"] == config["name"] and body["source"] == config["source"]
    assert body["reduced"] == config["reduced"] and len(config["reduced"]) <= 16
    assert all(NAME.match(k) for k in config["reduced"])
    assert "assumed" in body and "deployment" in body
    widths = re.compile(r"(_dim|_rank)$|^(hidden_size|intermediate_size|moe_intermediate_size|"
                        r"num_experts_per_tok|head_dim|state_size)$|expan")
    assert not [k for k in config["reduced"] if widths.search(k)]
    assert config["name"] in {w["config"] for w in BENCH["workloads"]}
