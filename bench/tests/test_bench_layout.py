"""BENCHMARK.json and the files it names: every configuration, traffic
mix and metric reader is found by name, and every per-layer metric moves
an end-to-end metric that each of its cells reports."""
import json

import pytest

from bench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
END_TO_END = {"req_per_s", "p99_ms", "setup_s"}


def _cells(metric):
    every = [w["name"] for w in BENCH["workloads"]]
    return set(metric.get("workloads", every))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(cell):
    c = harness.load_cell(cell)
    assert c.traffic.batch > 0 and c.chips == 1
    assert {harness.base_name(m["name"]) for m in c.end_to_end} <= END_TO_END
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert c.per_layer


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=[m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_has_its_reader_and_moves_its_cells(metric):
    assert callable(harness.metric_reader(metric["name"]))
    moved = [m for m in BENCH["end_to_end"] if m["name"] == metric["moves"]]
    assert moved and _cells(metric) <= _cells(moved[0])
    if metric["name"] != harness.base_name(metric["name"]):
        assert metric["moves"].endswith(metric["name"][len(
            harness.base_name(metric["name"])):])
