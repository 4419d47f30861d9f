"""BENCHMARK.json against the benchmark's files: every cell's files found by
name, every metric read by a file of its own, names and keys in the
benchmark's format."""

import json
import re

import pytest

from port_bench.lib import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry = spec.workload(BENCH, cell)
    assert NAME.match(entry["config"]) and NAME.match(entry["traffic"]) and entry["chips"] in (1, 4)
    config = spec.configuration(BENCH, entry)
    traffic = spec.traffic(entry["traffic"])
    assert (spec.BENCH / "generators" / f"{traffic['generator']}.py").exists()
    assert config["name"] == entry["config"]
    limits = spec.limits(cell)
    assert limits and all(v >= 0 for v in limits.values())
    assert len(entry["why"]) <= 200
    assert any(m["name"] == "setup_s" for m in spec.end_to_end(BENCH, cell))
    assert len(spec.end_to_end(BENCH, cell)) >= 2 and spec.per_layer(BENCH, cell)


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(kind):
    for m in BENCH[kind]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        module = spec.metric(m["name"])
        assert callable(module.read)
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
            assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
            assert m["workloads"] and set(m["workloads"]) <= set(CELLS)
            reported = {c for c in CELLS if m["moves"] in {e["name"] for e in spec.end_to_end(BENCH, c)}}
            assert set(m["workloads"]) <= reported


def test_configs_used_and_files_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {c["config"] for c in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        data = json.loads((spec.ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] == []
        assert data["source"] == c["source"]


def test_one_layer_name_per_layer():
    for m in BENCH["per_layer"]:
        assert "\n" not in m["layer"] and "\t" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    assert {m["layer"] for m in BENCH["per_layer"] if m["name"].startswith("device_idle")} == {"device"}
    roofs = {m["layer"] for m in BENCH["per_layer"] if m["name"].split(".")[0] in ("frontend_roofline", "contrast_roofline")}
    assert len(roofs) == 1
