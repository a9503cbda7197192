"""BENCHMARK.json against the contract's shape, and every piece of every
cell found by name; a new cell and a new metric come from new files
alone."""
import json
import re
import shutil

import pytest

from ocr_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


def test_keys_and_names():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter",
                                                     "host_clock")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_piece_of_a_cell_is_found(cell):
    p = harness.find_cell(BENCH, cell)
    assert hasattr(harness.driver_of(p), "run")
    assert p["limits"] and all(isinstance(v, (int, float)) for v in p["limits"].values())
    assert any(m["name"] == "setup_s" for m in p["e2e"]) and len(p["e2e"]) >= 2
    assert p["per_layer"]
    for m in p["per_layer"]:
        assert hasattr(harness.reader_of(p, m["name"]), "read")
        assert cell in m["workloads"]
        assert m["moves"] in {e["name"] for e in p["e2e"]}


def test_a_new_cell_and_metric_come_from_new_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "ocr_bench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    first = bench["workloads"][0]
    bench["workloads"].append(dict(first, name="dummy_cell", traffic="dummy_mix"))
    bench["per_layer"].append({"name": "dummy_metric", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "host prep",
                               "moves": bench["per_layer"][0]["moves"], "workloads": ["dummy_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = harness.load_json(harness.BENCH / "traffic" / f"{first['traffic']}.json")
    (root / "ocr_bench" / "traffic" / "dummy_mix.json").write_text(json.dumps(dict(mix, pool=3)))
    (root / "ocr_bench" / "limits" / "dummy_cell.json").write_text('{"map_err": 0.5}')
    (root / "ocr_bench" / "metrics" / "dummy_metric.py").write_text("def read(rec):\n    return 42.0\n")
    p = harness.find_cell(bench, "dummy_cell", root=root)
    assert p["traffic"]["pool"] == 3 and p["limits"] == {"map_err": 0.5}
    assert [m["name"] for m in p["per_layer"]] == ["dummy_metric"]
    assert harness.reader_of(p, "dummy_metric").read({}) == 42.0
    assert p["dir"] == root / "ocr_bench"
