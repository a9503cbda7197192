"""A whole run of each cell on the CPU at a tiny size (the look for a chip
skipped): the result line's keys and types, traced and not."""
import json

import pytest
import torch

from ocr_bench import harness
from ocr_bench.tests import tiny

CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell, trace, capsys):
    ctx, p = tiny.ctx(cell, seconds=2.0, trace=trace)
    line = harness.run_cell(ctx, p)
    harness.emit(line)
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert list(last)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(last)
    assert isinstance(last["correct"], bool) and last["correct"], last
    assert isinstance(last["attempted"], int) and last["attempted"] > 0 and last["failed"] == 0
    assert set(last["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in last["checks"].values():
        assert set(c) == {"value", "limit"}
    assert err.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert last["device"]["window_s"] > 0 and "breakdown" in last
        assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
        # the CPU has no device: the readers of device metrics find nothing
        assert all(not k.startswith(("idle_share", "mfu")) for k in last["metrics"])
    else:
        assert set(last["metrics"]) == {m["name"] for m in p["e2e"]}
        for m in last["metrics"].values():
            assert m["value"] > 0 and isinstance(m["unit"], str)

