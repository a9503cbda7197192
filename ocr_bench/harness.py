"""One run of one cell: find its pieces by name, run its driver, check its
outputs, print the result line.

Everything of a cell is found by the names in ``BENCHMARK.json``:

* the configuration: the file its ``configs`` entry names;
* the traffic: ``ocr_bench/traffic/<traffic>.json``, whose ``driver`` names
  ``ocr_bench/drivers/<driver>.py``;
* the limits of the check: ``ocr_bench/limits/<cell>.json``;
* each per-layer metric: ``ocr_bench/metrics/<metric>.py``, whose
  ``read(records)`` returns a number, or None where it finds nothing.

A driver's ``run(ctx)`` sets up, calls ``ctx.run_window`` and returns a
dict: ``e2e`` (its end-to-end numbers), ``attempted``, ``failed``,
``memory_peak_bytes``, ``records`` (what the metric readers read),
``numbers`` (the checked numbers) and ``complete`` (whether the check had
something to read).
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "lightly_ocr_tpu")
CACHE = ROOT / "build" / "ocr_bench"


def process_start() -> float:
    """Wall-clock time at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def set_cache_dirs() -> None:
    """Build and kernel caches in fixed directories inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The cell's pieces, found by name under the checkout ``root``: {cell,
    config, traffic, limits, e2e, per_layer, dir}."""
    here = root / BENCH.name
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    traffic = load_json(here / "traffic" / f"{cell['traffic']}.json")

    def mine(m):
        return name in m.get("workloads", [name])

    return {"cell": cell, "config": load_json(root / conf["file"]), "traffic": traffic,
            "limits": load_json(here / "limits" / f"{name}.json"),
            "e2e": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)], "dir": here}


def driver_of(pieces: dict):
    name = pieces["traffic"]["driver"]
    return load_module(pieces["dir"] / "drivers" / f"{name}.py", f"ocr_bench_driver_{name}")


def reader_of(pieces: dict, metric: str):
    return load_module(pieces["dir"] / "metrics" / f"{metric}.py",
                       "ocr_bench_metric_" + metric.replace(".", "_"))


def imported_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Ctx:
    """What a driver gets: the cell's pieces and the window's clock.  In a
    traced run the profiler covers the window's first ``trace_seconds``."""

    def __init__(self, pieces: dict, seed: int, seconds: float, trace: bool, device: str,
                 started: float):
        self.cell = pieces["cell"]
        self.config, self.traffic, self.limits = pieces["config"], pieces["traffic"], pieces["limits"]
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self.started = started
        self.setup_s = None
        self.t0 = self.t1 = None
        self.traced = None  # (start, end) of the traced part, perf_counter
        self.events = None
        self.control = False  # also read the control's numbers (controls.py)
        self._prof = self._span = None

    def start_window(self) -> None:
        """Set-up ends here; in a traced run the profiler starts first."""
        import torch

        if self.trace:
            from ocr_bench import trace

            self._path = os.path.join(tempfile.gettempdir(), f"ocr_bench_trace_{os.getpid()}.json")
            self._prof = trace.profiled(self._path)
            self._box = self._prof.__enter__()
            self._span = torch.profiler.record_function(trace.WINDOW)
        self.setup_s = time.time() - self.started
        self.t0 = time.perf_counter()
        self.t1 = self.t0 + self.seconds
        if self._span is not None:
            self._span.__enter__()

    def run_window(self, fn):
        """Start the window, run ``fn(t0, t1)``, wait for its end, and
        return (t0, t1, the traced part or None)."""
        self.start_window()
        fn(self.t0, self.t1)
        self.sleep_until(self.t1)
        return self.t0, self.t1, self.traced

    def poll(self) -> None:
        """End the traced part once its time has come."""
        if self._span is None:
            return
        end = self.t0 + min(self.seconds, float(self.traffic["trace_seconds"]))
        if time.perf_counter() >= end:
            self._span.__exit__(None, None, None)
            self.traced = (self.t0, time.perf_counter())
            self._span = None
            self._prof.__exit__(None, None, None)
            self.events = self._box["events"]

    def sleep_until(self, t: float) -> None:
        if self._span is not None:
            end = self.t0 + min(self.seconds, float(self.traffic["trace_seconds"]))
            time.sleep(max(0.0, min(end, t) - time.perf_counter()))
            self.poll()
        time.sleep(max(0.0, t - time.perf_counter()))


def number(x: float):
    return float(x) if math.isfinite(float(x)) else None


def main(argv=None) -> int:
    import argparse

    started = process_start()
    set_cache_dirs()
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    pieces = find_cell(load_json(ROOT / "BENCHMARK.json"), a.workload)

    import torch

    chips = int(pieces["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"ocr_bench: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: nothing run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    ctx = Ctx(pieces, a.seed, a.seconds, bool(a.trace), "cuda", started)
    result = run_cell(ctx, pieces)
    bad = imported_forbidden()
    if bad:
        print(f"ocr_bench: modules of {bad} are loaded in the measuring process", file=sys.stderr)
        return 3
    emit(result)
    return 0


def run_cell(ctx: Ctx, pieces: dict) -> dict:
    """Run the cell's driver and build the result line."""
    import torch

    traffic = pieces["traffic"]
    driver = driver_of(pieces)
    if ctx.config.get("tf32") is not None:  # else PyTorch's defaults, as users run it
        torch.backends.cuda.matmul.allow_tf32 = bool(ctx.config["tf32"])
        torch.backends.cudnn.allow_tf32 = bool(ctx.config["tf32"])
    out = driver.run(ctx)
    checks = {}
    for name, limit in ctx.limits.items():
        checks[name] = {"value": out["numbers"].get(name), "limit": limit}
    correct = out["complete"] and all(c["value"] is not None and c["value"] <= c["limit"]
                                      for c in checks.values())
    metrics, device = {}, {
        "platform": "gpu" if ctx.device == "cuda" else ctx.device,
        "kind": torch.cuda.get_device_name(0) if ctx.device == "cuda" else "cpu",
        "count": int(ctx.cell["chips"]),
        "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = {"correct": bool(correct), "attempted": int(out["attempted"]), "failed": int(out["failed"])}
    if ctx.trace:
        from ocr_bench.trace import Trace

        tr = Trace(ctx.events)
        records = dict(out["records"], trace=tr, config=ctx.config, traffic=traffic)
        for m in pieces["per_layer"]:
            v = reader_of(pieces, m["name"]).read(records)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        line["breakdown"] = tr.breakdown()
    else:
        values = dict(out["e2e"], setup_s=ctx.setup_s)
        for m in pieces["e2e"]:
            metrics[m["name"]] = {"value": number(values[m["name"]]), "unit": m["unit"]}
    line.update(metrics=metrics, device=device)
    if not out["complete"]:
        line["incomplete"] = out["why_incomplete"]
    line["checks"] = checks
    return line


def emit(line: dict) -> None:
    """The checked numbers beside their limits on standard error, then the
    result as the last line of standard output."""
    print(f"correct: {line['correct']}" + (f" ({line['incomplete']})" if "incomplete" in line else ""),
          file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
