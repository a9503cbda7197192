"""Nothing the benchmark imports is JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the program."""
import ast
import subprocess
import sys
from pathlib import Path

from ocr_bench import harness

BENCH = harness.BENCH


def top_imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_the_check_compares_whole_top_level_names(monkeypatch):
    before = set(harness.imported_forbidden())
    monkeypatch.setitem(sys.modules, "lightly_ocr_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert set(harness.imported_forbidden()) == before
    monkeypatch.setitem(sys.modules, "lightly_ocr_tpu.models", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert set(harness.imported_forbidden()) == before | {"lightly_ocr_tpu", "jaxlib"}


def test_no_source_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert not top_imports(path) & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in list((BENCH / "reference").glob("*.py")) + list((BENCH / "counts").glob("*.py")):
        assert "lightly_ocr_tpu_torch" not in top_imports(path), path


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); from ocr_bench import harness, serving, check_serving, "
            "check_training, trace; from ocr_bench.drivers import serve_closed, train_loop; "
            "import lightly_ocr_tpu_torch.serving.batch, lightly_ocr_tpu_torch.train.trainer; "
            "print(harness.imported_forbidden())" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
