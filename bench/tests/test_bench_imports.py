"""Nothing the benchmark runs imports JAX or the JAX package (compared by
whole top-level name: the port's name begins with the JAX package's), and
the references import nothing of the program."""
import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            tops.add(node.args[0].value.split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_by_whole_name(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = _imports(path)
    assert "repro_torch" not in tops and "harness" not in tops
    assert tops <= {"__future__", "importlib", "itertools", "numpy",
                    "torch", "reference"}


def test_prefix_is_not_a_match():
    import run
    assert run.loaded_forbidden(["repro_torch", "repro_torch.serve",
                                 "jaxtyping", "torch"]) == []
    assert run.loaded_forbidden(["repro.core", "jax._src", "flax",
                                 "jaxlib.xla"]) == ["flax", "jax", "jaxlib",
                                                    "repro"]


def test_a_whole_run_loads_no_jax(tmp_path):
    """Run a tiny cell in a fresh interpreter and look at ``sys.modules``."""
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(BENCH / 'tests')!r}, {str(BENCH)!r}, "
        f"{str(BENCH.parent / 'src')!r}]\n"
        "import conftest\n"
        "from harness import runner\n"
        "import run\n"
        "out = runner.run_cell(conftest.tiny_cell('olmoe'), 5, 0.5, False,"
        " 'cpu', time.perf_counter())\n"
        "print(run.loaded_forbidden(), out['correct'])\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[] True"


def test_no_result_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and bench/, run.py exits
    non-zero and prints no result."""
    root = BENCH.parent
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    res = subprocess.run(
        [sys.executable, *bench["command"][1:], "--workload",
         bench["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=tmp_path)
    assert res.returncode != 0
    assert '"correct"' not in res.stdout
