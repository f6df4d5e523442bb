"""The control: the reference in TF32, put in the program's place, comes
out not correct where the program does. On the CPU at a tiny size; on
the card at each cell's own size (``card`` tests, run there with
``python3 -m pytest -q bench/tests -m card``)."""
import json
import subprocess
import sys
import time

import pytest

from conftest import tiny_cell
from harness import runner, spec

SEED = 2**32 + 17
CELLS = [w["name"] for w in json.loads(
    (spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _fails(nums: dict, limits: dict) -> list[str]:
    return [k for k, v in nums.items() if k in limits and v > limits[k]]


@pytest.mark.parametrize("family", ["olmoe", "starcoder2"])
def test_control_fails_where_the_program_passes(family):
    cell = tiny_cell(family)
    out = runner.run_cell(cell, SEED, 1.0, False, "cpu",
                          time.perf_counter(), control=True)
    limits = cell.workload["limits"]
    assert out["correct"]
    failed = _fails(out["numbers"]["control"], limits)
    assert {"kv_err", "logit_err"} <= set(failed)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(card, cell):
    """A short window of the cell at its own size: the program correct,
    the control over a limit."""
    res = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "5", "--trace", "0", "--control", "1"],
        capture_output=True, text=True, timeout=900, cwd=spec.ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    result = json.loads(res.stdout.strip().splitlines()[-1])
    assert result["correct"]
    info = json.loads([ln for ln in res.stderr.splitlines()
                       if ln.startswith('{"card"')][-1])
    limits = spec.load_cell(cell).workload["limits"]
    assert _fails(info["control"], limits)
