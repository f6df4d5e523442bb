"""The harness of ``tests/test_torch_examples_*.py``: run a reference
script of ``examples/`` and its port ``repro_torch.examples.<name>`` on
the CPU, and compare what they print line for line.

The reference runs in a subprocess under ``JAX_PLATFORMS=cpu`` (the repo
root and ``src`` on its path); the port's ``main(argv, device="cpu")``
runs in the test's process with its standard output captured and every
telemetry plane reset around it. Only numbers measured by a clock are
masked (``serve_kv_cream``'s tokens/s and p99, ``train_lm``'s tok/s),
and ``train_lm``'s two loss values, which come from each package's own
random weights: they are checked finite and masked alike.
"""
from __future__ import annotations

import contextlib
import importlib
import io
import math
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: (pattern, replacement) per example: the clock's numbers only
CLOCK = {
    "serve_kv_cream": [(r"tokens/s=\s*[0-9.]+", "tokens/s=<clock>"),
                       (r"p99=\s*[0-9.]+ms", "p99=<clock>ms")],
    "train_lm": [(r"\| \d+ tok/s \|", "| <clock> tok/s |")],
}
LOSS = re.compile(r"^loss (\S+) -> (\S+) \|")


def reset_planes() -> None:
    """Every telemetry plane of the port off and empty."""
    from repro_torch import obs
    obs.metrics.disable()
    obs.metrics.REGISTRY.clear()
    obs.tracing.reset()
    obs.memprof.disable()
    obs.memprof.clear()
    obs.slo.TRACKER.reset()


def run_reference(name: str, args: list[str], timeout: float = 600) -> str:
    """``python examples/<name>.py *args`` on the CPU -> its stdout."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, str(ROOT / "examples" /
                                               f"{name}.py"), *args],
                          capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def run_port(name: str, args: list[str], device: str = "cpu",
             events: list | None = None) -> str:
    """``repro_torch.examples.<name>.main(args, device)`` -> its stdout;
    ``events``, if given, receives the tracer's events."""
    from repro_torch import obs
    module = importlib.import_module(f"repro_torch.examples.{name}")
    out = io.StringIO()
    reset_planes()
    try:
        with contextlib.redirect_stdout(out):
            module.main(args, device=device)
        if events is not None:
            events.extend(obs.tracing.TRACER.events)
    finally:
        reset_planes()
    return out.getvalue()


def masked(name: str, text: str) -> list[str]:
    """``text``'s lines with the clock's numbers (and ``train_lm``'s loss
    values, checked finite) masked."""
    lines = []
    for line in text.splitlines():
        for pattern, repl in CLOCK.get(name, ()):
            line = re.sub(pattern, repl, line)
        m = LOSS.match(line) if name == "train_lm" else None
        if m:
            assert all(math.isfinite(float(v)) for v in m.groups()), line
            line = LOSS.sub("loss <loss> -> <loss> |", line)
        lines.append(line)
    return lines


def assert_same_output(name: str, port: str, ref: str) -> None:
    got, want = masked(name, port), masked(name, ref)
    assert got == want, "\n".join(
        f"port: {g!r}\nref:  {w!r}" for g, w in zip(got, want) if g != w) \
        or f"{len(got)} lines != {len(want)} lines"
