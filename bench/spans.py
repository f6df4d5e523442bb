"""Run one cell traced, with the program's own spans on for the slice, and
print where the card's time and idle go by program span.

    python3 bench/spans.py --workload <cell> --seed <n> --seconds <s> [--program 0|1]

from the root of a checkout. It runs ``bench/run.py --trace 1`` with
:class:`harness.spans.ProgramTracer` as the slice's tracer, so the lines
``bench/run.py`` prints come first, its result line among them; then one
JSON object: ``program`` (whether the program's tracer was on),
``readings`` (``engine.unpack_share``, ``model.attn_share``,
``model.moe_share``: device time launched inside those spans over the busy
time, %; ``engine.host_ms_per_step``), ``spans`` (device and idle seconds
by innermost program span, top 12), ``busy_s``, ``window_s``, and
``bench_step_ms``, the median of the harness's ``bench.step`` ranges
(there with ``--program 0`` too, for the cost of the program's tracer).
"""
from __future__ import annotations

import run  # bench/run.py: its environment, before torch is imported

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", required=True)
    ap.add_argument("--seconds", required=True)
    ap.add_argument("--program", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(run.HERE), str(run.ROOT / "src")]
    from harness import runner, spans
    spans.ProgramTracer.program = bool(args.program)
    runner._Tracer = spans.ProgramTracer
    rc = run.main(["--workload", args.workload, "--seed", args.seed,
                   "--seconds", args.seconds, "--trace", "1"])
    prog = spans.ProgramTracer.last
    if rc or prog is None:
        return rc or 1
    steps = prog.bench_steps_us
    print(json.dumps({
        "program": bool(args.program), "readings": prog.readings(),
        "spans": prog.by_span(), "busy_s": prog.tl.busy_s,
        "window_s": prog.tl.window_s,
        "bench_step_ms": statistics.median(steps) / 1e3 if steps else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
