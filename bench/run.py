"""Run one cell of the benchmark once and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted`` (turns sent in the window), ``failed``
(those that never got a first token), ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each number the
comparison with the reference judged, beside its limit (also the last
lines of standard error). Exits non-zero, printing no result, without
enough CUDA devices, without the program under test, or if JAX or the
JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402

# one process with few threads: no thread pool of the host's libraries
# spinning beside the serving loop's one Python thread
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _fail(code: int, msg: str):
    print(f"bench: {msg}", file=sys.stderr)
    raise SystemExit(code)


def loaded_forbidden(names=None) -> list[str]:
    """Top-level names among loaded modules (or ``names``) that are, whole,
    JAX's or the JAX package's."""
    tops = {m.split(".")[0] for m in (sys.modules if names is None
                                      else names)}
    return sorted(tops & set(FORBIDDEN))


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also judge the TF32 reference (the control)")
    args = ap.parse_args(argv)

    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    # every build and kernel cache at a fixed path inside the checkout (the
    # port's own nvcc build goes to build/repro_torch)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    from harness import spec
    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        _fail(2, f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}")
    try:
        import repro_torch  # noqa: F401
    except ImportError as err:
        _fail(3, f"the program under test is missing: {err}")
    from harness import runner, trace

    out = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda:0", T_START, control=bool(args.control))
    run = out["run"]
    bad = loaded_forbidden()
    if bad:
        _fail(4, f"JAX or the JAX package was loaded: {bad}")
    wanted = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": out["peak"]}
    result = {"correct": bool(out["correct"]),
              "attempted": run.window["attempted"],
              "failed": run.window["failed"], "metrics": metrics,
              "device": device}
    if args.trace and run.timeline is not None:
        tl = run.timeline
        device.update(busy_s=tl.busy_s, window_s=tl.window_s)
        result["breakdown"] = trace.breakdown(tl)
    nums = out["numbers"]
    info = {k: nums[k] for k in ("tokens", "kv_blocks", "ties", "gathers",
                                 "writes", "stamps", "times")}
    w = run.window
    host = {"tokens": w["tokens"], "seconds": w["seconds"],
            "slice_tokens": run.slice_tokens}
    for m in ("tokens_per_s", "itl_p95_ms", "ttft_p95_ms",
              "device_ms_per_token"):
        host[m] = spec.reader(m).read(run)
    print(json.dumps({"card": _power_limit(), "compared": info,
                      "control": nums.get("control"), "window": host}),
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    result["checks"] = out["checks"]
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
