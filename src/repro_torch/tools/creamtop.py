"""creamtop — the CREAM-Scope terminal dashboard.

Port of ``tools/creamtop.py``. Renders the SLO verdicts + metric sections
from one of three sources:

  * ``--bench BENCH_<suite>.json`` — the ``_metrics`` blob a benchmark
    run embedded into its suite file (plus the CREAM-Lens bank heatmap
    when the file also carries a ``_memprof`` blob);
  * ``--snapshot metrics.json`` — a raw ``repro_torch.obs.metrics.collect()``
    (or reference ``collect()``) dump;
  * ``--demo`` — run a small live CREAM-Serve workload under scrubbing
    with error injection and render the live registry/tracker (the
    scenario of ``examples/observe_serving.py``, smaller). It runs on the
    card unless given ``--device cpu``; without a card it raises.

Usage::

    PYTHONPATH=src python -m repro_torch.tools.creamtop --snapshot m.json
    PYTHONPATH=src python -m repro_torch.tools.creamtop --demo
"""
from __future__ import annotations

import argparse
import json

#: The demo's model: the serving tests' two-layer dense decoder.
DEMO_CONFIG = dict(name="creamtop-demo", family="dense", num_layers=2,
                   d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                   vocab_size=256, head_dim=16, dtype="float32")


def demo(device=None) -> str:
    """A small live serving run: six sessions on paid and batch tiers, a
    turn, single-bit flips planted in the SECDED rows, a second turn that
    reads the sessions' KV back through the corrected gather, then a
    scrub recorded by the monitor; returns the rendered dashboard."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import injection
    from repro_torch.core.monitor import ErrorMonitor
    from repro_torch.kernels.common import resolve_device
    from repro_torch.obs import dashboard, metrics, tracing
    from repro_torch.serve import Engine, ServeRequest

    device = resolve_device(device)     # refuse a missing card first
    metrics.enable()
    tracing.enable()
    eng = Engine(ModelConfig(**DEMO_CONFIG), max_batch=4, max_len=32,
                 num_rows=64, secded_rows=16, device=device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=8).astype(np.int32)
               for _ in range(6)]

    def turn() -> list:
        return [ServeRequest(f"s{i}", p, 4, tier="paid" if i % 2 else "batch")
                for i, p in enumerate(prompts)]

    eng.serve(turn())
    pool = eng.pool
    storage, _ = injection.inject_flips(pool.storage, rng, n_flips=64,
                                        row_range=(pool.boundary,
                                                   pool.num_rows))
    eng.vm.pools[eng.pool_name] = dataclasses.replace(pool, storage=storage)
    eng.serve(turn())
    new_state, stats = eng.pool.scrub()
    eng.vm.pools[eng.pool_name] = new_state
    ErrorMonitor().record(eng.pool_name, stats)
    return dashboard.render()


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--bench", metavar="BENCH_JSON",
                     help="BENCH_<suite>.json with an embedded _metrics blob")
    src.add_argument("--snapshot", metavar="METRICS_JSON",
                     help="a metrics.collect() JSON dump")
    src.add_argument("--demo", action="store_true",
                     help="run a small live serving demo and render it")
    ap.add_argument("--device", default=None,
                    help="the demo's device (default: cuda)")
    args = ap.parse_args(argv)
    if args.demo:
        print(demo(args.device))
        return
    from repro_torch.obs import dashboard
    path = args.bench or args.snapshot
    with open(path) as f:
        blob = json.load(f)
    snap = blob.get("_metrics") if args.bench else blob
    memprof = blob.get("_memprof") if args.bench else None
    if not isinstance(snap, dict) and not isinstance(memprof, dict):
        raise SystemExit(
            f"{path}: no _metrics/_memprof blob "
            "(run the benchmark with its profile and/or memprof planes on)")
    if isinstance(snap, dict):
        print(dashboard.render(snap=snap, statuses=[]))
    if isinstance(memprof, dict):
        # CREAM-Lens bank panel: per-profile chip x bank heatmaps
        print(dashboard.render_bank_heatmap(memprof))


if __name__ == "__main__":
    main()
