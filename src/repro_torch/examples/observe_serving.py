"""CREAM-Scope end to end: serve, corrupt the cheap tier, stay green.

Runs CREAM-Serve with the telemetry plane on. The KV pool is parity-laid:
batch-tier sessions get CREAM frames (parity — detect, not correct) and
paid-tier sessions get frames from the SECDED tail. Between turns we flip
one bit in every CREAM row — the cheap tier's storage — then scrub and
keep serving. The decode gather's status fold counts the parity
detections, the scrub census logs the corrupt lines, and the dashboard
shows the paper's contract holding: batch-tier errors are *counted but
tolerated* while the paid/SECDED reliability SLO stays green. Port of
``examples/observe_serving.py``.

Run: PYTHONPATH=src python -m repro_torch.examples.observe_serving [--device cpu]
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.layouts import Layout
from repro_torch.core.monitor import ErrorMonitor
from repro_torch.core.scrubber import scrub
from repro_torch.examples import parser
from repro_torch.kernels.common import resolve_device
from repro_torch.obs import dashboard, metrics, slo, tracing
from repro_torch.serve import Engine, ServeRequest
from repro_torch.vm import VirtualMemory

CONFIG = dict(name="observe-demo", family="dense", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
              head_dim=16, dtype="float32")
# Parity-laid pool: CREAM region [0, 48) detects-but-tolerates, SECDED
# tail [48, 64) is the paid tier's zero-uncorrectable contract.
NUM_ROWS, SECDED_ROWS = 64, 16


def main(argv=None, device=None) -> None:
    args = parser(__doc__).parse_args(argv)
    device = resolve_device(device if device is not None else args.device)
    cfg = ModelConfig(**CONFIG)

    metrics.enable()
    tracing.enable()

    vm = VirtualMemory(row_words=64, device=device)
    vm.add_pool("kv", NUM_ROWS, Layout.PARITY,
                boundary=NUM_ROWS - SECDED_ROWS)
    eng = Engine(cfg, max_batch=4, max_len=32, vm=vm, pool="kv",
                 mode="cream", device=device)
    # parity reclaims ≈ +10.7 % of the CREAM region; 3/4 of this pool is
    # CREAM, so the pool-wide floor is ~0.08 (48 · 0.107 / 64)
    slo.TRACKER.set_capacity_target("kv", 0.07)

    rng = np.random.default_rng(0)
    prompts = {f"s{i}": rng.integers(0, 256, size=8).astype(np.int32)
               for i in range(6)}
    tiers = {sid: "paid" if i % 2 else "batch"
             for i, sid in enumerate(prompts)}

    def turn(max_new):
        return [ServeRequest(sid, prompts[sid], max_new=max_new,
                             tier=tiers[sid]) for sid in prompts]

    print("turn 1: 6 sessions (3 paid on SECDED frames, 3 batch on parity)")
    eng.serve(turn(max_new=4))

    print("fault: flipping one bit in every CREAM row (batch-tier storage)")
    pool = eng.pool
    storage = pool.storage.clone()
    storage[:pool.boundary, 0, 0] ^= 1
    eng.vm.pools["kv"] = dataclasses.replace(pool, storage=storage)

    mon = ErrorMonitor()
    new_state, stats = scrub(eng.pool)
    eng.vm.pools["kv"] = new_state
    mon.record("kv", stats)
    print(f"scrub:  corrupt parity lines={stats.parity_corrupt_lines} "
          f"corrected={stats.corrected} "
          f"uncorrectable={stats.detected_uncorrectable}")

    print("turn 2: same sessions resume their parked (now corrupted) KV\n")
    eng.serve(turn(max_new=4))

    print(dashboard.render())

    by_scope = {s.scope: s for s in slo.TRACKER.report()}
    parity_hits = by_scope["class/parity"].value
    assert by_scope["class/secded"].ok, "paid-tier SLO must stay green"
    assert by_scope["class/parity"].ok, \
        "batch-tier errors tolerated by contract"
    assert parity_hits > 0, "batch-tier detections must be counted"
    print(f"contract held: {parity_hits:.0f} batch-tier (parity) detections "
          "counted and tolerated; paid/SECDED uncorrectable budget 0 intact; "
          f"{len(tracing.TRACER.events)} spans traced")


if __name__ == "__main__":
    main()
