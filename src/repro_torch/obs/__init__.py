"""CREAM-Scope — the telemetry plane (port of ``repro/obs``).

All host-side control plane; the device's share is the small per-page
status the serving step's mixed read already computes, reduced to a
per-class count matrix and *folded* into the registry between steps:

  * :mod:`.metrics` — a process-global registry of counters / gauges /
    histograms with labelled series (pool, reliability class, tier,
    region), a Prometheus-style text exposition, and the fold helpers;
  * :mod:`.tracing` — nestable spans with a Perfetto / chrome-tracing
    JSON exporter on the named hot paths (``Engine.step``
    gather/compute/scatter, the router dispatch, the sharded pool's
    dispatches and migration, ``repartition_with_migration``, scrub
    sweeps, objcache batched get/set) and, beyond the reference's, at the
    serving step's and the model's boundaries (``engine.poll``,
    ``sched.tick``, ``engine.step`` and its ``.unpack`` / ``.model`` /
    ``.insert`` / ``.readback``, ``engine.prefill.model`` / ``.pack`` /
    ``.write``, ``model.attn`` / ``.mlp`` / ``.moe`` / ``.head``); every
    span is stamped on the torch profiler's clock (``tracing.now_us``,
    Unix time) and is a ``record_function`` range, so the profiler charges
    the device operations launched inside it to it; blocking spans wait
    for their device work with CUDA events, except under the profiler;
  * :mod:`.slo` + :mod:`.dashboard` — per-reliability-class SLO tracking
    (uncorrectable reads on SECDED frames must be 0; capacity reclaimed
    rides the boundary register) and a terminal snapshot dashboard
    (``python -m repro_torch.tools.creamtop``);
  * :mod:`.memprof` — CREAM-Lens, the bank-level memory-system profiler:
    captures the data plane's page-access streams, attributes them to
    (chip, bank, row) via the layout translation, and replays them
    through the per-bank state machines of :mod:`.dram_sim`.

Everything but the SLO tracker is opt-in: with the planes disabled (the
default) every instrumentation site reduces to one boolean check, and a
decode step launches what it launches without them. The tracker is always
fed (scrub censuses, the read-status fold, pool capacity).
"""
from repro_torch.obs import dashboard, memprof, metrics, slo, tracing

__all__ = ["metrics", "tracing", "slo", "dashboard", "memprof"]
