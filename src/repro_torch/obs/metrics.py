"""Process-global metrics registry: counters, gauges, histograms.

Port of ``repro/obs/metrics.py`` (pure Python; the port keeps its own
copy). Metric names (``NAME_*``), label sets and the ``collect()`` /
``snapshot()`` formats are the reference's, catalogued in
``docs/observability.md``.

  * **host-only** — series hold python floats. Device code never touches
    the registry; the serving step's read-status count matrix is a small
    ``(len(FOLD_CLASSES), 2)`` tensor, folded here *between* steps with
    one device-to-host copy (:func:`fold_read_status`);
  * **near-zero cost when disabled** — every instrumentation site guards
    on :func:`enabled` (one module-level boolean read); handle methods
    check it again so even un-guarded call sites stay cheap;
  * **labelled series** — ``metric.labels(pool="kv", cls="secded")``
    returns a cached handle; label values become part of the series key.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

_LOCK = threading.Lock()

#: Default histogram bucket upper bounds, in microseconds (latency-shaped).
DEFAULT_BUCKETS = (10.0, 50.0, 100.0, 500.0, 1000.0, 5000.0, 10000.0,
                   50000.0, 100000.0, float("inf"))


@dataclass
class _Series:
    """One (metric, label-values) time series."""
    value: float = 0.0                       # counter / gauge
    count: int = 0                           # histogram observations
    sum: float = 0.0
    buckets: list[int] = field(default_factory=list)


class Handle:
    """A series bound to concrete label values; the object call sites hold."""

    __slots__ = ("_metric", "_series")

    def __init__(self, metric: "Metric", series: _Series):
        self._metric = metric
        self._series = series

    def inc(self, n: float = 1.0) -> None:
        if not self._metric.registry.enabled:
            return
        if self._metric.kind != "counter":
            raise TypeError(f"{self._metric.name} is a {self._metric.kind}")
        if n < 0:
            raise ValueError("counters only go up")
        self._series.value += float(n)

    def set(self, v: float) -> None:
        if not self._metric.registry.enabled:
            return
        if self._metric.kind != "gauge":
            raise TypeError(f"{self._metric.name} is a {self._metric.kind}")
        self._series.value = float(v)

    def observe(self, v: float) -> None:
        if not self._metric.registry.enabled:
            return
        if self._metric.kind != "histogram":
            raise TypeError(f"{self._metric.name} is a {self._metric.kind}")
        v = float(v)
        s = self._series
        s.count += 1
        s.sum += v
        for i, ub in enumerate(self._metric.buckets):
            if v <= ub:
                s.buckets[i] += 1
                break

    @property
    def value(self) -> float:
        return self._series.value


class Metric:
    """A named metric family; concrete series come from :meth:`labels`."""

    def __init__(self, registry: "Registry", name: str, kind: str,
                 help: str = "", labelnames: tuple[str, ...] = (),
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        self.registry = registry
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets)
        self._series: dict[tuple[str, ...], _Series] = {}
        self._handles: dict[tuple[str, ...], Handle] = {}

    def labels(self, **kv: str) -> Handle:
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != "
                f"declared {sorted(self.labelnames)}")
        key = tuple(str(kv[ln]) for ln in self.labelnames)
        h = self._handles.get(key)
        if h is None:
            with _LOCK:
                s = self._series.get(key)
                if s is None:
                    s = _Series(buckets=[0] * len(self.buckets))
                    self._series[key] = s
                h = self._handles.setdefault(key, Handle(self, s))
        return h

    # unlabelled convenience (metrics declared with no label names)
    def inc(self, n: float = 1.0) -> None:
        self.labels().inc(n)

    def set(self, v: float) -> None:
        self.labels().set(v)

    def observe(self, v: float) -> None:
        self.labels().observe(v)

    @property
    def series(self) -> dict[tuple[str, ...], _Series]:
        return self._series


class Registry:
    """A metric namespace. The process-global one is :data:`REGISTRY`."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._metrics: dict[str, Metric] = {}

    # -- declaration ---------------------------------------------------------
    def _declare(self, name: str, kind: str, help: str,
                 labels: tuple[str, ...],
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Metric:
        with _LOCK:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind or m.labelnames != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} re-declared as {kind}{labels} "
                        f"(was {m.kind}{m.labelnames})")
                return m
            m = Metric(self, name, kind, help, labels, buckets)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labels: tuple[str, ...] = ()) -> Metric:
        return self._declare(name, "counter", help, tuple(labels))

    def gauge(self, name: str, help: str = "",
              labels: tuple[str, ...] = ()) -> Metric:
        return self._declare(name, "gauge", help, tuple(labels))

    def histogram(self, name: str, help: str = "",
                  labels: tuple[str, ...] = (),
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Metric:
        return self._declare(name, "histogram", help, tuple(labels), buckets)

    # -- lifecycle -----------------------------------------------------------
    def reset(self) -> None:
        """Zero every series (registrations and label sets survive)."""
        with _LOCK:
            for m in self._metrics.values():
                for s in m.series.values():
                    s.value = 0.0
                    s.count = 0
                    s.sum = 0.0
                    s.buckets = [0] * len(m.buckets)

    def clear(self) -> None:
        """Drop every metric (a fresh namespace)."""
        with _LOCK:
            self._metrics.clear()

    # -- export --------------------------------------------------------------
    def collect(self) -> dict:
        """JSON-friendly snapshot: {name: {kind, help, series: [...]}}."""
        out: dict = {}
        for name, m in sorted(self._metrics.items()):
            rows = []
            for key, s in sorted(m.series.items()):
                labels = dict(zip(m.labelnames, key))
                if m.kind == "histogram":
                    rows.append({"labels": labels, "count": s.count,
                                 "sum": s.sum,
                                 "buckets": dict(zip(
                                     (str(b) for b in m.buckets),
                                     s.buckets))})
                else:
                    rows.append({"labels": labels, "value": s.value})
            out[name] = {"kind": m.kind, "help": m.help, "series": rows}
        return out

    def snapshot(self) -> str:
        """Prometheus-style text exposition (the testable wire format)."""
        lines: list[str] = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for key, s in sorted(m.series.items()):
                lab = ",".join(f'{ln}="{lv}"'
                               for ln, lv in zip(m.labelnames, key))
                suffix = "{" + lab + "}" if lab else ""
                if m.kind == "histogram":
                    cum = 0
                    for ub, b in zip(m.buckets, s.buckets):
                        cum += b
                        le = "+Inf" if ub == float("inf") else f"{ub:g}"
                        blab = (lab + "," if lab else "") + f'le="{le}"'
                        lines.append(f"{name}_bucket{{{blab}}} {cum}")
                    lines.append(f"{name}_sum{suffix} {s.sum:g}")
                    lines.append(f"{name}_count{suffix} {s.count}")
                else:
                    lines.append(f"{name}{suffix} {s.value:g}")
        return "\n".join(lines) + "\n"

    def get(self, name: str) -> Metric | None:
        return self._metrics.get(name)

    def value(self, name: str, **labels: str) -> float:
        """Current value of one series (0.0 if it does not exist yet)."""
        m = self._metrics.get(name)
        if m is None:
            return 0.0
        s = m.series.get(tuple(str(labels[ln]) for ln in m.labelnames))
        return s.value if s else 0.0


#: The process-global registry every subsystem emits into.
REGISTRY = Registry(enabled=False)


def enabled() -> bool:
    return REGISTRY.enabled


def enable(on: bool = True) -> None:
    REGISTRY.enabled = on


def disable() -> None:
    REGISTRY.enabled = False


def counter(name: str, help: str = "",
            labels: tuple[str, ...] = ()) -> Metric:
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: tuple[str, ...] = ()) -> Metric:
    return REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: tuple[str, ...] = (),
              buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Metric:
    return REGISTRY.histogram(name, help, labels, buckets)


def snapshot() -> str:
    return REGISTRY.snapshot()


def collect() -> dict:
    return REGISTRY.collect()


def reset() -> None:
    REGISTRY.reset()


# ---------------------------------------------------------------------------
# Canonical metric names (catalogued in docs/observability.md)
# ---------------------------------------------------------------------------

NAME_READ_STATUS = "cream_read_status_total"
NAME_SCRUB_SWEEPS = "cream_scrub_sweeps_total"
NAME_SCRUB_BEATS = "cream_scrub_beats_total"
NAME_SCRUB_CORRECTED = "cream_scrub_corrected_total"
NAME_SCRUB_UNCORRECTABLE = "cream_scrub_uncorrectable_total"
NAME_REGION_ERROR_RATE = "cream_region_error_rate"
NAME_CAPACITY_PAGES = "cream_capacity_pages"
NAME_CAPACITY_RECLAIMED = "cream_capacity_reclaimed_pages"
NAME_PAGES_MIGRATED = "cream_pages_migrated_total"
NAME_MIGRATION_TO_HOST = "cream_migration_to_host_total"
NAME_VM_READS = "cream_vm_reads_total"
NAME_VM_WRITES = "cream_vm_writes_total"
NAME_TOKENS_DECODED = "cream_tokens_decoded_total"
NAME_DECODE_STEPS = "cream_decode_steps_total"
NAME_PREFILLS = "cream_prefills_total"
NAME_PREEMPTIONS = "cream_preemptions_total"
NAME_RESTORES = "cream_restores_total"
NAME_OBJCACHE_OPS = "cream_objcache_ops_total"
NAME_SHARD_DISPATCH = "cream_shard_dispatch_total"
NAME_SHARD_RING_PAGES = "cream_shard_ring_pages_total"
# CREAM-Lens (repro_torch.obs.memprof) replayed bank-profile series
NAME_DRAM_ROW_HIT_RATE = "cream_dram_bank_row_hit_rate"
NAME_DRAM_CONFLICT_RATE = "cream_dram_bank_conflict_rate"
NAME_DRAM_BLP = "cream_dram_bank_blp"
NAME_DRAM_TFAW_STALL = "cream_dram_bank_tfaw_stall_cycles"
NAME_DRAM_QUEUE_P99 = "cream_dram_bank_queue_p99"
NAME_DRAM_EXTRA_CHIP = "cream_dram_bank_extra_chip_frac"
NAME_DRAM_ACCESSES = "cream_dram_bank_accesses_total"

def _fold_classes() -> tuple[str, ...]:
    from repro_torch.core import protection
    return tuple(p.value for p in protection.ladder())


#: Storage classes in fold order (index into the device-side count matrix).
#: Derived from the Protection ladder (strongest first) — NEVER hardcode the
#: class count; adding a rung must widen every consumer in lockstep.
FOLD_CLASSES = _fold_classes()


def read_status_counter() -> Metric:
    return counter(NAME_READ_STATUS,
                   "per-page decode outcomes on the serving read path",
                   labels=("cls", "status"))


def touch_read_status() -> None:
    """Pre-create the per-class read-status series at zero, so snapshots
    always carry the full (cls, status) matrix even before any error."""
    m = read_status_counter()
    for cls in FOLD_CLASSES:
        for status in ("corrected", "uncorrectable"):
            m.labels(cls=cls, status=status)


def fold_read_status(counts) -> None:
    """Fold a device-side status-count accumulator into the registry.

    ``counts`` is ``(len(FOLD_CLASSES), 2)`` — column 0 corrected, column 1
    detected-uncorrectable — reduced from the status the step's gather
    returns (see ``repro_torch.serve.engine``): an int tensor on any
    device, copied to the host once here, or a numpy array. Also feeds
    the per-class reliability SLO (:mod:`repro_torch.obs.slo`), so a
    SECDED uncorrectable surfacing on the read path breaches immediately.
    """
    from repro_torch.obs import slo
    c = np.asarray(counts.cpu() if hasattr(counts, "cpu") else counts)
    for i, cls in enumerate(FOLD_CLASSES):
        if c[i, 0] or c[i, 1]:
            slo.TRACKER.record_read_status(cls, corrected=int(c[i, 0]),
                                           uncorrectable=int(c[i, 1]))
    if not REGISTRY.enabled:
        return
    m = read_status_counter()
    for i, cls in enumerate(FOLD_CLASSES):
        if c[i, 0]:
            m.labels(cls=cls, status="corrected").inc(int(c[i, 0]))
        if c[i, 1]:
            m.labels(cls=cls, status="uncorrectable").inc(int(c[i, 1]))


def record_pool_capacity(pool_name: str, pool) -> None:
    """Publish a pool's boundary-register capacity split as gauges.

    Called whenever a boundary is created or moved; the per-class page
    gauges are the "capacity reclaimed rides the boundary register" story.
    Also feeds the capacity SLO (:mod:`repro_torch.obs.slo`), whether or
    not metrics are enabled.
    """
    from repro_torch.obs import slo
    slo.TRACKER.record_capacity(pool_name, pool)
    if not REGISTRY.enabled:
        return
    from repro_torch.core.layouts import Layout
    g = gauge(NAME_CAPACITY_PAGES,
              "device pages by storage class (rides the boundary register)",
              labels=("pool", "cls"))
    if pool.layout == Layout.BASELINE_ECC:
        cream_cls = "secded"
    elif pool.layout == Layout.PARITY:
        cream_cls = "parity"
    else:
        cream_cls = "none"
    daec_pages = getattr(pool, "daec_rows", 0)
    secded_pages = pool.num_rows - pool.boundary - daec_pages
    cream_pages = pool.boundary + pool.num_extra_pages
    if cream_cls == "secded":
        g.labels(pool=pool_name, cls="secded").set(secded_pages + cream_pages)
    else:
        g.labels(pool=pool_name, cls="secded").set(secded_pages)
        g.labels(pool=pool_name, cls=cream_cls).set(cream_pages)
    if daec_pages:
        g.labels(pool=pool_name, cls="daec").set(daec_pages)
    gauge(NAME_CAPACITY_RECLAIMED,
          "extra pages reclaimed from code lanes",
          labels=("pool",)).labels(pool=pool_name).set(pool.num_extra_pages)
