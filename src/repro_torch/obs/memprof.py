"""CREAM-Lens — the bank-level memory-system profiler.

Port of ``repro/obs/memprof.py``. CREAM-Scope (:mod:`.metrics` /
:mod:`.tracing`) sees the stack down to the page dispatch; this module
sees *below* the page: when the sharded data plane fails to turn
bank-level parallelism into speedup, where does the concurrency go —
router serialization, row-buffer conflicts, or activation-window
(tRRD/tFAW) stalls?

Three stages, mirroring a hardware profiler:

  1. **Capture** — :func:`record` appends :class:`AccessRecord`\\ s (step,
     op, page ids, pool geometry, stream label) from cheap opt-in hooks on
     the pool engines (``repro_torch.core.pool``'s read / write / migrate,
     the sharded pool's routed and stream dispatches, the serving engine's
     decode gather, the object cache). Disabled (the default) every hook
     is one module-boolean read; nothing allocates and no hook touches the
     device. Enabled, a hook given a CUDA tensor of ids copies it to the
     host. One record per dispatch: a pool verb that another recording
     dispatch runs (the sharded pool's bank reads, the object cache's
     read-modify-write) runs under :func:`suspended`, as the reference's
     hooks skip the traced operands inside such a dispatch.
  2. **Attribute** — :func:`page_coords_np` + :func:`code_rows_np` are
     numpy mirrors of :func:`repro_torch.core.layouts.page_coords`: every
     page id becomes its 8 physical ``(row, lane)`` slices plus the
     layout's extra-chip traffic (SECDED code reads, packed-parity rows).
  3. **Replay** — :func:`replay` runs each stream's records through the
     per-bank state machines of :mod:`repro_torch.obs.dram_sim`
     (``BankArray``: row-buffer state, tRCD/tRP/tCAS, per-chip tRRD/tFAW
     activation windows, per-bank queues), yielding per-bank row
     hit/miss/conflict counts, achieved-BLP histograms, tFAW-stall cycles
     and queue-depth percentiles.

:func:`collect` snapshots everything; with metrics enabled the profile is
also exported as ``cream_dram_bank_*`` gauges, and :func:`counter_events`
turns stream timelines into Perfetto counter tracks ("ph": "C") that sit
next to the gather/compute/scatter spans. See docs/observability.md
§ Memory-system profiling.
"""
from __future__ import annotations

import contextlib
import math
import os
import threading
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.layouts import (CODE_LANE, DATA_LANES,
                                      DEFAULT_ROW_WORDS, GROUP_ROWS, LANES,
                                      REGION_CREAM, REGION_EXTRA,
                                      REGION_SECDED, WRAP_LANES, WRAP_ROWS,
                                      Layout, extra_base_row)
from repro_torch.obs import dram_sim
from repro_torch.obs.tracing import now_us

#: Capture cap: one record per engine dispatch, so this bounds *dispatches*,
#: not pages. Overflow increments ``dropped`` (reported, never silent).
MAX_RECORDS = 4096

_LOCK = threading.Lock()


@dataclass
class AccessRecord:
    """One captured data-plane dispatch (a batch gather or scatter)."""
    step: int
    t_us: float                  # tracing.now_us() — the spans' clock
    op: str                      # "gather" | "scatter"
    pages: np.ndarray            # (n,) page ids in the *pool's own* id space
    layout: Layout
    num_rows: int                # pool (or shard-local) regular-page count
    boundary: int                # CREAM/SECDED split of that id space
    row_words: int
    pool: str = "pool"
    stream: str = "main"         # replay lane: one BankArray per stream


class MemProfiler:
    """Capture buffer + published-profile store. Global instance: PROFILER."""

    def __init__(self) -> None:
        self.enabled = False
        self.records: list[AccessRecord] = []
        self.dropped = 0
        self.step = 0
        self.published: dict[str, dict] = {}

    def record(self, op: str, pages, *, layout: Layout, num_rows: int,
               boundary: int, row_words: int = DEFAULT_ROW_WORDS,
               pool: str = "pool", stream: str = "main") -> None:
        if not self.enabled:
            return
        if op not in ("gather", "scatter"):
            raise ValueError(f"op must be gather|scatter, got {op!r}")
        if hasattr(pages, "cpu"):        # a tensor: to the host, now
            pages = pages.detach().cpu().numpy()
        arr = np.asarray(pages, dtype=np.int64).reshape(-1)
        with _LOCK:
            if len(self.records) >= MAX_RECORDS:
                self.dropped += 1
                return
            self.records.append(AccessRecord(
                self.step, now_us(), op, arr, layout,
                int(num_rows), int(boundary), int(row_words), pool, stream))

    def next_step(self) -> None:
        self.step += 1

    def reset(self) -> None:
        """Drop captured records (published profiles survive)."""
        with _LOCK:
            self.records = []
            self.dropped = 0
            self.step = 0

    def clear(self) -> None:
        """Full reset: records AND published profiles."""
        self.reset()
        self.published = {}

    def publish(self, name: str, profile: dict) -> None:
        """Stash a replayed profile under ``name`` (survives reset())."""
        self.published[str(name)] = profile


#: The process-global profiler every hook records into.
PROFILER = MemProfiler()


def enabled() -> bool:
    return PROFILER.enabled


def enable(on: bool = True) -> None:
    PROFILER.enabled = on


def disable() -> None:
    PROFILER.enabled = False


def record(op: str, pages, **kw) -> None:
    PROFILER.record(op, pages, **kw)


@contextlib.contextmanager
def suspended():
    """Record nothing inside: the pool verbs a recording dispatch runs for
    itself (the reference records such a dispatch once, at its wrapper,
    and its hooks skip the traced operands inside)."""
    was = PROFILER.enabled
    PROFILER.enabled = False
    try:
        yield
    finally:
        PROFILER.enabled = was


def next_step() -> None:
    PROFILER.next_step()


def reset() -> None:
    PROFILER.reset()


def clear() -> None:
    PROFILER.clear()


def publish(name: str, profile: dict) -> None:
    PROFILER.publish(name, profile)


def records() -> list[AccessRecord]:
    return list(PROFILER.records)


# ---------------------------------------------------------------------------
# Attribution: numpy mirror of layouts.page_coords (+ extra-chip traffic).
# Host-side replay must not touch the device, so the translation is
# mirrored in numpy; tests/test_torch_memprof.py holds the mirror equal to
# the reference's for every layout × boundary.
# ---------------------------------------------------------------------------


def page_coords_np(layout: Layout, num_rows: int, boundary: int,
                   pages: np.ndarray, row_words: int = DEFAULT_ROW_WORDS
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Numpy twin of :func:`repro_torch.core.layouts.page_coords`.

    Returns ``(rows (n, 8), lanes (n, 8), region (n,))`` int32 — the 8
    physical (row, lane) slices holding each page's data, and its REGION_*
    code. Same contract as the jnp original, including the INTERWRAP wrap
    tables and the extra-page code-lane packing.
    """
    pages = np.asarray(pages, dtype=np.int64).reshape(-1)
    n = pages.shape[0]
    k = np.arange(DATA_LANES, dtype=np.int64)
    is_secded = (pages >= boundary) & (pages < num_rows)
    is_extra = pages >= num_rows
    region = np.where(is_secded, REGION_SECDED,
                      np.where(is_extra, REGION_EXTRA,
                               REGION_CREAM)).astype(np.int32)
    e = pages - num_rows
    row_rows = np.broadcast_to(pages[:, None], (n, DATA_LANES))
    row_lanes = np.broadcast_to(k[None, :], (n, DATA_LANES))

    if layout == Layout.INTERWRAP:
        group = np.where(is_extra, e, pages // GROUP_ROWS)
        slot = np.where(is_extra, GROUP_ROWS, pages % GROUP_ROWS)
        w_lanes = WRAP_LANES[slot]
        w_rows = GROUP_ROWS * group[:, None] + WRAP_ROWS[slot]
        in_sec = is_secded[:, None]
        rows = np.where(in_sec, row_rows, w_rows)
        lanes = np.where(in_sec, row_lanes, w_lanes)
        return rows.astype(np.int32), lanes.astype(np.int32), region

    ebase = extra_base_row(layout, boundary, row_words)
    ex_rows = ebase + GROUP_ROWS * e[:, None] + k[None, :]
    rows = np.where(is_extra[:, None], ex_rows, row_rows)
    lanes = np.where(is_extra[:, None], CODE_LANE, row_lanes)
    return rows.astype(np.int32), lanes.astype(np.int32), region


def code_rows_np(layout: Layout, num_rows: int, boundary: int,
                 pages: np.ndarray, row_words: int = DEFAULT_ROW_WORDS
                 ) -> np.ndarray:
    """Extra-chip (lane 8) row each page's access additionally touches.

    -1 = none. SECDED-region pages read their code row (same row, lane 8);
    PARITY-layout CREAM/extra pages read their packed-parity row (mirrors
    :func:`repro_torch.core.layouts.parity_coords`). This is exactly the
    traffic CREAM's layouts add to chip 8 — the paper's §4.4 overhead
    source.
    """
    pages = np.asarray(pages, dtype=np.int64).reshape(-1)
    is_secded = (pages >= boundary) & (pages < num_rows)
    out = np.full(pages.shape, -1, dtype=np.int64)
    out[is_secded] = pages[is_secded]
    if layout == Layout.PARITY and boundary > 0:
        rel = np.where(pages >= num_rows, boundary + (pages - num_rows),
                       pages)
        tables = math.ceil(boundary / 8)
        prow = np.where(rel < boundary, rel // 8,
                        tables + np.maximum(rel - boundary, 0) // 8)
        out = np.where(is_secded, out, prow)
    return out.astype(np.int32)


# ---------------------------------------------------------------------------
# Replay: captured streams -> per-bank state machines (.dram_sim)
# ---------------------------------------------------------------------------


@dataclass
class _StreamReplay:
    array: dram_sim.BankArray
    timeline: list[dict] = field(default_factory=list)
    pages: int = 0
    slice_accesses: int = 0
    extra_chip_accesses: int = 0


def replay(recs: list[AccessRecord] | None = None,
           timing=None) -> dict[str, _StreamReplay]:
    """Run captured records through per-bank state machines, per stream.

    Each ``(pool, stream)`` pair gets its own :class:`BankArray` — its own
    rank-subset hardware, matching the sharded pool's model where every
    shard is an independent module. Within one record (one engine
    dispatch) all page accesses issue simultaneously; banks serialize via
    their own occupancy. Consecutive records on a stream issue
    back-to-back (dispatch N+1 starts when N's slowest bank finishes).
    """
    ds = dram_sim
    t = timing or ds.Timing()
    recs = PROFILER.records if recs is None else recs
    streams: dict[str, _StreamReplay] = {}
    for rec in recs:
        key = rec.stream if rec.pool == "pool" else \
            f"{rec.pool}/{rec.stream}"
        sr = streams.get(key)
        if sr is None:
            bridge = 0 if rec.layout == Layout.BASELINE_ECC else t.bridge
            sr = streams[key] = _StreamReplay(
                ds.BankArray(t, chips=LANES, banks=ds.NUM_BANKS,
                             bridge_cycles=bridge))
        arr = sr.array
        rows, lanes, _ = page_coords_np(rec.layout, rec.num_rows,
                                        rec.boundary, rec.pages,
                                        rec.row_words)
        crow = code_rows_np(rec.layout, rec.num_rows, rec.boundary,
                            rec.pages, rec.row_words)
        now = arr.finish_cycle
        for i in range(rec.pages.shape[0]):
            slices = [(int(lanes[i, j]),) + ds.bank_of(int(rows[i, j]))
                      for j in range(DATA_LANES)]
            if crow[i] >= 0:
                slices.append((CODE_LANE,) + ds.bank_of(int(crow[i])))
            arr.access(slices, now)
            sr.slice_accesses += len(slices)
            sr.extra_chip_accesses += sum(1 for c, _, _ in slices
                                          if c == CODE_LANE)
        sr.pages += int(rec.pages.shape[0])
        tot = arr.totals()
        sr.timeline.append({
            "t_us": rec.t_us, "op": rec.op, "pages": int(rec.pages.shape[0]),
            "blp": round(arr.achieved_blp, 4),
            "row_hit_rate": round(arr.row_hit_rate, 4),
            "queue_depth": int(arr.queue_depths[-1])
            if arr.queue_depths else 0,
            "tfaw_stall_cycles": int(tot.faw_stall_cycles),
        })
    return streams


def _stream_stats(sr: _StreamReplay) -> dict:
    arr = sr.array
    tot = arr.totals()
    acc = tot.accesses
    heat = [[arr.machine(c, b).counters.accesses
             for b in range(arr.banks)] for c in range(arr.chips)]
    return {
        "pages": sr.pages,
        "accesses": acc,
        "row_hits": tot.row_hits,
        "row_empty": tot.row_empty,
        "row_conflicts": tot.row_conflicts,
        "row_hit_rate": round(arr.row_hit_rate, 4),
        "conflict_rate": round(tot.row_conflicts / acc, 4) if acc else 0.0,
        "achieved_blp": round(arr.achieved_blp, 4),
        "busy_cycles": tot.busy_cycles,
        "finish_cycle": arr.finish_cycle,
        "act_stall_cycles": tot.act_stall_cycles,
        "tfaw_stall_cycles": tot.faw_stall_cycles,
        "queue_p50": arr.queue_depth_percentile(50),
        "queue_p99": arr.queue_depth_percentile(99),
        "blp_hist": arr.blp_histogram(),
        "extra_chip_frac": round(
            sr.extra_chip_accesses / sr.slice_accesses, 4)
        if sr.slice_accesses else 0.0,
        "heatmap": heat,
        "timeline": sr.timeline,
    }


def profile(recs: list[AccessRecord] | None = None, timing=None) -> dict:
    """Replay + aggregate: the JSON-ready per-bank profile.

    ``overall`` treats the streams as concurrent hardware (the sharded
    pool's model): busy-bank cycles sum across streams while the makespan
    is the slowest stream's — so overall achieved-BLP grows with shard
    count only if the per-shard replays genuinely overlap.
    """
    ds = dram_sim
    t = timing or ds.Timing()
    streams = replay(recs, t)
    out_streams = {k: _stream_stats(v) for k, v in sorted(streams.items())}
    busy = sum(s["busy_cycles"] for s in out_streams.values())
    makespan = max((s["finish_cycle"] for s in out_streams.values()),
                   default=0)
    acc = sum(s["accesses"] for s in out_streams.values())
    hits = sum(s["row_hits"] for s in out_streams.values())
    confl = sum(s["row_conflicts"] for s in out_streams.values())
    sl = sum(v.slice_accesses for v in streams.values())
    xc = sum(v.extra_chip_accesses for v in streams.values())
    heat = np.zeros((LANES, ds.NUM_BANKS), dtype=np.int64)
    for s in out_streams.values():
        heat += np.asarray(s["heatmap"], dtype=np.int64)
    overall = {
        "streams": len(out_streams),
        "pages": sum(s["pages"] for s in out_streams.values()),
        "accesses": acc,
        "row_hit_rate": round(hits / acc, 4) if acc else 0.0,
        "conflict_rate": round(confl / acc, 4) if acc else 0.0,
        "achieved_blp": round(busy / makespan, 4) if makespan else 0.0,
        "act_stall_cycles": sum(s["act_stall_cycles"]
                                for s in out_streams.values()),
        "tfaw_stall_cycles": sum(s["tfaw_stall_cycles"]
                                 for s in out_streams.values()),
        "queue_p99": max((s["queue_p99"] for s in out_streams.values()),
                         default=0.0),
        "extra_chip_frac": round(xc / sl, 4) if sl else 0.0,
        "heatmap": heat.tolist(),
    }
    return {
        "timing": {"tCK_ns": t.tCK_ns, "tRCD": t.tRCD, "tRP": t.tRP,
                   "tCL": t.tCL, "tBL": t.tBL, "tRRD": t.tRRD,
                   "tFAW": t.tFAW, "bridge": t.bridge},
        "streams": out_streams,
        "overall": overall,
        "records": len(PROFILER.records if recs is None else recs),
        "dropped": PROFILER.dropped,
    }


# ---------------------------------------------------------------------------
# Export: metrics gauges, Perfetto counter tracks, the collected blob
# ---------------------------------------------------------------------------


def emit_metrics(prof: dict, suite: str = "pool") -> None:
    """Export one profile's stats as ``cream_dram_bank_*`` labelled gauges."""
    from repro_torch.obs import metrics
    if not metrics.enabled():
        return
    lab = ("suite", "stream")
    g_hit = metrics.gauge(metrics.NAME_DRAM_ROW_HIT_RATE,
                          "replayed per-bank row-buffer hit fraction", lab)
    g_con = metrics.gauge(metrics.NAME_DRAM_CONFLICT_RATE,
                          "replayed row-buffer conflict fraction", lab)
    g_blp = metrics.gauge(metrics.NAME_DRAM_BLP,
                          "achieved bank-level parallelism (busy/makespan)",
                          lab)
    g_faw = metrics.gauge(metrics.NAME_DRAM_TFAW_STALL,
                          "cycles stalled on the four-ACT tFAW window", lab)
    g_q99 = metrics.gauge(metrics.NAME_DRAM_QUEUE_P99,
                          "p99 per-bank request queue depth", lab)
    g_xtr = metrics.gauge(metrics.NAME_DRAM_EXTRA_CHIP,
                          "fraction of slice accesses on the code chip", lab)
    items = [("overall", prof["overall"])] + list(prof["streams"].items())
    for stream, s in items:
        kv = dict(suite=suite, stream=stream)
        g_hit.labels(**kv).set(s["row_hit_rate"])
        g_con.labels(**kv).set(s["conflict_rate"])
        g_blp.labels(**kv).set(s["achieved_blp"])
        g_faw.labels(**kv).set(s["tfaw_stall_cycles"])
        g_q99.labels(**kv).set(s["queue_p99"])
        g_xtr.labels(**kv).set(s["extra_chip_frac"])
    c_acc = metrics.counter(metrics.NAME_DRAM_ACCESSES,
                            "replayed accesses per (chip, bank)",
                            ("suite", "chip", "bank"))
    for chip, row in enumerate(prof["overall"]["heatmap"]):
        for bank, n in enumerate(row):
            if n:
                c_acc.labels(suite=suite, chip=str(chip),
                             bank=str(bank)).inc(n)


def counter_events(blob: dict) -> list[dict]:
    """Perfetto counter tracks ("ph": "C") from profile timelines.

    One ``dram.bank[<profile>/<stream>]`` track per replayed stream, with
    ``blp`` / ``row_hit_rate_pct`` / ``queue`` series, timestamped with the
    capture clock so the lanes line up with the gather/compute/scatter
    spans in the same trace.
    """
    profiles = blob.get("profiles", {}) if "profiles" in blob \
        else {"profile": blob}
    pid = os.getpid()
    events: list[dict] = []
    for pname, prof in profiles.items():
        for stream, s in prof.get("streams", {}).items():
            track = f"dram.bank[{pname}/{stream}]"
            for pt in s.get("timeline", []):
                events.append({
                    "name": track, "ph": "C", "cat": "cream",
                    "ts": pt["t_us"], "pid": pid,
                    "args": {"blp": pt["blp"],
                             "row_hit_rate_pct": 100 * pt["row_hit_rate"],
                             "queue": pt["queue_depth"]},
                })
    return events


def collect(timing=None) -> dict:
    """Snapshot: published profiles + a replay of any records still in the
    buffer (as a ``live`` profile when nothing was published under that
    name). Also exports metrics gauges when the metrics plane is on."""
    profiles = dict(PROFILER.published)
    if PROFILER.records:
        profiles.setdefault("live", profile(timing=timing))
    for name, prof in profiles.items():
        emit_metrics(prof, suite=name)
    return {
        "records": len(PROFILER.records),
        "dropped": PROFILER.dropped,
        "profiles": profiles,
    }
