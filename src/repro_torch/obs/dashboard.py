"""Terminal snapshot dashboard over the metrics registry + SLO tracker.

Port of ``repro/obs/dashboard.py``: for the same snapshot and statuses
the same text as the reference. Renders a fixed-width text report — what
``python -m repro_torch.tools.creamtop`` prints — either live (from the
process-global registry/tracker) or from a previously collected snapshot
dict (a ``metrics.collect()`` dump, or the ``_metrics`` blob of a
benchmark's suite file).
"""
from __future__ import annotations

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import slo as _slo

_W = 78


def _rule(ch: str = "-") -> str:
    return ch * _W


def _fmt_labels(labels: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items())) or "-"


def _counter_rows(snap: dict, name: str) -> list[tuple[str, float]]:
    m = snap.get(name)
    if not m:
        return []
    return [(_fmt_labels(r["labels"]), r.get("value", 0.0))
            for r in m["series"]]


def render_slo(statuses: list[_slo.SLOStatus]) -> str:
    lines = [_rule("="), "SLO".center(_W), _rule("=")]
    lines.append(f"{'scope':<22}{'objective':<30}{'value':>12}  state")
    lines.append(_rule())
    for s in statuses:
        state = "OK " if s.ok else "BREACH"
        lines.append(f"{s.scope:<22}{s.objective:<30}{s.value:>12.4g}  "
                     f"{state}  {s.detail}")
    if not statuses:
        lines.append("(no objectives recorded)")
    return "\n".join(lines)


def render_metrics(snap: dict) -> str:
    lines = [_rule("="), "METRICS".center(_W), _rule("=")]
    interesting = (
        ("capacity", (_metrics.NAME_CAPACITY_PAGES,
                      _metrics.NAME_CAPACITY_RECLAIMED)),
        ("reliability", (_metrics.NAME_READ_STATUS,
                         _metrics.NAME_SCRUB_CORRECTED,
                         _metrics.NAME_SCRUB_UNCORRECTABLE,
                         _metrics.NAME_SCRUB_SWEEPS)),
        ("data plane", (_metrics.NAME_VM_READS, _metrics.NAME_VM_WRITES,
                        _metrics.NAME_PAGES_MIGRATED,
                        _metrics.NAME_MIGRATION_TO_HOST,
                        _metrics.NAME_SHARD_DISPATCH,
                        _metrics.NAME_SHARD_RING_PAGES)),
        ("serving", (_metrics.NAME_TOKENS_DECODED,
                     _metrics.NAME_DECODE_STEPS, _metrics.NAME_PREFILLS,
                     _metrics.NAME_PREEMPTIONS, _metrics.NAME_RESTORES)),
        ("objcache", (_metrics.NAME_OBJCACHE_OPS,)),
    )
    shown: set[str] = set()
    for section, names in interesting:
        rows = []
        for name in names:
            shown.add(name)
            for lab, val in _counter_rows(snap, name):
                rows.append((f"{name}{{{lab}}}" if lab != "-" else name, val))
        if not rows:
            continue
        lines.append(f"[{section}]")
        for label, val in rows:
            lines.append(f"  {label:<62}{val:>14g}")
    other = sorted(set(snap) - shown)
    leftovers = []
    for name in other:
        if snap[name]["kind"] == "histogram":
            for r in snap[name]["series"]:
                c, s = r.get("count", 0), r.get("sum", 0.0)
                if c:
                    leftovers.append(
                        (f"{name}{{{_fmt_labels(r['labels'])}}}",
                         f"n={c} mean={s / c:.1f}us"))
        else:
            for lab, val in _counter_rows(snap, name):
                leftovers.append(
                    (f"{name}{{{lab}}}" if lab != "-" else name, f"{val:g}"))
    if leftovers:
        lines.append("[other]")
        for label, val in leftovers:
            lines.append(f"  {label:<58}{val:>18}")
    return "\n".join(lines)


#: Heat ramp for the bank heatmap, coolest -> hottest.
_HEAT = " .:-=+*#@"


def render_bank_heatmap(memprof_blob: dict) -> str:
    """Render CREAM-Lens bank heatmaps from a ``_memprof`` blob.

    One 9-chip x 8-bank panel per replayed profile (rows = chips, with
    chip 8 the code/extra chip; columns = banks), each cell shaded by its
    share of the profile's hottest bank, plus the headline stats the
    profile carries (achieved BLP, row hit rate, tFAW stalls). This is
    the ``creamtop --bench`` view of where bank-level
    parallelism actually lands.
    """
    lines = [_rule("="), "DRAM BANK PROFILE (CREAM-Lens)".center(_W),
             _rule("=")]
    profiles = memprof_blob.get("profiles", {})
    if not profiles:
        lines.append("(no bank profiles captured — run with --memprof)")
        return "\n".join(lines)
    for pname, prof in sorted(profiles.items()):
        o = prof.get("overall", {})
        lines.append(f"[{pname}]  streams={o.get('streams', 0)} "
                     f"accesses={o.get('accesses', 0)} "
                     f"blp={o.get('achieved_blp', 0.0):.2f} "
                     f"row_hit={o.get('row_hit_rate', 0.0):.1%} "
                     f"conflict={o.get('conflict_rate', 0.0):.1%} "
                     f"tfaw_stall={o.get('tfaw_stall_cycles', 0)}cy "
                     f"extra_chip={o.get('extra_chip_frac', 0.0):.1%}")
        heat = o.get("heatmap") or []
        peak = max((n for row in heat for n in row), default=0)
        lines.append("        " + " ".join(f"b{b}" for b in
                                           range(len(heat[0]) if heat else 0)))
        for chip, row in enumerate(heat):
            tag = "code" if chip == 8 else f"  c{chip}"
            cells = " ".join(
                (_HEAT[min(len(_HEAT) - 1,
                           (n * (len(_HEAT) - 1) + peak - 1) // peak)]
                 if peak else " ") * 2 for n in row)
            lines.append(f"  {tag}  {cells}")
        lines.append(_rule())
    return "\n".join(lines)


def render(snap: dict | None = None,
           statuses: list[_slo.SLOStatus] | None = None) -> str:
    """The full dashboard: SLO verdicts on top, metric sections below.

    With no arguments, reads the live process-global registry and tracker.
    """
    if snap is None:
        snap = _metrics.collect()
    if statuses is None:
        statuses = _slo.TRACKER.report()
    return render_slo(statuses) + "\n\n" + render_metrics(snap) + "\n"
