"""The spans the port emits beyond the reference's, and the helpers the
tests use to compare span names with the reference's and to read nesting
by containment.

The reference's engine emits ``serve.router.dispatch``, the blocking
``engine.step.gather`` / ``.compute`` / ``.scatter`` spans and
``engine.prefill``. The port adds spans at the serving step's and the
model's boundaries (``repro_torch.obs.tracing``, ``serve/engine.py``,
``serve/scheduler.py``, ``models/transformer.py``), which the reference
has no counterpart for. Comparisons of span names with the reference hold
the port's events restricted to the names the reference emits, and the
rest to exactly this table.
"""
from __future__ import annotations

import collections

#: span -> the span it opens inside (None: at the top)
PORT_SPANS = {
    "engine.poll": None,
    "sched.tick": "engine.poll",
    "engine.step": "engine.poll",
    "engine.step.unpack": "engine.step.compute",
    "engine.step.model": "engine.step.compute",
    "engine.step.insert": "engine.step.compute",
    "engine.step.readback": "engine.step",
    "model.attn": ("engine.step.model", "engine.prefill.model"),
    "model.mlp": ("engine.step.model", "engine.prefill.model"),
    "model.moe": ("engine.step.model", "engine.prefill.model"),
    "model.head": ("engine.step.model", "engine.prefill.model"),
    "engine.prefill.model": "engine.prefill",
    "engine.prefill.pack": "engine.prefill",
    "engine.prefill.write": "engine.prefill",
}


def names(events: list) -> collections.Counter:
    return collections.Counter(e["name"] for e in events)


def split(port_events: list, ref_events: list
          ) -> tuple[collections.Counter, collections.Counter, set]:
    """(the port's names restricted to the reference's, the reference's,
    the port's names the reference does not emit)."""
    got, want = names(port_events), names(ref_events)
    shared = collections.Counter({n: c for n, c in got.items()
                                  if n in want})
    return shared, want, set(got) - set(want)


def parents(events: list) -> list:
    """Each complete event's innermost enclosing complete event (by
    containment of ``[ts, ts + dur]`` on its thread), or None; in the
    order of ``events``."""
    spans = sorted((e["ts"], -e["dur"], i) for i, e in
                   enumerate(events) if e["ph"] == "X")
    out: list = [None] * len(events)
    stack: dict = collections.defaultdict(list)
    for ts, neg, i in spans:
        st = stack[events[i].get("tid")]
        while st and events[st[-1]]["ts"] + events[st[-1]]["dur"] < ts - neg:
            st.pop()
        out[i] = events[st[-1]] if st else None
        st.append(i)
    return out
