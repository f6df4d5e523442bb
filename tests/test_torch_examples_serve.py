"""The serving examples on the port print the reference scripts' lines.

``repro_torch.examples.serve_kv_cream`` and ``observe_serving`` on the
CPU, each against ``examples/<name>.py`` run under JAX on the CPU: equal
line for line, with only ``serve_kv_cream``'s tokens/s and p99 (the
clock's) masked. Pages, preemptions, restores and host reads, the scrub
census, the dashboard's SLO verdicts and metrics and the span count are
compared as printed, the port's count less the spans the reference has no
counterpart for (the step's and the model's, ``tests/torch_spans.py``):
those are exactly the table's. Each case takes ~15-20 s.
"""
import re
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_examples import assert_same_output, masked, run_port, run_reference
from torch_spans import PORT_SPANS

SPAN_COUNT = re.compile(r"\b(\d+) spans traced$", re.M)


def _reference_spans_only(text: str, events: list) -> str:
    """``text`` with its span count less the port's own spans."""
    added = [e for e in events if e["name"] in PORT_SPANS]
    assert {e["name"] for e in added} == set(PORT_SPANS) - {"model.moe"}
    assert [int(n) for n in SPAN_COUNT.findall(text)] == [len(events)]
    return SPAN_COUNT.sub(f"{len(events) - len(added)} spans traced", text)


@pytest.mark.parametrize("name", ["serve_kv_cream", "observe_serving"])
def test_example_prints_the_reference_lines(name):
    events: list = []
    port = run_port(name, [], events=events)
    if name == "observe_serving":
        port = _reference_spans_only(port, events)
    assert_same_output(name, port, run_reference(name, []))


def test_the_mask_hides_the_clock_and_nothing_else():
    a = ("secded : pages= 40 tokens/s=  373.3 p99=  385.7ms preempt=19 "
         "restores=14 host_reads=84")
    b = ("secded : pages= 40 tokens/s=   38.5 p99= 3736.5ms preempt=19 "
         "restores=14 host_reads=84")
    assert masked("serve_kv_cream", a) == masked("serve_kv_cream", b)
    c = b.replace("preempt=19", "preempt=18")
    assert masked("serve_kv_cream", a) != masked("serve_kv_cream", c)
    assert masked("observe_serving", a) != masked("observe_serving", b)
