"""The data-plane examples on the port print the reference scripts' lines.

``repro_torch.examples.quickstart``, ``vm_multitenant``,
``adaptive_reliability`` and ``objcache_memcached`` on the CPU, each
against ``examples/<name>.py`` run under JAX on the CPU: equal line for
line (nothing they print comes from a clock). Each case takes ~10-15 s,
most of it the reference's.
"""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_examples import assert_same_output, run_port, run_reference


@pytest.mark.parametrize("name", ["quickstart", "vm_multitenant",
                                  "adaptive_reliability",
                                  "objcache_memcached"])
def test_example_prints_the_reference_lines(name):
    assert_same_output(name, run_port(name, []), run_reference(name, []))
