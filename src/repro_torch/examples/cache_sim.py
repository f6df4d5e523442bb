"""The page-fault model's constants and trace generators.

The port's numpy copy of the parts of ``benchmarks/cache_sim.py`` that
:mod:`repro_torch.examples.objcache_memcached` uses: a miss costs the
paper's 500 us fault penalty (300 us SSD + 200 us software), a hit the
DRAM service time, and traces are zipfian page popularity over shuffled
page ids, alone or as WebSearch-style hot-set-over-uniform-tail traffic.
The draws are the reference's, in its order, for the same generator.
"""
from __future__ import annotations

import numpy as np

FAULT_PENALTY_US = 500.0
HIT_COST_US = 0.1          # DRAM service incl. controller (order of magnitude)


def zipf_trace(rng: np.random.Generator, n_pages: int, n_accesses: int,
               alpha: float = 0.99) -> np.ndarray:
    """Zipfian page popularity (hot keys), shuffled page ids."""
    ranks = np.arange(1, n_pages + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    perm = rng.permutation(n_pages)
    return perm[rng.choice(n_pages, size=n_accesses, p=probs)]


def websearch_trace(rng: np.random.Generator, hot_pages: int,
                    cold_pages: int, n_accesses: int,
                    hot_frac: float = 0.95,
                    alpha: float = 0.99) -> np.ndarray:
    """WebSearch-style index traffic: ``hot_frac`` of accesses a
    :func:`zipf_trace` over the first ``hot_pages`` ids, the rest uniform
    on the ``cold_pages`` above them."""
    hot = zipf_trace(rng, hot_pages, n_accesses, alpha)
    cold = hot_pages + rng.integers(0, cold_pages, size=n_accesses)
    return np.where(rng.random(n_accesses) < hot_frac, hot, cold)
