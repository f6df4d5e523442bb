"""The reference's seven ``examples/`` scripts on the port.

One module each under the reference script's name, run with
``python -m repro_torch.examples.<name> [--device cpu]``. Each has a
``main(argv=None, device=None)``, prints what the reference script prints
and keeps its ``assert``s. They run on the card unless asked for the CPU
(``--device cpu`` or ``device="cpu"``); without a card they raise.

  * :mod:`.quickstart`           — a pool, a flip storm, the boundary moved
  * :mod:`.vm_multitenant`       — CREAM-VM tenants and a zero-loss upgrade
  * :mod:`.adaptive_reliability` — ``RegionManager``'s scrub / adapt loop
  * :mod:`.objcache_memcached`   — CREAM-Cache under zipfian traffic
  * :mod:`.serve_kv_cream`       — CREAM-Serve in SECDED and CREAM modes
  * :mod:`.observe_serving`      — CREAM-Serve with the telemetry plane on
  * :mod:`.train_lm`             — the ~110M-parameter training driver

:mod:`.cache_sim` is the port's numpy copy of the page-fault model's
constants and trace generators that :mod:`.objcache_memcached` needs.
"""
from __future__ import annotations

import argparse


def parser(doc: str) -> argparse.ArgumentParser:
    """An example's argument parser, with its ``--device``."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions)")
    return ap
