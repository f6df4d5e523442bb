"""The paper's §3.3 vision: a cloud that re-partitions protection at runtime.

Three tenants share a server: a batch-job KV region (error-tolerant), a
database region (detection required), and the hypervisor (always SECDED).
The health loop scrubs, watches error rates, and moves each region's
boundary — healthy regions donate code-lane capacity, a failing DIMM gets
its protection upgraded automatically. Port of
``examples/adaptive_reliability.py``.

Run: PYTHONPATH=src python -m repro_torch.examples.adaptive_reliability [--device cpu]
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.injection import FaultModel
from repro_torch.core.monitor import MonitorConfig
from repro_torch.core.protection import Protection, RegionSpec
from repro_torch.core.regions import RegionManager
from repro_torch.examples import parser
from repro_torch.kernels.common import resolve_device


def main(argv=None, device=None) -> None:
    args = parser(__doc__).parse_args(argv)
    device = resolve_device(device if device is not None else args.device)
    mgr = RegionManager(MonitorConfig(window=2, upgrade_threshold=5e-8,
                                      downgrade_threshold=1e-9,
                                      downgrade_patience=2), device=device)
    mgr.add_region(RegionSpec.make("batch_kv", Protection.SECDED, 64,
                                   min_protection=Protection.NONE))
    mgr.add_region(RegionSpec.make("database", Protection.SECDED, 64,
                                   min_protection=Protection.PARITY))
    mgr.add_region(RegionSpec.make("hypervisor", Protection.SECDED, 32,
                                   min_protection=Protection.SECDED))

    # the 'database' region sits on an aging DIMM
    faults = FaultModel.make(seed=0, soft_rate=2000.0, n_hard=0,
                             shape=(64, 9, 256))

    print(f"{'epoch':5s} {'capacity':>9s}  transitions / health")
    for epoch in range(8):
        db = mgr.regions["database"]
        if epoch >= 3:  # DIMM starts flipping bits
            stor, n = faults.step(db.pool.storage)
            db.pool = dataclasses.replace(db.pool, storage=stor)
        mgr.scrub_all()
        trans = mgr.adapt()
        cap = mgr.total_capacity_pages()
        notes = "; ".join(f"{n}:{a.value}->{b.value}" for n, a, b in trans)
        rates = {n: f"{mgr.monitor.rate(n):.1e}" for n in mgr.regions}
        print(f"{epoch:5d} {cap:9d}  {notes or '-':40s} {rates}")

    report = mgr.capacity_report()
    print("\nfinal layout:")
    for name, r in report.items():
        print(f"  {name:10s} {r['protection']:7s} pages={r['pages']:3d} "
              f"(+{r['gain']:.1%})")


if __name__ == "__main__":
    main()
