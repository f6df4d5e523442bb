"""CREAM-VM end to end: two tenants, a weakening DIMM, zero lost pages.

Walks the full OS-level story on top of the paper's mechanism:

  1. a mixed pool (half CREAM, half SECDED) plus a small all-SECDED spare;
  2. a "secure" tenant (SECDED contract) and a "bulk" tenant (protection-
     free, so it gets the reclaimed extra pages);
  3. an uncorrectable fault appears; the scrub->monitor->recommend loop
     upgrades the pool to full SECDED — and the VM migrates the evicted
     extra pages live instead of dropping them.

Port of ``examples/vm_multitenant.py``.

Run: PYTHONPATH=src python -m repro_torch.examples.vm_multitenant [--device cpu]
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.layouts import Layout
from repro_torch.core.monitor import MonitorConfig
from repro_torch.core.protection import Protection
from repro_torch.examples import parser
from repro_torch.kernels.common import resolve_device, to_words
from repro_torch.vm import MigrationEngine, VirtualMemory, VMPolicy


def main(argv=None, device=None) -> None:
    args = parser(__doc__).parse_args(argv)
    device = resolve_device(device if device is not None else args.device)
    rng = np.random.default_rng(0)

    # 1) Pools under VM management.
    vm = VirtualMemory(row_words=64, device=device)
    vm.add_pool("dimm0", 32, Layout.INTERWRAP, boundary=16)  # mixed, 2 extras
    vm.add_pool("spare", 16, Layout.INTERWRAP, boundary=0)   # all SECDED
    engine = MigrationEngine(vm, use_kernel=True)
    policy = VMPolicy(vm, engine,
                      MonitorConfig(window=2, upgrade_threshold=1e-9))

    # 2) Tenants with different reliability contracts.
    vm.create_tenant("secure", default_reliability=Protection.SECDED)
    vm.create_tenant("bulk", default_reliability=Protection.NONE)
    sec = vm.alloc("secure", 4)
    bulk = vm.alloc("bulk", 18)          # fills the CREAM half + both extras
    dsec = to_words(rng.integers(0, 2**32, (4, vm.page_words),
                                 dtype=np.uint32)).to(device)
    dbulk = to_words(rng.integers(0, 2**32, (18, vm.page_words),
                                  dtype=np.uint32)).to(device)
    vm.write("secure", sec, dsec)
    vm.write("bulk", bulk, dbulk)
    rep = vm.capacity_report()
    print(f"dimm0: {rep['dimm0']['pages']} pages "
          f"(+{rep['dimm0']['extra_pages']} reclaimed), "
          f"util={vm.utilisation():.2f}")

    # 3) The DIMM weakens: an uncorrectable fault lands in a SECDED row.
    storage = vm.pools["dimm0"].storage.clone()
    storage[28, 3, 5] ^= 0b11
    vm.pools["dimm0"] = dataclasses.replace(vm.pools["dimm0"],
                                            storage=storage)

    scrubbed, performed = policy.step()  # scrub -> monitor -> repartition
    print(f"scrub saw uncorrectable="
          f"{scrubbed['dimm0'].detected_uncorrectable}; "
          f"transactions: {performed}")
    print(f"dimm0 boundary now {vm.pools['dimm0'].boundary} (full SECDED), "
          f"migrated {engine.stats.pages_moved} pages "
          f"({engine.stats.to_host} to host swap)")

    # 4) Nothing was lost.
    assert (vm.read("secure", sec) == dsec).all()
    assert (vm.read("bulk", bulk) == dbulk).all()
    print("all tenant pages intact — zero lost pages")


if __name__ == "__main__":
    main()
