"""Live page migration across pools, protection modes, and the host tier.

Port of ``repro/vm/migration.py``: the zero-loss repartition transaction
and ad-hoc relocation (:meth:`MigrationEngine.relocate`, which the tenant
SLO escalation uses).

  * **protection upgrade** (boundary shrinks, SECDED region grows): the
    extra pages the move would evict are read out in one fused
    gather/re-encode batch (:mod:`repro_torch.kernels.migrate`), the
    boundary moves, and the pages land in fresh frames (same-or-stronger
    class, any pool, host swap for overflow);
  * **protection downgrade** (boundary grows): mapped pages whose contract
    exceeds the weakened class are relocated out of the surrendered span
    first.

Destination writes into SECDED frames reuse the codes the kernel already
computed; everything else goes through the pool's ``write``. Both fused
paths (the gather/re-encode read and the coded-row scatter) are taken only
for a bare :class:`~repro_torch.core.pool.PoolState`: a wrapped pool (the
fault campaign's :class:`~repro_torch.faults.shadow.ShadowedPool`) goes
through its own ``read`` and ``write``, so its oracle sees every access.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.core.layouts import CODE_LANE, DATA_LANES, Layout
from repro_torch.core.pool import PoolState
from repro_torch.core.protection import at_least
from repro_torch.kernels.common import to_u32
from repro_torch.kernels.migrate import ops as migrate_ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.vm.address_space import PTE, VirtualMemory, cream_protection


@dataclass
class MigrationStats:
    pages_moved: int = 0
    bytes_moved: int = 0
    to_host: int = 0
    transactions: int = 0
    kernel_batches: int = 0
    seconds: float = 0.0

    @property
    def throughput_pages_s(self) -> float:
        return self.pages_moved / self.seconds if self.seconds else 0.0

    @property
    def throughput_mb_s(self) -> float:
        return self.bytes_moved / 2**20 / self.seconds if self.seconds else 0.0


def _scatter_coded_rows(storage: torch.Tensor, rows: torch.Tensor,
                        data: torch.Tensor, codes: torch.Tensor) -> None:
    """Land pages in SECDED rows reusing precomputed codes. In place: the
    reference donates the storage here."""
    n = rows.shape[0]
    storage[rows, :DATA_LANES, :] = data.reshape(n, DATA_LANES, -1)
    storage[rows, CODE_LANE, :] = codes


class MigrationEngine:
    """Relocates mapped pages between frames without losing contents."""

    def __init__(self, vm: VirtualMemory, use_kernel: bool | None = None):
        self.vm = vm
        self.use_kernel = use_kernel    # ignored: the pool's device decides
        self.stats = MigrationStats()

    # -- building blocks -----------------------------------------------------
    def _read_frames(self, state: PoolState, phys: list[int]
                     ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Batch-read frames -> (data, precomputed SECDED codes or None).

        Pure-CREAM InterWrap batches on a bare pool take the fused
        gather/re-encode kernel (codes for the destination come free); any
        other mix, and any wrapped pool, is one decode-corrected pool read.
        """
        if isinstance(state, PoolState) \
                and state.layout == Layout.INTERWRAP and all(
                p < state.boundary or p >= state.num_rows for p in phys):
            data, codes = migrate_ops.gather_encode(
                state.storage,
                torch.as_tensor(phys, dtype=torch.int32, device=state.device),
                state.num_rows)
            self.stats.kernel_batches += 1
            return data, codes
        return state.read(phys), None

    def _write_frames(self, pool_name: str, phys: list[int],
                      data: torch.Tensor, codes: torch.Tensor | None) -> None:
        """Batch-write frames, reusing precomputed codes where they apply."""
        vm = self.vm
        state = vm.pools[pool_name]
        # precomputed codes are SECDED: the DAEC tier re-encodes via write()
        if codes is not None and isinstance(state, PoolState) and all(
                state.boundary <= p < state.num_rows - state.daec_rows
                for p in phys):
            _scatter_coded_rows(
                state.storage,
                torch.as_tensor(phys, device=state.device), data, codes)
        else:
            vm.pools[pool_name] = state.write(phys, data)

    def _place(self, data: torch.Tensor, codes: torch.Tensor | None,
               victims: list[tuple[str, int, PTE]],
               exclude: dict[str, set[int]],
               avoid_pool: str | None = None) -> None:
        """Land read-out pages in fresh frames (or host) and remap PTEs.

        Destination pools are tried in registration order, a victim's own
        source pool last, ``avoid_pool`` never. Victims are placed in
        batches grouped by (source pool, reliability class).
        """
        vm = self.vm
        host_before = self.stats.to_host
        by_pool: dict[str, list[tuple[int, int]]] = {}
        host = None                   # device-to-host copy, on first overflow
        groups: dict[tuple[str | None, object], list[int]] = {}
        for i, (_, _, pte) in enumerate(victims):
            groups.setdefault((pte.pool, pte.reliability), []).append(i)
        for (src_pool, rel), idxs in groups.items():
            ordered = sorted(
                (kv for kv in vm.allocators.items() if kv[0] != avoid_pool),
                key=lambda kv: kv[0] == src_pool)
            remaining = list(idxs)
            for pool_name, alloc in ordered:
                if not remaining:
                    break
                picks = alloc.peek(rel, len(remaining),
                                   exclude=exclude.get(pool_name))
                for phys, i in zip(picks, remaining[:len(picks)]):
                    tenant, vpn, pte = victims[i]
                    alloc.claim(phys, tenant, vpn)
                    vm.tenants[tenant].entries[vpn] = PTE(
                        pool_name, phys, pte.reliability, pte.segment)
                    by_pool.setdefault(pool_name, []).append((i, phys))
                remaining = remaining[len(picks):]
            for i in remaining:       # overflow -> host swap tier
                tenant, vpn, pte = victims[i]
                if host is None:
                    host = to_u32(data)
                slot = vm._new_slot()
                vm.swap[slot] = host[i].copy()
                vm.tenants[tenant].entries[vpn] = PTE(
                    None, slot, pte.reliability, pte.segment)
                self.stats.to_host += 1
        for pool_name, items in by_pool.items():
            idx = torch.as_tensor([i for i, _ in items], device=data.device)
            sub_codes = codes[idx] if codes is not None else None
            self._write_frames(pool_name, [p for _, p in items],
                               data[idx], sub_codes)
        self.stats.pages_moved += len(victims)
        self.stats.bytes_moved += len(victims) * vm.page_bytes
        if obs_metrics.enabled():
            c = obs_metrics.counter(
                obs_metrics.NAME_PAGES_MIGRATED,
                "pages relocated by the migration engine",
                labels=("cls",))
            per_cls: dict[str, int] = {}
            for _, _, pte in victims:
                key = pte.reliability.value
                per_cls[key] = per_cls.get(key, 0) + 1
            for cls, n in per_cls.items():
                c.labels(cls=cls).inc(n)
            overflow = self.stats.to_host - host_before
            if overflow:
                obs_metrics.counter(
                    obs_metrics.NAME_MIGRATION_TO_HOST,
                    "migrated pages that overflowed to the host swap tier"
                ).labels().inc(overflow)

    # -- ad-hoc migration ----------------------------------------------------
    def relocate(self, tenant: str, vpns, avoid_pool: str | None = None
                 ) -> int:
        """Move pages off their current frames (e.g. away from a weakening
        pool, or up to a stronger class), preferring other pools; host swap
        on overflow. Returns the number of device-resident pages moved."""
        vpns = list(vpns)
        with obs_tracing.span("vm.migration.relocate", tenant=tenant,
                              pages=len(vpns)):
            return self._relocate(tenant, vpns, avoid_pool)

    def _relocate(self, tenant: str, vpns: list, avoid_pool: str | None
                  ) -> int:
        vm = self.vm
        t0 = time.perf_counter()
        space = vm.tenants[tenant]
        victims = []
        by_pool: dict[str, list[int]] = {}
        for vpn in vpns:
            pte = space.entries[vpn]
            if pte.pool is None:
                continue
            victims.append((tenant, vpn, pte))
            by_pool.setdefault(pte.pool, []).append(len(victims) - 1)
        if not victims:
            return 0
        # one gather per source pool, scattered straight into victim order
        n = len(victims)
        data_all = torch.zeros((n, vm.page_words), dtype=torch.int32,
                               device=vm.device)
        codes_all = torch.zeros((n, vm.row_words), dtype=torch.int32,
                                device=vm.device)
        have_codes = True
        for pool_name, idxs in by_pool.items():
            phys = [victims[i][2].phys for i in idxs]
            data, codes = self._read_frames(vm.pools[pool_name], phys)
            idx = torch.as_tensor(idxs, device=vm.device)
            data_all[idx] = data
            if codes is None:
                have_codes = False
            else:
                codes_all[idx] = codes
        # free the source frames, but bar them (and the avoided pool) as
        # destinations for this transaction: relocation must actually move
        exclude: dict[str, set[int]] = {}
        for _, _, pte in victims:
            vm.allocators[pte.pool].release(vm.pools[pte.pool], pte.phys)
            exclude.setdefault(pte.pool, set()).add(pte.phys)
        self._place(data_all, codes_all if have_codes else None,
                    victims, exclude, avoid_pool=avoid_pool)
        self.stats.transactions += 1
        self.stats.seconds += time.perf_counter() - t0
        return n

    # -- the transaction -----------------------------------------------------
    def repartition_with_migration(self, pool_name: str, new_boundary: int
                                   ) -> dict:
        """Move a pool's boundary without losing a single mapped page.

        Upgrade (shrink): doomed extra pages are read out (fused
        gather/re-encode batch), the boundary moves, and the pages land in
        fresh frames / host swap. Downgrade (grow): mapped pages whose
        reliability contract exceeds the weakened class are relocated out
        of the surrendered span first.
        """
        vm = self.vm
        state = vm.pools[pool_name]
        alloc = vm.allocators[pool_name]
        old = state.boundary
        with obs_tracing.span("vm.migration.repartition", pool=pool_name,
                              old_boundary=old, new_boundary=new_boundary):
            return self._repartition(pool_name, new_boundary, state, alloc,
                                     old)

    def _repartition(self, pool_name: str, new_boundary: int, state, alloc,
                     old: int) -> dict:
        vm = self.vm
        # validate before touching any mapping
        if new_boundary % state.boundary_step \
                or not 0 <= new_boundary <= state.num_rows:
            raise ValueError(f"bad boundary {new_boundary}")
        t0 = time.perf_counter()
        info = {"pool": pool_name, "old_boundary": old,
                "new_boundary": new_boundary, "migrated": 0, "to_host": 0,
                "evicted_unmapped": 0}
        if new_boundary == old:
            return info
        host_before = self.stats.to_host

        if new_boundary < old:      # upgrade: SECDED region grows
            victims = []
            for phys in state.evict_prediction(new_boundary):
                if phys in alloc.owner:
                    tenant, vpn = alloc.owner[phys]
                    victims.append((tenant, vpn,
                                    vm.tenants[tenant].entries[vpn]))
                else:       # free frame: simply vanishes in the rebuild
                    info["evicted_unmapped"] += 1
            codes_ok = True
        else:                       # downgrade: capacity reclaimed
            weak = cream_protection(state.layout)
            victims = []
            for phys in range(old, new_boundary):
                if phys in alloc.owner:
                    tenant, vpn = alloc.owner[phys]
                    pte = vm.tenants[tenant].entries[vpn]
                    if not at_least(weak, pte.reliability):
                        victims.append((tenant, vpn, pte))
            codes_ok = False        # the surrendered span is weak-class now
        data = codes = None
        if victims:
            data, codes = self._read_frames(
                state, [pte.phys for _, _, pte in victims])
            for _, _, pte in victims:     # unmap before the frame dies
                del alloc.owner[pte.phys]
        new_state, _ = state.move_boundary(new_boundary)
        vm.pools[pool_name] = new_state
        alloc.rebuild(new_state)
        if victims:
            # surviving frames of this pool are fair game as destinations
            self._place(data, codes if codes_ok else None, victims,
                        exclude={})
        info["migrated"] = len(victims)
        info["to_host"] = self.stats.to_host - host_before
        self.stats.transactions += 1
        self.stats.seconds += time.perf_counter() - t0
        obs_metrics.record_pool_capacity(pool_name, vm.pools[pool_name])
        return info
