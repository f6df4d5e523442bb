"""The DRAM bank model CREAM-Lens replays captured page streams through.

The port's own copy of the parts of ``benchmarks/dram_sim.py`` (its
reference) that :func:`repro_torch.obs.memprof.replay` needs: the DDR4-2400
:class:`Timing`, the row -> bank interleaving :func:`bank_of`, and the
gram-style per-bank state machines (:class:`BankCounters`,
:class:`BankMachine`, :class:`RankTimers`, :class:`BankArray`) — one
explicit state machine per (chip, bank) slice in the style of a real
controller's bank machines (open-row register, precharge/activate timing,
per-rank tRRD/tFAW activation windows, a request queue per bank). The
reference module imports the JAX package's layouts for its event-driven
simulator, so the port does not import it; the code below is the same
arithmetic, held equal to it on the same slices by the CPU tests.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.layouts import LANES


@dataclass(frozen=True)
class Timing:
    """DRAM timing parameters, in memory-clock cycles (nCK).

    Defaults are the JEDEC **DDR4-2400** speed bin, CL-nRCD-nRP = 16-16-16
    (JESD79-4; the same parameter set Ramulator ships as ``DDR4_2400R`` and
    Micron documents for MT40A-083E parts): tCK = 0.833 ns, tCAS/tRCD/tRP =
    13.32 ns = 16 nCK, burst BL8 over a DDR bus = 4 nCK, tRRD_S = 4 nCK
    (≥ 3.3 ns, x8 parts / 1 KB pages), tFAW = 26 nCK (≥ 21 ns).

    ``bridge`` is CREAM's +1-cycle bridge-chip translation (paper §4.4) and
    is the one parameter not drawn from the JEDEC bin.
    """
    tCK_ns: float = 0.833
    tRCD: int = 16
    tRP: int = 16
    tCL: int = 16
    tBL: int = 4          # 8 beats, DDR
    tRRD: int = 4         # ACT->ACT, different banks, same rank (tRRD_S)
    tFAW: int = 26        # rolling four-ACT window per rank
    bridge: int = 1       # CREAM bridge-chip translation (paper §4.4)


NUM_BANKS = 8


def bank_of(row: int) -> tuple[int, int]:
    """Pool row -> (bank, dram_row): consecutive rows hit different banks
    (paper Fig. 3's page->bank interleaving), as the bank attribution of
    :mod:`repro_torch.obs.memprof` needs it."""
    return row % NUM_BANKS, row // NUM_BANKS


@dataclass
class BankCounters:
    """Per-(chip, bank) census a :class:`BankMachine` accumulates."""
    accesses: int = 0
    row_hits: int = 0
    row_empty: int = 0        # miss with no row open (cold activate)
    row_conflicts: int = 0    # miss with a different row open (PRE + ACT)
    busy_cycles: int = 0      # Σ per-access service occupancy
    act_stall_cycles: int = 0  # cycles this bank waited on tRRD + tFAW
    faw_stall_cycles: int = 0  # the tFAW share of act_stall_cycles


@dataclass
class BankMachine:
    """Row-buffer state machine for one (chip, bank) slice."""
    open_row: int = -1
    free_at: int = 0
    counters: BankCounters = field(default_factory=BankCounters)


class RankTimers:
    """Per-chip (rank-subset) activation bookkeeping: tRRD + tFAW.

    A chip under rank subsetting is independently addressable, so each chip
    carries its own four-ACT window — the paper's §4.1.2 concurrency
    argument is exactly that these windows stop being shared.
    """

    def __init__(self, t: Timing):
        self.t = t
        self.last_act = -10**9
        self.act_times: list[int] = []     # up to the last 4 ACT cycles

    def earliest_act(self, ready: int) -> tuple[int, int]:
        """Earliest cycle an ACT may issue at/after ``ready``.

        Returns ``(act_at, faw_stall)`` where ``faw_stall`` is the share of
        the delay imposed by the four-ACT window alone (on top of tRRD)."""
        rrd_at = max(ready, self.last_act + self.t.tRRD)
        faw_at = rrd_at
        if len(self.act_times) >= 4:
            faw_at = max(rrd_at, self.act_times[-4] + self.t.tFAW)
        return faw_at, faw_at - rrd_at

    def commit_act(self, cycle: int) -> None:
        self.last_act = cycle
        self.act_times.append(cycle)
        if len(self.act_times) > 4:
            del self.act_times[0]


class BankArray:
    """All bank machines of one module: ``chips`` ranks × NUM_BANKS banks.

    ``access(slices, now)`` issues one lockstep page-slice access —
    ``slices`` is ``[(chip, bank, dram_row), ...]`` — applying per-bank
    row-buffer state, per-chip tRRD/tFAW activation limits and per-bank
    serialisation (a busy bank queues the access). Returns the completion
    cycle. ``bridge_cycles`` models CREAM's bridge-chip translation.
    """

    def __init__(self, timing: Timing | None = None, chips: int = LANES,
                 banks: int = NUM_BANKS, bridge_cycles: int = 0):
        self.t = timing or Timing()
        self.chips = chips
        self.banks = banks
        self.bridge = bridge_cycles
        self.machines = [[BankMachine() for _ in range(banks)]
                         for _ in range(chips)]
        self.ranks = [RankTimers(self.t) for _ in range(chips)]
        self.finish_cycle = 0
        self.blp_samples: list[float] = []   # per-access overlap snapshots
        self.queue_depths: list[int] = []    # per-access waiting depth
        self.sample_times: list[int] = []    # issue cycle of each snapshot

    def machine(self, chip: int, bank: int) -> BankMachine:
        return self.machines[chip][bank]

    def access(self, slices, now: int) -> int:
        t = self.t
        done_max = now
        waiting = 0
        for chip, bank, drow in slices:
            m = self.machines[chip][bank]
            if m.free_at > now:
                waiting += 1
            start = max(now, m.free_at)
            if m.open_row == drow:
                m.counters.row_hits += 1
                lat = t.tCL
            else:
                act_ready = start + (0 if m.open_row < 0 else t.tRP)
                act_at, faw_stall = self.ranks[chip].earliest_act(act_ready)
                m.counters.act_stall_cycles += act_at - act_ready
                m.counters.faw_stall_cycles += faw_stall
                self.ranks[chip].commit_act(act_at)
                if m.open_row < 0:
                    m.counters.row_empty += 1
                else:
                    m.counters.row_conflicts += 1
                lat = (act_at - start) + t.tRCD + t.tCL
            done = start + lat + t.tBL + self.bridge
            m.counters.accesses += 1
            m.counters.busy_cycles += done - start
            m.open_row = drow
            m.free_at = done
            done_max = max(done_max, done)
        # overlap snapshot: banks still busy after this access issued
        busy = sum(1 for row in self.machines for m in row
                   if m.free_at > now)
        self.blp_samples.append(float(busy))
        self.queue_depths.append(waiting)
        self.sample_times.append(now)
        self.finish_cycle = max(self.finish_cycle, done_max)
        return done_max

    # -- aggregate census ----------------------------------------------------
    def totals(self) -> BankCounters:
        tot = BankCounters()
        for row in self.machines:
            for m in row:
                c = m.counters
                tot.accesses += c.accesses
                tot.row_hits += c.row_hits
                tot.row_empty += c.row_empty
                tot.row_conflicts += c.row_conflicts
                tot.busy_cycles += c.busy_cycles
                tot.act_stall_cycles += c.act_stall_cycles
                tot.faw_stall_cycles += c.faw_stall_cycles
        return tot

    @property
    def row_hit_rate(self) -> float:
        tot = self.totals()
        return tot.row_hits / tot.accesses if tot.accesses > 0 else 0.0

    @property
    def achieved_blp(self) -> float:
        """Busy-bank cycles over the makespan — banks genuinely overlapping
        service. 0.0 for an empty replay (division guard)."""
        tot = self.totals()
        return tot.busy_cycles / self.finish_cycle \
            if self.finish_cycle > 0 else 0.0

    def blp_histogram(self, bins: int = 8) -> list[int]:
        """Histogram of per-access busy-bank snapshots (overlap levels)."""
        counts = [0] * bins
        for v in self.blp_samples:
            counts[min(int(v), bins - 1)] += 1
        return counts

    def queue_depth_percentile(self, q: float) -> float:
        if not self.queue_depths:
            return 0.0
        return float(np.percentile(np.asarray(self.queue_depths), q))
