"""The port's RegionManager runs the reference's scrub -> monitor -> adapt
loop step for step.

A reference ``repro.core.regions.RegionManager`` and a port one (on the
CPU) get the same regions and the same faults, and after every
``scrub_all`` / ``adapt`` they must hold identical transitions, scrub
censuses, monitor rates, capacity reports, evictions and storage:

  * the scenario of ``tests/test_system.py`` (a quiet region downgraded,
    a sickened PARITY region upgraded to SECDED);
  * the eight epochs of ``examples/adaptive_reliability.py`` (``batch_kv``
    and ``database`` SECDED -> PARITY at epoch 1; the DIMM under
    ``database`` flips bits from epoch 3, which takes ``batch_kv`` PARITY
    -> NONE and ``database`` back to SECDED; 160 -> 172 -> 168 pages);
  * operator-forced ``set_protection`` through every rung of the ladder,
    with seeded contents that every regular page keeps.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import injection as jinj
from repro.core import pool as jp
from repro.core.injection import FaultModel as JFault
from repro.core.monitor import MonitorConfig as JMonitorConfig
from repro.core.protection import Protection as JProt
from repro.core.protection import RegionSpec as JSpec
from repro.core.regions import RegionManager as JManager
from repro_torch.core import injection as tinj
from repro_torch.core import pool as tp
from repro_torch.core.injection import FaultModel
from repro_torch.core.layouts import Layout
from repro_torch.core.monitor import MonitorConfig
from repro_torch.core.protection import Protection, RegionSpec
from repro_torch.core.protection import (ADMISSIBLE_LAYOUTS, capacity_gain,
                                         default_layout)
from repro_torch.core.regions import RegionManager
from repro_torch.kernels import common

#: the example's monitor settings
EXAMPLE_MONITOR = dict(window=2, upgrade_threshold=5e-8,
                       downgrade_threshold=1e-9, downgrade_patience=2)


def _u32(t: torch.Tensor) -> np.ndarray:
    return common.to_u32(t)


def _trans(trans) -> list[tuple]:
    return [(n, a.value, b.value) for n, a, b in trans]


class Twin:
    """A reference and a port manager with the same regions."""

    def __init__(self, monitor: dict, regions: list[tuple]):
        self.j = JManager(JMonitorConfig(**monitor))
        self.t = RegionManager(MonitorConfig(**monitor), device="cpu")
        for name, prot, rows, floor in regions:
            self.j.add_region(JSpec.make(name, JProt(prot), rows,
                                         min_protection=JProt(floor)))
            self.t.add_region(RegionSpec.make(name, Protection(prot), rows,
                                              min_protection=Protection(
                                                  floor)))
        self.check()

    def check(self) -> None:
        assert self.t.capacity_report() == self.j.capacity_report()
        assert self.t.total_capacity_pages() == self.j.total_capacity_pages()
        assert _trans(self.t.transitions) == _trans(self.j.transitions)
        for name, jr in self.j.regions.items():
            tr = self.t.regions[name]
            assert tr.evictions == jr.evictions, name
            assert tr.spec.layout.value == jr.spec.layout.value
            assert tr.protection.value == jr.protection.value
            assert (tr.pool.boundary, tr.pool.layout.value,
                    tr.pool.daec_rows) == (jr.pool.boundary,
                                           jr.pool.layout.value,
                                           jr.pool.daec_rows)
            np.testing.assert_array_equal(_u32(tr.pool.storage),
                                          np.asarray(jr.pool.storage),
                                          err_msg=name)

    def set_storage(self, name: str, sto: np.ndarray) -> None:
        jr, tr = self.j.regions[name], self.t.regions[name]
        jr.pool = dataclasses.replace(jr.pool, storage=jnp.asarray(sto))
        tr.pool = dataclasses.replace(tr.pool, storage=common.to_words(sto))

    def epoch(self) -> list[tuple]:
        js, ts = self.j.scrub_all(), self.t.scrub_all()
        assert {k: vars(v) for k, v in ts.items()} == \
            {k: vars(v) for k, v in js.items()}
        for name in self.j.regions:
            assert self.t.monitor.rate(name) == self.j.monitor.rate(name)
        self.check()
        jt, tt = self.j.adapt(), self.t.adapt()
        assert _trans(tt) == _trans(jt)
        self.check()
        return _trans(tt)


def test_region_descriptors_equal_the_reference():
    from repro.core import protection as jprot
    for p in Protection:
        jpp = JProt(p.value)
        assert [l.value for l in ADMISSIBLE_LAYOUTS[p]] == \
            [l.value for l in jprot.ADMISSIBLE_LAYOUTS[jpp]]
        assert default_layout(p).value == jprot.default_layout(jpp).value
        assert capacity_gain(p) == jprot.capacity_gain(jpp)
    with pytest.raises(ValueError, match="invalid"):
        capacity_gain(Protection.PARITY, Layout.INTERWRAP)
    with pytest.raises(ValueError, match="invalid"):
        RegionSpec("x", Protection.NONE, Layout.PARITY, 8)
    spec = RegionSpec.make("kv", Protection.NONE, 16,
                           min_protection=Protection.PARITY)
    jspec = JSpec.make("kv", JProt.NONE, 16, min_protection=JProt.PARITY)
    assert (spec.layout.value, spec.rows, spec.min_protection.value,
            spec.max_protection.value) == (
        jspec.layout.value, jspec.rows, jspec.min_protection.value,
        jspec.max_protection.value)


def test_add_region_refuses_unaligned_rows_and_needs_a_device(monkeypatch):
    mgr = RegionManager(device="cpu")
    with pytest.raises(ValueError, match="group-aligned"):
        mgr.add_region(RegionSpec.make("x", Protection.SECDED, 12))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RegionManager()


def test_system_scenario_in_lockstep():
    """tests/test_system.py::test_adaptive_region_manager_moves_capacity."""
    tw = Twin(dict(window=2, upgrade_threshold=1e-7,
                   downgrade_threshold=1e-9, downgrade_patience=2),
              [("kv", "secded", 32, "none"), ("wt", "parity", 32, "parity")])
    before = tw.t.total_capacity_pages()
    for _ in range(3):
        js, ts = tw.j.scrub_all(), tw.t.scrub_all()
        assert {k: vars(v) for k, v in ts.items()} == \
            {k: vars(v) for k, v in js.items()}
    trans = _trans(tw.t.adapt())
    assert trans == _trans(tw.j.adapt())
    assert ("kv", "secded", "parity") in trans
    tw.check()
    assert tw.t.total_capacity_pages() > before
    # sicken 'wt' -> upgrade to SECDED
    jsto, _ = jinj.inject_flips(tw.j.regions["wt"].pool.storage,
                                np.random.default_rng(0), 200)
    tsto, _ = tinj.inject_flips(tw.t.regions["wt"].pool.storage,
                                np.random.default_rng(0), 200)
    np.testing.assert_array_equal(_u32(tsto), np.asarray(jsto))
    tw.set_storage("wt", np.asarray(jsto))
    assert ("wt", "parity", "secded") in tw.epoch()


EXAMPLE_EPOCHS = {0: ([], 160),
                  1: ([("batch_kv", "secded", "parity"),
                       ("database", "secded", "parity")], 172),
                  3: ([("batch_kv", "parity", "none"),
                       ("database", "parity", "secded")], 168)}


@pytest.fixture(scope="module")
def example():
    """The example's eight epochs run in lockstep; per-epoch results."""
    tw = Twin(EXAMPLE_MONITOR, [("batch_kv", "secded", 64, "none"),
                                ("database", "secded", 64, "parity"),
                                ("hypervisor", "secded", 32, "secded")])
    jfault = JFault.make(seed=0, soft_rate=2000.0, n_hard=0,
                         shape=(64, 9, 256))
    tfault = FaultModel.make(seed=0, soft_rate=2000.0, n_hard=0,
                             shape=(64, 9, 256))
    epochs = []
    for epoch in range(8):
        if epoch >= 3:   # the DIMM under 'database' starts flipping bits
            jsto, jn = jfault.step(tw.j.regions["database"].pool.storage)
            tsto, tn = tfault.step(tw.t.regions["database"].pool.storage)
            assert tn == jn > 0
            np.testing.assert_array_equal(_u32(tsto), np.asarray(jsto))
            tw.set_storage("database", np.asarray(jsto))
        trans = tw.epoch()
        epochs.append((trans, tw.t.total_capacity_pages()))
    return tw, epochs


@pytest.mark.parametrize("epoch", range(8))
def test_example_epoch_matches_the_reference(example, epoch):
    tw, epochs = example
    trans, cap = epochs[epoch]
    want_trans, want_cap = EXAMPLE_EPOCHS.get(
        epoch, ([], epochs[epoch - 1][1]))
    assert trans == want_trans
    assert cap == want_cap


def test_example_final_layout(example):
    tw, _ = example
    report = tw.t.capacity_report()
    assert {n: (r["protection"], r["pages"]) for n, r in report.items()} == \
        {"batch_kv": ("none", 72), "database": ("secded", 64),
         "hypervisor": ("secded", 32)}
    assert tw.t.regions["batch_kv"].evictions == \
        tw.j.regions["batch_kv"].evictions
    assert tw.t.regions["batch_kv"].evictions     # PARITY extras evicted


# every rung of the ladder and back, through the layout swaps. The
# reference's DAEC rung tags the pool BASELINE_ECC at boundary R and
# carves no DAEC tier; the port keeps that (ROADMAP, reference caveats).
LADDER_WALK = ["none", "parity", "secded", "daec", "parity", "none",
               "daec", "secded", "parity"]


@pytest.mark.parametrize("start", ["secded", "none", "parity"])
def test_set_protection_through_every_rung(start):
    tw = Twin(EXAMPLE_MONITOR, [("r", start, 32, "none")])
    rng = np.random.default_rng(11)
    j, t = tw.j.regions["r"], tw.t.regions["r"]
    ids = np.arange(32)                          # the regular pages
    data = rng.integers(0, 2**32, (32, 8 * 256), dtype=np.uint32)
    j.pool = j.pool.write(ids, jnp.asarray(data))
    t.pool = t.pool.write(ids, common.to_words(data))
    tw.check()
    for prot in LADDER_WALK:
        tw.j.set_protection("r", JProt(prot))
        tw.t.set_protection("r", Protection(prot))
        tw.check()
        got, st = tp.read_pages_any_status(t.pool, ids)
        np.testing.assert_array_equal(_u32(got), data)
        want, jst = jp.read_pages_any_status(j.pool, jnp.asarray(ids))
        np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
        # the extra pages read back as the reference's, status and all
        n = t.pool.num_pages
        if n > 32:
            extra = np.arange(32, n)
            gd, gs = tp.read_pages_any_status(t.pool, extra)
            wd, ws = jp.read_pages_any_status(j.pool, jnp.asarray(extra))
            np.testing.assert_array_equal(_u32(gd), np.asarray(wd))
            np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
