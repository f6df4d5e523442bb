"""The router-fused read's status output.

The plain version of ``read_correct_routed(..., status=True)`` against S
reference ``PoolState`` banks driven through ``router.route_np`` (the
reference's own sharded pool runs at S = 1 only under the installed JAX),
on pools with planted data-bit, code-bit and double-bit flips: data and
per-page status equal, and the data equal to the status-free read.
``ShardedPool.read(status=True)`` takes the fused read exactly when the
pool has no DAEC tier and is not PARITY, and the serving engine's
metrics-on gather on such a pool is one fused read with status whose
folded counts equal a status read of the same ids.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pool as jpool
from repro.core import secded as jsec
from repro.core.layouts import Layout as JLayout
from repro_torch.configs.base import ModelConfig
from repro_torch.core.layouts import Layout
from repro_torch.kernels import common
from repro_torch.kernels.mixed import ops as mixed_ops
from repro_torch.kernels.mixed import ref as mixed_ref
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import slo as obs_slo
from repro_torch.obs import tracing as obs_tracing
from repro_torch.serve import Engine, ServeRequest
from repro_torch.serve import engine as engine_mod
from repro_torch.shard import make_sharded_pool, router
from repro_torch.shard import pool as shard_pool
from repro_torch.vm.address_space import VirtualMemory

ROWS, W = 128, 16
LAYOUTS = [Layout.INTERWRAP, Layout.PACKED, Layout.RANK_SUBSET,
           Layout.PARITY, Layout.BASELINE_ECC]


def _banks(layout, S, seed):
    """(S, R_local, 9, W) words whose SECDED rows carry valid codes, with a
    data-bit, a code-bit and a same-beat double flip in each bank's first
    three SECDED rows, and a data-bit flip in a second beat of the fourth."""
    rng = np.random.default_rng(seed)
    b_local = 0 if layout == Layout.BASELINE_ECC else ROWS // (2 * S)
    r_local = ROWS // S
    sto = rng.integers(0, 2**32, (S, r_local, 9, W), dtype=np.uint32)
    for s in range(S):
        data = sto[s, b_local:, :8].reshape(r_local - b_local, 8 * W)
        codes = np.array(jsec.encode_block(jnp.asarray(data)))
        data[0, 3] ^= np.uint32(1 << 5)
        codes[1, 1] ^= np.uint32(1 << 9)
        data[2, 6] ^= np.uint32((1 << 2) | (1 << 9))
        data[3, 2 * W + 1] ^= np.uint32(1 << 30)
        sto[s, b_local:, :8] = data.reshape(-1, 8, W)
        sto[s, b_local:, 8] = codes
    return sto, S * b_local


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: l.value)
def test_plain_routed_status_equals_reference_banks(layout, S):
    sto, boundary = _banks(layout, S, seed=11 * S + LAYOUTS.index(layout))
    b_local = boundary // S
    jl = JLayout(layout.value)
    banks = [jpool.PoolState(jnp.asarray(sto[s]), b_local, jl, W)
             for s in range(S)]
    n_pages = ROWS + S * banks[0].num_extra_pages
    ids = np.random.default_rng(S).permutation(n_pages).astype(np.int32)
    words = common.to_words(sto)
    data, status = mixed_ops.read_correct_routed(
        words, torch.as_tensor(ids), layout, ROWS, boundary, S, status=True)
    np.testing.assert_array_equal(
        common.to_u32(data), common.to_u32(mixed_ref.read_correct_routed(
            words, torch.as_tensor(ids), layout, ROWS, boundary, S)))
    shard, local = router.route_np(ids, ROWS, S)
    want_d = np.zeros((ids.size, 8 * W), np.uint32)
    want_s = np.zeros(ids.size, np.int32)
    for s in range(S):
        own = shard == s
        d, st = jpool.read_pages_any_status(banks[s],
                                            jnp.asarray(local[own]))
        want_d[own], want_s[own] = np.asarray(d), np.asarray(st)
    np.testing.assert_array_equal(common.to_u32(data), want_d)
    if layout == Layout.PARITY:
        # the fused read decodes SECDED pages only; the parity check of the
        # CREAM pages is the local engine's, so compare the SECDED pages
        sec = (local >= b_local) & (local < ROWS // S)
        np.testing.assert_array_equal(status.numpy()[sec], want_s[sec])
        assert (status.numpy()[~sec] == 0).all()
    else:
        np.testing.assert_array_equal(status.numpy(), want_s)
    if layout != Layout.INTERWRAP or S > 1:
        return
    assert set(status.tolist()) == {0, 1, 2, 3}


@pytest.mark.parametrize("daec,layout,fused", [
    (0, Layout.INTERWRAP, True), (0, Layout.BASELINE_ECC, True),
    (8, Layout.INTERWRAP, False), (0, Layout.PARITY, False)])
def test_sharded_status_read_takes_the_fused_read_when_it_can(
        daec, layout, fused, monkeypatch):
    sp = make_sharded_pool(64, layout, boundary=32, num_shards=2,
                           row_words=W, daec_rows=daec, device="cpu")
    ids = np.arange(sp.num_pages)
    rng = np.random.default_rng(5)
    sp = sp.write(ids, rng.integers(0, 2**32, (ids.size, sp.page_words),
                                    dtype=np.uint32))
    sp.storage[1, 20, 3, 2] ^= 1 << 4          # a single in bank 1
    assert sp.fused_status == fused
    calls = []
    real = mixed_ops.read_correct_routed
    monkeypatch.setattr(mixed_ops, "read_correct_routed",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    want = shard_pool._read_status(sp, ids)
    data, status = sp.read(ids, status=True)
    assert calls == ([{"status": True}] if fused else [])
    assert torch.equal(data, want[0]) and torch.equal(status, want[1])
    assert int(status.max()) == 1


CFG = ModelConfig(name="serve-test", family="dense", num_layers=2,
                  d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                  vocab_size=256, head_dim=16, dtype="float32")


def test_engine_metrics_gather_on_a_sharded_pool_is_one_fused_read(
        monkeypatch):
    vm = VirtualMemory(row_words=2 * 2 * 16, device="cpu")
    vm.add_pool("kv", 64, Layout.INTERWRAP, boundary=32, shards=4)
    eng = Engine(CFG, vm=vm, pool="kv", max_batch=4, max_len=32, seed=0)
    rng = np.random.default_rng(1)
    for i in range(4):
        eng.submit(ServeRequest(f"r{i}", rng.integers(0, 256, 12)
                                .astype(np.int32), 6))
    calls = {"routed": [], "bank": 0}
    real = mixed_ops.read_correct_routed
    monkeypatch.setattr(mixed_ops, "read_correct_routed",
                        lambda *a, **k: calls["routed"].append(k)
                        or real(*a, **k))
    real_bank = shard_pool._read_status

    def bank(*a, **k):
        calls["bank"] += 1
        return real_bank(*a, **k)
    monkeypatch.setattr(shard_pool, "_read_status", bank)
    obs_metrics.enable()
    try:
        while eng.steps == 0:
            eng.poll()
        phys = eng.kv.gather_phys(np.arange(eng.max_batch)).reshape(-1)
        calls["routed"].clear()
        data, counts = eng._gather_pages_counts(phys)
        assert calls == {"routed": [{"status": True}], "bank": 0}
        d2, st = real_bank(eng.pool, np.asarray(phys, np.int64))
        assert torch.equal(data, d2)
        rows4 = engine_mod._status_rows(eng.pool, phys)
        assert torch.equal(counts, engine_mod._status_counts(
            torch.as_tensor(rows4), st))
    finally:
        obs_metrics.disable()
        obs_metrics.REGISTRY.clear()
        obs_tracing.reset()
        obs_slo.TRACKER.reset()
