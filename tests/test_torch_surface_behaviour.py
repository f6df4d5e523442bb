"""Each name the port gained to complete the reference's surface, held
against the reference on the same numpy inputs, on the CPU.

  * ``kernels.mixed.ops.read_pool`` and ``kernels.hash.ops.lookup_pool``
    against the reference's (its plain version, ``use_kernel=False``, and
    its Pallas kernel in interpret mode) on an all-InterWrap, a PARITY and
    a mixed InterWrap pool with planted single flips: bit for bit.
  * ``read_correct_routed(..., shard_id=s)`` on every bank against the
    reference's one-bank form, the plain version and the kernel.
  * ``repro_torch.shard``'s ``write_any`` / ``read_any`` /
    ``read_any_status`` / ``read_any_writeback``: at S = 1 against the
    reference ``ShardedPool``'s functions, at S = 2 and 4 against S
    reference ``PoolState`` banks through ``router.route_np`` (the oracle
    rule of CREAM-Shard), with a DAEC tier, a PARITY pool and a write-back
    read; again on a 2-rank gloo mesh (``tests/torch_mesh_ranks.py``).
  * ``PoolLike`` on a local pool, a one-card and a mesh sharded pool and
    a shadowed pool; the SECDED tables, ``WORDS_PER_LINE`` and
    ``lines_per_row``; the pool's ``*_jit`` entry points; ``ceil_div`` /
    ``round_up``.
  * ``PagedKV.mapped_pages`` / ``used_pages`` through admit -> grow ->
    preempt -> restore, step for step; ``engine.Request``.
  * The functional model API on the smoke qwen3 with the reference's
    weights: ``init_params`` -> ``load_jax_params`` round trips, and
    ``forward`` / ``prefill`` / ``decode_step`` / ``decode_step_paged``
    logits within 1e-4 and greedy tokens equal; ``apply_embed`` /
    ``apply_lm_head``, ``init_kv_cache``, ``build_model(remat=)``.
  * ``use_kernel`` everywhere the reference takes it: accepted, and no
    value sends a non-CPU tensor to a plain version;
    ``MigrationEngine(vm, use_kernel=True)`` and ``False`` leave the same
    storage; ``RegionManager.scrub_all(use_kernel=)`` equals the
    reference's.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_mesh_ranks as ranks
from repro import shard as jshard
from repro.configs.registry import get_config as jget_config
from repro.core import layouts as jlayouts
from repro.core import pool as jpool
from repro.core import secded as jsec
from repro.core.layouts import Layout as JLayout
from repro.core.monitor import MonitorConfig as JMonitorConfig
from repro.core.protection import Protection as JProtection
from repro.core.protection import RegionSpec as JRegionSpec
from repro.core.regions import RegionManager as JRegionManager
from repro.kernels import common as jcommon
from repro.kernels.hash import ops as jhash_ops
from repro.kernels.mixed import ops as jmixed_ops
from repro.models import attention as jattention
from repro.models import common as jmodels_common
from repro.models import transformer as jtransformer
from repro.objcache import hash_index as jhix
from repro.serve import paged_kv as jpaged
from repro.vm import VirtualMemory as JVM
from repro_torch import shard
from repro_torch.configs.registry import get_config
from repro_torch.core import layouts, secded
from repro_torch.core import pool as tpool
from repro_torch.core.layouts import Layout
from repro_torch.core.monitor import MonitorConfig
from repro_torch.core.pool import PoolLike
from repro_torch.core.protection import Protection, RegionSpec
from repro_torch.core.regions import RegionManager
from repro_torch.faults.shadow import ShadowedPool
from repro_torch.kernels import common
from repro_torch.kernels.daec import ops as daec_ops
from repro_torch.kernels.hash import ops as hash_ops
from repro_torch.kernels.interwrap import ops as interwrap_ops
from repro_torch.kernels.migrate import ops as migrate_ops
from repro_torch.kernels.mixed import ops as mixed_ops
from repro_torch.kernels.mixed import ref as mixed_ref
from repro_torch.kernels.parity8 import ops as parity8_ops
from repro_torch.kernels.scrub import ops as scrub_ops
from repro_torch.kernels.secded import ops as secded_ops
from repro_torch.models import attention, build_model, transformer
from repro_torch.models import common as models_common
from repro_torch.models.model import load_jax_params, params_tree
from repro_torch.objcache import hash_index as hix
from repro_torch.serve import engine as tengine
from repro_torch.serve import paged_kv
from repro_torch.shard import make_sharded_pool, router
from repro_torch.vm import MigrationEngine, VirtualMemory
from repro_torch.vm.migration import MigrationEngine as TMig


def _u32(t) -> np.ndarray:
    return common.to_u32(t) if isinstance(t, torch.Tensor) else np.asarray(t)


def _flip_secded(sto: np.ndarray, boundary: int) -> None:
    """A single data-bit and a single code-bit flip in the first two
    SECDED rows (in place)."""
    if boundary + 2 <= sto.shape[0]:
        sto[boundary, 3, 5] ^= np.uint32(1 << 7)
        sto[boundary + 1, 8, 2] ^= np.uint32(1 << 12)


# ---------------------------------------------------------------------------
# read_pool and lookup_pool
# ---------------------------------------------------------------------------

ROWS, W = 32, 16
POOLS = {"interwrap": (Layout.INTERWRAP, ROWS),
         "parity": (Layout.PARITY, ROWS // 2),
         "mixed": (Layout.INTERWRAP, ROWS // 2)}


def _twin_pools(name: str):
    """The same written pool in both packages, single flips planted."""
    layout, boundary = POOLS[name]
    j = jpool.make_pool(ROWS, JLayout(layout.value), boundary=boundary,
                        row_words=W)
    rng = np.random.default_rng(len(name))
    data = rng.integers(0, 2**32, (j.num_pages, 8 * W), dtype=np.uint32)
    j = j.write(np.arange(j.num_pages), jnp.asarray(data))
    sto = np.array(j.storage)
    _flip_secded(sto, boundary)
    sto[0, 1, 2] ^= np.uint32(1 << 3)          # a CREAM-row flip
    j = dataclasses.replace(j, storage=jnp.asarray(sto))
    t = tpool.PoolState(common.to_words(sto), boundary, layout, W)
    return j, t, rng


@pytest.mark.parametrize("name", list(POOLS))
def test_read_pool_equals_the_reference(name):
    j, t, rng = _twin_pools(name)
    pages = rng.permutation(j.num_pages).astype(np.int32)
    want = np.asarray(jmixed_ops.read_pool(j, jnp.asarray(pages),
                                           use_kernel=False))
    np.testing.assert_array_equal(
        np.asarray(jmixed_ops.read_pool(j, jnp.asarray(pages),
                                        use_kernel=True)), want)
    for uk in (None, False, True):
        got = mixed_ops.read_pool(t, torch.as_tensor(pages), use_kernel=uk)
        np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("name", list(POOLS))
def test_lookup_pool_equals_the_reference(name):
    j, t, rng = _twin_pools(name)
    keys = rng.choice(10_000, 12, replace=False).astype(np.uint32)
    pages = rng.permutation(j.num_pages)[:12].astype(np.int32)
    args = (jnp.asarray(pages), jnp.zeros(12, jnp.int32),
            jnp.full(12, 8, jnp.int32))
    jidx, _, ok = jhix.insert(jhix.make_index(32, 8), jnp.asarray(keys),
                              *args)
    assert np.asarray(ok).all()
    tidx = hix.make_index(32, 8, device="cpu")
    tidx, _, _ = hix.insert(tidx, common.to_words(keys),
                            torch.as_tensor(pages),
                            torch.zeros(12, dtype=torch.int32),
                            torch.full((12,), 8, dtype=torch.int32))
    queries = np.concatenate([keys, [55555, 7]]).astype(np.uint32)
    want = np.asarray(jhash_ops.lookup_pool(j, jidx, jnp.asarray(queries),
                                            use_kernel=False))
    np.testing.assert_array_equal(np.asarray(jhash_ops.lookup_pool(
        j, jidx, jnp.asarray(queries), use_kernel=True)), want)
    for uk in (None, False, True):
        got = hash_ops.lookup_pool(t, tidx, common.to_words(queries),
                                   use_kernel=uk)
        np.testing.assert_array_equal(_u32(got), want)


# ---------------------------------------------------------------------------
# read_correct_routed's one-bank form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("layout", [Layout.INTERWRAP, Layout.PARITY],
                         ids=lambda l: l.value)
def test_routed_read_of_one_bank_equals_the_reference(layout, S):
    rows, b_local = 64, 32 // S
    rng = np.random.default_rng(S)
    banks = []
    for _ in range(S):
        b = jpool.make_pool(rows // S, JLayout(layout.value),
                            boundary=b_local, row_words=W)
        data = rng.integers(0, 2**32, (b.num_pages, 8 * W), dtype=np.uint32)
        sto = np.array(b.write(np.arange(b.num_pages),
                               jnp.asarray(data)).storage)
        _flip_secded(sto, b_local)
        banks.append(sto)
    n = rows + S * b.num_extra_pages
    ids = rng.permutation(n).astype(np.int32)
    words = common.to_words(np.stack(banks))
    for s in range(S):
        args = (jnp.asarray(banks[s]), jnp.asarray(ids),
                JLayout(layout.value), rows, S * b_local, S, jnp.int32(s))
        want = np.asarray(jmixed_ops.read_correct_routed(*args,
                                                         use_kernel=False))
        np.testing.assert_array_equal(np.asarray(
            jmixed_ops.read_correct_routed(*args, use_kernel=True)), want)
        targs = (words[s].contiguous(), torch.as_tensor(ids), layout, rows,
                 S * b_local, S)
        np.testing.assert_array_equal(
            _u32(mixed_ops.read_correct_routed(*targs, shard_id=s)), want)
        np.testing.assert_array_equal(
            _u32(mixed_ref.read_correct_routed(*targs, shard_id=s)), want)
        got, st = mixed_ops.read_correct_routed(*targs, shard_id=s,
                                                status=True)
        np.testing.assert_array_equal(_u32(got), want)
        own = router.route_np(ids, rows, S)[0] == s
        assert not st[torch.as_tensor(~own)].any()
    # shard_id=None is still the all-banks read of (S, R_local, 9, W)
    all_banks = mixed_ops.read_correct_routed(words, torch.as_tensor(ids),
                                              layout, rows, S * b_local, S)
    acc = sum(_u32(mixed_ops.read_correct_routed(
        words[s].contiguous(), torch.as_tensor(ids), layout, rows,
        S * b_local, S, shard_id=s)).astype(np.uint64) for s in range(S))
    np.testing.assert_array_equal(_u32(all_banks), acc.astype(np.uint32))


# ---------------------------------------------------------------------------
# CREAM-Shard's module functions
# ---------------------------------------------------------------------------

SW = 16
CASES = {"interwrap": (Layout.INTERWRAP, False), "daec":
         (Layout.INTERWRAP, True), "parity": (Layout.PARITY, False)}


def _spec(case: str, S: int) -> dict:
    """Geometry, a write with duplicate ids and a valid mask, and flips:
    single data- and code-bit flips and a same-beat double in every
    bank's first SECDED rows, an adjacent double in a DAEC row, a CREAM
    row's flip."""
    layout, daec = CASES[case]
    rows, boundary = 32 * S, 16 * S
    b_local, r_local = boundary // S, rows // S
    extra = jpool.make_pool(r_local, JLayout(layout.value),
                            boundary=b_local, row_words=SW).num_extra_pages
    n = rows + S * extra
    rng = np.random.default_rng(S + 7 * len(case))
    ids = np.concatenate([rng.permutation(n), rng.integers(0, n, 7)])
    flips = []
    for s in range(S):
        flips += [(s, b_local, 2, 5, 7), (s, b_local + 1, 8, 3, 1),
                  (s, b_local + 2, 4, 0, 3), (s, b_local + 2, 4, 0, 4),
                  (s, 1, 3, 2, 9)]
        if daec:
            flips += [(s, r_local - 1, 5, 6, 10), (s, r_local - 1, 5, 6, 11)]
    return dict(rows=rows, W=SW, layout=layout.value, boundary=boundary,
                daec=2 * S if daec else 0, ids=ids.astype(np.int64),
                data=rng.integers(0, 2**32, (ids.size, 8 * SW),
                                  dtype=np.uint32),
                valid=rng.random(ids.size) < 0.9,
                all_ids=rng.permutation(n).astype(np.int64),
                flips=np.asarray(flips, np.int64))


def _oracle(spec: dict, S: int) -> dict:
    """S reference PoolState banks through the same sequence, routed by
    ``router.route_np`` -> the expected records (banks stacked)."""
    rows = int(spec["rows"])
    banks = [jpool.make_pool(rows // S, JLayout(str(spec["layout"])),
                             boundary=int(spec["boundary"]) // S,
                             row_words=SW, daec_rows=int(spec["daec"]) // S)
             for _ in range(S)]
    land = tpool._landing_rows(spec["ids"], spec["valid"])
    shard_of, local = router.route_np(spec["ids"], rows, S)
    for s in range(S):
        own = land & (shard_of == s)
        banks[s] = jpool.write_pages_any(banks[s], local[own],
                                         jnp.asarray(spec["data"][own]))
    out = {"write": np.stack([np.asarray(b.storage) for b in banks])}
    ids = spec["all_ids"]
    shard_of, local = router.route_np(ids, rows, S)

    def read(fn):
        data = np.zeros((ids.size, 8 * SW), np.uint32)
        status = np.zeros(ids.size, np.uint32)
        for s in range(S):
            own = shard_of == s
            got = fn(s, local[own])
            data[own], status[own] = np.asarray(got[0]), np.asarray(got[1])
        return data, status

    out["read_status"] = read(
        lambda s, loc: jpool.read_pages_any_status(banks[s], loc))
    sto = np.stack([np.array(b.storage) for b in banks])
    for s, r, ln, w, bit in spec["flips"]:
        sto[s, r, ln, w] ^= np.uint32(1 << int(bit))
    banks = [dataclasses.replace(b, storage=jnp.asarray(sto[s]))
             for s, b in enumerate(banks)]
    out["flipped"] = sto.copy()
    out["flipped_status"] = read(
        lambda s, loc: jpool.read_pages_any_status(banks[s], loc))
    new = list(banks)

    def writeback(s, loc):
        data, status, new[s] = jpool.read_pages_any_writeback(banks[s], loc)
        return data, status

    out["writeback"] = read(writeback)
    out["after_writeback"] = np.stack([np.asarray(b.storage) for b in new])
    banks = new
    out["clean_status"] = read(
        lambda s, loc: jpool.read_pages_any_status(banks[s], loc))
    return out


def _one_card(spec: dict, S: int) -> dict:
    pool = make_sharded_pool(int(spec["rows"]), Layout(str(spec["layout"])),
                             int(spec["boundary"]), num_shards=S,
                             row_words=SW, daec_rows=int(spec["daec"]),
                             device="cpu")
    out = {}

    def record(name, value):
        if isinstance(value, shard.ShardedPool):
            value = value.storage
        vals = value if isinstance(value, tuple) else (value,)
        out[name] = tuple(_u32(v) for v in vals)

    ranks.shard_functions_sequence(pool, spec, record)
    return out


def _check_records(got: dict, want: dict, where: str) -> None:
    assert got["poollike"][0].all() and got["input_kept"][0].all(), where
    np.testing.assert_array_equal(got["write"][0], want["write"],
                                  err_msg=where)
    np.testing.assert_array_equal(got["read"][0], want["read_status"][0],
                                  err_msg=where)
    for name in ("read_status", "flipped_status", "writeback",
                 "clean_status"):
        for g, w in zip(got[name], want[name]):
            np.testing.assert_array_equal(g, w, err_msg=f"{where} {name}")
    np.testing.assert_array_equal(got["flipped_kept"][0], want["flipped"],
                                  err_msg=where)
    np.testing.assert_array_equal(got["after_writeback"][0],
                                  want["after_writeback"], err_msg=where)


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_shard_functions_equal_the_reference_banks(case, S):
    spec = _spec(case, S)
    want = _oracle(spec, S)
    got = _one_card(spec, S)
    _check_records(got, want, f"{case} S={S}")
    # the flips were seen and the write-back repaired what they corrected
    st = want["flipped_status"][1]
    assert {1, 2, 3} <= set(st.tolist()) or case == "parity"
    assert 3 in set(st.tolist())
    assert set(want["clean_status"][1].tolist()) <= {0, 3}


@pytest.mark.parametrize("case", list(CASES))
def test_shard_functions_equal_the_reference_sharded_pool(case):
    """At S = 1 the reference's own module functions run (jitted: eager,
    each shard_map body dispatches op by op, ~30x slower)."""
    spec = _spec(case, 1)
    write_any, read_any, read_any_status, read_any_writeback = (
        jax.jit(f) for f in (jshard.write_any, jshard.read_any,
                             jshard.read_any_status,
                             jshard.read_any_writeback))
    j = jshard.make_sharded_pool(int(spec["rows"]),
                                 JLayout(str(spec["layout"])),
                                 int(spec["boundary"]), num_shards=1,
                                 row_words=SW, daec_rows=int(spec["daec"]))
    j = write_any(j, spec["ids"], jnp.asarray(spec["data"]),
                  valid=spec["valid"])
    got = _one_card(spec, 1)
    np.testing.assert_array_equal(got["write"][0], np.asarray(j.storage))
    ids = spec["all_ids"]
    np.testing.assert_array_equal(got["read"][0],
                                  np.asarray(read_any(j, ids)))
    for g, w in zip(got["read_status"], read_any_status(j, ids)):
        np.testing.assert_array_equal(g, np.asarray(w))
    j = dataclasses.replace(j, storage=jax.device_put(
        jnp.asarray(got["flipped_kept"][0]), j.storage.sharding))
    for g, w in zip(got["flipped_status"], read_any_status(j, ids)):
        np.testing.assert_array_equal(g, np.asarray(w))
    data, status, j = read_any_writeback(j, ids)
    np.testing.assert_array_equal(got["writeback"][0], np.asarray(data))
    np.testing.assert_array_equal(got["writeback"][1], np.asarray(status))
    np.testing.assert_array_equal(got["after_writeback"][0],
                                  np.asarray(j.storage))


def test_shard_functions_on_a_two_rank_mesh(tmp_path):
    S = 2
    specs, paths = [], []
    for i, case in enumerate(CASES):
        spec = _spec(case, S)
        path = tmp_path / f"spec{i}.npz"
        np.savez(path, **spec)
        specs.append(spec)
        paths.append(str(path))
    out = tmp_path / "out"
    out.mkdir()
    ranks.run_ranks(ranks.shard_functions_rank, S, tmp_path, paths,
                    str(out), timeout=120.0)
    for r in range(S):
        assert (out / f"modules_r{r}.json").read_text() == "[]"
    for i, (case, spec) in enumerate(zip(CASES, specs)):
        want = _oracle(spec, S)
        for r in range(S):
            def load(name, r=r, i=i):
                k = 0
                vals = []
                while (out / f"r{r}_{i}_{name}_{k}.npy").exists():
                    vals.append(np.load(out / f"r{r}_{i}_{name}_{k}.npy"))
                    k += 1
                return tuple(vals)
            got = {name: load(name) for name in (
                "poollike", "input_kept", "write", "read", "read_status",
                "flipped_status", "writeback", "clean_status")}
            # each rank holds its own bank
            for name in ("write", "flipped_kept", "after_writeback"):
                got[name] = (np.stack([np.load(
                    out / f"r{b}_{i}_{name}_0.npy") for b in range(S)]),)
            _check_records(got, want, f"mesh {case} rank {r}")


# ---------------------------------------------------------------------------
# PoolLike, the tables, the pool's *_jit entry points, tiling helpers
# ---------------------------------------------------------------------------


def test_every_pool_kind_is_a_poollike():
    local = tpool.make_pool(16, row_words=SW, device="cpu")
    sharded = make_sharded_pool(32, num_shards=2, row_words=SW, device="cpu")
    for p in (local, sharded, ShadowedPool(local), ShadowedPool(sharded)):
        assert isinstance(p, PoolLike), type(p)
    assert not isinstance(object(), PoolLike)
    assert isinstance(jpool.make_pool(16, row_words=SW), jpool.PoolLike)


def test_secded_tables_and_line_geometry_equal_the_reference():
    for name in ("MASK_LO", "MASK_HI", "SYNDROME_TABLE", "H_COLUMNS"):
        got = getattr(secded, name)
        assert got.dtype == torch.int32, name
        want = np.asarray(getattr(jsec, name))
        np.testing.assert_array_equal(got.numpy().view(want.dtype), want,
                                      err_msg=name)
    assert layouts.WORDS_PER_LINE == jlayouts.WORDS_PER_LINE
    for rw in (16, 64, 256):
        assert layouts.lines_per_row(rw) == jlayouts.lines_per_row(rw)
    assert layouts.lines_per_row() == jlayouts.lines_per_row()


def test_tiling_helpers_equal_the_reference():
    for a in range(0, 40):
        for b in (1, 3, 8, 16):
            assert common.ceil_div(a, b) == jcommon.ceil_div(a, b)
            assert common.round_up(a, b) == jcommon.round_up(a, b)


def test_pool_jit_entry_points_equal_the_reference():
    j, t, rng = _twin_pools("mixed")
    pages = rng.permutation(j.num_pages)[:20].astype(np.int32)
    np.testing.assert_array_equal(
        _u32(tpool.read_pages_any_jit(t, pages)),
        np.asarray(jpool.read_pages_any_jit(j, pages)))
    for g, w in zip(tpool.read_pages_any_status_jit(t, pages),
                    jpool.read_pages_any_status_jit(j, pages)):
        np.testing.assert_array_equal(_u32(g), np.asarray(w))
    data = rng.integers(0, 2**32, (20, 8 * W), dtype=np.uint32)
    j = jpool.write_pages_any_jit(j, pages, jnp.asarray(data))
    new = tpool.write_pages_any_jit(t, pages, common.to_words(data))
    assert new.storage is t.storage                 # in place: the donation
    np.testing.assert_array_equal(_u32(new.storage), np.asarray(j.storage))
    for fn in (tpool.read_pages_any_jit, tpool.read_pages_any_status_jit):
        with pytest.raises(ValueError, match="out of range"):
            fn(new, [new.num_pages])
    with pytest.raises(ValueError, match="out of range"):
        tpool.write_pages_any_jit(new, [-1], common.to_words(data[:1]))


# ---------------------------------------------------------------------------
# PagedKV's page accounting, step for step
# ---------------------------------------------------------------------------


def test_paged_kv_page_accounting_equals_the_reference():
    rows, rw = 32, 64
    j_vm, t_vm = JVM(row_words=rw), VirtualMemory(row_words=rw,
                                                  device="cpu")
    j_vm.add_pool("kv", rows, JLayout.INTERWRAP, boundary=rows - 8)
    t_vm.add_pool("kv", rows, Layout.INTERWRAP, boundary=rows - 8)
    kw = dict(n_layers=2, token_words=16, max_seqs=6, max_tokens=64)
    j = jpaged.PagedKV(j_vm, "kv", **kw)
    t = paged_kv.PagedKV(t_vm, "kv", **kw)
    assert t.block_tokens == j.block_tokens

    def same(step):
        assert t.used_pages() == j.used_pages(), step
        for row in j._rows:
            assert t.mapped_pages(row) == j.mapped_pages(row), (step, row)
        return t.used_pages()

    seen = [same("open")]
    rows_ = [(j.open(tier), t.open(tier)) for tier in
             ("paid", "batch", "batch", "paid")]
    assert all(a == b for a, b in rows_)
    rows_ = [a for a, _ in rows_]
    seen.append(same("admit"))
    for n in (5, 12, 20, 33):                    # grow
        for row in rows_:
            assert t.ensure(row, n) == j.ensure(row, n)
            seen.append(same(f"grow {n} row {row}"))
    for row in rows_[1:3]:                       # preempt the batch rows
        assert t.preempt(row) == j.preempt(row)
        seen.append(same(f"preempt {row}"))
    for row in rows_[1:3]:
        assert t.restore(row) == j.restore(row)
        seen.append(same(f"restore {row}"))
    t.close(rows_[0])
    j.close(rows_[0])
    seen.append(same("close"))
    assert max(seen) > seen[0] == 1              # the scratch page alone
    assert tengine.Request is tengine.ServeRequest


# ---------------------------------------------------------------------------
# The functional model API
# ---------------------------------------------------------------------------

LOGIT_ATOL = 1e-4


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree.detach().cpu() if isinstance(
        tree, torch.Tensor) else tree)}


@pytest.fixture(scope="module")
def qwen():
    jcfg = jget_config("qwen3-0.6b").smoke()
    cfg = get_config("qwen3-0.6b").smoke()
    jparams = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    model = load_jax_params(build_model(cfg, device="cpu"), np_tree)
    return jcfg, cfg, jparams, np_tree, params_tree(model)


def test_init_params_round_trips_through_load_jax_params(qwen):
    jcfg, cfg, _, np_tree, tparams = qwen
    # the reference's weights carried across come back leaf for leaf
    got, want = _flat(tparams), _flat(np_tree)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the port's own tree: the reference's shapes, and it loads back
    own = transformer.init_params(cfg, seed=3, device="cpu")
    flat = _flat(own)
    assert {k: v.shape for k, v in flat.items()} == \
        {k: v.shape for k, v in want.items()}
    back = _flat(params_tree(load_jax_params(
        build_model(cfg, seed=9, device="cpu"),
        jax.tree.map(np.asarray, {k: v for k, v in own.items()}))))
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    again = _flat(transformer.init_params(cfg, seed=3, device="cpu"))
    assert all(np.array_equal(again[k], flat[k]) for k in flat)


def _tokens(cfg, b: int, s: int) -> np.ndarray:
    return np.random.default_rng(b + s).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_forward_equals_the_reference(qwen):
    jcfg, cfg, jparams, _, tparams = qwen
    toks = _tokens(cfg, 2, 9)
    for mode in ("all", "last"):
        jl, jaux = jtransformer.forward(jparams, jcfg, jnp.asarray(toks),
                                        logits_mode=mode)
        tl, taux = transformer.forward(tparams, cfg, torch.as_tensor(toks),
                                       logits_mode=mode)
        np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0)
        assert float(taux) == pytest.approx(float(jaux), abs=1e-6)
    assert transformer.forward_fn is transformer.forward


def test_prefill_and_decode_step_equal_the_reference(qwen):
    jcfg, cfg, jparams, np_tree, tparams = qwen
    toks, max_len, steps = _tokens(cfg, 3, 7), 16, 6
    jl, jst = jtransformer.prefill(jparams, jcfg, jnp.asarray(toks), max_len)
    tl, tst = transformer.prefill(tparams, cfg, torch.as_tensor(toks),
                                  max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    # the methods on the same weights give the same values
    model = load_jax_params(build_model(cfg, device="cpu"), np_tree)
    ml, mst = model.prefill_state(torch.as_tensor(toks), max_len)
    assert torch.equal(ml, tl)
    jt = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    tt = tl[:, -1].argmax(-1).to(torch.int32)
    mt = tt.clone()
    for _ in range(steps):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jl, jst = jtransformer.decode_step(jparams, jcfg, jst, jt)
        tl, tst = transformer.decode_step(tparams, cfg, tst, tt)
        ml, mst = model.decode_step(mst, mt)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0)
        assert torch.equal(ml, tl)
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = tl.argmax(-1).to(torch.int32)
        mt = ml.argmax(-1).to(torch.int32)
    np.testing.assert_array_equal(tst["cache_len"].numpy(),
                                  np.asarray(jst["cache_len"]))
    assert transformer.decode_step_fn is transformer.decode_step


def test_decode_step_paged_equals_the_reference(qwen):
    jcfg, cfg, jparams, np_tree, tparams = qwen
    toks, pad = _tokens(cfg, 2, 6), 10
    _, jst = jtransformer.prefill(jparams, jcfg, jnp.asarray(toks), pad)
    ks = np.stack([np.asarray(jst[f"pos{i}"]["k"]) for i in
                   range(jcfg.period)], 1).reshape(
        (jcfg.num_layers, 2, pad) + jst["pos0"]["k"].shape[3:])
    vs = np.stack([np.asarray(jst[f"pos{i}"]["v"]) for i in
                   range(jcfg.period)], 1).reshape(ks.shape)
    state = {"cache_len": np.full((2,), 6, np.int32)}
    tok = toks[:, -1]
    jl, jnew, (jk, jv) = jtransformer.decode_step_paged(
        jparams, jcfg, {"cache_len": jnp.asarray(state["cache_len"])},
        jnp.asarray(tok), (jnp.asarray(ks), jnp.asarray(vs)))
    kv = (torch.as_tensor(ks), torch.as_tensor(vs))
    tstate = {"cache_len": torch.as_tensor(state["cache_len"])}
    tl, tnew, (tk, tv) = transformer.decode_step_paged(
        tparams, cfg, tstate, torch.as_tensor(tok), kv)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tnew["cache_len"].numpy(),
                                  np.asarray(jnew["cache_len"]))
    np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(jl, -1)))
    model = load_jax_params(build_model(cfg, device="cpu"), np_tree)
    ml, _, (mk, mv) = model.decode_step_paged(tstate, torch.as_tensor(tok),
                                              kv)
    assert torch.equal(ml, tl) and torch.equal(mk, tk)


def test_model_helpers_equal_the_reference(qwen):
    jcfg, cfg, jparams, _, tparams = qwen
    toks = _tokens(cfg, 2, 5)
    np.testing.assert_array_equal(
        models_common.apply_embed(tparams["embed"],
                                  torch.as_tensor(toks)).numpy(),
        np.asarray(jmodels_common.apply_embed(jparams["embed"],
                                              jnp.asarray(toks))))
    x = np.random.default_rng(0).standard_normal(
        (2, 3, cfg.d_model)).astype(np.float32)
    head = {"w": torch.as_tensor(np.asarray(jparams["embed"]["table"]).T
                                 .copy())}
    np.testing.assert_allclose(
        models_common.apply_lm_head(head, torch.as_tensor(x)).numpy(),
        np.asarray(jmodels_common.apply_lm_head(
            {"w": jnp.asarray(head["w"].numpy())}, jnp.asarray(x))),
        atol=1e-5, rtol=0)
    k, v = attention.init_kv_cache(cfg, 2, 16, 4, torch.float32)
    jk, jv = jattention.init_kv_cache(jcfg, 2, 16, 4, jnp.float32)
    assert tuple(k.shape) == jk.shape and tuple(v.shape) == jv.shape
    assert not k.any() and not v.any()
    for remat in ("none", "block", "full"):
        assert build_model(cfg, device="cpu", remat=remat).remat == remat
    with pytest.raises(ValueError, match="remat"):
        build_model(cfg, device="cpu", remat="bad")


# ---------------------------------------------------------------------------
# use_kernel: accepted everywhere, and the device decides
# ---------------------------------------------------------------------------

KW = 16


def _meta(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device="meta")


META_CALLS = {
    "secded.encode": lambda uk: secded_ops.encode(_meta(4, 8 * KW),
                                                  use_kernel=uk),
    "secded.decode": lambda uk: secded_ops.decode(
        _meta(4, 8 * KW), _meta(4, KW), use_kernel=uk),
    "daec.encode": lambda uk: daec_ops.encode(_meta(4, 8 * KW),
                                              use_kernel=uk),
    "mixed.read_correct": lambda uk: mixed_ops.read_correct(
        _meta(32, 9, KW), _meta(5), Layout.PARITY, 32, 16, use_kernel=uk),
    "mixed.read_pool": lambda uk: mixed_ops.read_pool(
        tpool.PoolState(_meta(32, 9, KW), 16, Layout.PARITY, KW), _meta(5),
        use_kernel=uk),
    "mixed.read_correct_routed": lambda uk: mixed_ops.read_correct_routed(
        _meta(2, 16, 9, KW), _meta(5), Layout.INTERWRAP, 32, 16, 2,
        use_kernel=uk),
    "mixed.read_correct_routed(shard_id)":
        lambda uk: mixed_ops.read_correct_routed(
            _meta(16, 9, KW), _meta(5), Layout.INTERWRAP, 32, 16, 2,
            shard_id=1, use_kernel=uk),
    "migrate.gather_encode": lambda uk: migrate_ops.gather_encode(
        _meta(32, 9, KW), _meta(5), 32, use_kernel=uk),
    "interwrap.gather": lambda uk: interwrap_ops.gather(
        _meta(32, 9, KW), _meta(5), 32, use_kernel=uk),
    "parity8.check": lambda uk: parity8_ops.check(
        _meta(4, 8 * KW), _meta(4, KW // 8), use_kernel=uk),
    "hash.lookup_pool": lambda uk: hash_ops.lookup_pool(
        tpool.PoolState(_meta(32, 9, KW), 16, Layout.PARITY, KW),
        hix.HashIndex(_meta(64), _meta(64), None, None, 8), _meta(5),
        use_kernel=uk),
    "scrub.scrub_rows": lambda uk: scrub_ops.scrub_rows(_meta(32, 9, KW),
                                                        use_kernel=uk),
}


@pytest.mark.parametrize("use_kernel", [None, False, True])
@pytest.mark.parametrize("name", list(META_CALLS))
def test_no_use_kernel_sends_a_device_tensor_to_a_plain_version(
        name, use_kernel):
    """A tensor off the CPU goes to the kernel or raises, whatever
    ``use_kernel`` says — here, with no card, it must raise before
    anything is built or launched."""
    with pytest.raises(ValueError, match="CUDA device"):
        META_CALLS[name](use_kernel)


@pytest.mark.parametrize("use_kernel", [None, False, True])
def test_cpu_tensors_take_the_plain_version_whatever_use_kernel_says(
        use_kernel):
    common.LAUNCHES.clear()
    j, t, rng = _twin_pools("mixed")
    pages = torch.as_tensor(rng.permutation(j.num_pages)[:8])
    want = mixed_ref.read_correct(t.storage, pages, t.layout, t.num_rows,
                                  t.boundary)
    assert torch.equal(mixed_ops.read_pool(t, pages, use_kernel=use_kernel),
                       want)
    data = mixed_ops.read_correct(t.storage, pages, t.layout, t.num_rows,
                                  t.boundary, use_kernel=use_kernel)
    assert torch.equal(data, want)
    secded_ops.decode(data, secded_ops.encode(data, use_kernel=use_kernel),
                      use_kernel=use_kernel)
    scrub_ops.scrub_rows(t.storage, use_kernel=use_kernel)
    assert sum(common.LAUNCHES.values()) == 0


def _vm_story(use_kernel: bool):
    """examples/vm_multitenant.py's pools and tenants, a fault, one policy
    step -> the VM."""
    from repro_torch.vm import VMPolicy
    rng = np.random.default_rng(0)
    vm = VirtualMemory(row_words=64, device="cpu")
    vm.add_pool("dimm0", 32, Layout.INTERWRAP, boundary=16)
    vm.add_pool("spare", 16, Layout.INTERWRAP, boundary=0)
    engine = MigrationEngine(vm, use_kernel=use_kernel)
    assert engine.use_kernel is use_kernel
    policy = VMPolicy(vm, engine, MonitorConfig(window=2,
                                                upgrade_threshold=1e-9))
    vm.create_tenant("secure", default_reliability=Protection.SECDED)
    vm.create_tenant("bulk", default_reliability=Protection.NONE)
    sec, bulk = vm.alloc("secure", 4), vm.alloc("bulk", 18)
    vm.write("secure", sec, common.to_words(rng.integers(
        0, 2**32, (4, vm.page_words), dtype=np.uint32)))
    vm.write("bulk", bulk, common.to_words(rng.integers(
        0, 2**32, (18, vm.page_words), dtype=np.uint32)))
    sto = vm.pools["dimm0"].storage.clone()
    sto[28, 3, 5] ^= 0b11
    vm.pools["dimm0"] = dataclasses.replace(vm.pools["dimm0"], storage=sto)
    _, performed = policy.step()
    assert performed and engine.stats.pages_moved == 2
    return vm


def test_migration_engine_use_kernel_leaves_the_same_storage():
    a, b = _vm_story(True), _vm_story(False)
    for name in a.pools:
        assert torch.equal(a.pools[name].storage, b.pools[name].storage)
        assert a.pools[name].boundary == b.pools[name].boundary
    assert TMig is MigrationEngine


@pytest.mark.parametrize("use_kernel", [False, True])
def test_region_manager_scrub_all_takes_use_kernel(use_kernel):
    jm = JRegionManager(JMonitorConfig(window=2))
    tm = RegionManager(MonitorConfig(window=2), device="cpu")
    jm.add_region(JRegionSpec.make("db", JProtection.SECDED, 16))
    tm.add_region(RegionSpec.make("db", Protection.SECDED, 16))
    rng = np.random.default_rng(1)
    sto = np.array(jm.regions["db"].pool.storage)
    for r in rng.permutation(16)[:5]:
        sto[r, rng.integers(0, 9), rng.integers(0, sto.shape[2])] ^= \
            np.uint32(1 << int(rng.integers(0, 32)))
    jm.regions["db"].pool = dataclasses.replace(jm.regions["db"].pool,
                                                storage=jnp.asarray(sto))
    tm.regions["db"].pool = dataclasses.replace(
        tm.regions["db"].pool, storage=common.to_words(sto))
    want = jm.scrub_all(use_kernel=False)["db"]
    got = tm.scrub_all(use_kernel=use_kernel)["db"]
    assert vars(got) == vars(want)
    np.testing.assert_array_equal(_u32(tm.regions["db"].pool.storage),
                                  np.asarray(jm.regions["db"].pool.storage))
