"""CREAM-Shard's banks and the training host mesh across ranks, on the CPU.

Rank programs (``tests/torch_mesh_ranks.py``, no JAX) run in processes
spawned by ``torch.multiprocessing``, one gloo group each over a
``FileStore`` under ``tmp_path``, every collective under a timeout and
every group under a deadline, so a hung rank fails its test. They write
what they saw as ``.npy`` files, and this process holds those against the
reference:

  * the shard-local routed read (the TPU kernel's own form: one bank and
    its ``shard_id``, the other banks' rows zero) against the reference's
    plain version and its Pallas kernel in interpret mode, for every bank
    of S = 2 and 4 on INTERWRAP, PARITY and a DAEC-tier pool, bit-exact;
  * a mesh pool of 1, 2 and 4 ranks through write -> reads -> planted
    flips -> ``read_writeback`` -> migration across banks -> repartition
    down and up -> streams -> ``set_daec_rows`` -> scrub: every rank's
    reads, bank for bank its storage, the evicted ids and the census equal
    S reference ``PoolState`` banks driven through ``router.route_np`` and
    the port's one-card pool, bit for bit; at S = 1 also the reference
    ``ShardedPool`` itself;
  * the serve-test engine on a 2-rank mesh pool with a migration across
    banks: both ranks' tokens equal the reference engine's on a local pool
    of the same global geometry;
  * the smoke qwen3 trained data-parallel on 2 ranks (3 steps, remat none,
    microbatch 2): losses and gradient norms within 1e-5 relative of the
    reference trainer in one process on the same global batches, the
    parameters within 1e-4 relative of each leaf's scale and bit-identical
    across the ranks. (AdamW's ``m / (sqrt(v) + 1e-8)`` turns the float32
    rounding of gradients near 1e-8 into a share of a whole step: on this
    config the port's one-process trainer sits 5.3e-5 from the reference
    after 3 steps, and any other order of the same sums moves it as far.)
  * the launcher under ``torch.distributed.run`` on 2 ranks, twice on one
    checkpoint directory: each line printed once, the second run resumed.
"""
import dataclasses
import json
import os
import subprocess
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
from repro.configs.base import ModelConfig as JConfig
from repro.configs.base import TrainConfig as JTrain
from repro.configs.registry import get_config as jget_config
from repro.core import pool as jpool
from repro.core import scrubber as jscrub
from repro.core.layouts import Layout as JLayout
from repro.distributed.sharding import tree_paths as jtree_paths
from repro.kernels.mixed import kernel as jmixed
from repro.kernels.mixed import ref as jmixed_ref
from repro.serve import Engine as JEngine
from repro.serve import ServeRequest as JRequest
from repro.train.trainer import make_trainer as jmake_trainer
from repro_torch.core import pool as tpool
from repro_torch.core.layouts import Layout
from repro_torch.kernels import common
from repro_torch.kernels.mixed import ops as mixed_ops
from repro_torch.shard import ShardedPool, make_sharded_pool, router

ROOT = Path(__file__).resolve().parent.parent


def _u32(t) -> np.ndarray:
    return common.to_u32(t) if isinstance(t, torch.Tensor) else np.asarray(t)


def _no_jax_in_ranks(out: Path, world: int) -> None:
    for r in range(world):
        assert json.loads((out / f"modules_r{r}.json").read_text()) == []


# ---------------------------------------------------------------------------
# The shard-local routed read
# ---------------------------------------------------------------------------

ROWS, W = 64, 16


def _bank_words(case: str, S: int) -> tuple[np.ndarray, int, Layout]:
    """(S, R_local, 9, W) banks written by reference pools (valid codes,
    a SEC-DAEC tier for "daec"), then single data-bit, single code-bit and
    same-beat double flips in every bank's protected rows."""
    layout = Layout.PARITY if case == "parity" else Layout.INTERWRAP
    r_local, b_local = ROWS // S, ROWS // (2 * S)
    rng = np.random.default_rng(S + 3 * len(case))
    banks = []
    for _ in range(S):
        b = jpool.make_pool(r_local, JLayout(layout.value),
                            boundary=b_local, row_words=W,
                            daec_rows=4 if case == "daec" else 0)
        data = rng.integers(0, 2**32, (b.num_pages, 8 * W), dtype=np.uint32)
        b = b.write(np.arange(b.num_pages), jnp.asarray(data))
        sto = np.array(b.storage)
        sto[b_local, 2, 3] ^= np.uint32(1 << 5)
        sto[b_local + 1, 8, 1] ^= np.uint32(1 << 9)
        sto[b_local + 2, 6, 0] ^= np.uint32((1 << 2) | (1 << 9))
        banks.append(sto)
    return np.stack(banks), S * b_local, layout


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("case", ["interwrap", "parity", "daec"])
def test_shard_local_read_equals_the_reference(case, S):
    sto, boundary, layout = _bank_words(case, S)
    b_local = boundary // S
    n_pages = ROWS + S * jpool.make_pool(
        ROWS // S, JLayout(layout.value), boundary=b_local,
        row_words=W).num_extra_pages
    rng = np.random.default_rng(S)
    flipped = [(b_local + i) * S + s for i in range(3) for s in range(S)]
    ids = np.unique(np.concatenate([flipped, [n_pages - 1, 0],
                                    rng.permutation(n_pages)[:10]]))
    ids = rng.permutation(ids).astype(np.int32)
    shard, local = router.route_np(ids, ROWS, S)
    words = common.to_words(sto)
    full, full_st = mixed_ops.read_correct_routed(
        words, torch.as_tensor(ids), layout, ROWS, boundary, S, status=True)
    acc = np.zeros((ids.size, 8 * W), np.uint32)
    for s in range(S):
        bank = words[s].contiguous()
        got = _u32(mixed_ops.read_correct_routed_local(
            bank, torch.as_tensor(ids), layout, ROWS, boundary, S, s))
        args = (jnp.asarray(sto[s]), jnp.asarray(ids), JLayout(layout.value),
                ROWS, boundary, S, jnp.int32(s))
        want = np.asarray(jmixed_ref.read_correct_routed(*args))
        np.testing.assert_array_equal(np.asarray(jmixed.read_correct_routed(
            *args)), want)
        np.testing.assert_array_equal(got, want, err_msg=f"bank {s}")
        assert not got[shard != s].any()
        # the status output: the owned pages' statuses, 0 for the others
        buf = torch.full((ids.size * (8 * W + 1),), 7, dtype=torch.int32)
        data, st = mixed_ops.read_correct_routed_local(
            bank, torch.as_tensor(ids), layout, ROWS, boundary, S, s,
            status=True, out=buf)
        assert data.data_ptr() == buf.data_ptr()
        np.testing.assert_array_equal(_u32(data), want)
        np.testing.assert_array_equal(
            st.numpy(), np.where(shard == s, full_st.numpy(), 0))
        acc += want
    # the int32 sum of the banks' shares is the all-banks read
    np.testing.assert_array_equal(acc, _u32(full))
    assert set(full_st.tolist()) == {0, 1, 2, 3}


def test_shard_local_read_refuses_what_it_does_not_take():
    sto = torch.zeros((4, 8, 9, 16), dtype=torch.int32)
    ids = torch.arange(4)
    read = mixed_ops.read_correct_routed_local
    with pytest.raises(ValueError, match="bank"):
        read(sto, ids, Layout.INTERWRAP, 32, 32, 4, 0)
    with pytest.raises(ValueError, match="banks"):
        read(sto[0], ids, Layout.INTERWRAP, 32, 30, 4, 0)
    with pytest.raises(ValueError, match="shard_id"):
        read(sto[0], ids, Layout.INTERWRAP, 32, 32, 4, 4)
    with pytest.raises(ValueError, match="out"):
        read(sto[0], ids, Layout.INTERWRAP, 32, 32, 4, 1,
             out=torch.empty(7, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        read(sto[0], torch.arange(8)[::2], Layout.INTERWRAP, 32, 32, 4, 1)


# ---------------------------------------------------------------------------
# The pool's verbs on a banks mesh
# ---------------------------------------------------------------------------

VERB_ROWS, VERB_BOUNDARY, VERB_W = 64, 32, 32
BANK_RECORDS = ("write", "after_writeback", "migrate", "down", "up", "daec",
                "scrub")


def _pool_spec(layout: Layout, S: int) -> dict:
    rows, boundary = VERB_ROWS, VERB_BOUNDARY
    one = make_sharded_pool(rows, layout, boundary, num_shards=S,
                            row_words=VERB_W, device="cpu")
    n = one.num_pages
    rng = np.random.default_rng(10 + S)
    ids = np.concatenate([rng.permutation(n), rng.integers(0, n, 9)])
    sec = boundary // S
    src = np.asarray([3, 5, n - 1, sec * S, 0], np.int64)
    bank = router.route_np(np.arange(n), rows, S)[0]
    dst = []
    for i, p in enumerate(src):         # four across banks, the last within
        dst.append(next(q for q in rng.permutation(n)
                        if q not in src and q not in dst
                        and (S == 1 or (bank[q] != bank[p]) == (i < 4))))
    streams = np.stack([rng.choice(np.arange(s, rows, S), 3, replace=False)
                        for s in range(S)])
    return dict(
        layout=layout.value, rows=rows, boundary=boundary, W=VERB_W,
        ids=ids, data=rng.integers(0, 2**32, (ids.size, 8 * VERB_W),
                                   dtype=np.uint32),
        valid=rng.random(ids.size) < 0.9, all_ids=rng.permutation(n),
        flips=np.asarray([(0, sec, 2, 5, 7), (S - 1, sec + 1, 8, 3, 1),
                          (1 % S, sec + 2, 4, 0, 3),
                          (1 % S, sec + 2, 4, 0, 4)]),
        src=src, dst=np.asarray(dst, np.int64), streams=streams,
        stream_data=rng.integers(0, 2**32, (S, 3, 8 * VERB_W),
                                 dtype=np.uint32),
        daec=2 * S)


class RefBanks:
    """S reference ``PoolState`` banks driven through ``router.route_np``:
    the records :func:`torch_mesh_ranks.pool_sequence` makes."""

    def __init__(self, spec: dict, S: int):
        self.S, self.rows, self.spec = S, int(spec["rows"]), spec
        self.j = [jpool.make_pool(self.rows // S,
                                  JLayout(str(spec["layout"])),
                                  boundary=int(spec["boundary"]) // S,
                                  row_words=int(spec["W"]))
                  for _ in range(S)]

    def route(self, ids):
        return router.route_np(ids, self.rows, self.S)

    def banks(self) -> list:
        return [np.asarray(b.storage) for b in self.j]

    def write(self, ids, data, valid=None):
        land = tpool._landing_rows(np.asarray(ids, np.int64), valid)
        shard, local = self.route(ids)
        for s in range(self.S):
            own = land & (shard == s)
            if own.any():
                self.j[s] = self.j[s].write(local[own],
                                            jnp.asarray(data[own]))

    def read(self, ids, verb="read"):
        shard, local = self.route(ids)
        data = np.zeros((len(ids), self.j[0].page_words), np.uint32)
        status = np.zeros(len(ids), np.int32)
        for s in range(self.S):
            own = shard == s
            if own.any():
                if verb == "read":
                    d, st = self.j[s].read(local[own], status=True)
                else:
                    d, st, self.j[s] = self.j[s].read_writeback(local[own])
                data[own], status[own] = np.asarray(d), np.asarray(st)
        return data, status

    def flip(self, cells):
        sto = [b.copy() for b in self.banks()]
        for s, r, ln, w, b in cells:
            sto[s][r, ln, w] ^= np.uint32(1 << int(b))
        self.j = [dataclasses.replace(b, storage=jnp.asarray(x))
                  for b, x in zip(self.j, sto)]

    def records(self) -> dict:
        spec, S, out = self.spec, self.S, {}
        self.write(spec["ids"], spec["data"], spec["valid"])
        out["write"] = self.banks()
        d, st = self.read(spec["all_ids"])
        out["read"], out["read_status"] = (d,), (d, st)
        self.flip(spec["flips"])
        out["flipped_status"] = self.read(spec["all_ids"])
        out["writeback"] = self.read(spec["all_ids"], verb="writeback")
        out["after_writeback"] = self.banks()
        data = self.read(spec["src"])[0]
        land = tpool._landing_rows(spec["dst"], None)
        self.write(spec["dst"][land], data[land])
        out["migrate"] = self.banks()
        out["migrate_read"] = self.read(spec["all_ids"])
        evicted = []
        for s in range(S):
            loc = jpool.evicted_extra_pages(self.j[s], 0)
            evicted += router.unroute(np.full(len(loc), s), np.asarray(
                loc, np.int64), self.rows, S).tolist()
        out["down_evicted"] = (np.asarray(sorted(evicted)),)
        self.j = [jpool.repartition(b, 0)[0] for b in self.j]
        out["down"] = self.banks()
        nb = int(spec["boundary"]) // S
        self.j = [jpool.repartition(b, nb)[0] for b in self.j]
        out["up"] = self.banks()
        n_pages = self.rows + S * self.j[0].num_extra_pages
        out["up_read"] = self.read(np.arange(n_pages))
        streams = spec["streams"]
        _, local = self.route(streams.reshape(-1))
        local = local.reshape(streams.shape)
        for s in range(S):
            self.j[s] = self.j[s].write(local[s],
                                        jnp.asarray(spec["stream_data"][s]))
        out["streams"] = [np.asarray(self.j[s].read(local[s]))[None]
                          for s in range(S)]
        self.j = [jpool.set_daec_rows(b, int(spec["daec"]) // S)
                  for b in self.j]
        out["daec"] = self.banks()
        out["daec_read"] = self.read(np.arange(n_pages))
        merged, corrupt = {}, []
        for s in range(S):
            self.j[s], st = jscrub.scrub(self.j[s])
            for k, v in vars(st).items():
                if k != "corrupt_rows":
                    merged[k] = merged.get(k, 0) + v
            corrupt.extend(r * S + s for r in st.corrupt_rows)
        out["scrub"] = self.banks()
        out["census"] = dict(merged, corrupt_rows=sorted(corrupt))
        return out


def _one_card_records(spec: dict, S: int) -> dict:
    """The port's one-card pool through the same sequence (and its
    CREAM-Lens records under ``"lens"``)."""
    pool = make_sharded_pool(int(spec["rows"]), Layout(str(spec["layout"])),
                             int(spec["boundary"]), num_shards=S,
                             row_words=int(spec["W"]), device="cpu")
    out = {}

    def record(name, value):
        if isinstance(value, ShardedPool):
            out[name] = [_u32(value.storage[s]) for s in range(S)]
        else:
            vals = value if isinstance(value, tuple) else (value,)
            out[name] = tuple(_u32(v) for v in vals)

    with ranks.lens_on():
        ranks.pool_sequence(pool, spec, record)
        out["lens"] = ranks.lens_records()
    out["census"] = json.loads(out["census"][0].tobytes())
    return out


def _reference_sharded_pool_banks(spec: dict) -> dict:
    """The reference ``ShardedPool`` (one bank: the only size its mesh
    runs under the installed JAX) through the sequence's pool steps."""
    p = jshard.make_sharded_pool(int(spec["rows"]),
                                 JLayout(str(spec["layout"])),
                                 int(spec["boundary"]), num_shards=1,
                                 row_words=int(spec["W"]))
    out = {}
    p = p.write(spec["ids"], jnp.asarray(spec["data"]), valid=spec["valid"])
    out["write"] = np.asarray(p.storage[0])
    sto = np.array(p.storage)
    for _, r, ln, w, b in spec["flips"]:
        sto[0, r, ln, w] ^= np.uint32(1 << int(b))
    p = dataclasses.replace(p, storage=jax.device_put(
        jnp.asarray(sto), p.storage.sharding))
    out["flipped_status"] = tuple(np.asarray(x) for x in p.read(
        spec["all_ids"], status=True))
    _, _, p = p.read_writeback(spec["all_ids"])
    out["after_writeback"] = np.asarray(p.storage[0])
    p = p.migrate(spec["src"], spec["dst"])
    out["migrate"] = np.asarray(p.storage[0])
    p, _ = p.move_boundary(0)
    out["down"] = np.asarray(p.storage[0])
    p, _ = p.move_boundary(int(spec["boundary"]))
    out["up"] = np.asarray(p.storage[0])
    p = p.streams(spec["streams"], jnp.asarray(spec["stream_data"]))
    p = p.set_daec_rows(int(spec["daec"]))
    out["daec"] = np.asarray(p.storage[0])
    p, _ = p.scrub()
    out["scrub"] = np.asarray(p.storage[0])
    return out


def _rank_record(out: Path, r: int, name: str, arity: int) -> tuple:
    return tuple(np.load(out / f"r{r}_{name}_{i}.npy") for i in range(arity))


@pytest.mark.parametrize("S", [1, 2, 4])
def test_mesh_pool_equals_the_reference_banks_and_the_one_card_pool(
        S, tmp_path):
    layout = Layout.INTERWRAP if S != 2 else Layout.PARITY
    spec = _pool_spec(layout, S)
    np.savez(tmp_path / "spec.npz", **spec)
    out = tmp_path / "out"
    out.mkdir()
    ranks.run_ranks(ranks.mesh_pool_rank, S, tmp_path,
                    str(tmp_path / "spec.npz"), str(out))
    _no_jax_in_ranks(out, S)
    ref = RefBanks(spec, S).records()
    one = _one_card_records(spec, S)
    assert sorted(set(ref["flipped_status"][1].tolist())) == [0, 1, 2, 3]
    assert one["census"] == ref["census"]
    for r in range(S):
        assert json.loads((out / f"r{r}_refused.json").read_text()) == [
            "make_sharded_pool", "make_banks_mesh"]
        for name in BANK_RECORDS:
            (got,) = _rank_record(out, r, name, 1)
            np.testing.assert_array_equal(got, ref[name][r],
                                          err_msg=f"{name}, bank {r}")
            np.testing.assert_array_equal(got, one[name][r])
        for name, want in ref.items():
            if name in BANK_RECORDS or name in ("census", "lens"):
                continue
            if name == "streams":
                want = (want[r],)
            got = _rank_record(out, r, name, len(want))
            for i, (g, w) in enumerate(zip(got, want)):
                np.testing.assert_array_equal(g, w, err_msg=f"{name} {r}")
                np.testing.assert_array_equal(
                    g, one[name][i][r:r + 1] if name == "streams"
                    else one[name][i])
        census = json.loads(_rank_record(out, r, "census", 1)[0].tobytes())
        assert census == ref["census"]
    # CREAM-Lens: each rank records its own bank; the ranks' records
    # together are the one-card pool's
    lens = [rec for r in range(S) for rec in json.loads(
        (out / f"r{r}_memprof.json").read_text())]
    assert lens and all(rec[1].endswith(f"bank{r}") for r in range(S)
                        for rec in json.loads(
                            (out / f"r{r}_memprof.json").read_text()))
    assert sorted(map(json.dumps, lens)) == sorted(map(json.dumps,
                                                       one["lens"]))
    if S == 1:
        jp = _reference_sharded_pool_banks(spec)
        for name, want in jp.items():
            got = np.load(out / f"r0_{name}_0.npy")
            if name == "flipped_status":
                np.testing.assert_array_equal(got, want[0])
                np.testing.assert_array_equal(
                    np.load(out / "r0_flipped_status_1.npy"), want[1])
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)


# ---------------------------------------------------------------------------
# CREAM-Serve on a mesh pool
# ---------------------------------------------------------------------------


def test_engine_on_a_two_rank_mesh_pool_decodes_the_reference_tokens(
        tmp_path):
    S, secded_rows = 2, 16
    jeng = JEngine(JConfig(**ranks.SERVE_TEST), max_batch=4, max_len=32,
                   seed=0, mode="cream", num_rows=ranks.SERVE_ROWS,
                   row_words=ranks.ROW_WORDS, secded_rows=secded_rows)
    jeng.vm.create_tenant("mig")
    jeng.vm.alloc("mig", ranks.MIG_FRAMES, allow_host=False)
    phys = np.asarray([e.phys for _, e in sorted(
        jeng.vm.tenants["mig"].entries.items())])
    bank = router.route_np(phys, ranks.SERVE_ROWS, S)[0]
    src = phys[bank == 0][:3]
    dst = phys[bank == 1][:3]
    assert src.size == dst.size == 3
    rng = np.random.default_rng(6)
    payload = rng.integers(0, 2**32, (3, jeng.pool.page_words),
                           dtype=np.uint32)
    jeng.vm.pools["kv"] = jeng.pool.write(src, jnp.asarray(payload))
    prompts = np.stack([rng.integers(0, 256, size=12).astype(np.int32)
                        for _ in range(8)])
    jreqs = [JRequest(f"s{i}", p, 10) for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    k = 0
    while jeng.sched.has_work():
        jeng.poll()
        k += 1
        if k == 3:
            jeng.schedule_migration(src, dst)
    want = [r.generated for r in jreqs]
    spec = dict(secded_rows=secded_rows, src=src, dst=dst, payload=payload,
                prompts=prompts, mig_phys=phys,
                **{f"w:{p}": np.asarray(v)
                   for p, v in jtree_paths(jeng.params).items()})
    np.savez(tmp_path / "spec.npz", **spec)
    out = tmp_path / "out"
    out.mkdir()
    ranks.run_ranks(ranks.serve_rank, S, tmp_path, str(tmp_path / "spec.npz"),
                    str(out))
    _no_jax_in_ranks(out, S)
    for r in range(S):
        assert np.load(out / f"r{r}_tokens.npy").tolist() == want
        np.testing.assert_array_equal(np.load(out / f"r{r}_moved.npy"),
                                      payload)
        assert int(np.load(out / f"r{r}_steps.npy")[0]) == jeng.steps
    np.testing.assert_array_equal(np.asarray(jeng.pool.read(dst)), payload)


# ---------------------------------------------------------------------------
# Data-parallel training
# ---------------------------------------------------------------------------

SEQ, BATCH, STEPS = 32, 4, 3


def _close(got, want, rel: float, what: str) -> None:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, (
        what, np.abs(got - want).max(), scale)


def test_two_rank_training_equals_the_reference_trainer(tmp_path):
    S, micro = 2, 2
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=40,
              scrub_every=0, checkpoint_every=0, remat="none",
              microbatch=micro)
    ref = jmake_trainer(jget_config("qwen3-0.6b").smoke(), JTrain(**kw),
                        seq_len=SEQ, global_batch=BATCH)
    spec = dict(seq=SEQ, batch=BATCH,
                **{f"p:{p}": np.asarray(v)
                   for p, v in jtree_paths(ref.params).items()})
    for step in range(STEPS):
        b = ref.data.batch(step)
        spec[f"tokens{step}"] = np.asarray(b["tokens"])
        spec[f"labels{step}"] = np.asarray(b["labels"])
    np.savez(tmp_path / "spec.npz", **spec)
    out = tmp_path / "out"
    out.mkdir()
    ranks.run_ranks(ranks.train_rank, S, tmp_path, str(tmp_path / "spec.npz"),
                    str(out), STEPS, micro)
    _no_jax_in_ranks(out, S)
    log = ref.run(STEPS)
    want_params = jtree_paths(ref.params)
    got = [dict(np.load(out / f"r{r}_params.npz")) for r in range(S)]
    for r in range(S):
        _close(np.load(out / f"r{r}_loss.npy"), [e["loss"] for e in log],
               1e-5, "loss")
        _close(np.load(out / f"r{r}_gnorm.npy"),
               [e["grad_norm"] for e in log], 1e-5, "grad_norm")
        assert list(got[r]) == list(want_params)
        for path, want in want_params.items():
            _close(got[r][path], want, 1e-4, path)
            # every replica applied the same update to the same bits
            np.testing.assert_array_equal(got[r][path], got[0][path])


def test_train_launcher_on_two_ranks_resumes_and_prints_once(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    args = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
            "--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--steps",
            "4", "--ckpt-dir", str(tmp_path / "ckpt")]
    first = subprocess.run(args, capture_output=True, text=True, env=env,
                           cwd=ROOT, timeout=150)
    assert first.returncode == 0, first.stderr[-3000:]
    lines = first.stdout.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("qwen3-0.6b-smoke: loss ")
    assert lines[0].endswith("over 4 steps")
    second = subprocess.run(args, capture_output=True, text=True, env=env,
                            cwd=ROOT, timeout=150)
    assert second.returncode == 0, second.stderr[-3000:]
    lines = second.stdout.strip().splitlines()
    assert lines[0] == "resumed at step 4" and len(lines) == 2
    assert lines[1].startswith("qwen3-0.6b-smoke: loss ")
