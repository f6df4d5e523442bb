"""The port's SequenceCache tier and dense decode path equal the reference.

  * ``SequenceCache``: the three acceptance tests of ``tests/test_vm.py``
    (allocation through the VM, survival across a protection upgrade,
    batched resumes spanning both tiers), each run on a ``repro`` cache and
    a ``repro_torch`` cache (on the CPU) with the same blobs in the same
    order: identical bytes back, identical stats and residency after every
    step, and identical pool storage in ``cream`` and ``secded`` modes;
  * ``pack_tree`` / ``unpack_tree``: the reference's bytes for the same
    tree, and a lossless round trip;
  * ``VirtualMemory.residency`` / ``swap_in`` against the reference's;
  * the dense decode path (``prefill_state``, ``decode_step``): logits
    within 1e-4 (float32, other reduction orders) and equal greedy tokens
    against the reference's ``decode_step``, and the same tokens as the
    port's paged ``Engine.serve`` on ``serve-test``, as
    ``tests/test_serve_paged.py`` holds the reference's engine to its dense
    path;
  * the slice end to end: a flash prefill parked and resumed through a
    ``cream`` cache decodes the tokens of an uninterrupted decode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen3_0_6b as jqwen
from repro.configs.base import ModelConfig as JConfig
from repro.core.layouts import Layout as JLayout
from repro.core.protection import Protection as JProtection
from repro.models import transformer as jtf
from repro.serve import kv_cache as jkv
from repro.vm.address_space import VirtualMemory as JVM
from repro.vm.migration import MigrationEngine as JMigration
from repro_torch.configs import qwen3_0_6b as tqwen
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.core.layouts import Layout as TLayout
from repro_torch.core.protection import Protection as TProtection
from repro_torch.kernels import common
from repro_torch.models import build_model, load_jax_params
from repro_torch.serve import (Engine, SequenceCache, ServeRequest,
                               pack_tree, unpack_tree)
from repro_torch.vm.address_space import VirtualMemory as TVM
from repro_torch.vm.migration import MigrationEngine as TMigration

ROW_WORDS = 64


class _Pair:
    """A reference cache and a port cache driven with the same calls."""

    def __init__(self, mode: str = "cream", num_rows: int = 16):
        self.j = jkv.SequenceCache(num_rows=num_rows, mode=mode,
                                   row_words=ROW_WORDS)
        self.t = SequenceCache(num_rows=num_rows, mode=mode,
                               row_words=ROW_WORDS, device="cpu")
        self.blobs: dict[str, np.ndarray] = {}

    def park(self, sid: str, blob: np.ndarray) -> None:
        self.blobs[sid] = blob
        self.j.park(sid, blob)
        self.t.park(sid, torch.from_numpy(blob.copy()))
        self.check()

    def resume(self, sid: str):
        want, got = self.j.resume(sid), self.t.resume(sid)
        self._same_blob(want, got)
        self.check()
        return got

    def resume_many(self, sids):
        want, got = self.j.resume_many(sids), self.t.resume_many(sids)
        assert list(got) == list(want)
        for sid in want:
            self._same_blob(want[sid], got[sid])
        self.check()
        return got

    @staticmethod
    def _same_blob(want, got) -> None:
        if want is None:
            assert got is None
            return
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)

    def check(self) -> None:
        js, ts = self.j.stats, self.t.stats
        for f in ("device_hits", "host_hits", "misses", "evictions"):
            assert getattr(ts, f) == getattr(js, f), f
        assert ts.fault_rate == js.fault_rate
        assert list(self.t.lru) == list(self.j.lru)
        for sid, e in self.j.lru.items():
            te = self.t.lru[sid]
            assert (te.vpns, te.nbytes) == (e.vpns, e.nbytes)
            assert self.t.vm.residency(self.t.tenant, te.vpns) \
                == self.j.vm.residency(self.j.tenant, e.vpns)
        assert self.t.vm.used_device_pages() == self.j.vm.used_device_pages()
        assert self.t.device_capacity_pages == self.j.device_capacity_pages
        assert self.t.device_utilisation == self.j.device_utilisation
        np.testing.assert_array_equal(common.to_u32(self.t.pool.storage),
                                      np.asarray(self.j.pool.storage))


@pytest.mark.parametrize("mode", ["cream", "secded"])
def test_sequence_cache_allocates_through_vm(mode):
    rng = np.random.default_rng(7)
    c = _Pair(mode)
    for i in range(10):
        c.park(f"s{i}", rng.integers(0, 256, size=2500, dtype=np.uint8))
    for sid, b in c.blobs.items():
        assert (c.resume(sid).numpy() == b).all()
    assert c.t.vm.used_device_pages() > 0
    assert c.t.device_capacity_pages == (18 if mode == "cream" else 16)


@pytest.mark.parametrize("n_seqs", [9, 17], ids=["test_vm", "extras-used"])
def test_sequence_cache_survives_pool_upgrade(n_seqs):
    """``test_vm``'s 9 one-page blobs, and 17, which reach the extra pages
    that the upgrade to all-SECDED must migrate."""
    rng = np.random.default_rng(8)
    c = _Pair("cream")
    for i in range(n_seqs):
        c.park(f"s{i}", rng.integers(0, 256, size=2000, dtype=np.uint8))
    jinfo = JMigration(c.j.vm).repartition_with_migration(
        jkv.SequenceCache.POOL, 0)
    tinfo = TMigration(c.t.vm).repartition_with_migration(
        SequenceCache.POOL, 0)
    assert tinfo["migrated"] == jinfo["migrated"]
    assert (tinfo["migrated"] > 0) == (n_seqs > 16)
    assert c.t.pool.boundary == c.j.pool.boundary == 0
    c.check()
    for sid, b in c.blobs.items():
        assert (c.resume(sid).numpy() == b).all()      # nothing lost


def test_sequence_cache_resume_many_batches_tiers():
    rng = np.random.default_rng(9)
    c = _Pair("cream")
    for i in range(6):
        c.park(f"s{i}", rng.integers(0, 256, size=2500, dtype=np.uint8))
    for i in range(14):                     # overflow -> LRU demotions
        c.park(f"x{i}", rng.integers(0, 256, size=2500, dtype=np.uint8))
    got = c.resume_many(list(c.blobs) + ["unknown"])
    assert got["unknown"] is None and c.t.stats.misses == 1
    for sid, b in c.blobs.items():
        assert (got[sid].numpy() == b).all()
    assert c.t.stats.host_hits > 0
    assert (c.resume("s0").numpy() == c.blobs["s0"]).all()
    c.park("s0", rng.integers(0, 256, size=900, dtype=np.uint8))  # re-park


def test_cream_holds_more_sequences_than_secded_on_the_same_rows():
    """The slice's capacity claim at CPU size: 9 equal blobs on 8 x their
    pages of rows, parked and resumed in turns; ``cream`` keeps every one
    on the device, ``secded`` thrashes one through the host each turn."""
    rng = np.random.default_rng(10)
    blobs = {f"s{i}": rng.integers(0, 256, size=5000, dtype=np.uint8)
             for i in range(9)}
    pairs = {m: _Pair(m, num_rows=8 * 3) for m in ("cream", "secded")}
    for c in pairs.values():
        for sid, b in blobs.items():
            c.park(sid, b)
        for _ in range(2):
            got = c.resume_many(list(blobs))
            for sid in blobs:
                c.park(sid, got[sid].numpy())
    assert pairs["cream"].t.stats.host_hits == 0
    assert pairs["secded"].t.stats.host_hits > 0


def test_vm_residency_and_swap_in_equal_the_reference():
    jvm, tvm = JVM(row_words=ROW_WORDS), TVM(row_words=ROW_WORDS,
                                             device="cpu")
    jvm.add_pool("p", 16, JLayout.INTERWRAP, boundary=8)
    tvm.add_pool("p", 16, TLayout.INTERWRAP, boundary=8)
    jvm.create_tenant("t", default_reliability=JProtection.SECDED)
    tvm.create_tenant("t", default_reliability=TProtection.SECDED)
    data = np.random.default_rng(11).integers(
        0, 2**32, size=(12, 8 * ROW_WORDS), dtype=np.uint32)
    jv, tv = jvm.alloc("t", 12), tvm.alloc("t", 12)   # 8 SECDED, 4 host
    assert jv == tv
    jvm.write("t", jv, jnp.asarray(data))
    tvm.write("t", tv, data)
    for vpns in (tv[:8], tv[8:], tv):
        assert tvm.residency("t", vpns) == jvm.residency("t", vpns)
    assert tvm.swap_out("t", tv[:3]) == jvm.swap_out("t", jv[:3]) == 3
    assert tvm.residency("t", tv[:3]) == "host"
    assert tvm.swap_in("t", tv) == jvm.swap_in("t", jv) == 3
    for vpn in tv:
        jp, tp = jvm.translate("t", vpn), tvm.translate("t", vpn)
        assert (tp.pool, tp.phys) == (jp.pool, jp.phys)
    np.testing.assert_array_equal(common.to_u32(tvm.read("t", tv)), data)
    np.testing.assert_array_equal(common.to_u32(tvm.pools["p"].storage),
                                  np.asarray(jvm.pools["p"].storage))


def test_pack_tree_bytes_equal_the_reference_and_round_trip():
    rng = np.random.default_rng(12)
    arrays = {"cache_len": np.asarray([7, 3], np.int32),
              "pos0": {"v": rng.standard_normal((2, 2, 5, 2, 4))
                       .astype(np.float32),
                       "k": rng.standard_normal((2, 2, 5, 2, 4))
                       .astype(np.float32)},
              "extra": {"b": np.arange(3, dtype=np.int16),
                        "a": np.asarray([2.5], np.float32)}}
    jblob, _ = jkv.pack_tree(jax.tree.map(jnp.asarray, arrays))
    tree = jax.tree.map(torch.as_tensor, arrays)
    blob, spec = pack_tree(tree)
    assert blob.dtype == torch.uint8
    np.testing.assert_array_equal(blob.numpy(), jblob)
    back = unpack_tree(blob, spec)
    assert set(back) == set(tree) and set(back["extra"]) == {"a", "b"}
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(tree),
                                 jax.tree.leaves(back), strict=True):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    blob[:] = 0                               # unpacked tensors own their bytes
    assert int(back["cache_len"][0]) == 7


# ---------------------------------------------------------------------------
# The dense decode path
# ---------------------------------------------------------------------------

SERVE_TEST = dict(name="serve-test", family="dense", num_layers=2,
                  d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                  vocab_size=256, head_dim=16, dtype="float32")


def _configs(name: str):
    if name == "serve-test":
        return JConfig(**SERVE_TEST), TConfig(**SERVE_TEST)
    return jqwen.CONFIG.smoke(), tqwen.CONFIG.smoke()


@pytest.mark.parametrize("name", ["serve-test", "qwen3-0.6b-smoke"])
def test_dense_decode_equals_the_reference(name):
    jcfg, tcfg = _configs(name)
    params = jax.tree.map(np.asarray, jtf.init_params(jcfg,
                                                      jax.random.key(2)))
    model = load_jax_params(build_model(tcfg, device="cpu"), params)
    rng = np.random.default_rng(13)
    B, S, max_len, steps = 2, 10, 16, 6      # runs past max_len? no: 16
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jlogits, jstate = jtf.prefill(params, jcfg, jnp.asarray(toks), max_len)
    tlogits, tstate = model.prefill_state(torch.as_tensor(toks), max_len)
    jtok = np.asarray(jnp.argmax(jlogits[:, -1], -1), np.int32)
    ttok = tlogits[:, -1].argmax(-1).to(torch.int32)
    np.testing.assert_array_equal(ttok.numpy(), jtok)
    for _ in range(steps):
        jl, jstate = jtf.decode_step(params, jcfg, jstate, jnp.asarray(jtok))
        tl, tstate = model.decode_step(tstate, ttok)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        jtok = np.asarray(jnp.argmax(jl, -1), np.int32)
        ttok = tl.argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), jtok)
    np.testing.assert_array_equal(tstate["cache_len"].numpy(),
                                  np.asarray(jstate["cache_len"]))
    for kv in ("k", "v"):
        np.testing.assert_allclose(tstate["pos0"][kv].numpy(),
                                   np.asarray(jstate["pos0"][kv]),
                                   rtol=1e-4, atol=1e-4)


def test_decode_past_max_len_writes_nothing_as_the_reference():
    jcfg, tcfg = _configs("serve-test")
    params = jax.tree.map(np.asarray, jtf.init_params(jcfg,
                                                      jax.random.key(4)))
    model = load_jax_params(build_model(tcfg, device="cpu"), params)
    toks = np.arange(8, dtype=np.int32)[None]
    _, jstate = jtf.prefill(params, jcfg, jnp.asarray(toks), 8)
    _, tstate = model.prefill_state(torch.as_tensor(toks), 8)
    before = tstate["pos0"]["k"].clone()
    jl, jstate = jtf.decode_step(params, jcfg, jstate,
                                 jnp.asarray([3], jnp.int32))
    tl, tstate = model.decode_step(tstate, torch.as_tensor([3]))
    assert torch.equal(tstate["pos0"]["k"], before)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


def _dense_greedy(model, prompt: np.ndarray, max_len: int, max_new: int,
                  attn_impl: str = "xla") -> list[int]:
    model.attn_impl = attn_impl
    logits, state = model.prefill_state(torch.as_tensor(prompt[None]),
                                        max_len, logits_mode="last")
    tok = int(logits[0].argmax())
    gen = [tok]
    for _ in range(max_new - 1):
        lg, state = model.decode_step(state, torch.as_tensor([tok]))
        tok = int(lg[0].argmax())
        gen.append(tok)
    return gen


def test_paged_engine_equals_the_dense_path():
    cfg = TConfig(**SERVE_TEST)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, size=12).astype(np.int32)
               for _ in range(6)]
    reqs = [ServeRequest(f"s{i}", p, 8) for i, p in enumerate(prompts)]
    eng = Engine(cfg, max_batch=4, max_len=32, num_rows=64, row_words=64,
                 seed=0, device="cpu")
    eng.serve(reqs)
    want = [_dense_greedy(eng.model, p, eng.max_len, 8) for p in prompts]
    assert [r.generated for r in reqs] == want


def test_flash_prefill_parked_and_resumed_decodes_as_uninterrupted():
    cfg = TConfig(**SERVE_TEST)
    model = build_model(cfg, attn_impl="flash", seed=6, device="cpu")
    rng = np.random.default_rng(14)
    prompts = {f"s{i}": rng.integers(0, 256, size=20).astype(np.int32)
               for i in range(3)}
    max_len, turns, per_turn = 32, 3, 4
    want = {sid: _dense_greedy(model, p, max_len, turns * per_turn + 1,
                               "flash") for sid, p in prompts.items()}
    cache = SequenceCache(num_rows=32, mode="cream", row_words=ROW_WORDS,
                          device="cpu")          # 36 pages: 3 states of 9
    spec, got, last = None, {}, {}
    for sid, p in prompts.items():
        logits, state = model.prefill_state(torch.as_tensor(p[None]),
                                            max_len, logits_mode="last")
        last[sid] = int(logits[0].argmax())
        got[sid] = [last[sid]]
        blob, spec = pack_tree(state)
        cache.park(sid, blob)
    for _ in range(turns):
        blobs = cache.resume_many(list(prompts))
        for sid in prompts:
            state = unpack_tree(blobs[sid], spec)
            for _ in range(per_turn):
                lg, state = model.decode_step(state,
                                              torch.as_tensor([last[sid]]))
                last[sid] = int(lg[0].argmax())
                got[sid].append(last[sid])
            cache.park(sid, pack_tree(state)[0])
    assert got == want
    assert cache.stats.device_hits == turns * len(prompts)
