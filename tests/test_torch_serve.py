"""CREAM-Serve on the port equals the reference engine.

Both packages get one set of weights (the reference's ``init_params``,
converted through numpy by ``load_jax_params``) and the same numpy
prompts, for the ``serve-test`` config of ``tests/test_serve_paged.py`` and
for ``qwen3-0.6b``'s smoke reduction (which keeps qk-norm and tied
embeddings). The port runs on the CPU with its plain kernel versions.

  * Model: prefill and ``decode_step_paged`` logits and KV agree within
    ``atol = rtol = 1e-4`` in float32 — torch and XLA reduce in different
    orders, so the last bits differ.
  * Engine: the two engines, driven in lockstep, hold identical block
    tables and gather identical page ids at every poll, finish with
    identical statistics and greedy tokens, in ``cream`` and ``secded``
    modes and across a mid-decode protection upgrade; the port's SECDED
    rows all decode clean afterwards.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen3_0_6b as jqwen
from repro.configs.base import ModelConfig as JConfig
from repro.models import transformer as jtf
from repro.serve import Engine as JEngine
from repro.serve import ServeRequest as JRequest
from repro.vm.migration import MigrationEngine as JMigration
from repro_torch.configs import qwen3_0_6b as tqwen
from repro_torch.configs.base import BlockKind, MixerKind
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.core import secded
from repro_torch.models import build_model, load_jax_params
from repro_torch.serve import Engine as TEngine
from repro_torch.serve import ServeRequest as TRequest
from repro_torch.vm.migration import MigrationEngine as TMigration

TOL = dict(atol=1e-4, rtol=1e-4)
SERVE_TEST = dict(name="serve-test", family="dense", num_layers=2,
                  d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                  vocab_size=256, head_dim=16, dtype="float32")


def _configs(name: str) -> tuple[JConfig, TConfig]:
    if name == "serve-test":
        return JConfig(**SERVE_TEST), TConfig(**SERVE_TEST)
    return jqwen.CONFIG.smoke(), tqwen.CONFIG.smoke()


CONFIGS = ["serve-test", "qwen3-0.6b-smoke"]


def _fields(cfg) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = tuple((b.value, m.value) for b, m in v) \
            if f.name == "pattern" else v
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_configs_match_the_reference(name):
    jcfg, tcfg = _configs(name)
    assert _fields(tcfg) == _fields(jcfg)
    assert tcfg.activation_dtype == torch.float32
    assert _fields(tqwen.CONFIG) == _fields(jqwen.CONFIG)
    assert (BlockKind.ATTN, MixerKind.MLP) in tcfg.pattern


def _np_params(jcfg: JConfig, seed: int = 0):
    return jax.tree.map(np.asarray, jtf.init_params(jcfg, jax.random.key(seed)))


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_and_paged_decode_logits_match(name):
    jcfg, tcfg = _configs(name)
    params = _np_params(jcfg)
    model = load_jax_params(build_model(tcfg, device="cpu"), params)
    rng = np.random.default_rng(0)
    B, S, max_len = 2, 12, 16
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)

    want_logits, want_state = jtf.prefill(params, jcfg, jnp.asarray(toks),
                                          max_len)
    got_logits, (k, v) = model.prefill(torch.as_tensor(toks))
    _close(got_logits, want_logits)
    want_k = np.asarray(want_state["pos0"]["k"])[:, :, :S]  # (stages, B, S..)
    _close(k, want_k)
    _close(v, np.asarray(want_state["pos0"]["v"])[:, :, :S])

    # paged decode: KV views with pool garbage (NaN, huge) past cache_len
    L, hkv, hd, s_pad = (jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim,
                         24)
    kv = rng.standard_normal((2, L, B, s_pad, hkv, hd)).astype(np.float32)
    lens = np.asarray([5, 17], np.int32)
    for b, n in enumerate(lens):
        kv[0, :, b, n + 1:] = np.float32(3e38)
        kv[1, :, b, n + 1:] = np.nan
    step_toks = rng.integers(0, jcfg.vocab_size, B).astype(np.int32)
    want = jtf.decode_step_paged(
        params, jcfg, {"cache_len": jnp.asarray(lens)},
        jnp.asarray(step_toks), (jnp.asarray(kv[0]), jnp.asarray(kv[1])))
    got = model.decode_step_paged(
        {"cache_len": torch.as_tensor(lens)}, torch.as_tensor(step_toks),
        (torch.as_tensor(kv[0]), torch.as_tensor(kv[1])))
    assert np.isfinite(got[0].numpy()).all()
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1]["cache_len"].numpy(),
                                  np.asarray(want[1]["cache_len"]))
    _close(got[2][0], want[2][0])
    _close(got[2][1], want[2][1])


# ---------------------------------------------------------------------------
# The engines in lockstep
# ---------------------------------------------------------------------------


def _prompts(n: int, vocab: int):
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, size=12).astype(np.int32)
            for _ in range(n)]


class Twin:
    """A reference engine and a port engine with the same weights."""

    def __init__(self, name: str, mode: str, num_rows: int):
        self.name = name
        jcfg, tcfg = _configs(name)
        # one KV token per row of words: 8 tokens per block for both configs
        row_words = 2 * jcfg.num_kv_heads * jcfg.head_dim
        kw = dict(max_batch=4, max_len=32, mode=mode, num_rows=num_rows,
                  row_words=row_words, seed=0)
        self.j = JEngine(jcfg, **kw)
        self.t = TEngine(tcfg, device="cpu", **kw)
        load_jax_params(self.t.model, jax.tree.map(np.asarray, self.j.params))
        prompts = _prompts(8, jcfg.vocab_size)
        self.jreqs = [JRequest(f"s{i}", p, 10) for i, p in enumerate(prompts)]
        self.treqs = [TRequest(f"s{i}", p, 10) for i, p in enumerate(prompts)]
        for a, b in zip(self.jreqs, self.treqs):
            self.j.submit(a)
            self.t.submit(b)
        self.jmig, self.tmig = JMigration(self.j.vm), TMigration(self.t.vm)

    def check_tables(self) -> None:
        jkv, tkv = self.j.kv, self.t.kv
        np.testing.assert_array_equal(tkv._table, jkv._table)
        n = min(len(tkv._phys), len(jkv._phys))
        np.testing.assert_array_equal(tkv._phys[:n], jkv._phys[:n])
        rows = np.asarray([s.row if s is not None else -1
                           for s in self.j.sched.slots])
        assert rows.tolist() == [s.row if s is not None else -1
                                 for s in self.t.sched.slots]
        if (rows >= 0).any():
            np.testing.assert_array_equal(tkv.gather_phys(rows),
                                          jkv.gather_phys(rows))
        assert self.t.vm.allocators["kv"].owner == \
            self.j.vm.allocators["kv"].owner

    def run(self, repartition_at: int | None = None) -> dict | None:
        info, k = None, 0
        while self.j.sched.has_work():
            assert self.t.sched.has_work()
            self.j.poll()
            self.t.poll()
            k += 1
            self.check_tables()
            if k == repartition_at:
                jinfo = self.jmig.repartition_with_migration("kv", 0)
                info = self.tmig.repartition_with_migration("kv", 0)
                assert info == jinfo
                self.j.refresh_translation()
                self.t.refresh_translation()
                self.check_tables()
        assert not self.t.sched.has_work()
        assert self.j.steps == self.t.steps
        assert self.j.sched.stats == self.t.sched.stats
        assert vars(self.j.vm.stats) == vars(self.t.vm.stats)
        return info

    def tokens(self) -> list[list[int]]:
        want = [r.generated for r in self.jreqs]
        assert [r.generated for r in self.treqs] == want
        return want

    def assert_secded_rows_clean(self) -> None:
        pool = self.t.pool
        assert pool.boundary < pool.num_rows
        rows = torch.arange(pool.boundary, pool.num_rows)
        _, _, status = secded.decode_block(
            pool.storage[rows, :8].reshape(len(rows), -1),
            pool.storage[rows, 8])
        assert int(status.max()) == 0


@pytest.fixture(scope="module", params=CONFIGS)
def cream(request) -> Twin:
    """The plain CREAM-mode run both engine tests compare with."""
    twin = Twin(request.param, "cream", num_rows=32)
    twin.run()
    return twin


def test_cream_and_secded_modes_match_the_reference(cream):
    sec = Twin(cream.name, "secded", num_rows=24)
    sec.run()
    assert sec.t.sched.stats["preemptions"] > 0
    assert sec.tokens() == cream.tokens()
    assert cream.t.vm.device_capacity_pages("kv") > \
        sec.t.vm.device_capacity_pages("kv")
    sec.assert_secded_rows_clean()


def test_mid_decode_repartition_matches_the_reference(cream):
    moved = Twin(cream.name, "cream", num_rows=32)
    info = moved.run(repartition_at=12)
    assert info is not None and info["migrated"] > 0 and info["to_host"] > 0
    assert moved.t.sched.restores > 0
    assert moved.tokens() == cream.tokens()
    assert moved.t.pool.boundary == 0
    moved.assert_secded_rows_clean()
