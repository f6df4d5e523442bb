"""The port's mixture of experts (``repro_torch.models.moe``) against the
reference's ``repro.models.moe`` on the CPU.

The same numpy inputs (seeded) and the reference's weights go through
both. Routing is held exactly: the top-k expert ids equal
``jax.lax.top_k``'s (ties to the lower index first, a forced tie
included), and the queue slots and keep mask equal the reference's
(its sort-based ranking, ``repro/models/moe.py`` lines 69-85, evaluated
with ``jnp`` on the same expert ids), overflow past the capacity included.
The output and the aux loss are within 1e-5 of the reference's (float32;
torch and XLA sum in other orders). A reference and a port ``Engine``
serving olmoe's ``smoke()`` config from the same weights, on a SECDED
pool that preempts and on a CREAM one that does not, decode equal tokens
step for step: the scheduler gives both the same batches, so the MoE's
batch dependence (capacity, queue order, idle slots' token 0) is the
same in both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro.serve import Engine as JEngine
from repro.serve import ServeRequest as JRequest
from repro_torch.configs import get_config
from repro_torch.models import load_jax_params, moe
from repro_torch.serve import Engine as TEngine
from repro_torch.serve import ServeRequest as TRequest

TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(**kw):
    j = dataclasses.replace(jget_config("olmoe-1b-7b").smoke(), **kw)
    t = dataclasses.replace(get_config("olmoe-1b-7b").smoke(), **kw)
    return j, t


def _params(jcfg, seed: int = 0):
    jp = jmoe.init_moe(jax.random.key(seed), jcfg, jnp.float32)
    return jp, {k: torch.as_tensor(np.array(v)) for k, v in jp.items()}


class _NS(dict):
    __getattr__ = dict.__getitem__


def _ref_dispatch(idx: np.ndarray, e: int, c: int):
    """The reference's slot computation (ref moe.py:69-85) on ``idx``."""
    flat_idx = jnp.asarray(idx).reshape(-1)
    order = jnp.argsort(flat_idx, stable=True)
    counts = jnp.bincount(flat_idx, length=e)
    starts = jnp.cumsum(counts) - counts
    pos_sorted = jnp.arange(flat_idx.shape[0]) - starts[flat_idx[order]]
    pos = jnp.zeros_like(flat_idx).at[order].set(
        pos_sorted.astype(flat_idx.dtype))
    keep = pos < c
    return np.asarray(jnp.where(keep, flat_idx * c + pos, e * c)), \
        np.asarray(keep)


def _run_both(jcfg, tcfg, jp, tp, x: np.ndarray):
    jout, jaux = jmoe.apply_moe(jp, jcfg, jnp.asarray(x))
    tout, taux = moe.apply_moe(_NS(tp), tcfg, torch.as_tensor(x))
    return (np.asarray(jout), float(jaux)), (tout.numpy(), float(taux))


@pytest.mark.parametrize("batch,seq,cf", [(2, 8, 1.25), (1, 1, 1.25),
                                          (4, 1, 1.25), (2, 16, 0.5)],
                         ids=["prefill", "one-token", "decode-batch",
                              "tight-capacity"])
def test_apply_moe_equals_the_reference(batch, seq, cf):
    jcfg, tcfg = _cfgs(capacity_factor=cf)
    jp, tp = _params(jcfg)
    x = np.random.default_rng(1).standard_normal(
        (batch, seq, jcfg.d_model)).astype(np.float32)
    (jo, ja), (to, ta) = _run_both(jcfg, tcfg, jp, tp, x)
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_allclose(ta, ja, **TOL)
    assert moe.moe_capacity(tcfg, batch * seq) == \
        jmoe.moe_capacity(jcfg, batch * seq)


def test_routing_slots_and_keep_equal_the_reference_when_capacity_drops():
    """Skewed routing (expert 0's router column raised) overflows expert
    0's queue: the same pairs are dropped, to the pad slot, and the
    output is the reference's."""
    jcfg, tcfg = _cfgs(capacity_factor=1.0)
    jp, tp = _params(jcfg, seed=3)
    jp = dict(jp, router=jp["router"].at[:, 0].add(0.5))
    tp = dict(tp, router=torch.as_tensor(np.array(jp["router"])))
    t = 24
    x = np.random.default_rng(2).standard_normal(
        (1, t, jcfg.d_model)).astype(np.float32)
    xt = torch.as_tensor(x[0])
    probs, idx, gates = moe.route(_NS(tp), tcfg, xt)
    jprobs = jax.nn.softmax(jnp.asarray(x[0]) @ jp["router"], axis=-1)
    jg, jidx = jax.lax.top_k(jprobs, jcfg.experts_per_token)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), **TOL)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(
        gates.numpy(), np.asarray(jg / jg.sum(-1, keepdims=True)), **TOL)

    c = moe.moe_capacity(tcfg, t)
    slot, keep = moe.dispatch(tcfg, idx, c)
    want_slot, want_keep = _ref_dispatch(np.asarray(jidx),
                                         jcfg.num_experts, c)
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert not keep.all()                     # the capacity dropped pairs
    assert (slot[~keep] == tcfg.num_experts * c).all()
    (jo, ja), (to, ta) = _run_both(jcfg, tcfg, jp, tp, x)
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_allclose(ta, ja, **TOL)


def test_a_tie_in_probs_picks_the_lower_expert_first():
    """Experts 1 and 3 get identical router columns, so every token's
    probabilities tie between them: both packages pick expert 1 before
    expert 3, and give the same output."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=5)
    col = jp["router"][:, 1]
    # expert 0 far below the tied pair, expert 2 far above: top-2 = [2, 1]
    router = jp["router"].at[:, 3].set(col).at[:, 0].set(-col) \
        .at[:, 2].set(4 * col)
    jp = dict(jp, router=router)
    tp = dict(tp, router=torch.as_tensor(np.array(router)))
    # x . col > 0 for every token
    x = (np.abs(np.random.default_rng(4).standard_normal(
        (1, 6, jcfg.d_model))) * np.sign(np.asarray(col))).astype(np.float32)
    probs, idx, _ = moe.route(_NS(tp), tcfg, torch.as_tensor(x[0]))
    assert torch.equal(probs[:, 1], probs[:, 3])          # a real tie
    _, jidx = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x[0]) @ router, axis=-1), jcfg.experts_per_token)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert (idx[:, 1] == 1).all() and not (idx == 3).any()
    (jo, ja), (to, ta) = _run_both(jcfg, tcfg, jp, tp, x)
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_allclose(ta, ja, **TOL)


def test_init_moe_has_the_reference_layout():
    cfg = dataclasses.replace(get_config("olmoe-1b-7b").smoke(),
                              dtype="bfloat16")
    jcfg = dataclasses.replace(jget_config("olmoe-1b-7b").smoke(),
                               dtype="bfloat16")
    m = moe.MoE(cfg, torch.Generator().manual_seed(0), torch.bfloat16)
    jp = jmoe.init_moe(jax.random.key(0), jcfg, jnp.bfloat16)
    for name, w in m.named_parameters():
        assert tuple(w.shape) == jp[name].shape, name
        assert str(w.dtype).split(".")[1] == jp[name].dtype.name, name
        # dense_init's scale: std 1/sqrt(fan_in), within 10 %
        fan_in = cfg.moe_d_ff if name == "w_down" else cfg.d_model
        assert abs(float(w.float().std()) * fan_in ** 0.5 - 1) < 0.1, name
    x = torch.randn(2, 4, cfg.d_model).to(torch.bfloat16)
    out, aux = moe.apply_moe(m, cfg, x)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert torch.isfinite(out.float()).all()


@pytest.mark.parametrize("mode,rows", [("secded", 24), ("cream", 48)])
def test_engines_decode_equal_tokens(mode, rows):
    jcfg = jget_config("olmoe-1b-7b").smoke()
    tcfg = get_config("olmoe-1b-7b").smoke()
    kw = dict(max_batch=4, max_len=32, mode=mode, num_rows=rows,
              row_words=2 * jcfg.num_kv_heads * jcfg.head_dim, seed=0)
    j = JEngine(jcfg, **kw)
    t = TEngine(tcfg, device="cpu", **kw)
    load_jax_params(t.model, jax.tree.map(np.asarray, j.params))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab_size, 12).astype(np.int32)
               for _ in range(8)]
    jreqs = [JRequest(f"s{i}", p, 10) for i, p in enumerate(prompts)]
    treqs = [TRequest(f"s{i}", p, 10) for i, p in enumerate(prompts)]
    for a, b in zip(jreqs, treqs):
        j.submit(a)
        t.submit(b)
    while j.sched.has_work():
        j.poll()
        t.poll()
        assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert not t.sched.has_work()
    assert j.sched.stats == t.sched.stats
    assert (t.sched.stats["preemptions"] > 0) == (mode == "secded")
    assert all(len(r.generated) == 10 for r in treqs)
