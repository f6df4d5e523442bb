"""Flash attention and the model's flash path equal the reference.

  * ``kernels/flash_attention`` (the plain version, which the wrapper takes
    for CPU tensors) against the reference's Pallas kernel in interpret
    mode, on the shapes of ``tests/test_kernels_sweep.py`` and a ragged S
    that no power-of-two block divides, causal and not: within 2e-5 for
    float32 (different reduction orders) and 2e-2 for bfloat16 (one
    rounding of the output), the sweep's tolerances;
  * ``build_model(cfg, attn_impl="flash")``'s ``forward`` (both logits
    modes), ``loss`` and the state-returning prefill against the
    reference's ``build_model(cfg, attn_impl="flash")`` from one set of
    weights (``load_jax_params``): logits and loss within 1e-4, decode-state
    K/V within 1e-5 (float32, other reduction orders).

The CUDA kernel runs on the card (``chip_smoke.py``), where it is held
against the same plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen3_0_6b as jqwen
from repro.configs.base import ModelConfig as JConfig
from repro.kernels.flash_attention import kernel as jkernel
from repro.models import transformer as jtf
from repro.models.model import build_model as jbuild
from repro_torch.configs import qwen3_0_6b as tqwen
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import build_model, load_jax_params

RNG = np.random.default_rng(41)
SHAPES = [
    (2, 4, 2, 128, 64, "float32"),
    (1, 8, 1, 256, 32, "float32"),
    (1, 2, 2, 64, 128, "float32"),
    (2, 4, 4, 128, 64, "bfloat16"),
    (1, 4, 2, 100, 32, "float32"),      # ragged: no block of 2^k divides
    (1, 4, 2, 100, 64, "bfloat16"),
]


def _to_torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.as_tensor(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("b,hq,hkv,s,d,dtype", SHAPES)
def test_attention_equals_the_reference_kernel(b, hq, hkv, s, d, dtype,
                                               causal):
    q, k, v = (RNG.standard_normal((b, h, s, d)).astype(np.float32)
               for h in (hq, hkv, hkv))
    jdt = getattr(jnp, dtype)
    want = jkernel.attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                             jnp.asarray(v, jdt), causal=causal)
    got = ops.attention(_to_torch(q, dtype), _to_torch(k, dtype),
                        _to_torch(v, dtype), causal=causal)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_attention_takes_an_explicit_scale():
    q, k, v = (torch.as_tensor(RNG.standard_normal((1, 2, 16, 32)),
                               dtype=torch.float32) for _ in range(3))
    want = jkernel.attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                             causal=True, scale=0.3)
    np.testing.assert_allclose(ops.attention(q, k, v, scale=0.3).numpy(),
                               np.asarray(want), rtol=2e-5, atol=2e-5)


def test_attention_refuses_what_it_does_not_take():
    q = torch.zeros((1, 4, 8, 32))
    k = torch.zeros((1, 3, 8, 32))
    with pytest.raises(ValueError, match="grouped-query"):
        ops.attention(q, k, k)
    with pytest.raises(TypeError, match="share one of"):
        ops.attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError, match="share one of"):
        ops.attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="contiguous"):
        ops.attention(q.transpose(1, 2).contiguous().transpose(1, 2), q, q)


# ---------------------------------------------------------------------------
# The model's flash path
# ---------------------------------------------------------------------------

SERVE_TEST = dict(name="serve-test", family="dense", num_layers=2,
                  d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                  vocab_size=256, head_dim=16, dtype="float32")


def _configs(name: str):
    if name == "serve-test":
        return JConfig(**SERVE_TEST), TConfig(**SERVE_TEST)
    return jqwen.CONFIG.smoke(), tqwen.CONFIG.smoke()


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("name", ["serve-test", "qwen3-0.6b-smoke"])
def test_flash_model_equals_the_reference(name):
    jcfg, tcfg = _configs(name)
    jmodel = jbuild(jcfg, attn_impl="flash")
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(3)))
    model = load_jax_params(build_model(tcfg, attn_impl="flash",
                                        device="cpu"), params)
    assert model.attn_impl == "flash"
    B, S, max_len = 2, 24, 32
    toks = RNG.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    labels = RNG.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jt, tt = jnp.asarray(toks), torch.as_tensor(toks)

    want, want_aux = jmodel.forward(params, jt)
    got, aux = model(tt)
    _close(got, want, 1e-4)
    assert float(aux) == float(want_aux) == 0.0
    want_last, _ = jtf.forward(params, jcfg, jt, attn_impl="flash",
                               logits_mode="last")
    got_last, _ = model(tt, logits_mode="last")
    assert got_last.shape == (B, jcfg.vocab_size)
    _close(got_last, want_last, 1e-4)
    _close(model.loss(tt, torch.as_tensor(labels)),
           jmodel.loss(params, jt, jnp.asarray(labels)), 1e-4)

    want_logits, want_state = jmodel.prefill(params, jt, max_len)
    got_logits, state = model.prefill_state(tt, max_len)
    _close(got_logits, want_logits, 1e-4)
    assert set(state) == set(want_state)
    np.testing.assert_array_equal(state["cache_len"].numpy(),
                                  np.asarray(want_state["cache_len"]))
    for kv in ("k", "v"):
        _close(state["pos0"][kv], want_state["pos0"][kv], 1e-5)
    _, last_state = model.prefill_state(tt, max_len, logits_mode="last")
    assert torch.equal(last_state["pos0"]["k"], state["pos0"]["k"])


def test_flash_and_einsum_attention_agree_in_the_port():
    cfg = TConfig(**SERVE_TEST)
    flash = build_model(cfg, attn_impl="flash", seed=5, device="cpu")
    plain = build_model(cfg, attn_impl="xla", seed=5, device="cpu")
    toks = torch.as_tensor(RNG.integers(0, cfg.vocab_size, (1, 40)))
    _close(flash(toks, logits_mode="last")[0],
           plain(toks, logits_mode="last")[0].numpy(), 1e-5)
    with pytest.raises(ValueError, match="attn_impl"):
        build_model(cfg, attn_impl="pallas", device="cpu")
