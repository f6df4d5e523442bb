"""The port's Mamba block (``repro_torch.models.ssm``) against the
reference's ``repro.models.ssm`` on the CPU.

At jamba's ``smoke()`` widths (d 64, d_inner 128, state 8, dt rank 8,
conv 4), the reference's weights and seeded numpy inputs go through
both: the prefill output and its decode state (the conv carry and the
SSM state), over one chunk and over two (S = 512, the state carried
across the chunk boundary), and then decode steps from that state. All
within 1e-5 of the reference's scale (float32; the reference's
associative scan and the port's doubling scan sum in other orders). Also:
the port's decode steps continue its prefill as a longer prefill does,
the causal conv's carry, the seeded initialisation's magnitudes, and the
chunk assertion.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.models import ssm

REL = 1e-5


class _NS(dict):
    __getattr__ = dict.__getitem__


def _cfgs():
    return (jget_config("jamba-1.5-large-398b").smoke(),
            get_config("jamba-1.5-large-398b").smoke())


def _params(jcfg, seed: int = 0):
    jp = jssm.init_ssm(jax.random.key(seed), jcfg, jnp.float32)
    return jp, _NS({k: torch.as_tensor(np.array(v)) for k, v in jp.items()})


def _close(got, want, what: str = "") -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= REL * scale, what


@pytest.mark.parametrize("seq", [16, 512], ids=["one-chunk", "two-chunks"])
def test_prefill_and_decode_equal_the_reference(seq):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, seq, jcfg.d_model)).astype(np.float32)
    jy, jst = jssm.apply_ssm_prefill(jp, jcfg, jnp.asarray(x))
    ty, tst = ssm.apply_ssm_prefill(tp, tcfg, torch.as_tensor(x))
    _close(ty, jy, "prefill y")
    _close(tst["conv"], jst["conv"], "conv carry")
    _close(tst["h"], jst["h"], "ssm state")
    _close(ssm.apply_ssm(tp, tcfg, torch.as_tensor(x)),
           jssm.apply_ssm(jp, jcfg, jnp.asarray(x)), "apply_ssm")
    for step in range(3):
        xt = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jy, jst = jssm.apply_ssm_decode(jp, jcfg, jnp.asarray(xt), jst)
        ty, tst = ssm.apply_ssm_decode(tp, tcfg, torch.as_tensor(xt), tst)
        _close(ty, jy, f"decode {step}")
        _close(tst["h"], jst["h"], f"state {step}")
        _close(tst["conv"], jst["conv"], f"conv {step}")


def test_decode_from_an_initial_state_equals_the_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=1)
    jst = jssm.init_ssm_state(jcfg, 3, jnp.float32)
    tst = ssm.init_ssm_state(tcfg, 3, torch.float32)
    for k in ("conv", "h"):
        assert tuple(tst[k].shape) == jst[k].shape
        assert str(tst[k].dtype).split(".")[1] == jst[k].dtype.name
    xt = np.random.default_rng(1).standard_normal(
        (3, 1, jcfg.d_model)).astype(np.float32)
    jy, _ = jssm.apply_ssm_decode(jp, jcfg, jnp.asarray(xt), jst)
    ty, _ = ssm.apply_ssm_decode(tp, tcfg, torch.as_tensor(xt), tst)
    _close(ty, jy)


def test_decode_continues_the_prefill():
    """Prefill of 8 tokens then 4 decode steps gives the outputs and the
    state of a 12-token prefill (the recurrent and the scanned forms)."""
    _, cfg = _cfgs()
    p = ssm.SSM(cfg, torch.Generator().manual_seed(0), torch.float32)
    x = torch.randn(2, 12, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, wst = ssm.apply_ssm_prefill(p, cfg, x)
        y, st = ssm.apply_ssm_prefill(p, cfg, x[:, :8])
        ys = [y]
        for t in range(8, 12):
            y, st = ssm.apply_ssm_decode(p, cfg, x[:, t:t + 1], st)
            ys.append(y)
    _close(torch.cat(ys, dim=1), want.numpy(), "outputs")
    _close(st["h"], wst["h"].numpy(), "state")
    _close(st["conv"], wst["conv"].numpy(), "conv")


def test_causal_conv_carries_the_trailing_inputs():
    x = torch.randn(2, 5, 3, generator=torch.Generator().manual_seed(0))
    w = torch.randn(4, 3, generator=torch.Generator().manual_seed(1))
    y, carry = ssm._causal_conv(x, w)
    jy, jcarry = jssm._causal_conv(jnp.asarray(x.numpy()),
                                   jnp.asarray(w.numpy()))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-6)
    assert torch.equal(carry, x[:, -3:])
    np.testing.assert_array_equal(carry.numpy(), np.asarray(jcarry))
    # the carry continues the sequence: two halves give the whole
    y1, c1 = ssm._causal_conv(x[:, :2], w)
    y2, _ = ssm._causal_conv(x[:, 2:], w, c1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               atol=1e-6)


def test_init_ssm_has_the_reference_layout_and_sane_magnitudes():
    jcfg, tcfg = _cfgs()
    jp = jssm.init_ssm(jax.random.key(0), jcfg, jnp.float32)
    p = ssm.SSM(tcfg, torch.Generator().manual_seed(0), torch.float32)
    own = dict(p.named_parameters())
    assert set(own) == set(jp)
    for name, w in own.items():
        assert tuple(w.shape) == jp[name].shape, name
        assert w.dtype == torch.float32
    # S4D-real A (log 1..n, to a float32 ulp: the two logs round apart)
    # and d_skip = 1
    np.testing.assert_allclose(p.a_log.numpy(), np.asarray(jp["a_log"]),
                               rtol=1.2e-7, atol=0)
    np.testing.assert_array_equal(p.d_skip.numpy(), np.asarray(jp["d_skip"]))
    # the inverse softplus of dt_bias is a step in [1e-3, 1e-1]
    dt = torch.nn.functional.softplus(p.dt_bias)
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    assert abs(float(p.conv_w.std()) - 0.1) < 0.02
    assert abs(float(p.in_proj.std()) * tcfg.d_model ** 0.5 - 1) < 0.1
    bf = dataclasses.replace(tcfg, dtype="bfloat16")
    pb = ssm.SSM(bf, torch.Generator().manual_seed(0), torch.bfloat16)
    jb = jssm.init_ssm(jax.random.key(0), jcfg, jnp.bfloat16)
    for name, w in pb.named_parameters():
        assert str(w.dtype).split(".")[1] == jb[name].dtype.name, name


def test_prefill_refuses_a_ragged_chunking():
    _, cfg = _cfgs()
    p = ssm.SSM(cfg, torch.Generator().manual_seed(0), torch.float32)
    with pytest.raises(AssertionError):
        ssm.apply_ssm_prefill(p, cfg, torch.zeros(1, 300, cfg.d_model))
