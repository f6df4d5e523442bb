"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against the
reference's ``repro.models.xlstm`` on the CPU.

At xlstm-1.3b's ``smoke()`` widths (d 64, 4 heads; the mLSTM cell at 2 ×
d, heads of 32), the reference's weights and seeded numpy inputs go
through both:

  * mLSTM: the parallel form's output, the prefill's recurrent state
    (C, n, m and the conv carry), then recurrent decode steps from it;
    and in the port alone, the recurrent form stepped over a sequence
    from the initial state gives the parallel form's outputs;
  * sLSTM: the sequential block from the initial state and from a given
    state, and its decode steps.

All within 1e-5 of the reference's scale (float32). A bfloat16 mLSTM
(weights in bfloat16, gate weights in float32) runs its parallel form,
prefill and decode, within 5e-2 of the reference's bfloat16 scale; a
prefill under 3 tokens is refused.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import xlstm as jx
from repro_torch.configs import get_config
from repro_torch.models import xlstm

REL = 1e-5


class _NS(dict):
    __getattr__ = dict.__getitem__


def _cfgs(dtype: str = "float32"):
    import dataclasses
    return (dataclasses.replace(jget_config("xlstm-1.3b").smoke(),
                                dtype=dtype),
            dataclasses.replace(get_config("xlstm-1.3b").smoke(),
                                dtype=dtype))


def _tensor(v) -> torch.Tensor:
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        return torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.as_tensor(np.array(a))


def _params(init, jcfg, seed: int = 0, dtype=jnp.float32):
    jp = init(jax.random.key(seed), jcfg, dtype)
    return jp, _NS({k: _tensor(v) for k, v in jp.items()})


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _close(got, want, what: str = "", rel: float = REL) -> None:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale, what


def _state_close(got: dict, want: dict, what: str, rel: float = REL):
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], f"{what} {k}", rel)


@pytest.mark.parametrize("seq", [3, 16], ids=["shortest", "prompt"])
def test_mlstm_parallel_prefill_and_decode_equal_the_reference(seq):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jx.init_mlstm, jcfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, seq, jcfg.d_model)).astype(np.float32)
    _close(xlstm.apply_mlstm(tp, tcfg, torch.as_tensor(x)),
           jx.apply_mlstm(jp, jcfg, jnp.asarray(x)), "parallel")
    jy, jst = jx.apply_mlstm_prefill(jp, jcfg, jnp.asarray(x))
    ty, tst = xlstm.apply_mlstm_prefill(tp, tcfg, torch.as_tensor(x))
    _close(ty, jy, "prefill")
    _state_close(tst, jst, "prefill state")
    for step in range(3):
        xt = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jy, jst = jx.apply_mlstm_decode(jp, jcfg, jnp.asarray(xt), jst)
        ty, tst = xlstm.apply_mlstm_decode(tp, tcfg, torch.as_tensor(xt),
                                           tst)
        _close(ty, jy, f"decode {step}")
        _state_close(tst, jst, f"decode {step}")


def test_mlstm_recurrent_form_equals_the_parallel_form():
    """Stepping the recurrent form from the initial state over a sequence
    gives the parallel form's outputs, and a prefill followed by decode
    steps gives a longer parallel pass's last outputs."""
    _, cfg = _cfgs()
    p = xlstm.MLSTM(cfg, torch.Generator().manual_seed(0), torch.float32)
    x = torch.randn(2, 10, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = xlstm.apply_mlstm(p, cfg, x)
        st = xlstm.init_mlstm_state(cfg, 2)
        ys = []
        for t in range(10):
            y, st = xlstm.apply_mlstm_decode(p, cfg, x[:, t:t + 1], st)
            ys.append(y)
        _close(torch.cat(ys, dim=1), want, "recurrent from zero")
        y, st = xlstm.apply_mlstm_prefill(p, cfg, x[:, :6])
        ys = [y]
        for t in range(6, 10):
            y, st = xlstm.apply_mlstm_decode(p, cfg, x[:, t:t + 1], st)
            ys.append(y)
    _close(torch.cat(ys, dim=1), want, "prefill + decode")


def test_mlstm_prefill_needs_three_tokens():
    _, cfg = _cfgs()
    p = xlstm.MLSTM(cfg, torch.Generator().manual_seed(0), torch.float32)
    with pytest.raises(ValueError, match="at least 3"):
        xlstm.apply_mlstm_prefill(p, cfg, torch.zeros(1, 2, cfg.d_model))


def test_bfloat16_mlstm_runs_and_follows_the_reference():
    """bfloat16 activations against float32 gate weights: the port casts
    to float32 where JAX promotes (torch.matmul refuses mixed dtypes)."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp, tp = _params(jx.init_mlstm, jcfg, dtype=jnp.bfloat16)
    assert tp.wi.dtype == torch.float32 and tp.w_up.dtype == torch.bfloat16
    x = np.random.default_rng(3).standard_normal(
        (2, 8, jcfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.as_tensor(x).to(torch.bfloat16)
    ty = xlstm.apply_mlstm(tp, tcfg, xt)
    assert ty.dtype == torch.bfloat16 and torch.isfinite(ty.float()).all()
    _close(ty, jx.apply_mlstm(jp, jcfg, xj), "parallel", rel=5e-2)
    jy, jst = jx.apply_mlstm_prefill(jp, jcfg, xj[:, :6])
    ty, tst = xlstm.apply_mlstm_prefill(tp, tcfg, xt[:, :6])
    assert all(t.dtype == torch.float32 for t in tst.values())
    _close(ty, jy, "prefill", rel=5e-2)
    jy, _ = jx.apply_mlstm_decode(jp, jcfg, xj[:, 6:7], jst)
    ty, tst = xlstm.apply_mlstm_decode(tp, tcfg, xt[:, 6:7], tst)
    assert ty.dtype == torch.bfloat16 and torch.isfinite(ty.float()).all()
    _close(ty, jy, "decode", rel=5e-2)


@pytest.mark.parametrize("given_state", [False, True],
                         ids=["initial-state", "given-state"])
def test_slstm_equals_the_reference(given_state):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jx.init_slstm, jcfg, seed=2)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    jst = tst = None
    if given_state:
        _, jst = jx.apply_slstm(jp, jcfg, jnp.asarray(x[:, :4]))
        jst = {k: jnp.asarray(v) for k, v in jst.items()}
        tst = {k: _tensor(v) for k, v in jst.items()}
    jy, jnew = jx.apply_slstm(jp, jcfg, jnp.asarray(x), jst)
    ty, tnew = xlstm.apply_slstm(tp, tcfg, torch.as_tensor(x), tst)
    _close(ty, jy, "output")
    _state_close(tnew, jnew, "state")
    for step in range(2):
        xt = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jy, jnew = jx.apply_slstm_decode(jp, jcfg, jnp.asarray(xt), jnew)
        ty, tnew = xlstm.apply_slstm_decode(tp, tcfg, torch.as_tensor(xt),
                                            tnew)
        _close(ty, jy, f"decode {step}")
        _state_close(tnew, jnew, f"decode {step}")


def test_initial_states_and_layouts_equal_the_reference():
    jcfg, tcfg = _cfgs()
    for tinit, jinit in ((xlstm.init_mlstm_state, jx.init_mlstm_state),
                         (xlstm.init_slstm_state, jx.init_slstm_state)):
        t, j = tinit(tcfg, 3), jinit(jcfg, 3)
        assert set(t) == set(j)
        for k in j:
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    for cls, init in ((xlstm.MLSTM, jx.init_mlstm),
                      (xlstm.SLSTM, jx.init_slstm)):
        own = dict(cls(tcfg, torch.Generator().manual_seed(0),
                       torch.float32).named_parameters())
        ref = init(jax.random.key(0), jcfg, jnp.float32)
        assert set(own) == set(ref)
        for k in ref:
            assert tuple(own[k].shape) == ref[k].shape, k
