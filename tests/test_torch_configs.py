"""The port's config registry and serving launcher equal the reference's.

  * Registry: ``ARCH_IDS``, every field of all ten configs and of their
    ``smoke()`` reductions (enums by value), ``SHAPES``, ``iter_cells``
    and ``TrainConfig`` equal the reference's.
  * Models: for each of the five attention + dense-MLP configs at
    ``smoke()``, the port's prefill logits are within ``atol = rtol =
    1e-4`` of the reference's after the reference weights are carried
    across with ``load_jax_params`` (float32; torch and XLA reduce in
    different orders), and a reference and a port ``Engine`` in ``cream``
    mode decode equal greedy tokens. The four other families still raise
    ``NotImplementedError``.
  * Launcher: the reference's and the port's ``launch/serve.py`` ``main``
    at ``--arch qwen3-0.6b --smoke`` (the port with ``--device cpu``)
    print equal JSON on every key that is not a time, or both refuse the
    same way.
"""
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.launch import serve as jlaunch
from repro.models import transformer as jtf
from repro.serve import Engine as JEngine
from repro.serve import ServeRequest as JRequest
from repro_torch.launch import serve as tlaunch
from repro_torch.models import build_model, load_jax_params
from repro_torch.serve import Engine as TEngine
from repro_torch.serve import ServeRequest as TRequest

TOL = dict(atol=1e-4, rtol=1e-4)
DENSE = ["deepseek-coder-33b", "starcoder2-7b", "granite-34b",
         "chameleon-34b", "musicgen-large"]
OTHER_FAMILIES = ["olmoe-1b-7b", "kimi-k2-1t-a32b", "jamba-1.5-large-398b",
                  "xlstm-1.3b"]
TIMES = {"wall_s", "tokens_per_s", "p50_latency_ms", "p99_latency_ms"}


def _fields(obj) -> dict:
    """Dataclass fields with enums (and the pattern's pairs) by value."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name == "pattern":
            v = tuple((b.value, m.value) for b, m in v)
        out[f.name] = v
    return out


def test_registry_equals_the_reference():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert set(DENSE) | set(OTHER_FAMILIES) | {"qwen3-0.6b"} == \
        set(tconfigs.ARCH_IDS)
    assert sorted(tconfigs.__all__) == sorted(jconfigs.__all__)
    assert {k: _fields(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: _fields(v) for k, v in jconfigs.SHAPES.items()}
    for include in (False, True):
        got = [(c.name, s.name) for c, s in tconfigs.iter_cells(include)]
        want = [(c.name, s.name) for c, s in jconfigs.iter_cells(include)]
        assert got == want
    assert _fields(tconfigs.get_shape("decode_32k")) == \
        _fields(jconfigs.get_shape("decode_32k"))
    assert _fields(tconfigs.TrainConfig()) == _fields(jconfigs.TrainConfig())
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("gpt-5")


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_every_config_equals_the_reference(arch):
    t, j = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert _fields(t) == _fields(j)
    assert _fields(t.smoke()) == _fields(j.smoke())
    assert t.head_dim_ == j.head_dim_ and t.num_stages == j.num_stages
    assert t.activation_dtype == getattr(torch, j.dtype)
    for shape in tconfigs.SHAPES.values():
        assert tconfigs.shape_applicable(t, shape) == \
            jconfigs.shape_applicable(j, jconfigs.get_shape(shape.name))


@pytest.mark.parametrize("arch", OTHER_FAMILIES)
def test_other_families_are_not_ported_yet(arch):
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(tconfigs.get_config(arch).smoke(), device="cpu")


@pytest.mark.parametrize("arch", DENSE)
def test_dense_smoke_logits_match_the_reference(arch):
    jcfg = jconfigs.get_config(arch).smoke()
    tcfg = tconfigs.get_config(arch).smoke()
    params = jax.tree.map(np.asarray,
                          jtf.init_params(jcfg, jax.random.key(0)))
    model = load_jax_params(build_model(tcfg, device="cpu"), params)
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    want, _ = jtf.prefill(params, jcfg, jnp.asarray(toks), 16)
    got, _ = model.prefill(torch.as_tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    wlog, _ = jtf.forward(params, jcfg, jnp.asarray(toks))
    glog, _ = model.forward(torch.as_tensor(toks))
    np.testing.assert_allclose(glog.numpy(), np.asarray(wlog), **TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_smoke_engines_decode_equal_tokens(arch):
    jcfg = jconfigs.get_config(arch).smoke()
    tcfg = tconfigs.get_config(arch).smoke()
    kw = dict(max_batch=2, max_len=24, mode="cream", num_rows=32,
              row_words=64, seed=0)
    j = JEngine(jcfg, **kw)
    t = TEngine(tcfg, device="cpu", **kw)
    load_jax_params(t.model, jax.tree.map(np.asarray, j.params))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab_size, 10).astype(np.int32)
               for _ in range(3)]
    jreqs = [JRequest(f"s{i}", p, 6) for i, p in enumerate(prompts)]
    treqs = [TRequest(f"s{i}", p, 6) for i, p in enumerate(prompts)]
    jout, tout = j.serve(jreqs), t.serve(treqs)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert all(len(r.generated) == 6 for r in treqs)
    assert {k: v for k, v in tout.items() if k not in TIMES} == \
        {k: v for k, v in jout.items() if k not in TIMES}


def _run_main(main, argv, monkeypatch, capsys):
    """``main`` under ``argv`` -> its parsed JSON, or the error it raised."""
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    capsys.readouterr()
    try:
        main()
    except RuntimeError as e:
        return f"{type(e).__name__}: {e}"
    return json.loads(capsys.readouterr().out)


# the defaults deadlock in both: one paid request's 18 pages exceed the
# paid tier's 16 SECDED rows (ROADMAP, reference caveats)
LAUNCHES = [[], ["--secded-rows", "24"],
            ["--pool-mode", "secded", "--pool-rows", "96"]]


@pytest.mark.parametrize("flags", LAUNCHES,
                         ids=["defaults", "secded-rows-24", "secded-mode"])
def test_launcher_prints_what_the_reference_prints(flags, monkeypatch,
                                                   capsys):
    argv = ["--arch", "qwen3-0.6b", "--smoke", *flags]
    want = _run_main(jlaunch.main, argv, monkeypatch, capsys)
    got = _run_main(tlaunch.main, [*argv, "--device", "cpu"], monkeypatch,
                    capsys)
    if isinstance(want, str):
        assert got == want and "deadlock" in want
        return
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in TIMES} == \
        {k: v for k, v in want.items() if k not in TIMES}
    assert got["requests"] == 8 and got["tokens"] == 8 * 12


def test_launcher_refuses_a_full_width_bfloat16_config():
    """The paged KV cache keeps float32 KV only, as the reference's: every
    full-width config is bfloat16 and is refused before any weight is
    built."""
    with pytest.raises(ValueError, match="float32"):
        tlaunch.main(["--arch", "starcoder2-7b", "--device", "cpu"])

