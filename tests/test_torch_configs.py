"""The port's config registry and serving launcher equal the reference's.

  * Registry: ``ARCH_IDS``, every field of all ten configs and of their
    ``smoke()`` reductions (enums by value), ``SHAPES``, ``iter_cells``
    and ``TrainConfig`` equal the reference's.
  * Models: for each of the ten configs at ``smoke()`` (attention, MoE,
    Mamba and xLSTM families), the port's dense prefill logits, decode
    state and next decode step, and its forward logits and MoE aux loss,
    are within ``atol = rtol = 1e-4`` of the reference's after the
    reference weights are carried across with ``load_jax_params``
    (float32; torch and XLA reduce in different orders);
    ``params_tree`` gives the reference's tree back leaf for leaf; a
    reference and a port ``Engine`` in ``cream`` mode decode equal greedy
    tokens for the dense and the MoE configs, and both refuse the
    recurrent ones; the loss and its gradient equal
    ``jax.value_and_grad``'s for olmoe, jamba and xlstm (1e-4 of each
    leaf's scale); ``count_params`` (total and active), ``param_count``,
    ``active_param_count`` and ``model_flops_per_token`` equal the
    reference's for all ten configs at full size.
  * Launchers: the reference's and the port's ``launch/serve.py``
    ``main`` at ``--arch qwen3-0.6b --smoke`` (the port with ``--device
    cpu``) print equal JSON on every key that is not a time, or both
    refuse the same way; so do they at the two MoE configs' ``--smoke
    --secded-rows 24``. The port's ``launch/train.py --smoke`` trains
    every family with finite losses.
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
from repro.distributed.sharding import tree_paths as jtree_paths
from repro.launch import serve as jlaunch
from repro.models import count_params as jcount_params
from repro.models.model import model_flops_per_token as jflops
from repro.models import transformer as jtf
from repro.serve import Engine as JEngine
from repro.serve import ServeRequest as JRequest
from repro_torch.distributed.sharding import (tree_leaves, tree_map,
                                              tree_paths)
from repro_torch.launch import serve as tlaunch
from repro_torch.launch import train as ttrain
from repro_torch.models import (build_model, count_params, load_jax_params,
                                model_flops_per_token, params_tree,
                                transformer)
from repro_torch.serve import Engine as TEngine
from repro_torch.serve import ServeRequest as TRequest

TOL = dict(atol=1e-4, rtol=1e-4)
DENSE = ["deepseek-coder-33b", "starcoder2-7b", "granite-34b",
         "chameleon-34b", "musicgen-large"]
MOE = ["olmoe-1b-7b", "kimi-k2-1t-a32b"]
RECURRENT = ["jamba-1.5-large-398b", "xlstm-1.3b"]
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
    assert set(DENSE) | set(MOE) | set(RECURRENT) | {"qwen3-0.6b"} == \
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


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _smoke_pair(arch: str, seed: int = 0):
    """The reference's smoke config and parameters (numpy leaves) and a
    port model holding them."""
    jcfg = jconfigs.get_config(arch).smoke()
    tcfg = tconfigs.get_config(arch).smoke()
    params = jax.tree.map(np.asarray,
                          jtf.init_params(jcfg, jax.random.key(seed)))
    return jcfg, tcfg, params, load_jax_params(build_model(tcfg,
                                                           device="cpu"),
                                               params)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_dense_smoke_logits_match_the_reference(arch):
    """The dense (unpaged) path: prefill logits and the decode state at
    S (K/V, and every recurrent block's state), one decode step from it,
    and the forward's logits and aux loss."""
    jcfg, tcfg, params, model = _smoke_pair(arch)
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    want, wstate = jtf.prefill(params, jcfg, jnp.asarray(toks), 16)
    got, gstate = model.prefill_state(torch.as_tensor(toks), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    wflat, gflat = jtree_paths(wstate), tree_paths(gstate)
    assert set(gflat) == set(wflat)
    for path, leaf in wflat.items():
        np.testing.assert_allclose(_np(gflat[path]), np.asarray(leaf),
                                   err_msg=path, **TOL)
    nxt = np.argmax(np.asarray(want)[:, -1], axis=-1).astype(np.int32)
    wstep, _ = jtf.decode_step(params, jcfg, wstate, jnp.asarray(nxt))
    gstep, gstate = model.decode_step(gstate, torch.as_tensor(nxt))
    np.testing.assert_allclose(gstep.numpy(), np.asarray(wstep), **TOL)
    assert gstate["cache_len"].tolist() == [13, 13]
    wlog, waux = jtf.forward(params, jcfg, jnp.asarray(toks))
    glog, gaux = model.forward(torch.as_tensor(toks))
    np.testing.assert_allclose(glog.numpy(), np.asarray(wlog), **TOL)
    np.testing.assert_allclose(float(gaux), float(waux), **TOL)
    assert (float(gaux) > 0) == bool(tcfg.num_experts)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_params_tree_gives_the_reference_tree_back(arch):
    jcfg, _, params, model = _smoke_pair(arch, seed=1)
    jflat, tflat = jtree_paths(params), tree_paths(params_tree(model))
    assert list(tflat) == list(jflat)
    for path, leaf in jflat.items():
        np.testing.assert_array_equal(_np(tflat[path]), leaf, err_msg=path)
        assert str(tflat[path].dtype).split(".")[1] == leaf.dtype.name


@pytest.mark.parametrize("arch", RECURRENT)
def test_paged_path_refuses_recurrent_blocks(arch):
    """The paged path keeps only KV in pool pages: the port's model and
    engine refuse a pattern with recurrent blocks, as the reference's
    decode_step_paged and engine do."""
    jcfg, tcfg, params, model = _smoke_pair(arch)
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="attention-only") as got:
        model.prefill(toks)
    with pytest.raises(ValueError, match="attention-only") as want:
        jtf.decode_step_paged(params, jcfg, {"cache_len": jnp.zeros(1)},
                              jnp.zeros(1, jnp.int32), (None, None))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="attention-only"):
        model.decode_step_paged({"cache_len": torch.zeros(1)}, toks[:, 0],
                                (None, None))
    with pytest.raises(ValueError, match="attention-only"):
        JEngine(jcfg, max_batch=2, max_len=24)
    with pytest.raises(ValueError, match="attention-only"):
        TEngine(tcfg, max_batch=2, max_len=24, device="cpu")


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "jamba-1.5-large-398b",
                                  "xlstm-1.3b"])
def test_smoke_loss_and_gradients_equal_the_reference(arch):
    """loss_fn and its gradient against jax.value_and_grad of the
    reference's, from the same weights and batch; the MoE aux loss is in
    both. Each gradient leaf within 1e-4 of its largest magnitude, and
    remat "block" gives the same loss and gradient."""
    jcfg, tcfg, params, model = _smoke_pair(arch, seed=2)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    labs = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, params)
    wloss, wgrad = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jcfg, jnp.asarray(toks),
                              jnp.asarray(labs)))(jparams)
    wflat = jtree_paths(wgrad)
    for remat in ("none", "block"):
        tree = tree_map(lambda p: p.requires_grad_(True), params_tree(model))
        loss = transformer.loss_fn(tree, tcfg, torch.as_tensor(toks),
                                   torch.as_tensor(labs), remat=remat)
        np.testing.assert_allclose(float(loss.detach()), float(wloss),
                                   rtol=1e-5)
        grads = torch.autograd.grad(loss, tree_leaves(tree))
        gflat = dict(zip(tree_paths(tree), grads))
        assert list(gflat) == list(wflat)
        for path, leaf in wflat.items():
            want = np.asarray(leaf)
            scale = max(float(np.abs(want).max()), 1e-30)
            err = float(np.abs(_np(gflat[path]) - want).max())
            assert err <= 1e-4 * scale, (remat, path, err, scale)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_count_params_equals_the_reference_at_full_size(arch):
    t, j = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert count_params(t) == jcount_params(j) == t.param_count()
    assert count_params(t, active_only=True) == \
        jcount_params(j, active_only=True) == t.active_param_count()
    assert model_flops_per_token(t) == jflops(j)
    assert count_params(t.smoke()) == jcount_params(j.smoke())


@pytest.mark.parametrize("arch", DENSE + MOE)
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



@pytest.mark.parametrize("arch", MOE)
def test_moe_launcher_prints_what_the_reference_prints(arch, monkeypatch,
                                                       capsys):
    argv = ["--arch", arch, "--smoke", "--secded-rows", "24"]
    want = _run_main(jlaunch.main, argv, monkeypatch, capsys)
    got = _run_main(tlaunch.main, [*argv, "--device", "cpu"], monkeypatch,
                    capsys)
    assert not isinstance(want, str), want
    assert {k: v for k, v in got.items() if k not in TIMES} == \
        {k: v for k, v in want.items() if k not in TIMES}
    assert got["requests"] == 8 and got["tokens"] == 8 * 12


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "kimi-k2-1t-a32b",
                                  "jamba-1.5-large-398b", "xlstm-1.3b"])
def test_train_launcher_trains_every_family(arch, capsys):
    tr = ttrain.main(["--arch", arch, "--smoke", "--steps", "3",
                      "--seq-len", "32", "--global-batch", "4",
                      "--device", "cpu"])
    losses = [float(m["loss"]) for m in tr.metrics_log]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert capsys.readouterr().out.strip().endswith("over 3 steps")
